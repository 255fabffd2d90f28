"""Class-based visualization surface mirroring the reference Visualization
class (include/visualization.hpp:10-77), built on the BEV rasterizers in
bev.py; counterpart of ``patchwork_tpu/viz/visualization.py``.

Configurable class colors (hpp:53-56, ctor defaults visualization.cpp:7-13),
world->pixel mapping with Y flip + clamping (worldToPixel, cpp:146-166),
auto-bounds point drawing with 5 m padding and radius>1 disks
(drawPoints, cpp:175-218), and matplotlib-backed showImage.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .bev import (
    bev_enhanced_image,
    bev_ground_nonground_image,
    bev_height_image,
    save_png,
)

__all__ = ["Visualization"]

RGB = Tuple[int, int, int]


def _xyz(points) -> torch.Tensor:
    pts = np.asarray(points, np.float32)
    pts = pts.reshape(-1, 3) if pts.size == 0 else pts[:, :3]
    return torch.from_numpy(np.ascontiguousarray(pts))


class Visualization:
    def __init__(self):
        # reference ctor defaults (visualization.cpp:7-13), as RGB
        self.ground_color: RGB = (0, 255, 0)
        self.non_ground_color: RGB = (128, 128, 128)
        self.filtered_color: RGB = (0, 0, 255)
        self.background_color: RGB = (0, 0, 0)

    # -- color setters (hpp:53-56) --
    def set_ground_color(self, rgb: RGB) -> None:
        self.ground_color = rgb

    def set_non_ground_color(self, rgb: RGB) -> None:
        self.non_ground_color = rgb

    def set_filtered_color(self, rgb: RGB) -> None:
        self.filtered_color = rgb

    def set_background_color(self, rgb: RGB) -> None:
        self.background_color = rgb

    # -- image builders --
    @staticmethod
    def create_bev_image(points, width=300, height=150,
                         x_min=-150.0, y_min=-75.0, x_max=150.0, y_max=75.0):
        pts = _xyz(points)
        return bev_height_image(pts, torch.ones(len(pts), dtype=torch.bool),
                                width, height, x_min, y_min, x_max,
                                y_max).numpy()

    @staticmethod
    def create_ground_non_ground_image(ground_points, non_ground_points,
                                       width=300, height=150,
                                       x_min=-150.0, y_min=-75.0,
                                       x_max=150.0, y_max=75.0):
        g = _xyz(ground_points)
        n = _xyz(non_ground_points)
        pts = torch.cat([g, n])
        gm = torch.arange(len(pts)) < len(g)
        return bev_ground_nonground_image(pts, gm, ~gm, width, height, x_min,
                                          y_min, x_max, y_max).numpy()

    @staticmethod
    def create_enhanced_filtered_image(points, width=300, height=150,
                                       x_min=-150.0, y_min=-75.0,
                                       x_max=150.0, y_max=75.0):
        pts = _xyz(points)
        return bev_enhanced_image(pts, torch.ones(len(pts), dtype=torch.bool),
                                  width, height, x_min, y_min, x_max,
                                  y_max).numpy()

    # -- savers (cpp:115-135) --
    def save_bev_image(self, points, filename, **kw) -> bool:
        save_png(self.create_bev_image(points, **kw), filename)
        return True

    def save_ground_non_ground_image(self, ground, non_ground, filename, **kw) -> bool:
        save_png(self.create_ground_non_ground_image(ground, non_ground, **kw), filename)
        return True

    # -- display (cpp:137-144): matplotlib stands in for cv::imshow --
    @staticmethod
    def show_image(image, window_name: str = "image") -> None:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        fig = plt.figure(window_name)
        plt.imshow(np.asarray(image))
        plt.title(window_name)
        plt.axis("off")
        fig.canvas.draw_idle()

    @staticmethod
    def wait_for_key(delay_ms: int = 0) -> None:
        import matplotlib.pyplot as plt

        plt.pause(max(delay_ms, 1) / 1000.0)

    # -- geometry helpers (cpp:146-173) --
    @staticmethod
    def world_to_pixel(point, width, height, x_min, y_min, x_max, y_max):
        """World -> clamped pixel with Y flip (worldToPixel, cpp:146-166)."""
        x_ratio = (point[0] - x_min) / (x_max - x_min)
        y_ratio = 1.0 - (point[1] - y_min) / (y_max - y_min)
        px = int(np.clip(int(x_ratio * width), 0, width - 1))
        py = int(np.clip(int(y_ratio * height), 0, height - 1))
        return px, py

    @staticmethod
    def is_point_in_bounds(point, x_min, y_min, x_max, y_max) -> bool:
        return bool(
            x_min <= point[0] <= x_max and y_min <= point[1] <= y_max
        )

    def draw_points(self, image: np.ndarray, points, color: RGB,
                    point_size: float = 1.0) -> np.ndarray:
        """Auto-bounds overlay with 5 m padding; radius > 1 draws disks
        (drawPoints, cpp:175-218).  Mutates and returns ``image``."""
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        if len(pts) == 0:
            return image
        h, w = image.shape[:2]
        pad = 5.0
        x_min, y_min = pts[:, 0].min() - pad, pts[:, 1].min() - pad
        x_max, y_max = pts[:, 0].max() + pad, pts[:, 1].max() + pad

        # Vectorized world_to_pixel (same truncation + clamp as the scalar
        # helper above / drawPoints, cpp:175-218) for the whole batch.
        px = ((pts[:, 0] - x_min) / (x_max - x_min) * w).astype(np.int64)
        py = ((1.0 - (pts[:, 1] - y_min) / (y_max - y_min)) * h).astype(
            np.int64)
        px = np.clip(px, 0, w - 1)
        py = np.clip(py, 0, h - 1)

        if point_size <= 1.0:
            image[py, px] = color
        else:
            r = int(point_size)
            yy, xx = np.ogrid[-r : r + 1, -r : r + 1]
            dyy, dxx = np.nonzero(yy * yy + xx * xx <= r * r)
            # one (P, disk) index grid; out-of-bounds disk pixels are
            # skipped, matching the per-point window clipping
            iy = py[:, None] + (dyy[None, :] - r)
            ix = px[:, None] + (dxx[None, :] - r)
            ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            image[iy[ok], ix[ok]] = color
        return image
