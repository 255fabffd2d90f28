"""BEV (bird's-eye-view) rasterization as scatter ops on the device.

Counterpart of ``patchwork_tpu/viz/bev.py`` (reference:
src/visualization.cpp createBEVImage :18-47, createGroundNonGroundImage
:49-81, createEnhancedFilteredImage :83-113).  Points go to pixels in
float32 with truncation toward zero, as the JAX package computes them, and
each class is drawn with a per-pixel max (``scatter_reduce "amax"``) on a
flat ``(H*W, 3)`` canvas, which is deterministic where the reference's
last-point-wins overwrite is not.  Points outside the image are dropped by
a mask.  Only the finished image crosses to the host; :func:`save_png`
writes it with the standard library.

Colours (on-disk RGB, as the reference's BGR images show): height image
(255, i, i) with i = clip((z+2)*50, 0, 255); ground overlay green, non-ground
red, drawn over ground; enhanced (clip((z+1)*100), 127, clip((z+2)*50)).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

__all__ = [
    "bev_height_image",
    "bev_ground_nonground_image",
    "bev_enhanced_image",
    "save_png",
]

GROUND_RGB = (0, 255, 0)
NON_GROUND_RGB = (255, 0, 0)


def _pixel_index(xyz, mask, width, height, x_min, y_min, x_max, y_max):
    """Flat pixel index ``y * W + x`` of the points to draw, and which
    points those are (visualization.cpp:29-38).

    float32 arithmetic as in the JAX package; its float -> int32 cast maps
    NaN to 0 and saturates, which the in-range test below reproduces.
    """
    x_scale = float(np.float32(width) / np.float32(x_max - x_min))
    y_scale = float(np.float32(height) / np.float32(y_max - y_min))

    def cell(v, lo, scale):
        t = torch.trunc((v - lo) * scale)
        return torch.where(torch.isnan(t), torch.zeros_like(t), t)

    xf = cell(xyz[:, 0], x_min, x_scale)
    yf = cell(xyz[:, 1], y_min, y_scale)
    ok = mask & (xf >= 0) & (xf < width) & (yf >= 0) & (yf < height)
    idx = (yf[ok].to(torch.int64) * width + xf[ok].to(torch.int64))
    return idx, ok


def _draw_max(canvas, idx, colors):
    """Per-channel max of ``colors`` (M, 3) into ``canvas`` (H*W, 3) int32."""
    return canvas.scatter_reduce_(0, idx[:, None].expand(-1, 3),
                                  colors.to(torch.int32), "amax")


def _image(canvas, width, height):
    return canvas.to(torch.uint8).reshape(height, width, 3)


def _canvas(xyz, width, height):
    return torch.zeros((height * width, 3), dtype=torch.int32,
                       device=xyz.device)


def _u8(v):
    """float32 clipped to [0, 255] -> uint8 by truncation."""
    return torch.clamp(v, 0.0, 255.0).to(torch.uint8)


def bev_height_image(xyz, mask, width=300, height=150, x_min=-150.0,
                     y_min=-75.0, x_max=150.0, y_max=75.0):
    """Height-coloured BEV (createBEVImage, visualization.cpp:18-47):
    (H, W, 3) uint8 on ``xyz``'s device."""
    idx, ok = _pixel_index(xyz, mask, width, height, x_min, y_min, x_max,
                           y_max)
    inten = _u8((xyz[ok, 2] + 2.0) * 50.0)
    colors = torch.stack([torch.full_like(inten, 255), inten, inten], 1)
    return _image(_draw_max(_canvas(xyz, width, height), idx, colors),
                  width, height)


def bev_ground_nonground_image(xyz, ground, non_ground, width=300,
                               height=150, x_min=-150.0, y_min=-75.0,
                               x_max=150.0, y_max=75.0):
    """Green/red class overlay (createGroundNonGroundImage, :49-81);
    non-ground takes precedence (drawn second in the reference)."""
    canvas = _canvas(xyz, width, height)
    for cls, rgb in ((ground, GROUND_RGB), (non_ground, NON_GROUND_RGB)):
        idx, _ = _pixel_index(xyz, cls, width, height, x_min, y_min, x_max,
                              y_max)
        color = torch.tensor(rgb, dtype=torch.int32, device=xyz.device)
        canvas[idx] = color   # every write of a class is the same colour
    return _image(canvas, width, height)


def bev_enhanced_image(xyz, mask, width=300, height=150, x_min=-150.0,
                       y_min=-75.0, x_max=150.0, y_max=75.0):
    """Enhanced height-RGB image (createEnhancedFilteredImage, :83-113)."""
    idx, ok = _pixel_index(xyz, mask, width, height, x_min, y_min, x_max,
                           y_max)
    z = xyz[ok, 2]
    red = _u8((z + 1.0) * 100.0)
    blue = _u8((z + 2.0) * 50.0)
    colors = torch.stack([red, torch.full_like(red, 127), blue], 1)
    return _image(_draw_max(_canvas(xyz, width, height), idx, colors),
                  width, height)


def save_png(image, filename: str) -> None:
    """Write an (H, W, 3) uint8 RGB image (tensor or array) as a PNG, with
    ``zlib`` and ``struct`` only: 8-bit truecolour, no filter, no
    interlace."""
    if isinstance(image, torch.Tensor):
        image = image.cpu().numpy()
    img = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], 1)
    with open(filename, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))
