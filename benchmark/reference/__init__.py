"""The benchmark's plain reference of the ground segmentation algorithm.

A frozen NumPy copy of the port's oracle, with the three helpers it took
from the port copied in.  It imports numpy and torch (for the CPU
``atan2``) and nothing of the program, so a change to the program cannot
move the yardstick it is held to.
"""

from .patchwork import (Algorithm, FitWork, filter_ground, fit_plane_pca,
                        patch_ids, polar_angle, ring_edges, sector_edges)

__all__ = ["Algorithm", "FitWork", "filter_ground", "fit_plane_pca",
           "patch_ids", "polar_angle", "ring_edges", "sector_edges"]
