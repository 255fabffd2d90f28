"""The reference algorithm in NumPy (:mod:`.reference`) and the scenes the
engine is held to it on (:mod:`.scenes`)."""

from .reference import (clean_mask, filter_ground_oracle, fit_plane_and_split,
                        fit_plane_pca)
from .scenes import PARITY_SCENES, all_deficient_scene

__all__ = ["clean_mask", "fit_plane_pca", "fit_plane_and_split",
           "filter_ground_oracle", "PARITY_SCENES", "all_deficient_scene"]
