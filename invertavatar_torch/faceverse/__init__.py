"""FaceVerse online driving: the 3DMM coefficient pipeline and the manager
that rasterizes a frame's coefficients into a `uvcoords_image`."""

from .manager import FaceverseManager
from .model import FaceVerseAssets, FaceVerseModel, load_faceverse_assets

__all__ = ["FaceverseManager", "FaceVerseAssets", "FaceVerseModel", "load_faceverse_assets"]
