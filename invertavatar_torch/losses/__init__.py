"""Training criteria: LPIPS and the ArcFace identity loss (the JAX
package's `losses/__init__.py` exports)."""

from .id_loss import ArcFaceBackbone, id_loss  # noqa: F401
from .lpips import LPIPS  # noqa: F401
