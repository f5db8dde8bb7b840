"""Optimisation-based inversion (the JAX package's `inversion/__init__.py`
exports)."""

from .projector import project_w_plus  # noqa: F401
