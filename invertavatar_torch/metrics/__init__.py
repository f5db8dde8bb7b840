"""GAN evaluation metrics (the JAX package's `metrics/__init__.py` exports)."""

from .metric_main import calc_metric, list_metrics, register_metric  # noqa: F401
