from .logging import MetricLogger, count_params
from .seed import resolve_seed

__all__ = ["MetricLogger", "count_params", "resolve_seed"]
