from .bsi import BSI
from .common import ModelFn, broadcast_right, protect_const, resolve_device
from .discretization import Discretization
from .distributions import (
    LogUniform,
    discretized_normal_log_prob,
    normal_cdf,
    normal_log_prob,
)

__all__ = [
    "BSI",
    "Discretization",
    "LogUniform",
    "ModelFn",
    "broadcast_right",
    "protect_const",
    "resolve_device",
    "normal_cdf",
    "normal_log_prob",
    "discretized_normal_log_prob",
]
