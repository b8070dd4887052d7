from .bfn import BFN
from .bsi import BSI
from .common import (
    ModelFn,
    broadcast_right,
    lds_grid,
    mc_var,
    protect_const,
    resolve_device,
    sample_lds_t,
)
from .discretization import Discretization
from .schedules import get_schedule
from .vdm import VDM
from .distributions import (
    LogUniform,
    discretized_normal_log_prob,
    normal_cdf,
    normal_log_prob,
)

__all__ = [
    "BSI",
    "VDM",
    "BFN",
    "Discretization",
    "LogUniform",
    "ModelFn",
    "broadcast_right",
    "get_schedule",
    "lds_grid",
    "mc_var",
    "protect_const",
    "resolve_device",
    "sample_lds_t",
    "normal_cdf",
    "normal_log_prob",
    "discretized_normal_log_prob",
]
