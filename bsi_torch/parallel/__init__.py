"""The parallel layouts over ``torch.distributed``: data parallelism, FSDP,
the DiT's Megatron tensor and sequence parallelism, and its GPipe pipeline
parallelism.

Counterpart of ``bsi_tpu/parallel/``. See :mod:`.mesh` for the ranks'
layout, :mod:`.layout` for what the train step does with it and
:mod:`.pipeline` for the pipeline's stages and schedule.
"""

from .distributed import check_host_batch, host_shard, initialize_distributed
from .fsdp import assign_zero3_dim, fsdp_plan
from .layout import StateLayout
from .mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh, make_mesh, pad_to_multiple
from .pipeline import MicroRows, make_pipeline_apply, pp_plan, stage_blocks
from .sequence import apply_sequence_parallelism, token_stream_sharding
from .tensor import Shard, TensorParallel, check_heads, cut_dropout, tp_plan

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "Mesh",
    "MicroRows",
    "Shard",
    "StateLayout",
    "TensorParallel",
    "apply_sequence_parallelism",
    "assign_zero3_dim",
    "check_heads",
    "check_host_batch",
    "cut_dropout",
    "fsdp_plan",
    "host_shard",
    "initialize_distributed",
    "make_mesh",
    "make_pipeline_apply",
    "pad_to_multiple",
    "pp_plan",
    "stage_blocks",
    "token_stream_sharding",
    "tp_plan",
]
