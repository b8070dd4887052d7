"""The parallel layouts over ``torch.distributed``: data parallelism, FSDP,
and the DiT's Megatron tensor and sequence parallelism.

Counterpart of ``bsi_tpu/parallel/`` without the pipeline (which waits for
the DiT's stacked block layout). See :mod:`.mesh` for the ranks' layout and
:mod:`.layout` for what the train step does with it.
"""

from .distributed import check_host_batch, host_shard, initialize_distributed
from .fsdp import assign_zero3_dim, fsdp_plan
from .layout import StateLayout
from .mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, PIPELINE_ITEM, Mesh, make_mesh, pad_to_multiple
from .sequence import apply_sequence_parallelism, token_stream_sharding
from .tensor import Shard, TensorParallel, check_heads, tp_plan

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "PIPELINE_ITEM",
    "Mesh",
    "Shard",
    "StateLayout",
    "TensorParallel",
    "apply_sequence_parallelism",
    "assign_zero3_dim",
    "check_heads",
    "check_host_batch",
    "fsdp_plan",
    "host_shard",
    "initialize_distributed",
    "make_mesh",
    "pad_to_multiple",
    "token_stream_sharding",
    "tp_plan",
]
