"""Sequence parallelism (Megatron-SP) over the model axis.

Counterpart of ``bsi_tpu/parallel/sequence.py``. Between the Megatron pairs
the DiT's ``[B, S, D]`` token stream is split over S on the model group: the
LayerNorm+modulate kernels (K4f, K4b), dropout, the gates and the residual
adds run on ``S/tp`` tokens (a rank's dropout mask is its tokens' part of
one draw over the whole stream, ``cut_dropout``). Before each
column-parallel matmul (``to_qkv``, ``mlp.Dense_0``) the tokens are
all-gathered; after each row-parallel one
(``to_out``, ``mlp.Dense_1``) a reduce-scatter takes the all-reduce's place
(:class:`bsi_torch.parallel.tensor.TensorParallel`). Embed and decode stay
outside the split stream. K4b runs on the local tokens; the per-image
dshift and dscale it returns, with the gates' gradients, are summed over
the model group by one all-reduce of the block's conditioning gradient
(``TensorParallel.conditioning``), where JAX's partition rule psums them.
"""

from __future__ import annotations

from .mesh import MODEL_AXIS, Mesh
from .tensor import TensorParallel


def token_stream_sharding(mesh: Mesh) -> TensorParallel:
    """The token stream's split: S over the mesh's model group."""
    return TensorParallel(mesh, sequence=True)


def apply_sequence_parallelism(model, mesh: Mesh):
    """Set ``model``'s token sharding to :func:`token_stream_sharding`, or
    raise if the mesh or the model cannot take it; returns the model."""
    if mesh.shape.get(MODEL_AXIS, 1) <= 1:
        raise ValueError(
            "sequence_parallel=true requires model_parallelism > 1 (the "
            "sequence shards over the mesh's model axis)"
        )
    if not hasattr(model, "set_token_sharding"):
        raise ValueError(
            f"sequence_parallel=true needs a token-stream model with a "
            f"token_sharding field (the DiT family); got {type(model).__name__}"
        )
    model.set_token_sharding(token_stream_sharding(mesh))
    return model
