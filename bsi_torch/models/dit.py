"""Diffusion Transformer (DiT) denoiser.

Counterpart of ``bsi_tpu/models/dit.py``: DiT (arXiv:2212.09748) with the
reference's two deviations from upstream DiT, an extra Dense in front of the
SiLU of the adaLN modulation and dropout before the block MLP. Data is NHWC;
patchify and unpatchify are reshapes. The 2D positional embedding is a fixed
table built from two 1D Nyquist embeddings.

Submodules carry the flax names (``dit``, ``patch_encoder``, ``block_{i}``,
``ada_in``, ``attn``, ``mlp``, ...), so converted weights load by name. The
JAX package's keywords are taken as the shared ``configs/`` pass them:

- ``remat``: in training each block runs under non-reentrant
  ``torch.utils.checkpoint``, which keeps only its inputs and recomputes
  its activations in the backward. The checkpoint saves the RNG states and
  restores them for the recompute, so ``nn.Dropout`` and the seeds the
  attention kernels draw (``draw_seeds``) give the same masks twice: the
  gradients are those without it. The block's parameters are among the
  checkpoint's inputs (:func:`_bound_block`): the recompute runs in the
  backward, after the ``functional_call`` that bound the state's tensors
  to the module has exited, and would otherwise read the module's own.
- ``scan_blocks``: a layout flag that changes no arithmetic. The blocks
  always run as a Python loop and are stored as ``block_{i}`` (the loop
  layout); :func:`bsi_torch.convert.params_from_jax` splits a scan-layout
  tree into them and :func:`bsi_torch.convert.params_to_jax` stacks them
  back. The pipeline (:mod:`bsi_torch.parallel.pipeline`) requires it, as
  the JAX package's does: it runs blocks ``[lo, hi)`` of each stage
  (:meth:`DiT.run_blocks`) and frees the rest (:meth:`DiT.keep_blocks`).
- ``token_sharding``: sequence parallelism, what
  :func:`bsi_torch.parallel.token_stream_sharding` returns (or None): the
  token stream between the blocks' Megatron pairs split over S on the
  model group (:mod:`bsi_torch.parallel.sequence`); embed and decode stay
  outside the split.

:meth:`DenoisingDiT.set_layout` puts the model on a parallel layout: the
attention's dropout draws cut from the global batch's and, with tensor
parallelism, the blocks' Megatron pairs over the model group
(:mod:`bsi_torch.parallel.tensor`). Neither changes the blocks'
arithmetic, and weights converted by
:func:`bsi_torch.convert.params_from_jax` load unchanged: a layout shards
them after.

On a CUDA tensor each block runs K4f twice (the fused LayerNorm + modulate
before the attention and before the MLP) and K2 once (the attention, read
in place from the qkv projection's output, with the attention dropout
inside the kernel in ``train()``); their gradients are K4b twice and K3
once. With ``dtype=torch.bfloat16`` the parameters stay f32 and every layer
casts at use, as flax does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from bsi_torch.core.common import resolve_device
from bsi_torch.nn import MLP, Dense, FourierFeatures, LayerNorm, NyquistPositionalEmbedding, TokenAttention
from bsi_torch.ops.ln_modulate import layernorm_modulate
from bsi_torch.parallel.collectives import split_tokens, unsplit_tokens
from bsi_torch.parallel.tensor import TensorParallel, check_heads, cut_dropout


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation over tokens: ``shift + (scale + 1) * x``."""
    return shift[:, None, :] + (scale[:, None, :] + 1.0) * x


class DiTBlock(nn.Module):
    """DiT block with adaptive layer norm zero (adaLN-Zero) conditioning.

    ``ada_out`` starts at zero, so at initialisation every gate is 0 and the
    block is the identity.
    """

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4, dropout: float | None = None, *,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.ada_in = Dense(dim, dim, **kw)
        self.ada_out = Dense(dim, 6 * dim, **kw)
        nn.init.zeros_(self.ada_out.weight)
        self.attn = TokenAttention(dim, heads, dropout or 0.0, **kw)
        self.dropout = nn.Dropout(dropout) if dropout is not None else None
        self.mlp = MLP(dim, dim, [mlp_ratio * dim], actfn=functools.partial(F.gelu, approximate="tanh"), **kw)
        self.tp = None

    def set_layout(self, mesh, tp) -> None:
        """See :meth:`DiT.set_layout`."""
        if tp is not None:
            check_heads(self.ada_in.in_features, self.attn.heads, tp.size)
        self.tp = tp
        self.attn.set_layout(mesh, tp)
        self.mlp.set_layout(tp)

    def _modulation(self, c: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.ada_out(F.silu(self.ada_in(c)))
        # the adaLN pair over the model group; c is per image, never split
        tp = self.tp
        h = F.silu(self.ada_in(tp.enter(c, tokens=False)))
        return tp.conditioning(tp.leave(self.ada_out, h, tokens=False))

    def forward(self, x: torch.Tensor, c: torch.Tensor, rows=None) -> torch.Tensor:
        """``rows``: the pipeline microbatch ``x`` is
        (:class:`bsi_torch.parallel.pipeline.MicroRows`), whose dropout
        masks are cut from its stage's local batch's draws; None otherwise."""
        mod = self._modulation(c)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
        attn_out = self.attn(layernorm_modulate(x, shift_msa, scale_msa), rows)
        x = x + gate_msa[:, None, :] * attn_out
        mlp_in = layernorm_modulate(x, shift_mlp, scale_mlp)
        if self.dropout is not None:
            mlp_in = cut_dropout(self.dropout, mlp_in, rows=rows, tp=self.tp)
        return x + gate_mlp[:, None, :] * self.mlp(mlp_in)

    @property
    def draws(self) -> bool:
        """Whether a call in the current mode draws dropout masks."""
        return self.training and (self.dropout is not None or self.attn.dropout > 0.0)


def _bound_block(block: nn.Module, names: tuple, x: torch.Tensor, c: torch.Tensor, rows, *leaves) -> torch.Tensor:
    """``block(x, c, rows)`` with its parameters ``names`` bound to ``leaves``."""
    return torch.func.functional_call(block, dict(zip(names, leaves)), (x, c, rows))


class DiT(nn.Module):
    """Transformer over image patches with adaLN-Zero t-conditioning.

    ``in_channels`` is the channel count of the input ``x`` (flax infers it
    at init; PyTorch needs it to size ``patch_encoder``).
    """

    def __init__(
        self,
        input_size: tuple[int, int],
        patch_size: int,
        in_channels: int,
        out_channels: int,
        hidden_size: int,
        depth: int,
        heads: int,
        mlp_ratio: int = 4,
        dropout: float | None = None,
        remat: bool = False,
        scan_blocks: bool = False,
        *,
        dtype=None,
        device=None,
        token_sharding=None,
    ):
        super().__init__()
        self.remat = remat
        self.scan_blocks = scan_blocks
        self.input_size = tuple(input_size)
        self.patch_size = patch_size
        self.out_channels = out_channels
        self.hidden_size = hidden_size
        self.depth = depth
        kw = dict(dtype=dtype, device=device)
        self.patch_encoder = Dense(patch_size * patch_size * in_channels, hidden_size, **kw)
        self.decoder_norm = LayerNorm(hidden_size, **kw)
        self.patch_decoder = Dense(hidden_size, patch_size * patch_size * out_channels, **kw)
        for i in range(depth):
            self.add_module(f"block_{i}", DiTBlock(hidden_size, heads, mlp_ratio, dropout, **kw))
        self.t_emb = NyquistPositionalEmbedding(hidden_size, 1000)
        self._pos_tables: dict = {}
        self.token_sharding = None
        if token_sharding is not None:
            self.set_token_sharding(token_sharding)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.depth)]

    def keep_blocks(self, lo: int, hi: int) -> None:
        """Free the parameters of every block outside ``[lo, hi)`` (a
        pipeline stage's): they move to the ``meta`` device, which keeps
        their shapes and names and no storage."""
        for i, block in enumerate(self.blocks()):
            if not lo <= i < hi:
                block.to(device="meta")

    def set_layout(self, mesh) -> None:
        """Put the blocks on ``mesh`` (a :class:`~bsi_torch.parallel.Mesh`):
        the attention's dropout draws cut from the global batch's, and with
        a model group of more than one rank the Megatron pairs over it.
        Raises where tp does not divide the qkv head groups."""
        tp = TensorParallel(mesh) if mesh.model_size > 1 else None
        for block in self.blocks():
            block.set_layout(mesh, tp)

    def set_token_sharding(self, token_sharding) -> None:
        """Sequence parallelism: ``token_sharding`` is what
        :func:`bsi_torch.parallel.token_stream_sharding` returns; anything
        else raises."""
        if not (isinstance(token_sharding, TensorParallel) and token_sharding.sequence):
            raise ValueError(f"token_sharding: want what bsi_torch.parallel.token_stream_sharding returns, "
                             f"got {token_sharding!r}")
        self.token_sharding = token_sharding
        for block in self.blocks():
            block.set_layout(token_sharding.mesh, token_sharding)

    def _pos_embedding(self) -> np.ndarray:
        """Fixed 2D positional embedding: concat of per-row and per-column 1D
        Nyquist embeddings, h-major patch order (f64 numpy)."""
        height, width = self.input_size
        ph, pw = height // self.patch_size, width // self.patch_size
        emb = NyquistPositionalEmbedding(self.hidden_size // 2, max(height, width))
        pos_h = emb.table(np.linspace(0.0, 1.0, ph))
        pos_w = emb.table(np.linspace(0.0, 1.0, pw))
        rows = np.repeat(pos_h, pw, axis=0)
        cols = np.tile(pos_w, (ph, 1))
        return np.concatenate([rows, cols], axis=1)

    def _pos_table(self, like: torch.Tensor) -> torch.Tensor:
        """The table in ``like``'s dtype on its device, made once per pair."""
        key = (like.dtype, like.device)
        if key not in self._pos_tables:
            self._pos_tables[key] = torch.as_tensor(self._pos_embedding(), dtype=like.dtype, device=like.device)
        return self._pos_tables[key]

    def embed(self, x: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Patchify + encode + fixed positional embedding; the t-conditioning vector."""
        b, h, w, c_in = x.shape
        p = self.patch_size
        ph, pw = h // p, w // p
        patches = x.reshape(b, ph, p, pw, p, c_in).permute(0, 1, 3, 2, 4, 5).reshape(b, ph * pw, p * p * c_in)
        tokens = self.patch_encoder(patches)
        tokens = tokens + self._pos_table(tokens)
        return tokens, self.t_emb(t)

    def run_blocks(self, tokens: torch.Tensor, c: torch.Tensor, lo: int = 0, hi: int | None = None, *,
                   rows=None, before_block=None) -> torch.Tensor:
        """Blocks ``[lo, hi)`` (all by default) on ``tokens``, each under
        ``remat`` in training; under sequence parallelism the stream is
        split over the model group on entry and gathered on exit. ``rows``
        goes to every block (:meth:`DiTBlock.forward`); ``before_block(i)``,
        where given, is called before block ``i`` runs."""
        remat = self.remat and self.training and torch.is_grad_enabled()
        sp = self.token_sharding
        if sp is not None:
            tokens = split_tokens(tokens, sp.group, sp.size, sp.rank)
        for i in range(lo, self.depth if hi is None else hi):
            block = getattr(self, f"block_{i}")
            if before_block is not None:
                before_block(i)
            if remat:
                names, leaves = zip(*block.named_parameters())
                tokens = checkpoint(_bound_block, block, names, tokens, c, rows, *leaves, use_reentrant=False,
                                    preserve_rng_state=True)
            else:
                tokens = block(tokens, c, rows)
        if sp is not None:
            tokens = unsplit_tokens(tokens, sp.group, sp.size, sp.rank)
        return tokens

    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """LayerNorm + linear decode + unpatchify."""
        b = tokens.shape[0]
        h, w = self.input_size
        p = self.patch_size
        out = self.patch_decoder(self.decoder_norm(tokens))
        out = out.reshape(b, h // p, w // p, p, p, self.out_channels)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, self.out_channels)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        tokens, c = self.embed(x, t)
        return self.decode(self.run_blocks(tokens, c))


class DenoisingDiT(nn.Module):
    """DiT under the ``(mu, t) -> prediction`` denoiser contract, with
    optional per-channel Fourier features of the input.

    Args:
        data_shape: (H, W, C) image shape.
        patch_size: Side of a square patch.
        dim: Token width.
        depth: Number of DiT blocks.
        heads: Attention heads.
        mlp_ratio: MLP hidden width over ``dim``.
        dropout: Attention and pre-MLP dropout rate, active in ``train()``.
        remat: Recompute each block's activations in the backward.
        scan_blocks: The JAX package's scan layout flag; changes no
            arithmetic here, and the pipeline requires it.
        fourier_features: Optional per-pixel Fourier features of the input.
        dtype: Compute dtype (parameters stay f32).
        device: Where the parameters live; ``None`` means the card.
        token_sharding: Sequence parallelism (``token_stream_sharding``), or None.
    """

    def __init__(
        self,
        data_shape: tuple[int, int, int],
        patch_size: int,
        dim: int,
        depth: int,
        heads: int,
        mlp_ratio: int = 4,
        dropout: float | None = None,
        remat: bool = False,
        scan_blocks: bool = False,
        fourier_features: FourierFeatures | None = None,
        dtype: torch.dtype | None = None,
        token_sharding=None,
        device: torch.device | str | None = None,
    ):
        super().__init__()
        if len(data_shape) != 3:
            raise ValueError("DenoisingDiT only supports 2D image data (H, W, C)")
        device = resolve_device(device)
        self.data_shape = tuple(data_shape)
        self.fourier_features = fourier_features
        channels = data_shape[-1]
        in_channels = channels * (1 + (fourier_features.n_features() if fourier_features else 0))
        self.dit = DiT(data_shape[:2], patch_size, in_channels, channels, dim, depth, heads, mlp_ratio,
                       dropout, remat, scan_blocks, dtype=dtype, device=device, token_sharding=token_sharding)

    @property
    def token_sharding(self):
        return self.dit.token_sharding

    @property
    def scan_blocks(self) -> bool:
        return self.dit.scan_blocks

    @property
    def depth(self) -> int:
        return self.dit.depth

    def keep_blocks(self, lo: int, hi: int) -> None:
        self.dit.keep_blocks(lo, hi)

    def set_layout(self, mesh) -> None:
        self.dit.set_layout(mesh)

    def set_token_sharding(self, token_sharding) -> None:
        self.dit.set_token_sharding(token_sharding)

    def _features(self, mu: torch.Tensor) -> torch.Tensor:
        if self.fourier_features is not None:
            return torch.cat([mu, self.fourier_features(mu)], dim=-1)
        return mu

    def embed(self, mu: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.dit.embed(self._features(mu), t)

    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.dit.decode(tokens)

    def forward(self, mu: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """``mu`` [B, H, W, C] and ``t`` [B] -> prediction [B, H, W, C]."""
        return self.dit(self._features(mu), t)
