"""The DiT denoiser (Peebles & Xie, arXiv:2212.09748) as this repo defines
it: adaLN-Zero blocks with an extra dense layer before the SiLU of the
modulation, dropout on the attention's probabilities and before the MLP,
a fixed 2D Nyquist table for the patch positions, the Nyquist embedding of
t as the conditioning, Fourier features of the input beside it.

The model kind ``dit`` (see :mod:`benchmark.reference`). ``cfg``, as
:func:`sizes` gives it: ``data_shape`` (H, W, C), ``patch_size``, ``dim``,
``depth``, ``heads``, ``mlp_ratio``, ``fourier`` ((n_min, n_max) or None),
``dropout``. Parameter names are those of the port's ``DenoisingDiT``.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from .. import counts
from . import draws, shared_sizes
from .layers import (F32, Precision, attention, dense, fourier_channels, fourier_features, gelu_tanh, layer_norm,
                     merge_heads, nyquist, nyquist_table_2d, split_qkv)

# the program's model sizes of the CPU tests' tiny cells (on 8x8 images)
TINY = {"patch_size": 2, "dim": 128, "depth": 2, "heads": 2}
# adaLN-Zero's modulation starts at 0, where every block is the identity,
# which a check could not see through: its weights are drawn with std 0.02
SMALL_WEIGHTS = (".ada_out.",)


def sizes(config: dict) -> dict:
    m = config["program"]["task"]["model"]
    return {**shared_sizes(config), **{k: m[k] for k in ("patch_size", "dim", "depth", "heads")},
            "mlp_ratio": m.get("mlp_ratio", 4)}


def _tokens(cfg) -> int:
    h, w, _ = cfg["data_shape"]
    return (h // cfg["patch_size"]) * (w // cfg["patch_size"])


def flops(cfg: dict) -> float:
    """FLOPs of one image through the DiT: 2 a multiply-add of every dense
    layer (the modulation's once an image, the rest once a token) and
    4 S^2 D for attention's two products."""
    c = cfg["data_shape"][-1]
    p, d = cfg["patch_size"], cfg["dim"]
    s = _tokens(cfg)
    hidden = cfg.get("mlp_ratio", 4) * d
    block = 2 * s * (3 * d * d + d * d + 2 * d * hidden) + 2 * 7 * d * d + 4 * s * s * d
    return cfg["depth"] * block + 2 * s * p * p * fourier_channels(cfg) * d + 2 * s * d * p * p * c


def attention_calls(cfg: dict, batch: int, dtype: str, backward: bool) -> list[tuple[float, int]]:
    """``[(bound seconds, calls a forward)]`` of the fused-qkv attention (K2,
    and K3 with ``backward``): one a block."""
    heads = cfg["heads"]
    shapes = [((batch, heads, _tokens(cfg), cfg["dim"] // heads), cfg["depth"])]
    return counts.calls(shapes, dtype, counts.attention_fwd, counts.attention_bwd if backward else None)


def norm_calls(cfg: dict, batch: int, dtype: str, backward: bool) -> list[tuple[float, int]]:
    """LayerNorm + modulate (K4f, K4b): twice a block."""
    shapes = [((batch, _tokens(cfg), cfg["dim"]), 2 * cfg["depth"])]
    return counts.calls(shapes, dtype, counts.ln_modulate_fwd, counts.ln_modulate_bwd if backward else None)


def conv3x3_calls(cfg: dict, batch: int, dtype: str) -> list[tuple[float, int]]:
    """No convolution."""
    return []


def dropout_plan(cfg: dict, batch: int, seed: int, rate: float, dtype, device) -> list:
    """A train step's dropout draws at ``rate`` from ``seed``, in forward
    order: a block's attention draw, then its pre-MLP keep ``[B, S, D]``
    (``dtype`` is the compute dtype the masked tensor has)."""
    seq = _tokens(cfg)
    with draws.seeded(seed, device):
        return [(draws.AttentionDraw.draw(batch, cfg["heads"], seq, rate, device),
                 draws.module_keep((batch, seq, cfg["dim"]), rate, dtype, device, torch.contiguous_format))
                for _ in range(cfg["depth"])]


def param_shapes(cfg: dict) -> dict[str, tuple]:
    d, p, c = cfg["dim"], cfg["patch_size"], cfg["data_shape"][-1]
    hidden = cfg.get("mlp_ratio", 4) * d
    shapes = {
        "dit.patch_encoder.weight": (d, p * p * fourier_channels(cfg)), "dit.patch_encoder.bias": (d,),
        "dit.decoder_norm.weight": (d,), "dit.decoder_norm.bias": (d,),
        "dit.patch_decoder.weight": (p * p * c, d), "dit.patch_decoder.bias": (p * p * c,),
    }
    for i in range(cfg["depth"]):
        b = f"dit.block_{i}."
        for name, (n_out, n_in) in {"ada_in": (d, d), "ada_out": (6 * d, d), "attn.to_qkv": (3 * d, d),
                                    "attn.to_out": (d, d), "mlp.Dense_0": (hidden, d),
                                    "mlp.Dense_1": (d, hidden)}.items():
            shapes[b + name + ".weight"] = (n_out, n_in)
            shapes[b + name + ".bias"] = (n_out,)
    return shapes


def forward(params: dict, mu: torch.Tensor, t: torch.Tensor, cfg: dict, drop=None, rows=slice(None),
            prec: Precision = F32) -> torch.Tensor:
    """``mu [B, H, W, C]``, ``t [B]`` -> ``[B, H, W, C]``. ``drop``: a
    :func:`~.draws.dropout_plan` of the whole batch, of which ``rows`` are
    these; None in eval."""
    b, h, w, c = mu.shape
    p, d, heads = cfg["patch_size"], cfg["dim"], cfg["heads"]
    ph, pw = h // p, w // p
    x = mu
    if cfg.get("fourier"):
        x = torch.cat([mu, fourier_features(mu, *cfg["fourier"])], dim=-1)
    cin = x.shape[-1]
    patches = x.reshape(b, ph, p, pw, p, cin).permute(0, 1, 3, 2, 4, 5).reshape(b, ph * pw, p * p * cin)
    table = torch.as_tensor(nyquist_table_2d(d, ph, max(h, w)), dtype=mu.dtype, device=mu.device)
    tokens = dense(patches, params, "dit.patch_encoder", prec) + table
    cond = nyquist(t, d, 1000)
    rate = cfg.get("dropout") or 0.0
    for i in range(cfg["depth"]):
        pre = f"dit.block_{i}."
        mod = dense(F.silu(dense(cond, params, pre + "ada_in", prec)), params, pre + "ada_out", prec)
        shift_a, scale_a, gate_a, shift_m, scale_m, gate_m = (m[:, None, :] for m in mod.chunk(6, dim=-1))
        qkv = dense(shift_a + (scale_a + 1.0) * layer_norm(tokens), params, pre + "attn.to_qkv", prec)
        q, k, v = split_qkv(qkv, heads)
        keep = drop[i][0].mask(rows) if drop is not None else None
        attn = merge_heads(attention(q, k, v, keep, 1.0 - rate, prec))
        tokens = tokens + gate_a * dense(attn, params, pre + "attn.to_out", prec)
        mlp_in = shift_m + (scale_m + 1.0) * layer_norm(tokens)
        if drop is not None:
            mlp_in = torch.where(drop[i][1][rows], mlp_in / (1.0 - rate), 0.0)
        hidden = gelu_tanh(dense(mlp_in, params, pre + "mlp.Dense_0", prec))
        tokens = tokens + gate_m * dense(hidden, params, pre + "mlp.Dense_1", prec)
    out = dense(layer_norm(tokens, params["dit.decoder_norm.weight"], params["dit.decoder_norm.bias"]), params,
                "dit.patch_decoder", prec)
    return out.reshape(b, ph, pw, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
