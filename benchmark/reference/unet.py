"""The VDM-UNet denoiser (Kingma et al., arXiv:2107.00630, without
resampling) as this repo defines it: ``levels`` residual blocks down, each
keeping a skip, a centre of two blocks around one pixel attention, and
``levels`` blocks up over the skips concatenated; a residual block is
GroupNorm, SiLU, 3x3 conv, FiLM by the conditioning, SiLU, dropout, 3x3 conv
and the (1x1-projected where widths differ) skip. The conditioning is the
Nyquist embedding of t through two dense layers with SiLU.

The model kind ``unet`` (see :mod:`benchmark.reference`). ``cfg``, as
:func:`sizes` gives it: ``data_shape``, ``dim``, ``levels``, ``pos_emb``
((size, rate)), ``pos_emb_mult``, ``n_attention_heads``, ``fourier``,
``dropout``. Parameter names are those of the port's ``DenoisingVDMUNet``.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from .. import counts
from . import draws, shared_sizes
from .layers import (F32, Precision, attention, conv, dense, fourier_channels, fourier_features, group_norm,
                     merge_heads, nyquist, split_qkv)

# the program's model sizes of the CPU tests' tiny cells (on 8x8 images)
TINY = {"dim": 32, "levels": 1}
SMALL_WEIGHTS = ()


def sizes(config: dict) -> dict:
    m = config["program"]["task"]["model"]
    return {**shared_sizes(config), **{k: m[k] for k in ("dim", "levels", "pos_emb_mult", "n_attention_heads")},
            "pos_emb": (m["pos_emb"]["size"], m["pos_emb"]["expected_rate"])}


def flops(cfg: dict) -> float:
    """FLOPs of one image through the VDM-UNet: 2 a multiply-add of every
    convolution and dense layer, 4 (HW)^2 C for the attention's products."""
    h, w, c = cfg["data_shape"]
    d, hw = cfg["dim"], h * w
    c_dim = cfg["pos_emb"][0] * cfg["pos_emb_mult"]
    conv = lambda cin, cout, k: 2 * hw * cin * cout * k * k
    block = lambda cin: conv(cin, d, 3) + conv(d, d, 3) + (conv(cin, d, 1) if cin != d else 0) + 2 * c_dim * 2 * d
    total = conv(fourier_channels(cfg), d, 3) + conv(d, c, 1)
    total += 2 * cfg["pos_emb"][0] * c_dim + 2 * c_dim * c_dim
    total += (cfg["levels"] + 2) * block(d) + cfg["levels"] * block(2 * d)
    total += conv(d, 3 * d, 3) + conv(d, d, 3) + 4 * hw * hw * d
    return total


def attention_calls(cfg: dict, batch: int, dtype: str, backward: bool) -> list[tuple[float, int]]:
    """``[(bound seconds, calls a forward)]`` of the one pixel attention in
    the centre (K1; K5f and K5b at 256 pixels)."""
    h, w, _ = cfg["data_shape"]
    heads = cfg["n_attention_heads"]
    shapes = [((batch, heads, h * w, cfg["dim"] // heads), 1)]
    return counts.calls(shapes, dtype, counts.attention_fwd, counts.attention_bwd if backward else None)


def norm_calls(cfg: dict, batch: int, dtype: str, backward: bool) -> list[tuple[float, int]]:
    """GroupNorm + SiLU (K7f, K7b): once a residual block, at C = dim down
    and in the centre, 2 dim up."""
    h, w, _ = cfg["data_shape"]
    d = cfg["dim"]
    shapes = [((batch, h * w, d), cfg["levels"] + 2), ((batch, h * w, 2 * d), cfg["levels"])]
    return counts.calls(shapes, dtype, counts.groupnorm_silu_fwd, counts.groupnorm_silu_bwd if backward else None)


def conv3x3_calls(cfg: dict, batch: int, dtype: str) -> list[tuple[float, int]]:
    """The forward's 3x3 convolutions (K8f in f32 on the card): ``encode``
    from the input and its Fourier features; two a residual block (the first
    from 2 dim up); the attention's qkv (to 3 dim) and output."""
    h, w, _ = cfg["data_shape"]
    d, levels = cfg["dim"], cfg["levels"]
    shapes = [((batch, h, w, fourier_channels(cfg), d), 1), ((batch, h, w, d, d), (levels + 2) + (2 * levels + 2) + 1),
              ((batch, h, w, 2 * d, d), levels), ((batch, h, w, d, 3 * d), 1)]
    return counts.calls(shapes, dtype, counts.conv3x3_fwd)


def dropout_plan(cfg: dict, batch: int, seed: int, rate: float, dtype, device) -> list:
    """A train step's dropout draws at ``rate`` from ``seed``, in forward
    order: one keep ``[B, C, H, W]`` (channels last) a residual block,
    blocks down, centre in, centre out, up (``dtype`` is the compute dtype
    the masked tensor has)."""
    h, w, _ = cfg["data_shape"]
    with draws.seeded(seed, device):
        return [draws.module_keep((batch, cfg["dim"], h, w), rate, dtype, device, torch.channels_last)
                for _ in _block_names(cfg["levels"])]


def _block_names(levels: int):
    return [f"unet.down_{i}" for i in range(levels)] + ["unet.center_in", "unet.center_out"] + \
        [f"unet.up_{i}" for i in range(levels)]


def param_shapes(cfg: dict) -> dict[str, tuple]:
    d, c = cfg["dim"], cfg["data_shape"][-1]
    cin = fourier_channels(cfg)
    emb = cfg["pos_emb"][0]
    c_dim = emb * cfg["pos_emb_mult"]
    shapes = {"pos_map_1.weight": (c_dim, emb), "pos_map_1.bias": (c_dim,),
              "pos_map_2.weight": (c_dim, c_dim), "pos_map_2.bias": (c_dim,),
              "encode.weight": (d, cin, 3, 3), "encode.bias": (d,)}
    for name in _block_names(cfg["levels"]):
        d_in = 2 * d if ".up_" in name else d
        shapes.update({f"{name}.to_scale_shift.weight": (2 * d, c_dim), f"{name}.to_scale_shift.bias": (2 * d,),
                       f"{name}.GroupNorm_0.weight": (d_in,), f"{name}.GroupNorm_0.bias": (d_in,),
                       f"{name}.conv1.weight": (d, d_in, 3, 3), f"{name}.conv1.bias": (d,),
                       f"{name}.conv2.weight": (d, d, 3, 3), f"{name}.conv2.bias": (d,)})
        if d_in != d:
            shapes.update({f"{name}.skip.weight": (d, d_in, 1, 1), f"{name}.skip.bias": (d,)})
    shapes.update({"unet.GroupNorm_0.weight": (d,), "unet.GroupNorm_0.bias": (d,),
                   "unet.Attention2D_0.to_qkv.weight": (3 * d, d, 3, 3), "unet.Attention2D_0.to_qkv.bias": (3 * d,),
                   "unet.Attention2D_0.to_out.weight": (d, d, 3, 3), "unet.Attention2D_0.to_out.bias": (d,),
                   "decode.weight": (c, d, 1, 1), "decode.bias": (c,)})
    return shapes


def _residual(x, cond, p, name, keep, rate, prec):
    scale, shift = dense(cond, p, f"{name}.to_scale_shift", prec).chunk(2, dim=-1)
    h = F.silu(group_norm(x, p[f"{name}.GroupNorm_0.weight"], p[f"{name}.GroupNorm_0.bias"]))
    h = conv(h, p, f"{name}.conv1", prec)
    h = F.silu(shift[:, :, None, None] + (scale[:, :, None, None] + 1.0) * h)
    if keep is not None:
        h = torch.where(keep, h / (1.0 - rate), 0.0)
    h = conv(h, p, f"{name}.conv2", prec)
    if f"{name}.skip.weight" in p:
        x = conv(x, p, f"{name}.skip", prec)
    return x + h


def forward(params: dict, mu: torch.Tensor, t: torch.Tensor, cfg: dict, drop=None, rows=slice(None),
            prec: Precision = F32) -> torch.Tensor:
    """``mu [B, H, W, C]``, ``t [B]`` -> ``[B, H, W, C]``; ``drop``, ``rows``
    as :func:`.dit.forward`'s (a keep ``[B, C, H, W]`` a residual block)."""
    x = mu
    if cfg.get("fourier"):
        x = torch.cat([mu, fourier_features(mu, *cfg["fourier"])], dim=-1)
    cond = F.silu(dense(nyquist(t, *cfg["pos_emb"]), params, "pos_map_1", prec))
    cond = F.silu(dense(cond, params, "pos_map_2", prec))
    h = conv(x.permute(0, 3, 1, 2), params, "encode", prec)
    rate = cfg.get("dropout") or 0.0
    names = _block_names(cfg["levels"])
    keeps = iter([None] * len(names) if drop is None else [k[rows] for k in drop])
    skips = []
    for name in names[:cfg["levels"]]:
        h = _residual(h, cond, params, name, next(keeps), rate, prec)
        skips.append(h)
    h = _residual(h, cond, params, "unet.center_in", next(keeps), rate, prec)
    b, c, hh, ww = h.shape
    a = group_norm(h, params["unet.GroupNorm_0.weight"], params["unet.GroupNorm_0.bias"])
    qkv = conv(a, params, "unet.Attention2D_0.to_qkv", prec).permute(0, 2, 3, 1).reshape(b, hh * ww, 3 * c)
    q, k, v = split_qkv(qkv, cfg["n_attention_heads"])
    a = merge_heads(attention(q, k, v, prec=prec)).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    h = h + conv(a, params, "unet.Attention2D_0.to_out", prec)
    h = _residual(h, cond, params, "unet.center_out", next(keeps), rate, prec)
    for name in names[cfg["levels"] + 2:]:
        h = _residual(torch.cat([h, skips.pop()], dim=1), cond, params, name, next(keeps), rate, prec)
    return conv(h, params, "decode", prec).permute(0, 2, 3, 1)
