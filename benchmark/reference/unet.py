"""The VDM-UNet denoiser (Kingma et al., arXiv:2107.00630, without
resampling) as this repo defines it: ``levels`` residual blocks down, each
keeping a skip, a centre of two blocks around one pixel attention, and
``levels`` blocks up over the skips concatenated; a residual block is
GroupNorm, SiLU, 3x3 conv, FiLM by the conditioning, SiLU, dropout, 3x3 conv
and the (1x1-projected where widths differ) skip. The conditioning is the
Nyquist embedding of t through two dense layers with SiLU.

``cfg``: ``data_shape``, ``dim``, ``levels``, ``pos_emb`` ((size, rate)),
``pos_emb_mult``, ``n_attention_heads``, ``fourier``. Parameter names are
those of the port's ``DenoisingVDMUNet``.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from .layers import (F32, Precision, attention, conv, dense, fourier_features, group_norm, merge_heads, nyquist,
                     split_qkv)


def _block_names(levels: int):
    return [f"unet.down_{i}" for i in range(levels)] + ["unet.center_in", "unet.center_out"] + \
        [f"unet.up_{i}" for i in range(levels)]


def param_shapes(cfg: dict) -> dict[str, tuple]:
    d, c = cfg["dim"], cfg["data_shape"][-1]
    ff = cfg.get("fourier")
    cin = c * (1 + (2 * (ff[1] - ff[0] + 1) if ff else 0))
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
