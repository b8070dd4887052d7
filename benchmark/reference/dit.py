"""The DiT denoiser (Peebles & Xie, arXiv:2212.09748) as this repo defines
it: adaLN-Zero blocks with an extra dense layer before the SiLU of the
modulation, dropout on the attention's probabilities and before the MLP,
a fixed 2D Nyquist table for the patch positions, the Nyquist embedding of
t as the conditioning, Fourier features of the input beside it.

``cfg``: ``data_shape`` (H, W, C), ``patch_size``, ``dim``, ``depth``,
``heads``, ``mlp_ratio``, ``fourier`` ((n_min, n_max) or None). Parameter
names are those of the port's ``DenoisingDiT``.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from .layers import (F32, Precision, attention, dense, fourier_features, gelu_tanh, layer_norm, merge_heads,
                     nyquist, nyquist_table_2d, split_qkv)


def _in_channels(cfg) -> int:
    c = cfg["data_shape"][-1]
    ff = cfg.get("fourier")
    return c * (1 + (2 * (ff[1] - ff[0] + 1) if ff else 0))


def param_shapes(cfg: dict) -> dict[str, tuple]:
    d, p, c = cfg["dim"], cfg["patch_size"], cfg["data_shape"][-1]
    hidden = cfg.get("mlp_ratio", 4) * d
    shapes = {
        "dit.patch_encoder.weight": (d, p * p * _in_channels(cfg)), "dit.patch_encoder.bias": (d,),
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
