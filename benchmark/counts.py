"""Operations and bytes from a configuration's shapes: the model's FLOPs a
forward, and each attention and norm call's operations, bytes and bound.

A bound is the least time the card could take: the larger of the bytes
over the HBM bandwidth and the operations over the peak for the dtype
(bf16 on the tensor cores; f32 off them, since the f32 cells run with TF32
off). Bytes count each input read once and each output written once, as
the computation needs them: an attention forward reads q, k, v and writes
its output; its backward reads q, k, v and dO and writes dq, dk, dv, and
recomputes the probabilities (10 B H S^2 D operations against the forward's
4). Peaks: NVIDIA's H100 SXM data sheet, dense.
"""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
SIZE = {"bf16": 2, "f32": 4}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# ------------------------------------------------------------------- models


def _fourier_channels(cfg) -> int:
    c = cfg["data_shape"][-1]
    ff = cfg.get("fourier")
    return c * (1 + (2 * (ff[1] - ff[0] + 1) if ff else 0))


def dit_flops(cfg: dict) -> float:
    """FLOPs of one image through the DiT: 2 a multiply-add of every dense
    layer (the modulation's once an image, the rest once a token) and
    4 S^2 D for attention's two products."""
    h, w, c = cfg["data_shape"]
    p, d = cfg["patch_size"], cfg["dim"]
    s = (h // p) * (w // p)
    hidden = cfg.get("mlp_ratio", 4) * d
    block = 2 * s * (3 * d * d + d * d + 2 * d * hidden) + 2 * 7 * d * d + 4 * s * s * d
    return cfg["depth"] * block + 2 * s * p * p * _fourier_channels(cfg) * d + 2 * s * d * p * p * c


def unet_flops(cfg: dict) -> float:
    """FLOPs of one image through the VDM-UNet: 2 a multiply-add of every
    convolution and dense layer, 4 (HW)^2 C for the attention's products."""
    h, w, c = cfg["data_shape"]
    d, hw = cfg["dim"], h * w
    c_dim = cfg["pos_emb"][0] * cfg["pos_emb_mult"]
    conv = lambda cin, cout, k: 2 * hw * cin * cout * k * k
    block = lambda cin: conv(cin, d, 3) + conv(d, d, 3) + (conv(cin, d, 1) if cin != d else 0) + 2 * c_dim * 2 * d
    total = conv(_fourier_channels(cfg), d, 3) + conv(d, c, 1)
    total += 2 * cfg["pos_emb"][0] * c_dim + 2 * c_dim * c_dim
    total += (cfg["levels"] + 2) * block(d) + cfg["levels"] * block(2 * d)
    total += conv(d, 3 * d, 3) + conv(d, d, 3) + 4 * hw * hw * d
    return total


MODEL_FLOPS = {"dit": dit_flops, "unet": unet_flops}


# -------------------------------------------------------------------- calls


def attention_fwd(b, h, s, d, dtype):
    """(flops, bytes) of one attention forward over [b, h, s, d]."""
    return 4.0 * b * h * s * s * d, 4.0 * b * s * h * d * SIZE[dtype]


def attention_bwd(b, h, s, d, dtype):
    return 10.0 * b * h * s * s * d, 7.0 * b * s * h * d * SIZE[dtype]


def ln_modulate_fwd(b, s, d, dtype):
    """LayerNorm + modulate over [b, s, d] with shift and scale [b, d]."""
    return 8.0 * b * s * d, (2.0 * b * s * d + 2.0 * b * d) * SIZE[dtype]


def ln_modulate_bwd(b, s, d, dtype):
    return 14.0 * b * s * d, (3.0 * b * s * d + 4.0 * b * d) * SIZE[dtype]


def groupnorm_silu_fwd(b, rows, c, dtype):
    """GroupNorm + SiLU over [b, rows, c] with scale and bias [c]."""
    return 10.0 * b * rows * c, (2.0 * b * rows * c + 2.0 * c) * SIZE[dtype]


def groupnorm_silu_bwd(b, rows, c, dtype):
    return 18.0 * b * rows * c, (3.0 * b * rows * c + 4.0 * c) * SIZE[dtype]


def attention_calls(kind: str, cfg: dict, batch: int, dtype: str, backward: bool) -> list[tuple[float, int]]:
    """``[(bound seconds, calls a forward)]`` of the attention calls of one
    forward (and, with ``backward``, of its backward) at ``batch``."""
    h, w, _ = cfg["data_shape"]
    if kind == "dit":
        s, heads = (h // cfg["patch_size"]) * (w // cfg["patch_size"]), cfg["heads"]
        shape, n = (batch, heads, s, cfg["dim"] // heads), cfg["depth"]
    else:
        heads = cfg["n_attention_heads"]
        shape, n = (batch, heads, h * w, cfg["dim"] // heads), 1
    calls = [(bound_s(*attention_fwd(*shape, dtype), dtype), n)]
    if backward:
        calls.append((bound_s(*attention_bwd(*shape, dtype), dtype), n))
    return calls


def norm_calls(kind: str, cfg: dict, batch: int, dtype: str, backward: bool) -> list[tuple[float, int]]:
    """The same for the fused norms: LayerNorm + modulate twice a DiT block,
    GroupNorm + SiLU once a UNet residual block (C = dim down and in the
    centre, 2 dim up)."""
    h, w, _ = cfg["data_shape"]
    if kind == "dit":
        s = (h // cfg["patch_size"]) * (w // cfg["patch_size"])
        shapes = [((batch, s, cfg["dim"]), 2 * cfg["depth"])]
        fwd, bwd = ln_modulate_fwd, ln_modulate_bwd
    else:
        d = cfg["dim"]
        shapes = [((batch, h * w, d), cfg["levels"] + 2), ((batch, h * w, 2 * d), cfg["levels"])]
        fwd, bwd = groupnorm_silu_fwd, groupnorm_silu_bwd
    calls = [(bound_s(*fwd(*shape, dtype), dtype), n) for shape, n in shapes]
    if backward:
        calls += [(bound_s(*bwd(*shape, dtype), dtype), n) for shape, n in shapes]
    return calls
