"""Operations and bytes of one call of each of the port's kernels, from its
shapes, and the bound of a call: what a model kind's file
(``reference/<kind>.py``) counts its forwards with.

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


def calls(shapes: list, dtype: str, fwd, bwd=None) -> list[tuple[float, int]]:
    """``[(bound seconds, calls a forward)]`` of ``fwd`` at each ``(shape,
    calls a forward)`` of ``shapes`` and, where ``bwd`` is given, of ``bwd``
    at each after them."""
    out = [(bound_s(*fwd(*shape, dtype), dtype), n) for shape, n in shapes]
    if bwd is not None:
        out += [(bound_s(*bwd(*shape, dtype), dtype), n) for shape, n in shapes]
    return out


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


def conv3x3_fwd(b, h, w, cin, cout, dtype):
    """A 'SAME' 3x3 convolution at stride 1 of [b, h, w, cin] to cout
    channels, with a bias: 2 a multiply-add; it reads the input, the weight
    and the bias and writes the output. ``cin`` is the model's, whatever
    padding a kernel adds."""
    return 18.0 * b * h * w * cin * cout, (b * h * w * (cin + cout) + 9.0 * cin * cout + cout) * SIZE[dtype]
