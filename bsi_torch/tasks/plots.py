"""Validation-time diagnostic plots.

Counterpart of ``bsi_tpu/tasks/plots.py``: at each validation it renders

- an 8x8 grid of fresh samples,
- 16 sampling-trajectory filmstrips (x_hat over the k steps),
- denoising panels: 8 fixed training images noised at 15 noise-level
  quantiles, each shown as (mu, x_hat) row pairs, noised as each algorithm
  noises: BSI's belief at lambda(t), VDM's forward marginal, BFN's flow
  distribution,

all drawn from a generator seeded with the fixed plot seed, on the EMA
parameters, and checked to be finite: the de-facto NaN watchdog of
training. The 8 images are normalized as an eval batch is (the JAX
package passes uint8 storage to the noiser as 0..255). The images are PNGs
under ``<run_dir>/plots/step_<n>/``, written with ``zlib`` and ``struct``
from the standard library, and are logged to W&B when a run is attached.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch

PLOT_SEED = 2831183658


def _to_uint8_grid(images: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """[rows*cols, H, W, C] uint8 -> one [rows*H, cols*W, C] image."""
    n, h, w, c = images.shape
    if n != rows * cols:
        raise ValueError(f"{n} images do not fill a {rows}x{cols} grid")
    return images.reshape(rows, cols, h, w, c).transpose(0, 2, 1, 3, 4).reshape(rows * h, cols * w, c)


def png_bytes(array: np.ndarray) -> bytes:
    """An 8-bit grey, RGB or RGBA PNG of ``array`` ([H, W] or [H, W, C])."""
    array = np.ascontiguousarray(array, np.uint8)
    if array.ndim == 3 and array.shape[-1] == 1:
        array = array[..., 0]
    h, w = array.shape[:2]
    if array.ndim == 2:
        color_type = 0
    elif array.ndim == 3 and array.shape[-1] in (3, 4):
        color_type = 2 if array.shape[-1] == 3 else 6
    else:
        raise ValueError(f"cannot write an array of shape {array.shape} as a PNG")
    # each row starts with filter type 0 (none)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), array.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_png(path: Path, array: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(png_bytes(array))


def read_png(path: Path) -> np.ndarray:
    """The pixels ``[H, W, C]`` of a PNG as ``png_bytes`` writes it (8-bit
    grey, RGB or RGBA, every row unfiltered); raises ``ValueError`` on a bad
    signature or chunk CRC, or on any other kind of PNG."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in its {kind!r} chunk")
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + length
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    channels = {0: 1, 2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or b"IEND" not in chunks:
        raise ValueError(f"{path}: not an 8-bit grey, RGB or RGBA PNG with an end (depth {depth}, colour {color})")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    if rows.size != h * (1 + w * channels) or rows.reshape(h, -1)[:, 0].any():
        raise ValueError(f"{path}: its pixel rows are not {h} unfiltered rows of {w}x{channels}")
    return rows.reshape(h, -1)[:, 1:].reshape(h, w, channels)


def _finite(x: torch.Tensor, what: str) -> None:
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"non-finite {what}")


def _noiser(algo):
    """``(generator, x, t) -> noised x`` at times ``t`` of shape ``(q, batch)``."""
    if hasattr(algo, "_sample_q_mu_lambda"):  # BSI: the belief at lambda(t)
        return lambda g, x, t: algo._sample_q_mu_lambda(g, x, algo.p_lambda.icdf(t))
    if hasattr(algo, "_sample_zt_given_x"):  # VDM: the forward marginal
        return algo._sample_zt_given_x
    return algo._sample_flow_distribution  # BFN: the flow distribution


class PlotsCallback:
    """Callable hooked into ``Trainer.callbacks``; signature (trainer, stage, step)."""

    def __init__(self, *, n_samples: int = 64, n_histories: int = 16, n_quantiles: int = 15):
        self.n_samples = n_samples
        self.n_histories = n_histories
        self.n_quantiles = n_quantiles

    def __call__(self, trainer, *, stage: str, step: int) -> None:
        algo = trainer.algorithm
        state = trainer.state
        disc = trainer.data.discretization()
        device = trainer.device
        generator = lambda: torch.Generator(device=device).manual_seed(PLOT_SEED)
        out_dir = trainer.run_dir / "plots" / f"step_{step}"
        to_8bit = lambda x: disc.to_8bit_image(x).cpu().numpy()
        images = {}

        samples = trainer.sample_fn(state, generator(), self.n_samples)
        _finite(samples, "samples")
        images[f"{stage}/samples"] = _to_uint8_grid(to_8bit(samples), 8, self.n_samples // 8)

        # trajectory filmstrips: rows = samples, columns = steps; BSI and BFN
        # return (mus, x_hats, ys), VDM the x_hats alone
        model_fn = lambda mu, t: trainer.eval_apply(state.ema_params, mu, t)
        history = algo.sample_history(model_fn, generator(), self.n_histories, device=device)
        x_hats = history[1] if isinstance(history, tuple) else history
        _finite(x_hats, "sample history")
        hx = to_8bit(x_hats)  # [k+1, n, H, W, C]
        k1, n, h, w, c = hx.shape
        images[f"{stage}/histories"] = hx.transpose(1, 2, 0, 3, 4).reshape(n * h, k1 * w, c)

        # denoising panels: 8 training images noised at the quantiles of t
        with torch.inference_mode():
            quantiles = torch.linspace(0.0, 1.0, self.n_quantiles, device=device)
            first, _ = next(trainer.data.eval_batches(trainer.data.eval_splits()["train"], 8))
            base = torch.as_tensor(first, dtype=torch.float32, device=device)
            t_grid = quantiles[:, None].expand(self.n_quantiles, len(base))
            mu = _noiser(algo)(generator(), base, t_grid)
            flat_mu = mu.reshape((-1,) + mu.shape[2:])
            x_hat = algo._predict_x(model_fn, flat_mu, quantiles.repeat_interleave(len(base)))
        _finite(x_hat, "denoisings")
        shape = (self.n_quantiles, len(base)) + tuple(base.shape[1:])
        stacked = np.stack([to_8bit(flat_mu).reshape(shape), to_8bit(x_hat).reshape(shape)], axis=2)
        q, b, _, h, w, c = stacked.shape
        images[f"{stage}/denoisings"] = stacked.transpose(1, 2, 3, 0, 4, 5).reshape(b * 2 * h, q * w, c)

        for name, arr in images.items():
            save_png(out_dir / (name.replace("/", "_") + ".png"), arr)
        wb = getattr(trainer.logger, "_wandb", None)
        if wb is not None:
            import wandb

            wb.log({k: wandb.Image(v) for k, v in images.items()}, step=step)
