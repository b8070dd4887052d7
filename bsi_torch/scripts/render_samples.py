"""A saved samples ``.npz`` as a PNG grid.

Counterpart of ``scripts/render_samples.py``, writing the PNG with the
port's own ``zlib`` writer (``bsi_torch.tasks.plots.save_png``) where the
JAX script uses PIL.

    python -m bsi_torch.scripts.render_samples samples.npz out.png [--cols 8]
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np

from bsi_torch.tasks.plots import save_png


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m bsi_torch.scripts.render_samples", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("samples")
    parser.add_argument("out")
    parser.add_argument("--cols", type=int, default=8)
    args = parser.parse_args(argv)

    with np.load(args.samples) as z:
        samples = z["samples"]

    if samples.dtype != np.uint8:
        # continuous [-1, 1] data -> 8-bit
        samples = np.clip((samples + 1) / 2 * 255, 0, 255).astype(np.uint8)

    n, h, w, c = samples.shape
    cols = args.cols
    rows = math.ceil(n / cols)
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    for i, img in enumerate(samples):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = img

    save_png(Path(args.out), grid)
    print(f"wrote {args.out} ({rows}x{cols} grid)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
