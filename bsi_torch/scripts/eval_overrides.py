"""The test pass of a checkpoint under config overrides.

Counterpart of ``scripts/eval_overrides.py``: rebuilds the training setup
from the checkpoint's config with the overrides and runs ``Trainer.test``
(with validation FID where the statistics and the Inception weights exist).

    python -m bsi_torch.scripts.eval_overrides -c <ckpt_dir> [-o out.json] [overrides...]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ._common import load_trainer


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m bsi_torch.scripts.eval_overrides", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("-o", "--out", default=None)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_intermixed_args(argv)

    trainer, config, data = load_trainer(args.checkpoint, args.overrides)
    metrics = trainer.test()
    print(json.dumps(metrics, indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    sys.exit(main())
