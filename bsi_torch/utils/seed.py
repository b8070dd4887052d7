"""Seed handling.

Counterpart of ``bsi_tpu/utils/seed.py``: one run seed, generated when the
config has none and stored back into it, from which the trainer derives the
parameters' initialisation, the train state's generator and its dropout
seed, and the data module its streams.
"""

from __future__ import annotations

import numpy as np

_MAX_SEED = 2**63 - 1


def resolve_seed(config: dict) -> int:
    """Return the run seed, generating one if the config has none, and store
    it back into the config (as an int; JSON-safe)."""
    seed = config.get("seed")
    if seed is None:
        seed = int(np.random.SeedSequence().entropy % _MAX_SEED)
    seed = int(seed) % _MAX_SEED
    config["seed"] = seed
    return seed
