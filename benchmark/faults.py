"""Faults planted under a run's timed path, to show that its check catches
them: the fault test (``tests/test_bench_faults.py``) drives whole runs with
each, and ``calibrate.py`` reads each one's numbers at a cell's own size.

- ``unchanged``: a train step that returns its state unchanged (it runs
  and reports its loss, then puts every tensor of the state back); a
  sampler whose steps leave the belief as it was.
- ``half``: a train step over half the batch, the mean over that half; a
  sampling call that leaves out half the batch's samples (zeros).
- ``altered``: a sampling call whose samples are altered where they are
  produced (scaled by 1.001).
"""

from __future__ import annotations

import torch

TRAIN = ("unchanged", "half")
SAMPLE = ("unchanged", "half", "altered")


def plant(trainer, name: str, driver: str) -> None:
    """Breaks ``trainer`` (built by ``build_task``) with fault ``name``."""
    if driver == "train":
        step = trainer._train_step
        if name == "half":
            trainer._train_step = lambda state, batch: step(state, batch[: batch.shape[0] // 2])
        elif name == "unchanged":
            def unchanged(state, batch):
                keep = [{n: v.detach().clone() for n, v in d.items()}
                        for d in (state.params, state.ema_params, state.opt_state.mu, state.opt_state.nu)]
                count = (state.step, state.opt_state.count)
                state, metrics = step(state, batch)
                with torch.no_grad():
                    for d, saved in zip((state.params, state.ema_params, state.opt_state.mu, state.opt_state.nu), keep):
                        for n, v in saved.items():
                            d[n].copy_(v)
                state.step, state.opt_state.count = count
                return state, metrics
            trainer._train_step = unchanged
        else:
            raise ValueError(f"no train fault {name!r}")
        return
    sample = trainer.sample_fn
    if name == "half":
        def half(*args, **kw):
            out = sample(*args, **kw).clone()
            out[out.shape[0] // 2:] = 0.0
            return out
        trainer.sample_fn = half
    elif name == "altered":
        trainer.sample_fn = lambda *args, **kw: sample(*args, **kw) * 1.001
    elif name == "unchanged":
        algo = trainer.algorithm

        def still(model_fn, eps0, step_eps, t, *, with_history=False):
            mu = torch.rsqrt(algo.p_lambda.icdf(t)[0]) * eps0
            for i in range(t.shape[0] - 1):
                algo._predict_x(model_fn, mu, t[i].expand(mu.shape[0]))
                step_eps(i)
            return mu, None

        object.__setattr__(algo, "_sample_loop", still)
    else:
        raise ValueError(f"no sample fault {name!r}")
