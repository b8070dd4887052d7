"""Gradient accumulation in the port's train step against the JAX package's
scan over micro-batches, on JAX's own draws for each micro-batch, and the
dropout masks of the micro-batches."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bsi_tpu.core import BSI as JaxBSI
from bsi_tpu.core.common import sample_lds_t as jax_sample_lds_t
from bsi_tpu.train import EMAConfig as JaxEMAConfig
from bsi_tpu.train import TrainState as JaxTrainState
from bsi_tpu.train import make_optimizer as jax_make_optimizer
from bsi_tpu.train import make_train_step as jax_make_train_step
from bsi_tpu.train import warmup_cosine_schedule as jax_warmup_cosine

from bsi_torch.core import BSI
from bsi_torch.train import EMAConfig, TrainState, make_optimizer, make_train_step, warmup_cosine_schedule

from test_torch_train import (EMA, KW, SMALL, assert_state_close, batch_of, closed_form_params,
                              jax_closed_form, port_closed_form, to_port)


def jax_micro_draws(key, step, micro, accum, batch_size, algo_shape):
    """The t and eps of micro-batch ``micro`` in the JAX step at ``step``:
    ``fold_in`` -> ``split`` (algorithm, dropout) -> ``split(rng_algo,
    accum)[micro]`` -> ``train_loss``'s split (lambda, mu)."""
    rng_algo, _ = jax.random.split(jax.random.fold_in(key, step))
    rng_lambda, rng_mu = jax.random.split(jax.random.split(rng_algo, accum)[micro])
    t = jax_sample_lds_t(rng_lambda, 1, batch_size, dtype=jnp.float64)[0]
    eps = jax.random.normal(rng_mu, (batch_size,) + algo_shape, jnp.float64)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps))


@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_trajectory_matches_jax(accum):
    seed, micro = 30 + accum, 3
    ref, ours = JaxBSI(data_shape=SMALL, **KW), BSI(data_shape=SMALL, **KW)
    sched = dict(lr=5e-2, warmup_steps=2, max_steps=8)
    tx_ref = jax_make_optimizer(jax_warmup_cosine(**sched))
    p = closed_form_params(seed)
    jp = jax.tree.map(jnp.asarray, p)
    key = jax.random.key(seed)
    jax_state = JaxTrainState.create(params=jp, opt_state=tx_ref.init(jp), rng=key)
    jax_step = jax.jit(jax_make_train_step(ref, jax_closed_form, tx_ref, JaxEMAConfig(**EMA), accum_steps=accum))
    tx = make_optimizer(warmup_cosine_schedule(**sched))
    params = {k: v.requires_grad_() for k, v in to_port(p).items()}
    state = TrainState.create(params=params, opt_state=tx.init(params), generator=torch.Generator())
    noise = lambda step, batch, i: jax_micro_draws(key, step, i, accum, batch.shape[0], SMALL)
    port_step = make_train_step(ours, port_closed_form, tx, EMAConfig(**EMA), accum_steps=accum, noise=noise)
    to_jax = lambda d: {k: v.detach().numpy() for k, v in d.items()}
    for step in range(3):
        x_np, x = batch_of(40 + step, (accum, micro) + SMALL)
        jax_state, metrics = jax_step(jax_state, jnp.asarray(x_np))
        state, port_metrics = port_step(state, x)
        assert_state_close(state, jax_state, port_metrics, metrics, rtol=1e-12, atol=1e-12, to_jax=to_jax)
    assert state.step == 3 and state.opt_state.count == 3


def test_accumulation_wants_the_micro_batch_axis():
    algo = BSI(data_shape=SMALL, **KW)
    params = {k: v.requires_grad_() for k, v in to_port(closed_form_params(0)).items()}
    tx = make_optimizer(1e-3)
    state = TrainState.create(params=params, opt_state=tx.init(params), generator=torch.Generator())
    step = make_train_step(algo, port_closed_form, tx, EMAConfig(), accum_steps=2)
    with pytest.raises(ValueError, match="want"):
        step(state, batch_of(0, (3, 2) + SMALL)[1])
    with pytest.raises(ValueError, match="accum_steps"):
        make_train_step(algo, port_closed_form, tx, EMAConfig(), accum_steps=0)


def run_recording_masks(accum: int, dropout_seed: int) -> list[torch.Tensor]:
    """Two accumulated steps of a closed-form model with dropout on its
    input; returns the keep mask of every micro-batch, in order."""
    masks = []

    def model(p, mu, t):
        kept = torch.nn.functional.dropout(torch.ones_like(mu), p=0.5, training=True)
        masks.append(kept != 0)
        return port_closed_form(p, mu * kept, t)

    algo = BSI(data_shape=SMALL, **KW)
    params = {k: v.requires_grad_() for k, v in to_port(closed_form_params(1)).items()}
    tx = make_optimizer(1e-3)
    state = TrainState.create(params=params, opt_state=tx.init(params),
                              generator=torch.Generator().manual_seed(2), dropout_seed=dropout_seed)
    step = make_train_step(algo, model, tx, EMAConfig(), accum_steps=accum)
    x = batch_of(3, (1, 4) + SMALL)[1].expand((accum, 4) + SMALL)  # the same images in every slot
    for _ in range(2):
        state, _ = step(state, x)
    return masks


def test_micro_batches_draw_their_own_masks_and_reruns_repeat_them():
    masks = run_recording_masks(2, dropout_seed=7)
    assert len(masks) == 4
    for a in range(4):
        for b in range(a):
            assert not torch.equal(masks[a], masks[b]), (a, b)
    torch.manual_seed(123)  # the caller's generator does not enter the masks
    again = run_recording_masks(2, dropout_seed=7)
    assert all(torch.equal(m, n) for m, n in zip(masks, again))
    other = run_recording_masks(2, dropout_seed=8)
    assert not any(torch.equal(m, n) for m, n in zip(masks, other))
