"""The port's BFN baseline against the JAX package's on the CPU, in f64, on
JAX's own draws: the flow distribution and the clipped x-prediction, every
loss part, the ELBO and the n-step ELBO, the train loss and its gradients,
and the additive-accuracy sampler along one trajectory; and the JAX
package's two fixes of the reference (``t=None`` in the n-step loss, time
draws ``(n_samples, batch)`` without low-discrepancy sampling). The
denoiser is a small MLP whose flax weights the port carries through
``bsi_torch.convert``. Tolerance: 1e-10 relative (f64 on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from bsi_tpu.core import BFN as JaxBFN
from bsi_tpu.core import Discretization as JaxDiscretization
from bsi_tpu.core.common import sample_lds_t as jax_sample_lds_t

from bsi_torch.convert import params_to_jax
from bsi_torch.core import BFN, Discretization

from test_torch_mlp import SHAPE, mlp_pair
from test_torch_train import batch_of
from test_torch_unet16 import as_torch, jax_elbo_draws
from test_torch_vdm import close

KW = dict(data_shape=SHAPE, sigma_1=1e-3, k=5)


def pair(discretize: bool = False, lds: bool = True):
    kw = dict(KW, low_discrepancy_sampling=lds)
    return (JaxBFN(discretization=JaxDiscretization.image_8bit() if discretize else None, **kw),
            BFN(discretization=Discretization.image_8bit() if discretize else None, **kw))


def models(seed=0):
    ref, params, ours = mlp_pair(fourier=False, layers=2, seed=seed)
    return (lambda mu, t: ref.apply(params, mu, t)), ours, (ref, params)


def test_flow_distribution_and_prediction_match_jax():
    ref, ours = pair()
    jax_fn, port_fn, _ = models(1)
    x_np, x = batch_of(2, (3,) + SHAPE)
    # t = 0 (below t_min: a zero prediction), tiny, mid, 1
    t_np = np.array([[0.0, 1e-7, 0.5], [0.3, 0.9, 1.0]])
    key = jax.random.key(3)
    want = ref._sample_flow_distribution(key, jnp.asarray(x_np), jnp.asarray(t_np))
    (eps,) = as_torch(jax.random.normal(key, t_np.shape + SHAPE, jnp.float64))
    mu = ours._flow(x, torch.from_numpy(t_np), eps)
    close(mu, want)
    flat_mu, flat_t = mu.reshape((-1,) + SHAPE), torch.from_numpy(t_np).reshape(-1)
    with torch.inference_mode():
        got = ours._predict_x(port_fn, flat_mu, flat_t)
    close(got, ref._predict_x(jax_fn, jnp.asarray(flat_mu.numpy()), jnp.asarray(flat_t.numpy())), atol=1e-14)
    assert torch.equal(got[0], torch.zeros(SHAPE, dtype=torch.float64))  # t < t_min
    assert got.abs().max() <= 1.0  # clipped to [x_min, x_max]
    with pytest.raises(ValueError, match="sigma_1"):
        BFN(data_shape=SHAPE, sigma_1=1.0)


@pytest.mark.parametrize("discretize", [False, True])
def test_reconstruction_loss_matches_jax(discretize):
    ref, ours = pair(discretize)
    jax_fn, port_fn, _ = models(4)
    x_np, x = batch_of(5, (3,) + SHAPE)
    key = jax.random.key(6)
    want = ref.reconstruction_loss(jax_fn, key, jnp.asarray(x_np), 2)
    (eps,) = as_torch(jax.random.normal(key, (2, 3) + SHAPE, jnp.float64))
    with torch.inference_mode():
        got = ours._reconstruction_loss_on(port_fn, x, eps)
    assert got.shape == (2, 3)
    close(got, want)


@pytest.mark.parametrize("lds", [True, False])
def test_continuous_time_loss_matches_jax(lds):
    ref, ours = pair(lds=lds)
    jax_fn, port_fn, _ = models(7)
    x_np, x = batch_of(8, (3,) + SHAPE)
    key = jax.random.key(9)
    want = ref.continuous_time_loss(jax_fn, key, jnp.asarray(x_np), 2)
    rng_t, rng_mu = jax.random.split(key)
    t, eps = as_torch(jax_sample_lds_t(rng_t, 2, 3, low_discrepancy=lds, dtype=jnp.float64),
                      jax.random.normal(rng_mu, (2, 3) + SHAPE, jnp.float64))
    with torch.inference_mode():
        got = ours._continuous_time_loss_on(port_fn, x, t, eps)
    close(got, want)
    # the reference's non-LDS branch returns (batch, n_samples); the port, as
    # the JAX package, (n_samples, batch) either way
    g = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        assert ours.continuous_time_loss(port_fn, g, x, 2).shape == (2, 3)


@pytest.mark.parametrize("schedule", ["default", "given"])
def test_discrete_time_loss_matches_jax(schedule):
    ref, ours = pair()
    jax_fn, port_fn, _ = models(10)
    x_np, x = batch_of(11, (3,) + SHAPE)
    t_np = None if schedule == "default" else np.array([0.0, 0.3, 0.6, 0.9, 1.0])
    n = KW["k"] if t_np is None else len(t_np) - 1
    key = jax.random.key(12)
    # t=None: the reference crashes here (``self.linspace``), the JAX package
    # and the port run the default schedule
    want = ref.discrete_time_loss(jax_fn, key, jnp.asarray(x_np), 3, t=None if t_np is None else jnp.asarray(t_np))
    rng_i, rng_mu = jax.random.split(key)
    i, eps = as_torch(jax.random.randint(rng_i, (3, 3), 0, n), jax.random.normal(rng_mu, (3, 3) + SHAPE, jnp.float64))
    with torch.inference_mode():
        got = ours._discrete_time_loss_on(port_fn, x, i, eps, t=None if t_np is None else torch.from_numpy(t_np))
    assert got.dtype == torch.float64
    close(got, want)
    g = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        assert torch.isfinite(ours.discrete_time_loss(port_fn, g, x, 3)).all()


@pytest.mark.parametrize("discretize", [False, True])
def test_elbo_and_finite_elbo_match_jax(discretize):
    ref, ours = pair(discretize)
    jax_fn, port_fn, _ = models(13)
    x_np, x = batch_of(14, (3,) + SHAPE)
    key = jax.random.key(15)
    want = ref.elbo(jax_fn, key, jnp.asarray(x_np), 2, 3, estimate_var=True)
    with torch.inference_mode():
        got = ours._elbo_on(port_fn, x, *jax_elbo_draws(key, x.shape, 2, 3), estimate_var=True)
    for g, w in zip(got[:2], want[:2]):
        close(g, w)
    assert set(got[2]) == set(want[2]) == {"l_recon", "l_latent", "bpd_var"}
    for name in want[2]:
        close(got[2][name], want[2][name])

    want = ref.finite_elbo(jax_fn, key, jnp.asarray(x_np), 2, 3)
    with torch.inference_mode():
        got = ours._finite_elbo_on(port_fn, x, *jax_elbo_draws(key, x.shape, 2, 3, finite_k=KW["k"]))
    for g, w in zip(got[:2], want[:2]):
        close(g, w)
    for name in want[2]:
        close(got[2][name], want[2][name])


def test_train_loss_and_gradients_match_jax():
    ref, ours = pair()
    jax_fn, port_fn, (model, params) = models(16)
    x_np, x = batch_of(17, (4,) + SHAPE)
    key = jax.random.key(18)

    def loss_fn(p):
        return ref.train_loss(lambda mu, t: model.apply(p, mu, t), key, jnp.asarray(x_np)).mean()

    want_loss, want = jax.value_and_grad(loss_fn)(params)
    rng_t, rng_mu = jax.random.split(key)
    t, eps = as_torch(jax_sample_lds_t(rng_t, 1, 4, dtype=jnp.float64)[0],
                      jax.random.normal(rng_mu, (4,) + SHAPE, jnp.float64))
    per_example = ours._train_loss_on(port_fn, x, t, eps)
    assert per_example.shape == (4,)  # the reference reduces to a scalar
    close(per_example, ref.train_loss(jax_fn, key, jnp.asarray(x_np)))
    named = dict(port_fn.named_parameters())
    loss = per_example.mean()
    close(loss, want_loss)
    grads = params_to_jax(dict(zip(named, torch.autograd.grad(loss, list(named.values())))))
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, w in jax.tree_util.tree_leaves_with_path(want["params"]):
        close(got[path], w, atol=1e-12)


@pytest.mark.parametrize("schedule", ["default", "given"])
def test_sampler_matches_jax_along_one_trajectory(schedule):
    ref, ours = pair()
    jax_fn, port_fn, _ = models(19)
    t_np = None if schedule == "default" else np.array([0.0, 0.2, 0.5, 0.8, 1.0])
    t_jax = None if t_np is None else jnp.asarray(t_np)
    key = jax.random.key(20)
    want = ref.sample(jax_fn, key, 3, t=t_jax, dtype=jnp.float64)
    want_mus, want_x_hats, want_ys = ref.sample_history(jax_fn, key, 3, t=t_jax, dtype=jnp.float64)
    shape = (3,) + SHAPE
    k = KW["k"] if t_np is None else len(t_np) - 1
    keys = jax.random.split(key, k)  # one key a step, no initial draw
    step_eps = lambda i: as_torch(jax.random.normal(keys[i], shape, jnp.float64))[0]
    t = ours.default_schedule(torch.float64) if t_np is None else torch.from_numpy(t_np)
    with torch.inference_mode():
        mu, (mus, x_hats, ys) = ours._sample_loop(port_fn, 3, step_eps, t, with_history=True)
        final = ours._predict_x(port_fn, mu, t.new_ones((3,)))
    close(final, want, atol=1e-14)
    close(torch.stack(mus), want_mus, atol=1e-14)
    close(torch.stack(x_hats + [final]), want_x_hats, atol=1e-14)
    close(torch.stack(ys), want_ys, atol=1e-12)
    # the port's own entry points
    g = lambda: torch.Generator().manual_seed(1)
    s = ours.sample(port_fn, g(), 3, device="cpu", dtype=torch.float64)
    mus, x_hats, ys = ours.sample_history(port_fn, g(), 3, device="cpu", dtype=torch.float64)
    assert s.shape == shape and mus.shape == x_hats.shape == (KW["k"] + 1,) + shape and ys.shape == (KW["k"],) + shape
    assert torch.equal(x_hats[-1], s)
