"""The port's VDM baseline against the JAX package's on the CPU, in f64, on
JAX's own draws: the noise schedule, every loss part, the ELBO and the
finite-step ELBO, the train loss and its gradients, and the ancestral
sampler along one trajectory. The denoiser is a small MLP whose flax
weights the port carries through ``bsi_torch.convert``. Tolerance: 1e-10
relative (f64 on both sides; the sums run in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from bsi_tpu.core import VDM as JaxVDM
from bsi_tpu.core import Discretization as JaxDiscretization
from bsi_tpu.core.common import sample_lds_t as jax_sample_lds_t

from bsi_torch.convert import params_to_jax
from bsi_torch.core import VDM, Discretization

from test_torch_mlp import SHAPE, mlp_pair
from test_torch_train import batch_of
from test_torch_unet16 import as_torch, jax_elbo_draws

KW = dict(data_shape=SHAPE, snr_min=6.73794699909e-3, snr_max=597195.613793, k=5)
RTOL = 1e-10


def pair(discretize: bool, lds: bool = True):
    kw = dict(KW, low_discrepancy_sampling=lds)
    return (JaxVDM(discretization=JaxDiscretization.image_8bit() if discretize else None, **kw),
            VDM(discretization=Discretization.image_8bit() if discretize else None, **kw))


def models(seed=0):
    """The JAX MLP's apply on its f64 params and the port's MLP on the same weights."""
    ref, params, ours = mlp_pair(fourier=False, layers=2, seed=seed)
    return (lambda mu, t: ref.apply(params, mu, t)), ours, (ref, params)


def close(got, want, rtol=RTOL, atol=0.0):
    npt.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got), np.asarray(want),
                        rtol=rtol, atol=atol)


def test_noise_schedule_matches_jax():
    ref, ours = pair(False)
    t = np.linspace(0.0, 1.0, 41)
    for name in ("gamma", "sigma2", "alpha", "snr"):
        close(getattr(ours, name)(torch.from_numpy(t)), getattr(ref, name)(jnp.asarray(t)))
    assert (ours.gamma_0, ours.gamma_1, ours.n_dim) == (ref.gamma_0, ref.gamma_1, ref.n_dim)
    close(ours.default_schedule(torch.float64), ref.default_schedule(jnp.float64), atol=1e-15)


@pytest.mark.parametrize("discretize", [False, True])
def test_prior_and_reconstruction_match_jax(discretize):
    ref, ours = pair(discretize)
    jax_fn, port_fn, _ = models()
    x_np, x = batch_of(1, (3,) + SHAPE)
    close(ours.prior_loss(x), ref.prior_loss(jnp.asarray(x_np)))
    key = jax.random.key(2)
    want = ref.reconstruction_loss(jax_fn, key, jnp.asarray(x_np), 4)
    (eps,) = as_torch(jax.random.normal(key, (4,) + x.shape, jnp.float64))
    got = ours._reconstruction_loss_on(x, eps)
    assert got.shape == (4, 3)
    close(got, want)


@pytest.mark.parametrize("lds", [True, False])
def test_inf_diffusion_loss_matches_jax(lds):
    ref, ours = pair(False, lds)
    jax_fn, port_fn, _ = models(3)
    x_np, x = batch_of(4, (3,) + SHAPE)
    key = jax.random.key(5)
    want = ref.inf_diffusion_loss(jax_fn, key, jnp.asarray(x_np), 2)
    rng_t, rng_z = jax.random.split(key)
    t = jax_sample_lds_t(rng_t, 2, 3, low_discrepancy=lds, dtype=jnp.float64)
    t, eps = as_torch(t, jax.random.normal(rng_z, (2, 3) + SHAPE, jnp.float64))
    with torch.inference_mode():
        got = ours._inf_diffusion_loss_on(port_fn, x, t, eps)
    assert got.shape == (2, 3)  # (n_samples, batch) with or without LDS
    close(got, want)


@pytest.mark.parametrize("schedule", ["default", "given"])
def test_finite_diffusion_loss_matches_jax(schedule):
    ref, ours = pair(False)
    jax_fn, port_fn, _ = models(6)
    x_np, x = batch_of(7, (3,) + SHAPE)
    t_np = None if schedule == "default" else np.array([1.0, 0.7, 0.4, 0.1, 0.0])
    T = KW["k"] if t_np is None else len(t_np) - 1
    key = jax.random.key(8)
    want = ref.finite_diffusion_loss(jax_fn, key, jnp.asarray(x_np), 3,
                                     t=None if t_np is None else jnp.asarray(t_np))
    rng_i, rng_z = jax.random.split(key)
    i, eps = as_torch(jax.random.randint(rng_i, (3, 3), 0, T), jax.random.normal(rng_z, (3, 3) + SHAPE, jnp.float64))
    with torch.inference_mode():
        got = ours._finite_diffusion_loss_on(port_fn, x, i, eps, t=None if t_np is None else torch.from_numpy(t_np))
    close(got, want)


@pytest.mark.parametrize("discretize", [False, True])
def test_elbo_and_finite_elbo_match_jax(discretize):
    ref, ours = pair(discretize)
    jax_fn, port_fn, _ = models(9)
    x_np, x = batch_of(10, (3,) + SHAPE)
    key = jax.random.key(11)
    want = ref.elbo(jax_fn, key, jnp.asarray(x_np), 2, 3, estimate_var=True)
    with torch.inference_mode():
        got = ours._elbo_on(port_fn, x, *jax_elbo_draws(key, x.shape, 2, 3), estimate_var=True)
    for g, w in zip(got[:2], want[:2]):
        close(g, w)
    assert set(got[2]) == set(want[2]) == {"l_prior", "l_recon", "l_diff", "bpd_var"}
    for name in want[2]:
        close(got[2][name], want[2][name])

    want = ref.finite_elbo(jax_fn, key, jnp.asarray(x_np), 2, 3)
    with torch.inference_mode():
        got = ours._finite_elbo_on(port_fn, x, *jax_elbo_draws(key, x.shape, 2, 3, finite_k=KW["k"]))
    for g, w in zip(got[:2], want[:2]):
        close(g, w)
    for name in want[2]:
        close(got[2][name], want[2][name])
    with pytest.raises(ValueError, match="two samples"):
        ours._elbo_on(port_fn, x, *jax_elbo_draws(key, x.shape, 1, 3), estimate_var=True)


def test_train_loss_and_gradients_match_jax():
    ref, ours = pair(False)
    jax_fn, port_fn, (model, params) = models(12)
    x_np, x = batch_of(13, (4,) + SHAPE)
    key = jax.random.key(14)

    def loss_fn(p):
        return ref.train_loss(lambda mu, t: model.apply(p, mu, t), key, jnp.asarray(x_np)).mean()

    want_loss, want = jax.value_and_grad(loss_fn)(params)
    rng_t, rng_z = jax.random.split(key)
    t, eps = as_torch(jax_sample_lds_t(rng_t, 1, 4, dtype=jnp.float64)[0],
                      jax.random.normal(rng_z, (1, 4) + SHAPE, jnp.float64)[0])
    per_example = ours._train_loss_on(port_fn, x, t, eps)
    assert per_example.shape == (4,)
    close(per_example, ref.train_loss(jax_fn, key, jnp.asarray(x_np)))
    named = dict(port_fn.named_parameters())
    loss = per_example.mean()
    close(loss, want_loss)
    grads = params_to_jax(dict(zip(named, torch.autograd.grad(loss, list(named.values())))))
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, w in jax.tree_util.tree_leaves_with_path(want["params"]):
        close(got[path], w, atol=1e-12)
    # the port's own draws: a finite per-example loss
    g = torch.Generator().manual_seed(0)
    assert torch.isfinite(ours.train_loss(port_fn, g, x)).all()


@pytest.mark.parametrize("schedule", ["default", "given"])
def test_sampler_matches_jax_along_one_trajectory(schedule):
    ref, ours = pair(False)
    jax_fn, port_fn, _ = models(15)
    t_np = None if schedule == "default" else np.array([1.0, 0.8, 0.5, 0.2, 0.0])
    t_jax = None if t_np is None else jnp.asarray(t_np)
    key = jax.random.key(16)
    want = ref.sample(jax_fn, key, 3, t=t_jax, dtype=jnp.float64)
    want_hist = ref.sample_history(jax_fn, key, 3, t=t_jax, dtype=jnp.float64)
    # _sample_scan's draws: the initial latent, then one key per step
    rng0, rng_steps = jax.random.split(key)
    shape = (3,) + SHAPE
    k = KW["k"] if t_np is None else len(t_np) - 1
    (z,) = as_torch(jax.random.normal(rng0, shape, jnp.float64))
    keys = jax.random.split(rng_steps, k)
    step_eps = lambda i: as_torch(jax.random.normal(keys[i], shape, jnp.float64))[0]
    t = ours.default_schedule(torch.float64) if t_np is None else torch.from_numpy(t_np)
    with torch.inference_mode():
        z_final, x_hats = ours._sample_loop(port_fn, z, step_eps, t, with_history=True)
        got = z_final / ours.alpha(t.new_zeros(()))
    close(got, want)
    assert want_hist.shape == (k + 1,) + shape and len(x_hats) == k
    close(torch.stack(x_hats + [got]), want_hist)
    # the port's own entry points: shapes, the generator's device, finite
    g = lambda: torch.Generator().manual_seed(1)
    s = ours.sample(port_fn, g(), 3, device="cpu", dtype=torch.float64)
    h = ours.sample_history(port_fn, g(), 3, device="cpu", dtype=torch.float64)
    assert s.shape == shape and h.shape == (KW["k"] + 1,) + shape
    assert torch.equal(h[-1], s) and torch.isfinite(h).all()
