"""The port's BSI sampler against the JAX package's, on JAX's own noise."""

import numpy as np
import numpy.testing as npt
import torch

import jax
import jax.numpy as jnp

from bsi_tpu.core import BSI as JaxBSI

from bsi_torch.core import BSI

from test_torch_unet import tiny_pair

KW = dict(data_shape=(8, 8, 3), lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, preconditioning="edm")


def jax_draws(key, n, algo):
    """The normal draws of JAX's sampler, split as ``BSI._sample_scan`` splits them."""
    shape = (n,) + algo.data_shape
    rng0, rng_steps = jax.random.split(key)
    eps0 = jax.random.normal(rng0, shape, jnp.float64)
    steps = [jax.random.normal(k, shape, jnp.float64) for k in jax.random.split(rng_steps, algo.k)]
    return torch.from_numpy(np.array(eps0)), [torch.from_numpy(np.array(e)) for e in steps]


def port_sample(algo, model_fn, eps0, steps):
    t = algo.default_schedule(torch.float64)
    mu, hist = algo._sample_loop(model_fn, eps0, lambda i: steps[i], t, with_history=True)
    return algo._predict_x(model_fn, mu, torch.ones(eps0.shape[0], dtype=torch.float64)), hist


def test_closed_form_sampler_matches_jax():
    k, n = 8, 4
    ref, ours = JaxBSI(k=k, **KW), BSI(k=k, **KW)
    jax_fn = lambda mu, t: jnp.tanh(mu) * t[:, None, None, None]
    torch_fn = lambda mu, t: torch.tanh(mu) * t[:, None, None, None]
    key = jax.random.key(3)
    want = np.asarray(ref.sample(jax_fn, key, n, dtype=jnp.float64))
    got, (mus, x_hats, ys) = port_sample(ours, torch_fn, *jax_draws(key, n, ref))
    npt.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)
    want_mus, want_x_hats, want_ys = ref.sample_history(jax_fn, key, n, dtype=jnp.float64)
    npt.assert_allclose(torch.stack(mus).numpy(), np.asarray(want_mus), atol=1e-12, rtol=0)
    npt.assert_allclose(torch.stack(x_hats).numpy(), np.asarray(want_x_hats)[:-1], atol=1e-12, rtol=0)
    npt.assert_allclose(torch.stack(ys).numpy(), np.asarray(want_ys), atol=1e-12, rtol=0)


def test_unet_sampler_matches_jax():
    # Without Fourier features: at random weights, features of frequency up to
    # 2 pi 2^8 make the UNet so sensitive to its input that the forward's ~1e-7
    # gap (JAX's f32 attention logits) grows ~100x per step. The next test
    # covers the Fourier features along JAX's own trajectory.
    k, n = 4, 2
    ref, ours = JaxBSI(k=k, **KW), BSI(k=k, **KW)
    model, params, port_model = tiny_pair(1, seed=4, fourier=False)
    jax_fn = lambda mu, t: model.apply(params, mu, t)
    key = jax.random.key(5)
    want = np.asarray(ref.sample(jax_fn, key, n, dtype=jnp.float64))
    with torch.inference_mode():
        got, _ = port_sample(ours, port_model, *jax_draws(key, n, ref))
    npt.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_unet_decodes_along_jax_trajectory():
    k, n = 4, 2
    ref, ours = JaxBSI(k=k, **KW), BSI(k=k, **KW)
    model, params, port_model = tiny_pair(1, seed=6)
    jax_fn = lambda mu, t: model.apply(params, mu, t)
    mus, x_hats, _ = ref.sample_history(jax_fn, jax.random.key(7), n, dtype=jnp.float64)
    t = ours.default_schedule(torch.float64)  # t[k] = 1 is the final decode
    with torch.inference_mode():
        for i in range(k + 1):
            got = ours._predict_x(port_model, torch.from_numpy(np.array(mus[i])), t[i].expand(n))
            npt.assert_allclose(got.numpy(), np.asarray(x_hats[i]), atol=1e-6, rtol=0)


def test_sample_and_history_shapes():
    k, n = 3, 2
    algo = BSI(k=k, **KW)
    fn = lambda mu, t: torch.tanh(mu) * t[:, None, None, None]
    mus, x_hats, ys = algo.sample_history(fn, torch.Generator().manual_seed(0), n, device="cpu")
    assert mus.shape == (k + 1, n, 8, 8, 3)
    assert x_hats.shape == (k + 1, n, 8, 8, 3)
    assert ys.shape == (k, n, 8, 8, 3)
    a = algo.sample(fn, torch.Generator().manual_seed(0), n, device="cpu")
    b = algo.sample(fn, torch.Generator().manual_seed(0), n, device="cpu")
    assert a.shape == (n, 8, 8, 3) and a.dtype == torch.float32
    assert torch.equal(a, b) and torch.equal(a, x_hats[-1])
    assert torch.isfinite(a).all()
