"""The port's numerics leaves against the JAX package, at f64 on the CPU."""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp

from bsi_tpu.core import BSI as JaxBSI
from bsi_tpu.core import LogUniform as JaxLogUniform
from bsi_tpu.core import normal_log_prob as jax_normal_log_prob
from bsi_tpu.core import discretized_normal_log_prob as jax_discretized_normal_log_prob
from bsi_tpu.core import Discretization as JaxDiscretization
from bsi_tpu.nn import FourierFeatures as JaxFourierFeatures
from bsi_tpu.nn import NyquistPositionalEmbedding as JaxNyquist

from bsi_torch.core import (
    BSI,
    Discretization,
    LogUniform,
    discretized_normal_log_prob,
    normal_log_prob,
)
from bsi_torch.nn import FourierFeatures, NyquistPositionalEmbedding

RTOL = 1e-12
KW = dict(data_shape=(8, 8, 3), lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, k=8)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_loguniform_matches_jax():
    rng = np.random.default_rng(0)
    ours, ref = LogUniform(1e-2, 1e6 + 1e-2), JaxLogUniform(1e-2, 1e6 + 1e-2)
    q = rng.uniform(size=64)
    lam = np.exp(rng.uniform(np.log(1e-2), np.log(1e6), size=64))
    npt.assert_allclose(ours.icdf(_t(q)).numpy(), np.asarray(ref.icdf(jnp.asarray(q))), rtol=RTOL)
    npt.assert_allclose(ours.cdf(_t(lam)).numpy(), np.asarray(ref.cdf(jnp.asarray(lam))), rtol=RTOL, atol=1e-15)
    npt.assert_allclose(
        ours.reciprocal_pdf(_t(lam)).numpy(), np.asarray(ref.reciprocal_pdf(jnp.asarray(lam))), rtol=RTOL
    )


def test_gaussian_log_probs_match_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, size=(4, 8))
    loc = x + 0.01 * rng.normal(size=x.shape)
    scale = 1.0 / np.sqrt(2e6)
    npt.assert_allclose(
        normal_log_prob(_t(x), _t(loc), scale).numpy(),
        np.asarray(jax_normal_log_prob(jnp.asarray(x), jnp.asarray(loc), scale)),
        rtol=RTOL,
    )
    ours = discretized_normal_log_prob(_t(x), _t(loc), 0.01, Discretization.image_8bit())
    ref = jax_discretized_normal_log_prob(
        jnp.asarray(x), jnp.asarray(loc), 0.01, JaxDiscretization.image_8bit()
    )
    npt.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-12)


def test_edm_coefficients_and_schedule_match_jax():
    ours, ref = BSI(**KW), JaxBSI(**KW)
    t = np.linspace(0.0, 1.0, 17)
    for a, b in zip(ours._edm_preconditioning(_t(t)), ref._edm_preconditioning(jnp.asarray(t))):
        # c_skip at t=0 is alpha / kappa with alpha = lambda_0's rounding
        # residue (~1e-18): compared absolutely there
        npt.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-15)
    npt.assert_allclose(
        ours.default_schedule(torch.float64).numpy(),
        np.asarray(ref.default_schedule(jnp.float64)),
        rtol=RTOL, atol=1e-15,
    )
    assert ours.n_dim == ref.n_dim
    assert (ours.p_lambda.low, ours.p_lambda.high) == (ref.p_lambda.low, ref.p_lambda.high)


@pytest.mark.parametrize("size,rate", [(8, 100), (32, 100), (16, 256)])
def test_nyquist_embedding_matches_jax(size, rate):
    t = np.random.default_rng(2).uniform(size=(5,))
    ours = NyquistPositionalEmbedding(size, rate)(_t(t)).numpy()
    ref = np.asarray(JaxNyquist(size, rate)(jnp.asarray(t)))
    npt.assert_allclose(ours, ref, rtol=RTOL, atol=1e-14)


def test_fourier_features_match_jax():
    x = np.random.default_rng(3).uniform(-1, 1, size=(2, 4, 4, 3))
    ours = FourierFeatures(6, 8)(_t(x)).numpy()
    ref = np.asarray(JaxFourierFeatures(6, 8)(jnp.asarray(x)))
    assert ours.shape == ref.shape == (2, 4, 4, 18)
    npt.assert_allclose(ours, ref, rtol=RTOL, atol=1e-12)


def test_unknown_preconditioning_raises():
    with pytest.raises(ValueError, match="preconditioning"):
        BSI(**{**KW, "preconditioning": "vp"})
