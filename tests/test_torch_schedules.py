"""The port's sampling-step schedules against the JAX package's
``get_schedule``, for BSI, VDM and BFN, in f64: the same points within
1e-12, and the same refusals."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from bsi_tpu.core import BFN as JaxBFN
from bsi_tpu.core import BSI as JaxBSI
from bsi_tpu.core import VDM as JaxVDM
from bsi_tpu.core import get_schedule as jax_get_schedule

from bsi_torch.core import BFN, BSI, VDM, get_schedule

ALGOS = {
    "bsi": (dict(lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, k=50), JaxBSI, BSI),
    "vdm": (dict(snr_min=1e-2, snr_max=1e5), JaxVDM, VDM),
    "bfn": (dict(sigma_1=1e-3), JaxBFN, BFN),
}


def pair(name):
    kw, jax_cls, port_cls = ALGOS[name]
    return jax_cls(data_shape=(4,), **kw), port_cls(data_shape=(4,), **kw)


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("algo", ["bsi", "vdm", "bfn"])
def test_linear_schedules_match_jax(algo, k):
    ref, ours = pair(algo)
    want = np.asarray(jax_get_schedule("linear", k, ref, dtype=jnp.float64))
    got = get_schedule("linear", k, ours, dtype=torch.float64)
    assert got.shape == (k + 1,) and got.dtype == torch.float64
    npt.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # VDM's time runs 1 -> 0, the others' 0 -> 1
    assert (got[0].item(), got[-1].item()) == ((1.0, 0.0) if algo == "vdm" else (0.0, 1.0))


@pytest.mark.parametrize("k", [2, 20])
@pytest.mark.parametrize("name", ["cosine", "edm", "edm7"])
def test_variance_schedules_match_jax(name, k):
    ref, ours = pair("bsi")
    want = np.asarray(jax_get_schedule(name, k, ref, dtype=jnp.float64))
    got = get_schedule(name, k, ours, dtype=torch.float64)
    # variance schedules give k points, increasing in t from 0 to 1
    assert got.shape == (k,)
    npt.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    assert bool((torch.diff(got) > 0).all())
    npt.assert_allclose([got[0].item(), got[-1].item()], [0.0, 1.0], atol=1e-9)


@pytest.mark.parametrize("name", ["cosine", "edm", "edm7"])
def test_variance_schedules_refused_for_vdm(name):
    ref, ours = pair("vdm")
    with pytest.raises(ValueError):
        jax_get_schedule(name, 10, ref)
    with pytest.raises(ValueError, match="BSI/BFN-style time"):
        get_schedule(name, 10, ours)


@pytest.mark.parametrize("name", ["cosine", "edm", "edm7"])
def test_variance_schedules_need_a_precision_range(name):
    # BFN has no lambda_0 / alpha_M: the JAX package fails on the missing
    # attribute, and so does the port
    ref, ours = pair("bfn")
    with pytest.raises(AttributeError):
        jax_get_schedule(name, 10, ref)
    with pytest.raises(AttributeError):
        get_schedule(name, 10, ours)


@pytest.mark.parametrize("algo", ["bsi", "bfn"])
def test_unknown_schedule_refused(algo):
    ref, ours = pair(algo)
    with pytest.raises((ValueError, AttributeError)):
        jax_get_schedule("quadratic", 10, ref)
    expected = ValueError if algo == "bsi" else AttributeError
    with pytest.raises(expected):
        get_schedule("quadratic", 10, ours)


def test_schedules_drive_the_port_sampler():
    _, ours = pair("bsi")
    model = lambda mu, t: torch.tanh(mu)
    for name in ("cosine", "edm", "edm7"):
        t = get_schedule(name, 8, ours, dtype=torch.float64)
        s = ours.sample(model, torch.Generator().manual_seed(0), 2, device="cpu", t=t, dtype=torch.float64)
        assert s.shape == (2, 4) and bool(torch.isfinite(s).all())
