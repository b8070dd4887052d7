"""The port's Adam and AdamW with the first moment stored in bf16 and the
second in the parameters' dtype (``mu_dtype`` alone), against optax over 20
steps on the same gradients."""

import numpy as np
import numpy.testing as npt
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from bsi_tpu.train import make_optimizer as jax_make_optimizer

from bsi_torch.convert import _find_adam_state
from bsi_torch.train import make_optimizer

STEPS = 20


def bf16_bits(a) -> np.ndarray:
    """The bit patterns of bf16 values from JAX (ml_dtypes) or torch."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_mu_dtype_alone_matches_optax(name):
    rng = np.random.default_rng(0)
    params = rng.normal(size=(64, 64)).astype(np.float32)
    grads = [rng.normal(size=(64, 64)).astype(np.float32) for _ in range(STEPS)]
    kw = dict(name=name, weight_decay=0.1, mu_dtype="bfloat16")
    tx_ref = jax_make_optimizer(1e-3, **kw)
    jp = {"w": jnp.asarray(params)}
    st_ref = tx_ref.init(jp)
    tx = make_optimizer(1e-3, **kw)
    ours = {"w": torch.from_numpy(params.copy())}
    st = tx.init(ours)
    assert st.mu["w"].dtype == torch.bfloat16 and st.nu["w"].dtype == torch.float32
    for g in grads:
        updates, st_ref = tx_ref.update({"w": jnp.asarray(g)}, st_ref, jp)
        jp = optax.apply_updates(jp, updates)
        tx.update([torch.from_numpy(g.copy())], st, ours)
    adam = _find_adam_state(st_ref)
    assert adam.mu["w"].dtype == jnp.bfloat16 and st.count == int(adam.count) == STEPS
    # mu is rounded to bf16 at the same points as optax's: the same bits
    npt.assert_array_equal(bf16_bits(st.mu["w"]), bf16_bits(adam.mu["w"]))
    npt.assert_allclose(st.nu["w"].numpy(), np.asarray(adam.nu["w"]), rtol=1e-6)
    # the parameters within 1e-6 of their norm, and within 1e-5 of the 20
    # steps' update (measured: 8e-9 and 1.4e-6; before mu was rounded as
    # optax rounds it, 4e-5 and 7e-3)
    want = np.asarray(jp["w"])
    diff = np.linalg.norm(ours["w"].numpy() - want)
    assert diff <= 1e-6 * np.linalg.norm(want)
    assert diff <= 1e-5 * np.linalg.norm(want - params)
