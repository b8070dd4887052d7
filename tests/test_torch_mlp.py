"""The port's DenoisingMLP against the JAX package's on the same weights, in
f64 on the CPU."""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from bsi_tpu.models import DenoisingMLP as JaxMLP
from bsi_tpu.nn import FourierFeatures as JaxFF
from bsi_tpu.nn import NyquistPositionalEmbedding as JaxNyquist

from bsi_torch.convert import params_from_jax, params_to_jax
from bsi_torch.models import DenoisingMLP
from bsi_torch.nn import FourierFeatures, NyquistPositionalEmbedding

SHAPE = (4, 4, 3)


def mlp_pair(*, fourier: bool, layers: int, actfn: str = "silu", zero_init: bool = False, seed: int = 0):
    """A flax-initialised JAX DenoisingMLP, its params in f64, and the port's
    at f64 carrying the same weights."""
    kw = dict(hidden_width=16, layers=layers, actfn=actfn, zero_init=zero_init)
    ref = JaxMLP(data_shape=SHAPE, pos_emb=JaxNyquist(8, 100), fourier_features=JaxFF(6, 8) if fourier else None,
                 **kw)
    params = ref.init(jax.random.key(seed), jnp.zeros((2,) + SHAPE), jnp.zeros((2,)))
    params = jax.tree.map(lambda a: a.astype(jnp.float64), params)
    ours = DenoisingMLP(SHAPE, NyquistPositionalEmbedding(8, 100),
                        fourier_features=FourierFeatures(6, 8) if fourier else None, device="cpu", **kw)
    state = params_from_jax(params)
    assert set(state) == set(ours.state_dict())
    ours.load_state_dict(state)
    return ref, params, ours.double().eval()


@pytest.mark.parametrize("fourier,layers,actfn", [(True, 2, "silu"), (False, 3, "gelu"), (True, 1, "relu")])
def test_forward_matches_jax_f64(fourier, layers, actfn):
    ref, params, ours = mlp_pair(fourier=fourier, layers=layers, actfn=actfn, seed=layers)
    rng = np.random.default_rng(layers)
    mu = rng.normal(size=(5,) + SHAPE)
    t = rng.uniform(size=(5,))
    want = np.asarray(ref.apply(params, jnp.asarray(mu), jnp.asarray(t)))
    with torch.inference_mode():
        got = ours(torch.from_numpy(mu), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (5,) + SHAPE
    npt.assert_allclose(got, want, atol=1e-10, rtol=0)
    # and back: the port's parameters name every flax leaf
    back = params_to_jax(ours.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(params["params"]):
        got_leaf = back
        for key in path:
            got_leaf = got_leaf[key.key]
        npt.assert_array_equal(got_leaf, np.asarray(leaf))


def test_zero_init_head_and_bf16_compute():
    _, _, ours = mlp_pair(fourier=True, layers=2, zero_init=True)
    assert torch.count_nonzero(ours.head.weight) == 0 and torch.count_nonzero(ours.head.bias) == 0
    bf16 = DenoisingMLP(SHAPE, NyquistPositionalEmbedding(8, 100), hidden_width=16, dtype=torch.bfloat16,
                        device="cpu")
    out = bf16(torch.randn((2,) + SHAPE), torch.rand(2))
    assert out.dtype == torch.bfloat16 and out.shape == (2,) + SHAPE
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
