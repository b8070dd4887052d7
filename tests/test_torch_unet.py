"""The port's VDM-UNet against the JAX package's, on converted flax weights."""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

from bsi_tpu.models import DenoisingVDMUNet as JaxUNet
from bsi_tpu.nn import FourierFeatures as JaxFF
from bsi_tpu.nn import NyquistPositionalEmbedding as JaxNyquist

from bsi_torch.convert import params_from_jax
from bsi_torch.models import DenoisingVDMUNet
from bsi_torch.nn import FourierFeatures, NyquistPositionalEmbedding

TINY = dict(data_shape=(8, 8, 3), dim=32, levels=2)


def tiny_pair(heads: int, seed: int = 0, fourier: bool = True):
    """A flax-initialised tiny JAX UNet, its params, and the port's UNet at f64
    carrying the same weights."""
    ref = JaxUNet(pos_emb=JaxNyquist(8, 100), fourier_features=JaxFF(6, 8) if fourier else None,
                  n_attention_heads=heads, **TINY)
    params = ref.init(jax.random.key(seed), jnp.zeros((2, 8, 8, 3)), jnp.zeros((2,)))
    ours = DenoisingVDMUNet(pos_emb=NyquistPositionalEmbedding(8, 100),
                            fourier_features=FourierFeatures(6, 8) if fourier else None,
                            n_attention_heads=heads, device="cpu", **TINY)
    ours.load_state_dict(params_from_jax(params))
    return ref, params, ours.double().eval()


@pytest.mark.parametrize("heads", [1, 2])
def test_forward_matches_jax_f64(heads):
    ref, params, ours = tiny_pair(heads)
    rng = np.random.default_rng(heads)
    mu = rng.normal(size=(3, 8, 8, 3))
    t = rng.uniform(size=(3,))
    want = np.asarray(ref.apply(params, jnp.asarray(mu), jnp.asarray(t)))
    with torch.inference_mode():
        got = ours(torch.from_numpy(mu), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (3, 8, 8, 3)
    # the gap is JAX's f32 attention logits (f64 everywhere else)
    npt.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_converter_uses_every_flax_leaf_once():
    _, params, ours = tiny_pair(1)
    state = params_from_jax(params)
    leaves = jax.tree_util.tree_leaves(params)
    assert len(state) == len(leaves)
    assert set(state) == set(ours.state_dict())
    for name, tensor in ours.state_dict().items():
        assert tensor.shape == state[name].shape, name
    assert sum(x.size for x in leaves) == sum(p.numel() for p in ours.parameters())


def test_bf16_cast_points():
    _, _, ours = tiny_pair(1)
    bf16 = DenoisingVDMUNet(pos_emb=NyquistPositionalEmbedding(8, 100),
                            fourier_features=FourierFeatures(6, 8), dtype=torch.bfloat16,
                            device="cpu", **TINY).eval()
    bf16.load_state_dict({k: v.float() for k, v in ours.state_dict().items()})
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    mu = torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    t = torch.rand(2, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        out = bf16(mu, t)
        full = ours(mu.double(), t.double())
    assert out.dtype == torch.bfloat16 and out.shape == mu.shape
    scale = full.abs().max().item()
    assert (out.double() - full).abs().max().item() <= 0.05 * scale


def test_flax_default_init_scale():
    ours = DenoisingVDMUNet(pos_emb=NyquistPositionalEmbedding(8, 100), device="cpu", **TINY)
    w = ours.unet.down_0.conv1.weight
    fan_in = w[0].numel()
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.1
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / np.sqrt(fan_in) + 1e-6
    assert torch.all(ours.unet.down_0.conv1.bias == 0)
    assert torch.all(ours.unet.down_0.GroupNorm_0.weight == 1)
