"""The VDM-UNet with ``downsampling_attention``, an attention tail on every
residual block, on the CPU against the JAX package: a tiny gelu model's
forward and train-loss gradients on the same weights and draws, the
converter's names for the tails, and silu still refused (flax cannot build
it)."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from bsi_tpu.core import BSI as JaxBSI
from bsi_tpu.core.common import sample_lds_t as jax_sample_lds_t
from bsi_tpu.models import DenoisingVDMUNet as JaxUNet
from bsi_tpu.nn import FourierFeatures as JaxFF
from bsi_tpu.nn import NyquistPositionalEmbedding as JaxNyquist

from bsi_torch.convert import params_from_jax, params_to_jax
from bsi_torch.core import BSI
from bsi_torch.models import DenoisingVDMUNet
from bsi_torch.nn import FourierFeatures, NyquistPositionalEmbedding

from test_torch_train import batch_of

IMG = (8, 8, 3)
TINY = dict(data_shape=IMG, dim=32, levels=2, actfn="gelu", downsampling_attention=True, n_attention_heads=1)
KW = dict(lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, preconditioning="edm")


def tail_pair(seed: int = 0):
    """A flax-initialised tiny gelu JAX UNet with attention tails, its
    params, and the port's at f64 carrying the same weights."""
    ref = JaxUNet(pos_emb=JaxNyquist(8, 100), fourier_features=JaxFF(6, 8), **TINY)
    params = ref.init(jax.random.key(seed), jnp.zeros((2,) + IMG), jnp.zeros((2,)))
    ours = DenoisingVDMUNet(pos_emb=NyquistPositionalEmbedding(8, 100), fourier_features=FourierFeatures(6, 8),
                            device="cpu", **TINY)
    ours.load_state_dict(params_from_jax(params))
    return ref, params, ours.double().eval()


def flat(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf) for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_every_flax_leaf_is_used_once_and_round_trips():
    _, params, ours = tail_pair(0)
    state = params_from_jax(params)
    # every flax leaf became one tensor of the port's model, and the port has no other
    assert len(state) == len(flat(params["params"]))
    assert set(state) == set(ours.state_dict())
    for block in ("down_0", "down_1", "center_in", "center_out", "up_0", "up_1"):
        assert f"unet.{block}.GroupNorm_1.weight" in state
        assert f"unet.{block}.Attention2D_0.to_qkv.weight" in state
    back = flat(params_to_jax(state))
    want = flat(params["params"])
    assert set(back) == set(want)
    for path, leaf in want.items():
        npt.assert_array_equal(back[path], leaf, err_msg=path)


def test_forward_with_attention_tails_matches_jax_f64():
    ref, params, ours = tail_pair(1)
    rng = np.random.default_rng(1)
    mu, t = rng.normal(size=(3,) + IMG), rng.uniform(size=(3,))
    want = np.asarray(ref.apply(params, jnp.asarray(mu), jnp.asarray(t)))
    with torch.inference_mode():
        got = ours(torch.from_numpy(mu), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (3,) + IMG
    # the gap is JAX's f32 attention logits in 7 attentions (f64 everywhere else)
    npt.assert_allclose(got, want, atol=1e-6 * max(1.0, np.abs(want).max()), rtol=0)


def test_train_loss_gradients_with_attention_tails_match_jax():
    ref, ours = JaxBSI(data_shape=IMG, **KW), BSI(data_shape=IMG, **KW)
    model, params, port_model = tail_pair(2)
    x_np, x = batch_of(3, (2,) + IMG)
    key = jax.random.key(4)

    def loss_fn(p):
        return ref.train_loss(lambda mu, t: model.apply(p, mu, t), key, jnp.asarray(x_np)).mean()

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    # JAX's draws, split as bsi_tpu/core/bsi.py splits the key
    rng_lambda, rng_mu = jax.random.split(key)
    t = torch.from_numpy(np.array(jax_sample_lds_t(rng_lambda, 1, 2, dtype=jnp.float64)[0]))
    eps = torch.from_numpy(np.array(jax.random.normal(rng_mu, x.shape, jnp.float64)))
    named = dict(port_model.named_parameters())
    loss = ours._train_loss_on(port_model, x, t, eps).mean()
    grads = flat(params_to_jax(dict(zip(named, torch.autograd.grad(loss, list(named.values()))))))
    npt.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    flat_want = flat(want["params"])
    assert set(grads) == set(flat_want)
    # each leaf within 1e-5 of its norm: JAX's f32 attention logits (~1e-7
    # of the forward) through the backward
    for path, w in flat_want.items():
        assert np.linalg.norm(grads[path] - w) <= 1e-5 * np.linalg.norm(w), path


def test_silu_with_attention_tails_raises_as_flax_does():
    with pytest.raises(Exception):
        JaxUNet(pos_emb=JaxNyquist(8, 100), **{**TINY, "actfn": "silu"}).init(
            jax.random.key(0), jnp.zeros((1,) + IMG), jnp.zeros((1,)))
    with pytest.raises(ValueError, match="silu"):
        DenoisingVDMUNet(pos_emb=NyquistPositionalEmbedding(8, 100), device="cpu", **{**TINY, "actfn": "silu"})
