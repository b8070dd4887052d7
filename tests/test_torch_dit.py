"""The port's DiT against the JAX package's, on converted flax weights."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from bsi_tpu.core import BSI as JaxBSI
from bsi_tpu.models import DenoisingDiT as JaxDiT
from bsi_tpu.models.dit import DiT as JaxDiTCore
from bsi_tpu.models.dit import modulate as jax_modulate
from bsi_tpu.models.dit import unstack_block_params
from bsi_tpu.nn import FourierFeatures as JaxFF
from bsi_tpu.nn import NyquistPositionalEmbedding as JaxNyquist

from bsi_torch.convert import params_from_jax, params_to_jax
from bsi_torch.core import BSI
from bsi_torch.models import DenoisingDiT
from bsi_torch.models.dit import DiT, modulate
from bsi_torch.nn import FourierFeatures, NyquistPositionalEmbedding

from test_torch_sampler import jax_draws, port_sample

# data 8x8x3, patch 2 (16 tokens), dim 128, depth 2; heads 2 is head_dim 64
# (two heads per qkv group), heads 1 head_dim 128
TINY = dict(data_shape=(8, 8, 3), patch_size=2, dim=128, depth=2)
KW = dict(data_shape=(8, 8, 3), lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, preconditioning="edm")


def fill_ada_out(tree, seed, std=0.02):
    """adaLN-Zero starts each ``ada_out`` at zero, so every gate is 0 and
    every block the identity: a parity check at that init passes whatever
    the blocks compute. Fill each ``ada_out`` kernel and bias with seeded
    normals (f32, as flax keeps them), in either block layout."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for name, value in node.items():
            if name == "ada_out":
                out[name] = {k: rng.normal(scale=std, size=np.shape(v)).astype(np.float32)
                             for k, v in value.items()}
            elif isinstance(value, dict):
                out[name] = walk(value)
            else:
                out[name] = value
        return out

    return walk(tree)


def tiny_dit_pair(heads: int, seed: int = 0, scan: bool = False, fourier: bool = True):
    """A flax-initialised tiny JAX DiT (``ada_out`` filled), its params, and
    the port's DiT at f64 carrying the same weights."""
    ref = JaxDiT(heads=heads, fourier_features=JaxFF(6, 8) if fourier else None, scan_blocks=scan, **TINY)
    params = ref.init(jax.random.key(seed), jnp.zeros((2, 8, 8, 3)), jnp.zeros((2,)))
    params = fill_ada_out(params, seed + 100)
    ours = DenoisingDiT(heads=heads, fourier_features=FourierFeatures(6, 8) if fourier else None,
                        device="cpu", **TINY)
    ours.load_state_dict(params_from_jax(params))
    return ref, params, ours.double().eval()


@pytest.mark.parametrize("scan", [False, True], ids=["loop", "scan"])
@pytest.mark.parametrize("heads", [2, 1])
def test_forward_matches_jax_f64(heads, scan):
    ref, params, ours = tiny_dit_pair(heads, seed=heads, scan=scan)
    rng = np.random.default_rng(heads)
    mu = rng.normal(size=(3, 8, 8, 3))
    t = rng.uniform(size=(3,))
    want = np.asarray(ref.apply(params, jnp.asarray(mu), jnp.asarray(t)))
    with torch.inference_mode():
        got = ours(torch.from_numpy(mu), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (3, 8, 8, 3)
    # ada_out filled: the blocks move the output by a visible amount
    with torch.inference_mode():
        for i in range(2):
            getattr(ours.dit, f"block_{i}").ada_out.weight.zero_()
            getattr(ours.dit, f"block_{i}").ada_out.bias.zero_()
        identity = ours(torch.from_numpy(mu), torch.from_numpy(t)).numpy()
    assert np.abs(identity - want).max() > 1e-2
    # the gap is JAX's f32 attention logits (f64 everywhere else)
    npt.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_converter_uses_every_flax_leaf_once_and_inverts():
    _, params, ours = tiny_dit_pair(2)
    state = params_from_jax(params)
    leaves = jax.tree_util.tree_leaves(params)
    assert len(state) == len(leaves)
    assert set(state) == set(ours.state_dict())
    for name, tensor in ours.state_dict().items():
        assert tensor.shape == state[name].shape, name
    assert sum(x.size for x in leaves) == sum(p.numel() for p in ours.parameters())
    back = params_to_jax(state)
    want = jax.tree_util.tree_leaves_with_path(params["params"])
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        npt.assert_array_equal(a, np.asarray(b))


def test_converter_splits_the_scan_layout():
    _, params, _ = tiny_dit_pair(2, scan=True)
    assert "blocks" in params["params"]["dit"]
    state = params_from_jax(params)
    loop = unstack_block_params(params)
    want = params_from_jax(loop)
    assert set(state) == set(want) and any(".block_1." in k for k in state)
    for name in want:
        assert torch.equal(state[name], want[name]), name
    back = params_to_jax(state)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(loop["params"])):
        assert pa == pb
        npt.assert_array_equal(a, np.asarray(b))


def test_modulate_matches_jax():
    rng = np.random.default_rng(11)
    x, shift, scale = rng.normal(size=(2, 5, 8)), rng.normal(size=(2, 8)), rng.normal(size=(2, 8))
    want = np.asarray(jax_modulate(*map(jnp.asarray, (x, shift, scale))))
    npt.assert_array_equal(modulate(*map(torch.from_numpy, (x, shift, scale))).numpy(), want)


def test_positional_tables_match_jax():
    t = np.linspace(0.0, 1.0, 7)
    npt.assert_array_equal(NyquistPositionalEmbedding(64, 32).table(t), JaxNyquist(64, 32).table(t))
    ref = JaxDiTCore(input_size=(8, 12), patch_size=2, out_channels=3, hidden_size=64, depth=1, heads=1)
    ours = DiT((8, 12), 2, 3, 3, 64, 1, 1, device="cpu")
    table = ours._pos_embedding()
    assert table.dtype == np.float64 and table.shape == (4 * 6, 64)
    npt.assert_array_equal(table, ref._pos_embedding())


def test_dit_sampler_matches_jax():
    # Free-running on JAX's own draws, without Fourier features (with them
    # the forward's gap grows ~100x a step; the next test covers them).
    k, n = 4, 2
    ref, ours_algo = JaxBSI(k=k, **KW), BSI(k=k, **KW)
    model, params, port_model = tiny_dit_pair(2, seed=8, fourier=False)
    key = jax.random.key(9)
    want = np.asarray(ref.sample(lambda mu, t: model.apply(params, mu, t), key, n, dtype=jnp.float64))
    with torch.inference_mode():
        got, _ = port_sample(ours_algo, port_model, *jax_draws(key, n, ref))
    npt.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_dit_decodes_along_jax_trajectory():
    # Per step along JAX's own trajectory: at random weights the Fourier
    # features amplify the forward's ~1e-8 gap ~100x a step, so two
    # free-running samplers would part.
    k, n = 4, 2
    ref, ours_algo = JaxBSI(k=k, **KW), BSI(k=k, **KW)
    model, params, port_model = tiny_dit_pair(2, seed=5)
    jax_fn = lambda mu, t: model.apply(params, mu, t)
    mus, x_hats, _ = ref.sample_history(jax_fn, jax.random.key(7), n, dtype=jnp.float64)
    t = ours_algo.default_schedule(torch.float64)
    with torch.inference_mode():
        for i in range(k + 1):
            got = ours_algo._predict_x(port_model, torch.from_numpy(np.array(mus[i])), t[i].expand(n))
            npt.assert_allclose(got.numpy(), np.asarray(x_hats[i]), atol=1e-6, rtol=0)


def test_bf16_cast_points():
    _, _, ours = tiny_dit_pair(1)
    bf16 = DenoisingDiT(heads=1, fourier_features=FourierFeatures(6, 8), dtype=torch.bfloat16,
                        device="cpu", **TINY).eval()
    bf16.load_state_dict({k: v.float() for k, v in ours.state_dict().items()})
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    mu = torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    t = torch.rand(2, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        out = bf16(mu, t)
        full = ours(mu.double(), t.double())
    assert out.dtype == torch.bfloat16 and out.shape == mu.shape
    assert (out.double() - full).abs().max().item() <= 0.05 * full.abs().max().item()


def test_default_init_is_adaln_zero():
    ours = DenoisingDiT(heads=2, device="cpu", **TINY)
    block = ours.dit.block_0
    assert torch.all(block.ada_out.weight == 0) and torch.all(block.ada_out.bias == 0)
    w = block.attn.to_qkv.weight
    assert abs(w.std().item() * np.sqrt(w.shape[1]) - 1.0) < 0.1
    assert torch.all(ours.dit.decoder_norm.weight == 1)


def test_entry_point_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DenoisingDiT(heads=2, **TINY)
