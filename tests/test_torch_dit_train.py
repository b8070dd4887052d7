"""The port's DiT training against the JAX package on the CPU: the optimizer's
bf16 moment storage (``scale_by_adam_cast``), the train state carried across
with it, and a tiny DiT's train-loss gradients and train-step trajectory on
JAX's own draws."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import optax
import pytest
import torch

from bsi_tpu.core import BSI as JaxBSI
from bsi_tpu.core.common import sample_lds_t as jax_sample_lds_t
from bsi_tpu.train import EMAConfig as JaxEMAConfig
from bsi_tpu.train import TrainState as JaxTrainState
from bsi_tpu.train import make_optimizer as jax_make_optimizer
from bsi_tpu.train import make_train_step as jax_make_train_step
from bsi_tpu.train import warmup_cosine_schedule as jax_warmup_cosine

from bsi_torch.convert import _find_adam_state, params_to_jax, train_state_from_jax
from bsi_torch.core import BSI
from bsi_torch.models import DenoisingDiT
from bsi_torch.train import EMAConfig, TrainState, make_optimizer, make_train_step, module_apply
from bsi_torch.train import warmup_cosine_schedule

from test_torch_dit import TINY, tiny_dit_pair
from test_torch_train import EMA, batch_of, jax_noise, run_jax

KW = dict(data_shape=(8, 8, 3), lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, preconditioning="edm")
CAST = dict(mu_dtype="bfloat16", nu_dtype="bfloat16")


def _f64(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float64), tree)


# ------------------------------------------------- bf16 moment storage


def test_bf16_moments_match_scale_by_adam_cast():
    # Three AdamW updates of f32 params with bf16 moments: the update uses the
    # unrounded new moments, only the stored ones are rounded. f32 arithmetic
    # on both sides: params within 1e-6 relative; the bf16 moments equal, or
    # one bf16 ulp apart where the f32 values before rounding differ in the
    # last bit and straddle a rounding boundary.
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(6, 5)).astype(np.float32), "b": rng.normal(size=(7,)).astype(np.float32)}
    tx_ref = jax_make_optimizer(1e-2, weight_decay=0.1, **CAST)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx_ref.init(jp)
    tx = make_optimizer(1e-2, weight_decay=0.1, **CAST)
    ours = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx.init(ours)
    assert all(m.dtype == torch.bfloat16 for m in (*state.mu.values(), *state.nu.values()))
    for step in range(3):
        grads = {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in params.items()}
        updates, jstate = tx_ref.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tx.update([torch.from_numpy(g.copy()) for g in grads.values()], state, ours)
        adam = _find_adam_state(jstate)
        for k in params:
            npt.assert_allclose(ours[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7, err_msg=(step, k))
            for got, want in ((state.mu[k], adam.mu[k]), (state.nu[k], adam.nu[k])):
                assert np.asarray(want).dtype == jnp.bfloat16
                npt.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32), rtol=2**-8, atol=0)
    assert state.count == 3


def test_bf16_update_differs_from_rounding_first():
    # The update must read the unrounded moments: rounding them to bf16 before
    # the update (what an in-place bf16 update does) moves the params.
    p = {"w": torch.tensor([1.0, -2.0, 3.0])}
    g = [torch.tensor([0.123456, -0.0314159, 0.271828])]
    tx = make_optimizer(1e-1, **CAST)
    state = tx.init(p)
    tx.update([x.clone() for x in g], state, p)
    ref = {"w": torch.tensor([1.0, -2.0, 3.0])}
    tx32 = make_optimizer(1e-1)
    tx32.update([x.clone() for x in g], tx32.init(ref), ref)
    # the first Adam step is mu_hat / sqrt(nu_hat) = sign(g) exactly only
    # through unrounded moments
    assert torch.equal(p["w"], ref["w"])
    w0, g0 = torch.tensor([1.0, -2.0, 3.0]), g[0]
    mu_b = (0.1 * g0).bfloat16().float() / 0.1
    nu_b = (0.001 * g0 * g0).bfloat16().float() / 0.001
    rounded_first = w0 - 0.1 * (mu_b / (nu_b.sqrt() + 1e-8) + 0.01 * w0)
    assert not torch.equal(rounded_first, p["w"])


def test_train_state_from_jax_keeps_moment_dtypes():
    params = {"w": jnp.asarray(np.random.default_rng(1).normal(size=(3, 4)), jnp.float32)}
    tx = jax_make_optimizer(1e-2, **CAST)
    jstate = JaxTrainState.create(params=params, opt_state=tx.init(params), rng=jax.random.key(0))
    updates, opt = tx.update({"w": jnp.ones((3, 4), jnp.float32)}, jstate.opt_state, params)
    jstate = jstate.replace(opt_state=opt)
    convert = lambda tree: {k: torch.from_numpy(np.asarray(v).astype(np.float32)).to(
        torch.bfloat16 if np.asarray(v).dtype == jnp.bfloat16 else torch.float32) for k, v in tree.items()}
    state = train_state_from_jax(jstate, generator=torch.Generator(), device="cpu", convert=convert)
    assert state.opt_state.mu["w"].dtype == torch.bfloat16 and state.params["w"].dtype == torch.float32
    npt.assert_array_equal(state.opt_state.nu["w"].float().numpy(),
                           np.asarray(_find_adam_state(opt).nu["w"]).astype(np.float32))


def test_params_converters_carry_bf16_leaves():
    from bsi_torch.convert import params_from_jax

    tree = {"params": {"Dense_0": {"kernel": jnp.asarray([[1.5, -2.25]], jnp.bfloat16),
                                   "bias": jnp.asarray([0.5, 3.0], jnp.bfloat16)}}}
    state = params_from_jax(tree)
    assert state["Dense_0.weight"].dtype == torch.bfloat16
    assert state["Dense_0.weight"].tolist() == [[1.5], [-2.25]]
    back = params_to_jax(state)
    npt.assert_array_equal(back["Dense_0"]["kernel"], [[1.5, -2.25]])


# ----------------------------------------------------------- tiny DiT


def _jax_draws(key, batch):
    rng_lambda, rng_mu = jax.random.split(key)
    t = jax_sample_lds_t(rng_lambda, 1, batch.shape[0], dtype=jnp.float64)[0]
    eps = jax.random.normal(rng_mu, batch.shape, jnp.float64)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps))


@pytest.mark.parametrize("heads", [2, 1])
def test_dit_loss_gradients_match_jax(heads):
    # ada_out filled (adaLN-Zero would make every block the identity and give
    # the attention a zero upstream gradient), dropout off, f64
    ref, ours = JaxBSI(**KW), BSI(**KW)
    model, params, port_model = tiny_dit_pair(heads, seed=30 + heads)
    params = _f64(params)
    x_np, x = batch_of(31, (2, 8, 8, 3))
    key = jax.random.key(32)

    def loss_fn(p):
        return ref.train_loss(lambda mu, t: model.apply(p, mu, t), key, jnp.asarray(x_np)).mean()

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    t, eps = _jax_draws(key, x)
    named = dict(port_model.named_parameters())
    loss = ours._train_loss_on(port_model, x, t, eps).mean()
    grads = params_to_jax(dict(zip(named, torch.autograd.grad(loss, list(named.values())))))
    npt.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want["params"]))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert set(flat_got) == set(flat_want)
    # each leaf against its norm: JAX's f32 attention logits (~1e-8 in the
    # forward), through the backward. The key bias has no gradient at all
    # (softmax ignores a shift shared by every key): rounding noise on both
    # sides, held in absolute terms.
    scale = max(np.linalg.norm(np.asarray(w)) for w in flat_want.values())
    for path, w in flat_want.items():
        w = np.asarray(w)
        assert np.linalg.norm(flat_got[path] - w) <= 1e-5 * np.linalg.norm(w) + 1e-9 * scale, path
    # the attention's gradient is not hidden by adaLN-Zero
    qkv = [w for p, w in flat_want.items() if "to_qkv" in jax.tree_util.keystr(p) and "kernel" in jax.tree_util.keystr(p)]
    assert all(np.abs(np.asarray(w)).max() > 1e-6 for w in qkv)


def test_dit_trajectory_matches_jax():
    ref, ours = JaxBSI(**KW), BSI(**KW)
    model, params, port_model = tiny_dit_pair(2, seed=40)
    params = _f64(params)
    sched_args = dict(lr=1e-3, warmup_steps=2, max_steps=10)
    tx_ref = jax_make_optimizer(jax_warmup_cosine(**sched_args))
    key = jax.random.key(41)
    jax_state = JaxTrainState.create(params=params, opt_state=tx_ref.init(params), rng=key)
    jax_step = jax.jit(jax_make_train_step(ref, lambda p, mu, t, rng: model.apply(p, mu, t), tx_ref,
                                           JaxEMAConfig(**EMA)))
    tx = make_optimizer(warmup_cosine_schedule(**sched_args))
    named = dict(port_model.named_parameters())
    state = TrainState.create(params=named, opt_state=tx.init(named), generator=torch.Generator())
    port_step = make_train_step(ours, module_apply(port_model), tx, EMAConfig(**EMA),
                                noise=jax_noise(key, (8, 8, 3)))
    x_np, x = batch_of(42, (2, 8, 8, 3))
    lr_sum = 0.0
    for ref_state, metrics in run_jax(jax_step, jax_state, jnp.asarray(x_np), 3):
        lr_sum += tx.lr(state.step)
        state, port_metrics = port_step(state, x)
        npt.assert_allclose(port_metrics["train/loss"].item(), float(metrics["train/loss"]), rtol=1e-6)
        npt.assert_allclose(port_metrics["train/grad_norm"].item(), float(metrics["train/grad_norm"]),
                            rtol=1e-5)
        # Adam moves each element by about lr * g / |g|; where a gradient is
        # ~0 that ratio is rounding noise, so each leaf is held in root mean
        # square to 1e-3 of the largest move Adam could have made, and the key
        # bias (no gradient at all) only to Adam's bound, as for the UNet.
        got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(state.params)))
        for path, w in jax.tree_util.tree_leaves_with_path(ref_state.params["params"]):
            diff = got[path] - np.asarray(w)
            if jax.tree_util.keystr(path).endswith("['to_qkv']['bias']"):
                # grouped layout (g, qkv, hpg, d), one group of two heads of 64: k is [128:256]
                assert np.abs(diff[128:256]).max() <= 2 * lr_sum
                diff = np.concatenate([diff[:128], diff[256:]])
            assert np.sqrt(np.mean(diff**2)) <= 1e-3 * lr_sum, path
        ema = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(state.ema_params)))
        for path, w in jax.tree_util.tree_leaves_with_path(ref_state.ema_params["params"]):
            if not jax.tree_util.keystr(path).endswith("['to_qkv']['bias']"):
                assert np.sqrt(np.mean((ema[path] - np.asarray(w)) ** 2)) <= 1e-3 * lr_sum, path
    assert state.step == 3


def test_dit_with_dropout_trains_on_the_cpu():
    # dropout 0.05 in train() takes the plain path on the CPU (torch.rand
    # masks, as JAX's fallback); the step gives finite metrics and moves the
    # attention weights
    torch.manual_seed(0)
    model = DenoisingDiT(heads=2, dropout=0.05, device="cpu", **TINY)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".ada_out." in name:
                p.normal_(0.0, 0.02)
    params = dict(model.named_parameters())
    tx = make_optimizer(warmup_cosine_schedule(5e-4, 100, 10**6), **CAST)
    state = TrainState.create(params=params, opt_state=tx.init(params), generator=torch.Generator().manual_seed(1))
    before = params["dit.block_0.attn.to_qkv.weight"].detach().clone()
    step = make_train_step(BSI(**KW, k=50), module_apply(model), tx, EMAConfig(update_after_step=1000))
    _, x = batch_of(50, (4, 8, 8, 3))
    for _ in range(2):
        state, metrics = step(state, x.float())
    assert np.isfinite(metrics["train/loss"].item()) and np.isfinite(metrics["train/grad_norm"].item())
    assert not torch.equal(before, params["dit.block_0.attn.to_qkv.weight"])
    assert state.opt_state.mu["dit.block_0.attn.to_qkv.weight"].dtype == torch.bfloat16
