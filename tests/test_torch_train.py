"""The port's training slice against the JAX package on the CPU: the BSI train
loss on JAX's draws, its gradients, the optimizer, the EMA, and whole
train-step trajectories from one state."""

import numpy as np
import numpy.testing as npt
import optax
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from bsi_tpu.core import BSI as JaxBSI
from bsi_tpu.core.common import mc_var as jax_mc_var
from bsi_tpu.core.common import sample_lds_t as jax_sample_lds_t
from bsi_tpu.train import EMAConfig as JaxEMAConfig
from bsi_tpu.train import TrainState as JaxTrainState
from bsi_tpu.train import ema_decay as jax_ema_decay
from bsi_tpu.train import make_optimizer as jax_make_optimizer
from bsi_tpu.train import make_train_step as jax_make_train_step
from bsi_tpu.train import warmup_cosine_schedule as jax_warmup_cosine
from bsi_tpu.train import warmup_schedule as jax_warmup

from bsi_torch.convert import _find_adam_state, params_to_jax, train_state_from_jax
from bsi_torch.core import BSI, lds_grid, mc_var, sample_lds_t
from bsi_torch.nn import ResidualBlock
from bsi_torch.train import (
    EMAConfig,
    TrainState,
    ema_decay,
    make_optimizer,
    make_train_step,
    module_apply,
    warmup_cosine_schedule,
    warmup_schedule,
)

from test_torch_unet import tiny_pair

KW = dict(lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, preconditioning="edm")
# Every EMA branch within 5 steps: copies at steps 0 and 2, off-cycle steps
# 1 and 3, a real decay at step 4, and switch-EMA at steps 0 and 4.
EMA = dict(update_after_step=2, update_every=2, update_model_with_ema_every=4)
SMALL = (4, 4, 3)


def jax_step_draws(key, step, batch_shape, algo_shape):
    """The t and eps the JAX train step draws at ``step``: ``fold_in`` ->
    ``split`` (algorithm, dropout) -> ``train_loss``'s split (lambda, mu)."""
    rng_algo, _ = jax.random.split(jax.random.fold_in(key, step))
    rng_lambda, rng_mu = jax.random.split(rng_algo)
    t = jax_sample_lds_t(rng_lambda, 1, batch_shape[0], dtype=jnp.float64)[0]
    eps = jax.random.normal(rng_mu, (batch_shape[0],) + algo_shape, jnp.float64)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps))


def jax_noise(key, algo_shape):
    return lambda step, batch: jax_step_draws(key, step, tuple(batch.shape), algo_shape)


def closed_form_params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=SMALL), "a": rng.normal(size=(3,)) * 0.1, "s": np.array(0.5)}


def jax_closed_form(p, mu, t, rng=None):
    return jnp.tanh(p["w"] * mu + p["a"]) * (p["s"] * t)[:, None, None, None]


def port_closed_form(p, mu, t):
    return torch.tanh(p["w"] * mu + p["a"]) * (p["s"] * t)[:, None, None, None]


def to_port(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def batch_of(seed, shape):
    x = np.random.default_rng(seed).integers(0, 256, shape) / 255.0 * 2.0 - 1.0
    return x, torch.from_numpy(x)


# ------------------------------------------------------------- time draws


def test_lds_grid_matches_jax_on_its_draws():
    key = jax.random.key(11)
    n, b = 3, 5
    rng_offset, rng_perm = jax.random.split(key)
    offset = jax.random.uniform(rng_offset, (), dtype=jnp.float64)
    perm = jax.random.permutation(rng_perm, n * b)
    want = jax_sample_lds_t(key, n, b, dtype=jnp.float64)
    got = lds_grid(torch.from_numpy(np.array(perm)), torch.tensor(float(offset), dtype=torch.float64), n, b)
    npt.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_lds_t_is_stratified():
    n, b = 2, 50
    total = n * b
    t = sample_lds_t(torch.Generator().manual_seed(0), n, b, dtype=torch.float64)
    assert t.shape == (n, b) and t.dtype == torch.float64
    assert (t >= 0).all() and (t < 1).all()
    # the grid i / (1 + total) shifted by one offset: sorted gaps are one
    # slot each, except one gap of two slots where the empty slot wraps
    gaps = torch.diff(torch.sort(t.flatten()).values) * (1 + total)
    npt.assert_allclose(np.sort(gaps.numpy())[:-1], 1.0, atol=1e-9)
    assert 1.0 - 1e-9 <= gaps.max().item() <= 2.0 + 1e-9
    iid = sample_lds_t(torch.Generator().manual_seed(0), n, b, low_discrepancy=False)
    assert iid.shape == (n, b) and ((iid >= 0) & (iid < 1)).all()


def test_mc_var_matches_jax():
    values = np.random.default_rng(1).normal(size=(5, 3))
    npt.assert_allclose(mc_var(torch.from_numpy(values), 5).numpy(),
                        np.asarray(jax_mc_var(jnp.asarray(values), 5)), rtol=1e-14)


# -------------------------------------------------------------- the loss


def test_train_loss_closed_form_on_jax_draws():
    ref, ours = JaxBSI(data_shape=SMALL, **KW), BSI(data_shape=SMALL, **KW)
    p = closed_form_params(2)
    x_np, x = batch_of(3, (6,) + SMALL)
    key = jax.random.key(4)
    want = ref.train_loss(lambda mu, t: jax_closed_form(p, mu, t), key, jnp.asarray(x_np))
    # train_loss(model_fn, rng, x) splits its key as one train step does
    rng_lambda, rng_mu = jax.random.split(key)
    t = torch.from_numpy(np.array(jax_sample_lds_t(rng_lambda, 1, 6, dtype=jnp.float64)[0]))
    eps = torch.from_numpy(np.array(jax.random.normal(rng_mu, x.shape, jnp.float64)))
    got = ours._train_loss_on(lambda mu, tt: port_closed_form(to_port(p), mu, tt), x, t, eps)
    npt.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=0)
    # the draws' split into lambda and mu as _sample_lambda / _sample_q_mu_lambda
    gen = torch.Generator().manual_seed(5)
    lam = ours._sample_lambda(gen, 1, 6, torch.float64)
    assert lam.shape == (1, 6) and (lam >= KW["lambda_0"]).all()
    assert ours._sample_q_mu_lambda(gen, x, lam[0]).shape == x.shape


def test_train_loss_unet_on_jax_draws():
    ref, ours = JaxBSI(data_shape=(8, 8, 3), **KW), BSI(data_shape=(8, 8, 3), **KW)
    model, params, port_model = tiny_pair(1, seed=6)
    x_np, x = batch_of(7, (3, 8, 8, 3))
    key = jax.random.key(8)
    want = jax.jit(lambda p, k, xx: ref.train_loss(lambda mu, t: model.apply(p, mu, t), k, xx))(
        params, key, jnp.asarray(x_np))
    rng_lambda, rng_mu = jax.random.split(key)
    t = torch.from_numpy(np.array(jax_sample_lds_t(rng_lambda, 1, 3, dtype=jnp.float64)[0]))
    eps = torch.from_numpy(np.array(jax.random.normal(rng_mu, x.shape, jnp.float64)))
    with torch.no_grad():
        got = ours._train_loss_on(port_model, x, t, eps)
    # the gap is JAX's f32 attention logits, as in the forward test
    npt.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    # the port's own draws give a finite positive loss of the batch's shape
    with torch.no_grad():
        own = ours.train_loss(port_model, torch.Generator().manual_seed(0), x)
    assert own.shape == (3,) and torch.isfinite(own).all() and (own > 0).all()


def test_unet_loss_gradients_match_jax():
    ref, ours = JaxBSI(data_shape=(8, 8, 3), **KW), BSI(data_shape=(8, 8, 3), **KW)
    model, params, port_model = tiny_pair(1, seed=9)
    x_np, x = batch_of(10, (2, 8, 8, 3))
    key = jax.random.key(12)

    def loss_fn(p):  # bsi_tpu/train/step.py's loss_and_grads
        return ref.train_loss(lambda mu, t: model.apply(p, mu, t), key, jnp.asarray(x_np)).mean()

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    rng_lambda, rng_mu = jax.random.split(key)
    t = torch.from_numpy(np.array(jax_sample_lds_t(rng_lambda, 1, 2, dtype=jnp.float64)[0]))
    eps = torch.from_numpy(np.array(jax.random.normal(rng_mu, x.shape, jnp.float64)))
    named = dict(port_model.named_parameters())
    loss = ours._train_loss_on(port_model, x, t, eps).mean()
    grads = params_to_jax(dict(zip(named, torch.autograd.grad(loss, list(named.values())))))
    npt.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want["params"]))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert set(flat_got) == set(flat_want)
    # each leaf relative to its norm: the f32 attention logits again (~1e-7
    # in the forward), through the backward
    for path, w in flat_want.items():
        w = np.asarray(w)
        assert np.linalg.norm(flat_got[path] - w) <= 1e-5 * np.linalg.norm(w), path


# ------------------------------------------------------ optimizer and EMA


@pytest.mark.parametrize("kind", ["warmup", "cosine"])
def test_schedules_match_optax(kind):
    if kind == "warmup":
        ours, ref = warmup_schedule(2e-4, 10), jax_warmup(2e-4, 10)
    else:
        ours, ref = warmup_cosine_schedule(2e-4, 10, 50), jax_warmup_cosine(2e-4, 10, 50)
    for count in [0, 1, 5, 9, 10, 11, 30, 49, 50, 51, 200]:
        npt.assert_allclose(ours(count), float(ref(jnp.int32(count))), rtol=1e-12, atol=1e-20)


@pytest.mark.parametrize("norm", [0.999, 1.001])
def test_clip_and_adamw_update_match_optax(norm):
    rng = np.random.default_rng(13)
    params = {"a": rng.normal(size=(3, 4)), "b": rng.normal(size=(5,))}
    grads = {k: rng.normal(size=v.shape) for k, v in params.items()}
    scale = norm / np.sqrt(sum((g * g).sum() for g in grads.values()))
    grads = {k: g * scale for k, g in grads.items()}
    tx_ref = jax_make_optimizer(1e-2, weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, params)
    updates, _ = tx_ref.update(jax.tree.map(jnp.asarray, grads), tx_ref.init(jp), jp)
    want = optax.apply_updates(jp, updates)
    tx = make_optimizer(1e-2, weight_decay=0.1)
    ours = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tx.update([torch.from_numpy(g.copy()) for g in grads.values()], tx.init(ours), ours)
    for k in params:
        npt.assert_allclose(ours[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-15)
    # Adam's first step is ~lr * sign(g) whatever the scale, so the clip shows
    # in the decayed-weight-free Adam moments: mu = 0.1 * clipped g
    tx_nd = make_optimizer(1e-2, name="adam")
    st = tx_nd.init(ours)
    tx_nd.update([torch.from_numpy(g.copy()) for g in grads.values()], st, ours)
    factor = 1.0 if norm < 1.0 else 1.0 / norm
    for k, g in grads.items():
        npt.assert_allclose(st.mu[k].numpy(), 0.1 * g * factor, rtol=1e-14)


def test_ema_decay_matches_jax_bit_for_bit():
    for cfg in [dict(update_after_step=2), dict(update_after_step=0, power=0.75, inv_gamma=3.0),
                dict(update_after_step=1000, beta=0.999)]:
        ours, ref = EMAConfig(**cfg), JaxEMAConfig(**cfg)
        for step in [0, 1, 2, 3, 4, 7, 100, 1000, 1001, 1002, 5000, 10**6]:
            got = ema_decay(ours, step)
            assert got.dtype == np.float32
            assert got == np.asarray(jax_ema_decay(ref, jnp.int32(step))), (cfg, step)


def test_dropout_matches_flax_semantics():
    block = ResidualBlock(32, 32, 8, dropout=0.1, device="cpu").double()
    drop = block.dropout
    x = torch.ones(200_000, dtype=torch.float64)
    torch.manual_seed(0)
    out = drop.train()(x)
    kept = out != 0
    n = x.numel()
    sigma = np.sqrt(0.9 * 0.1 / n)
    assert abs(kept.double().mean().item() - 0.9) <= 4 * sigma
    ref = flax_nn.Dropout(0.1, deterministic=False).apply({}, jnp.ones(8), rngs={"dropout": jax.random.key(0)})
    flax_scale = np.unique(np.asarray(ref)[np.asarray(ref) != 0])
    npt.assert_allclose(out[kept].unique().numpy(), flax_scale, rtol=1e-15)
    npt.assert_allclose(flax_scale, 1 / 0.9, rtol=1e-15)
    assert torch.equal(drop.eval()(x), x)


def test_bf16_train_model_and_f32_eval_model_share_params():
    _, _, f64 = tiny_pair(1, seed=14)
    from bsi_torch.models import DenoisingVDMUNet
    from bsi_torch.nn import FourierFeatures, NyquistPositionalEmbedding

    kw = dict(data_shape=(8, 8, 3), dim=32, levels=2, pos_emb=NyquistPositionalEmbedding(8, 100),
              fourier_features=FourierFeatures(6, 8), device="cpu")
    train_model = DenoisingVDMUNet(dtype=torch.bfloat16, **kw)
    eval_model = DenoisingVDMUNet(**kw)
    params = {k: v.float() for k, v in f64.state_dict().items()}
    mu = torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    t = torch.rand(2, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ev = module_apply(eval_model, train=False)(params, mu, t)
        tr = module_apply(train_model, train=True)(params, mu, t)
        full = f64(mu.double(), t.double())
    assert ev.dtype == torch.float32 and tr.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in params.values())
    # f32 against f64: the Fourier features (frequencies up to 2 pi 2^8) lose
    # f32 digits; bf16 keeps about two decimal digits
    scale = full.abs().max().item()
    assert (ev.double() - full).abs().max().item() <= 1e-3 * scale
    assert (tr.double() - full).abs().max().item() <= 5e-2 * scale
    assert not eval_model.training and train_model.training


# ------------------------------------------------------------ trajectories


def run_jax(step_fn, state, x, n):
    out = []
    for _ in range(n):
        state, metrics = step_fn(state, x)
        out.append((state, metrics))
    return out


def assert_state_close(port, ref, metrics_port, metrics_ref, *, rtol, atol, to_jax):
    npt.assert_allclose(metrics_port["train/loss"].item(), float(metrics_ref["train/loss"]), rtol=rtol)
    npt.assert_allclose(metrics_port["train/grad_norm"].item(), float(metrics_ref["train/grad_norm"]), rtol=rtol)
    adam = _find_adam_state(ref.opt_state)
    assert port.step == int(ref.step) and port.opt_state.count == int(adam.count)
    for ours, want in [(port.params, ref.params), (port.ema_params, ref.ema_params),
                       (port.opt_state.mu, adam.mu), (port.opt_state.nu, adam.nu)]:
        got = dict(jax.tree_util.tree_leaves_with_path(to_jax(ours)))
        for path, w in jax.tree_util.tree_leaves_with_path(want):
            npt.assert_allclose(got[path], np.asarray(w), rtol=rtol, atol=atol, err_msg=str(path))


def closed_form_setup(seed):
    data_shape = SMALL
    ref, ours = JaxBSI(data_shape=data_shape, **KW), BSI(data_shape=data_shape, **KW)
    sched_args = dict(lr=5e-2, warmup_steps=2, max_steps=8)
    tx_ref = jax_make_optimizer(jax_warmup_cosine(**sched_args))
    tx = make_optimizer(warmup_cosine_schedule(**sched_args))
    p = closed_form_params(seed)
    jp = jax.tree.map(jnp.asarray, p)
    key = jax.random.key(seed)
    jax_state = JaxTrainState.create(params=jp, opt_state=tx_ref.init(jp), rng=key)
    jax_step = jax.jit(jax_make_train_step(ref, jax_closed_form, tx_ref, JaxEMAConfig(**EMA)))
    port_params = {k: v.requires_grad_() for k, v in to_port(p).items()}
    state = TrainState.create(params=port_params, opt_state=tx.init(port_params), generator=torch.Generator())
    port_step = make_train_step(ours, port_closed_form, tx, EMAConfig(**EMA), noise=jax_noise(key, data_shape))
    return jax_step, jax_state, port_step, state, key


def test_closed_form_trajectory_matches_jax():
    jax_step, jax_state, port_step, state, _ = closed_form_setup(15)
    x_np, x = batch_of(16, (6,) + SMALL)
    to_jax = lambda d: {k: v.detach().numpy() for k, v in d.items()}
    for ref, metrics in run_jax(jax_step, jax_state, jnp.asarray(x_np), 5):
        state, port_metrics = port_step(state, x)
        assert_state_close(state, ref, port_metrics, metrics, rtol=1e-12, atol=1e-12, to_jax=to_jax)
    # the clip was active (the loss is scaled by 1/p(lambda), up to ~1e7)
    assert float(metrics["train/grad_norm"]) > 1.0


def test_state_carried_across_takes_the_same_step():
    jax_step, jax_state, _, _, key = closed_form_setup(17)
    x_np, x = batch_of(18, (6,) + SMALL)
    (_, _), (ref2, _), (ref3, metrics3) = run_jax(jax_step, jax_state, jnp.asarray(x_np), 3)
    state = train_state_from_jax(ref2, generator=torch.Generator(), device="cpu", convert=to_port)
    tx = make_optimizer(warmup_cosine_schedule(5e-2, 2, 8))
    port_step = make_train_step(BSI(data_shape=SMALL, **KW), port_closed_form, tx, EMAConfig(**EMA),
                                noise=jax_noise(key, SMALL))
    state, metrics = port_step(state, x)
    to_jax = lambda d: {k: v.detach().numpy() for k, v in d.items()}
    assert_state_close(state, ref3, metrics, metrics3, rtol=1e-12, atol=1e-12, to_jax=to_jax)


def test_unet_trajectory_matches_jax():
    ref, ours = JaxBSI(data_shape=(8, 8, 3), **KW), BSI(data_shape=(8, 8, 3), **KW)
    model, params, port_model = tiny_pair(1, seed=19)
    params = jax.tree.map(lambda a: a.astype(jnp.float64), params)  # flax initialises in f32
    sched_args = dict(lr=1e-3, warmup_steps=2, max_steps=10)
    tx_ref = jax_make_optimizer(jax_warmup_cosine(**sched_args))
    key = jax.random.key(20)
    jax_state = JaxTrainState.create(params=params, opt_state=tx_ref.init(params), rng=key)
    jax_step = jax.jit(jax_make_train_step(ref, lambda p, mu, t, rng: model.apply(p, mu, t), tx_ref,
                                           JaxEMAConfig(**EMA)))
    tx = make_optimizer(warmup_cosine_schedule(**sched_args))
    named = dict(port_model.named_parameters())
    state = TrainState.create(params=named, opt_state=tx.init(named), generator=torch.Generator())
    port_step = make_train_step(ours, module_apply(port_model), tx, EMAConfig(**EMA),
                                noise=jax_noise(key, (8, 8, 3)))
    x_np, x = batch_of(21, (2, 8, 8, 3))
    lr_sum = 0.0
    for ref_state, metrics in run_jax(jax_step, jax_state, jnp.asarray(x_np), 3):
        lr_sum += tx.lr(state.step)
        state, port_metrics = port_step(state, x)
        npt.assert_allclose(port_metrics["train/loss"].item(), float(metrics["train/loss"]), rtol=1e-6)
        npt.assert_allclose(port_metrics["train/grad_norm"].item(), float(metrics["train/grad_norm"]),
                            rtol=1e-5)
        # Adam moves each element by about lr * g / |g|, at most ~lr a step.
        # Where a gradient is ~0, that ratio is rounding noise, and the
        # forward's ~1e-6 gap (JAX's f32 attention logits) makes another
        # noise on each side: such an element lands anywhere within the
        # learning rate. The key bias of the attention has no gradient at
        # all (softmax ignores a shift shared by every key), so it is held
        # only to Adam's bound. Every other leaf is held in root mean square
        # to 1e-3 of the largest move Adam could have made, the learning
        # rates summed (observed: one element in 6,048 of the encode kernel
        # off by 5e-3 of it after the first step).
        got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(state.params)))
        for path, w in jax.tree_util.tree_leaves_with_path(ref_state.params["params"]):
            diff = got[path] - np.asarray(w)
            if jax.tree_util.keystr(path).endswith("['to_qkv']['bias']"):
                # grouped layout (g, qkv, hpg, d) with one head: k is [32:64]
                assert np.abs(diff[32:64]).max() <= 2 * lr_sum
                diff = np.concatenate([diff[:32], diff[64:]])
            rms = np.sqrt(np.mean(diff**2))
            assert rms <= 1e-3 * lr_sum, (path, rms, lr_sum)
    assert state.step == 3
