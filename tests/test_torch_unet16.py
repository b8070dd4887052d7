"""The 16x16 slice on the CPU against the JAX package: the VDM-UNet on 16x16
images (forward and train-loss gradients), the ELBO and its eval step on
JAX's own draws, the sampling function, and train steps whose dropout is a
function of the state."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from bsi_tpu.core import BSI as JaxBSI
from bsi_tpu.core import Discretization as JaxDiscretization
from bsi_tpu.core.common import sample_lds_t as jax_sample_lds_t
from bsi_tpu.models import DenoisingVDMUNet as JaxUNet
from bsi_tpu.nn import FourierFeatures as JaxFF
from bsi_tpu.nn import NyquistPositionalEmbedding as JaxNyquist
from bsi_tpu.train import TrainState as JaxTrainState
from bsi_tpu.train import make_eval_step as jax_make_eval_step
from bsi_tpu.train import make_optimizer as jax_make_optimizer

from bsi_torch.convert import params_from_jax, params_to_jax, train_state_from_jax
from bsi_torch.core import BSI, Discretization
from bsi_torch.models import DenoisingVDMUNet
from bsi_torch.nn import FourierFeatures, NyquistPositionalEmbedding
from bsi_torch.train import (
    AdamState,
    EMAConfig,
    TrainState,
    make_eval_step,
    make_optimizer,
    make_sample_fn,
    make_train_step,
    module_apply,
    warmup_cosine_schedule,
)
from bsi_torch.train.step import step_seed

from test_torch_train import SMALL, batch_of, closed_form_params, jax_closed_form, port_closed_form, to_port

IMG = (16, 16, 3)
TINY16 = dict(data_shape=IMG, dim=32, levels=2)
KW = dict(lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, preconditioning="edm")


def tiny16_pair(seed: int = 0):
    """A flax-initialised tiny JAX UNet on 16x16 images, its params, and the
    port's UNet at f64 carrying the same weights."""
    ref = JaxUNet(pos_emb=JaxNyquist(8, 100), fourier_features=JaxFF(6, 8), n_attention_heads=1, **TINY16)
    params = ref.init(jax.random.key(seed), jnp.zeros((2,) + IMG), jnp.zeros((2,)))
    ours = DenoisingVDMUNet(pos_emb=NyquistPositionalEmbedding(8, 100), fourier_features=FourierFeatures(6, 8),
                            n_attention_heads=1, device="cpu", **TINY16)
    ours.load_state_dict(params_from_jax(params))
    return ref, params, ours.double().eval()


def as_torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def jax_elbo_draws(key, x_shape, n_recon, n_measure, *, finite_k=None):
    """The draws of JAX's ``elbo`` (or with ``finite_k``, ``finite_elbo``'s),
    split as ``bsi_tpu/core/bsi.py`` splits its key: reconstruction eps, then
    the measurement's t (or step indices) and eps."""
    rng_recon, rng_measure = jax.random.split(key)
    b, data = x_shape[0], tuple(x_shape[1:])
    recon_eps = jax.random.normal(rng_recon, (n_recon, b) + data, jnp.float64)
    rng_a, rng_mu = jax.random.split(rng_measure)
    if finite_k is None:
        first = jax_sample_lds_t(rng_a, n_measure, b, dtype=jnp.float64)
    else:
        first = jax.random.randint(rng_a, (n_measure, b), 0, finite_k)
    eps = jax.random.normal(rng_mu, (n_measure, b) + data, jnp.float64)
    return as_torch(recon_eps, first, eps)


# ------------------------------------------------------------- the model


def test_forward_16x16_matches_jax_f64():
    ref, params, ours = tiny16_pair(0)
    rng = np.random.default_rng(1)
    mu, t = rng.normal(size=(3,) + IMG), rng.uniform(size=(3,))
    want = np.asarray(ref.apply(params, jnp.asarray(mu), jnp.asarray(t)))
    with torch.inference_mode():
        got = ours(torch.from_numpy(mu), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == (3,) + IMG
    # the gap is JAX's f32 attention logits over S = 256 (f64 everywhere else)
    npt.assert_allclose(got, want, atol=1e-6 * max(1.0, np.abs(want).max()), rtol=0)


def test_train_loss_gradients_16x16_match_jax():
    ref, ours = JaxBSI(data_shape=IMG, **KW), BSI(data_shape=IMG, **KW)
    model, params, port_model = tiny16_pair(2)
    x_np, x = batch_of(3, (2,) + IMG)
    key = jax.random.key(4)

    def loss_fn(p):
        return ref.train_loss(lambda mu, t: model.apply(p, mu, t), key, jnp.asarray(x_np)).mean()

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    rng_lambda, rng_mu = jax.random.split(key)
    t, eps = as_torch(jax_sample_lds_t(rng_lambda, 1, 2, dtype=jnp.float64)[0],
                      jax.random.normal(rng_mu, x.shape, jnp.float64))
    named = dict(port_model.named_parameters())
    loss = ours._train_loss_on(port_model, x, t, eps).mean()
    grads = params_to_jax(dict(zip(named, torch.autograd.grad(loss, list(named.values())))))
    npt.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want["params"]))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert set(flat_got) == set(flat_want)
    # each leaf within 1e-5 of its norm: JAX's f32 attention logits (~1e-7
    # of the forward) through the backward
    for path, w in flat_want.items():
        w = np.asarray(w)
        assert np.linalg.norm(flat_got[path] - w) <= 1e-5 * np.linalg.norm(w), path


# -------------------------------------------------------------- the ELBO


@pytest.mark.parametrize("discretized", [False, True])
def test_elbo_closed_form_on_jax_draws(discretized):
    disc = dict(discretization=JaxDiscretization.image_8bit()) if discretized else {}
    ref = JaxBSI(data_shape=SMALL, **KW, **disc)
    ours = BSI(data_shape=SMALL, **KW, **({"discretization": Discretization.image_8bit()} if discretized else {}))
    p = closed_form_params(5)
    x_np, x = batch_of(6, (5,) + SMALL)
    fn_jax = lambda mu, t: jax_closed_form(p, mu, t)
    fn_port = lambda mu, t: port_closed_form(to_port(p), mu, t)
    key = jax.random.key(7)
    want_elbo, want_bpd, want_extra = ref.elbo(fn_jax, key, jnp.asarray(x_np), 2, 3, estimate_var=True)
    recon_eps, t, eps = jax_elbo_draws(key, x.shape, 2, 3)
    elbo, bpd, extra = ours._elbo_on(fn_port, x, recon_eps, t, eps, estimate_var=True)
    assert bpd.shape == (5,) and extra["l_recon"].shape == (2, 5) and extra["l_measure"].shape == (3, 5)
    npt.assert_allclose(bpd.numpy(), np.asarray(want_bpd), rtol=0, atol=1e-9)
    npt.assert_allclose(elbo.numpy(), np.asarray(want_elbo), rtol=1e-12)
    for name in ("l_recon", "l_measure", "bpd_var"):
        npt.assert_allclose(extra[name].numpy(), np.asarray(want_extra[name]), rtol=1e-10, err_msg=name)
    # finite_elbo: one step of the default k=50 schedule per sample
    want_fin = ref.finite_elbo(fn_jax, key, jnp.asarray(x_np), 2, 3)[1]
    recon_eps, i, eps = jax_elbo_draws(key, x.shape, 2, 3, finite_k=ours.k)
    l_recon = ours._reconstruction_loss_on(fn_port, x, recon_eps)
    l_measure = ours._finite_measurement_loss_on(fn_port, x, i, eps)
    npt.assert_allclose(ours._assemble_elbo(l_recon, l_measure, 2, 3, False)[1].numpy(), np.asarray(want_fin),
                        rtol=0, atol=1e-9)


def test_elbo_entry_points_draw_from_the_generator():
    ours = BSI(data_shape=SMALL, **KW)
    p = to_port(closed_form_params(8))
    fn = lambda mu, t: port_closed_form(p, mu, t)
    _, x = batch_of(9, (4,) + SMALL)
    gen = lambda: torch.Generator().manual_seed(10)
    elbo, bpd, extra = ours.elbo(fn, gen(), x, 2, 2, estimate_var=True)
    assert torch.equal(bpd, ours._elbo_on(fn, x, *ours.elbo_noise(gen(), x, 2, 2))[1])
    assert bpd.shape == (4,) and torch.isfinite(bpd).all() and (extra["bpd_var"] >= 0).all()
    fin = ours.finite_elbo(fn, gen(), x, 1, 2, t=torch.linspace(0, 1, 5, dtype=torch.float64))[1]
    assert fin.shape == (4,) and torch.isfinite(fin).all()
    assert ours.reconstruction_loss(fn, gen(), x, 3).shape == (3, 4)
    assert ours.inf_measurement_loss(fn, gen(), x, 2).shape == (2, 4)
    with pytest.raises(ValueError, match="two samples"):
        ours.elbo(fn, gen(), x, 1, 2, estimate_var=True)


def test_elbo_unet_16x16_on_jax_draws():
    ref, ours = JaxBSI(data_shape=IMG, **KW), BSI(data_shape=IMG, **KW)
    model, params, port_model = tiny16_pair(11)
    x_np, x = batch_of(12, (3,) + IMG)
    key = jax.random.key(13)
    _, want_bpd, _ = jax.jit(lambda k, xx: ref.elbo(lambda mu, t: model.apply(params, mu, t), k, xx))(
        key, jnp.asarray(x_np))
    with torch.inference_mode():
        bpd = ours._elbo_on(port_model, x, *jax_elbo_draws(key, x.shape, 1, 1))[1]
    # JAX's f32 attention logits again, through two forwards
    npt.assert_allclose(bpd.numpy(), np.asarray(want_bpd), rtol=1e-6, atol=0)


def test_eval_step_masked_sums_match_jax_on_a_ragged_mask():
    ref, ours = JaxBSI(data_shape=SMALL, **KW), BSI(data_shape=SMALL, **KW)
    p = closed_form_params(14)
    x_np, x = batch_of(15, (5,) + SMALL)
    mask = np.array([1.0, 1.0, 0.0, 1.0, 0.0])
    key = jax.random.key(16)
    jp = jax.tree.map(jnp.asarray, p)
    jax_state = JaxTrainState.create(params=jp, opt_state=jax_make_optimizer(1e-3).init(jp), rng=key)
    want = jax_make_eval_step(ref, jax_closed_form)(jax_state, jnp.asarray(x_np), jnp.asarray(mask), key)
    params = to_port(p)
    state = TrainState.create(params=params, opt_state=make_optimizer(1e-3).init(params),
                              generator=torch.Generator())
    draws = jax_elbo_draws(key, x.shape, 1, 1)
    step = make_eval_step(ours, port_closed_form, noise=lambda batch: draws)
    got = step(state, x, torch.from_numpy(mask))
    assert set(got) == set(want)
    for name, w in want.items():
        npt.assert_allclose(got[name].item(), float(w), rtol=1e-10, err_msg=name)
    assert got["count"].item() == 3.0
    # the masked sums are the sums of the kept examples' bpd
    bpd = ours._elbo_on(lambda mu, t: port_closed_form(params, mu, t), x, *draws)[1]
    npt.assert_allclose(got["bpd_sum"].item(), bpd[mask > 0].sum().item(), rtol=1e-12)
    # without a noise hook the draws come from the generator passed in
    own = make_eval_step(ours, port_closed_form)
    a = own(state, x, torch.from_numpy(mask), torch.Generator().manual_seed(3))
    b = own(state, x, torch.from_numpy(mask), torch.Generator().manual_seed(3))
    assert all(torch.equal(a[name], b[name]) for name in a)


def test_eval_step_reads_the_ema_params():
    ours = BSI(data_shape=SMALL, **KW)
    params = to_port(closed_form_params(17))
    ema = {k: v * 0.5 for k, v in params.items()}
    state = TrainState.create(params=params, opt_state=AdamState(0, {}, {}), generator=torch.Generator(),
                              ema_params=ema)
    _, x = batch_of(18, (2,) + SMALL)
    draws = ours.elbo_noise(torch.Generator().manual_seed(0), x)
    mask = torch.ones(2, dtype=torch.float64)
    by_ema = make_eval_step(ours, port_closed_form, noise=lambda b: draws)(state, x, mask)["bpd_sum"]
    by_params = make_eval_step(ours, port_closed_form, noise=lambda b: draws, use_ema=False)(state, x, mask)["bpd_sum"]
    want = ours._elbo_on(lambda mu, t: port_closed_form(ema, mu, t), x, *draws)[1].sum()
    npt.assert_allclose(by_ema.item(), want.item(), rtol=1e-12)
    assert by_ema.item() != by_params.item()


def test_sample_fn_runs_the_sampler_on_the_ema_params():
    algo = BSI(data_shape=IMG, k=3, **KW)
    _, _, model = tiny16_pair(19)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    ema = {k: v * 0.9 for k, v in params.items()}
    state = TrainState.create(params=params, opt_state=AdamState(0, {}, {}), generator=torch.Generator(),
                              ema_params=ema)
    sample = make_sample_fn(algo, module_apply(model, train=False))
    got = sample(state, torch.Generator().manual_seed(20), 2, dtype=torch.float64)
    want = algo.sample(lambda mu, t: torch.func.functional_call(model, ema, (mu, t)),
                       torch.Generator().manual_seed(20), 2, device="cpu", dtype=torch.float64)
    assert got.shape == (2,) + IMG and torch.equal(got, want)


# ------------------------------------------- dropout as a function of state


def _dropout_setup(seed=21):
    torch.manual_seed(seed)
    model = DenoisingVDMUNet(pos_emb=NyquistPositionalEmbedding(8, 100), fourier_features=FourierFeatures(6, 8),
                             dropout=0.5, device="cpu", **TINY16)
    tx = make_optimizer(warmup_cosine_schedule(1e-3, 2, 10))
    step = make_train_step(BSI(data_shape=IMG, **KW, k=50), module_apply(model), tx, EMAConfig(update_after_step=1))
    weights = {k: v.detach().clone() for k, v in model.named_parameters()}
    return step, tx, weights


def _state(tx, weights, *, dropout_seed=5, noise_seed=6):
    params = {k: v.clone().requires_grad_() for k, v in weights.items()}
    return TrainState.create(params=params, opt_state=tx.init(params), generator=torch.Generator().manual_seed(noise_seed),
                             dropout_seed=dropout_seed)


def _copy(state):
    gen = torch.Generator()
    gen.set_state(state.generator.get_state())
    clone = lambda d: {k: v.detach().clone() for k, v in d.items()}
    params = {k: v.requires_grad_() for k, v in clone(state.params).items()}
    opt = AdamState(state.opt_state.count, clone(state.opt_state.mu), clone(state.opt_state.nu))
    return TrainState(step=state.step, params=params, ema_params=clone(state.ema_params), opt_state=opt,
                      generator=gen, dropout_seed=state.dropout_seed)


def _same(a, b):
    return all(torch.equal(a.params[k], b.params[k]) for k in a.params)


def test_train_step_dropout_is_a_function_of_the_state():
    step, tx, weights = _dropout_setup()
    _, x = batch_of(22, (2,) + IMG)
    x = x.float()
    a, b = _state(tx, weights), _state(tx, weights)
    a, _ = step(a, x)
    torch.rand(1000)  # unrelated draws from the default generator in between
    torch.nn.functional.dropout(torch.ones(100), 0.5)
    b, _ = step(b, x)
    assert _same(a, b)
    # a state copied at step n takes the same step n + 1
    c = _copy(a)
    torch.manual_seed(123)
    a, metrics_a = step(a, x)
    c, metrics_c = step(c, x)
    assert _same(a, c) and torch.equal(metrics_a["train/loss"], metrics_c["train/loss"])
    # the masks differ from step to step and from seed to seed, so the checks
    # above are not vacuous: another dropout seed, the same noise, moves apart
    d = _state(tx, weights, dropout_seed=7)
    d, _ = step(d, x)
    e = _state(tx, weights)
    e, _ = step(e, x)
    assert not _same(d, e)
    assert step_seed(5, 0) != step_seed(5, 1) and step_seed(5, 0) != step_seed(7, 0)


def test_train_step_leaves_the_default_stream_alone():
    step, tx, weights = _dropout_setup(23)
    _, x = batch_of(24, (2,) + IMG)
    torch.manual_seed(9)
    want = torch.rand(8)
    torch.manual_seed(9)
    step(_state(tx, weights), x.float())
    assert torch.equal(torch.rand(8), want)


def test_converted_state_carries_the_dropout_seed():
    p = closed_form_params(25)
    jp = jax.tree.map(jnp.asarray, p)
    tx = jax_make_optimizer(1e-3)
    key = jax.random.key(26)
    state = train_state_from_jax(JaxTrainState.create(params=jp, opt_state=tx.init(jp), rng=key),
                                 generator=torch.Generator(), device="cpu", convert=to_port)
    words = np.asarray(jax.random.key_data(key)).astype(np.uint64)
    assert state.dropout_seed == (int(words[0]) << 32) | int(words[1])
    other = train_state_from_jax(JaxTrainState.create(params=jp, opt_state=tx.init(jp), rng=jax.random.key(27)),
                                 generator=torch.Generator(), device="cpu", convert=to_port)
    assert other.dropout_seed != state.dropout_seed
