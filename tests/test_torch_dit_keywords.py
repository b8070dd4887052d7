"""The DiT's keywords as the shared ``configs/`` and the JAX package pass them:
the config's keys build the port's model, ``remat`` changes no number of a
train step with dropout, ``scan_blocks`` is a layout flag, and a token
sharding other than ``bsi_torch.parallel.token_stream_sharding``'s is
refused (the parallel layouts' tests run the one it returns)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
import yaml

from bsi_tpu.models import DenoisingDiT as JaxDiT
from bsi_tpu.nn import FourierFeatures as JaxFF

from bsi_torch.convert import params_from_jax
from bsi_torch.core import BSI
from bsi_torch.models import DenoisingDiT
from bsi_torch.nn import FourierFeatures
from bsi_torch.train import EMAConfig, TrainState, make_optimizer, make_train_step, module_apply
from bsi_torch.train import warmup_cosine_schedule

from test_torch_train import batch_of

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "task" / "model" / "dit.yaml"
# The config's widths cut to a tiny model; every other key is the config's.
TINY = dict(data_shape=(8, 8, 3), patch_size=2, dim=32, depth=2, heads=2)
KW = dict(data_shape=(8, 8, 3), lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, preconditioning="edm")


def config_keys() -> dict:
    """dit.yaml's constructor keys: ``defaults`` (sub-configs) and the keys
    that ``bsi_tpu/config/instantiate.py`` treats as meta (``_target_``,
    ``name``) dropped."""
    cfg = yaml.safe_load(CONFIG.read_text())
    return {key: val for key, val in cfg.items() if key not in ("defaults", "_target_", "name")}


def test_config_keys_build_the_port_and_jax_alike():
    keys = {**config_keys(), **TINY}
    assert {"remat", "dropout"} <= set(keys)
    ref = JaxDiT(fourier_features=JaxFF(6, 8), **keys)
    params = ref.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,)))
    ours = DenoisingDiT(fourier_features=FourierFeatures(6, 8), device="cpu", **keys)
    ours.load_state_dict(params_from_jax(params))  # strict: the same parameters by name
    assert ours.dit.remat is False  # the config's "remat: no"


def test_scan_blocks_is_a_layout_flag():
    rng = np.random.default_rng(0)
    mu, t = torch.from_numpy(rng.normal(size=(2, 8, 8, 3))), torch.from_numpy(rng.uniform(size=(2,)))
    torch.manual_seed(0)
    loop = DenoisingDiT(device="cpu", **TINY).double().eval()
    scan = DenoisingDiT(scan_blocks=True, device="cpu", **TINY).double().eval()
    scan.load_state_dict(loop.state_dict())
    assert set(scan.state_dict()) == set(loop.state_dict())
    with torch.inference_mode():
        assert torch.equal(scan(mu, t), loop(mu, t))


@pytest.mark.parametrize("cls", ["DenoisingDiT", "DiT"])
def test_token_sharding_is_refused(cls):
    from bsi_torch.models import dit

    with pytest.raises(ValueError, match="token_sharding: want what bsi_torch.parallel.token_stream_sharding"):
        if cls == "DenoisingDiT":
            DenoisingDiT(token_sharding=object(), device="cpu", **TINY)
        else:
            dit.DiT((8, 8), 2, 3, 3, 32, 2, 2, device="cpu", token_sharding=object())


def _model(remat: bool) -> DenoisingDiT:
    torch.manual_seed(0)
    model = DenoisingDiT(dropout=0.05, remat=remat, device="cpu", **TINY)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".ada_out." in name:  # adaLN-Zero: at init every block is the identity
                p.normal_(0.0, 0.02)
    return model


def test_remat_gives_the_same_gradients_with_dropout():
    # One train-loss gradient in train() at dropout 0.05, the same weights
    # and draws, each side's dropout drawn from the same seed. The
    # checkpoint's recompute restores the RNG state, so it redraws the same
    # masks: the gradients are equal bit for bit.
    algo = BSI(**KW, k=50)
    _, x = batch_of(3, (4, 8, 8, 3))
    t, eps = algo.train_noise(torch.Generator().manual_seed(4), x)
    grads = []
    for remat in (False, True):
        model = _model(remat).train()
        named = dict(model.named_parameters())
        torch.manual_seed(7)
        loss = algo._train_loss_on(model, x.float(), t.float(), eps.float()).mean()
        grads.append((loss, dict(zip(named, torch.autograd.grad(loss, list(named.values()))))))
    (loss0, g0), (loss1, g1) = grads
    assert torch.equal(loss0, loss1)
    assert set(g0) == set(g1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    # dropout was on: another seed gives another loss
    torch.manual_seed(8)
    other = algo._train_loss_on(_model(False).train(), x.float(), t.float(), eps.float()).mean()
    assert not torch.equal(other, loss0)


def test_remat_gives_the_same_train_steps():
    # Two train steps (the step reseeds the default generator from the
    # state's dropout seed and the step): the same losses, gradient norms
    # and parameters bit for bit.
    _, x = batch_of(50, (4, 8, 8, 3))
    runs = []
    for remat in (False, True):
        model = _model(remat)
        params = dict(model.named_parameters())
        tx = make_optimizer(warmup_cosine_schedule(5e-4, 100, 10**6))
        state = TrainState.create(params=params, opt_state=tx.init(params),
                                  generator=torch.Generator().manual_seed(1))
        step = make_train_step(BSI(**KW, k=50), module_apply(model), tx, EMAConfig(update_after_step=1000))
        metrics = []
        for _ in range(2):
            state, m = step(state, x.float())
            metrics.append((m["train/loss"].item(), m["train/grad_norm"].item()))
        runs.append((metrics, {k: v.detach().clone() for k, v in state.params.items()}))
    (m0, p0), (m1, p1) = runs
    assert m0 == m1
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name
    npt.assert_array_less(0.0, np.array(m0)[:, 0])
