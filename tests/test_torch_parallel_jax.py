"""The port's tensor + sequence parallel train step against the JAX
package's on the CPU: JAX's step jitted on the conftest's 8 CPU devices
under ``make_mesh(8, model_parallelism=2)`` with the DiT's token stream
sharded over the model axis, against ``make_train_step`` on 2 gloo ranks
with TP 2 and SP, on the same converted weights, batch and draws (JAX's,
fed through ``noise=``), f64."""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import torch

from bsi_tpu.core import BSI as JaxBSI
from bsi_tpu.models import DenoisingDiT as JaxDiT
from bsi_tpu.nn import FourierFeatures as JaxFF
from bsi_tpu.parallel import make_mesh as jax_make_mesh
from bsi_tpu.parallel.sequence import token_stream_sharding as jax_token_stream_sharding
from bsi_tpu.parallel.tensor import tp_state_sharding
from bsi_tpu.train import EMAConfig as JaxEMAConfig
from bsi_tpu.train import TrainState as JaxTrainState
from bsi_tpu.train import make_optimizer as jax_make_optimizer
from bsi_tpu.train import make_train_step as jax_make_train_step
from bsi_tpu.train import warmup_cosine_schedule as jax_warmup_cosine
from jax.sharding import NamedSharding, PartitionSpec as P

from bsi_torch.convert import params_from_jax, params_to_jax
from test_torch_dit import fill_ada_out
from test_torch_train import EMA, batch_of, jax_step_draws
from torch_parallel_worker import launch

MODEL = dict(data_shape=(8, 8, 3), patch_size=2, dim=32, depth=2, heads=2)
ALGO = dict(data_shape=(8, 8, 3), lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, preconditioning="edm")
SCHED = dict(lr=1e-3, warmup_steps=2, max_steps=10)
STEPS = 3


def test_tp_sp_train_step_matches_jax(tmp_path):
    mesh = jax_make_mesh(8, model_parallelism=2)
    model = JaxDiT(fourier_features=JaxFF(6, 7), token_sharding=jax_token_stream_sharding(mesh), **MODEL)
    # the token sharding changes no parameter: init without it, at batch 2
    params = model.clone(token_sharding=None).init(jax.random.key(60), jnp.zeros((2, 8, 8, 3)), jnp.zeros((2,)))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), fill_ada_out(params, 160))
    tx = jax_make_optimizer(jax_warmup_cosine(**SCHED))
    key = jax.random.key(61)
    state = JaxTrainState.create(params=params, opt_state=tx.init(params), rng=key)
    shardings = tp_state_sharding(state, mesh)
    state = jax.device_put(state, shardings)
    # the TP rules put to_qkv, to_out, the MLP pair and the adaLN pair on the model axis
    specs = dict(jax.tree_util.tree_leaves_with_path(shardings.params))
    assert sum("model" in s.spec for s in specs.values()) == 2 * 6
    step = jax.jit(jax_make_train_step(JaxBSI(**ALGO), lambda p, mu, t, rng: model.apply(p, mu, t), tx,
                                       JaxEMAConfig(**EMA)),
                   in_shardings=(shardings, NamedSharding(mesh, P("data"))),
                   out_shardings=(shardings, NamedSharding(mesh, P())))
    x_np, x = batch_of(62, (8, 8, 8, 3))
    want = []
    for _ in range(STEPS):
        state, metrics = step(state, jnp.asarray(x_np))
        want.append({k: float(v) for k, v in metrics.items()})
    draws = [jax_step_draws(key, n, tuple(x.shape), (8, 8, 3)) for n in range(STEPS)]
    torch.save({"model": MODEL, "params": params_from_jax(params), "algo": ALGO, "sched": SCHED, "ema": EMA,
                "batch": x, "draws": draws}, (tmp_path / "out").mkdir() or tmp_path / "out" / "inputs.pt")

    got = launch(tmp_path, 2, "jax_step")
    assert got[0]["jax_step"] == got[1]["jax_step"]
    # each rank holds its half of every Megatron pair's weights
    full = sum(int(np.prod(np.shape(a))) for a in jax.tree.leaves(params))
    assert got[0]["jax_step"]["local_numel"] < full
    for ours, theirs in zip(got[0]["jax_step"]["metrics"], want):
        # JAX's plain attention takes f32 logits even at f64 (as the port's
        # plain path does, bsi_torch/ops/flash_attention.py::_xla_attention):
        # a rounding-boundary flip of one f32 logit moves the loss by ~1e-9
        npt.assert_allclose(ours["train/loss"], theirs["train/loss"], rtol=1e-9)
        npt.assert_allclose(ours["train/grad_norm"], theirs["train/grad_norm"], rtol=1e-9)
    after = params_to_jax(torch.load(tmp_path / "out" / "jax_step" / "params.pt"))
    # Adam divides each gradient element by its own scale, so where a
    # gradient is ~0 a rounding-level difference becomes a visible step: each
    # leaf is held to 1e-8 of its norm plus 1e-6 of the farthest Adam could
    # have moved it (lr summed over the steps, in every element). The key
    # bias has no gradient at all (softmax ignores a shift shared by every
    # key), so its k columns are rounding noise on both sides, held to
    # Adam's bound alone, as tests/test_torch_dit_train.py holds them.
    schedule = jax_warmup_cosine(**SCHED)
    lr_sum = sum(float(schedule(n)) for n in range(STEPS))
    k_cols = np.r_[16:32, 64:80]  # grouped (g qkv hpg d): 2 groups of q|k|v, 16 each
    for path, w in jax.tree_util.tree_leaves_with_path(state.params["params"]):
        name = jax.tree_util.keystr(path)
        w = np.asarray(w)
        got_leaf = after
        for k in path:
            got_leaf = got_leaf[k.key]
        diff = got_leaf - w
        if name.endswith("['to_qkv']['bias']"):
            assert np.abs(diff[k_cols]).max() <= 2 * lr_sum, name
            diff, w = np.delete(diff, k_cols), np.delete(w, k_cols)
        assert np.linalg.norm(diff) <= 1e-8 * np.linalg.norm(w) + 1e-6 * lr_sum * np.sqrt(w.size), name
