"""The port's pipeline parallelism (``bsi_torch/parallel/pipeline.py``)
against the JAX package's (``bsi_tpu/parallel/pipeline.py``) and against
one process, on the CPU, f64.

JAX runs on the conftest's CPU devices; the port on gloo ranks started by
``tests/torch_parallel_worker.py`` (one launch of 2 ranks and one of 4),
on the same weights (the tiny DiT of ``tests/test_pipeline.py``: depth 4,
dim 32, 2 heads, 8x8x3, patch 2, Fourier features 6..7, ``ada_out``
filled) and inputs:

- the pipelined forward and every leaf's gradient at (P, M) = (2, 2),
  (2, 4), (4, 2), and at P 2 x TP 2 with and without SP, against the port
  in one process to ``tests/test_pipeline.py``'s tolerances (1e-10 on the
  output, 1e-8 relative on the gradients), and against JAX's
  ``make_pipeline_apply`` on the conftest's CPU devices to the DiT's parity
  tolerances (``tests/test_torch_dit.py``, ``test_torch_dit_train.py``:
  JAX's plain attention takes f32 logits even at f64, the port's f64 ones
  rounded to f32); each leaf's gradient on every stage that holds it, and
  the order of the point-to-point transfers the same on both sides of
  every pair of stages;
- ``make_train_step`` at P 2 x DP 2 on JAX's draws against JAX's pipelined
  train step, 3 steps;
- the Trainer at P 2 (dropout on, M 4, and with remat), at P 2 x DP 2
  with FSDP and at P 2 x TP 2 with SP and dropout (also with remat) against
  one process, the one-process Trainer with remat, checkpoints across P
  1 and P 2 bit for bit, the dropout masks of each block and microbatch,
  and ``python -m bsi_torch.train``'s ``main`` at P 2 with its checkpoint
  restored without the pipe;
- ``pp_plan`` against ``pp_state_sharding``, and the refusals JAX makes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from bsi_tpu.core import BSI as JaxBSI
from bsi_tpu.models import DenoisingDiT as JaxDiT
from bsi_tpu.models.dit import stack_block_params, unstack_block_params
from bsi_tpu.nn import FourierFeatures as JaxFF
from bsi_tpu.parallel import make_mesh as jax_make_mesh
from bsi_tpu.parallel.pipeline import make_pipeline_apply as jax_pipeline_apply
from bsi_tpu.parallel.pipeline import pp_state_sharding
from bsi_tpu.parallel.sequence import apply_sequence_parallelism as jax_sp
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

MODEL = dict(data_shape=(8, 8, 3), patch_size=2, dim=32, depth=4, heads=2)
ALGO = dict(data_shape=(8, 8, 3), lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, preconditioning="edm")
SCHED = dict(lr=1e-3, warmup_steps=2, max_steps=10)
STEPS = 3
# (P, M, TP, SP) on each launch
CASES = {2: [(2, 2, 1, False), (2, 4, 1, False)], 4: [(4, 2, 1, False), (2, 2, 2, False), (2, 2, 2, True)]}


def case_name(pipe, micro, tp, sp):
    return f"p{pipe}_m{micro}_tp{tp}" + ("_sp" if sp else "")


def jax_model(**kw):
    return JaxDiT(fourier_features=JaxFF(6, 7), scan_blocks=True, **MODEL, **kw)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's pipelined outputs, gradients and train step, and the inputs the
    workers read (``out/inputs.pt`` of each launch's directory)."""
    model = jax_model()
    params = model.init(jax.random.key(70), jnp.zeros((2, 8, 8, 3)), jnp.zeros((2,)))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), fill_ada_out(params, 170))
    rng = np.random.default_rng(71)
    mu, t = rng.normal(size=(8, 8, 8, 3)), rng.uniform(size=(8,))
    refs = {}
    for case in CASES[2] + CASES[4]:
        pipe, micro, tp, sp = case
        mesh = jax_make_mesh(pipe * tp, pipeline_parallelism=pipe, model_parallelism=tp)
        m = jax_sp(model, mesh) if sp else model
        papply = jax_pipeline_apply(m, mesh, microbatches=micro)
        placed = jax.device_put(params, pp_state_sharding(params, mesh))
        fwd = lambda p: papply(p, jnp.asarray(mu), jnp.asarray(t), None, deterministic=True)
        y = jax.jit(fwd)(placed)
        grads = jax.jit(jax.grad(lambda p: (fwd(p) ** 2).mean()))(placed)
        refs[case_name(*case)] = (np.asarray(y), params_from_jax(jax.device_get(grads)))

    # the pipelined train step at P 2 x DP 2
    mesh = jax_make_mesh(4, pipeline_parallelism=2)
    papply = jax_pipeline_apply(model, mesh, microbatches=2)
    tx = jax_make_optimizer(jax_warmup_cosine(**SCHED))
    key = jax.random.key(72)
    state = JaxTrainState.create(params=params, opt_state=tx.init(params), rng=key)
    shardings = pp_state_sharding(state, mesh)
    state = jax.device_put(state, shardings)
    step = jax.jit(jax_make_train_step(JaxBSI(**ALGO), lambda p, mu_, t_, r: papply(p, mu_, t_, r, deterministic=False),
                                       tx, JaxEMAConfig(**EMA)),
                   in_shardings=(shardings, NamedSharding(mesh, P("data"))),
                   out_shardings=(shardings, NamedSharding(mesh, P())))
    x_np, x = batch_of(73, (8, 8, 8, 3))
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, jnp.asarray(x_np))
        metrics.append({k: float(v) for k, v in m.items()})
    draws = [jax_step_draws(key, n, tuple(x.shape), (8, 8, 3)) for n in range(STEPS)]
    # the port in one process on the same weights: what the pipeline must reproduce
    from bsi_torch.models import DenoisingDiT
    from bsi_torch.nn import FourierFeatures

    port = DenoisingDiT(fourier_features=FourierFeatures(6, 7), device="cpu", **MODEL).double()
    port.load_state_dict(params_from_jax(params))
    named = dict(port.named_parameters())
    y_port = port(torch.from_numpy(mu), torch.from_numpy(t))
    g_port = dict(zip(named, torch.autograd.grad((y_port ** 2).mean(), list(named.values()))))
    inputs = {"model": MODEL, "params": params_from_jax(params), "mu": torch.from_numpy(mu),
              "t": torch.from_numpy(t), "cases": CASES, "algo": ALGO, "sched": SCHED, "ema": EMA, "batch": x,
              "draws": draws}
    root = tmp_path_factory.mktemp("pipeline")
    for world in (2, 4):
        (root / f"ranks{world}" / "out").mkdir(parents=True)
        torch.save(inputs, root / f"ranks{world}" / "out" / "inputs.pt")
    return {"root": root, "refs": refs, "params": params, "state": jax.device_get(state), "metrics": metrics,
            "port": (y_port.detach().numpy(), {n: g.numpy() for n, g in g_port.items()})}


@pytest.fixture(scope="module")
def ranks2(jax_side):
    return launch(jax_side["root"] / "ranks2", 2, "pipe_apply,pipe_masks,pipe_trainer2,pipe_entry")


@pytest.fixture(scope="module")
def ranks4(jax_side):
    return launch(jax_side["root"] / "ranks4", 4, "pipe_apply,pipe_step,pipe_trainer4")


def _case_files(jax_side, world, name):
    out = jax_side["root"] / f"ranks{world}" / "out" / "pipe_apply"
    return [torch.load(out / f"{name}_rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.mark.parametrize("world, case", [(w, c) for w in (2, 4) for c in CASES[w]],
                         ids=[case_name(*c) for w in (2, 4) for c in CASES[w]])
def test_pipelined_forward_and_gradients_match(jax_side, ranks2, ranks4, world, case):
    name = case_name(*case)
    y_jax, g_jax = jax_side["refs"][name]
    y_one, g_one = jax_side["port"]
    files = _case_files(jax_side, world, name)
    scale = max(np.linalg.norm(g.numpy()) for g in g_jax.values())
    seen = {}
    for got in files:
        # every pipe rank returns the whole output
        npt.assert_allclose(got["y"].numpy(), y_one, rtol=1e-10, atol=1e-10)
        npt.assert_allclose(got["y"].numpy(), y_jax, rtol=0, atol=1e-6)
        for leaf, g in got["grads"].items():
            g, want = g.numpy(), g_jax[leaf].numpy()
            npt.assert_allclose(g, g_one[leaf], rtol=1e-8, atol=1e-10, err_msg=leaf)
            assert np.linalg.norm(g - want) <= 1e-5 * np.linalg.norm(want) + 1e-9 * scale, leaf
            seen.setdefault(leaf, []).append(got["stage"])
    assert set(seen) == set(g_jax) == set(g_one)
    pipe = case[0]
    for leaf, stages in seen.items():
        if ".block_" in leaf:
            # a block's leaves live on one stage: the one that runs the block
            block = int(leaf.split(".block_")[1].split(".")[0])
            assert set(stages) == {block // (MODEL["depth"] // pipe)}, (leaf, stages)
        else:
            assert sorted(set(stages)) == list(range(pipe)), (leaf, stages)


@pytest.mark.parametrize("world, case", [(w, c) for w in (2, 4) for c in CASES[w]],
                         ids=[case_name(*c) for w in (2, 4) for c in CASES[w]])
def test_neighbours_meet_their_transfers_in_one_order(jax_side, ranks2, ranks4, world, case):
    files = _case_files(jax_side, world, case_name(*case))
    pipe, micro = case[0], case[1]
    mirror = {"send": "recv", "recv": "send"}
    for rank, got in enumerate(files):
        stage = got["stage"]
        for peer in {p for _, p, _ in got["trace"]}:
            mine = [(op, shape) for op, p, shape in got["trace"] if p == peer]
            theirs = [(mirror[op], shape) for op, p, shape in files[peer]["trace"] if p == rank]
            assert mine == theirs, (rank, peer)
            # forward: M sends down (or receives from above), then the backward's M the other way
            down = files[peer]["stage"] > stage
            ops = [op for op, _ in mine]
            assert ops == ["send" if down else "recv"] * micro + ["recv" if down else "send"] * micro


def test_pipelined_train_step_matches_jax(jax_side, ranks4):
    got = [r["pipe_step"] for r in ranks4]
    for r in got[1:]:
        assert r["metrics"] == got[0]["metrics"]
    # data ranks x pipe ranks
    assert sorted(tuple(r["mesh"]) for r in got) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    full = sum(int(np.prod(np.shape(a))) for a in jax.tree.leaves(jax_side["params"]))
    assert all(r["local_numel"] < full for r in got)
    for ours, theirs in zip(got[0]["metrics"], jax_side["metrics"]):
        # JAX's plain attention takes f32 logits even at f64 (tests/test_torch_parallel_jax.py)
        npt.assert_allclose(ours["train/loss"], theirs["train/loss"], rtol=1e-9)
        npt.assert_allclose(ours["train/grad_norm"], theirs["train/grad_norm"], rtol=1e-9)
    after = torch.load(jax_side["root"] / "ranks4" / "out" / "pipe_step" / "params.pt")
    want = params_from_jax(jax_side["state"].params)
    assert set(after) == set(want)
    schedule = jax_warmup_cosine(**SCHED)
    lr_sum = sum(float(schedule(n)) for n in range(STEPS))
    k_cols = np.r_[16:32, 64:80]  # grouped (g qkv hpg d): 2 groups of q|k|v, 16 each
    for name, w in want.items():
        w, diff = w.numpy(), (after[name] - w).numpy()
        if name.endswith("attn.to_qkv.bias"):
            # the key bias has no gradient: rounding noise on both sides, held to Adam's bound
            assert np.abs(diff[k_cols]).max() <= 2 * lr_sum, name
            diff, w = np.delete(diff, k_cols), np.delete(w, k_cols)
        assert np.linalg.norm(diff) <= 1e-8 * np.linalg.norm(w) + 1e-6 * lr_sum * np.sqrt(w.size), name


def _holds_one_process(got, steps=3):
    npt.assert_allclose(got["layout"]["loss"], got["base"]["loss"], rtol=1e-10)
    npt.assert_allclose(got["layout"]["grad_norm"], got["base"]["grad_norm"], rtol=1e-10)
    npt.assert_allclose(got["layout"]["val_bpd"], got["base"]["val_bpd"], rtol=1e-10)
    npt.assert_allclose(got["layout"]["val_fid"], got["base"]["val_fid"], rtol=1e-8)
    assert got["worst_leaf"] < 1e-10, got["worst_leaf"]
    assert len(got["layout"]["loss"]) == steps


@pytest.mark.parametrize("world, run", [(2, "dropout"), (2, "m4"), (4, "fsdp"), (4, "tp_sp")])
def test_pipelined_trainer_matches_one_process(ranks2, ranks4, world, run):
    ranks = ranks2 if world == 2 else ranks4
    results = [r[f"pipe_trainer{world}"][run] for r in ranks]
    for r in results[1:]:
        assert r["layout"] == results[0]["layout"]
    _holds_one_process(results[0])
    # a stage holds its block (of 2) and the rest, about half the model;
    # FSDP then halves the block's large leaves over the data group
    assert results[0]["local_numel"] < (0.4 if run == "fsdp" else 0.6) * results[0]["full_numel"]


@pytest.mark.parametrize("world", [2, 4], ids=["p2", "p2_tp2_sp"])
def test_remat_under_the_pipeline_matches_one_process_and_remat_off(ranks2, ranks4, world):
    """remat recomputes each block in the backward, after the calls that
    bound the state's tensors to the model have returned: the state, not
    the module's initial weights (nor, under TP, its full-shape ones), must
    be what it reads, from step 2 on as at step 1. Dropout is on."""
    ranks = ranks2 if world == 2 else ranks4
    results = [r[f"pipe_trainer{world}"]["remat"] for r in ranks]
    for r in results[1:]:
        assert r["layout"]["layout"] == results[0]["layout"]["layout"]
    _holds_one_process(results[0]["layout"])
    _holds_one_process(results[0]["layout_off"])
    if world == 2:
        # the one-process Trainer with remat, the same fault's other face
        _holds_one_process(results[0]["one"])


def test_the_entry_point_trains_over_the_pipe_and_its_checkpoint_restores_in_one_process(ranks2):
    for r in ranks2:
        got = r["pipe_entry"]
        assert len(got["loss"]) == 2 and np.isfinite(got["loss"]).all()
        assert len(got["val_bpd"]) == 1 and np.isfinite(got["val_bpd"]).all()
        assert got["restored"] and got["pipeline_parallelism"] == 1
    assert ranks2[0]["pipe_entry"] == ranks2[1]["pipe_entry"]


def test_checkpoints_cross_pipeline_layouts_bit_for_bit(ranks2):
    for r in ranks2:
        got = r["pipe_trainer2"]["ckpt"]
        assert got["p2_gathers_the_file"] and got["p2_to_p1_bit_equal"] and got["p1_to_p2_bit_equal"]
        assert got["p2_resume_bit_equal"]
        cont = got["p1_to_p2_then_3_steps"]
        # the P 2 run's 3 steps are the one-process run's steps 4-6
        npt.assert_allclose(cont["layout"]["loss"], cont["base"]["loss"][3:], rtol=1e-10)
        assert cont["worst_leaf"] < 1e-10
    # stage 0 holds block 0 and the rest, stage 1 block 1 and the rest
    held = [set(r["pipe_trainer2"]["ckpt"]["held"]) for r in ranks2]
    assert not any(".block_1." in n for n in held[0]) and not any(".block_0." in n for n in held[1])


def test_dropout_masks_per_block_and_microbatch(ranks2):
    stages = [r["pipe_masks"] for r in ranks2]
    masks = {}
    for s in stages:
        for key, run in s.items():
            if key != "one_process":
                for block, ms in run["masks"].items():
                    masks.setdefault(key, {})[block] = ms
    a, again, b = masks["a"], masks["a_again"], masks["b"]
    # 4 blocks (2 a stage) x 2 microbatches
    assert set(a) == {"0", "1", "2", "3"} and all(len(v) == 2 for v in a.values())
    assert a == again and all(a[k] != b[k] for k in a)
    every = [m for v in a.values() for m in v]
    assert len(set(every)) == len(every)  # distinct across blocks and microbatches
    # the one-process run's masks of each block, its rows cut in two, are the pipeline's
    one = stages[0]["one_process"]["masks"]
    for block, (whole,) in one.items():
        bits = np.unpackbits(np.frombuffer(bytes.fromhex(whole), np.uint8))
        halves = [np.packbits(h).tobytes().hex() for h in np.split(bits, 2)]
        assert halves == a[block], block
    outs = [s[k]["out"] for s in stages for k in ("a", "a_again", "b")]
    assert np.isfinite(outs).all()
    npt.assert_allclose(stages[0]["a"]["out"], stages[0]["one_process"]["out"], rtol=1e-12)
    assert stages[0]["a"]["out"] != stages[0]["b"]["out"]


def test_params_to_jax_builds_the_scan_layout(jax_side):
    loop = unstack_block_params(jax_side["params"])
    state = params_from_jax(loop)
    scan = params_to_jax(state, scan_blocks=True)
    want = stack_block_params(loop, depth=MODEL["depth"])["params"]
    assert jax.tree.structure(scan) == jax.tree.structure(jax.tree.map(np.asarray, want))
    for a, b in zip(jax.tree.leaves(scan), jax.tree.leaves(want)):
        npt.assert_array_equal(a, np.asarray(b))
    assert list(scan["dit"])[-1] == "blocks"
    back = unstack_block_params({"params": scan})["params"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(loop["params"])):
        npt.assert_array_equal(a, np.asarray(b))
    assert params_to_jax(state).keys() == loop["params"].keys()


def test_pp_plan_lays_out_leaves_as_pp_state_sharding(jax_side):
    """P 2 x TP 2 x DP 2 with FSDP: each block's leaves on its stage, the rest
    on every stage, and every kernel's model and data dims those of JAX's
    stacked leaf (a torch weight is the kernel transposed; JAX's rules leave
    the column biases whole, where the port cuts them, PR 14)."""
    from bsi_torch.parallel import Mesh, pp_plan

    min_size = 2**10
    jax_mesh = jax_make_mesh(8, pipeline_parallelism=2, model_parallelism=2)
    specs = pp_state_sharding(jax_side["params"], jax_mesh, fsdp=True, min_size=min_size)
    ndim = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.ndim, jax_side["params"])))
    specs = {tuple(k.key for k in path): tuple(s.spec) + (None,) * (ndim[path] - len(s.spec))
             for path, s in jax.tree_util.tree_leaves_with_path(specs)}
    named = params_from_jax(jax_side["params"])
    plan = pp_plan(named, Mesh(data_size=2, model_size=2, pipe_size=2), fsdp=True, min_size=min_size)
    kernels = 0
    for name, shard in plan.items():
        *parents, leaf = name.split(".")
        block = next((int(p[6:]) for p in parents if p.startswith("block_")), None)
        if block is not None:
            parents = [p for p in parents if not p.startswith("block_")]
            parents[parents.index("dit") + 1:parents.index("dit") + 1] = ["blocks", "block"]
        leaf = {"weight": "kernel" if named[name].ndim == 2 else "scale"}.get(leaf, leaf)
        spec = specs[("params", *parents, leaf)]
        assert (spec[0] == "pipe") == (block is not None), name
        assert shard.stage == (None if block is None else block // 2), name
        if leaf == "kernel":
            ours = [None, None]
            for dim, axis in ((shard.model_dim, "model"), (shard.data_dim, "data")):
                if dim is not None:
                    ours[1 - dim] = axis  # [out, in] -> [in, out]
            assert tuple(ours) == spec[-2:], (name, ours, spec)
            kernels += 1
        assert shard.pipe_sum == name.startswith("dit.patch_encoder."), name
    assert kernels == 6 * MODEL["depth"] + 2


def test_the_pipeline_refuses_what_jax_refuses():
    from bsi_torch.models import DenoisingDiT
    from bsi_torch.parallel import Mesh, make_pipeline_apply, stage_blocks

    with pytest.raises(ValueError, match="^model depth 3 not divisible by pipe axis 2$"):
        stage_blocks(3, 2, 0)
    assert [stage_blocks(24, 2, s) for s in (0, 1)] == [(0, 12), (12, 24)]
    with pytest.raises(ValueError, match="pipeline parallelism needs a model built with scan_blocks=True"):
        make_pipeline_apply(DenoisingDiT(device="cpu", **MODEL), Mesh())
    with pytest.raises(ValueError, match="a pipe axis of more than one stage"):
        make_pipeline_apply(DenoisingDiT(device="cpu", scan_blocks=True, **MODEL), Mesh())
