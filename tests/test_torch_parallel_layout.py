"""The parallel layouts' pieces that need no process group, on the CPU:
the FSDP and TP leaf rules against the JAX package's shardings on the same
leaves, K4b's sequence-sharded backward against the JAX package's (its
partition rule psums dshift and dscale), the attention's dropout draws cut
from the global batch's, a rank's rows of a sampling run, the mesh without a group, the entry point's
environment rules, and the launcher."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from bsi_tpu.models import DenoisingDiT as JaxDiT
from bsi_tpu.nn import FourierFeatures as JaxFF
from bsi_tpu.parallel import make_mesh as jax_make_mesh
from bsi_tpu.parallel.fsdp import fsdp_state_sharding
from bsi_tpu.parallel.tensor import tp_state_sharding

from bsi_torch.convert import params_from_jax
from bsi_torch.ops import ln_modulate as lm
from bsi_torch.ops.attention import DrawShard, multi_head_attention_fused_qkv
from bsi_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    Shard,
    StateLayout,
    check_host_batch,
    fsdp_plan,
    host_shard,
    initialize_distributed,
    make_mesh,
    tp_plan,
)
from bsi_torch.utils.launcher import render_pod_commands, render_slurm_script, submit_slurm, torchrun_env

jax_lm = importlib.import_module("bsi_tpu.ops.ln_modulate")


# ------------------------------------------------------------ leaf rules


def _jax_dim(torch_name: str, torch_dim, ndim: int):
    """The JAX leaf's dim of a torch leaf's dim: a Dense weight [out, in] is
    the kernel [in, out] transposed."""
    if torch_dim is None:
        return None
    return 1 - torch_dim if ndim == 2 else torch_dim


def _jax_path(torch_name: str, ndim: int) -> str:
    *parents, leaf = torch_name.split(".")
    leaf = {"weight": "kernel" if ndim == 2 else "scale"}.get(leaf, leaf)
    return "/".join(["params", *parents, leaf])


def _specs(shardings) -> dict:
    return {"/".join(str(k.key) for k in path): s.spec
            for path, s in jax.tree_util.tree_leaves_with_path(shardings)}


@pytest.mark.parametrize("min_size", [2**14, 2**8])
@pytest.mark.parametrize("kind", ["fsdp", "tp", "tp_fsdp"])
def test_leaf_rules_match_jax(kind, min_size):
    # the tiny DiT of tests/test_tensor_parallel.py, on a (data 4, model 2) mesh
    model = JaxDiT(data_shape=(8, 8, 3), patch_size=2, dim=32, depth=2, heads=2, fourier_features=JaxFF(6, 7))
    params = model.init(jax.random.key(0), jnp.zeros((2, 8, 8, 3)), jnp.zeros((2,)))
    mesh = jax_make_mesh(8, model_parallelism=2)
    ours = params_from_jax(params)
    if kind == "fsdp":
        want = _specs(fsdp_state_sharding(params, mesh, min_size=min_size))
        got = {n: Shard(data_dim=d) for n, d in fsdp_plan(ours, 4, min_size).items()}
    else:
        want = _specs(tp_state_sharding(params, mesh, fsdp=kind == "tp_fsdp", min_size=min_size))
        got = tp_plan(ours, 2, fsdp=kind == "tp_fsdp", data_size=4, min_size=min_size)
    assert len(got) == len(want)
    sharded = {DATA_AXIS: 0, MODEL_AXIS: 0}
    for name, shard in got.items():
        ndim = ours[name].ndim
        spec = list(want[_jax_path(name, ndim)]) + [None] * ndim
        jax_model = spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None
        jax_data = spec.index(DATA_AXIS) if DATA_AXIS in spec else None
        if ndim == 1 and shard.model_dim == 0 and jax_model is None:
            # a column-parallel layer's bias: JAX's rules name only kernels
            # (GSPMD slices the replicated bias); the port keeps its slice
            assert any(name.endswith(s) for s in (".ada_in.bias", ".to_qkv.bias", ".Dense_0.bias")), name
        else:
            assert _jax_dim(name, shard.model_dim, ndim) == jax_model, name
        assert _jax_dim(name, shard.data_dim, ndim) == jax_data, name
        sharded[DATA_AXIS] += shard.data_dim is not None
        sharded[MODEL_AXIS] += shard.model_dim is not None
    assert sharded[MODEL_AXIS] == (0 if kind == "fsdp" else 2 * (6 + 3))
    assert (sharded[DATA_AXIS] > 0) == (kind != "tp" and min_size == 2**8)


def test_state_layout_cuts_and_draws_without_a_group():
    mesh = Mesh(data_size=2, model_size=2, data_rank=1, model_rank=0)
    layout = StateLayout(mesh, {"w": Shard(model_dim=0, data_dim=1), "b": Shard()})
    full = torch.arange(48.0).reshape(4, 12)
    npt.assert_array_equal(layout.local("w", full), full[:2, 6:])
    assert not layout.local("b", full).data_ptr() == full.data_ptr()
    batch = torch.zeros(3, 2)
    assert layout.global_like(batch).shape == (6, 2)
    npt.assert_array_equal(layout.rows(torch.arange(6), 0, 3), [3, 4, 5])
    seeds = {StateLayout(Mesh(data_size=4, data_rank=r), {}).dropout_seed(7) for r in range(4)}
    assert StateLayout(Mesh(), {}).dropout_seed(7) == 7 and len(seeds) == 4


# ------------------------------------------------------ K4b under SP


def test_k4b_sequence_sharded_backward_matches_jax(monkeypatch):
    # JAX's partitioned K4b in Pallas interpret mode on the CPU mesh, as
    # tests/test_sequence_parallel.py runs it, against the port's plain K4b
    # (_bwd_math) on each of the two token shards, dshift and dscale summed
    monkeypatch.setattr(jax_lm, "_INTERPRET", True)
    monkeypatch.setattr(jax_lm, "_use_pallas", lambda x: True)
    jax_lm._partitioned_fwd.cache_clear()
    jax_lm._partitioned_bwd.cache_clear()
    try:
        mesh = jax_make_mesh(8, model_parallelism=2)
        sp = NamedSharding(mesh, P("data", "model", None))
        rng = np.random.default_rng(0)
        b, s, d = 4, 16, 256
        x, g = rng.normal(size=(b, s, d)), rng.normal(size=(b, s, d))
        shift, scale = rng.normal(size=(b, d)), 0.1 * rng.normal(size=(b, d))

        def loss(x_, shift_, scale_):
            out = jax_lm.layernorm_modulate(jax.lax.with_sharding_constraint(x_, sp), shift_, scale_)
            return jnp.sum(jax.lax.with_sharding_constraint(out, sp) * g)

        want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            *(jnp.asarray(a, jnp.float32) for a in (x, shift, scale)))
    finally:
        jax_lm._partitioned_fwd.cache_clear()
        jax_lm._partitioned_bwd.cache_clear()
    t = lambda a: torch.from_numpy(a).float()
    halves = [lm._bwd_math(t(x[:, i:i + s // 2]), t(scale), t(g[:, i:i + s // 2])) for i in (0, s // 2)]
    dx = torch.cat([h[0] for h in halves], dim=1)
    dshift = halves[0][1] + halves[1][1]
    dscale = halves[0][2] + halves[1][2]
    for got, w, name in zip((dx, dshift, dscale), want, ("dx", "dshift", "dscale")):
        npt.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("seq", [128, 64])
def test_k4b_plans_the_local_token_counts(seq, dtype):
    # DiT-L/2's 256 tokens over tp 2 and 4: the TMA body, whole rows a warp
    plan = lm.plan(64, seq, 1024, dtype)
    assert plan.tma and plan.rows == 7 and plan.tiles == -(-seq // 7) and plan.smem_bytes <= lm.SMEM_LIMIT


# ------------------------------------------------- draws cut by shard


def test_attention_draws_cut_from_the_global_batch():
    # the grouped qkv of 4 heads of 16 (one head a group): a rank's heads
    # 2..3 of rows 1..2 draw the keep masks the global batch's draw gives them
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.normal(size=(4, 8, 3 * 64)))
    rate = 0.3
    full = multi_head_attention_fused_qkv(qkv, heads=4, dropout_rate=rate,
                                          generator=torch.Generator().manual_seed(5))
    same = multi_head_attention_fused_qkv(qkv, heads=4, dropout_rate=rate, generator=torch.Generator().manual_seed(5),
                                          shard=DrawShard(4, 0, 4, 0))
    assert torch.equal(full, same)
    local = multi_head_attention_fused_qkv(qkv[1:3, :, 2 * 48:], heads=2, dropout_rate=rate,
                                           generator=torch.Generator().manual_seed(5), shard=DrawShard(4, 1, 4, 2))
    npt.assert_allclose(local.numpy(), full[1:3, :, 32:].numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("algorithm", ["bsi", "vdm", "bfn"])
def test_sampling_a_rank_s_rows_is_those_rows_of_the_whole_run(algorithm):
    # what validation FID does under a layout: the noise of the global
    # batch drawn, the sampler run on this rank's rows alone
    from bsi_torch import BFN, BSI, VDM

    shape = (4, 4, 3)
    algo = {"bsi": lambda: BSI(data_shape=shape, lambda_0=1e-2, alpha_M=1e6, alpha_R=2e6, k=4),
            "vdm": lambda: VDM(data_shape=shape, snr_min=6.7e-3, snr_max=6e5, k=4),
            "bfn": lambda: BFN(data_shape=shape, sigma_1=1e-3, k=4)}[algorithm]()
    model_fn = lambda mu, t: torch.tanh(mu) * (0.5 + t.reshape(-1, 1, 1, 1))  # row by row
    run = lambda **kw: algo.sample(model_fn, torch.Generator().manual_seed(3), 6, device="cpu",
                                   dtype=torch.float64, **kw)
    whole = run()
    assert whole.shape == (6,) + shape and torch.isfinite(whole).all()
    assert torch.equal(run(rows=slice(2, 4)), whole[2:4])
    assert torch.equal(run(rows=slice(0, 6)), whole)


# ------------------------------------------------------------- the mesh


def test_mesh_without_a_process_group():
    mesh = make_mesh()
    assert mesh == Mesh() and not mesh.distributed and mesh.writes and mesh.device() is None
    assert host_shard() == (0, 1)
    with pytest.raises(ValueError, match=r"^1 devices not divisible by model_parallelism=2 x pipeline_parallelism=1"
                                         r" x dcn_data_parallelism=1$"):
        make_mesh(model_parallelism=2)
    with pytest.raises(ValueError, match=r"^1 devices not divisible by model_parallelism=1 x pipeline_parallelism=2"
                                         r" x dcn_data_parallelism=1$"):
        make_mesh(pipeline_parallelism=2)
    with pytest.raises(ValueError, match=r"global_batch % num_hosts == 0"):
        check_host_batch(3, 8, 2)
    check_host_batch(4, 8, 2)


def test_initialize_distributed_reads_the_environment(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert initialize_distributed() is False
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="incomplete"):
        initialize_distributed()
    for key, value in torchrun_env(master_port=29511).items():
        monkeypatch.setenv(key, value)
    if not torch.cuda.is_available():
        # NCCL without a card raises; it never carries on over gloo
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            initialize_distributed()


# ------------------------------------------------------------ launcher


def test_slurm_script_and_torchrun_lines(tmp_path):
    script = render_slurm_script(["experiment=imagenet32", "trainer.fsdp=yes"], job_name="in32", nodes=2,
                                 gpus_per_node=8, grace_s=120, extra_directives=["--partition=gpu"])
    for line in ("#SBATCH --signal=USR1@120", "#SBATCH --requeue", "#SBATCH --nodes=2",
                 "#SBATCH --ntasks-per-node=8", "#SBATCH --gpus-per-node=8", "#SBATCH --partition=gpu"):
        assert line in script.splitlines(), line
    for var in ('MASTER_ADDR="${nodes[0]}"', "MASTER_PORT=", 'WORLD_SIZE="$SLURM_NTASKS"',
                'RANK="$SLURM_PROCID"', 'LOCAL_RANK="$SLURM_LOCALID"'):
        assert var in script, var
    assert "JAX_" not in script
    assert "ckpt_interrupt" in script and 'resume="from_ckpt=$ckpt"' in script
    assert "-m bsi_torch.train experiment=imagenet32 trainer.fsdp=yes run_root=runs/in32" in script
    path, job_id = submit_slurm(script, script_path=tmp_path / "job.sbatch", dry_run=True)
    assert job_id is None and path.read_text() == script

    cmds = render_pod_commands(["experiment=imagenet32"], num_nodes=2, gpus_per_node=8,
                               rdzv_endpoint="node0:29400", job_name="in32")
    assert len(cmds) == 2 and len(set(cmds)) == 1
    assert cmds[0].startswith("torchrun --nnodes=2 --nproc-per-node=8 ")
    assert "--rdzv-endpoint=node0:29400" in cmds[0] and cmds[0].endswith(
        "-m bsi_torch.train experiment=imagenet32 run_root=runs/in32")


def test_launch_cli_dry_runs_without_sbatch(tmp_path, capsys, monkeypatch):
    from bsi_torch.scripts import launch

    monkeypatch.setattr("shutil.which", lambda name: None)
    assert launch.main(["--out-dir", str(tmp_path), "-m", "data=synthetic", "seed=1,2"]) == 0
    out = capsys.readouterr().out
    assert out.count("dry-run (no sbatch)") == 2
    assert sorted(p.name for p in tmp_path.glob("*.sbatch")) == ["bsi-torch-0.sbatch", "bsi-torch-1.sbatch"]
    assert "seed=2" in (tmp_path / "bsi-torch-1.sbatch").read_text()
    assert launch.main(["--backend", "pod", "--nodes", "2", "data=synthetic"]) == 0
    assert capsys.readouterr().out.count("torchrun --nnodes=2") == 2
