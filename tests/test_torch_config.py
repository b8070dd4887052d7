"""The port's config system against the JAX package's: its own YAML reader
against PyYAML (the JAX package's loader) on every file of ``configs/``, the
composed configs, the sweep expansion, and the ``_target_`` mapping."""

from pathlib import Path

import pytest

from bsi_tpu.config.config import ConfigLoader as JaxConfigLoader
from bsi_tpu.config.config import _yaml_load as jax_yaml_load

from bsi_torch.config import ConfigError, ConfigLoader, instantiate, locate, port_target
from bsi_torch.config.yaml_subset import YamlError, load
from bsi_torch.train.__main__ import CONFIG_DIR, expand_sweep

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
FILES = sorted(str(p.relative_to(CONFIGS)) for p in CONFIGS.rglob("*.yaml"))


def same(a, b) -> bool:
    """Equal, with the types as well (``1`` is not ``1.0`` or ``True``)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b or (a != a and b != b)  # nan


def test_entry_point_reads_the_repos_configs():
    assert CONFIG_DIR == CONFIGS and len(FILES) >= 28


@pytest.mark.parametrize("name", FILES)
def test_reader_matches_pyyaml_on_every_config_file(name):
    text = (CONFIGS / name).read_text()
    assert same(load(text), jax_yaml_load(text))


OVERRIDE_VALUES = [
    "[32,32,3]", "[0.9, 0.99]", "2e-4", "3e-4", "1e-2", "-1.5e+3", "6.73794699909e-3", "0.66666666666666666",
    "1947925778702538666", "10", "-7", "0", "0x1F", "0o17", "017", "1_000", "yes", "no", "true", "False", "on",
    "OFF", "~", "null", "", "cpu", "bf16", '"32"', "'it''s'", '"a\\tb"', "mu_dtype", "[vdm, bfn, bsi]",
    "{a: 1, b: [2, 3]}", "[]", "{}", ".inf", "-.inf", ".nan", "1.", ".5", "${eval:'0.01 * ${..optimizer.lr}'}",
    "${task.name}-${task.model.name}", "a b c", "key: value", "- x", "[a, [b, c]]", "09", "1e5", "+3",
]


@pytest.mark.parametrize("raw", OVERRIDE_VALUES)
def test_reader_matches_pyyaml_on_override_values(raw):
    assert same(load(raw), jax_yaml_load(raw))


BLOCKS = [
    "a:\n- 1\n- 2\nb: 3\n",
    "a:\n  - x: 1\n    y: 2\n  - z\n",
    "- - 1\n  - 2\n- 3\n",
    "a: # comment\n  b: 'c # not a comment'\n",
    "a:\n\n  b: 1   # trailing\n# full line\n  c: [1, 2]\n",
    "'quoted key': 1\n\"other\": x\n",
    "a:\nb:\n",
]


@pytest.mark.parametrize("text", BLOCKS)
def test_reader_matches_pyyaml_on_block_structures(text):
    assert same(load(text), jax_yaml_load(text))


@pytest.mark.parametrize("text", ["a: &x 1\n", "a: !!int 3\n", "a: |\n  text\n", "a: 1\n---\nb: 2\n",
                                  "a: 1\n  b: 2\n", "a: b\n c\n", "a: 1\na: 2\n"])
def test_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(YamlError):
        load(text)


LOADS = [
    [],
    ["experiment=cifar10-vdm"],
    ["experiment=imagenet32"],
    ["experiment=imagenet64"],
    ["mode=debug"],
    ["mode=debug", "data=synthetic", "data.data_shape=[4,4,3]", "+trainer.device=cpu"],
    ["experiment=cifar10-vdm", "data=synthetic", "data.data_shape=[32,32,3]", "trainer.max_steps=6",
     "trainer.accumulate_grad_batches=2"],
    ["task=vdm", "task.model=mlp", "task/lr_scheduler=cosine", "task.optimizer.mu_dtype=bfloat16"],
    ["task.model=dit", "task.model.fourier_features=none", "seed=7", "+extra.new.key=1e-3"],
    ["experiment=imagenet32", "task=bfn", "task.optimizer.lr=1e-4"],
]


@pytest.mark.parametrize("overrides", LOADS, ids=lambda ov: " ".join(ov) or "defaults")
def test_composed_configs_match_jax(overrides):
    ours = ConfigLoader(CONFIGS).load("train", overrides)
    ref = JaxConfigLoader(CONFIGS).load("train", overrides)
    assert same(ours, ref)


def test_override_errors_match_jax():
    for bad in (["trainer.no_such_key=1"], ["novalue"], ["data=no_such_option"]):
        with pytest.raises(ConfigError):
            ConfigLoader(CONFIGS).load("train", bad)
        with pytest.raises(Exception):
            JaxConfigLoader(CONFIGS).load("train", bad)


@pytest.mark.parametrize("overrides", [
    ["data=synthetic", "seed=1,2", "task=bsi,vdm"],
    ["experiment=imagenet32"],
    ["experiment=imagenet32", "task=bsi,vdm"],
    ["experiment=cifar10-vdm", "data=synthetic", "data.data_shape=[32,32,3]"],
])
def test_expand_sweep_matches_train_py(overrides):
    import train as train_cli

    assert expand_sweep(ConfigLoader(CONFIGS), overrides) == train_cli.expand_sweep(JaxConfigLoader(CONFIGS),
                                                                                     overrides)


def test_instantiate_maps_targets_to_the_port():
    assert port_target("bsi_tpu.models.DenoisingVDMUNet") == "bsi_torch.models.DenoisingVDMUNet"
    assert port_target("collections.OrderedDict") == "collections.OrderedDict"
    from bsi_torch.models import DenoisingMLP
    from bsi_torch.nn import FourierFeatures

    assert locate("bsi_tpu.models.DenoisingMLP") is DenoisingMLP
    cfg = ConfigLoader(CONFIGS).load("train", ["task.model=mlp"])
    ff = instantiate(cfg["task"]["model"]["fourier_features"])
    assert isinstance(ff, FourierFeatures) and (ff.n_min, ff.n_max) == (6, 8)
    model = instantiate(cfg["task"]["model"], data_shape=(4, 4, 3), device="cpu")
    assert isinstance(model, DenoisingMLP) and model.data_shape == (4, 4, 3)


@pytest.mark.parametrize("overrides,target", [
    (["task=vdm"], "bsi_tpu.core.VDM"),
    (["task=bfn"], "bsi_tpu.core.BFN"),
    (["data=imagenet32"], "bsi_tpu.data.ImageNetDataModule"),
])
def test_unported_targets_name_their_roadmap_item(overrides, target, tmp_path):
    # The three targets that once raised naming their ROADMAP item (the
    # baselines, ImageNet) now read as the port's classes and build.
    from bsi_torch.core import Discretization
    from bsi_torch.data.imagenet import write_synthetic_shards

    cfg = ConfigLoader(CONFIGS).load("train", overrides)
    node = cfg["data"] if overrides[0].startswith("data") else cfg["task"]["algorithm"]
    assert node["_target_"] == target
    inner = target.partition(".")[2]
    assert port_target(target) == f"bsi_torch.{inner}"
    cls = locate(target)
    assert cls.__module__.startswith("bsi_torch.") and cls.__name__ == inner.rpartition(".")[2]
    if overrides[0].startswith("data"):
        write_synthetic_shards(tmp_path, 32, 100, 4, seed=0)
        built = instantiate(dict(node, root=str(tmp_path)), seed=1)
        assert built.data_shape() == (32, 32, 3)
    else:
        built = instantiate(node, data_shape=(4, 4, 3), discretization=Discretization.image_8bit())
        assert built.data_shape == (4, 4, 3) and built.k == 50
    assert isinstance(built, cls)


def test_the_port_reads_no_yaml_library():
    import subprocess
    import sys

    code = ("import sys; from bsi_torch.config import ConfigLoader; from bsi_torch.train.__main__ import CONFIG_DIR; "
            "ConfigLoader(CONFIG_DIR).load('train', ['experiment=cifar10-vdm']); "
            "print(sorted(m for m in ('yaml', 'jax', 'bsi_tpu') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=CONFIGS.parent)
    assert out.stdout.strip() == "[]"
