"""The port's data modules against the JAX package's, bit for bit: the train
stream, the eval batches and masks, the cursor's round trip, sharding, uint8
batches (numpy here, the native gather in the JAX package), and CIFAR-10
read from fabricated pickle batches."""

import pickle

import numpy as np
import numpy.testing as npt
import pytest

from bsi_tpu.data import ArrayDataModule as JaxArrays
from bsi_tpu.data import CIFAR10DataModule as JaxCIFAR10
from bsi_tpu.data import SyntheticDataModule as JaxSynthetic
from bsi_tpu.data import eval_shard as jax_eval_shard
from bsi_tpu.data import padded_batches as jax_padded_batches

from bsi_torch.core import Discretization
from bsi_torch.data import ArrayDataModule, CIFAR10DataModule, SyntheticDataModule, eval_shard, padded_batches


def assert_streams_equal(ours, ref, n_batches: int = 5) -> None:
    a, b = ours.train_batches(), ref.train_batches()
    for _ in range(n_batches):
        x, y = next(a), next(b)
        assert x.dtype == y.dtype
        npt.assert_array_equal(x, y)


def assert_eval_equal(ours, ref, *, test: bool = False) -> None:
    splits_ours = ours.test_splits() if test else ours.eval_splits()
    splits_ref = ref.test_splits() if test else ref.eval_splits()
    assert list(splits_ours) == list(splits_ref)
    for name in splits_ours:
        npt.assert_array_equal(splits_ours[name], splits_ref[name])
        got = list(ours.eval_batches(splits_ours[name]))
        want = list(ref.eval_batches(splits_ref[name]))
        assert len(got) == len(want) > 0
        for (xb, mb), (xw, mw) in zip(got, want):
            npt.assert_array_equal(xb, xw)
            npt.assert_array_equal(mb, mw)


@pytest.mark.parametrize("kw", [
    dict(n_train=40, n_val=13, data_shape=(4, 4, 3), batch_size=6, eval_batch_size=5, seed=3),
    dict(n_train=24, n_val=7, data_shape=(8, 6, 1), batch_size=4, seed=11, augment_flip=True),
    dict(n_train=32, n_val=9, data_shape=(4, 4, 3), batch_size=8, eval_batch_size=4, seed=5, num_shards=2,
         shard_id=1, train_eval_size=10),
])
def test_synthetic_module_matches_jax_bit_for_bit(kw):
    ours, ref = SyntheticDataModule(**kw), JaxSynthetic(**kw)
    assert ours.data_shape() == ref.data_shape() and ours.short_name() == ref.short_name() == "synthetic"
    assert isinstance(ours.discretization(), Discretization)
    assert_streams_equal(ours, ref, 7)
    assert_eval_equal(ours, ref)
    assert_eval_equal(ours, ref, test=True)
    # the cursor round trip: a fresh module resumes the stream where it stood
    # (the cursor holds the indices; the flips' generator is not in it, in
    # either package)
    state = ours.state_dict()
    assert state == ref.state_dict()
    if kw.get("augment_flip"):
        return
    want = [next(ours.train_batches()) for _ in range(3)]
    again = SyntheticDataModule(**kw)
    again.load_state_dict(state)
    got = [next(again.train_batches()) for _ in range(3)]
    for x, y in zip(got, want):
        npt.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype,flip", [
    pytest.param(np.float32, True, id="float32"), pytest.param(np.uint8, True, id="uint8"),
    pytest.param(np.float32, False, id="float32-noflip"), pytest.param(np.uint8, False, id="uint8-noflip"),
])
def test_array_module_matches_jax_bit_for_bit(dtype, flip):
    rng = np.random.default_rng(0)
    make = lambda n: (rng.integers(0, 256, (n, 4, 5, 3)).astype(np.uint8) if dtype == np.uint8
                      else rng.uniform(-1, 1, (n, 4, 5, 3)).astype(np.float32))
    train, val, test = make(30), make(11), make(6)
    kw = dict(batch_size=4, eval_batch_size=3, seed=9, augment_flip=flip, train_eval_size=8)
    ours, ref = ArrayDataModule(train, val, test, **kw), JaxArrays(train, val, test, **kw)
    assert_streams_equal(ours, ref, 9)
    assert_eval_equal(ours, ref)
    assert_eval_equal(ours, ref, test=True)


def test_samplers_match_jax():
    for n, shards in ((11, 3), (7, 1), (16, 4)):
        for shard in range(shards):
            npt.assert_array_equal(eval_shard(n, shard, shards), jax_eval_shard(n, shard, shards))
            idx = eval_shard(n, shard, shards)
            for (a, m), (b, mm) in zip(padded_batches(idx, 3, num_batches=5), jax_padded_batches(idx, 3, 5)):
                npt.assert_array_equal(a, b)
                npt.assert_array_equal(m, mm)
    with pytest.raises(ValueError):
        ArrayDataModule(np.zeros((4, 2, 2, 1), np.float32), np.zeros((2, 2, 2, 1), np.float32), batch_size=3,
                        num_shards=2)


def write_cifar_batches(root, per_batch: int = 20):
    """Five train batches and a test batch in the CIFAR-10 python format."""
    rng = np.random.default_rng(2)
    folder = root / "cifar-10-batches-py"
    folder.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 256, (per_batch, 3072)).astype(np.uint8),
                 b"labels": rng.integers(0, 10, per_batch).tolist()}
        with open(folder / name, "wb") as f:
            pickle.dump(batch, f)


def test_cifar10_module_matches_jax_on_fabricated_batches(tmp_path):
    write_cifar_batches(tmp_path / "ours")
    write_cifar_batches(tmp_path / "ref")
    kw = dict(batch_size=8, eval_batch_size=6, seed=4, train_eval_size=12, augment_flip=True)
    ours = CIFAR10DataModule(str(tmp_path / "ours"), **kw)
    ref = JaxCIFAR10(str(tmp_path / "ref"), **kw)
    assert ours.data_shape() == (32, 32, 3)
    assert (tmp_path / "ours" / "cifar10-train.npy").exists()
    npt.assert_array_equal(ours.train_labels, ref.train_labels)
    npt.assert_array_equal(ours.val_labels, ref.val_labels)
    assert len(ours.eval_splits()["val"]) == 10  # the 90/10 split of 100
    assert_streams_equal(ours, ref, 15)
    assert_eval_equal(ours, ref)
    assert_eval_equal(ours, ref, test=True)
    # a second module reads the cache, not the batches
    (tmp_path / "ours" / "cifar-10-batches-py" / "data_batch_1").unlink()
    again = CIFAR10DataModule(str(tmp_path / "ours"), **kw)
    npt.assert_array_equal(again.eval_splits()["val"], ours.eval_splits()["val"])


def test_cifar10_module_without_data_says_where_to_put_it(tmp_path):
    with pytest.raises(FileNotFoundError, match="cifar-10-python.tar.gz"):
        CIFAR10DataModule(str(tmp_path))
