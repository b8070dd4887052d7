"""The port's Downsampled-ImageNet data module against the JAX package's, bit
for bit, on shards in the official ``.npz`` format written under
``tmp_path``: the split, the labels, the eval and test splits, the first
train batches, ``preload`` yes and no, and the port's ``.npy`` row source
against the JAX package's h5 one on unsorted and repeated indices."""

import numpy as np
import numpy.testing as npt
import pytest

from bsi_tpu.data import ImageNetDataModule as JaxImageNet
from bsi_tpu.data.h5source import H5LazySource

from bsi_torch.data import ImageNetDataModule, NpyRowSource
from bsi_torch.data.imagenet import write_synthetic_shards

from test_torch_data import assert_eval_equal, assert_streams_equal

KW = dict(batch_size=8, eval_batch_size=6, seed=4, train_eval_size=12, val_fraction=0.05)


def rows(split) -> np.ndarray:
    """Every row of a split, an array or a lazy source."""
    return split[np.arange(len(split))]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Shards of 32x32 and 64x64 images, 170 train in 2 shards, 9 val."""
    root = tmp_path_factory.mktemp("imagenet")
    for n in (32, 64):
        write_synthetic_shards(root / f"imagenet{n}", n, 170, 9, seed=n)
    return root


def test_the_shards_are_the_official_format(shards):
    with np.load(shards / "imagenet32" / "Imagenet32_train_npz" / "train_data_batch_1.npz") as z:
        assert z["data"].dtype == np.uint8 and z["data"].shape == (85, 3072)
        assert sorted(z.files) == ["data", "labels", "mean"] and 1 <= z["labels"].min() <= z["labels"].max() <= 1000
        first = z["data"][0]
    ours = ImageNetDataModule(str(shards / "imagenet32"), n=32, **KW)
    # channel-planar rows become NHWC: pixel (y, x) of channel c is data[c*1024 + 32*y + x]
    image = np.load(shards / "imagenet32" / "imagenet32-train.npy", mmap_mode="r")[0]
    for c, y, x in ((0, 0, 0), (1, 5, 7), (2, 31, 30)):
        assert image[y, x, c] == first[c * 1024 + 32 * y + x]
    assert ours.data_shape() == (32, 32, 3) and ours.short_name() == "imagenet32"
    assert ours.train_full_labels.dtype == np.int16 and len(ours.train_full_labels) == 170


@pytest.mark.parametrize("n,preload", [(32, True), (32, False), (64, False)])
def test_module_matches_jax_bit_for_bit(shards, n, preload):
    root = str(shards / f"imagenet{n}")
    ours = ImageNetDataModule(root, n=n, preload=preload, **KW)
    ref = JaxImageNet(root, n=n, preload=preload, **KW)
    assert ours.data_shape() == ref.data_shape() == (n, n, 3)
    assert ours.name == ref.name == f"imagenet{n}"
    for name in ("train_full_labels", "train_labels", "val_labels", "test_labels"):
        got, want = getattr(ours, name), getattr(ref, name)
        assert got.dtype == want.dtype == np.int16
        npt.assert_array_equal(got, want)
    assert len(ours.eval_splits()["val"]) == len(ref.eval_splits()["val"]) == 8  # 5 % of 170
    assert len(ours.test_splits()["test"]) == 9  # the official val set
    assert_streams_equal(ours, ref, 25)  # past an epoch of 162
    if preload:
        assert_eval_equal(ours, ref)
        assert_eval_equal(ours, ref, test=True)
        return
    # lazy sources stay lazy, and give the same rows and batches
    for which in ("eval_splits", "test_splits"):
        splits_ours, splits_ref = getattr(ours, which)(), getattr(ref, which)()
        assert list(splits_ours) == list(splits_ref)
        for name in splits_ours:
            assert isinstance(splits_ours[name], NpyRowSource) and isinstance(splits_ref[name], H5LazySource)
            npt.assert_array_equal(rows(splits_ours[name]), rows(splits_ref[name]))
            for (xb, mb), (xw, mw) in zip(ours.eval_batches(splits_ours[name]), ref.eval_batches(splits_ref[name]),
                                          strict=True):
                npt.assert_array_equal(xb, xw)
                npt.assert_array_equal(mb, mw)


def test_preload_yes_and_no_are_the_same(shards):
    root = str(shards / "imagenet32")
    eager, lazy = (ImageNetDataModule(root, n=32, preload=p, **KW) for p in (True, False))
    assert isinstance(eager.eval_splits()["val"], np.ndarray)
    assert_streams_equal(eager, lazy, 25)
    for which in ("eval_splits", "test_splits"):
        for name, split in getattr(eager, which)().items():
            other = getattr(lazy, which)()[name]
            npt.assert_array_equal(split, rows(other))
            for (xb, mb), (xw, mw) in zip(eager.eval_batches(split), lazy.eval_batches(other), strict=True):
                npt.assert_array_equal(xb, xw)
                npt.assert_array_equal(mb, mw)


def test_row_source_matches_the_h5_source(shards):
    root = shards / "imagenet64"
    JaxImageNet(str(root), n=64, preload=False, **KW)  # writes imagenet64.h5
    ImageNetDataModule(str(root), n=64, preload=False, **KW)  # writes the .npy cache
    subset = np.array([3, 150, 7, 99, 42, 0, 169])
    ours = NpyRowSource(root / "imagenet64-train.npy", subset=subset)
    ref = H5LazySource(root / "imagenet64.h5", "train", subset=subset)
    assert ours.shape == ref.shape == (7, 64, 64, 3) and len(ours) == 7 and ours.dtype == ref.dtype == np.uint8
    for idx in ([4, 0, 6, 0, 4, 2], [6, 5, 4, 3, 2, 1, 0], [3, 3, 3], 2, np.array([1])):
        got, want = ours[idx], ref[idx]
        assert got.shape == want.shape and got.flags.c_contiguous
        npt.assert_array_equal(got, want)
    inner = np.array([5, 1, 1, 6])
    npt.assert_array_equal(ours.subset(inner)[[3, 0, 2]], ref.subset(inner)[[3, 0, 2]])
    whole = NpyRowSource(root / "imagenet64-train.npy")
    npt.assert_array_equal(whole[[169, 0, 169]], H5LazySource(root / "imagenet64.h5", "train")[[169, 0, 169]])


def test_the_cache_is_read_once_written(tmp_path):
    write_synthetic_shards(tmp_path, 32, 120, 5, seed=1, n_shards=3)
    first = ImageNetDataModule(str(tmp_path), n=32, **KW)
    assert sorted(p.name for p in tmp_path.glob("*.npy")) == [
        "imagenet32-test-labels.npy", "imagenet32-test.npy", "imagenet32-train-labels.npy", "imagenet32-train.npy"]
    assert not list(tmp_path.glob("*.h5"))  # the JAX package's cache is neither written nor read
    for shard in tmp_path.glob("Imagenet32_*/*.npz"):
        shard.unlink()
    again = ImageNetDataModule(str(tmp_path), n=32, **KW)
    npt.assert_array_equal(again.eval_splits()["val"], first.eval_splits()["val"])
    npt.assert_array_equal(again.train_labels, first.train_labels)


def test_without_shards_it_says_where_to_put_them(tmp_path):
    with pytest.raises(FileNotFoundError, match="train_data_batch_"):
        ImageNetDataModule(str(tmp_path), n=64)
