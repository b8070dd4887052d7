"""The port's FID machinery (``bsi_torch.metrics``) against the JAX
package's (``bsi_tpu.metrics``) on the same numpy inputs: the statistics
and uint8 conversion bit for bit, the distance within 1e-12 relative, the
InceptionV3 in f64 at the JAX full-graph mirror test's tolerance, the f32
embed within 1e-4 of the features' scale, and the stats files and weights
files read across the packages."""

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import bsi_tpu.metrics as J
import bsi_tpu.metrics.inception as JI
import bsi_torch.metrics as P
import bsi_torch.metrics.inception as PI
from bsi_torch.convert import inception_params_from_jax
from bsi_torch.data import SyntheticDataModule


def rich_params(seed: int) -> dict[str, np.ndarray]:
    """f64 weights of the exact architecture with fan-in-scaled convolutions
    and non-trivial BatchNorm statistics (identity BN would hide a wrong
    fold), in the JAX package's HWIO layout."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, cin, cout, (kh, kw) in PI._conv_specs():
        params[f"{name}.conv.weight"] = rng.normal(0, (cin * kh * kw) ** -0.5, size=(kh, kw, cin, cout))
        params[f"{name}.bn.weight"] = rng.uniform(0.5, 1.5, cout)
        params[f"{name}.bn.bias"] = rng.normal(0, 0.2, cout)
        params[f"{name}.bn.running_mean"] = rng.normal(0, 0.1, cout)
        params[f"{name}.bn.running_var"] = rng.uniform(0.5, 1.5, cout)
    return params


def test_architecture_and_names_are_pt_inception():
    assert PI._conv_specs() == JI._conv_specs()
    names = {name for name in PI.InceptionV3FID().state_dict() if not name.endswith("num_batches_tracked")}
    assert names == set(JI.random_params(0))
    assert {"Conv2d_1a_3x3.conv.weight", "Mixed_5b.branch1x1.bn.running_var",
            "Mixed_7c.branch_pool.conv.weight"} <= names


def test_feature_stats_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(100, 8)).astype(np.float32)
    ours, theirs = P.FeatureStats(8), J.FeatureStats(8)
    for i in range(0, 100, 7):
        # a tensor on the port's side, the array on JAX's
        ours.update(torch.from_numpy(x[i:i + 7]))
        theirs.update(x[i:i + 7])
    assert ours.n == theirs.n == 100
    npt.assert_array_equal(ours.sum, theirs.sum)
    npt.assert_array_equal(ours.cov_sum, theirs.cov_sum)
    for a, b in zip(ours.mean_cov(), theirs.mean_cov()):
        npt.assert_array_equal(a, b)


@pytest.mark.parametrize("dim", [4, 64])
def test_frechet_distance_and_fid_from_stats(dim):
    rng = np.random.default_rng(dim)
    a, b = rng.normal(size=(300, dim)), rng.normal(size=(200, dim)) * 1.3 + 0.2
    pairs = []
    for mod in (P, J):
        pairs.append((mod.FeatureStats(dim), mod.FeatureStats(dim)))
        pairs[-1][0].update(a)
        pairs[-1][1].update(b)
    ours, theirs = P.fid_from_stats(*pairs[0]), J.fid_from_stats(*pairs[1])
    assert abs(ours - theirs) <= 1e-12 * abs(theirs) and theirs > 0.1
    (m1, c1), (m2, c2) = pairs[0][0].mean_cov(), pairs[0][1].mean_cov()
    want = J.frechet_distance(m1, c1, m2, c2)
    assert abs(P.frechet_distance(m1, c1, m2, c2) - want) <= 1e-12 * abs(want)
    assert abs(P.frechet_distance(m1, c1, m1, c1)) < 1e-8


def test_images_to_uint8_bit_for_bit():
    x = np.random.default_rng(1).uniform(-0.5, 1.5, size=(4, 8, 8, 3)).astype(np.float32)
    ours = P.images_to_uint8(x)
    assert ours.dtype == np.uint8
    npt.assert_array_equal(ours, J.images_to_uint8(x))


def _stub_embed(imgs):
    x = np.asarray(imgs, np.float64) / 255.0
    return np.concatenate([x.mean(axis=(1, 2)), x.std(axis=(1, 2))], axis=1)


def test_fid_score_matches_jax_and_resets():
    rng = np.random.default_rng(3)
    real_imgs = rng.integers(0, 256, size=(300, 4, 4, 3), dtype=np.uint8)
    fake_imgs = rng.integers(64, 256, size=(250, 4, 4, 3), dtype=np.uint8)
    scores = []
    for mod in (P, J):
        real = mod.FeatureStats(6)
        real.update(_stub_embed(real_imgs))
        score = mod.FIDScore(_stub_embed, real, block_size=100)
        score.update(fake_imgs)
        scores.append(score)
    npt.assert_array_equal(scores[0].fake_stats.cov_sum, scores[1].fake_stats.cov_sum)
    ours, theirs = scores[0].compute(), scores[1].compute()
    assert abs(ours - theirs) <= 1e-12 * abs(theirs) and ours > 1e-3
    scores[0].reset()
    assert scores[0].fake_stats.n == 0
    scores[0].update(real_imgs)
    assert scores[0].compute() < 1e-9


def test_stats_npz_passes_between_packages(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(50, 5))
    for writer, reader in ((P, J), (J, P)):
        s = writer.FeatureStats(5)
        s.update(x)
        path = tmp_path / f"{writer.__name__}.npz"
        s.save_npz(path)
        with np.load(path) as z:
            assert sorted(z.files) == ["cov_sum", "n", "sum"]
        back = reader.FeatureStats.from_npz(path)
        assert back.n == 50
        npt.assert_array_equal(back.sum, s.sum)
        npt.assert_array_equal(back.cov_sum, s.cov_sum)
    assert P.fid_stats_path("root", "cifar10", "train") == J.fid_stats_path("root", "cifar10", "train")


def test_random_params_are_the_jax_draws():
    ours = P.random_params(0)
    theirs = inception_params_from_jax(J.random_params(0))
    assert set(ours) == set(theirs)
    for key, value in ours.items():
        assert value.dtype == torch.float32
        assert torch.equal(value, theirs[key]), key


@pytest.mark.parametrize("size", [(67, 53), (32, 32)])
def test_inception_f64_matches_jax(size):
    """The whole network (resize, stem, the 11 mixed blocks, the pooling) in
    f64 on the same weights: branch order, strides, paddings, the two FID
    pooling deviations and the BN fold."""
    params = rich_params(0)
    x01 = np.random.default_rng(7).random((2,) + size + (3,))
    want = np.asarray(JI.inception_features({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x01)))
    got = P.inception_features(inception_params_from_jax(params), torch.from_numpy(x01)).numpy()
    assert got.shape == want.shape == (2, 2048) and got.dtype == np.float64
    npt.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_embed_fn_f32_matches_jax_and_restores_tf32_flags():
    params = {k: v.astype(np.float32) for k, v in rich_params(3).items()}
    imgs = np.random.default_rng(11).integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    want = np.asarray(JI.make_embed_fn(params)(imgs))
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = P.make_embed_fn(inception_params_from_jax(params), device="cpu")(imgs)
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert got.dtype == torch.float32 and got.shape == (2, 2048)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_load_params_of_a_pth_and_of_the_jax_npz(tmp_path):
    params = {k: v.astype(np.float32) for k, v in rich_params(5).items()}
    state = inception_params_from_jax(params)
    # the official checkpoint also carries the fc head (dropped) and each
    # BatchNorm's counter (kept: nn.BatchNorm2d loads it, and fills it in
    # where a state dict lacks it, as the .npz's)
    counters = {key.replace("running_mean", "num_batches_tracked"): torch.tensor(0)
                for key in state if key.endswith("running_mean")}
    official = dict(state, **counters, **{"fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008)})
    torch.save(official, tmp_path / "pt_inception-test.pth")
    np.savez(tmp_path / "pt_inception-test.npz", **params)
    from_pth = P.load_params(tmp_path / "pt_inception-test.pth")
    from_npz = P.load_params(tmp_path / "pt_inception-test.npz")
    assert set(from_pth) == set(state) | set(counters) and set(from_npz) == set(state)
    # the JAX package reads the same .pth to the same values
    jax_read = inception_params_from_jax(JI.load_params(tmp_path / "pt_inception-test.pth"))
    for key in state:
        assert torch.equal(from_pth[key], from_npz[key]) and torch.equal(from_pth[key], jax_read[key]), key
    imgs = np.random.default_rng(2).integers(0, 256, size=(2, 24, 24, 3), dtype=np.uint8)
    a = P.make_embed_fn(from_pth, device="cpu")(imgs)
    b = P.make_embed_fn(from_npz, device="cpu")(torch.from_numpy(imgs))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


def test_default_weights_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("BSI_TPU_INCEPTION_WEIGHTS", raising=False)
    assert P.default_weights_path() is None
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "pt_inception-2015-12-05.npz").write_bytes(b"")
    assert P.default_weights_path() == tmp_path.joinpath("data", "pt_inception-2015-12-05.npz").relative_to(tmp_path)
    (tmp_path / "data" / "pt_inception-2015-12-05.pth").write_bytes(b"")
    assert P.default_weights_path().name == "pt_inception-2015-12-05.pth"
    (tmp_path / "w.pth").write_bytes(b"")
    monkeypatch.setenv("BSI_TPU_INCEPTION_WEIGHTS", str(tmp_path / "w.pth"))
    assert P.default_weights_path() == tmp_path / "w.pth"


def test_build_validation_fid(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("BSI_TPU_INCEPTION_WEIGHTS", raising=False)
    warnings = []
    gray = SyntheticDataModule(n_train=8, n_val=4, data_shape=(4, 4, 1))
    assert P.build_validation_fid(gray, stats_root=tmp_path, embed_fn=_stub_embed) == {}
    rgb = SyntheticDataModule(n_train=8, n_val=4, data_shape=(4, 4, 3))
    assert P.build_validation_fid(rgb, stats_root=tmp_path, embed_fn=_stub_embed, warn=warnings.append) == {}
    assert len(warnings) == 3
    real = P.FeatureStats(6)
    real.update(np.random.default_rng(0).normal(size=(10, 6)))
    real.save_npz(P.fid_stats_path(tmp_path, "synthetic", "val"))
    warnings.clear()
    metrics = P.build_validation_fid(rgb, stats_root=tmp_path, embed_fn=_stub_embed, warn=warnings.append)
    assert set(metrics) == {"val"} and metrics["val"].real_stats.n == 10
    assert warnings == ["No precomputed FID statistics for train found.",
                        "No precomputed FID statistics for test found."]
    # statistics but no weights: a warning, no FID
    warnings.clear()
    assert P.build_validation_fid(rgb, stats_root=tmp_path, warn=warnings.append, device="cpu") == {}
    assert "no InceptionV3 weights" in warnings[-1]


def test_reduce_stats_is_the_identity_for_one_process():
    s = P.FeatureStats(3)
    s.update(np.eye(3))
    assert P.fid.reduce_stats_across_processes(s) is s
