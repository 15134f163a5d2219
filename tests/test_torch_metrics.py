"""The port's image metrics and FID utilities against the JAX package's:
PSNR, SSIM (the mean, ``full=True``'s cs, the map at the borders) and RMSE
within rtol 1e-5; the Frechet distance within 1e-6 relative; the Dose-CLIP
feature extractor at shared tower weights on 512^2 slices (the
antialiased resize to the tower's resolution) within rtol 1e-4 / atol 1e-5
of the features, and an FID through it within 1e-3 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.ops import metrics as jm
from founddiff_tpu.utils import fid as jfid
from founddiff_tpu_torch.ops import metrics as tm
from founddiff_tpu_torch.utils import fid as tfid
from torch_parity import MICRO_CLIP, jit_quick, load_port, np_, t_
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

RTOL = 1e-5


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.standard_normal(shape).astype(np.float32) * 0.05, 0, 1)
    return a, b.astype(np.float32)


SHAPES = [(1, 16, 16, 1), (2, 24, 20, 1), (1, 64, 64, 3), (3, 12, 12, 2)]


@pytest.mark.parametrize("shape", SHAPES)
def test_psnr_rmse(shape):
    a, b = _pair(0, shape)
    np.testing.assert_allclose(float(tm.compute_psnr(t_(a), t_(b))),
                               float(jm.compute_psnr(jnp.asarray(a), jnp.asarray(b))), rtol=RTOL)
    np.testing.assert_allclose(float(tm.compute_rmse(t_(a), t_(b))),
                               float(jm.compute_rmse(jnp.asarray(a), jnp.asarray(b))), rtol=RTOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_ssim_and_cs(shape, reduction):
    a, b = _pair(1, shape)
    want, want_cs = jm.compute_ssim(jnp.asarray(a), jnp.asarray(b), reduction=reduction,
                                    full=True)
    got, got_cs = tm.compute_ssim(t_(a), t_(b), reduction=reduction, full=True)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    np.testing.assert_allclose(float(got_cs), float(want_cs), rtol=RTOL)
    np.testing.assert_allclose(float(tm.compute_ssim(t_(a), t_(b), reduction=reduction)),
                               float(want), rtol=RTOL)


@pytest.mark.parametrize("shape", [(1, 16, 16, 1), (2, 13, 17, 1)])
def test_ssim_map_at_the_borders(shape):
    """The unreduced map: every pixel, the reflect-padded border rows and
    columns included, within rtol 1e-5 (atol 1e-6 where the map is ~0)."""
    a, b = _pair(2, shape)
    want = np.asarray(jm.compute_ssim(jnp.asarray(a), jnp.asarray(b), reduction="none"))
    got = np_(tm.compute_ssim(t_(a), t_(b), reduction="none"))
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    for edge in (got[:, :5], got[:, -5:], got[:, :, :5], got[:, :, -5:]):
        assert np.isfinite(edge).all()


def test_metrics_of_identical_images():
    a, _ = _pair(3, (1, 16, 16, 1))
    assert float(tm.compute_ssim(t_(a), t_(a))) == pytest.approx(1.0, abs=1e-6)
    assert float(tm.compute_rmse(t_(a), t_(a))) == 0.0
    assert torch.isinf(tm.compute_psnr(t_(a), t_(a)))
    want = jm.slice_metrics(jnp.asarray(a), jnp.asarray(a * 0.9))
    for k, fn in (("psnr", tm.compute_psnr), ("ssim", tm.compute_ssim),
                  ("rmse", tm.compute_rmse)):
        np.testing.assert_allclose(float(fn(t_(a), t_(a * 0.9))), float(want[k]), rtol=RTOL)


@pytest.mark.parametrize("n,d", [(40, 8), (6, 16), (200, 32)])
def test_frechet_distance(n, d):
    """Full-rank and rank-deficient (n < d) covariances, 1e-6 relative."""
    rng = np.random.default_rng(n)
    fa = rng.standard_normal((n, d))
    fb = rng.standard_normal((n, d)) * 1.3 + 0.2
    mu1, s1 = tfid.feature_statistics(fa)
    mu2, s2 = tfid.feature_statistics(fb)
    jmu1, js1 = jfid.feature_statistics(fa)
    np.testing.assert_array_equal(mu1, jmu1)
    np.testing.assert_array_equal(s1, js1)
    want = jfid.frechet_distance(jmu1, js1, mu2, s2)
    assert tfid.frechet_distance(mu1, s1, mu2, s2) == pytest.approx(want, rel=1e-6)
    assert tfid.fid_from_features(fa, fb) == pytest.approx(jfid.fid_from_features(fa, fb),
                                                           rel=1e-6)
    # identical sets: the eps offset alone, -2 eps d
    assert tfid.fid_from_features(fa, fa) == pytest.approx(-2e-6 * d, rel=1e-3)


def test_inception_score():
    probs = np.random.default_rng(5).dirichlet(np.ones(10), size=50)
    np.testing.assert_allclose(tfid.inception_score(probs, splits=5),
                               jfid.inception_score(probs, splits=5), rtol=1e-12)


@pytest.fixture(scope="module")
def towers():
    from founddiff_tpu.models.clip import CLIPIQA as JCLIPIQA
    from founddiff_tpu_torch.models.clip import CLIPIQA as TCLIPIQA

    jt = JCLIPIQA(**dict(MICRO_CLIP))
    params = jit_quick(jt.init)(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)))["params"]
    tt = load_port(TCLIPIQA(**dict(MICRO_CLIP)), params)
    return jt, params, tt


@pytest.mark.parametrize("size", [512, 64, 40])
def test_clip_extractor_against_jax(towers, size):
    """Slices of ``size``^2 through both extractors at shared weights: 512^2
    and 40^2 are resized to the tower's 64^2 (antialiased), 64^2 is not."""
    jt, params, tt = towers
    x = np.random.default_rng(size).random((3, size, size, 1), dtype=np.float32)
    want = jfid.make_clip_extractor(params, jt, batch_size=2)(x)
    got = tfid.make_clip_extractor(tt, batch_size=2)(x)
    assert got.shape == want.shape == (3, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    got_t = tfid.make_clip_extractor(tt, batch_size=2)(torch.from_numpy(x))
    np.testing.assert_array_equal(got_t, got)


def test_resize_is_jax_bilinear():
    """The resize alone: ``F.interpolate(antialias=True)`` against
    ``jax.image.resize(..., "bilinear")``, down (512 -> 224, 512 -> 64) and
    up (40 -> 64)."""
    import torch.nn.functional as F

    for src, dst in ((512, 224), (512, 64), (40, 64)):
        x = np.random.default_rng(src + dst).random((1, src, src, 1), dtype=np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (1, dst, dst, 1), "bilinear"))
        got = F.interpolate(t_(x).permute(0, 3, 1, 2), size=(dst, dst), mode="bilinear",
                            align_corners=False, antialias=True).permute(0, 2, 3, 1)
        np.testing.assert_allclose(np_(got), want, rtol=1e-5, atol=1e-6)


def test_compute_fid_against_jax(towers):
    """compute_fid over the two extractors: two sets of 8 slices, and a set
    against itself (the eps offset alone, -2 eps d)."""
    jt, params, tt = towers
    rng = np.random.default_rng(9)
    x, y = (rng.random((8, 32, 32, 1), dtype=np.float32) for _ in range(2))
    jx, tx = jfid.make_clip_extractor(params, jt), tfid.make_clip_extractor(tt)
    assert tfid.compute_fid(x, y, tx) == pytest.approx(jfid.compute_fid(x, y, jx), rel=1e-3)
    assert tfid.compute_fid(x, x, tx) == pytest.approx(-2e-6 * 64, rel=1e-3)


@pytest.mark.parametrize("n,nrow", [(1, 1), (4, 2), (5, 8)])
def test_image_grid_and_preview_window(n, nrow):
    from founddiff_tpu.utils import images as jimg
    from founddiff_tpu_torch.utils import images as timg

    x = np.random.default_rng(n).random((n, 8, 8, 1), dtype=np.float32)
    np.testing.assert_array_equal(timg.hu_preview_window(x), jimg.hu_preview_window(x))
    np.testing.assert_array_equal(timg.make_grid(x, nrow=nrow), jimg.make_grid(x, nrow=nrow))


@pytest.mark.parametrize("pil", [True, False])
def test_save_image_png_or_npy(tmp_path, monkeypatch, pil):
    """A PNG grid with PIL; ``<path>.npy`` of the same uint8 grid without it."""
    from founddiff_tpu_torch.utils.images import save_image

    if not pil:
        monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    x = np.random.default_rng(0).random((2, 8, 8, 1), dtype=np.float32)
    path = str(tmp_path / "sample-1.png")
    save_image(x, path, nrow=2)
    if pil:
        from PIL import Image

        got = np.asarray(Image.open(path))
    else:
        got = np.load(path + ".npy")
    assert got.shape == (12, 22) and got.dtype == np.uint8


def test_metrics_logger_and_logger(tmp_path):
    import json

    from founddiff_tpu_torch.utils.logger import get_logger
    from founddiff_tpu_torch.utils.metrics_log import MetricsLogger

    m = MetricsLogger(str(tmp_path / "m" / "metrics.jsonl"))
    m.log({"test_psnr": np.float32(30.5)}, step=3)
    m.log({"loss": 0.25})
    m.close()
    recs = [json.loads(line) for line in open(tmp_path / "m" / "metrics.jsonl")]
    assert recs[0]["step"] == 3 and recs[0]["test_psnr"] == 30.5 and "step" not in recs[1]
    log = get_logger(str(tmp_path / "t.log"))
    log.info("(ab dose  0: psnr: 1.0000)")
    get_logger(str(tmp_path / "t.log")).info("again")  # handlers replaced, not doubled
    lines = open(tmp_path / "t.log").read().splitlines()
    assert len(lines) == 2 and lines[0].endswith("] (ab dose  0: psnr: 1.0000)")
