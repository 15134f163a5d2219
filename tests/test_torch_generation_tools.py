"""The port's generation datasets and its two result tools (CPU) against the
JAX package.

- ``pad_to_multiple``; ``ImageFolderDataset`` in each condition mode on PNGs
  written here (patches and flips from equal seeds), bit for bit;
  ``data_transform`` / ``inverse_data_transform`` under each option and the
  round trip; ``logit_transform``; the FFHQ 2019 split; the CIFAR10 error
  without ``torchvision``;
- the FID tool: the refusal without weights (a subprocess, rc != 0, the JAX
  message); its JSON on a ``--flax_params`` pickle of a micro tower against
  the JAX script's on the same files and tree (keys equal, ``fid_doseclip``
  within 1e-3 relative); a pickle of JAX arrays refused;
- ``analyze_results``: the report against the JAX tool's, run as a
  subprocess on the same files (1e-4).
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from founddiff_tpu.data import generation as jgen
from founddiff_tpu_torch.data import generation as tgen
from founddiff_tpu_torch.models import clip as clip_mod
from founddiff_tpu_torch.tools import analyze_results, fid_and_inception_score as fid_tool
from torch_parity import MICRO_CLIP, calibrated_micro_clipiqa
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pngs(folder, n, size, seed, mode="RGB"):
    Image = pytest.importorskip("PIL.Image")
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = size
        arr = rng.integers(0, 256, (h, w, 3 if mode == "RGB" else 1), dtype=np.uint8)
        Image.fromarray(arr if mode == "RGB" else arr[..., 0], mode).save(
            os.path.join(folder, f"img{i:03d}.png"))
    return folder


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_pad_to_multiple():
    arr = np.random.default_rng(0).random((13, 21, 3)).astype(np.float32)
    for m in (8, 16):
        _same(tgen.pad_to_multiple(arr, m)[0], jgen.pad_to_multiple(arr, m)[0])
        assert tgen.pad_to_multiple(arr, m)[1] == jgen.pad_to_multiple(arr, m)[1]


@pytest.mark.parametrize("condition", [0, 1, 2])
def test_image_folder_dataset(tmp_path, condition):
    dirs = [_pngs(str(tmp_path / f"d{k}"), 4, (37, 29), seed=k) for k in range(3)]
    folder = dirs[0] if condition == 0 else dirs[:condition + 1]
    kw = dict(image_size=16, condition=condition, augment_flip=True, seed=3)
    port, ref = tgen.ImageFolderDataset(folder, **kw), jgen.ImageFolderDataset(folder, **kw)
    assert len(port) == len(ref) == 4
    for i in range(4):
        _same(port[i], ref[i])
    gray = tgen.ImageFolderDataset(dirs[0], 16, convert_image_to="L", sample=True)
    _same(gray[1], jgen.ImageFolderDataset(dirs[0], 16, convert_image_to="L", sample=True)[1])


class _Cfg:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("opts", [
    dict(rescaled=True), dict(logit_transform=True),
    dict(uniform_dequantization=True, rescaled=True),
    dict(gaussian_dequantization=True, rescaled=True),
    dict(rescaled=True, image_mean=np.full((4, 4, 1), 0.25, np.float32))])
def test_data_transform(opts):
    x = np.random.default_rng(1).random((2, 4, 4, 1)).astype(np.float32)
    cfg = _Cfg(**opts)
    got = tgen.data_transform(cfg, x, np.random.RandomState(5))
    want = jgen.data_transform(cfg, x, np.random.RandomState(5))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tgen.inverse_data_transform(cfg, got),
                               jgen.inverse_data_transform(cfg, want), rtol=1e-6, atol=1e-6)
    if not any(k.endswith("dequantization") for k in opts):  # exact round trip
        np.testing.assert_allclose(tgen.inverse_data_transform(cfg, got), x, atol=1e-5)


def test_ffhq_split_and_cifar_error(tmp_path, monkeypatch):
    _pngs(str(tmp_path / "FFHQ"), 10, (16, 16), seed=9)
    port = tgen.get_generation_dataset("ffhq", str(tmp_path), 16, random_flip=False)
    ref = jgen.get_generation_dataset("ffhq", str(tmp_path), 16, random_flip=False)
    for p, r in zip(port, ref):
        assert p.idx == r.idx and len(p) == len(r)
        _same(p[0], r[0])
    assert (len(port[0]), len(port[1])) == (9, 1)
    monkeypatch.setitem(sys.modules, "torchvision", None)
    with pytest.raises(RuntimeError, match="torchvision unavailable for CIFAR10"):
        tgen.get_generation_dataset("cifar10", str(tmp_path), 32)
    with pytest.raises(ValueError):
        tgen.get_generation_dataset("mnist", str(tmp_path), 32)


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


SIZE, N = 64, 72  # the micro tower's resolution; more slices than its 64 features


@pytest.fixture(scope="module")
def fid_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("fid")
    rng = np.random.default_rng(12)
    dirs = []
    for name, shift in (("gen", 0.1), ("ref", 0.0)):
        d = root / name
        d.mkdir()
        for i in range(N):
            level = rng.random()
            np.save(d / f"s{i:03d}.npy", np.clip(0.6 * level + shift + 0.3
                                                 * rng.random((SIZE, SIZE)), 0, 1)
                    .astype(np.float32))
        dirs.append(str(d))
    slices = np.stack([np.load(os.path.join(dirs[1], f))[..., None]
                       for f in sorted(os.listdir(dirs[1]))[:16]])
    _, jm, params = calibrated_micro_clipiqa(31, slices, SIZE)
    path = str(root / "tower.pkl")
    with open(path, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, params), f)
    return dirs, path, params


def test_fid_refusal(fid_files):
    (gen, ref), _, _ = fid_files
    r = subprocess.run([sys.executable, "-m", "founddiff_tpu_torch.tools.fid_and_inception_score",
                        gen, "--reference_dir", ref, "--device", "cpu"], capture_output=True,
                       text=True, env=_env(), cwd=REPO, timeout=300)
    assert r.returncode != 0 and fid_tool.REFUSAL in r.stderr
    assert fid_tool.REFUSAL == (
        "FID requires pretrained extractor features: pass --clip_weights (torch Dose-CLIP "
        "checkpoint) or --flax_params. Refusing to score with randomly initialized features.")


def test_fid_json_against_jax(fid_files, monkeypatch, capsys):
    """Both scripts build the full-size CLIPIQA; here both build the micro
    tower the pickle holds."""
    import fid_and_inception_score as jfid
    from founddiff_tpu.models import clip as jclip

    (gen, ref), path, _ = fid_files
    monkeypatch.setattr(jclip, "CLIPIQA", lambda base=jclip.CLIPIQA, **kw: base(
        **dict(MICRO_CLIP), **kw))
    monkeypatch.setattr(sys, "argv", ["fid", gen, "--reference_dir", ref, "--flax_params", path])
    jfid.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(clip_mod, "CLIPIQA", lambda base=clip_mod.CLIPIQA, **kw: base(
        **dict(MICRO_CLIP), **kw))
    got = fid_tool.main([gen, "--reference_dir", ref, "--flax_params", path, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == got and set(got) == set(want)
    assert {k: got[k] for k in got if k != "fid_doseclip"} == {
        k: want[k] for k in want if k != "fid_doseclip"}
    assert got["n_generated"] == got["n_reference"] == N
    assert got["fid_doseclip"] > 1e-3
    assert abs(got["fid_doseclip"] - want["fid_doseclip"]) <= 1e-3 * abs(want["fid_doseclip"])


def test_fid_refuses_a_pickle_of_jax_arrays(fid_files, tmp_path):
    (gen, ref), _, params = fid_files
    path = str(tmp_path / "jax.pkl")
    with open(path, "wb") as f:
        pickle.dump({"head1_fc1": {"bias": jax.numpy.zeros(3)}}, f)
    with pytest.raises(SystemExit, match="holds JAX arrays"):
        fid_tool.read_param_pickle(path)


def test_analyze_results_against_jax(tmp_path):
    pred, gt = tmp_path / "pred", tmp_path / "gt"
    pred.mkdir()
    gt.mkdir()
    rng = np.random.default_rng(13)
    names = ["ab-sim-0.50-0.npy", "ab-sim-0.50-1.npy", "ab-sim-0.25-0.npy",
             "lung-quarter_1mm-0.npy", "head-sim-0.10-2.npy"]
    for n in names:
        g = rng.random((32, 32)).astype(np.float32)
        np.save(gt / n, g)
        np.save(pred / n, np.clip(g + 0.05 * rng.standard_normal(g.shape), 0, 1)
                .astype(np.float32))
    np.save(pred / "ab-sim-0.50-9.npy", g)  # no ground truth: skipped
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", "analyze_results.py"),
                        str(pred), str(gt)], capture_output=True, text=True, env=_env(),
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    want = json.loads(r.stdout)
    got = analyze_results.main([str(pred), str(gt), "--device", "cpu",
                                "--export-figs", str(tmp_path / "figs")])
    assert list(got) == list(want) and len(got) == 4
    for k in want:
        assert got[k]["n"] == want[k]["n"]
        for m in ("psnr", "ssim", "rmse"):
            assert abs(got[k][m] - want[k][m]) <= 1e-4, (k, m)
    assert len(os.listdir(tmp_path / "figs")) == len(names)
