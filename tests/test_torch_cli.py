"""``python -m founddiff_tpu_torch`` (``founddiff_tpu_torch.cli``) on the CPU:
the tiny end-to-end run of the verify notes (dim 8 x (1, 2), 16^2 slices,
no tower, ``--debug``): 2 train steps, then test mode from the checkpoint
the run wrote, on each ``--dataset``; and the flags against ``train.py``'s."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from founddiff_tpu_torch import cli
from test_data import _write_tree
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--debug", "--image_size", "16", "--dim", "8", "--dim_mults", "1,2",
         "--no_dose_encoder", "--device", "cpu", "--train_batch_size", "1"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The data tree, then ``--is_train`` for 2 steps in a fresh working
    directory; the trained trainer saves milestone 1."""
    work = tmp_path_factory.mktemp("cli")
    root = str(work / "mayo")
    _write_tree(root, "train512")
    _write_tree(root, "test", n=4)
    rng = np.random.RandomState(3)
    for d in ("sim-0.33", "sim-0.20", "sim-0.12", "sim-0.05"):  # 2020_unseen's doses
        for anat, top in (("ab", "Mayo2020_ab_2d"), ("lung", "Mayo2020_lung_2d"),
                          ("head", "Mayo2020_head_2d_2")):
            p = os.path.join(root, top, "test", d)
            os.makedirs(p)
            for i in range(2):
                np.save(os.path.join(p, f"{anat}-sim-{d.split('-')[1]}-{i}.npy"),
                        (1024 + 200 * rng.randn(16, 16)).astype(np.float32))
    for sub in ("quarter_1mm", "full_1mm"):  # 2016_unseen
        p = os.path.join(root, "Mayo2016_2d", "test", sub)
        os.makedirs(p)
        for i in range(3):
            np.save(os.path.join(p, f"L067-{sub}-{i}.npy"),
                    (1024 + 200 * rng.randn(16, 16)).astype(np.float32))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        trainer = cli.main(["--name", "smoke", "--is_train", "--data_root", root,
                            "--train_num_steps", "2", *SMALL])
        trainer.save(1)
    finally:
        os.chdir(cwd)
    return work, root, trainer


def test_train_mode_writes_log_metrics_and_preview(run):
    work, _, trainer = run
    folder = work / "checkpoints" / "smoke"
    assert trainer.step == 2 and trainer.config.train.checkpoint_folder == "checkpoints/smoke"
    log = (folder / "train.log").read_text()
    assert "step 1/2 loss_unet0: " in log and "training complete" in log
    rec = [json.loads(line) for line in (folder / "metrics.jsonl").read_text().splitlines()]
    assert rec[0]["step"] == 1 and np.isfinite(rec[0]["loss_unet0"])
    # --debug: a preview every 2 steps from the test set
    assert any((folder / "sample" / f).exists() for f in ("sample-1.png", "sample-1.png.npy"))
    assert (folder / "sample" / "model-1.pt").exists()


@pytest.mark.parametrize("dataset,suffix,n", [("2020_seen", "test_final", 32),
                                              ("2020_unseen", "test_final_unseen", 16),
                                              ("2016_unseen", "test_final_2016", 3)])
@pytest.mark.parametrize("source", ["epoch", "torch_checkpoint"])
def test_test_mode_from_the_checkpoint(run, dataset, suffix, n, source, monkeypatch):
    work, root, trainer = run
    monkeypatch.chdir(work)
    ckpt = ["--epoch", "1"] if source == "epoch" else [
        "--torch_checkpoint", str(work / "checkpoints" / "smoke" / "sample" / "model-1.pt")]
    tester = cli.main(["--name", "smoke", "--data_root", root, "--dataset", dataset,
                       *ckpt, *SMALL])
    for k, v in trainer.ema.state_dict().items():  # the trained EMA was loaded
        assert torch.equal(v, tester.ema.state_dict()[k]), k
    out = work / "checkpoints" / "smoke" / f"{suffix}_npy"
    names = sorted(os.listdir(out))
    assert len(names) == n and all(f.endswith(".npy") for f in names)
    assert np.load(out / names[0]).shape == (16, 16)
    lines = (work / "checkpoints" / "smoke" / f"{suffix}.log").read_text().splitlines()
    assert "(ab average mean: psnr: " in lines[0] and "test_psnr: " in lines[-1]


def test_flags_follow_train_py():
    """The same flags and defaults as ``train.py`` less --scan_impl, plus
    --device; the same Config fields from the same argv."""
    import train as jtrain

    argv = ["--name", "x", "--debug", "--dim", "16", "--dim_mults", "1,2,4",
            "--no_dose_encoder", "--sampling_timesteps", "5", "--train_num_steps", "50"]
    jopt, topt = vars(jtrain.parse_args(argv)), vars(cli.parse_args(argv))
    assert set(jopt) - set(topt) == {"scan_impl"}
    assert set(topt) - set(jopt) == {"device"} and topt["device"] == "cuda"
    assert {k: v for k, v in jopt.items() if k in topt} == \
        {k: v for k, v in topt.items() if k in jopt}
    jcfg = jtrain.build_config(jtrain.parse_args(argv))
    tcfg = cli.build_config(cli.parse_args(argv))
    for part in ("model", "diffusion", "train", "data", "mesh"):
        j, t = vars(getattr(jcfg, part)), vars(getattr(tcfg, part))
        assert {k: j[k] for k in t if k in j} == {k: t[k] for k in t if k in j}, part
    with pytest.raises(SystemExit):
        cli.parse_args(argv + ["--scan_impl", "ref"])


def test_module_entry_point_help():
    out = subprocess.run([sys.executable, "-m", "founddiff_tpu_torch", "--help"], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    assert "--device" in out and "--scan_impl" in out and "--mesh_data" in out
    assert "--torch_checkpoint" in out
