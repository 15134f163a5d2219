"""On the card: the control at each cell's own size comes out as not
correct, and the tiny cells run correct through the kernels."""

from __future__ import annotations

import pytest

from bench_h100 import calibrate
from bench_h100.lib import compare, manifest, runner

import tiny

CONTROL = ["fd512-serve-bs4", "vanilla512-train-fp32", "fd512-train-fp32"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CONTROL)
def test_control_at_full_size_is_not_correct(card, cell):
    r = calibrate.reading(tiny.REPO, cell, 424242, 1.0, "cuda", control=True)
    rows = compare.judge(r["numbers"], manifest.checks(tiny.REPO, cell)["limits"])
    assert not all(ok for *_, ok in rows), rows


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-train", "tiny-vanilla-train"])
def test_tiny_cells_on_the_card(card, tmp_path, cell):
    root = tiny.make_root(tmp_path)
    assert runner.run(cell, 99, 0.5, False, root=root, device="cuda")["correct"] is True
