"""The work counts against hand-worked small shapes."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from bench_h100.lib import flops, manifest, peaks

from tiny import REPO, tiny_config


def test_products_of_a_convolution_and_a_linear():
    x = torch.zeros(2, 8, 10, 10, device="meta")
    w = torch.zeros(16, 8, 3, 3, device="meta")
    assert flops.products(lambda: F.conv2d(x, w, padding=1)) == 2 * 2 * 10 * 10 * 16 * 8 * 9
    a, b = torch.zeros(5, 7, device="meta"), torch.zeros(3, 7, device="meta")
    assert flops.products(lambda: F.linear(a, b)) == 2 * 5 * 7 * 3


def test_scan_work_of_the_tiny_founddiff():
    """dim 8 x (1, 2) at 32^2: SS2Ds at (32^2, D 16, N 4) twice, (16^2, D 16,
    N 8) once and (16^2, D 32, N 8) twice; 9 P D N + P D each."""
    per = lambda P, D, N: 9 * P * D * N + P * D
    want = 2 * per(1024, 16, 4) + per(256, 16, 8) + 2 * per(256, 32, 8)
    _, scan, _ = flops.unet_forward(tiny_config("t", "founddiff"), 1)
    assert scan == want
    _, scan3, _ = flops.unet_forward(tiny_config("t", "founddiff"), 3)
    assert scan3 == 3 * want


def test_unet_products_scale_with_batch_and_vanilla_has_no_scan():
    u1, _, t1 = flops.unet_forward(tiny_config("t", "founddiff"), 1)
    u2, _, t2 = flops.unet_forward(tiny_config("t", "founddiff"), 2)
    assert u2 == 2 * u1 and t2 == 2 * t1 and u1 > 0 and t1 > 0
    v, scan, tower = flops.unet_forward(tiny_config("t", "vanilla"), 1)
    assert v > 0 and scan == 0 and tower == 0


def test_request_and_step_work():
    config = tiny_config("t", "founddiff")
    unet, scan, tower = flops.unet_forward(config, 4)
    request = manifest.module(REPO, "work", "founddiff_request").work(
        config, {"batch": 4})
    assert request == [(tower, peaks.FP32_PRODUCT_FLOPS), (2 * unet, peaks.BF16_FLOPS),
                       (2 * scan, peaks.FP32_FLOPS)]
    unet2, scan2, tower2 = flops.unet_forward(config, 2)
    step = manifest.module(REPO, "work", "train_step").work(config, {})
    assert step == [(2 * (tower2 + 3 * unet2), peaks.FP32_PRODUCT_FLOPS),
                    (2 * 3 * scan2, peaks.FP32_FLOPS)]


def test_least_seconds():
    assert peaks.least_seconds(3.35e12, [(1e12, 1e12)]) == pytest.approx(1.0)
    # two units run at once: the slower sets the time; one unit's work adds up
    assert peaks.least_seconds(0, [(1e12, 1e12), (3e12, 2e12)]) == pytest.approx(1.5)
    assert peaks.least_seconds(0, [(1e12, 1e12), (1e12, 1e12)]) == pytest.approx(2.0)
    assert peaks.peak_seconds([(1e12, 1e12), (3e12, 2e12)]) == pytest.approx(2.5)


def test_ss2d_least_seconds_by_hand():
    ss2d = manifest.module(REPO, "work", "ss2d")
    meta = dict(shape=(1, 4, 4, 2), d_inner=4, d_state=2, dt_rank=1, dtype="float32")
    P, C0, D, N, R = 16, 2, 4, 2, 1
    products = 2 * P * (C0 * 2 * D + D * (R + 2 * N) + R * D + D * C0)
    cores = P * D * (9 * N + 1) + 2 * P * D * 9
    weights = 4 * (C0 * 2 * D + 4 * (R + 2 * N) * D + 4 * D * R + D * C0 + 9 * D) \
        + 4 * (4 * D * N + 8 * D)
    moved = 4 * P * C0 * 3 + weights
    want = max(moved / peaks.HBM_BYTES_PER_S, products / peaks.FP32_PRODUCT_FLOPS,
               cores / peaks.FP32_FLOPS)
    assert ss2d.least_seconds(meta, "forward") == pytest.approx(want)
    back = max((4 * P * C0 * 4 + 2 * weights) / peaks.HBM_BYTES_PER_S,
               2 * products / peaks.FP32_PRODUCT_FLOPS, 2 * cores / peaks.FP32_FLOPS)
    assert ss2d.least_seconds(meta, "backward") == pytest.approx(back)
