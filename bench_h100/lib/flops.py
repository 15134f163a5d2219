"""Operations of the configuration's equations, counted from its shapes.

The reference model is built on the ``meta`` device (no memory, no data)
and run once under ``torch.utils.flop_counter.FlopCounterMode``, which
counts each convolution and matrix product from its operand shapes (two
operations a multiply-add).  The scan's recurrence is no product: each
SS2D's scan is replaced by a stub that records its shapes, and its work is
counted apart as the recurrence's nine operations per state element and
step plus the skip term (``flops_selective_scan``, src/emamba2.py:38-110).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_h100.lib import build


def reference_on_meta(config: dict):
    """The reference on ``meta`` with every scan stubbed; returns it and the
    list the stubs append ``(B, K, L, D, N)`` to."""
    ref = build.reference(config, "meta")
    scans = []

    def stub(u, delta, A, *rest):
        scans.append(tuple(u.shape) + (A.shape[-1],))
        return torch.zeros_like(u, dtype=torch.float32)

    for m in ref.modules():
        if hasattr(m, "scan"):
            m.scan = stub
    return ref, scans


def products(fn) -> int:
    """Operations of the products that ``fn()`` runs."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def scan_ops(scans) -> int:
    return sum(9 * B * K * L * D * N + B * K * L * D for B, K, L, D, N in scans)


def unet_forward(config: dict, batch: int):
    """(product operations, scan operations) of one UNet forward at ``batch``
    slices, and the tower's product operations on them (0 without one)."""
    size = config["program"]["diffusion"]["image_size"]
    ref, scans = reference_on_meta(config)
    meta = lambda *s: torch.zeros(*s, device="meta")
    if config["family"] == "vanilla":
        return products(lambda: ref(meta(batch, size, size, 1), meta(batch))), 0, 0
    x = meta(batch, size, size, 1)
    tower = products(lambda: ref.encode(x))
    E = ref.unet0.text_mlp[0].in_features
    unet = products(lambda: ref(meta(batch, size, size, 2), meta(batch), meta(batch, E),
                                meta(batch, 1, 256)))
    return unet, scan_ops(scans), tower
