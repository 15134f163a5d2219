"""``FOUNDDIFF_ATTN_BLOCK`` read by the port as the JAX package reads it (CPU).

- ``attn_block_route`` against the JAX one under each value (unset,
  ``auto``, ``on``, ``off``) at the nine MambaBlock shapes of a 512^2 slice
  and at a 16^2 micro shape, where the JAX capability gate holds, so that the
  two routings agree wherever the port's own gate and the JAX one both take
  the shape;
- the port's route as a function of the device and of whether autograd
  records the call: at the 512^2, 360^2 and 16^2 shapes, ``auto`` on a CUDA
  tensor with nothing recorded takes the kernel wherever ``attn_block_ok``
  holds, and keeps the JAX routing on CPU tensors and for recorded calls;
  a ``MambaBlock`` hands the route its device and the gradient decision;
- with ``on``, one micro ``MambaBlock`` at C 64 (below the default's 128)
  against one JAX ``MambaBlock`` with ``scan_impl="pallas_fused"`` under the
  same value (its attention half in interpret mode): both sides are seen
  calling the fused attention half; fp32, rtol 1e-3 / atol 1e-4 as the other
  model tests of the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.models import ss2d as jss2d
from founddiff_tpu.ops import attn_block as jattn
from founddiff_tpu_torch.models import ss2d as tss2d
from founddiff_tpu_torch.ops import attn_block as tattn
from torch_parity import jit_quick, load_port, np_, perturb, t_

RTOL, ATOL = 1e-3, 1e-4
# (H = W, C) of the nine MambaBlocks of Config() at 512^2, and a micro one
SHAPES = [(512, 64), (256, 64), (128, 128), (64, 256), (64, 512), (64, 512), (128, 256),
          (256, 128), (512, 64), (16, 64)]
# the same nine at 360^2: 180, 90 and 45 are no multiples of 8
SHAPES_360 = [(360, 64), (180, 64), (90, 128), (45, 256), (45, 512), (45, 512), (90, 256),
              (180, 128), (360, 64)]
# blocks of a UNet forward on the kernel (512^2 nine, 360^2 nine, the 16^2
# shape) by mode, for (auto on a CUDA tensor recording nothing, otherwise)
ON_KERNEL = {None: ((9, 2, 1), (6, 0, 0)), "auto": ((9, 2, 1), (6, 0, 0)),
             "on": ((9, 2, 1), (9, 2, 1)), "off": ((0, 0, 0), (0, 0, 0))}


def _mode(monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("FOUNDDIFF_ATTN_BLOCK", raising=False)
    else:
        monkeypatch.setenv("FOUNDDIFF_ATTN_BLOCK", mode)


@pytest.mark.parametrize("mode", [None, "auto", "on", "off"])
def test_route_matches_jax(mode, monkeypatch):
    _mode(monkeypatch, mode)
    for H, C in SHAPES:
        assert jattn.attn_block_ok(H, H, C) and tattn.attn_block_ok(H, H, C), (H, C)
        want = jattn.attn_block_route(H, H, C)
        assert tattn.attn_block_route(H, H, C) == want, (mode, H, C)
        assert want == (mode == "on" or (mode != "off" and C >= 128)), (mode, H, C)


@pytest.mark.parametrize("mode", [None, "auto", "on", "off"])
@pytest.mark.parametrize("cuda,grad", [(False, False), (False, True), (True, False),
                                       (True, True)])
def test_route_by_device_and_gradient(mode, cuda, grad, monkeypatch):
    _mode(monkeypatch, mode)
    route = lambda shapes: [tattn.attn_block_route(H, H, C, cuda, grad) for H, C in shapes]
    got = tuple(sum(route(s)) for s in (SHAPES[:9], SHAPES_360, SHAPES[9:]))
    assert got == ON_KERNEL[mode][0 if cuda and not grad else 1], (mode, cuda, grad)
    if not cuda or grad:  # the JAX routing, and the call without the two flags
        for H, C in SHAPES + SHAPES_360:
            want = jattn.attn_block_route(H, H, C)
            assert tattn.attn_block_route(H, H, C, cuda, grad) == want, (mode, H, C)
            assert tattn.attn_block_route(H, H, C) == want, (mode, H, C)


@pytest.mark.parametrize("grad", [False, True])
def test_mamba_block_hands_the_route_its_call(grad, monkeypatch):
    """A C = 64 MambaBlock asks the route with its input's device and with
    whether autograd records the call; on the CPU it keeps the plain
    composition either way."""
    _mode(monkeypatch, None)
    asked, fused = [], []
    route, fn = tattn.attn_block_route, tss2d.attn_block
    monkeypatch.setattr(tss2d, "attn_block_route", lambda *a: asked.append(a) or route(*a))
    monkeypatch.setattr(tss2d, "attn_block", lambda *a, **k: fused.append(1) or fn(*a, **k))
    B, H, C, tdim = 2, 8, 64, 16
    g = torch.Generator().manual_seed(int(grad))
    x, c, t = (torch.randn(B, H, H, C, generator=g), torch.randn(B, 1, 256, generator=g),
               torch.randn(B, tdim, generator=g))
    block = tss2d.MambaBlock(C, 4, time_dim=tdim)
    with torch.set_grad_enabled(grad):
        out = block(x, c, t)
    assert asked == [(H, H, C, False, grad)] and not fused
    assert out.requires_grad == grad and out.shape == x.shape


def test_mamba_block_with_the_kernel_on_below_128(monkeypatch):
    _mode(monkeypatch, "on")
    B, H, W, C, N, tdim = 2, 8, 8, 64, 4, 64
    rng = np.random.default_rng(64)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    c = (rng.standard_normal((B, 1, 256)) * 0.1).astype(np.float32)
    t = rng.standard_normal((B, tdim)).astype(np.float32)
    calls = {}
    for module, key in ((jattn, "jax"), (tss2d, "port")):
        fn = module.attn_block

        def wrapped(*a, fn=fn, key=key, **k):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(module, "attn_block", wrapped)
    jm = jss2d.MambaBlock(hidden_size=C, d_state=N, scan_impl="pallas_fused")
    params = perturb(jit_quick(jm.init)(jax.random.PRNGKey(1), x, c, t)["params"], seed=C)
    want = jit_quick(jm.apply)({"params": params}, *map(jnp.asarray, (x, c, t)))
    port = load_port(tss2d.MambaBlock(C, N, time_dim=tdim), params)
    with torch.no_grad():
        got = port(t_(x), t_(c), t_(t))
    assert calls.get("jax", 0) >= 1 and calls.get("port", 0) == 1
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL)
