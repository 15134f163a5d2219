"""``FOUNDDIFF_ATTN_BLOCK`` read by the port as the JAX package reads it (CPU).

- ``attn_block_route`` against the JAX one under each value (unset,
  ``auto``, ``on``, ``off``) at the nine MambaBlock shapes of a 512^2 slice
  and at a 16^2 micro shape, where the JAX capability gate holds, so that the
  two routings agree wherever the port's own gate and the JAX one both take
  the shape;
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
