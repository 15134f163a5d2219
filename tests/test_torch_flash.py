"""The port's flash attention (CPU, plain versions) against the JAX package's
Pallas flash attention, run in interpret mode on the CPU as
``tests/test_flash_attention.py`` runs it.

- the forward and its three gradients through the autograd Function against
  ``jax.vjp`` of ``flash_attention`` (the ``custom_vjp`` over the Pallas
  forward and the two backward kernels), at ragged lengths, with the JAX
  blocks at 32 so that several q and k blocks and a masked last k block run;
- each plain version alone against the JAX implementation it stands for:
  ``flash_fwd_plain`` (o and the logsumexp) against ``_flash_fwd_impl``,
  ``flash_bwd_dq_plain`` and ``flash_bwd_dkv_plain`` against
  ``_flash_bwd_impl`` at the forward's own lse;
- large logits (online softmax without overflow);
- ``flash_fwd_plain`` against ``_flash_fwd_impl`` at the lengths where the
  CUDA forward's tiles are cut (its warps take 16 query rows and its tiles
  64 keys): 1, 15, 16, 17, 63 and 65, against JAX blocks of 32.

Inputs from numpy seeds; fp32; rtol 1e-3 / atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.ops.attention_pallas import _flash_bwd_impl, _flash_fwd_impl
from founddiff_tpu.ops.attention_pallas import flash_attention as j_flash
from founddiff_tpu_torch.ops import flash_attention as fa
from torch_parity import np_, t_

RTOL, ATOL = 1e-3, 1e-4
SCALE = 32 ** -0.5


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL,
                               err_msg=err_msg)


def _qkvo(seed, lq, lk, d=32, b=2, h=2, std=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, d)).astype(np.float32) * std
               for n in (lq, lk, lk))
    do = rng.standard_normal((b, h, lq, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("lq,lk,blk", [(64, 64, 32), (100, 60, 32), (96, 72, 32),
                                       (300, 260, 256)])
def test_forward_and_gradients(lq, lk, blk):
    q, k, v, do = _qkvo(lq + lk, lq, lk)
    out_j, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, SCALE, blk_q=blk, blk_k=blk),
                         *map(jnp.asarray, (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    qkv = [t_(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*qkv, SCALE)
    _close(out, out_j, "o")
    out.backward(t_(do))
    for name, a, g in zip("qkv", qkv, grads_j):
        _close(a.grad, g, "d" + name)


@pytest.mark.parametrize("lq,lk", [(100, 60), (40, 130)])
def test_plain_versions_against_the_jax_kernels(lq, lk):
    q, k, v, do = _qkvo(7 * lq + lk, lq, lk)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o_j, lse_blocks = _flash_fwd_impl(jq, jk, jv, SCALE, 32, 32)
    G = q.shape[0] * q.shape[1]
    # row 0 of the 8 sublane copies of each q block
    lse_j = np.asarray(lse_blocks)[:, :, 0, :].reshape(G, -1)[:, :lq]
    o, lse = fa.flash_fwd_plain(t_(q), t_(k), t_(v), SCALE)
    assert lse.shape == (G, lq) and lse.dtype == torch.float32
    _close(o, o_j, "o")
    _close(lse, lse_j, "lse")
    dq_j, dk_j, dv_j = _flash_bwd_impl(jq, jk, jv, o_j, lse_blocks, jdo, SCALE, 32, 32)
    dcap = (t_(do) * o).sum(-1).reshape(G, lq)
    args = (t_(q), t_(k), t_(v), t_(do), lse, dcap, SCALE)
    _close(fa.flash_bwd_dq_plain(*args), dq_j, "dq")
    dk, dv = fa.flash_bwd_dkv_plain(*args)
    _close(dk, dk_j, "dk")
    _close(dv, dv_j, "dv")


@pytest.mark.parametrize("lq,lk", [(1, 1), (15, 17), (16, 16), (17, 63), (63, 65), (65, 1)])
def test_plain_forward_at_the_kernel_tile_edges(lq, lk):
    q, k, v, _ = _qkvo(3 * lq + lk, lq, lk)
    o_j, lse_blocks = _flash_fwd_impl(*map(jnp.asarray, (q, k, v)), SCALE, 32, 32)
    G = q.shape[0] * q.shape[1]
    lse_j = np.asarray(lse_blocks)[:, :, 0, :].reshape(G, -1)[:, :lq]
    o, lse = fa.flash_fwd_plain(t_(q), t_(k), t_(v), SCALE)
    assert o.shape == (2, 2, lq, 32) and lse.shape == (G, lq)
    _close(o, o_j, "o")
    _close(lse, lse_j, "lse")


def test_large_logits_stay_finite():
    q, k, v, _ = _qkvo(1, 64, 64, d=16, b=1, h=1, std=30.0)
    v = v / 30.0
    want = j_flash(*map(jnp.asarray, (q, k, v)), 1.0, blk_q=16, blk_k=16)
    got = fa.flash_attention(t_(q), t_(k), t_(v), 1.0)
    assert torch.isfinite(got).all()
    _close(got, want)


def test_bf16_keeps_the_io_dtype():
    q, k, v, do = _qkvo(2, 48, 40)
    qkv = [t_(a).bfloat16().requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*qkv)
    assert out.dtype == torch.bfloat16
    out.backward(t_(do).bfloat16())
    assert all(a.grad.dtype == torch.bfloat16 for a in qkv)
    want = fa.flash_attention(*(a.detach().float() for a in qkv))
    np.testing.assert_allclose(np_(out), np_(want), rtol=2e-2, atol=2e-2)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    q, k, v, do = (t_(a) for a in _qkvo(3, 32, 32))
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v, SCALE)
    dcap = (do * o).sum(-1).reshape(lse.shape)
    fa.flash_bwd_dq(q, k, v, do, lse, dcap, SCALE)
    fa.flash_bwd_dkv(q, k, v, do, lse, dcap, SCALE)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == before
    torch.testing.assert_close(fa.flash_attention_plain(q, k, v), fa.flash_attention(q, k, v))
