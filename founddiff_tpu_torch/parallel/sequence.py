"""Sequence-sharded selective scan over the mesh's 'seq' axis (mirror of
``founddiff_tpu/parallel/sequence.py``).

The sequence axis L of the scan is split over the ranks of a seq group.
Each rank scans its shard from a zero state (the dispatching
:func:`selective_scan`: ``scan_forward``'s kernel on the card, with the
state after the shard's last step, ``h_last``), and summarises it as
``(A_prod, h_end)``, where ``A_prod = exp(A * sum(delta'))`` is the
product of the shard's decay factors.  One all-gather of the two
``[B, K, D, N]`` summaries over the group gives every rank the state
entering its shard (an exclusive fold over the shards before it), and the
correction

    y_t += sum_n C_t[n] * exp(A * cumsum(delta')_t) * h_prefix[n]

is exact, since the recurrence is linear in its initial state: no second
scan.  A second all-gather collects y's shards, so that every rank of the
group holds the whole ``[B, K, L, D]``, as the JAX ``out_specs`` make it.
The correction is plain PyTorch, as it is plain XLA outside any Pallas
kernel in JAX; its ``[B, K, L, D, N]`` fp32 intermediate is computed in
chunks of L (the same math) to bound its memory.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from founddiff_tpu_torch.ops.selective_scan import selective_scan

# elements of the correction's fp32 [B, K, l, D, N] intermediate per chunk of L
CORRECTION_ELEMS = 1 << 26


def local_summary(u, delta, A, Bmat, Cmat, Dskip, delta_bias):
    """One shard's local scan from a zero state and its summary:
    ``(y_local [B,K,L,D], A_prod [B,K,D,N], h_end [B,K,D,N], cum [B,K,L,D])``,
    all fp32; ``cum`` the inclusive ``cumsum(delta')`` over the shard."""
    dl = F.softplus(delta.float() + delta_bias.float()[None, :, None, :])
    y_local, h_end = selective_scan(u, delta, A, Bmat, Cmat, Dskip, delta_bias,
                                    return_last_state=True)
    A_prod = torch.exp(dl.sum(dim=2)[..., None] * A.float()[None])
    return y_local, A_prod, h_end, torch.cumsum(dl, dim=2)


def apply_prefix(y_local, cum, Cmat, A, all_Ap, all_he, index: int,
                 chunk: Optional[int] = None):
    """``y_local`` of shard ``index`` corrected by the state entering it: the
    fold ``h = h * A_prod_i + h_end_i`` over shards ``[0, index)`` of the
    gathered summaries ``all_Ap``, ``all_he`` [n, B, K, D, N], then
    ``y += sum_n C * exp(A * cum) * h`` over chunks of ``chunk`` steps of L
    (by default as many as :data:`CORRECTION_ELEMS` allows)."""
    if index == 0:
        return y_local
    h = torch.zeros_like(all_he[0])
    for i in range(index):
        h = h * all_Ap[i] + all_he[i]
    Bsz, K, L, D = y_local.shape
    N = A.shape[-1]
    step = chunk or max(1, CORRECTION_ELEMS // (Bsz * K * D * N))
    Ak = A.float()[None, :, None]  # [1, K, 1, D, N]
    hk = h[:, :, None]  # [B, K, 1, D, N]
    parts = []
    for l0 in range(0, L, step):
        decay = torch.exp(cum[:, :, l0:l0 + step, :, None] * Ak)
        parts.append(torch.einsum("bkldn,bkln->bkld", decay * hk,
                                  Cmat[:, :, l0:l0 + step].float()))
    return y_local + torch.cat(parts, dim=2)


def seq_sharded_selective_scan(u, delta, A, Bmat, Cmat, Dskip=None, delta_bias=None, *,
                               mesh, axis: str = "seq"):
    """Selective scan with L split over ``mesh`` axis ``axis``; every rank
    of the group passes the whole ``[B, K, L, D]`` operands and gets the
    whole fp32 ``y`` back.  The batch is not split again: where the JAX
    ``shard_map`` splits it over 'data' (``batch_axis``), the port's data
    ranks already hold their own rows.  Shapes as :func:`selective_scan`:
    u, delta [B,K,L,D]; A [K,D,N]; B, C [B,K,L,N]; Dskip, delta_bias [K,D].
    Raises when L does not divide by the axis."""
    Bsz, K, L, D = u.shape
    n = mesh.shape[axis]
    if L % n:
        raise ValueError(f"sequence length {L} does not split over {n} {axis} ranks")
    zeros = lambda: torch.zeros(K, D, device=u.device)
    Dskip = zeros() if Dskip is None else Dskip
    delta_bias = zeros() if delta_bias is None else delta_bias
    Ll = L // n
    index = mesh.index[axis]
    part = slice(index * Ll, (index + 1) * Ll)
    y, A_prod, h_end, cum = local_summary(u[:, :, part], delta[:, :, part], A,
                                          Bmat[:, :, part], Cmat[:, :, part], Dskip, delta_bias)
    summaries = mesh.all_gather(torch.stack([A_prod, h_end]), axis).reshape(n, 2, Bsz, K, D, -1)
    y = apply_prefix(y, cum, Cmat[:, :, part], A, summaries[:, 0], summaries[:, 1], index)
    y = mesh.all_gather(y, axis).reshape(n, Bsz, K, Ll, D).permute(1, 2, 0, 3, 4)
    return y.reshape(Bsz, K, L, D)
