"""Backward by rematerialisation, as the JAX package's fused kernels do it
(``_sib_bwd``, ``_ab_bwd``, ``_fused_ln_mod_bwd``): the forward ran a kernel,
the backward recomputes a plain composition of the same function under
autograd and differentiates that."""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def remat_grads(fn: Callable, inputs: Sequence, needs: Sequence[bool], grad_out):
    """Gradients of ``fn(*inputs)`` at cotangent ``grad_out`` for the inputs
    whose ``needs`` flag is set (``None`` for the others, and for an input
    the output does not depend on)."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_(n) if torch.is_tensor(t) else t
                for t, n in zip(inputs, needs)]
        wrt = [a for a, n in zip(args, needs) if n and torch.is_tensor(a)]
        out = fn(*args)
        grads = iter(torch.autograd.grad(out, wrt, grad_out, allow_unused=True)
                     if wrt else ())
    return tuple(next(grads) if n and torch.is_tensor(a) else None
                 for a, n in zip(args, needs))
