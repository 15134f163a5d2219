"""Backward by rematerialisation, as the JAX package's fused kernels do it
(``_sib_bwd``, ``_ab_bwd``, ``_fused_ln_mod_bwd``): the forward ran a kernel,
the backward recomputes a plain composition of the same function under
autograd and differentiates that.

:func:`remat_op` builds such an op once: its ``torch.autograd.Function``
and the dispatch that every kernel wrapper of this protocol shares."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from founddiff_tpu_torch.ops import _cache
from founddiff_tpu_torch.utils import trace


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


def remat_op(name: str, kernel: Callable, plain: Callable, compose: Optional[Callable] = None,
             *, tensors: int) -> Callable:
    """The op ``op(*tensor_args, *static_args)`` of a kernel whose backward
    rematerialises: the first ``tensors`` arguments are tensors (or None),
    the rest the op's non-tensor arguments, in the order ``kernel``,
    ``plain`` and ``compose`` all take them.

    A call that autograd records (:func:`._cache.needs_grad` over the tensor
    arguments) goes through the autograd Function ``name``: its forward runs
    ``kernel`` on CUDA tensors and ``plain`` on CPU tensors and saves the
    tensor arguments, its backward is :func:`remat_grads` through
    ``compose`` (default ``plain``); the two run in the spans
    ``kernel.<name>.forward`` and ``kernel.<name>.backward``, and autograd
    names the node ``<name>Backward``.  Any other call runs ``kernel`` or
    ``plain`` directly, without the Function.  The device is the first
    argument's.  ``op.Function`` is the Function."""
    compose = compose or plain

    def forward(ctx, *args):
        ctx.static = args[tensors:]
        ctx.save_for_backward(*args[:tensors])
        return (kernel if args[0].is_cuda else plain)(*args)

    def backward(ctx, grad):
        static = ctx.static
        grads = remat_grads(lambda *a: compose(*a, *static), ctx.saved_tensors,
                            ctx.needs_input_grad[:tensors], grad)
        return grads + (None,) * len(static)

    fn = type(name, (torch.autograd.Function,), dict(
        __module__=kernel.__module__,
        forward=staticmethod(trace.traced(f"kernel.{name}.forward")(forward)),
        backward=staticmethod(trace.traced(f"kernel.{name}.backward")(backward))))

    def op(*args):
        # grad mode tested first: a direct call then builds no slice
        if torch.is_grad_enabled() and _cache.needs_grad(*args[:tensors]):
            return fn.apply(*args)
        return (kernel if args[0].is_cuda else plain)(*args)

    op.Function = fn
    return op
