"""The precision of the reference's products.

Every product of the reference (convolution, linear map, batched matrix
product) goes through this module.  By default it computes in float32 and
the caller keeps TF32 off.  A control run, which has to come out as not
correct, switches a stretch of the reference to the next precision below
the one the configuration states:

- ``"fp8"``: both operands of each product rounded to float8 e4m3 with one
  scale per tensor (its largest magnitude at 448), the way an fp8 path
  feeds the tensor cores; sums stay float32;
- ``"tf32"``: both operands of each product rounded to TF32 (10 mantissa
  bits, to nearest even), as the tensor cores take them, and cuBLAS and
  cuDNN allowed TF32 for the stretch; the same numbers on a host without a
  card.

Imports nothing but torch.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

MODES = ("fp32", "fp8", "tf32")
# the next precision below each that a configuration states: the control's
BELOW = {"float32": "tf32", "bfloat16": "fp8", "float16": "fp8"}
_MODE = contextvars.ContextVar("reference_products", default="fp32")
FP8_MAX = 448.0


@contextlib.contextmanager
def products(mode: str):
    """Runs the body with the reference's products in ``mode``."""
    if mode not in MODES:
        raise ValueError(f"products: {mode!r} is not one of {MODES}")
    token = _MODE.set(mode)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if mode == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        _MODE.reset(token)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def below(stated: str) -> str:
    """The control's products for a stretch the configuration states at
    ``stated`` (a torch dtype's name)."""
    if stated not in BELOW:
        raise ValueError(f"below: no control for {stated!r}; one of {sorted(BELOW)}")
    return BELOW[stated]


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at one scale per tensor, back in float32."""
    t = t.float()
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32's 10 mantissa bits (to nearest even), in float32."""
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -8192
    return bits.view(torch.float32)


ROUND = {"fp8": fp8_round, "tf32": tf32_round}


def _operand(t: torch.Tensor) -> torch.Tensor:
    """The operand at the stretch's precision; the rounding passes the
    gradient straight through."""
    t = t.float()
    fn = ROUND.get(_MODE.get())
    return t if fn is None else t + (fn(t.detach()) - t.detach())


def linear(x, w, b=None):
    """``x @ w.T + b`` over the last axis."""
    return F.linear(_operand(x), _operand(w), None if b is None else b.float())


def conv(x, w, b=None, stride=1, padding=0, groups=1):
    """2-D convolution of NHWC ``x`` with an ``[O, I/g, kh, kw]`` kernel; NHWC out."""
    y = F.conv2d(_operand(x).permute(0, 3, 1, 2), _operand(w),
                 None if b is None else b.float(), stride=stride, padding=padding,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def matmul(a, b):
    return _operand(a) @ _operand(b)


def einsum(eq: str, a, b):
    return torch.einsum(eq, _operand(a), _operand(b))
