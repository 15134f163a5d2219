"""Seeded weights, made by the benchmark on the device and loaded into both
the system under test and the reference.

One ``torch.rand`` call on the device gives every value; each tensor of the
reference's state dict takes its slice, mapped to its distribution by name:
fan-in uniform for the products, near one for norm scales, the S4D
initialisation of the scan's A and dt, and no layer left an identity (the
adaLN-Zero modulations and the prompt are drawn non-zero).  The tower's
batch-norm statistics are then set from data.
"""

from __future__ import annotations

import math

import torch

NEAR_ONE = (".g", "Ds")
SMALL = ("positional_embedding", "text_projection", "ctx", "token_prefix", "token_suffix")


def _fan_in(name: str, shape) -> int:
    if name.endswith("x_proj_weight"):
        return shape[-1]
    if name.endswith("dt_projs_weight"):
        return shape[-1]
    return max(1, math.prod(shape) // shape[0])


def _fill(name: str, u: torch.Tensor, shape, shapes: dict, final_scale: float) -> torch.Tensor:
    """Maps U[0, 1) draws ``u`` to ``name``'s distribution; every 1-D
    weight is a norm's scale."""
    sym = u * 2 - 1
    if name.endswith("running_mean"):
        return torch.zeros_like(u)
    if name.endswith("running_var"):
        return torch.ones_like(u)
    if name.endswith("logit_scale"):
        return torch.full_like(u, math.log(1 / 0.07))
    if name.endswith("A_logs"):
        n = torch.arange(1, shape[-1] + 1, device=u.device, dtype=torch.float32)
        return (n.log().expand(shape) + 0.1 * sym.reshape(shape)).reshape(-1)
    if name.endswith("dt_projs_bias"):
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).clamp_min(1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    if name.endswith("temperature"):
        return 0.5 + u
    if name.endswith("prompt"):
        return u
    if "adaLN_modulation" in name:  # adaLN-Zero drawn live: std 0.02
        return sym * (0.02 * math.sqrt(3))
    if any(name.endswith(s) for s in NEAR_ONE) or (name.endswith("weight") and len(shape) == 1):
        return 1 + 0.1 * sym
    if any(name.endswith(s) for s in SMALL):
        return 0.02 * sym
    if name.endswith("bias"):
        w = shapes.get(name[: -len("bias")] + "weight")
        if w is None or len(w) < 2:  # a norm's shift
            return 0.1 * sym
        return sym * _fan_in(name, w) ** -0.5
    bound = _fan_in(name, shape) ** -0.5
    if name.endswith("final_conv.weight"):
        bound *= final_scale
    return sym * bound


def make_state(reference: torch.nn.Module, seed: int, device, final_scale: float = 1.0) -> dict:
    """A state dict for ``reference``'s names and shapes, drawn on ``device``
    from ``seed``.  ``final_scale`` scales the last convolution's bound (a
    residual predictor's output is small)."""
    ref = reference.state_dict()
    shapes = {n: tuple(t.shape) for n, t in ref.items()}
    total = sum(math.prod(s) for n, s in shapes.items() if ref[n].is_floating_point())
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if not ref[name].is_floating_point():
            out[name] = ref[name].to(device)
            continue
        n = math.prod(shape)
        out[name] = _fill(name, draws[at:at + n], shape, shapes, final_scale).reshape(shape)
        at += n
    return out


@torch.no_grad()
def calibrate_batch_norms(tower: torch.nn.Module, run) -> None:
    """Each batch norm's running statistics of ``tower`` set to those of
    its input in one pass of ``run()``, layer after layer, as a tower
    trained on such slices would hold them."""

    def set_stats(bn, args):
        flat = args[0].reshape(-1, args[0].shape[-1]).double()
        bn.running_mean.copy_(flat.mean(0))
        bn.running_var.copy_(flat.var(0))

    hooks = [m.register_forward_pre_hook(set_stats) for m in tower.modules()
             if type(m).__name__ == "FrozenBatchNorm"]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
