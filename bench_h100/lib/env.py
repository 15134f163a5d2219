"""The run's environment: caches at fixed paths inside the checkout, TF32
off, and the look for modules that must not be loaded."""

from __future__ import annotations

import os
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "founddiff_tpu")


def set_caches(root: str) -> None:
    """Triton's and torch's extension caches at fixed directories inside the
    checkout (the port builds its kernels under ``founddiff_tpu_torch/_build``,
    also inside it), so that only a checkout's first run builds.  Called
    before torch is imported."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")


def fp32_means_fp32() -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is, whole, one of ``FORBIDDEN``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """``name, power.limit`` of the cards as nvidia-smi reads them, or why not."""
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({type(e).__name__})"
    return done.stdout.strip().replace("\n", "; ") or f"not read (rc {done.returncode})"
