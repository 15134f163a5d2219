"""Where the port's diffusion entry points run (CPU).

``GaussianDiffusion`` and ``ResidualDiffusion`` default to the card, as
``factory.build`` does: on a host without one, a constructor given no device
raises rather than sampling on the CPU, and ``build(..., device="cpu")``
hands its device to the diffusion, so an unconditional ``ddim_sample``
(``x_input=None``) draws and returns on the CPU.
"""

import pytest
import torch

from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from founddiff_tpu_torch.diffusion.residual import ResidualDiffusion
from founddiff_tpu_torch.factory import build
from torch_parity import MICRO_CLIP

SIZE = 16


def _model_fn(x, t, s=None):
    return [torch.tanh(x)]


@pytest.mark.parametrize("make", [
    lambda **kw: GaussianDiffusion(_model_fn, image_size=SIZE, channels=1, **kw),
    lambda **kw: ResidualDiffusion(_model_fn, image_size=SIZE, **kw),
], ids=["gaussian", "residual"])
def test_constructor_defaults_to_the_card(make):
    """No device named: the card, or an error on a host without one."""
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert make(device="cpu").device == torch.device("cpu")


def test_build_hands_its_device_to_the_diffusion():
    """An unconditional DDIM-2 sample of a micro FoundDiff built on the CPU:
    its noise and its output lie on the CPU, finite, of the request's shape."""
    cfg = Config()
    cfg.model.dim, cfg.model.dim_mults = 8, (1, 2)
    cfg.model.condition = False
    cfg.diffusion.image_size = SIZE
    diffusion, _ = build(cfg, device="cpu", seed=3, clip_overrides=MICRO_CLIP)
    assert isinstance(diffusion, ResidualDiffusion)
    assert diffusion.device == torch.device("cpu")
    out = diffusion.ddim_sample(None, (2, SIZE, SIZE, 1), sch=diffusion.test_schedule,
                                generator=torch.Generator().manual_seed(0))
    assert len(out) == 1
    img = out[0]
    assert img.device == torch.device("cpu")
    assert img.shape == (2, SIZE, SIZE, 1)
    assert bool(torch.isfinite(img).all())
