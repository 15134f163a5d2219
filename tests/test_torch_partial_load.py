"""A two-UNet JAX tree that holds only the UNet it calls loads into the port.

flax creates a submodule's parameters at its first call, so a JAX
``UnetRes`` with ``num_unet=2`` and ``test_res_or_noise`` "res" or "noise"
holds only ``unet0`` or ``unet1`` (``founddiff_tpu/models/unet.py:263-270``).
The port builds both; ``load_jax_params`` loads such a tree with the other
UNet left at its init and a warning naming its prefix, and stays strict for
every other key.  The output equals JAX's (fp32; rtol 1e-3 / atol 1e-4).
"""

import pytest
import torch

from founddiff_tpu_torch.factory import init_params
from founddiff_tpu_torch.models.unet import UnetRes
from founddiff_tpu_torch.utils.convert import from_jax_params, load_jax_params
from torch_parity import t_
from test_torch_variants import close, micro_variant


def _kw(which):
    return dict(num_unet=2, objective="pred_res_noise", test_res_or_noise=which)


def _port(which):
    port = UnetRes(8, (1, 2), condition=True, **_kw(which))
    init_params(port, torch.Generator().manual_seed(3))
    return port


@pytest.mark.parametrize("which", ["res", "noise"])
def test_two_unet_tree_without_the_uncalled_unet(which):
    params, want, (x, time, _) = micro_variant(_kw(which), seed=7)
    absent = "unet1" if which == "res" else "unet0"
    assert absent not in params
    port = _port(which)
    before = {k: v.clone() for k, v in port.state_dict().items() if k.startswith(absent)}
    with pytest.raises(RuntimeError):
        port.load_state_dict(from_jax_params(params), strict=True)
    with pytest.warns(UserWarning, match=f"{absent}\\."):
        load_jax_params(port, params)
    for k, v in port.state_dict().items():
        if k.startswith(absent):
            assert torch.equal(v, before[k]), k
    got = port.eval().requires_grad_(False)(t_(x), [t_(t) for t in time])
    live = 0 if which == "res" else 1
    close(got[live], want[live])
    assert got[1 - live] == 0.0 and float(want[1 - live]) == 0.0


def test_load_jax_params_stays_strict_elsewhere():
    params = micro_variant(_kw("res"), seed=8)[0]
    bad = dict(params, unet0={k: v for k, v in params["unet0"].items() if k != "final_conv"})
    with pytest.raises(RuntimeError, match="final_conv"):
        load_jax_params(_port("res"), bad)
    with pytest.raises(RuntimeError):  # a "noise" model needs unet1, which this tree lacks
        load_jax_params(_port("noise"), params)
