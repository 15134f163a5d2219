"""The auxiliary losses of the port (``founddiff_tpu_torch/ops/losses.py``)
and their use in ``ResidualDiffusion.p_losses``, against the JAX package on
the CPU.

- ``sobel``, ``grad_loss``, ``euclidean_dist``, ``bmc_loss`` and
  ``wt_decomp`` (levels 1, 3 and 6 on odd sides, and a power of two) on
  seeded numpy inputs; ``bmc_loss``'s gradient, whose scale takes none;
- ``loss`` with ``aux_grad_loss_weight`` and ``aux_wavelet_loss_weight``
  (each alone and both), with ``t`` and the noise drawn as the JAX loss
  draws them and handed to the port.

fp32; rtol 1e-3 / atol 1e-4, as the other parity tests of the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from founddiff_tpu.diffusion import ResidualDiffusion as JDiffusion
from founddiff_tpu.ops import losses as jl
from founddiff_tpu_torch.diffusion.residual import ResidualDiffusion as TDiffusion
from founddiff_tpu_torch.ops import losses as tl
from torch_parity import jit_quick, np_, t_

RTOL, ATOL = 1e-3, 1e-4
SIZE = 12


def _close(got, want):
    np.testing.assert_allclose(np_(got), np.asarray(want, np.float32), rtol=RTOL, atol=ATOL)


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("name", ["sobel", "grad_loss", "euclidean_dist", "bmc_loss"])
def test_losses_match_jax(name):
    a, b = _pair(1, (3, 9, 11, 2))
    if name == "sobel":
        want, got = jl.sobel(jnp.asarray(a)), tl.sobel(t_(a))
    elif name == "euclidean_dist":
        a2, b2 = a.reshape(3, -1), b.reshape(3, -1) * 0.5
        want, got = jl.euclidean_dist(jnp.asarray(a2), jnp.asarray(b2)), tl.euclidean_dist(
            t_(a2), t_(b2))
    elif name == "grad_loss":
        want, got = jl.grad_loss(jnp.asarray(a), jnp.asarray(b)), tl.grad_loss(t_(a), t_(b))
    else:
        want = jl.bmc_loss(jnp.asarray(a), jnp.asarray(a + 0.3 * b), 0.7)
        got = tl.bmc_loss(t_(a), t_(a + 0.3 * b), 0.7)
    assert got.shape == tuple(np.shape(want))
    _close(got, want)


def test_bmc_loss_gradient():
    """d loss / d (pred, noise_var): the scale 2 * noise_var takes no
    gradient on either side (``stop_gradient`` / ``detach``)."""
    a, b = _pair(2, (4, 6, 6, 1))
    pred, var = a * 0.5, np.float32(0.4)
    jg = jax.grad(lambda p, v: jl.bmc_loss(p, jnp.asarray(b), v), argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(var))
    p_t = t_(pred).requires_grad_(True)
    v_t = torch.tensor(var).requires_grad_(True)
    tl.bmc_loss(p_t, t_(b), v_t).backward()
    _close(p_t.grad, jg[0])
    _close(v_t.grad, jg[1])


@pytest.mark.parametrize("level,shape", [(1, (2, 1, 23, 23)), (3, (2, 1, 23, 29)),
                                         (6, (1, 2, 23, 23)), (3, (2, 1, 32, 32))])
def test_wt_decomp_matches_jax(level, shape):
    x = np.random.default_rng(level).standard_normal(shape).astype(np.float32)
    want = jit_quick(lambda v: jl.wt_decomp(v, level))(jnp.asarray(x))
    got = tl.wt_decomp(t_(x), level)
    for g, w in zip(got, want):
        assert g.shape == w.shape == x.shape
        _close(g, w)
    assert float(np.abs(np.asarray(want[1])).max()) > 0.1  # the high band is live


def test_symmetric_padding_is_numpys():
    """The wavelet padding reflects with the edge, past the axis length too."""
    v = np.arange(5, dtype=np.float32)
    for before, after in ((3, 2), (13, 11), (0, 7)):
        np.testing.assert_array_equal(
            tl._pad_symmetric(torch.from_numpy(v), 0, before, after).numpy(),
            np.pad(v, (before, after), mode="symmetric"))


def _jax_draws(rng, b, shape):
    """``t`` and the noise exactly as ``loss`` and ``p_losses`` draw them."""
    rng, t_rng = jax.random.split(rng)
    t = jax.random.randint(t_rng, (b,), 0, 1000)
    _, noise_rng, _, _ = jax.random.split(rng, 4)
    noise = jax.random.normal(noise_rng, shape, dtype=jnp.float32)
    return torch.from_numpy(np.array(t)).long(), t_(noise)


@pytest.mark.parametrize("grad_w,wave_w", [(0.5, 0.0), (0.0, 0.3), (0.2, 0.7)])
def test_p_losses_with_auxiliary_weights(grad_w, wave_w):
    def model(x_in, time):  # the same closed form on both sides
        a = x_in[..., :1] * 0.7 - x_in[..., 1:2] * 0.2 + time[0][:, None, None, None] * 1e-3
        return [a]

    kw = dict(image_size=SIZE, timesteps=1000, sampling_timesteps=2, loss_type="l2",
              objective="pred_res", condition=True, sum_scale=0.01, test_res_or_noise="res",
              aux_grad_loss_weight=grad_w, aux_wavelet_loss_weight=wave_w)
    jd = JDiffusion(lambda p, x, t, s=None: model(x, t), **kw)
    td = TDiffusion(lambda x, t, s=None: model(x, t), **kw, device="cpu")
    plain = TDiffusion(lambda x, t, s=None: model(x, t),
                       **dict(kw, aux_grad_loss_weight=0.0, aux_wavelet_loss_weight=0.0),
                       device="cpu")
    rng = np.random.default_rng(7)
    imgs = [rng.random((2, SIZE, SIZE, 1)).astype(np.float32) for _ in range(2)]
    key = jax.random.PRNGKey(11)
    want = jd.loss(None, key, [jnp.asarray(i) for i in imgs])
    t, noise = _jax_draws(key, 2, imgs[0].shape)
    got = td.loss([t_(i) for i in imgs], t=t, noise=noise)
    base = plain.loss([t_(i) for i in imgs], t=t, noise=noise)
    assert len(got) == len(want) == 1
    _close(got[0], want[0])
    assert float(got[0]) > float(base[0]) + 1e-4  # the auxiliary terms are added
