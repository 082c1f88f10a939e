"""The port's downsampler modules, SR losses and colour helpers against the
JAX package's, on the CPU, with the same numpy inputs.

Tolerances: the modules' forward and gradients (with respect to the input
and to the learnable kernel) atol 1e-5: f32 sums in another order, over
inputs in [0, 1), kernels that sum to 1, and cotangents of order one
(a mean's, for the learnable kernel). The losses and colour
conversions are a few f32 operations each: rtol 1e-5 (tv_loss sums 3*H*W
terms: rtol 1e-5; its gradient atol 1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dip_tpu.models.downsampler import Downsampler as FlaxDown  # noqa: E402
from dip_tpu.models.downsampler import LearnableDownsampler as FlaxLearnable  # noqa: E402
from dip_tpu.ops import color as jcolor  # noqa: E402
from dip_tpu.ops import losses as jlosses  # noqa: E402
from dip_tpu.ops import resample as jresample  # noqa: E402
from dip_tpu_torch.models import Downsampler, Identity, LearnableDownsampler  # noqa: E402
from dip_tpu_torch.ops import color as tcolor  # noqa: E402
from dip_tpu_torch.ops import losses as tlosses  # noqa: E402


def _x(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("factor", [2, 4])
def test_downsampler_matches_flax(factor):
    x = _x((1, 32, 24, 3), factor)
    fm = FlaxDown(factor=factor)
    want, vjp = jax.vjp(lambda a: fm.apply({}, a), jnp.asarray(x))
    g = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = Downsampler(factor)(xt)
    (got_dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), atol=1e-5, rtol=0)


@pytest.mark.parametrize("factor", [2, 4])
def test_learnable_downsampler_matches_flax(factor):
    """Forward, and gradients with respect to x and the K x K kernel, for
    the cotangent of a mean over the output (so that the kernel's gradient,
    a sum over every output, is of order one). The flax module's initial
    kernel is resample_kernel_2d by construction; building it here spares
    an eager init that compiles each of the K^2 tap slices."""
    x = _x((1, 32, 24, 3), 10 + factor)
    fm = FlaxLearnable(factor=factor)
    params = {"kernel": jnp.asarray(jresample.resample_kernel_2d(factor, "lanczos2", 0.5),
                                    dtype=jnp.float32)}
    tm = LearnableDownsampler(factor)
    np.testing.assert_array_equal(tm.kernel.detach().numpy(), np.asarray(params["kernel"]))

    @jax.jit
    def fwd_vjp(p, a, g):
        y, vjp = jax.vjp(lambda p, a: fm.apply({"params": p}, a), p, a)
        return y, vjp(g)

    out_shape = (1, 32 // factor, 24 // factor, 3)
    g = (np.random.default_rng(2).normal(size=out_shape) / np.prod(out_shape)).astype(np.float32)
    want, (want_dk, want_dx) = fwd_vjp(params, jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt)
    got_dk, got_dx = torch.autograd.grad(got, (tm.kernel, xt), torch.from_numpy(g))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_dk.numpy(), np.asarray(want_dk["kernel"]), atol=1e-5,
                               rtol=0)
    with torch.no_grad():
        tm.kernel.zero_()
    tm.reset_parameters()
    np.testing.assert_array_equal(tm.kernel.detach().numpy(), np.asarray(params["kernel"]))


def test_identity_passes_through():
    x = torch.rand(1, 4, 4, 3)
    net = Identity()
    net.reset_parameters(torch.Generator())
    assert net(x) is x and not list(net.parameters())


@pytest.mark.parametrize("beta", [0.5, 1.0])
def test_tv_loss_matches_jax(beta):
    """Inputs from a smooth ramp plus noise have no exactly equal
    neighbours, so the beta=0.5 gradient (a square root) is finite."""
    rng = np.random.default_rng(3)
    x = (np.linspace(0, 1, 3 * 12 * 10).reshape(1, 12, 10, 3)
         + rng.random((1, 12, 10, 3)) * 0.1).astype(np.float32)
    want, want_g = jax.value_and_grad(lambda a: jlosses.tv_loss(a, beta))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tlosses.tv_loss(xt, beta)
    (got_g,) = torch.autograd.grad(got, xt)
    assert np.isfinite(got_g.numpy()).all()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-5, rtol=0)


def test_psnr_y_and_colour_match_jax():
    a, b = _x((2, 9, 11, 3), 4), _x((2, 9, 11, 3), 5)
    for crop in (0, 2):
        np.testing.assert_allclose(
            tlosses.psnr_y(torch.from_numpy(a), torch.from_numpy(b), crop).item(),
            float(jlosses.psnr_y(jnp.asarray(a), jnp.asarray(b), crop)), rtol=1e-5)
    np.testing.assert_allclose(tcolor.rgb_to_ycbcr_y(torch.from_numpy(a)).numpy(),
                               np.asarray(jcolor.rgb_to_ycbcr_y(jnp.asarray(a))), rtol=1e-5)
    np.testing.assert_allclose(tcolor.rgb_to_ycbcr(torch.from_numpy(a)).numpy(),
                               np.asarray(jcolor.rgb_to_ycbcr(jnp.asarray(a))), rtol=1e-5)
