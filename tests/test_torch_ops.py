"""The port's tensor ops against the JAX package's, in f32 on the CPU, on
the same numpy inputs: atol = rtol = 1e-5 unless a test says otherwise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dip_tpu.ops import dispatch  # noqa: E402
from dip_tpu.ops import losses as jl  # noqa: E402
from dip_tpu.ops import pad as jpad  # noqa: E402
from dip_tpu.ops import resample as jres  # noqa: E402
from dip_tpu.ops import up_conv as jup  # noqa: E402
from dip_tpu.utils import noise as jnoise  # noqa: E402
from dip_tpu_torch.ops import losses as tl  # noqa: E402
from dip_tpu_torch.ops import pad as tpad  # noqa: E402
from dip_tpu_torch.ops import resample as tres  # noqa: E402
from dip_tpu_torch.ops import up_conv as tup  # noqa: E402
from dip_tpu_torch.utils import noise as tnoise  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("mode", ["zero", "reflection", "replication"])
@pytest.mark.parametrize("pad", [1, (2, 1)])
@pytest.mark.parametrize("ndim", [4, 3])
def test_pad2d(mode, pad, ndim):
    shape = (2, 6, 7, 3) if ndim == 4 else (6, 7, 3)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = jpad.pad2d(jnp.asarray(x), pad, mode)
    got = tpad.pad2d(torch.from_numpy(x), pad, mode)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_pad2d_backward_folds_strips():
    """The adjoint of reflection padding (the JAX package's custom VJP)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 5, 6, 2)).astype(np.float32)
    g = rng.normal(size=(1, 7, 8, 2)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jpad.pad2d(a, 1, "reflection") * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (tpad.pad2d(xt, 1, "reflection") * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(_np(xt.grad), _np(want), **TOL)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_upsample(mode):
    x = np.random.default_rng(2).normal(size=(2, 5, 6, 3)).astype(np.float32)
    want = jres.upsample(jnp.asarray(x), 2, mode)
    got = tres.upsample(torch.from_numpy(x), 2, mode)
    assert tuple(got.shape) == want.shape == (2, 10, 12, 3)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_mse_and_psnr():
    rng = np.random.default_rng(3)
    a = rng.random((1, 8, 9, 3)).astype(np.float32)
    b = rng.random((1, 8, 9, 3)).astype(np.float32)
    for fn_j, fn_t in ((jl.mse, tl.mse), (jl.psnr, tl.psnr)):
        np.testing.assert_allclose(_np(fn_t(torch.from_numpy(a), torch.from_numpy(b))),
                                   _np(fn_j(jnp.asarray(a), jnp.asarray(b))), **TOL)
    # identical images hit the 1e-12 floor in both
    np.testing.assert_allclose(_np(tl.psnr(torch.from_numpy(a), torch.from_numpy(a))),
                               _np(jl.psnr(jnp.asarray(a), jnp.asarray(a))), **TOL)


def test_get_noise_meshgrid_exact():
    want = jnoise.get_noise(None, 2, "meshgrid", (5, 7))
    got = tnoise.get_noise(None, 2, "meshgrid", (5, 7), device="cpu")
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("noise_type", ["u", "n"])
def test_get_noise_range_and_moments(noise_type):
    """The two generators differ, so compare by range and moments."""
    var = 0.1
    want = _np(jnoise.get_noise(jax.random.key(0), 8, "noise", (64, 48), noise_type, var))
    got = _np(tnoise.get_noise(torch.Generator().manual_seed(0), 8, "noise", (64, 48),
                               noise_type, var, device="cpu"))
    assert got.shape == want.shape == (1, 64, 48, 8)
    assert got.dtype == want.dtype == np.float32
    if noise_type == "u":
        for a in (got, want):
            assert a.min() >= 0.0 and a.max() < var
        mean, std = var / 2, var / np.sqrt(12)
    else:
        mean, std = 0.0, var
    for a in (got, want):  # 24,576 samples: 3% on the std, 0.02 std on the mean
        assert abs(a.mean() - mean) < 0.02 * std
        assert abs(a.std() - std) < 0.03 * std


@pytest.mark.parametrize("up_mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("hw", [(2, 2), (3, 7), (8, 8)])
def test_up2_moments(up_mode, hw):
    x = np.random.default_rng(sum(hw)).normal(size=(2, *hw, 6)).astype(np.float32)
    wm, wv = jup.up2_moments(jnp.asarray(x), up_mode)
    gm, gv = tup.up2_moments(torch.from_numpy(x), up_mode)
    np.testing.assert_allclose(_np(gm), _np(wm), **TOL)
    np.testing.assert_allclose(_np(gv), _np(wv), **TOL)


@pytest.mark.parametrize("up_mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("pad_mode", ["reflection", "replication"])
@pytest.mark.parametrize("hw", [(2, 2), (3, 5), (8, 8), (5, 2)])
def test_up2_conv3x3(up_mode, pad_mode, hw):
    """C=5, F=4. The JAX side runs the 'dots' seam with bf16 multiplies, so
    both packages round the same operands (x and the effective kernel e) to
    bf16 and sum in f32. The kernel holds multiples of 1/64, so e is exact
    in f32 in both and rounds to the same bf16 values."""
    h, w = hw
    rng = np.random.default_rng(h * 10 + w)
    x = rng.normal(size=(2, h, w, 5)).astype(np.float32)
    k = (rng.integers(-64, 65, size=(3, 3, 5, 4)) / 64).astype(np.float32)
    with dispatch.override(up_conv_impl="dots", dots_f32_bf16mul=True):
        want = jup.up2_conv3x3(jnp.asarray(x), jnp.asarray(k), up_mode, pad_mode)
    got = tup.up2_conv3x3(torch.from_numpy(x), torch.from_numpy(k), up_mode, pad_mode)
    assert tuple(got.shape) == want.shape == (2, 2 * h, 2 * w, 4)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_up2_affine_commutes():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(1, 4, 5, 3)).astype(np.float32))
    s = torch.tensor([1.5, -0.5, 2.0])
    t = torch.tensor([0.1, -0.2, 0.3])
    u = tup.Up2(x, "bilinear").affine(s, t)
    torch.testing.assert_close(tres.upsample(u.x, 2, u.mode),
                               tres.upsample(x, 2, "bilinear") * s + t, **TOL)
