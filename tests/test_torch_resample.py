"""The port's anti-aliased downsampler (dip_tpu_torch/ops/resample.py)
against the JAX package's (dip_tpu/ops/resample.py, and the Pallas kernel
dip_tpu/ops/pallas_resample.py in interpret mode), on the CPU.

Tolerances: the kernel profiles are the same float64 numpy on both sides
(atol 1e-12). The downsample is two f32 banded products on both sides,
summed in another order: atol 2e-5 against inputs in [0, 1), as the JAX
package's own Pallas-vs-XLA test. Its gradient: atol 1e-6, as that test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dip_tpu_torch.ops import hopper_resample as HR  # noqa: E402
from dip_tpu_torch.ops import resample as TR  # noqa: E402

# (factor, kernel_type, phase, kernel_width, support, sigma)
KERNELS = [
    (4, "lanczos", 0.5, 17, 2, None),
    (2, "lanczos", 0.5, 9, 2, None),
    (4, "lanczos", 0.0, 17, 2, None),
    (8, "lanczos", 0.5, 49, 3, None),
    (2, "gauss", 0.0, 7, None, 0.5),
    (2, "gauss", 0.0, 9, None, 1 / np.sqrt(2)),
    (2, "box", 0.5, 5, None, None),
    (4, "lanczos2", 0.5, None, None, None),
    (8, "lanczos2", 0.5, None, None, None),
    (4, "lanczos2", 0.0, None, None, None),
    (2, "lanczos3", 0.5, None, None, None),
    (3, "gauss12", 0.0, None, None, None),
    (2, "gauss1sq2", 0.0, None, None, None),
]

# (shape, factor, kernel_type, phase, preserve_size): the three cases of
# tests/test_pallas.py, odd K (phase 0: 4f+1 taps; gauss12: 7), a box,
# preserve_size=False, and a ragged shape (h_out = 23, not a multiple of 8)
CASES = [
    ((2, 64, 64, 3), 4, "lanczos2", 0.5, True),
    ((2, 32, 48, 3), 2, "lanczos2", 0.5, True),
    ((2, 64, 64, 3), 8, "lanczos3", 0.5, True),
    ((1, 32, 40, 3), 4, "lanczos2", 0.0, True),
    ((1, 33, 40, 2), 2, "gauss12", 0.0, True),
    ((1, 64, 64, 3), 4, "lanczos2", 0.5, False),
    ((2, 70, 45, 3), 3, "lanczos2", 0.5, True),
]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from dip_tpu.ops import pallas_resample, resample

    return jax, resample, pallas_resample


@pytest.mark.parametrize("factor,ktype,phase,width,support,sigma", KERNELS)
def test_kernel_construction_matches_jax(jx, factor, ktype, phase, width, support, sigma):
    _, JR, _ = jx
    args = (factor, ktype, phase, width, support, sigma)
    np.testing.assert_allclose(TR.resample_kernel_1d(*args), JR.resample_kernel_1d(*args),
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(TR.resample_kernel_2d(*args), JR.resample_kernel_2d(*args),
                               atol=1e-12, rtol=0)
    k = TR.resample_kernel_1d(*args).astype(np.float32)
    n_in = k.shape[0] + 4 * factor + 3
    n_out = (n_in - k.shape[0]) // factor + 1
    np.testing.assert_array_equal(TR._band_matrix(k, n_in, n_out, factor),
                                  JR._band_matrix(k, n_in, n_out, factor))


@pytest.mark.parametrize("shape,factor,ktype,phase,preserve", CASES)
def test_downsample_matches_jax_and_pallas(jx, shape, factor, ktype, phase, preserve):
    jax, JR, JP = jx
    x = np.random.default_rng(sum(shape) + factor).random(shape).astype(np.float32)
    want = np.asarray(JR.downsample(jax.numpy.asarray(x), factor, ktype, phase, preserve))
    fused = np.asarray(JP.downsample_fused(jax.numpy.asarray(x), factor, ktype, phase,
                                           preserve, interpret=True))
    got = TR.downsample(torch.from_numpy(x), factor, ktype, phase, preserve)
    plain = TR.downsample_plain(torch.from_numpy(x), factor, ktype, phase, preserve)
    assert tuple(got.shape) == want.shape == fused.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), fused, atol=2e-5, rtol=0)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


@pytest.mark.parametrize("shape,factor,ktype,phase,preserve", CASES)
def test_backward_matches_jax_grad(jx, shape, factor, ktype, phase, preserve):
    """The adjoint with the pad's fold against jax.grad of the Pallas
    kernel's custom VJP (XLA's autodiff of the banded products)."""
    jax, _, JP = jx
    rng = np.random.default_rng(7 + factor)
    x = rng.random(shape).astype(np.float32)
    y = TR.downsample(torch.from_numpy(x), factor, ktype, phase, preserve)
    g = rng.normal(size=tuple(y.shape)).astype(np.float32)

    def loss(a):
        return jax.numpy.sum(JP.downsample_fused(a, factor, ktype, phase, preserve,
                                                 interpret=True) * g)

    want = np.asarray(jax.grad(loss)(jax.numpy.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(TR.downsample(xt, factor, ktype, phase, preserve), xt,
                                 torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_constant_image_is_a_fixed_point():
    x = torch.full((1, 32, 32, 3), 0.7)
    y = TR.downsample(x, 4, "lanczos2", 0.5, True)
    assert tuple(y.shape) == (1, 8, 8, 3)
    torch.testing.assert_close(y, torch.full_like(y, 0.7), atol=1e-5, rtol=0)


def test_envelope_and_devices():
    """An empty output raises; the kernel wrapper takes CUDA tensors only
    and counts no launch on a refusal; the CPU path counts none either."""
    with pytest.raises(ValueError, match="empty"):
        TR.downsample(torch.zeros(1, 4, 4, 3), 4, "lanczos2", 0.5, False)
    HR.reset_launches()
    x = torch.rand(1, 32, 32, 3)
    TR.downsample(x, 4)
    taps = torch.from_numpy(TR._profile(TR._spec(4, "lanczos2", 0.5, None, None, None)))
    with pytest.raises(ValueError, match="CUDA"):
        HR.downsample_fused(x, taps, 4, 6, 8, 8)
    with pytest.raises(ValueError):
        TR.downsample(x.to("meta"), 4, "lanczos2", 0.5, True)
    assert HR.LAUNCHES == {"downsample": 0}


@pytest.mark.parametrize("ksize,factor,c", [(16, 4, 3), (32, 8, 3), (12, 3, 3), (7, 2, 3),
                                            (16, 4, 64), (96, 8, 3), (192, 32, 3),
                                            (1000, 250, 1)])
def test_tile_plan_fits_shared_memory(ksize, factor, c):
    """The plan fits the static 48 KiB for kernels far wider than any
    preset makes, and the SR presets (x4, x8) get 8x8 output tiles of all
    three channels."""
    tile, ct, smem = HR.tile_plan(ksize, factor, c)
    assert smem == 4 * (tile * ((tile - 1) * factor + ksize) * ct + ksize) <= HR.SMEM_BUDGET
    assert 1 <= ct <= min(c, 4) and 1 <= tile <= 8
    if (factor, c) in ((4, 3), (8, 3)) and ksize <= 32:
        assert (tile, ct) == (8, 3)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """The check chip_smoke.py runs for the downsample kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run python3 chip_smoke.py on the card)")
    from chip_smoke import phase_downsample_parity

    stats = phase_downsample_parity(torch.device("cuda", 0))
    assert stats["max_rel_err"] <= 1e-5
