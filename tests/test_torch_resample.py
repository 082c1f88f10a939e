"""The port's anti-aliased downsampler (dip_tpu_torch/ops/resample.py)
against the JAX package's (dip_tpu/ops/resample.py, and the Pallas kernel
dip_tpu/ops/pallas_resample.py in interpret mode), on the CPU.

Tolerances: the kernel profiles are the same float64 numpy on both sides
(atol 1e-12). The downsample is two f32 banded products on both sides,
summed in another order: atol 2e-5 against inputs in [0, 1), as the JAX
package's own Pallas-vs-XLA test. Its gradient: atol 1e-6, as that test.
The Hopper kernel's blocked algorithm, emulated in torch (its tiles,
channel groups, window staging and the two passes; the CUDA source itself
needs the card): atol 1e-6, since it sums the same f32 terms in the plain
version's tap order.
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


# (K, f, N, C, h_out, w_out): SR x4 and x8 at HR 384x576 (lanczos2), a
# ragged batch at x3, gauss12 at x2, 64 channels at x4, a kernel wider than
# any preset (past two blocks an SM), two far wider that do not fit, the
# 128-channel post-down of a 512^2 Skip's top scale, lanczos3 x4 and x8. The
# ids of the first eight are (K, f, C).
PLAN_CASES = [
    pytest.param(16, 4, 1, 3, 96, 144, id="16-4-3"),
    pytest.param(32, 8, 1, 3, 48, 72, id="32-8-3"),
    pytest.param(12, 3, 2, 3, 23, 14, id="12-3-3"),
    pytest.param(7, 2, 1, 3, 192, 288, id="7-2-3"),
    pytest.param(16, 4, 1, 64, 24, 36, id="16-4-64"),
    pytest.param(96, 8, 1, 3, 48, 72, id="96-8-3"),
    pytest.param(192, 32, 1, 3, 12, 18, id="192-32-3"),
    pytest.param(1000, 250, 1, 1, 2, 2, id="1000-250-1"),
    pytest.param(8, 2, 1, 128, 256, 256, id="8-2-128"),
    pytest.param(24, 4, 1, 3, 96, 144, id="24-4-3"),
    pytest.param(48, 8, 1, 3, 48, 72, id="48-8-3"),
]


def _blocks(n, c, h_out, w_out, tile_h, tile_w, cg):
    return n * -(-h_out // tile_h) * -(-w_out // tile_w) * -(-c // cg)


@pytest.mark.parametrize("ksize,factor,n,c,h_out,w_out", PLAN_CASES)
def test_tile_plan_fits_shared_memory(ksize, factor, n, c, h_out, w_out):
    """The plan's shared memory is csrc/resample.cu's formula and within the
    227 KB a block may opt in to (within half of it, two blocks an SM,
    where any plan is); its grid has at least 132 blocks wherever some plan
    has (SR x4 and x8: 216); up to 4 channels a block takes them all, and
    wide tensors go in groups of 16 or 32 channels where that fills the
    grid (128 channels at 512^2: 8x16 tiles of 16). A window that fits no
    plan raises."""
    if HR.window(4, factor, ksize) ** 2 * 4 > HR.SMEM_MAX:
        with pytest.raises(ValueError, match="does not fit"):
            HR.tile_plan(ksize, factor, n, c, h_out, w_out)
        return
    plan = HR.tile_plan(ksize, factor, n, c, h_out, w_out)
    assert plan.tile_h in HR.TILES and plan.tile_w in HR.TILES and plan.tile_h % HR.ROWS == 0
    assert plan.smem == HR.smem_bytes(plan.tile_h, plan.tile_w, plan.cg, factor, ksize)
    win_w = HR.window(plan.tile_w, factor, ksize)
    assert plan.smem == 4 * (HR.window(plan.tile_h, factor, ksize) * win_w * plan.cg
                             + plan.tile_h * HR.inter_pitch(win_w, plan.cg) + ksize)
    assert plan.smem <= HR.SMEM_MAX
    assert plan.blocks == _blocks(n, c, h_out, w_out, plan.tile_h, plan.tile_w, plan.cg)
    groups = (c,) if c <= 4 else (4, 8, 16, 32)
    if HR.smem_bytes(4, 4, min(c, 4), factor, ksize) <= HR.SMEM_SHARE:
        assert plan.smem <= HR.SMEM_SHARE and plan.cg in groups
        assert plan.blocks >= min(HR.MIN_BLOCKS, _blocks(n, c, h_out, w_out, 4, 4, min(c, 4)))
    else:  # one channel a block is allowed too
        assert plan.cg in groups + (1,)
        assert plan.blocks >= min(HR.MIN_BLOCKS, _blocks(n, c, h_out, w_out, 4, 4, 1))
    if (ksize, factor, c) in ((16, 4, 3), (32, 8, 3)):
        assert plan.blocks >= HR.MIN_BLOCKS
    if c >= 16 and plan.blocks >= HR.MIN_BLOCKS:
        assert plan.cg >= 16  # 64 bytes or more of each pixel
    if c == 128:
        assert (plan.tile_h, plan.tile_w, plan.cg) == (8, 16, 16)
        assert plan.blocks >= HR.MIN_BLOCKS and plan.smem <= HR.SMEM_SHARE
    pitch = HR.inter_pitch(win_w, plan.cg)
    assert pitch >= win_w * plan.cg and (plan.cg >= 32 or pitch % 32 == plan.cg % 32)


def blocked_downsample(x: torch.Tensor, taps: torch.Tensor, factor: int, pad: int,
                       h_out: int, w_out: int) -> torch.Tensor:
    """A pure-torch emulation of csrc/resample.cu's kernel, block by block,
    on its flat shared memory: the block's tile and channel group from its
    index (channel groups fastest), the window staged with clamped rows and
    columns, the taps behind the H pass's rows, then for each row group the
    H pass (kRows rows a thread, each window value read once) into rows of
    the padded pitch, the W pass along them with stride f, and stores
    masked at the ragged edges. NaN marks shared memory never written."""
    n, h, w, c = x.shape
    ksize, f, rows = taps.shape[0], factor, HR.ROWS
    plan = HR.tile_plan(ksize, factor, n, c, h_out, w_out)
    th, tw, cg = plan.tile_h, plan.tile_w, plan.cg
    win_h, win_w = HR.window(th, f, ksize), HR.window(tw, f, ksize)
    run, pitch = win_w * cg, HR.inter_pitch(win_w, cg)
    inter0, taps0 = win_h * run, win_h * run + th * pitch
    tiles_h, tiles_w, groups = -(-h_out // th), -(-w_out // tw), -(-c // cg)
    assert n * tiles_h * tiles_w * groups == plan.blocks
    span = (rows - 1) * f + ksize
    out = torch.full((n, h_out, w_out, c), float("nan"))
    for b in range(n):
        for blk in range(tiles_h * tiles_w * groups):
            grp, tile = blk % groups, blk // groups
            o_r0, o_c0 = tile // tiles_w * th, tile % tiles_w * tw
            c0 = grp * cg
            cn = min(cg, c - c0)
            smem = torch.full((plan.smem // 4,), float("nan"))
            smem[taps0:taps0 + ksize] = taps
            r_in = (o_r0 * f - pad + torch.arange(win_h)).clamp(0, h - 1)
            c_in = (o_c0 * f - pad + torch.arange(win_w)).clamp(0, w - 1)
            col, q = torch.meshgrid(torch.arange(win_w), torch.arange(cn), indexing="ij")
            for row in range(win_h):
                smem[row * run + col * cg + q] = x[b, r_in[row]][c_in][:, c0:c0 + cn]
            k = smem[taps0:taps0 + ksize]
            for g in range(th // rows):
                acc = [torch.zeros(win_w, cn) for _ in range(rows)]
                for m in range(span):
                    v = smem[g * rows * f * run + col * cg + q + m * run]
                    for r in range(rows):
                        if 0 <= m - r * f < ksize:
                            acc[r] = acc[r] + k[m - r * f] * v
                for r in range(rows):
                    smem[inter0 + (g * rows + r) * pitch + col * cg + q] = acc[r]
            t, qt = torch.meshgrid(torch.arange(th), torch.arange(cn), indexing="ij")
            live = o_r0 + torch.arange(th) < h_out
            for gq in range(tw // rows):
                acc = [torch.zeros(th, cn) for _ in range(rows)]
                for m in range(span):
                    v = smem[inter0 + t * pitch + gq * rows * f * cg + qt + m * cg]
                    for r in range(rows):
                        if 0 <= m - r * f < ksize:
                            acc[r] = acc[r] + k[m - r * f] * v
                for r in range(rows):
                    q0 = o_c0 + gq * rows + r
                    if q0 < w_out:
                        out[b, o_r0:o_r0 + th, q0, c0:c0 + cn] = acc[r][live]
    return out


@pytest.mark.parametrize("shape,factor,ktype,phase,preserve",
                         CASES + [((1, 34, 30, 128), 2, "lanczos2", 0.5, True)])
def test_blocked_algorithm_matches_plain_and_pallas(jx, shape, factor, ktype, phase, preserve):
    """The kernel's blocked algorithm (its tiles, channel groups, window
    staging and two passes, emulated in torch) against downsample_plain and
    the Pallas kernel in interpret mode, at atol 1e-6: f32 sums of the same
    terms, taps in the same order as the plain version's banded products."""
    jax, _, JP = jx
    x = np.random.default_rng(sum(shape) + factor).random(shape).astype(np.float32)
    spec = TR._spec(factor, ktype, phase, None, None, None)
    pad, h_out, w_out = TR._geometry(shape, spec, preserve)
    taps = torch.from_numpy(TR._profile(spec)).float()
    got = blocked_downsample(torch.from_numpy(x), taps, factor, pad, h_out, w_out)
    plain = TR.downsample_plain(torch.from_numpy(x), factor, ktype, phase, preserve)
    fused = np.asarray(JP.downsample_fused(jax.numpy.asarray(x), factor, ktype, phase,
                                           preserve, interpret=True))
    assert tuple(got.shape) == tuple(plain.shape) == fused.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), fused, atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """The check chip_smoke.py runs for the downsample kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run python3 chip_smoke.py on the card)")
    from chip_smoke import phase_downsample_parity

    stats = phase_downsample_parity(torch.device("cuda", 0))
    assert stats["max_rel_err"] <= 1e-5
