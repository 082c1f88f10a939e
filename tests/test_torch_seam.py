"""The seam kernels' plain versions (dip_tpu_torch/ops/hopper_up_conv.py)
against the JAX Pallas kernels (dip_tpu/ops/pallas_up_conv.py), which run
in interpret mode on the CPU, at C = F = 128.

Both sides round the same operands to bf16 and sum in f32, so in f32 mode
they differ only in the order of the f32 sums: max-normalised error 1e-4.
In bf16 mode each result is also rounded to bf16, and two f32 sums that
differ in the last bits can round to neighbouring bf16 values: 1e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from chip_smoke import (AM_SEAMS, FLAGSHIP_SEAMS, FWD_RAGGED, RAGGED_SEAM,  # noqa: E402
                        TOL as CARD_TOL, LIBRARY_SEAMS as CARD_LIBRARY_SEAMS, library_calls,
                        seam_bound)
from dip_tpu_torch.ops import hopper_up_conv as H  # noqa: E402
from dip_tpu_torch.ops import hopper_wgrad as W  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 1e-2}
C = F = 128


@pytest.fixture(scope="module")
def jx():
    """jax and the Pallas seam module, imported here and not at the top so
    that the CUDA test below also runs on a machine without JAX."""
    jax = pytest.importorskip("jax")
    from dip_tpu.ops import pallas_up_conv

    return jax, pallas_up_conv


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def _inputs(h, w, dtype, seed):
    """xp, e, HR cotangent dz as numpy f32 values exactly representable in
    `dtype`, so both packages see identical inputs."""
    rng = np.random.default_rng(seed)
    t = getattr(torch, dtype)

    def snap(a):
        return torch.from_numpy(a.astype(np.float32)).to(t).float().numpy()

    xp = snap(rng.normal(size=(1, h + 2, w + 2, C)))
    e = snap(rng.normal(size=(3, 3, C, 4 * F)) * 0.1)
    dz = snap(rng.normal(size=(1, 2 * h, 2 * w, F)))
    return xp, e, dz


def _jnp(jax, a, dtype):
    return jax.numpy.asarray(a, dtype=getattr(jax.numpy, dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(8, 8), (16, 12)])
def test_plain_versions_match_pallas_kernels(jx, hw, dtype):
    jax, P = jx
    h, w = hw
    xp, e, dz = _inputs(h, w, dtype, seed=h * 31 + w)
    xp_j, e_j = _jnp(jax, xp, dtype), _jnp(jax, e, dtype)
    dzq_j = dz.reshape(1, h, 2, w, 2, F).transpose(0, 1, 3, 2, 4, 5).reshape(1, h, w, 4 * F)
    dzq_j = _jnp(jax, dzq_j, "bfloat16")
    want_z = jax.jit(P._fwd)(xp_j, e_j)
    want_dxp = jax.jit(P._dgrad, static_argnums=(2, 3))(dzq_j, e_j, xp_j.shape, xp_j.dtype)
    want_de = jax.jit(P._wgrad)(xp_j, dzq_j)

    xp_t, e_t = _torch(xp, dtype), _torch(e, dtype)
    dzq_t = H.phase_major(_torch(dz, dtype))
    np.testing.assert_array_equal(dzq_t.float().numpy(),
                                  np.asarray(dzq_j, dtype=np.float32))
    got_z = H.fwd_plain(xp_t, e_t)
    got_dxp = H.dgrad_plain(dzq_t, e_t, xp_t.dtype)
    got_de = H.wgrad_plain(xp_t, dzq_t)
    for name, got, want in (("fwd", got_z, want_z), ("dgrad", got_dxp, want_dxp),
                            ("wgrad", got_de, want_de)):
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype) == f"torch.{want.dtype}", name
        rel = _rel(got.float().numpy(), np.asarray(want, dtype=np.float32))
        assert rel < TOL[dtype], (name, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wgrad_plain_matches_pallas_kernel_off_8(jx, dtype):
    """wgrad_plain against the Pallas _wgrad where C and 4F are off
    multiples of 8 (C = 20, F = 7; N = 2, w off the kernel's 16-pixel
    tile), the shapes at which the Hopper kernel stages synchronously."""
    jax, P = jx
    n, h, w, c, f = 2, 8, 10, 20, 7
    rng = np.random.default_rng(11)
    t = getattr(torch, dtype)
    xp = torch.from_numpy(rng.normal(size=(n, h + 2, w + 2, c)).astype(np.float32)).to(t)
    dzq = torch.from_numpy(rng.normal(size=(n, h, w, 4 * f)).astype(np.float32)).to(torch.bfloat16)
    want = jax.jit(P._wgrad)(_jnp(jax, xp.float().numpy(), dtype),
                             _jnp(jax, dzq.float().numpy(), "bfloat16"))
    got = H.wgrad_plain(xp, dzq)
    assert tuple(got.shape) == want.shape and str(got.dtype) == f"torch.{want.dtype}"
    assert _rel(got.float().numpy(), np.asarray(want, dtype=np.float32)) < TOL[dtype]
    torch.testing.assert_close(H.wgrad(xp, dzq), got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seam", [(2, 8, 10, 20, 7), (1, 5, 19, 24, 12), (2, 7, 9, 5, 3)])
def test_dgrad_plain_matches_pallas_kernel_off_8(jx, seam, dtype):
    """dgrad_plain against the Pallas _dgrad where C or 4F is off a multiple
    of 8 (the Hopper kernel's synchronous staging and scalar epilogue), N = 2,
    and h + 2, w + 2 off the kernel's 8x16 dxp tile; and the wrapper on CPU
    tensors is the plain version."""
    jax, P = jx
    n, h, w, c, f = seam
    rng = np.random.default_rng(sum(seam))
    t = getattr(torch, dtype)
    e = torch.from_numpy(rng.normal(size=(3, 3, c, 4 * f)).astype(np.float32) * 0.1).to(t)
    dzq = torch.from_numpy(rng.normal(size=(n, h, w, 4 * f)).astype(np.float32)).to(torch.bfloat16)
    want = jax.jit(P._dgrad, static_argnums=(2, 3))(
        _jnp(jax, dzq.float().numpy(), "bfloat16"), _jnp(jax, e.float().numpy(), dtype),
        (n, h + 2, w + 2, c), getattr(jax.numpy, dtype))
    got = H.dgrad_plain(dzq, e, t)
    assert tuple(got.shape) == want.shape and str(got.dtype) == f"torch.{want.dtype}"
    assert _rel(got.float().numpy(), np.asarray(want, dtype=np.float32)) < TOL[dtype]
    torch.testing.assert_close(H.dgrad(dzq, e, t), got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(8, 8), (16, 12)])
def test_carry_plain_version_matches_pallas_kernel(jx, hw, dtype):
    """fwd_plain(xp, e, carry) against the Pallas forward with its carry-in
    epilogue (the add in the output dtype), and the wrapper on CPU tensors."""
    jax, P = jx
    h, w = hw
    xp, e, dz = _inputs(h, w, dtype, seed=h * 7 + w)
    carry = dz[:, ::-1].copy()  # any (N,2h,2w,F) values exact in dtype
    want = jax.jit(P._fwd)(_jnp(jax, xp, dtype), _jnp(jax, e, dtype), _jnp(jax, carry, dtype))
    args = (_torch(xp, dtype), _torch(e, dtype), _torch(carry, dtype))
    got = H.fwd_plain(*args)
    torch.testing.assert_close(H.fwd(*args), got, rtol=0, atol=0)
    assert tuple(got.shape) == want.shape and str(got.dtype) == f"torch.{want.dtype}"
    assert _rel(got.float().numpy(), np.asarray(want, dtype=np.float32)) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_carry_autograd_matches_pallas_vjp(jx, dtype):
    """UpConv3x3 with a carry vs jax.vjp of up2_conv3x3_pallas_carry:
    the output, dxp, de, and d(carry) = dz exactly."""
    jax, P = jx
    xp, e, dz = _inputs(8, 8, dtype, seed=9)
    carry = -dz
    z_j, vjp = jax.vjp(P.up2_conv3x3_pallas_carry, _jnp(jax, xp, dtype),
                       _jnp(jax, e, dtype), _jnp(jax, carry, dtype))
    dxp_j, de_j, dc_j = vjp(_jnp(jax, dz, dtype))
    ts = [_torch(a, dtype).requires_grad_() for a in (xp, e, carry)]
    z_t = H.up2_conv3x3_hopper(*ts)
    dxp_t, de_t, dc_t = torch.autograd.grad(z_t, ts, _torch(dz, dtype))
    for name, got, want in (("z", z_t, z_j), ("dxp", dxp_t, dxp_j), ("de", de_t, de_j)):
        assert tuple(got.shape) == want.shape, name
        rel = _rel(got.detach().float().numpy(), np.asarray(want, dtype=np.float32))
        assert rel < TOL[dtype], (name, rel)
    np.testing.assert_array_equal(dc_t.float().numpy(), np.asarray(dc_j, dtype=np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_function_matches_pallas_vjp(jx, dtype):
    """UpConv3x3 (forward kernel, then dz permute + dgrad + wgrad) vs
    jax.vjp of up2_conv3x3_pallas, on CPU tensors (plain versions)."""
    jax, P = jx
    h, w = 8, 8
    xp, e, dz = _inputs(h, w, dtype, seed=5)
    z_j, vjp = jax.vjp(P.up2_conv3x3_pallas, _jnp(jax, xp, dtype), _jnp(jax, e, dtype))
    dxp_j, de_j = vjp(_jnp(jax, dz, dtype))

    xp_t = _torch(xp, dtype).requires_grad_()
    e_t = _torch(e, dtype).requires_grad_()
    z_t = H.up2_conv3x3_hopper(xp_t, e_t)
    dxp_t, de_t = torch.autograd.grad(z_t, (xp_t, e_t), _torch(dz, dtype))
    for name, got, want in (("z", z_t, z_j), ("dxp", dxp_t, dxp_j), ("de", de_t, de_j)):
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype) == f"torch.{want.dtype}", name
        rel = _rel(got.detach().float().numpy(), np.asarray(want, dtype=np.float32))
        assert rel < TOL[dtype], (name, rel)


def test_wrappers_take_plain_versions_on_cpu_only():
    """On CPU tensors the wrappers return the plain result and count no
    launch, with or without a carry; a mix of devices, a wrong dtype or a
    carry that does not match the output raises."""
    xp, e, dz = _inputs(4, 4, "float32", seed=1)
    xp_t, e_t = torch.from_numpy(xp), torch.from_numpy(e)
    H.reset_launches()
    torch.testing.assert_close(H.fwd(xp_t, e_t), H.fwd_plain(xp_t, e_t), rtol=0, atol=0)
    carry = torch.ones(1, 8, 8, F)
    torch.testing.assert_close(H.fwd(xp_t, e_t, carry), H.fwd_plain(xp_t, e_t, carry),
                               rtol=0, atol=0)
    assert H.LAUNCHES == {"fwd": 0, "fwd_carry": 0, "dgrad": 0, "wgrad": 0}
    with pytest.raises(ValueError):
        H.fwd(xp_t, e_t, carry[:, :4])
    with pytest.raises(ValueError):
        H.fwd(xp_t, e_t, carry.to(torch.bfloat16))
    with pytest.raises(TypeError):
        H.fwd(xp_t.double(), e_t)
    with pytest.raises(TypeError):
        H.dgrad(H.phase_major(torch.from_numpy(dz)).float(), e_t, torch.float32)
    with pytest.raises(ValueError):
        H.fwd(xp_t, e_t[:, :, :5])
    with pytest.raises(ValueError):
        H.fwd(xp_t, e_t.to("meta"))


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """The check chip_smoke.py runs in its kernel-parity phase, the
    carry-in forward (K1c) against fwd_plain(..., carry) included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run python3 chip_smoke.py on the card)")
    from chip_smoke import phase_kernel_parity

    stats = phase_kernel_parity(torch.device("cuda", 0))
    assert set(stats) == {"fwd", "fwd_carry", "dgrad", "wgrad"}


# (N, h, w, C, F): C and 4F off multiples of 8, and N = 2; the last also
# with h and w off the 8x16 pixel tile of the Hopper kernels
LIBRARY_SEAMS = [(1, 4, 6, 8, 4), (2, 5, 3, 5, 3), (2, 6, 4, 12, 5), (1, 9, 17, 20, 7)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seam", LIBRARY_SEAMS)
@pytest.mark.parametrize("name", ["fwd", "fwd_carry", "dgrad", "wgrad"])
def test_library_yardsticks_match_plain_versions(name, seam, dtype):
    """chip_smoke.py's library yardsticks (cuDNN's conv + pixel_shuffle, its
    transposed conv and its weight gradient on the card) compute each seam
    kernel's function: against the plain versions on CPU tensors, at the
    tolerance phase 3 holds them to."""
    n, h, w, c, f = seam
    t = getattr(torch, dtype)
    rng = np.random.default_rng(sum(seam))
    xp = torch.from_numpy(rng.normal(size=(n, h + 2, w + 2, c)).astype(np.float32)).to(t)
    e = torch.from_numpy(rng.normal(size=(3, 3, c, 4 * f)).astype(np.float32) * 0.1).to(t)
    dzq = torch.from_numpy(rng.normal(size=(n, h, w, 4 * f)).astype(np.float32)).to(torch.bfloat16)
    carry = torch.from_numpy(rng.normal(size=(n, 2 * h, 2 * w, f)).astype(np.float32)).to(t)
    want = {"fwd": lambda: H.fwd_plain(xp, e), "fwd_carry": lambda: H.fwd_plain(xp, e, carry),
            "dgrad": lambda: H.dgrad_plain(dzq, e, t),
            "wgrad": lambda: H.wgrad_plain(xp, dzq)}[name]()
    got = library_calls(xp, e, dzq, carry, t)[name]()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _rel(got.float().numpy(), want.float().numpy()) < CARD_TOL[t]


def test_seam_bounds_at_the_top_flagship_seam():
    """Phase 3's bounds at (1, 256, 256, 128, 128) bf16: 77.3 GFLOP at 989
    TFLOP/s for every seam kernel, against 85 MB (152 MB with the carry)."""
    for name in ("fwd", "fwd_carry", "dgrad", "wgrad"):
        ms, by = seam_bound(name, 1, 256, 256, 128, 128, torch.bfloat16)
        assert by == "operations" and ms == pytest.approx(77.3e9 / 989e12 * 1e3, rel=1e-3)
    ms, by = seam_bound("fwd", 1, 16, 16, 8, 2, torch.float32)
    assert by == "bytes"


@pytest.mark.parametrize("seam", FLAGSHIP_SEAMS + [RAGGED_SEAM] + FWD_RAGGED + CARD_LIBRARY_SEAMS
                         + AM_SEAMS)
def test_wgrad_split_plan(seam):
    """wgrad_plan, which sizes every K3 launch, at the seams chip_smoke.py
    holds the kernel to: its splits sum the N*h*w pixels once, each split
    in whole 8x16 pixel tiles (tiles_per_split of them but the last, which
    takes the rest); the workspace is one f32 (9, C, 4F) slab a split; the
    plan depends on the shape alone; and at the top flagship seam the grid
    fills at least two waves of the H100's 132 SMs."""
    n, h, w, c, f = seam
    plan = H.wgrad_plan(n, h, w, c, f)
    # each tile's pixels, counted from a mask of the valid pixels
    rows, cols = -(-h // 8), -(-w // 16)
    valid = np.zeros((n, rows * 8, cols * 16), dtype=np.int64)
    valid[:, :h, :w] = 1
    tile_px = valid.reshape(n, rows, 8, cols, 16).sum(axis=(2, 4)).reshape(-1)
    per = plan.tiles_per_split
    assert plan.tiles == tile_px.size
    assert (plan.splits - 1) * per < plan.tiles <= plan.splits * per
    assert plan.pixels == tuple(int(tile_px[i * per:(i + 1) * per].sum())
                                for i in range(plan.splits))
    assert sum(plan.pixels) == n * h * w
    assert plan.workspace == (plan.splits, 9, c, 4 * f)
    assert plan.grid == (-(-c // 64) * -(-4 * f // 128) * 3, plan.splits)
    H.wgrad_plan.cache_clear()
    assert H.wgrad_plan(n, h, w, c, f) == plan
    if seam == FLAGSHIP_SEAMS[-1]:
        assert plan.grid[0] * plan.grid[1] >= 2 * 132


@pytest.mark.parametrize("seam", FLAGSHIP_SEAMS + [RAGGED_SEAM] + FWD_RAGGED + CARD_LIBRARY_SEAMS
                         + AM_SEAMS)
def test_wgrad_plan_is_the_3x3_plan_over_4f_columns(seam):
    """K3's plan is the plan of the kernel it shares with the bf16 K5, over
    the seam's 4F phase columns: every K3 launch is sized as before."""
    n, h, w, c, f = seam
    assert H.wgrad_plan(n, h, w, c, f) == H.wgrad3x3_plan(n, h, w, c, 4 * f)


# the bf16 K5 launches of an inpainting 'kate' step at 512^2, (N, H, W, Ci,
# Co) of g (x is (N, H+2, W+2, Ci)): each of the five scales' stride-1 down
# conv and the 3x3 skip part of its decoder conv; then two ragged ones
KATE_K5 = [(1, r, r, 128, 128) for r in (512, 256, 256, 128, 128, 64, 64, 32, 32, 16)]


@pytest.mark.parametrize("shape", KATE_K5 + [(2, 19, 23, 20, 12), (1, 10, 13, 5, 3)])
def test_wgrad3x3_split_plan(shape):
    """wgrad3x3_plan, which sizes every bf16 K5 launch: its splits sum the
    N*H*W pixels once in whole 8x16 pixel tiles, at most one split for
    every six tiles, on no more blocks than two waves of the H100's 132 SMs
    (one block an SM) and one split's rounding; the workspace is one f32
    (9, Ci, Co rounded up to 4) slab a split."""
    n, h, w, ci, co = shape
    plan = H.wgrad3x3_plan(n, h, w, ci, co)
    tiles = n * -(-h // 8) * -(-w // 16)
    assert plan.tiles == tiles
    assert (plan.splits - 1) * plan.tiles_per_split < tiles <= plan.splits * plan.tiles_per_split
    assert sum(plan.pixels) == n * h * w and len(plan.pixels) == plan.splits
    assert plan.splits <= -(-tiles // 6)
    blocks = -(-ci // 64) * -(-co // 128) * 3
    assert plan.grid == (blocks, plan.splits)
    assert blocks * (plan.splits - 1) < 2 * 132
    assert plan.workspace == (plan.splits, 9, ci, -(-co // 4) * 4)
    if shape == KATE_K5[0]:
        # the top 'kate' shape: 6 block kinds x 44 splits of 47 tiles, 26 MB
        assert (plan.grid, plan.tiles_per_split) == ((6, 44), 47)
        assert 4 * np.prod(plan.workspace) == pytest.approx(26e6, rel=0.01)


@pytest.mark.parametrize("seam", [(1, 8, 16, 16, 8), (2, 7, 9, 5, 3), (1, 12, 10, 20, 7)])
def test_wgrad_plain_is_the_3x3_weight_gradient(seam):
    """The identity that lets one kernel serve K3 and K5: the seam's weight
    gradient is the VALID 3x3 conv weight gradient of xp against the
    phase-major dzq (K5's plain version at halo 0), Co = 4F; C and 4F off 8
    in the second and third case. xp is f32 with bf16-representable values
    and dzq bf16, so wgrad_plain's rounding of its operands changes nothing."""
    n, h, w, c, f = seam
    rng = np.random.default_rng(sum(seam))
    xp = torch.from_numpy(rng.normal(size=(n, h + 2, w + 2, c)).astype(np.float32))
    xp = xp.to(torch.bfloat16).float()
    dzq = torch.from_numpy(rng.normal(size=(n, h, w, 4 * f)).astype(np.float32)).to(torch.bfloat16)
    got = H.wgrad_plain(xp, dzq)
    want = W.wgrad3x3_s1_plain(xp, dzq.float(), halo=0)
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    assert _rel(got.numpy(), want.numpy()) < 1e-6


# the seams chip_smoke.py holds K2 to, and one whose single split fills
# 1.94 waves of two blocks an SM (512 blocks)
@pytest.mark.parametrize("seam", FLAGSHIP_SEAMS + [RAGGED_SEAM] + FWD_RAGGED + CARD_LIBRARY_SEAMS
                         + AM_SEAMS + [(1, 254, 254, 128, 128)])
def test_dgrad_split_plan(seam):
    """dgrad_plan, which sizes every K2 launch, at the seams chip_smoke.py
    holds the kernel to: its splits run the 9 * ceil(4F/64) steps once, in
    order, each split whole 64-column chunks (or, where 4F is one chunk,
    whole kernel rows of three taps) and none shorter than the floor but
    the last; the workspace is one f32 (N, h+2, w+2, C) slab a split, none
    for one split; a grid that fills a wave of two blocks an SM is not
    split; the plan depends on the shape alone; and at the top flagship
    seam it is one split, no workspace, on a grid of two waves."""
    n, h, w, c, f = seam
    plan = H.dgrad_plan(n, h, w, c, f)
    chunks = -(-4 * f // 64)
    assert plan.steps == 9 * chunks
    assert plan.blocks == n * -(-(h + 2) // 8) * -(-(w + 2) // 16) * -(-c // 128)
    per = plan.steps_per_split
    spans = [(s * per, min((s + 1) * per, plan.steps)) for s in range(plan.splits)]
    # every step once, in order, each split non-empty
    assert [t for a, b in spans for t in range(a, b)] == list(range(plan.steps))
    assert all(b > a for a, b in spans)
    # whole chunks, or whole kernel rows where 4F is one chunk (the kernel's
    # entry refuses a run that is not a multiple of 3)
    assert per % (9 if chunks > 1 else 3) == 0
    assert per >= min(H._DG_MIN_STEPS, plan.steps)
    if plan.splits == 1:
        assert plan.workspace is None
    else:
        assert plan.workspace == (plan.splits, n, h + 2, w + 2, c)
        # split only below one wave, and no more than two waves need
        assert plan.blocks < 2 * 132
        assert (plan.splits - 1) * plan.blocks < 2 * 2 * 132
    H.dgrad_plan.cache_clear()
    assert H.dgrad_plan(n, h, w, c, f) == plan
    if seam == FLAGSHIP_SEAMS[-1]:
        assert plan.splits == 1 and plan.workspace is None
        assert plan.blocks >= 2 * 132
