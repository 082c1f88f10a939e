"""The convolution weight gradients (dip_tpu_torch/ops/hopper_wgrad.py)
against the JAX package: the plain versions against the Pallas kernels of
dip_tpu/ops/pallas_wgrad.py (interpret mode on the CPU), the reflect-padded
3x3 conv's whole weight gradient against jax.grad of the flax Conv, and
the port's Conv with its weight gradients routed through the kernels'
autograd.Functions against the same Conv on cuDNN's (here ATen's) own.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dip_tpu_torch.models.blocks import Conv  # noqa: E402
from dip_tpu_torch.models.skip import Skip  # noqa: E402
from dip_tpu_torch.ops import hopper_wgrad as W  # noqa: E402
from dip_tpu_torch.ops.pad import pad2d  # noqa: E402


@pytest.fixture(scope="module")
def jx():
    """jax and the Pallas weight-gradient module, imported here and not at
    the top so that the CUDA test below also runs on a machine without JAX."""
    jax = pytest.importorskip("jax")
    from dip_tpu.ops import pallas_wgrad

    return jax, pallas_wgrad


def _pallas(fn, *args):
    """Run a Pallas TPU kernel in interpret mode, as tests/test_pallas_wgrad.py does."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return fn(*args)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("h,w,ci,co", [(16, 24, 8, 16), (32, 16, 4, 8)])
def test_wgrad3x3_plain_matches_pallas(jx, h, w, ci, co):
    jax, pw = jx
    x, g = _normal((1, h, w, ci), 0), _normal((1, h, w, co), 1)
    want = _pallas(pw.wgrad3x3_s1, jax.numpy.asarray(x[0]), jax.numpy.asarray(g[0]))
    got = W.wgrad3x3_s1_plain(torch.from_numpy(x), torch.from_numpy(g), halo=1)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,w,ci,co", [(16, 24, 8, 16), (8, 10, 20, 12)])
def test_wgrad3x3_plain_halo0_matches_pallas(jx, h, w, ci, co, dtype):
    """The plain version with halo=0 on the zero-padded x (the operands of
    the bf16 kernel, which takes x padded) against the Pallas kernel on the
    unpadded x, in both dtypes; Ci and Co off 8 in the second case."""
    jax, pw = jx
    jnp = jax.numpy
    t = getattr(torch, dtype)
    x = torch.from_numpy(_normal((1, h, w, ci), 14)).to(t)
    g = torch.from_numpy(_normal((1, h, w, co), 15)).to(t)
    want = _pallas(pw.wgrad3x3_s1, jnp.asarray(x[0].float().numpy(), getattr(jnp, dtype)),
                   jnp.asarray(g[0].float().numpy(), getattr(jnp, dtype)))
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    got = W.wgrad3x3_s1_plain(xp, g, halo=0)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert _max_rel(got.numpy(), want) < {"float32": 2e-4, "bfloat16": 1e-3}[dtype]
    torch.testing.assert_close(got, W.wgrad3x3_s1_plain(x, g, halo=1), rtol=0, atol=0)


def test_wgrad1x1_plain_matches_pallas(jx):
    jax, pw = jx
    x, g = _normal((1, 32, 32, 8), 2), _normal((1, 32, 32, 16), 3)
    want = _pallas(pw.wgrad1x1, jax.numpy.asarray(x[0]), jax.numpy.asarray(g[0]))
    got = W.wgrad1x1_plain(torch.from_numpy(x), torch.from_numpy(g))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("pad", ["reflection", "replication"])
def test_prepadded_conv_matches_flax_conv_grad(jx, pad):
    """The port pads first and takes the whole weight gradient from one
    halo-0 launch. The JAX package splits it (a zero-pad conv's gradient
    plus the border strips' corrections by XLA autodiff); the sum must be
    the same. Against jax.grad of the flax Conv: halo 0 on the padded
    input, and the port's Conv with conv_wgrad='all' (dW, bias and dx)."""
    jax, _ = jx
    jnp = jax.numpy
    from dip_tpu.models.blocks import Conv as FlaxConv
    from dip_tpu_torch import interop

    x, ct = _normal((2, 12, 10, 8), 4), _normal((2, 12, 10, 16), 5)
    fconv = FlaxConv(16, 3, pad=pad)
    params = fconv.init(jax.random.key(0), jnp.asarray(x))["params"]

    def loss(p, xx):
        return jnp.sum(fconv.apply({"params": p}, xx) * jnp.asarray(ct))

    gp, gx = jax.grad(loss, (0, 1))(params, jnp.asarray(x))
    want_k = np.asarray(gp["Conv_0"]["kernel"])  # HWIO

    dw = W.wgrad3x3_s1(pad2d(torch.from_numpy(x), 1, pad), torch.from_numpy(ct), halo=0)
    assert _max_rel(dw.numpy(), want_k) < 1e-5

    conv = Conv(8, 16, 3, pad=pad)
    sd = interop.flax_to_state_dict({"Conv_0": jax.tree_util.tree_map(np.asarray, params)})
    conv.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()})
    xt = torch.from_numpy(x).requires_grad_()
    (conv(xt, conv_wgrad="all") * torch.from_numpy(ct)).sum().backward()
    assert _max_rel(conv.weight.grad.permute(2, 3, 1, 0).numpy(), want_k) < 1e-5
    assert _max_rel(conv.bias.grad.numpy(), np.asarray(gp["Conv_0"]["bias"])) < 1e-5
    assert _max_rel(xt.grad.numpy(), np.asarray(gx)) < 1e-5


# (in_channels, features, kernel_size, stride, pad, downsample_mode, parts,
# folded affine) -> (3x3, 1x1) kernel-wrapper calls in one backward
CONV_CASES = {
    "3x3 zero pad": ((8, 16, 3, 1, "zero", "stride", 1, False), (1, 0)),
    "3x3 reflection": ((8, 16, 3, 1, "reflection", "stride", 1, False), (1, 0)),
    "3x3 replication, folded BN": ((8, 16, 3, 1, "replication", "stride", 1, True), (1, 0)),
    "3x3 reflection, two parts": ((12, 16, 3, 1, "reflection", "stride", 2, False), (2, 0)),
    "1x1": ((8, 5, 1, 1, "zero", "stride", 1, False), (0, 1)),
    "1x1, two parts, folded BN": ((12, 4, 1, 1, "reflection", "stride", 2, True), (0, 2)),
    "3x3 stride 2, avg post-down": ((8, 16, 3, 2, "reflection", "avg", 1, False), (1, 0)),
    "1x1 stride 2, max post-down": ((8, 16, 1, 2, "zero", "max", 1, False), (0, 1)),
    "3x3 stride 2 (cuDNN)": ((8, 16, 3, 2, "reflection", "stride", 1, False), (0, 0)),
    "5x5 (cuDNN)": ((8, 16, 5, 1, "reflection", "stride", 1, False), (0, 0)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_gradients_with_kernel_wgrad_match_off(case, monkeypatch):
    """Conv with conv_wgrad='all' against 'off', same weights, f32: the
    output exactly, every gradient within 1e-5 of its largest value; the
    stride-1 3x3 and the 1x1 convs (a post-down conv runs at stride 1)
    reach the wrappers once per part, the others never."""
    (cin, feat, ks, stride, pad, dmode, parts, folded), want_calls = CONV_CASES[case]
    calls = {"3x3": 0, "1x1": 0}
    w3, w1 = W.wgrad3x3_s1, W.wgrad1x1

    def count3(x, g, halo=1):
        calls["3x3"] += 1
        return w3(x, g, halo)

    def count1(x, g):
        calls["1x1"] += 1
        return w1(x, g)

    monkeypatch.setattr(W, "wgrad3x3_s1", count3)
    monkeypatch.setattr(W, "wgrad1x1", count1)
    rng = np.random.default_rng(6)
    split = [cin // parts] * parts
    xs = [torch.from_numpy(rng.normal(size=(1, 16, 12, c)).astype(np.float32)) for c in split]
    scale = torch.from_numpy(rng.random(cin).astype(np.float32) + 0.5) if folded else None
    shift = torch.from_numpy(rng.normal(size=cin).astype(np.float32)) if folded else None
    results = {}
    for mode in ("off", "all"):
        conv = Conv(cin, feat, ks, stride, pad=pad, downsample_mode=dmode)
        conv.reset_parameters(torch.Generator().manual_seed(7))
        leaves = [x.clone().requires_grad_() for x in xs]
        out = conv(leaves if parts > 1 else leaves[0], scale, shift, conv_wgrad=mode)
        ct = torch.from_numpy(np.random.default_rng(8).normal(size=out.shape).astype(np.float32))
        grads = torch.autograd.grad((out * ct).sum(), [conv.weight, conv.bias, *leaves])
        results[mode] = (out.detach(), grads)
    torch.testing.assert_close(results["all"][0], results["off"][0], rtol=0, atol=0)
    for got, want in zip(results["all"][1], results["off"][1]):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert (calls["3x3"], calls["1x1"]) == want_calls


def test_function_returns_the_weights_dtype():
    """bf16 weights get a bf16 dW, rounded once from the f32 kernel sum; the
    data gradient stays cuDNN's (here ATen's), in x's dtype."""
    x = torch.from_numpy(_normal((1, 8, 8, 8), 9)).to(torch.bfloat16).requires_grad_()
    w = torch.from_numpy(_normal((4, 8, 3, 3), 10, 0.1)).to(torch.bfloat16).requires_grad_()
    g = torch.from_numpy(_normal((1, 8, 8, 4), 11)).to(torch.bfloat16)
    dx, dw = torch.autograd.grad(W.conv3x3_s1(x, w, 1), (x, w), g)
    assert dw.dtype == dx.dtype == torch.bfloat16
    want = W.wgrad3x3_s1_plain(x.detach(), g, 1).permute(3, 2, 0, 1).to(torch.bfloat16)
    assert torch.equal(dw, want)
    ref_x = x.detach().float().requires_grad_()
    y = torch.nn.functional.conv2d(ref_x.permute(0, 3, 1, 2), w.detach().float(), padding=1)
    (ref_dx,) = torch.autograd.grad(y, ref_x, g.float().permute(0, 3, 1, 2))
    assert (dx.float() - ref_dx).abs().max() <= 1e-2 * ref_dx.abs().max()


def test_wrappers_take_plain_versions_on_cpu_only():
    """On CPU tensors the wrappers return the plain result and count no
    launch; a device mix, shapes outside the envelope and other dtypes
    raise."""
    x, g = torch.from_numpy(_normal((2, 5, 7, 3), 12)), torch.from_numpy(_normal((2, 5, 7, 6), 13))
    xp = pad2d(x, 1, "reflection")
    W.reset_launches()
    assert torch.equal(W.wgrad3x3_s1(x, g), W.wgrad3x3_s1_plain(x, g))
    assert torch.equal(W.wgrad3x3_s1(xp, g, 0), W.wgrad3x3_s1_plain(xp, g, 0))
    assert torch.equal(W.wgrad1x1(x, g), W.wgrad1x1_plain(x, g))
    assert W.LAUNCHES == {"wgrad3x3_s1": 0, "wgrad1x1": 0}
    with pytest.raises(ValueError, match="one CUDA device"):
        W.wgrad3x3_s1(x, g.to("meta"))
    with pytest.raises(ValueError, match="one CUDA device"):
        W.wgrad1x1(x.to("meta"), g)
    with pytest.raises(ValueError):
        W.wgrad3x3_s1(x, g, 2)
    with pytest.raises(ValueError):
        W.wgrad3x3_s1(xp, g, 1)
    with pytest.raises(ValueError):
        W.wgrad1x1(x, g[:1])
    with pytest.raises(ValueError):
        W.wgrad1x1(x[0], g[0])
    with pytest.raises(TypeError):
        W.wgrad1x1(x, g.to(torch.bfloat16))
    with pytest.raises(TypeError):
        W.wgrad1x1(x.double(), g.double())


def test_conv_wgrad_values_are_checked():
    for bad in ("on", "1", "3X3"):
        with pytest.raises(ValueError, match="conv_wgrad"):
            Skip(conv_wgrad=bad)
        with pytest.raises(ValueError, match="conv_wgrad"):
            Conv(4, 4, 3)(torch.zeros(1, 4, 4, 4), conv_wgrad=bad)
    with pytest.raises(ValueError, match="downsample_mode"):
        Conv(4, 4, 3, 2, downsample_mode="bicubic")


def _planar(shape, seed, dtype=torch.bfloat16):
    """An NHWC view of an NCHW-contiguous tensor (the layout cuDNN hands back)."""
    n, h, w, c = shape
    return torch.from_numpy(_normal((n, c, h, w), seed)).to(dtype).permute(0, 2, 3, 1)


def test_k5_operands_pass_dense_tensors_through():
    """NHWC-dense bf16 x and g come back as themselves: no copy."""
    x = torch.from_numpy(_normal((2, 10, 12, 8), 16)).to(torch.bfloat16)
    g = torch.from_numpy(_normal((2, 8, 10, 16), 17)).to(torch.bfloat16)
    xd, gd = W._k5_operands(x, g, 0)
    assert xd is x and gd is g


@pytest.mark.parametrize("layout", ["planar", "w slice", "channel slice"])
def test_k5_operands_copy_strided_tensors_once(layout):
    """Channel-planar and sliced views come back NHWC-dense, 16-byte
    aligned, with the same values."""
    if layout == "planar":
        x, g = _planar((2, 10, 12, 8), 18), _planar((2, 8, 10, 16), 19)
    elif layout == "w slice":
        x = torch.from_numpy(_normal((2, 10, 15, 8), 18)).to(torch.bfloat16)[:, :, 1:13]
        g = torch.from_numpy(_normal((2, 8, 13, 16), 19)).to(torch.bfloat16)[:, :, 2:12]
    else:
        x = torch.from_numpy(_normal((2, 10, 12, 11), 18)).to(torch.bfloat16)[..., 3:]
        g = torch.from_numpy(_normal((2, 8, 10, 20), 19)).to(torch.bfloat16)[..., 4:]
    assert not x.is_contiguous() and not g.is_contiguous()
    xd, gd = W._k5_operands(x, g, 0)
    for got, want in ((xd, x), (gd, g)):
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert got.data_ptr() != want.data_ptr()
        assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["nhwc", "planar"])
def test_k5_operands_zero_pad_for_halo1(layout):
    """halo=1: x comes back NHWC-dense with one zero pixel around it."""
    if layout == "planar":
        x, g = _planar((1, 7, 9, 5), 20), _planar((1, 7, 9, 3), 21)
    else:
        x = torch.from_numpy(_normal((1, 7, 9, 5), 20)).to(torch.bfloat16)
        g = torch.from_numpy(_normal((1, 7, 9, 3), 21)).to(torch.bfloat16)
    xd, gd = W._k5_operands(x, g, 1)
    assert tuple(xd.shape) == (1, 9, 11, 5) and xd.is_contiguous()
    assert torch.equal(xd[:, 1:-1, 1:-1], x)
    ring = xd.clone()
    ring[:, 1:-1, 1:-1] = 0
    assert not ring.any()
    assert gd.is_contiguous() and torch.equal(gd, g)
    assert _max_rel(W.wgrad3x3_s1_plain(xd, gd, 0), W.wgrad3x3_s1_plain(x, g, 1)) < 1e-6


@pytest.mark.parametrize("dtype,want_ms", [(torch.bfloat16, 77.3e9 / 989e12 * 1e3),
                                           (torch.float32, 77.3e9 / 67e12 * 1e3)])
def test_wgrad_bound_at_the_top_kate_shape(dtype, want_ms):
    """Phase 3's bound of the 3x3 weight gradient at x (1,514,514,128), g
    (1,512,512,128): 77.3 GFLOP at the dtype's peak outweighs its bytes."""
    from chip_smoke import wgrad_bound

    ms, by = wgrad_bound(3, (1, 514, 514, 128), (1, 512, 512, 128), dtype)
    assert by == "operations" and ms == pytest.approx(want_ms, rel=1e-3)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """The check chip_smoke.py runs: the 'kate' shapes in bf16 and f32,
    halo 0 and 1, NHWC and channel-planar, two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run python3 chip_smoke.py on the card)")
    from chip_smoke import phase_wgrad_parity

    stats = phase_wgrad_parity(torch.device("cuda", 0))
    assert set(stats) == {"wgrad3x3_s1", "wgrad1x1"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["planar", "two images"])
def test_wgrad1x1_plain_matches_pallas_planar_and_batched(jx, case, dtype):
    """K6's plain version against the Pallas kernel in interpret mode, in
    both dtypes: on a channel-planar view (the layout the fit hands over),
    and with N = 2 summed (the Pallas kernel takes one image: its two results
    are added); Ci and Co off 8."""
    jax, pw = jx
    jnp = jax.numpy
    t = getattr(torch, dtype)
    n = 1 if case == "planar" else 2
    if case == "planar":
        x, g = _planar((1, 32, 32, 12), 22, t), _planar((1, 32, 32, 20), 23, t)
        assert not x.is_contiguous() and x.permute(0, 3, 1, 2).is_contiguous()
    else:
        x = torch.from_numpy(_normal((2, 32, 32, 12), 22)).to(t)
        g = torch.from_numpy(_normal((2, 32, 32, 20), 23)).to(t)
    want = sum(np.asarray(_pallas(pw.wgrad1x1, jnp.asarray(x[i].float().numpy(), getattr(jnp, dtype)),
                                  jnp.asarray(g[i].float().numpy(), getattr(jnp, dtype))))
               for i in range(n))
    got = W.wgrad1x1_plain(x, g)
    assert tuple(got.shape) == want.shape == (1, 1, 12, 20) and got.dtype == torch.float32
    assert _max_rel(got.numpy(), want) < {"float32": 2e-4, "bfloat16": 1e-3}[dtype]


# (N, H, W, Ci, Co) of g with Ci input channels: the 'kate' step's K5 and
# K6 shapes at 512^2, then ragged and narrow ones
F32_PLAN_SHAPES = [(1, r, r, 128, 128) for r in (512, 256, 128, 64, 32, 16)] + [
    (1, 512, 512, 128, 3), (2, 19, 23, 20, 12), (2, 32, 68, 64, 48), (1, 33, 70, 20, 36)]


@pytest.mark.parametrize("ks", [3, 1])
@pytest.mark.parametrize("shape", F32_PLAN_SHAPES)
def test_f32_split_plan(shape, ks):
    """f32_plan, which sizes every f32 K5 and K6 launch: its splits cover
    the N*H*ceil(W/64) row tiles exactly once, in order, at least one tile
    a split; about one wave of blocks on the H100's 132 SMs and no more
    (all of it where there are enough tiles); the workspace is one f32
    (ks*ks, Ci, Co rounded up to 4) slab a split; and the plan depends on
    the shape alone."""
    n, h, w, ci, co = shape
    plan = W.f32_plan(n, h, w, ci, co, ks)
    tiles = n * h * -(-w // 64)
    per = plan.tiles_per_split
    assert plan.tiles == tiles and plan.splits >= 1
    covered = np.zeros(tiles, dtype=np.int64)
    for s in range(plan.splits):
        covered[s * per:min((s + 1) * per, tiles)] += 1
    assert (covered == 1).all() and (plan.splits - 1) * per < tiles
    bk = 16 if co <= 16 else (64 if ks == 3 else 128)
    blocks = -(-ci // 128) * -(-co // bk) * (3 if ks == 3 else 1)
    assert plan.block_cols == bk and plan.grid == (blocks, plan.splits)
    assert blocks * (plan.splits - 1) < 132
    if per > 1:  # one tile fewer a split would take more than a wave
        assert blocks * -(-tiles // (per - 1)) > 132
    assert plan.workspace == (plan.splits, ks * ks, ci, -(-co // 4) * 4)
    W.f32_plan.cache_clear()
    assert W.f32_plan(n, h, w, ci, co, ks) == plan
    if shape == F32_PLAN_SHAPES[0] and ks == 3:
        # the top 'kate' shape: 6 block kinds x 22 splits of 187 tiles, 13 MB
        assert (plan.grid, plan.tiles_per_split) == ((6, 22), 187)
        assert 4 * np.prod(plan.workspace) == pytest.approx(13e6, rel=0.01)


@pytest.mark.parametrize("shape", [(1, 512, 512, 128, 128), (1, 512, 512, 128, 8),
                                   (2, 33, 70, 24, 40), (1, 16, 16, 128, 128)])
def test_wgrad_mma_plan_one_tap(shape):
    """The bf16 K6 plan: wgrad_mma_plan with one tap covers the N*h*w pixels
    once in whole 8x16 tiles, on one wave of blocks at most, with no
    kernel-row factor in its grid and one f32 (1, Ci, Co rounded up to 4)
    slab a split; with nine taps it is the 3x3 plan."""
    from dip_tpu_torch.ops import hopper_up_conv as H

    n, h, w, ci, co = shape
    plan = H.wgrad_mma_plan(n, h, w, ci, co, 1)
    tiles = n * -(-h // 8) * -(-w // 16)
    assert plan.tiles == tiles and sum(plan.pixels) == n * h * w
    assert (plan.splits - 1) * plan.tiles_per_split < tiles <= plan.splits * plan.tiles_per_split
    blocks = -(-ci // 64) * -(-co // 128)
    assert plan.grid == (blocks, plan.splits) and blocks * (plan.splits - 1) < 132
    assert plan.workspace == (plan.splits, 1, ci, -(-co // 4) * 4)
    assert H.wgrad_mma_plan(n, h, w, ci, co, 9) == H.wgrad3x3_plan(n, h, w, ci, co)
    with pytest.raises(ValueError):
        H.wgrad_mma_plan(n, h, w, ci, co, 4)


class _FakeLib:
    """Stands in for the kernel library: records each entry's arguments and
    returns 0 (success) without touching the buffers."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("dip_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_lib(monkeypatch):
    """Routes the wrappers to _FakeLib as if every tensor were on a card,
    and counts the dense copies the bf16 path makes."""
    from dip_tpu_torch.ops import _build

    lib = _FakeLib()
    lib.copies = []
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "on_cpu", lambda **tensors: False)
    monkeypatch.setattr(_build, "stream", lambda: None)
    real_dense = W._dense

    def dense(t):
        out = real_dense(t)
        if out is not t:
            lib.copies.append(tuple(t.shape))
        return out

    monkeypatch.setattr(W, "_dense", dense)
    return lib


@pytest.mark.parametrize("ks,halo", [(3, 0), (3, 1), (1, 0)])
def test_f32_wrappers_pass_planar_strides_and_copy_nothing(fake_lib, ks, halo):
    """f32 K5 and K6 on channel-planar x and g: one dip_wgrad_f32_fits call
    with one fit, the tensors' own pointers and element strides (no copy),
    the shape, the plan's splits, tiles a split and slab pitch; one launch
    counted."""
    h = 12
    hx = h + 2 - 2 * halo if ks == 3 else h
    x, g = _planar((2, hx, hx + 3, 12), 24, torch.float32), _planar((2, h, h + 3, 20), 25, torch.float32)
    W.reset_launches()
    dw = W.wgrad3x3_s1(x, g, halo) if ks == 3 else W.wgrad1x1(x, g)
    assert tuple(dw.shape) == (ks, ks, 12, 20) and dw.dtype == torch.float32
    assert W.LAUNCHES == {"wgrad3x3_s1": int(ks == 3), "wgrad1x1": int(ks == 1)}
    [(name, args)] = fake_lib.calls
    plan = W.f32_plan(2, h, h + 3, 12, 20, ks)
    assert name == "dip_wgrad_f32_fits" and args[4] == 1
    assert args[0] == x.data_ptr() and args[1] == g.data_ptr()
    assert args[5:12] == (2, h, h + 3, hx, hx + 3, 12, 20)
    assert args[12:20] == (*x.stride(), *g.stride())
    assert args[20:25] == (ks, halo, plan.splits, plan.tiles_per_split, plan.workspace[3])
    assert fake_lib.copies == []


@pytest.mark.parametrize("layout", ["nhwc", "planar"])
def test_bf16_wgrad1x1_runs_the_mma_entry(fake_lib, layout):
    """bf16 K6 calls dip_wgrad1x1_mma on NHWC-dense operands: an NHWC x and
    g pass through, a channel-planar one is copied once each; sized by the
    one-tap plan; a launch counted."""
    from dip_tpu_torch.ops import hopper_up_conv as H

    if layout == "planar":
        x, g = _planar((1, 16, 24, 16), 26), _planar((1, 16, 24, 32), 27)
    else:
        x = torch.from_numpy(_normal((1, 16, 24, 16), 26)).to(torch.bfloat16)
        g = torch.from_numpy(_normal((1, 16, 24, 32), 27)).to(torch.bfloat16)
    W.reset_launches()
    dw = W.wgrad1x1(x, g)
    assert tuple(dw.shape) == (1, 1, 16, 32) and W.LAUNCHES["wgrad1x1"] == 1
    [(name, args)] = fake_lib.calls
    plan = H.wgrad_mma_plan(1, 16, 24, 16, 32, 1)
    assert name == "dip_wgrad1x1_mma"
    assert args[4:] == (1, 16, 24, 16, 32, plan.splits, plan.tiles_per_split, 1, None)
    passed = (args[0] == x.data_ptr(), args[1] == g.data_ptr())
    assert passed == ((True, True) if layout == "nhwc" else (False, False))
    assert fake_lib.copies == ([] if layout == "nhwc" else [tuple(x.shape), tuple(g.shape)])


def test_bf16_wgrad1x1_pads_channels_off_8():
    """The bf16 1x1's operands come padded with zero channels to a multiple
    of 8 (the 3-channel head's g), NHWC-dense, with the same values; a
    multiple of 8 passes through."""
    g = _planar((1, 8, 10, 3), 28)
    gp = W._pad8(g)
    assert tuple(gp.shape) == (1, 8, 10, 8) and gp.is_contiguous() and gp.data_ptr() % 16 == 0
    assert torch.equal(gp[..., :3], g) and not gp[..., 3:].any()
    x = torch.from_numpy(_normal((1, 8, 10, 16), 29)).to(torch.bfloat16)
    assert W._pad8(x) is x
    # the zero channels add nothing (the CPU einsum's order of sums may differ)
    torch.testing.assert_close(W.wgrad1x1_plain(gp, gp)[..., :3, :3], W.wgrad1x1_plain(g, g),
                               rtol=1e-6, atol=1e-5)


def test_bf16_head_wgrad1x1_cuts_the_padding(fake_lib):
    """A 1x1 with Co = 3 runs the kernel on 8 columns and hands back the
    (1,1,Ci,3) part of its result."""
    x = torch.from_numpy(_normal((1, 8, 16, 16), 30)).to(torch.bfloat16)
    g = torch.from_numpy(_normal((1, 8, 16, 3), 31)).to(torch.bfloat16)
    dw = W.wgrad1x1(x, g)
    [(name, args)] = fake_lib.calls
    assert name == "dip_wgrad1x1_mma" and args[4:9] == (1, 8, 16, 16, 8)
    assert tuple(dw.shape) == (1, 1, 16, 3)


def test_bf16_wgrad3x3_call_is_unchanged(fake_lib):
    """bf16 K5 still calls dip_wgrad3x3_mma with the 3x3 plan, on x padded
    by one zero pixel for halo 1 (one copy) and g as it is."""
    from dip_tpu_torch.ops import hopper_up_conv as H

    x = torch.from_numpy(_normal((1, 16, 24, 16), 32)).to(torch.bfloat16)
    g = torch.from_numpy(_normal((1, 16, 24, 32), 33)).to(torch.bfloat16)
    dw = W.wgrad3x3_s1(x, g, 1)
    assert tuple(dw.shape) == (3, 3, 16, 32)
    [(name, args)] = fake_lib.calls
    plan = H.wgrad3x3_plan(1, 16, 24, 16, 32)
    assert name == "dip_wgrad3x3_mma"
    assert args[1] == g.data_ptr() and args[0] != x.data_ptr()
    assert args[4:] == (1, 16, 24, 16, 32, plan.splits, plan.tiles_per_split, 1, None)


def _vmapped_backward(ks, weight_batched, dtype, fits=3, n=2):
    """One backward of a vmapped Conv3x3S1 (halo 1) or Conv1x1 over `fits`
    fits of n images each; returns the physical x."""
    from torch.func import vmap

    x = torch.from_numpy(_normal((fits, n, 8, 16, 16), 34)).to(dtype).requires_grad_()
    wshape = (16, 16, ks, ks)
    w = torch.from_numpy(_normal((fits, *wshape) if weight_batched else wshape, 35)).to(dtype)
    w.requires_grad_()
    fn = (lambda xi, wi: W.conv3x3_s1(xi, wi, 1)) if ks == 3 else W.conv1x1
    y = vmap(fn, in_dims=(0, 0 if weight_batched else None))(x, w)
    torch.autograd.grad(y.float().sum(), (x, w))
    return x


@pytest.mark.parametrize("ks", [3, 1])
def test_vmap_bf16_batched_weight_runs_one_fit_axis_launch(fake_lib, ks):
    """Under vmap with each fit's own weight (BatchEngine), the bf16 weight
    gradient is ONE launch of the fit-axis entry for all the fits (fits =
    B, N = B * n), sized by one fit's plan; one launch counted."""
    from dip_tpu_torch.ops import hopper_up_conv as H

    W.reset_launches()
    _vmapped_backward(ks, True, torch.bfloat16)
    [(name, args)] = fake_lib.calls
    plan = H.wgrad_mma_plan(2, 8, 16, 16, 16, ks * ks)
    assert name == ("dip_wgrad3x3_mma_fits" if ks == 3 else "dip_wgrad1x1_mma_fits")
    assert args[4:] == (3, 6, 8, 16, 16, 16, plan.splits, plan.tiles_per_split, 1, None)
    assert W.LAUNCHES == {"wgrad3x3_s1": int(ks == 3), "wgrad1x1": int(ks == 1)}


@pytest.mark.parametrize("ks", [3, 1])
def test_vmap_f32_batched_weight_launches_once_a_fit(fake_lib, ks):
    """In f32 the fit axis of csrc/wgrad.cu serves the B fits in one launch:
    one dip_wgrad_f32_fits call with fits = B, N = B * n, x and g as they
    lie (their own pointers and strides), sized by one fit's plan; one
    launch counted."""
    W.reset_launches()
    x = _vmapped_backward(ks, True, torch.float32)
    [(name, args)] = fake_lib.calls
    plan = W.f32_plan(2, 8, 16, 16, 16, ks)
    assert name == "dip_wgrad_f32_fits"
    assert args[4:12] == (3, 6, 8, 16, 8, 16, 16, 16)
    assert args[20:25] == (ks, int(ks == 3), plan.splits, plan.tiles_per_split,
                           plan.workspace[3])
    assert args[0] == x.data_ptr()  # x read where it lies
    assert W.LAUNCHES == {"wgrad3x3_s1": int(ks == 3), "wgrad1x1": int(ks == 1)}


@pytest.mark.parametrize("ks,halo", [(3, 0), (3, 1), (1, 0)])
def test_f32_fit_axis_passes_strides_and_one_fit_plan(fake_lib, ks, halo):
    """f32 K5 and K6 with `fits` on channel-planar x and g: one
    dip_wgrad_f32_fits call with fits, all N images, the tensors' own
    pointers and element strides (no copy), and one fit's split plan; the
    workspace a slab set a fit and dW (fits, k, k, Ci, Co); one launch."""
    h, fits = 12, 2
    hx = h + 2 - 2 * halo if ks == 3 else h
    x = _planar((4, hx, hx + 3, 12), 60, torch.float32)
    g = _planar((4, h, h + 3, 20), 61, torch.float32)
    W.reset_launches()
    dw = W.wgrad3x3_s1(x, g, halo, fits) if ks == 3 else W.wgrad1x1(x, g, fits)
    assert tuple(dw.shape) == (fits, ks, ks, 12, 20) and dw.dtype == torch.float32
    assert W.LAUNCHES == {"wgrad3x3_s1": int(ks == 3), "wgrad1x1": int(ks == 1)}
    [(name, args)] = fake_lib.calls
    plan = W.f32_plan(2, h, h + 3, 12, 20, ks)
    assert name == "dip_wgrad_f32_fits" and args[4] == fits
    assert args[0] == x.data_ptr() and args[1] == g.data_ptr()
    assert args[5:12] == (4, h, h + 3, hx, hx + 3, 12, 20)
    assert args[12:20] == (*x.stride(), *g.stride())
    assert args[20:25] == (ks, halo, plan.splits, plan.tiles_per_split, plan.workspace[3])
    assert fake_lib.copies == []


def test_vmap_shared_weight_folds_the_fits_into_n(fake_lib):
    """Under vmap with one weight for every fit, the fits fold into N: the
    single-fit bf16 entry, once, over N = B * n images."""
    _vmapped_backward(3, False, torch.bfloat16)
    [(name, args)] = fake_lib.calls
    assert name == "dip_wgrad3x3_mma" and args[4] == 6


@pytest.mark.parametrize("ks", [3, 1])
def test_fit_axis_plain_is_per_fit(ks):
    """The plain versions with `fits`: fit b's dW from its own images only,
    equal to the plain version on its slice."""
    x = torch.from_numpy(_normal((4, 6, 7, 5), 36))
    g = torch.from_numpy(_normal((4, 6, 7, 3), 37))
    got = W.wgrad3x3_s1(x, g, 1, fits=2) if ks == 3 else W.wgrad1x1(x, g, fits=2)
    for b in range(2):
        one = (W.wgrad3x3_s1(x[2 * b:2 * b + 2], g[2 * b:2 * b + 2], 1) if ks == 3
               else W.wgrad1x1(x[2 * b:2 * b + 2], g[2 * b:2 * b + 2]))
        assert torch.equal(got[b], one)
    with pytest.raises(ValueError, match="fits"):
        W.wgrad1x1(x, g, fits=3)
