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
