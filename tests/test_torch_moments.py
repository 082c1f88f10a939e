"""The bilinear up2 moments' Hopper kernels (dip_tpu_torch/ops/hopper_moments.py,
csrc/up2_moments.cu) and their dispatch from ops/up_conv.py's up2_moments.

On the CPU: the plain backward (the kernel's 3x3 stencil form) against
autograd of the PyTorch formula in f64, the autograd.Function and its vmap
rule with the kernels stood in for by the formula, the launches a
recording stand-in of the kernel library sees, the wrappers refusing CPU
tensors and other dtypes, and up2_moments keeping its PyTorch form for CPU
tensors, 'nearest' and row blocks. On the card (marked `cuda`): the kernels against the formula
in f64, their bits run to run, under vmap and in a CUDA graph.

The file does not import JAX, so the `cuda` tests run on a machine without
it (`python -m pytest tests/test_torch_moments.py -m cuda --noconftest`).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dip_tpu_torch.ops import _build, launches  # noqa: E402
from dip_tpu_torch.ops import hopper_moments as HM  # noqa: E402
from dip_tpu_torch.ops import up_conv  # noqa: E402
from dip_tpu_torch.ops.rows import Rows  # noqa: E402

FLAGSHIP = [(1, s, s, 128) for s in (16, 32, 64, 128, 256)]
# the last: an SR seam's LR (w = 36, not a multiple of 8), whose channels
# straddle the kernels' blocks
AWKWARD = [(1, 6, 10, 8), (1, 2, 8, 16), (1, 5, 7, 8), (1, 9, 6, 4), (1, 7, 5, 3),
           (2, 12, 10, 16), (1, 24, 36, 128)]


def _x(shape, seed, dtype=torch.float32):
    """Normal values around a per-channel offset in [0.5, 1.5), so no
    channel's mean sits near 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) + rng.uniform(0.5, 1.5, size=shape[-1])
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _formula(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """up2_moments' PyTorch formula in x's own dtype (f64 for the
    references below): sliced products, einsums against the Gram diagonal,
    the clamp."""
    n, h, w, c = x.shape
    g0h = torch.from_numpy(HM._gram_diag(h)).to(x)
    g0w = torch.from_numpy(HM._gram_diag(w)).to(x)
    mean = x.mean((0, 1, 2))
    s0 = torch.einsum("nhwc,h,w->c", x * x, g0h, g0w)
    sh = 0.75 * torch.einsum("nhwc,w->c", x[:, :-1] * x[:, 1:], g0w)
    sw = 0.75 * torch.einsum("nhwc,h->c", x[:, :, :-1] * x[:, :, 1:], g0h)
    sd = 0.28125 * ((x[:, :-1, :-1] * x[:, 1:, 1:]).sum((0, 1, 2))
                    + (x[:, 1:, :-1] * x[:, :-1, 1:]).sum((0, 1, 2)))
    second = (s0 + sh + sw + sd) / (n * 4 * h * w)
    return mean, torch.clamp(second - mean * mean, min=0.0)


def _reference(x: torch.Tensor, g_mean: torch.Tensor, g_var: torch.Tensor):
    """(mean, var, dx) of the formula in f64 on the CPU."""
    xd = x.detach().cpu().double().requires_grad_()
    mean, var = _formula(xd)
    loss = (mean * g_mean.cpu().double()).sum() + (var * g_var.cpu().double()).sum()
    dx, = torch.autograd.grad(loss, xd)
    return mean.detach(), var.detach(), dx


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """|got - want| <= 1e-5 max|want| + the rounding of got's dtype (half an
    ulp of each value: 2^-8 relative in bf16, 2^-24 in f32)."""
    half_ulp = 2.0 ** -8 if got.dtype == torch.bfloat16 else 2.0 ** -24
    g = got.detach().cpu().double()
    tol = 1e-5 * want.abs().max() + half_ulp * want.abs() * (1 + 1e-5)
    err = (g - want).abs()
    assert bool((err <= tol).all()), (what, float((err - tol).max()), float(want.abs().max()))


def _plain_moments(x: torch.Tensor):
    """moments' outputs from the PyTorch formula's f32 sums, fit by fit:
    x (N, h, w, C) -> mean, var (C,) in x's dtype and stats (2, C); x
    (B, N, h, w, C) -> (B, C), (B, C), (B, 2, C)."""
    sums = [HM._sums_plain(xb) for xb in (x.unsqueeze(0) if x.dim() == 4 else x)]
    mean = torch.stack([m for m, _ in sums])
    second = torch.stack([s for _, s in sums])
    var = torch.clamp(second - mean * mean, min=0.0)
    out = mean.to(x.dtype), var.to(x.dtype), torch.stack([mean, second], -2)
    return tuple(t[0] for t in out) if x.dim() == 4 else out


@pytest.fixture
def plain_kernels(monkeypatch):
    """Up2Moments on the CPU: its kernel calls stood in for by the formula's
    sums and the backward kernel's plain version."""
    monkeypatch.setattr(HM, "moments", _plain_moments)
    monkeypatch.setattr(HM, "moments_bwd", HM.moments_bwd_plain)


def _cotangents(c: int, seed: int, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=c).astype(np.float32)).to(dtype),
            torch.from_numpy(rng.normal(size=c).astype(np.float32)).to(dtype))


# -- CPU --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 16, 16, 128)] + AWKWARD)
def test_plain_backward_matches_the_formulas_gradient(shape):
    """moments_bwd_plain, the backward kernel's stencil form, from the
    formula's f32 sums, against autograd of the formula in f64, and the
    PyTorch formula's mean and var (up2_moments_plain) against the
    formula's in f64."""
    x = _x(shape, seed=sum(shape))
    g_mean, g_var = _cotangents(shape[-1], seed=shape[1])
    mean, var, dx = _reference(x, g_mean, g_var)
    m, v = HM.up2_moments_plain(x)
    _close(m, mean, "mean")
    _close(v, var, "var")
    stats = torch.stack(HM._sums_plain(x))
    assert stats.dtype == torch.float32 and tuple(stats.shape) == (2, shape[-1])
    _close(HM.moments_bwd_plain(x, stats, g_mean, g_var), dx, "dx")


@pytest.mark.parametrize("used", ["mean", "var"])
def test_backward_with_one_output_used(used, plain_kernels):
    """Only one of mean and var reaches the loss: the other's cotangent is
    None (no zeros are materialised) and counts as zero."""
    x = _x((2, 6, 5, 8), seed=4)
    g_mean, g_var = _cotangents(8, seed=5)
    zero = torch.zeros(8)
    want = _reference(x, g_mean if used == "mean" else zero, g_var if used == "var" else zero)[2]
    xi = x.clone().requires_grad_()
    mean, var = HM.up2_moments_hopper(xi)
    out = (mean * g_mean).sum() if used == "mean" else (var * g_var).sum()
    got, = torch.autograd.grad(out, xi)
    _close(got, want, "dx")


@pytest.mark.parametrize("shape", [(1, 8, 8, 16), (2, 5, 7, 3)])
def test_vmap_rule_equals_each_fits_own_call(shape, plain_kernels):
    """Up2Moments under torch.func.vmap over B = 3 fits (the fits form on
    the physical tensor, here through the kernels' stand-ins) against each
    fit's own call: outputs and input gradients bit for bit."""
    xb = torch.stack([_x(shape, seed=i) for i in range(3)]).requires_grad_()
    mean, var = torch.func.vmap(HM.up2_moments_hopper)(xb)
    (mean.sum() + (3.0 * var).sum()).backward()
    for i in range(3):
        xi = xb.detach()[i].clone().requires_grad_()
        m, v = HM.up2_moments_hopper(xi)
        (m.sum() + (3.0 * v).sum()).backward()
        assert torch.equal(m, mean[i]) and torch.equal(v, var[i])
        assert torch.equal(xi.grad, xb.grad[i])


class _RecordingLib:
    """A stand-in kernel library: records each call, launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def test_vmapped_moments_launch_once_for_all_fits(monkeypatch):
    """Under vmap over B = 3 fits, one forward and one backward launch with
    fits = 3; each call moves its LAUNCHES counter by one."""
    lib = _RecordingLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "on_cpu", lambda **tensors: False)
    monkeypatch.setattr(_build, "stream", lambda: None)
    launches.reset()
    xb = torch.rand((3, 1, 16, 12, 32)).requires_grad_()
    mean, var = torch.func.vmap(HM.up2_moments_hopper)(xb)
    assert tuple(mean.shape) == tuple(var.shape) == (3, 32)
    assert launches.counts()["moments_fwd"] == 1 and launches.counts()["moments_bwd"] == 0
    (mean.sum() + var.sum()).backward()
    assert tuple(xb.grad.shape) == tuple(xb.shape)
    assert [n for n, _ in lib.calls] == ["dip_up2_moments_fwd", "dip_up2_moments_bwd"]
    rows, parts = HM.plan(1, 16, 12, 32, True)
    # x, part, mean, var, stats, 5 strides, fits, n, h, w, c, rows, parts, vec,
    # channels fastest, f32, stream
    assert lib.calls[0][1][5:20] == (6144, 6144, 384, 32, 1, 3, 1, 16, 12, 32, rows, parts,
                                     1, 1, 1)
    # x, g_mean, g_var, stats, dx, 5 strides, fits, n, h, w, c, rows, vec,
    # channels fastest, f32, stream
    assert lib.calls[1][1][5:19] == (6144, 6144, 384, 32, 1, 3, 1, 16, 12, 32, rows, 1, 1, 1)
    assert launches.counts()["moments_fwd"] == launches.counts()["moments_bwd"] == 1


def test_channel_planar_x_is_read_in_place(monkeypatch):
    """The channel-planar NHWC view of an NCHW tensor goes to the kernels
    as it is (columns fastest, its own strides, no copy), dx takes its
    layout; any other layout is copied to NHWC first."""
    lib = _RecordingLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "on_cpu", lambda **tensors: False)
    monkeypatch.setattr(_build, "stream", lambda: None)
    x = torch.rand((2, 24, 10, 16)).permute(0, 2, 3, 1)  # (N, h, w, C) = (2, 10, 16, 24)
    _, _, stats = HM.moments(x)
    dx = HM.moments_bwd(x, stats, torch.zeros(24), torch.zeros(24))
    assert dx.stride() == x.stride()
    (_, fwd), (_, bwd) = lib.calls
    assert fwd[0] == bwd[0] == x.data_ptr()
    assert fwd[5:10] == bwd[5:10] == (0, 3840, 16, 1, 160)
    assert fwd[17:19] == bwd[16:18] == (1, 0)  # 8-column vectors, columns fastest
    lib.calls.clear()
    y = torch.rand((2, 10, 24, 16)).permute(0, 1, 3, 2)  # neither layout
    HM.moments(y)
    (_, fwd), = lib.calls
    assert fwd[0] != y.data_ptr() and fwd[5:10] == (0, 3840, 384, 24, 1) and fwd[18] == 1


@pytest.mark.parametrize("call", ["moments", "moments_bwd"])
def test_kernel_wrappers_refuse_what_they_cannot_launch(call):
    """moments and moments_bwd launch kernels only: CPU tensors raise (the
    CPU's moments are up2_moments_plain), and so does a dtype the kernels
    do not take, where up2_moments would otherwise hand it over."""
    x = _x((1, 6, 5, 8), seed=1)
    stats = torch.stack(HM._sums_plain(x))
    g = torch.zeros(8)

    def run(x):
        return HM.moments(x) if call == "moments" else HM.moments_bwd(x, stats, g, g)

    with pytest.raises(ValueError, match="CUDA tensors"):
        run(x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        run(x.to(torch.float16))


def test_plan_keeps_a_fits_grid_its_own():
    """The grid is one fit's shape alone (so a fit's bits do not depend on
    how many fits share the launch): 16-row tiles halved to 4 while a fit
    has fewer than 264 blocks; 8-channel vectors where C allows."""
    assert HM.plan(1, 256, 256, 128, True) == (8, 512)
    assert HM.plan(1, 128, 128, 128, True) == (4, 256)
    assert HM.plan(1, 16, 16, 128, True) == (4, 4)
    assert HM.plan(1, 7, 5, 3, False) == (4, 2)


def test_up2_moments_keeps_the_torch_formula_on_the_cpu(monkeypatch):
    """On CPU tensors up2_moments takes PyTorch ops, bit for bit the
    formula, for 'bilinear' and 'nearest' and over row blocks, and never
    reaches the kernels' Function."""
    def refuse(*args):
        raise AssertionError("the kernels' Function ran on the CPU")

    monkeypatch.setattr(HM.Up2Moments, "apply", refuse)
    launches.reset()
    for dtype in (torch.float32, torch.bfloat16):
        x = _x((2, 8, 6, 16), seed=3, dtype=dtype).requires_grad_()
        mean, var = up_conv.up2_moments(x, "bilinear")
        fm, fv = _formula(x.to(torch.float32))
        assert torch.equal(mean, fm.to(dtype)) and torch.equal(var, fv.to(dtype))
        g, = torch.autograd.grad(mean.sum() + var.sum(), x)
        xr = x.detach().clone().requires_grad_()
        fm, fv = _formula(xr.to(torch.float32))
        gr, = torch.autograd.grad(fm.to(dtype).sum() + fv.to(dtype).sum(), xr)
        assert torch.equal(g, gr)
        xf = x.detach().to(torch.float32)
        mean, var = up_conv.up2_moments(x.detach(), "nearest")
        assert torch.equal(mean, xf.mean((0, 1, 2)).to(dtype))
        assert torch.equal(var, xf.var((0, 1, 2), unbiased=False).to(dtype))
        for mode in ("bilinear", "nearest"):
            whole = up_conv.up2_moments(x.detach(), mode)
            rows = up_conv.up2_moments(Rows([x.detach()[:, :4], x.detach()[:, 4:]]), mode)
            for a, b in zip(whole, rows):
                torch.testing.assert_close(a, b)
    assert launches.counts()["moments_fwd"] == launches.counts()["moments_bwd"] == 0


# -- the card ---------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run python3 chip_smoke.py on the card)")
    return torch.device("cuda", 0)


def _on(x: torch.Tensor, dev: torch.device, layout: str) -> torch.Tensor:
    """x on `dev`, NHWC-contiguous or as the channel-planar NHWC view of an
    NCHW tensor."""
    if layout == "nhwc":
        return x.to(dev)
    return x.movedim(-1, -3).contiguous().to(dev).movedim(-3, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nhwc", "planar"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FLAGSHIP + AWKWARD, ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_the_formula_in_f64(card, shape, dtype, layout):
    """Forward mean and var and backward dx for random cotangents on both
    outputs, against the formula's in f64: within 1e-5 of the largest
    value plus the rounding to the output dtype, from an NHWC and from a
    channel-planar x (dx in x's layout). Two calls give the same bits, and
    each moves its counter by one."""
    x = _x(shape, seed=sum(shape), dtype=dtype)
    g_mean, g_var = _cotangents(shape[-1], seed=shape[2], dtype=dtype)
    mean, var, dx = _reference(x, g_mean, g_var)
    xc = _on(x, card, layout).requires_grad_()
    launches.reset()
    runs = []
    for _ in range(2):
        m, v = up_conv.up2_moments(xc, "bilinear")
        g, = torch.autograd.grad((m * g_mean.to(card)).sum() + (v * g_var.to(card)).sum(), xc)
        runs.append((m, v, g))
    torch.cuda.synchronize()
    assert launches.counts()["moments_fwd"] == launches.counts()["moments_bwd"] == 2
    m, v, g = runs[0]
    assert m.dtype == v.dtype == g.dtype == dtype and g.stride() == xc.stride()
    _close(m, mean, "mean")
    _close(v, var, "var")
    _close(g, dx, "dx")
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nhwc", "planar"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 32, 32, 128), (2, 7, 5, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_vmap_over_fits_equals_each_fit_on_the_card(card, shape, dtype, layout):
    """torch.func.vmap over B = 3 fits: one launch each way, and every
    fit's mean, var and dx bitwise its own single-fit call's."""
    xb = _on(torch.stack([_x(shape, seed=10 + i, dtype=dtype) for i in range(3)]), card, layout)
    xb.requires_grad_()
    launches.reset()
    mean, var = torch.func.vmap(lambda t: up_conv.up2_moments(t, "bilinear"))(xb)
    (mean.sum() + (2.0 * var).sum()).backward()
    assert launches.counts()["moments_fwd"] == launches.counts()["moments_bwd"] == 1
    for i in range(3):
        xi = xb.detach()[i].clone().requires_grad_()  # clone keeps the layout
        m, v = up_conv.up2_moments(xi, "bilinear")
        (m.sum() + (2.0 * v).sum()).backward()
        assert torch.equal(m, mean[i]) and torch.equal(v, var[i])
        assert torch.equal(xi.grad, xb.grad[i])


@pytest.mark.cuda
def test_cuda_graph_replays_equal_eager(card):
    """The forward and backward captured in a CUDA graph: replays on new
    inputs equal eager calls bit for bit."""
    shape = (1, 64, 64, 128)
    x = _x(shape, seed=1, dtype=torch.bfloat16).to(card)
    g_mean, g_var = (t.to(card) for t in _cotangents(128, seed=2, dtype=torch.bfloat16))
    static = x.clone().requires_grad_()

    def step():
        m, v = up_conv.up2_moments(static, "bilinear")
        g, = torch.autograd.grad((m * g_mean).sum() + (v * g_var).sum(), static)
        return m, v, g

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    for seed in (3, 4):
        new = _x(shape, seed=seed, dtype=torch.bfloat16).to(card)
        with torch.no_grad():
            static.copy_(new)
        graph.replay()
        xe = new.clone().requires_grad_()
        m, v = up_conv.up2_moments(xe, "bilinear")
        g, = torch.autograd.grad((m * g_mean).sum() + (v * g_var).sum(), xe)
        torch.cuda.synchronize()
        for a, b in zip(outs, (m, v, g)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tiny_variance_and_the_clamps_mask(card, dtype):
    """A channel whose variance is 1e-3 of its squared mean stays finite and
    >= 0, and its gradient mask (g_var reaches dx) is torch's; with stats
    whose variance rounds below 0, the kernel masks g_var exactly as the
    plain backward does."""
    rng = np.random.default_rng(7)
    c = 16
    x = 10.0 + np.sqrt(0.1) * rng.normal(size=(1, 32, 24, c))
    x = torch.from_numpy(x.astype(np.float32)).to(dtype).to(card).requires_grad_()
    mean, var = up_conv.up2_moments(x, "bilinear")
    assert bool(torch.isfinite(var).all()) and bool((var >= 0).all())
    g, = torch.autograd.grad(var.sum(), x)
    xt = x.detach().clone().requires_grad_()
    tm, tv = HM.up2_moments_plain(xt)
    gt, = torch.autograd.grad(tv.sum(), xt)
    masked = g.abs().amax((0, 1, 2)) > 0
    assert torch.equal(masked, gt.abs().amax((0, 1, 2)) > 0) and bool(masked.all())
    # crafted stats: every other channel's second moment just below mean^2
    xs = x.detach()
    m32 = torch.linspace(1.0, 2.0, c, device=card)
    second = m32 * m32
    second[::2] = torch.nextafter(second[::2], torch.zeros_like(second[::2]))
    stats = torch.stack([m32, second])
    g_mean, g_var = (t.to(card) for t in _cotangents(c, seed=8, dtype=dtype))
    got = HM.moments_bwd(xs, stats, g_mean, g_var)
    want = HM.moments_bwd_plain(xs, stats, g_mean, g_var)
    # the two sum in other orders: one rounding of the output dtype apart
    torch.testing.assert_close(got.float(), want.float(), atol=1e-9,
                               rtol=1e-5 if dtype == torch.float32 else 2.0 ** -7)
    ref = HM.moments_bwd(xs, stats, g_mean, torch.zeros_like(g_var))
    assert torch.equal(got[..., ::2], ref[..., ::2])
    assert not torch.equal(got[..., 1::2], ref[..., 1::2])
