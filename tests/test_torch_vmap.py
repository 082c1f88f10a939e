"""The vmap rules of the port's autograd Functions (the fit axis of
parallel/batch.py's BatchEngine), on the CPU: each against a loop over
the fits, forward and gradients in f32 within 1e-6 of the largest value.

UpConv3x3 with a batched e runs UpConv3x3Fits on the B*N images (the
fit-axis kernels; here their plain versions per fit), with an unbatched e
it folds the fits into N; S2DPack, _EdgePad and _Downsample fold the fits
into N. A recording stand-in for the kernel library then shows that a
vmapped Skip step launches each seam kernel once a seam for all the fits,
with the fit count in its arguments.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.func import functional_call, vmap  # noqa: E402

from dip_tpu_torch.models import Skip  # noqa: E402
from dip_tpu_torch.ops import _build, hopper_s2d, hopper_up_conv as H, launches  # noqa: E402
from dip_tpu_torch.ops.pad import pad2d  # noqa: E402
from dip_tpu_torch.ops.resample import downsample  # noqa: E402
from dip_tpu_torch.ops.up_conv import up2_conv3x3  # noqa: E402

B = 3
TOL = 1e-6


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


def _rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _check(fn, batched, looped_args):
    """vmap(fn) over `batched` (each (B, ...) with requires_grad) against
    fn on each fit's slice: outputs, and the gradients of a fixed random
    weighting of them."""
    out = vmap(fn)(*batched)
    w = torch.from_numpy(np.random.default_rng(9).normal(size=out.shape).astype(np.float32))
    grads = torch.autograd.grad((out * w).sum(), batched)
    loop_in = [x.detach().clone().requires_grad_() for x in batched]
    loop_out = torch.stack([fn(*(x[i] for x in loop_in)) for i in range(B)])
    loop_grads = torch.autograd.grad((loop_out * w).sum(), loop_in)
    assert _rel(out, loop_out) <= TOL
    for g, lg in zip(grads, loop_grads):
        assert _rel(g, lg) <= TOL


@pytest.mark.parametrize("carry", [False, True])
def test_upconv_vmap_with_batched_e(carry):
    """Each fit its own xp and e: UpConv3x3Fits (per-fit plain versions)."""
    rng = np.random.default_rng(0)
    xp = _t(rng, B, 2, 6, 7, 8).requires_grad_()
    e = _t(rng, B, 3, 3, 8, 12, scale=0.1).requires_grad_()
    if carry:
        cy = _t(rng, B, 2, 8, 10, 3).requires_grad_()
        _check(lambda x, k, c: H.up2_conv3x3_hopper(x, k, c), (xp, e, cy), None)
    else:
        _check(lambda x, k: H.up2_conv3x3_hopper(x, k), (xp, e), None)


def test_upconv_vmap_with_shared_e_folds_the_fits():
    """One e for every fit: the fits fold into N, and e's gradient sums
    over all of them."""
    rng = np.random.default_rng(1)
    xp = _t(rng, B, 1, 6, 6, 8).requires_grad_()
    e = _t(rng, 3, 3, 8, 8, scale=0.1).requires_grad_()
    out = vmap(lambda x: H.up2_conv3x3_hopper(x, e))(xp)
    w = _t(rng, *out.shape)
    gx, ge = torch.autograd.grad((out * w).sum(), (xp, e))
    x2, e2 = xp.detach().clone().requires_grad_(), e.detach().clone().requires_grad_()
    ref = H.up2_conv3x3_hopper(x2.reshape(B, 6, 6, 8), e2).reshape(out.shape)
    rx, re = torch.autograd.grad((ref * w).sum(), (x2, e2))
    assert _rel(out, ref) <= TOL and _rel(gx, rx) <= TOL and _rel(ge, re) <= TOL


@pytest.mark.parametrize("pad_mode", ["reflection", "replication"])
def test_up2_conv3x3_builds_a_batched_e_under_vmap(pad_mode):
    """ops/up_conv.py as it stands (the einsum over each fit's kernel, the
    edge pad, the reflection corrections) under vmap against the loop."""
    rng = np.random.default_rng(2)
    x = _t(rng, B, 1, 5, 6, 8).requires_grad_()
    k = _t(rng, B, 3, 3, 8, 4, scale=0.2).requires_grad_()
    _check(lambda xi, ki: up2_conv3x3(xi, ki, "bilinear", pad_mode), (x, k), None)


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
def test_s2d_vmap_folds_the_fits(out_dtype):
    rng = np.random.default_rng(3)
    x = _t(rng, B, 2, 6, 8, 5).requires_grad_()
    fn = (lambda t: hopper_s2d.s2d(t, out_dtype).float()) if out_dtype else hopper_s2d.s2d
    if out_dtype is None:
        _check(fn, (x,), None)
    else:  # a bf16 cast: the fold gives the loop's values exactly
        got = vmap(fn)(x)
        want = torch.stack([fn(x[i]) for i in range(B)])
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["reflection", "replication"])
def test_edge_pad_vmap_folds_the_fits(mode):
    rng = np.random.default_rng(4)
    x = _t(rng, B, 2, 7, 9, 4).requires_grad_()
    _check(lambda t: pad2d(t, (2, 3), mode), (x,), None)


@pytest.mark.parametrize("factor,preserve", [(4, True), (2, False)])
def test_downsample_vmap_folds_the_fits(factor, preserve):
    rng = np.random.default_rng(5)
    x = _t(rng, B, 1, 24, 20, 3).requires_grad_()
    _check(lambda t: downsample(t, factor, "lanczos2", 0.5, preserve), (x,), None)


def test_fits_wrappers_take_per_fit_plain_versions_on_cpu():
    """fwd, dgrad and wgrad with a fit axis on CPU tensors: each fit's
    slice is that fit's own plain version, bit for bit."""
    rng = np.random.default_rng(6)
    xp, e = _t(rng, 2 * B, 6, 8, 8), _t(rng, B, 3, 3, 8, 12, scale=0.1)
    dzq = _t(rng, 2 * B, 4, 6, 12).to(torch.bfloat16)
    cy = _t(rng, 2 * B, 8, 12, 3)
    out, outc = H.fwd(xp, e), H.fwd(xp, e, cy)
    dxp, de = H.dgrad(dzq, e, torch.float32), H.wgrad(xp, dzq, B)
    assert de.shape == (B, 3, 3, 8, 12)
    for i in range(B):
        s = slice(2 * i, 2 * i + 2)
        assert torch.equal(out[s], H.fwd_plain(xp[s], e[i]))
        assert torch.equal(outc[s], H.fwd_plain(xp[s], e[i], cy[s]))
        assert torch.equal(dxp[s], H.dgrad_plain(dzq[s], e[i], torch.float32))
        assert torch.equal(de[i], H.wgrad_plain(xp[s], dzq[s]))
    with pytest.raises(ValueError):
        H.fwd(xp[:5], e)  # 3 fits do not divide 5 images
    with pytest.raises(ValueError):
        H.wgrad(xp, dzq, 4)


class _RecordingLib:
    """Stands in for the kernel library: records each entry's arguments
    and returns success, leaving the outputs as allocated."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def test_vmapped_skip_step_launches_each_seam_kernel_once(monkeypatch):
    """A vmapped forward and backward of B Skip fits (two fused seams) on
    the recording library: per seam one K1, K4, K2 and K3 launch for all
    B fits, each K1/K2/K3 call given fits = B; the launch counters count
    one fit's launches."""
    lib = _RecordingLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "on_cpu", lambda **tensors: False)
    monkeypatch.setattr(_build, "stream", lambda: None)
    model = Skip(num_input_channels=4, num_channels_down=[8, 8], num_channels_up=[8, 8],
                 num_channels_skip=[4, 4], upsample_mode="bilinear", pad="reflection")
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = {k: torch.stack([p.detach()] * B).requires_grad_()
              for k, p in model.named_parameters()}
    z = torch.rand((B, 1, 16, 16, 4), generator=torch.Generator().manual_seed(1))
    launches.reset()
    out = vmap(lambda p, zi: functional_call(model, p, (zi,)))(params, z)
    out.sum().backward()
    names = [n for n, _ in lib.calls]
    assert names.count("dip_up_conv_fwd") == names.count("dip_up_conv_dgrad") == 2
    assert names.count("dip_up_conv_wgrad") == names.count("dip_s2d_pack") == 2
    for name, args in lib.calls:
        if name in ("dip_up_conv_fwd", "dip_up_conv_dgrad", "dip_up_conv_wgrad"):
            assert args[4] == B, (name, args)  # fits
            assert args[5] == B, (name, args)  # images: one a fit
        if name == "dip_s2d_pack":
            assert args[2] == B  # the fits' cotangents in one launch
    counts = launches.counts()
    assert (counts["fwd"], counts["dgrad"], counts["wgrad"], counts["s2d_pack"]) == (2, 2, 2, 2)
