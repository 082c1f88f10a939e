"""The port's Skip net against the flax Skip, on the same weights.

At 128 channels and a 32x32 input the two decoder seams (LR 8x8 and
16x16) take the fused path on both sides: the JAX package runs its Pallas
kernels in interpret mode, the port the kernels' plain versions. Both
round the seam's operands to bf16, so tolerances are bf16 class where the
seam is on and f32 class where it is off.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dip_tpu.models import Skip as FlaxSkip  # noqa: E402
from dip_tpu.ops import dispatch, pallas_up_conv  # noqa: E402
from dip_tpu_torch import interop  # noqa: E402
from dip_tpu_torch.models import Skip  # noqa: E402
from dip_tpu_torch.ops import hopper_up_conv  # noqa: E402

CFG = dict(num_channels_down=[128] * 2, num_channels_up=[128] * 2,
           num_channels_skip=[4] * 2, upsample_mode="bilinear", pad="reflection")


def _grad_err(got: dict, want: dict) -> float:
    """Largest gradient error over the net, relative to its largest
    gradient. The scale of a BN that feeds another BN (through a
    positively homogeneous LeakyReLU) has a gradient that is rounding
    noise, zero in exact arithmetic, so a per-tensor norm would divide
    noise by noise."""
    g_max = max(float(np.abs(w).max()) for w in want.values())
    return max(float(np.abs(got[k] - want[k]).max()) for k in want) / g_max


def _compare_with_flax(seam: bool, carry: bool = False) -> None:
    for h in (8, 16):
        assert pallas_up_conv.seam_ok(1, h, h, 128, 128, 4)
    rng = np.random.default_rng(0)
    z = (rng.normal(size=(1, 32, 32, 8)) * 0.1).astype(np.float32)
    tgt = rng.random((1, 32, 32, 3)).astype(np.float32)
    fmodel = FlaxSkip(**CFG)
    params = jax.jit(fmodel.init)(jax.random.key(0), jnp.asarray(z))["params"]

    def loss_fn(p):
        out = fmodel.apply({"params": p}, jnp.asarray(z))
        return jnp.mean((out - jnp.asarray(tgt)) ** 2), out

    with dispatch.override(up_conv="on" if seam else "off", seam_carry=carry):
        (_, want_out), want_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want_g = {k: v.numpy() for k, v in interop.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, want_g)).items()}

    model = Skip(num_input_channels=8, up_conv=seam, seam_carry=carry, **CFG)
    model.load_state_dict(interop.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)))
    out = model(torch.from_numpy(z))
    torch.mean((out - torch.from_numpy(tgt)) ** 2).backward()
    got_g = {k: p.grad.numpy() for k, p in model.named_parameters()}

    assert tuple(out.shape) == want_out.shape == (1, 32, 32, 3)
    out_tol, grad_tol = (2e-3, 5e-2) if seam else (2e-5, 2e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=out_tol, rtol=0)
    assert set(got_g) == set(want_g)
    assert _grad_err(got_g, want_g) < grad_tol


@pytest.mark.parametrize("seam", [True, False])
def test_forward_and_gradients_match_flax(seam):
    """Seam on: both sides round the seam's operands to bf16, and f32
    inputs that differ in their last bits (BN statistics summed in another
    order) can round to neighbouring bf16 values; the JAX package's own
    jitted and eager forwards differ by 3e-4 for that reason. Hence atol
    2e-3 on the output and 5e-2 of the largest gradient. Seam off: f32
    throughout, 2e-5."""
    _compare_with_flax(seam)


def test_seam_carry_matches_flax(monkeypatch):
    """seam_carry on both sides: the skip-branch conv result enters each
    seam as its carry-in (the Pallas kernel's epilogue add, in interpret
    mode, against fwd_plain's add), and d(carry) flows back to the skip
    branch. Tolerances as with the seam on. Both decoder seams take a
    carry on the port's side."""
    carries = []
    plain = hopper_up_conv.fwd_plain

    def counting(xp, e, carry=None):
        carries.append(carry is not None)
        return plain(xp, e, carry)

    monkeypatch.setattr(hopper_up_conv, "fwd_plain", counting)
    _compare_with_flax(True, carry=True)
    assert carries == [True, True]


@pytest.mark.parametrize("up_mode", ["bilinear", "nearest"])
def test_fold_bn_and_fuse_concat_are_exact(up_mode):
    """fold_bn and fuse_concat on and off, with the seam off: the same
    function of the same weights, forward and gradients."""
    cfg = dict(num_input_channels=4, num_channels_down=[16, 16],
               num_channels_up=[16, 16], num_channels_skip=[4, 4],
               upsample_mode=up_mode, pad="reflection", up_conv=False)
    rng = np.random.default_rng(1)
    z = torch.from_numpy(rng.normal(size=(1, 16, 16, 4)).astype(np.float32))
    tgt = torch.from_numpy(rng.random((1, 16, 16, 3)).astype(np.float32))
    ref = Skip(fold_bn=False, fuse_concat=False, **cfg)
    ref.reset_parameters(torch.Generator().manual_seed(2))

    def run(model):
        out = model(z)
        grads = torch.autograd.grad(torch.mean((out - tgt) ** 2), list(model.parameters()))
        return out.detach(), {k: g for (k, _), g in zip(model.named_parameters(), grads)}

    want_out, want_g = run(ref)
    g_max = max(g.abs().max() for g in want_g.values())
    for fold_bn, fuse_concat in ((True, True), (True, False), (False, True)):
        model = Skip(fold_bn=fold_bn, fuse_concat=fuse_concat, **cfg)
        model.load_state_dict(ref.state_dict())
        out, grads = run(model)
        torch.testing.assert_close(out, want_out, atol=1e-5, rtol=1e-5)
        for k, g in grads.items():
            assert (g - want_g[k]).abs().max() <= 1e-5 * g_max, k


def test_seam_on_and_off_agree_to_bf16_rounding():
    """The fused seam (plain versions on the CPU) against the materialised
    upsample -> pad -> conv path, same weights."""
    rng = np.random.default_rng(3)
    z = torch.from_numpy((rng.normal(size=(1, 32, 32, 8)) * 0.1).astype(np.float32))
    on = Skip(num_input_channels=8, **CFG)
    on.reset_parameters(torch.Generator().manual_seed(4))
    off = Skip(num_input_channels=8, up_conv=False, **CFG)
    off.load_state_dict(on.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(on(z), off(z), atol=2e-3, rtol=0)
