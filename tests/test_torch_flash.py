"""Flash/no-flash in the port against the JAX task, on the CPU: the spec,
the per-scale up modes, and the fit's steps with the fused seam on both
sides."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dip_tpu.fit import engine as jeng  # noqa: E402
from dip_tpu.models import Skip as FlaxSkip  # noqa: E402
from dip_tpu.ops import dispatch, pallas_up_conv  # noqa: E402
from dip_tpu.tasks import flash_no_flash as jflash  # noqa: E402
from dip_tpu.tasks.base import make_input as jmake_input  # noqa: E402
from dip_tpu_torch import interop  # noqa: E402
from dip_tpu_torch.fit import engine as teng  # noqa: E402
from dip_tpu_torch.models import Skip  # noqa: E402
from dip_tpu_torch.tasks import flash_no_flash as tflash  # noqa: E402
from dip_tpu_torch.tasks.base import make_input, run_task, to_device  # noqa: E402

# 2 scales of 128 channels at 32^2: both decoder seams (LR 8 and 16) take
# the fused path on both sides, one per up mode the recipe mixes
SMALL = dict(num_channels_down=[128] * 2, num_channels_up=[128] * 2, num_channels_skip=[4] * 2,
             upsample_mode=["nearest", "bilinear"], pad="reflection")


def _images(size=32):
    rng = np.random.default_rng(0)
    flash = rng.random((1, size, size, 3)).astype(np.float32)
    noflash = np.clip(flash * 0.6 + rng.normal(scale=0.02, size=flash.shape), 0, 1)
    return flash, noflash.astype(np.float32)


def test_spec_matches_jax_task():
    """The recipe's fields, the flash image as z, and which scale gets
    which up mode: nearest at the two top scales, bilinear below."""
    flash, noflash = _images()
    j, t = jflash.task(flash, noflash), tflash.task(flash, noflash)
    assert t.name == j.name == "flash_no_flash"
    for f in ("num_iter", "lr", "reg_noise_std", "optimizer", "exp_weight", "backtrack"):
        assert getattr(t.cfg, f) == getattr(j.cfg, f), f
    assert (t.cfg.num_iter, t.cfg.lr) == (601, 0.1)
    assert t.spatial_size is j.spatial_size is None and t.input_depth == j.input_depth
    np.testing.assert_array_equal(t.net_input.numpy(), np.asarray(j.net_input))
    assert set(t.aux) == set(j.aux) == {"noflash"}
    np.testing.assert_array_equal(t.aux["noflash"].numpy(), np.asarray(j.aux["noflash"]))
    assert t.model.up_modes == list(j.model.upsample_mode) == tflash.UP_MODES
    assert t.model.up_modes == ["nearest", "nearest", "bilinear", "bilinear", "bilinear"]
    assert t.model.ch_skip == list(j.model.num_channels_skip) == [4] * 5
    assert t.model.pad == j.model.pad == "reflection"
    assert t.model.num_output_channels == j.model.num_output_channels == 3
    assert t.model.convs[0].weight.shape[1] == 3  # the flash image's channels in
    z = make_input(t, torch.Generator().manual_seed(0), "cpu")
    np.testing.assert_array_equal(z.numpy(), np.asarray(jmake_input(j, jax.random.key(0))))


def _grad_err(got: dict, want: dict) -> float:
    """Largest gradient error over the net, relative to its largest
    gradient (as tests/test_torch_skip.py measures it)."""
    g_max = max(float(np.abs(w).max()) for w in want.values())
    return max(float(np.abs(got[k] - want[k]).max()) for k in want) / g_max


def test_steps_match_jax_with_the_seam_on():
    """5 steps of the JAX Engine on the flash recipe (2 scales, nearest
    then bilinear, both seams fused, the Pallas kernels in interpret
    mode); at each step's params the port's forward and gradients (the
    seam's plain versions) against the JAX package's, under the seam-on
    tolerances of tests/test_torch_skip.py: output atol 2e-3, every
    gradient within 5e-2 of the largest, and the loss at rtol 1e-3. Each
    step is held at the JAX trajectory's params: with the seam on, the two
    packages round nearly equal seam inputs to neighbouring bf16 values,
    and Adam turns the gradients that differ by that rounding (the scale
    of a BN feeding a BN is rounding noise) into +-lr steps, so two free
    runs part. lr 1e-3 (ROADMAP queue C: trajectory parity runs at 1e-3)
    keeps the params at the init's scale, where the skip tests fix those
    tolerances; the recipe's 0.1 would leave it in one step."""
    flash, noflash = _images()
    for h in (8, 16):
        assert pallas_up_conv.seam_ok(1, h, h, 128, 128, 4)
    spec = jflash.task(flash, noflash)
    spec = dataclasses.replace(spec, model=FlaxSkip(**SMALL), cfg=dataclasses.replace(
        spec.cfg, num_iter=5, lr=1e-3, log_every=5))
    je = jeng.Engine(spec.model, spec.loss_fn, spec.cfg, spec.metrics_fn)
    z = jnp.asarray(flash)
    tgt = jnp.asarray(noflash)

    def loss_of(p):
        out = spec.model.apply({"params": p}, z)
        return jnp.mean((out - tgt) ** 2), out

    with dispatch.override(up_conv="on"):
        state = je.init_state(jax.random.key(0), z)
        step = jax.jit(je.step)
        grad = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
        points, losses = [], []
        for _ in range(5):
            params = jax.tree_util.tree_map(np.asarray, state.params["net"])
            (_, out), g = grad(state.params["net"])
            points.append((params, np.asarray(out), g))
            state, m = step(state, spec.aux)
            losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]

    tspec = tflash.task(flash, noflash)
    model = Skip(num_input_channels=3, **SMALL)
    assert model.up_modes == ["nearest", "bilinear"]
    for i, (params, want_out, want_g) in enumerate(points):
        model.load_state_dict(interop.flax_to_state_dict(params))
        model.zero_grad(set_to_none=True)
        out = model(tspec.net_input)
        loss = tspec.loss_fn(None, out, tspec.aux)
        loss.backward()
        want_g = {k: v.numpy() for k, v in interop.flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, want_g)).items()}
        got_g = {k: p.grad.numpy() for k, p in model.named_parameters()}
        np.testing.assert_allclose(out.detach().numpy(), want_out, atol=2e-3, rtol=0,
                                   err_msg=f"step {i}")
        assert _grad_err(got_g, want_g) < 5e-2, i
        np.testing.assert_allclose(loss.item(), losses[i], rtol=1e-3, err_msg=f"step {i}")


def test_run_task_takes_net_input_and_postprocess():
    """run_task fits from the spec's own z whatever the seed (which seeds
    the weights alone) and hands the render through postprocess."""
    flash, noflash = _images(64)
    spec = tflash.task(flash, noflash, num_iter=3)
    spec = dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, lr=1e-2, log_every=3),
                               postprocess=lambda out: out[..., :1])
    for seed in (0, 9):
        out, state, hist = run_task(spec, seed, device="cpu")
        assert tuple(out.shape) == (1, 64, 64, 1) and torch.isfinite(out).all()
        np.testing.assert_array_equal(state.z.numpy(), flash)
        assert set(hist) == {"loss", "psnr_track"} and len(hist["loss"]) == 3
    eng = teng.Engine(spec.model, spec.loss_fn, spec.cfg, spec.metrics_fn, device="cpu")
    assert torch.equal(make_input(spec, torch.Generator(), eng.device),
                       to_device(spec.net_input, eng.device))
