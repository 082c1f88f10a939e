"""The port's fit engine and tasks against the JAX package's, on the CPU."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dip_tpu.fit import engine as jeng  # noqa: E402
from dip_tpu.models import Skip as FlaxSkip  # noqa: E402
from dip_tpu.ops import dispatch  # noqa: E402
from dip_tpu.ops.losses import mse as jmse  # noqa: E402
from dip_tpu_torch import interop  # noqa: E402
from dip_tpu_torch.fit import engine as teng  # noqa: E402
from dip_tpu_torch.models import Skip  # noqa: E402
from dip_tpu_torch.ops.losses import mse as tmse, psnr as tpsnr  # noqa: E402
from dip_tpu_torch.tasks import denoise  # noqa: E402
from dip_tpu_torch.tasks.base import run_task  # noqa: E402

SMALL = dict(num_channels_down=[8, 16], num_channels_up=[8, 16],
             num_channels_skip=[4, 4], upsample_mode="bilinear", pad="reflection")


def _data(seed=0, size=32, depth=4):
    rng = np.random.default_rng(seed)
    z = (rng.random((1, size, size, depth)) * 0.1).astype(np.float32)
    tgt = rng.random((1, size, size, 3)).astype(np.float32)
    return z, tgt


@pytest.mark.parametrize("threshold", [5.0, -0.5])
def test_trajectory_matches_jax_engine(threshold):
    """5 steps with jitter off (the RNG streams cannot match), EMA and
    backtracking on, the seam off on both sides (f32 throughout). With
    threshold -0.5 every step that does not raise the tracked PSNR by
    0.5 dB is rolled back, so the restore path runs too. Compared by
    loss and metrics per step (rtol 1e-3) and by the rendered output
    (its MSE to the target, rtol 1e-3, and PSNR > 35 dB against the JAX
    render; 43.7 dB seen). Not elementwise: the scale of a BN that feeds
    another BN has a gradient that is rounding noise at init, which
    Adam's first step turns into a +-lr step, different on each side;
    it stops being harmless once the BN's bias has moved."""
    z, tgt = _data()
    cfg_kw = dict(num_iter=5, lr=0.01, reg_noise_std=0.0, exp_weight=0.99,
                  backtrack=True, backtrack_threshold=threshold, log_every=5)
    fmodel = FlaxSkip(**SMALL)
    je = jeng.Engine(fmodel, lambda p, out, aux: jmse(out, aux), jeng.FitConfig(**cfg_kw),
                     jeng.default_metrics(jnp.asarray(tgt)))
    with dispatch.override(up_conv="off"):
        jstate = je.init_state(jax.random.key(0), jnp.asarray(z))
        init = jax.tree_util.tree_map(np.asarray, jstate.params["net"])
        jstate, jhist = je.run(jstate, jnp.asarray(tgt))
        jout = np.array(je.render(jstate))

    te = teng.Engine(Skip(num_input_channels=4, up_conv=False, **SMALL),
                     lambda p, out, aux: tmse(out, aux), teng.FitConfig(**cfg_kw),
                     teng.default_metrics(torch.from_numpy(tgt)), device="cpu")
    tstate = te.init_state(0, torch.from_numpy(z))
    te.model.load_state_dict(interop.flax_to_state_dict(init))
    tstate.snapshot = {k: p.detach().clone() for k, p in tstate.params.items()}
    tstate, thist = te.run(tstate, torch.from_numpy(tgt))
    tout = te.render(tstate).numpy()

    assert set(thist) == set(jhist) == {"loss", "psnr_track", "backtracked"}
    for k in ("loss", "psnr_track"):
        np.testing.assert_allclose(thist[k], np.asarray(jhist[k]), rtol=1e-3, err_msg=k)
    np.testing.assert_array_equal(thist["backtracked"], np.asarray(jhist["backtracked"]))
    if threshold < 0:
        assert thist["backtracked"].sum() >= 1
    # the render's fit to the target, and the render itself by PSNR
    np.testing.assert_allclose(np.mean((tout - tgt) ** 2), np.mean((jout - tgt) ** 2),
                               rtol=1e-3)
    assert tpsnr(torch.from_numpy(tout), torch.from_numpy(jout)).item() > 35.0


class _Identity(torch.nn.Module):
    """out = z, with one unused parameter for the optimizer."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))

    def reset_parameters(self, generator):
        del generator

    def forward(self, z):
        return z + 0.0 * self.w


def test_jitter_statistics():
    """Input jitter z + N(0,1)*std: mean 0 and std `std` over 64*64*3
    samples, a fresh draw every step, z itself unchanged."""
    std = 0.2
    z = torch.from_numpy(_data(size=64, depth=3)[0])
    cfg = teng.FitConfig(num_iter=4, reg_noise_std=std, log_every=4)
    eng = teng.Engine(_Identity(), lambda p, out, aux: torch.mean(out * 0.0), cfg,
                      lambda out, ema, aux: {"mean": torch.mean(out - aux),
                                             "std": torch.std(out - aux),
                                             "first": (out - aux)[0, 0, 0, 0]},
                      device="cpu")
    state = eng.init_state(0, z)
    state, hist = eng.run(state, z)
    assert np.all(np.abs(hist["mean"]) < 0.02 * std)
    assert np.all(np.abs(hist["std"] - std) < 0.03 * std)
    assert len(set(hist["first"].tolist())) == 4
    torch.testing.assert_close(state.z, z, rtol=0, atol=0)


def test_bf16_path_within_psnr_of_f32():
    """compute_dtype='bfloat16' (params and z cast each step, f32 master
    params, seam on) against f32 from the same weights: the first forward
    within 40 dB PSNR (49.5 seen), and after 20 steps a fit to the target
    within 1.5 dB of f32's (0.7 dB seen). The trajectories themselves part
    (Adam on bf16-class gradient noise), so they are not compared."""
    z = (np.random.default_rng(0).random((1, 32, 32, 8)) * 0.1).astype(np.float32)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    tgt = np.stack([np.sin(xx / 5) * 0.5 + 0.5, np.cos(yy / 4) * 0.5 + 0.5,
                    (xx + yy) / 64], -1)[None].astype(np.float32)
    first, fit = {}, {}
    for cd in (None, "bfloat16"):
        model = Skip(num_input_channels=8, **dict(SMALL, num_channels_down=[128] * 2,
                                                   num_channels_up=[128] * 2))
        cfg = teng.FitConfig(num_iter=20, exp_weight=0.99, log_every=20, compute_dtype=cd)
        eng = teng.Engine(model, lambda p, out, aux: tmse(out, aux), cfg, device="cpu")
        state = eng.init_state(0, torch.from_numpy(z))
        first[cd] = eng.render(state)
        state, hist = eng.run(state, torch.from_numpy(tgt))
        assert np.all(np.isfinite(hist["loss"])) and hist["loss"][-1] < 0.1 * hist["loss"][0]
        out = eng.render(state)
        assert out.dtype == torch.float32 and tuple(out.shape) == (1, 32, 32, 3)
        assert all(p.dtype == torch.float32 for p in state.params.values())
        fit[cd] = tpsnr(out, torch.from_numpy(tgt)).item()
    assert tpsnr(first["bfloat16"], first[None]).item() > 40.0
    assert abs(fit["bfloat16"] - fit[None]) < 1.5


def test_run_task_denoise_on_cpu():
    rng = np.random.default_rng(0)
    clean = rng.random((1, 64, 64, 3)).astype(np.float32)
    noisy = denoise.get_noisy_image(clean, 25 / 255, rng)
    spec = denoise.task(noisy, "f16", gt=clean, num_iter=3)
    spec = dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, log_every=2))
    seen = []
    out, state, hist = run_task(spec, 0, device="cpu",
                                callback=lambda it, h, s: seen.append(it))
    assert seen == [2, 3]
    assert tuple(out.shape) == (1, 64, 64, 3) and torch.isfinite(out).all()
    assert set(hist) == {"loss", "psnr_track", "psnr_gt", "psnr_gt_sm", "backtracked"}
    assert all(len(v) == 3 for v in hist.values())
    assert state.step == 3


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.Engine(Skip(), lambda p, out, aux: tmse(out, aux), teng.FitConfig(),
                    device="cuda")


def test_port_imports_no_jax():
    code = ("import sys, dip_tpu_torch, dip_tpu_torch.interop, dip_tpu_torch.bench, "
            "dip_tpu_torch.tasks.denoise, dip_tpu_torch.ops.hopper_up_conv, "
            "dip_tpu_torch.tasks.super_resolve, dip_tpu_torch.eval.sr_eval, "
            "dip_tpu_torch.ops.hopper_resample, dip_tpu_torch.models.downsampler, "
            "dip_tpu_torch.fit.checkpoint, dip_tpu_torch.parallel, dip_tpu_torch.tasks, "
            "dip_tpu_torch.tasks.flash_no_flash, dip_tpu_torch.ops.launches, "
            "dip_tpu_torch.fit.lbfgs, dip_tpu_torch.models.unet, dip_tpu_torch.models.resnet, "
            "dip_tpu_torch.models.texture_nets, dip_tpu_torch.models.dcgan, "
            "dip_tpu_torch.pretrained, dip_tpu_torch.pretrained.perceptual, "
            "dip_tpu_torch.tasks.feature_inversion, dip_tpu_torch.tasks.activation_maximization, "
            "dip_tpu_torch.cli.main, dip_tpu_torch.data.imagenet_classes, "
            "dip_tpu_torch.utils.profiling, dip_tpu_torch.__main__; "
            "assert 'jax' not in sys.modules and 'flax' not in sys.modules, "
            "sorted(m for m in sys.modules if 'jax' in m)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
