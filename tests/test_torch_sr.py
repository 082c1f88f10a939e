"""The port's super-resolution task, fit and eval against the JAX package's,
on the CPU, from the same numpy inputs and the same initial weights.

Tolerances: the host data preparation is the same PIL and numpy code on
both sides, so it is compared exactly. Five-step trajectories (jitter off,
since the two RNG streams cannot match; the seam off on both sides, so f32
throughout) compare loss and metrics per step at rtol 1e-3, as
tests/test_torch_engine.py does for denoising: BN statistics summed in
another order move the trajectories apart slowly. Without a net (the
identity net, no BN) rtol 1e-4.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from dip_tpu.eval import sr_eval as jeval  # noqa: E402
from dip_tpu.fit import engine as jeng  # noqa: E402
from dip_tpu.models import Skip as FlaxSkip  # noqa: E402
from dip_tpu.ops import dispatch  # noqa: E402
from dip_tpu.tasks import super_resolve as jsr  # noqa: E402
from dip_tpu_torch import interop  # noqa: E402
from dip_tpu_torch.eval import sr_eval as teval  # noqa: E402
from dip_tpu_torch.fit import engine as teng  # noqa: E402
from dip_tpu_torch.models import Skip  # noqa: E402
from dip_tpu_torch.tasks import super_resolve as tsr  # noqa: E402

SMALL = dict(num_channels_down=[8, 16], num_channels_up=[8, 16],
             num_channels_skip=[4, 4], upsample_mode="bilinear", pad="reflection")


def _png(path, h, w, seed):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([np.sin(xx / 7) * 0.5 + 0.5, np.cos(yy / 5) * 0.5 + 0.5,
                    (xx + yy) / (h + w)], -1)
    img = img + np.random.default_rng(seed).random(img.shape) * 0.1
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)
    return str(path)


def test_host_data_matches_jax(tmp_path):
    path = _png(tmp_path / "a.png", 75, 101, 0)
    want, got = jsr.load_lr_hr(path, factor=4), tsr.load_lr_hr(path, factor=4)
    assert set(got) == set(want)
    for k in ("orig_np", "HR_np", "LR_np"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["HR_np"].shape == (64, 96, 3) and got["LR_np"].shape == (16, 24, 3)
    for g, w in zip(tsr.get_baselines(got["LR_pil"], got["HR_pil"]),
                    jsr.get_baselines(want["LR_pil"], want["HR_pil"])):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tsr.put_in_center(got["LR_np"], (20, 30)),
                                  jsr.put_in_center(want["LR_np"], (20, 30)))


def test_image_io_matches_jax(tmp_path):
    """get_image (as is, and resized down and up), crop_image, and a
    save -> load round trip, against dip_tpu/utils/image_io.py."""
    from dip_tpu.utils import image_io as jio
    from dip_tpu_torch.utils import image_io as tio

    path = _png(tmp_path / "b.png", 50, 70, 1)
    for size in (-1, 32, (96, 64)):
        (jp, ja), (tp, ta) = jio.get_image(path, size), tio.get_image(path, size)
        np.testing.assert_array_equal(ta, ja)
        assert tp.size == jp.size
    np.testing.assert_array_equal(tio.pil_to_np(tio.crop_image(tp, 32)),
                                  jio.pil_to_np(jio.crop_image(jp, 32)))
    tio.save_image(str(tmp_path / "c.png"), ta)
    np.testing.assert_array_equal(tio.pil_to_np(tio.load_image(str(tmp_path / "c.png"))), ta)
    np.testing.assert_array_equal(tio.nhwc_to_hwc(torch.from_numpy(tio.hwc_to_nhwc(ta))), ta)


@pytest.mark.parametrize("kwargs", [
    dict(factor=4), dict(factor=8), dict(factor=2, reg_noise_std=0.1, num_iter=7),
    dict(factor=2, learnable_downsampler=True), dict(factor=4, net="identity"),
    dict(factor=3, tv_weight=1e-3, kernel_type="lanczos3"),
])
def test_spec_fields_match_jax(kwargs):
    lr = np.random.default_rng(0).random((1, 8, 6, 3)).astype(np.float32)
    j, t = jsr.task(lr, **kwargs), tsr.task(lr, **kwargs)
    assert t.name == j.name
    assert (t.input_depth, t.spatial_size) == (j.input_depth, j.spatial_size)
    for f in ("num_iter", "lr", "reg_noise_std", "backtrack", "opt_input", "opt_over",
              "exp_weight", "optimizer"):
        assert getattr(t.cfg, f) == getattr(j.cfg, f), f
    np.testing.assert_array_equal(t.aux["lr"].numpy(), lr)
    if kwargs.get("learnable_downsampler"):
        np.testing.assert_array_equal(t.extra_params["down"].numpy(),
                                      np.asarray(j.extra_params["down"]["kernel"]))
    else:
        assert t.extra_params is None and j.extra_params is None
    assert type(t.model).__name__ == type(j.model).__name__


def _trajectories(kwargs, hr=32, steps=5):
    """Run the JAX and the port's SR fit for `steps` steps from the same z
    and initial trainable set; return their histories, final states'
    trainable sets (numpy) and renders."""
    factor = kwargs.get("factor", 4)
    rng = np.random.default_rng(1)
    lr = rng.random((1, hr // factor, hr // factor, 3)).astype(np.float32)
    gt = rng.random((1, hr, hr, 3)).astype(np.float32)
    jspec, tspec = jsr.task(lr, hr_gt=gt, **kwargs), tsr.task(lr, hr_gt=gt, **kwargs)
    skip = kwargs.get("net", "skip") == "skip"
    if skip:
        jspec = dataclasses.replace(jspec, model=FlaxSkip(**SMALL))
        tspec = dataclasses.replace(tspec, model=Skip(num_input_channels=32, up_conv=False,
                                                      **SMALL))
    z = (rng.random((1, hr, hr, jspec.input_depth)) * 0.1).astype(np.float32)
    over = dict(num_iter=steps, reg_noise_std=0.0, log_every=steps)

    je = jeng.Engine(jspec.model, jspec.loss_fn, dataclasses.replace(jspec.cfg, **over),
                     jspec.metrics_fn)
    with dispatch.override(up_conv="off"):
        jstate = je.init_state(jax.random.key(0), jnp.asarray(z), None, jspec.extra_params)
        init = jax.tree_util.tree_map(np.asarray, jstate.params)
        jstate, jhist = je.run(jstate, jspec.aux)
        jout = np.array(je.render(jstate))
    jfinal = interop.flax_trainable_to_torch(jax.tree_util.tree_map(np.asarray,
                                                                     jstate.params))

    te = teng.Engine(tspec.model, tspec.loss_fn, dataclasses.replace(tspec.cfg, **over),
                     tspec.metrics_fn, device="cpu")
    tstate = te.init_state(0, torch.from_numpy(z), tspec.extra_params)
    start = interop.flax_trainable_to_torch(init)
    assert set(start) == set(tstate.params)
    with torch.no_grad():
        for k, v in start.items():
            tstate.params[k].copy_(v)
    tstate.snapshot = {k: p.detach().clone() for k, p in tstate.params.items()}
    tstate, thist = te.run(tstate, tspec.aux)
    tout = te.render(tstate).numpy()
    return jhist, thist, jfinal, tstate.params, jout, tout


def _assert_hist_close(jhist, thist, rtol):
    assert set(thist) == set(jhist)
    for k in ("loss", "psnr_track", "psnr_lr", "psnr_hr"):
        np.testing.assert_allclose(thist[k], np.asarray(jhist[k]), rtol=rtol, err_msg=k)
    if "backtracked" in jhist:
        np.testing.assert_array_equal(thist["backtracked"], np.asarray(jhist["backtracked"]))


@pytest.mark.parametrize("kwargs", [dict(factor=4), dict(factor=4, tv_weight=1e-4),
                                    dict(factor=8)], ids=["backtrack", "tv", "x8"])
def test_sr_trajectory_matches_jax(kwargs):
    jhist, thist, _, _, jout, tout = _trajectories(kwargs)
    assert "backtracked" in thist
    _assert_hist_close(jhist, thist, 1e-3)
    assert 10 * np.log10(1 / np.mean((tout - jout) ** 2)) > 35.0


def test_learnable_downsampler_trajectory_matches_jax():
    """opt_over='net,down' at factor 2 (the 8x8 kernel): the metrics, and
    the learned kernels at the end (atol 1e-5 on taps that sum to 1)."""
    jhist, thist, jfinal, tfinal, _, _ = _trajectories(dict(factor=2,
                                                            learnable_downsampler=True))
    _assert_hist_close(jhist, thist, 1e-3)
    k0 = tsr.LearnableDownsampler(2).kernel.detach().numpy()
    assert np.abs(tfinal["down"].detach().numpy() - k0).max() > 1e-3  # it moved
    np.testing.assert_allclose(tfinal["down"].detach().numpy(), jfinal["down"].numpy(),
                               atol=1e-5, rtol=0)


def test_identity_trajectory_matches_jax():
    """net='identity': the HR pixels themselves are the trainable z
    (opt_input), no backtracking; the render is that z."""
    jhist, thist, jfinal, tfinal, jout, tout = _trajectories(dict(factor=4, net="identity"))
    _assert_hist_close(jhist, thist, 1e-4)
    np.testing.assert_allclose(tfinal["input"].detach().numpy(), jfinal["input"].numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=0)


def test_psnr_y_bbox_protocol_matches_jax():
    rng = np.random.default_rng(2)
    gt = rng.random((40, 48, 3)).astype(np.float32)
    pred = np.zeros_like(gt)
    pred[3:37, 5:45] = gt[3:37, 5:45] + rng.normal(size=(34, 40, 3)).astype(np.float32) * 0.05
    for ref in (None, gt):
        np.testing.assert_allclose(teval.psnr_y_bbox_protocol(gt, pred, ref),
                                   jeval.psnr_y_bbox_protocol(gt, pred, ref), rtol=1e-5)


def test_eval_sr_dataset_end_to_end(tmp_path):
    """Two small PNGs through load -> task (Skip 5x128) -> run_task on the
    CPU -> the bbox protocol, two steps each."""
    _png(tmp_path / "one.png", 70, 66, 3)
    _png(tmp_path / "two.png", 64, 100, 4)
    res = teval.eval_sr_dataset(str(tmp_path), factor=4, num_iter=2, verbose=False,
                                device="cpu")
    assert list(res.per_image) == ["one", "two"]
    assert all(np.isfinite(v) and v > 0 for v in res.per_image.values())
    assert res.mean_psnr_y == pytest.approx(np.mean(list(res.per_image.values())))
    assert res.latex_row("x").startswith("\\small{x} & $")


def test_sr_imports_and_builds_without_pil_or_jax():
    code = ("import sys; sys.modules['PIL'] = None\n"
            "import numpy as np\n"
            "import dip_tpu_torch.eval.sr_eval, dip_tpu_torch.utils.image_io\n"
            "from dip_tpu_torch.tasks import super_resolve as sr\n"
            "spec = sr.task(np.zeros((1, 8, 8, 3), np.float32), 4)\n"
            "assert spec.spatial_size == (32, 32)\n"
            "try:\n"
            "    sr.load_lr_hr('missing.png')\n"
            "    raise SystemExit('PIL was not needed')\n"
            "except ImportError:\n"
            "    pass\n"
            "assert 'jax' not in sys.modules and 'flax' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
