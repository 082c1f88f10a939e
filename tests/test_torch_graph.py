"""The fit engine's CUDA graph on the card: the graphed chunk against eager
steps, and a queued fit against the same fit alone. Both need a CUDA
device and skip without one (chip_smoke.py's [graph], [queue] and [ckpt]
lines run the same checks on the flagship)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dip_tpu_torch.fit import engine as teng  # noqa: E402
from dip_tpu_torch.models import Skip  # noqa: E402
from dip_tpu_torch.ops import launches  # noqa: E402
from dip_tpu_torch.ops.losses import mse, psnr  # noqa: E402
from dip_tpu_torch.parallel import FitQueue  # noqa: E402
from dip_tpu_torch.tasks.base import TaskSpec, run_task, start_task  # noqa: E402

SMALL = dict(num_channels_down=[128] * 2, num_channels_up=[128] * 2, num_channels_skip=[4] * 2,
             upsample_mode="bilinear", pad="reflection")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run python3 chip_smoke.py on the card)")
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield torch.device("cuda", 0)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _spec(**cfg) -> TaskSpec:
    rng = np.random.default_rng(0)
    tgt = torch.from_numpy(rng.random((1, 32, 32, 3)).astype(np.float32))
    cfg = teng.FitConfig(**dict(dict(num_iter=6, log_every=3, reg_noise_std=0.05,
                                     param_noise=True, exp_weight=0.9, backtrack=True,
                                     compute_dtype="bfloat16"), **cfg))
    return TaskSpec(name="small", model=Skip(num_input_channels=8, **SMALL), cfg=cfg,
                    loss_fn=lambda p, o, a: mse(o, a), aux=tgt,
                    metrics_fn=lambda o, e, a: {"psnr_track": psnr(o, a)},
                    input_depth=8, spatial_size=(32, 32))


@pytest.mark.cuda
def test_graphed_chunks_equal_eager_steps(card):
    """Engine.run (one eager step, its capture, then replays, over two
    chunks) against as many Engine.step calls from the same seeds: every
    metric, param and the EMA bit for bit, and the same kernel launches."""
    spec = _spec()
    launches.reset()
    eng, state, aux = start_task(dataclasses.replace(spec, model=Skip(num_input_channels=8,
                                                                      **SMALL)), 0, device=card)
    eager = [eng.step(state, aux)[1] for _ in range(6)]
    torch.cuda.synchronize()
    eager_launches = launches.counts()
    launches.reset()
    geng, gstate, gaux = start_task(spec, 0, device=card)
    gstate, hist = geng.run(gstate, gaux)
    torch.cuda.synchronize()
    assert gstate.graph is not None and launches.counts() == eager_launches
    for k in hist:
        np.testing.assert_array_equal(hist[k], torch.stack([m[k] for m in eager]).cpu().numpy(),
                                      err_msg=k)
    for k in state.params:
        assert torch.equal(gstate.params[k], state.params[k]), k
    assert torch.equal(gstate.ema_out, state.ema_out)


@pytest.mark.cuda
def test_queued_fit_equals_the_fit_alone(card):
    """Two jobs on their own streams; each equals run_task of its spec and
    seed, bit for bit."""
    spec = _spec(optimizer="sgd", lr=0.05)
    q = FitQueue()
    q.add(spec, 0, name="a", device=card).add(spec, 1, name="b", device=card)
    res = q.run()
    for name, seed in (("a", 0), ("b", 1)):
        out, state, hist = run_task(dataclasses.replace(spec, model=Skip(
            num_input_channels=8, **SMALL)), seed, device=card)
        assert torch.equal(res[name][0], out), name
        for k in hist:
            np.testing.assert_array_equal(res[name][2][k], hist[k], err_msg=k)
    assert not torch.equal(res["a"][1].params["convs.0.weight"],
                           res["b"][1].params["convs.0.weight"])


@pytest.mark.cuda
def test_sequential_fits_hand_their_graph_memory_back(card):
    """26 graphed 512^2 flagship fits one after another, each dropped when
    it ends: each graph's pool (about 4 GiB) goes back to the card before
    the next capture (a capture cannot free memory; before each one the
    engine returns the pools of graphs that are gone), so the card's
    reserved memory grows by far less than a pool a fit."""
    from dip_tpu_torch.bench import synthetic_noisy
    from dip_tpu_torch.tasks import denoise

    clean, noisy = synthetic_noisy(512)
    reserved = []
    for seed in range(26):
        spec = denoise.task(noisy, "f16", gt=clean, num_iter=6)
        spec = dataclasses.replace(spec, cfg=dataclasses.replace(
            spec.cfg, compute_dtype="bfloat16", log_every=6))
        out, state, _ = run_task(spec, seed, device=card)
        assert torch.isfinite(out).all()
        del out, state
        reserved.append(torch.cuda.memory_reserved(card))
    growth = (reserved[-1] - reserved[1]) / (len(reserved) - 2) / 2**30
    assert growth < 0.25, [round(r / 2**30, 2) for r in reserved]
