"""The port's FitQueue on the CPU: the callback order, each job against
the same fit alone, separate weights per job, and the loss histories
against the JAX FitQueue on the same weights."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dip_tpu.fit.engine import FitConfig as JFitConfig  # noqa: E402
from dip_tpu.models import Skip as FlaxSkip  # noqa: E402
from dip_tpu.ops import dispatch  # noqa: E402
from dip_tpu.ops.losses import mse as jmse, psnr as jpsnr  # noqa: E402
from dip_tpu.parallel.queue import FitQueue as JFitQueue  # noqa: E402
from dip_tpu.tasks.base import TaskSpec as JTaskSpec  # noqa: E402
from dip_tpu_torch import interop  # noqa: E402
from dip_tpu_torch.fit.engine import FitConfig  # noqa: E402
from dip_tpu_torch.models import Skip  # noqa: E402
from dip_tpu_torch.ops.losses import mse, psnr  # noqa: E402
from dip_tpu_torch.parallel import FitQueue  # noqa: E402
from dip_tpu_torch.tasks.base import TaskSpec, run_task  # noqa: E402

S = 16


def _spec(level: float, model=None, **cfg) -> TaskSpec:
    model = model or Skip(num_input_channels=4, num_channels_down=[8], num_channels_up=[8],
                          num_channels_skip=[2])
    cfg = FitConfig(**dict(dict(num_iter=40, lr=0.02, log_every=20), **cfg))
    return TaskSpec(name=f"const{level}", model=model, cfg=cfg,
                    loss_fn=lambda p, o, a: mse(o, a), aux=torch.full((1, S, S, 3), level),
                    metrics_fn=lambda o, e, a: {"psnr_track": psnr(o, a)},
                    input_depth=4, spatial_size=(S, S))


def test_round_robin_callbacks_and_fits():
    """As the JAX queue's test: callbacks interleave a@20, b@20, a@40,
    b@40, histories are full length, each job fits its own target."""
    seen = []
    q = FitQueue(callback=lambda name, it, hist: seen.append((name, it, len(hist["loss"]))))
    q.add(_spec(0.25), 0, name="a", device="cpu")
    q.add(_spec(0.75), 1, name="b", device="cpu")
    res = q.run()
    assert seen == [("a", 20, 20), ("b", 20, 20), ("a", 40, 20), ("b", 40, 20)]
    for name, level in (("a", 0.25), ("b", 0.75)):
        out, state, hist = res[name]
        assert hist["loss"].shape == (40,) and hist["loss"][-1] < hist["loss"][0]
        assert abs(out.mean().item() - level) < 0.15
        assert state.step == 40


def test_each_job_equals_the_fit_alone():
    """A queued job (input jitter, EMA, backtracking, a postprocess on)
    equals run_task of the same spec and seed, bit for bit."""
    spec = dataclasses.replace(
        _spec(0.5, num_iter=6, log_every=4, reg_noise_std=0.05, exp_weight=0.9, backtrack=True),
        postprocess=lambda out: out * 2.0)
    q = FitQueue()
    q.add(spec, 3, name="a", device="cpu").add(_spec(0.1), 4, name="b", device="cpu")
    out_q, state_q, hist_q = q.run()["a"]
    out, state, hist = run_task(spec, 3, device="cpu")
    assert torch.equal(out_q, out)
    for k in hist:
        np.testing.assert_array_equal(hist_q[k], hist[k], err_msg=k)
    for k in state.params:
        assert torch.equal(state_q.params[k], state.params[k]), k


def test_jobs_on_one_model_keep_separate_weights():
    """Two jobs from one spec.model train copies of it: their params are
    other tensors than each other's and than the spec's model's, and end
    apart."""
    model = Skip(num_input_channels=4, num_channels_down=[8], num_channels_up=[8],
                 num_channels_skip=[2])
    q = FitQueue()
    q.add(_spec(0.2, model, num_iter=10, log_every=5), 0, name="a", device="cpu")
    q.add(_spec(0.8, model, num_iter=10, log_every=5), 0, name="b", device="cpu")
    res = q.run()
    pa, pb = res["a"][1].params, res["b"][1].params
    own = dict(model.named_parameters())
    for k in pa:
        assert pa[k] is not pb[k] and pa[k] is not own[k] and pb[k] is not own[k]
    assert not torch.equal(pa["convs.0.weight"], pb["convs.0.weight"])
    assert abs(res["a"][0].mean().item() - res["b"][0].mean().item()) > 0.3


def test_histories_match_the_jax_queue():
    """Two jobs, 5 steps each in one chunk, jitter off (the RNG streams
    cannot match), the seam off on both sides (f32): each job's loss and
    PSNR per step against the JAX FitQueue's on the same weights and the
    same z (given as net_input), rtol 1e-3, as the JAX Engine trajectory
    test holds them. Adam at lr 1e-3, as the inpainting trajectory test
    runs: the scale of a BN that feeds another BN has a gradient that is
    rounding noise, which Adam turns into a step of +-lr, different on
    each side (at lr 1e-2 one of these two jobs parts by 1.3e-3 at step
    3)."""
    rng = np.random.default_rng(0)
    chans = dict(num_channels_down=[8, 16], num_channels_up=[8, 16], num_channels_skip=[4, 4],
                 upsample_mode="bilinear", pad="reflection")
    zs = [(rng.random((1, 32, 32, 4)) * 0.1).astype(np.float32) for _ in range(2)]
    tgts = [rng.random((1, 32, 32, 3)).astype(np.float32) for _ in range(2)]
    cfg = dict(num_iter=5, lr=1e-3, log_every=5, exp_weight=0.99)

    fmodel = FlaxSkip(**chans)
    jq = JFitQueue()
    with dispatch.override(up_conv="off"):
        for i in range(2):
            jq.add(JTaskSpec(name=f"j{i}", model=fmodel, cfg=JFitConfig(**cfg),
                             loss_fn=lambda p, o, a: jmse(o, a), aux=jnp.asarray(tgts[i]),
                             metrics_fn=lambda o, e, a: {"psnr_track": jpsnr(o, a)},
                             net_input=jnp.asarray(zs[i])), jax.random.key(i), name=f"j{i}")
        inits = [jax.tree_util.tree_map(np.asarray, job.state.params["net"]) for job in jq.jobs]
        jres = jq.run()

    q = FitQueue()
    for i in range(2):
        q.add(TaskSpec(name=f"t{i}", model=Skip(num_input_channels=4, up_conv=False, **chans),
                       cfg=FitConfig(**cfg), loss_fn=lambda p, o, a: mse(o, a),
                       aux=torch.from_numpy(tgts[i]),
                       metrics_fn=lambda o, e, a: {"psnr_track": psnr(o, a)},
                       net_input=zs[i]), i, name=f"t{i}", device="cpu")
        q.jobs[i].engine.model.load_state_dict(interop.flax_to_state_dict(inits[i]))
    res = q.run()
    for i in range(2):
        for k in ("loss", "psnr_track"):
            np.testing.assert_allclose(res[f"t{i}"][2][k], np.asarray(jres[f"j{i}"][2][k]),
                                       rtol=1e-3, err_msg=f"{i} {k}")
