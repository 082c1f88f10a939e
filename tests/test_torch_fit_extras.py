"""The port's fit extras against the JAX package's, on the CPU: the jitter
schedule, SGD, the step the CUDA graph holds (run uncaptured), the
'lbfgs' refusal and the functional facade."""

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
from dip_tpu_torch.ops.losses import mse as tmse  # noqa: E402

SMALL = dict(num_channels_down=[8, 16], num_channels_up=[8, 16],
             num_channels_skip=[4, 4], upsample_mode="bilinear", pad="reflection")
SCHEDULE = ((3, 0.5), (7, 0.1), (10, 0.02))


def _data(seed=0, size=32, depth=4):
    rng = np.random.default_rng(seed)
    z = (rng.random((1, size, size, depth)) * 0.1).astype(np.float32)
    tgt = rng.random((1, size, size, 3)).astype(np.float32)
    return z, tgt


def test_schedule_std_matches_jnp_select():
    """At every step around each boundary (and past the last), the std the
    port picks on the device equals jnp.select's first match over the same
    pairs, with reg_noise_std past the last pair."""
    default = 0.03
    bounds = torch.tensor([b for b, _ in SCHEDULE])
    stds = torch.tensor([s for _, s in SCHEDULE], dtype=torch.float32)
    for step in range(13):
        want = jnp.select([jnp.asarray(step) < b for b, _ in SCHEDULE],
                          list(jnp.asarray([s for _, s in SCHEDULE], jnp.float32)),
                          jnp.float32(default))
        got = teng.schedule_std(torch.tensor(step), bounds, stds,
                                torch.tensor(default, dtype=torch.float32))
        assert got.dtype == torch.float32
        assert got.item() == float(want), step


class _Identity(torch.nn.Module):
    """out = z, with one unused parameter for the optimizer."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))

    def reset_parameters(self, generator):
        del generator

    def forward(self, z):
        return z + 0.0 * self.w


def test_schedule_jitter_statistics():
    """z + N(0,1)*std(step) through the Engine: per step, mean 0 and std
    the schedule's over 64*64*3 samples (as test_jitter_statistics holds
    the fixed std), a fresh draw every step, z unchanged."""
    z = torch.from_numpy(_data(size=64, depth=3)[0])
    cfg = teng.FitConfig(num_iter=12, reg_noise_std=0.03, reg_noise_schedule=SCHEDULE,
                         log_every=5)
    eng = teng.Engine(_Identity(), lambda p, out, aux: torch.mean(out * 0.0), cfg,
                      lambda out, ema, aux: {"mean": torch.mean(out - aux),
                                             "std": torch.std(out - aux),
                                             "first": (out - aux)[0, 0, 0, 0]},
                      device="cpu")
    state, hist = eng.run(eng.init_state(0, z), z)
    want = np.array([next((s for b, s in SCHEDULE if i < b), 0.03) for i in range(12)])
    assert np.all(np.abs(hist["mean"]) < 0.02 * want)
    assert np.all(np.abs(hist["std"] - want) < 0.03 * want)
    assert len(set(hist["first"].tolist())) == 12
    assert state.step == 12 and state.device_step.item() == 12
    torch.testing.assert_close(state.z, z, rtol=0, atol=0)


def test_sgd_trajectory_matches_jax_engine():
    """5 SGD steps (optax.sgd: no momentum) from the JAX Engine's weights,
    carried by interop, jitter off (the RNG streams cannot match), EMA on,
    the seam off on both sides (f32 throughout): loss and PSNR per step at
    rtol 1e-3, as test_trajectory_matches_jax_engine holds Adam."""
    z, tgt = _data()
    cfg_kw = dict(num_iter=5, lr=0.05, optimizer="sgd", exp_weight=0.99, log_every=5)
    fmodel = FlaxSkip(**SMALL)
    je = jeng.Engine(fmodel, lambda p, out, aux: jmse(out, aux), jeng.FitConfig(**cfg_kw),
                     jeng.default_metrics(jnp.asarray(tgt)))
    with dispatch.override(up_conv="off"):
        jstate = je.init_state(jax.random.key(0), jnp.asarray(z))
        init = jax.tree_util.tree_map(np.asarray, jstate.params["net"])
        jstate, jhist = je.run(jstate, jnp.asarray(tgt))

    te = teng.Engine(Skip(num_input_channels=4, up_conv=False, **SMALL),
                     lambda p, out, aux: tmse(out, aux), teng.FitConfig(**cfg_kw),
                     teng.default_metrics(torch.from_numpy(tgt)), device="cpu")
    tstate = te.init_state(0, torch.from_numpy(z))
    assert isinstance(tstate.opt, torch.optim.SGD)
    assert tstate.opt.param_groups[0]["momentum"] == 0
    te.model.load_state_dict(interop.flax_to_state_dict(init))
    tstate, thist = te.run(tstate, torch.from_numpy(tgt))
    for k in ("loss", "psnr_track"):
        np.testing.assert_allclose(thist[k], np.asarray(jhist[k]), rtol=1e-3, err_msg=k)
    assert thist["loss"][-1] < thist["loss"][0]


def _twin(cfg):
    eng = teng.Engine(Skip(num_input_channels=4, **SMALL), lambda p, out, aux: tmse(out, aux),
                      cfg, teng.default_metrics(torch.from_numpy(_data()[1])), device="cpu")
    return eng, eng.init_state(3, torch.from_numpy(_data()[0]))


def test_replayable_step_equals_step():
    """The step a CUDA graph captures (Engine._step_into: the step, then
    its metrics into a row of a static table at a device slot), run
    uncaptured on the CPU for 5 steps with backtracking (threshold -0.5,
    so the restore runs), the schedule, weight jitter and the EMA on: bit
    for bit what Engine.step gives from the same seeds, in every metric,
    param, the EMA, the snapshot, the tracked PSNR and the device step."""
    cfg = teng.FitConfig(num_iter=5, log_every=5, reg_noise_std=0.02,
                         reg_noise_schedule=((2, 0.1), (4, 0.05)), param_noise=True,
                         exp_weight=0.9, backtrack=True, backtrack_threshold=-0.5)
    tgt = torch.from_numpy(_data()[1])
    eng_a, sa = _twin(cfg)
    eng_b, sb = _twin(cfg)
    want = [eng_b.step(sb, tgt)[1] for _ in range(5)]
    keys = tuple(want[0])
    table = torch.zeros((5, len(keys)))
    slot = torch.zeros(1, dtype=torch.int64)
    for _ in range(5):
        eng_a._step_into(sa, tgt, table, slot, keys)
    assert slot.item() == 5 and sum(m["backtracked"].item() for m in want) >= 1
    for i, m in enumerate(want):
        assert torch.equal(table[i], torch.stack([m[k] for k in keys])), i
    for k in sa.params:
        assert torch.equal(sa.params[k], sb.params[k]), k
        assert torch.equal(sa.snapshot[k], sb.snapshot[k]), k
    for a, b in ((sa.ema_out, sb.ema_out), (sa.last_track, sb.last_track),
                 (sa.device_step, sb.device_step)):
        assert torch.equal(a, b)


def test_lbfgs_raises_and_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="not ported yet"):
        teng.Engine(_Identity(), lambda p, out, aux: out.sum(),
                    teng.FitConfig(optimizer="lbfgs"), device="cpu")
    with pytest.raises(ValueError, match="unknown optimizer"):
        teng.Engine(_Identity(), lambda p, out, aux: out.sum(),
                    teng.FitConfig(optimizer="rmsprop"), device="cpu")


def test_fit_facade_equals_engine():
    """fit(...) = Engine + init_state(seed) + run + render, and init_fit
    gives that engine and state."""
    z, tgt = _data()
    cfg = teng.FitConfig(num_iter=3, log_every=2, reg_noise_std=0.05, exp_weight=0.9)
    loss = lambda p, out, aux: tmse(out, aux)  # noqa: E731
    out, state, hist = teng.fit(Skip(num_input_channels=4, **SMALL), loss, cfg, 7,
                                torch.from_numpy(z), torch.from_numpy(tgt), device="cpu")
    eng, s2 = teng.init_fit(Skip(num_input_channels=4, **SMALL), loss, cfg, 7,
                            torch.from_numpy(z), device="cpu")
    s2, h2 = eng.run(s2, torch.from_numpy(tgt))
    assert torch.equal(out, eng.render(s2)) and state.step == s2.step == 3
    np.testing.assert_array_equal(hist["loss"], h2["loss"])
