"""The port's L-BFGS (dip_tpu_torch/fit/lbfgs.py and the engine's
'lbfgs' optimizer) against the JAX engine's optax.lbfgs, on the CPU: the
convex problem of tests/test_lbfgs_parity.py step for step and to its
outcome, the tiny DIP problem of tests/test_lbfgs_dip.py to its outcome,
the line search's fixed noise, the refused capture, and a resumed fit."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dip_tpu.fit import engine as jeng  # noqa: E402
from dip_tpu.models import Identity as FlaxIdentity  # noqa: E402
from dip_tpu_torch.fit import engine as teng  # noqa: E402
from dip_tpu_torch.fit.checkpoint import restore_fit_state, save_fit_state  # noqa: E402
from dip_tpu_torch.fit.lbfgs import ZoomLBFGS, zoom_linesearch  # noqa: E402
from dip_tpu_torch.models import Identity, Skip  # noqa: E402
from dip_tpu_torch.ops.losses import mse  # noqa: E402

N, M = 24, 16
WARMUP, LBFGS_ITERS = 10, 40


def _problem():
    """tests/test_lbfgs_parity.py's least-squares problem."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(N, M)).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32)
    x0 = rng.normal(scale=0.1, size=(1, 4, 4, M)).astype(np.float32)
    return a, b, x0


def _loss_np(a, b, x):
    r = x.reshape(-1, M) @ a.T - b
    return float(np.mean(r * r))


@pytest.fixture(scope="module")
def convex_runs():
    """(JAX history, port history, initial loss, optimal loss) of the
    convex problem: WARMUP Adam steps, then LBFGS_ITERS L-BFGS steps over
    the input of an identity net."""
    a, b, x0 = _problem()
    cfg = dict(num_iter=LBFGS_ITERS, optimizer="lbfgs", lbfgs_warmup=WARMUP,
               lbfgs_warmup_lr=1e-3, opt_input=True, log_every=LBFGS_ITERS)
    aj, bj = jnp.asarray(a), jnp.asarray(b)

    def jloss(p, out, aux):
        r = out.reshape(-1, M) @ aj.T - bj
        return jnp.mean(r * r)

    je = jeng.Engine(FlaxIdentity(), jloss, jeng.FitConfig(**cfg))
    _, jhist = je.run(je.init_state(jax.random.key(0), jnp.asarray(x0)), None)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)

    def tloss(p, out, aux):
        r = out.reshape(-1, M) @ at.T - bt
        return torch.mean(r * r)

    te = teng.Engine(Identity(), tloss, teng.FitConfig(**cfg), device="cpu")
    _, thist = te.run(te.init_state(0, torch.from_numpy(x0)), None)
    x_star = np.linalg.lstsq(a, b, rcond=None)[0]
    optimal = _loss_np(a, b, np.broadcast_to(x_star, (x0.size // M, M)))
    return jhist, thist, _loss_np(a, b, x0), optimal


def test_first_steps_match_jax(convex_runs):
    """The Adam warm-up and the first 5 L-BFGS steps run the same f32
    algorithm on both sides (the zoom line search's scalar arithmetic in
    f32 on the port's host): each step's loss within 1e-4 relative."""
    jhist, thist, _, _ = convex_runs
    assert len(thist["loss"]) == len(jhist["loss"]) == LBFGS_ITERS
    np.testing.assert_allclose(thist["loss"][:5], np.asarray(jhist["loss"][:5]), rtol=1e-4)
    assert set(thist) == {"loss", "evals"} and (thist["evals"] >= 2).all()


def test_outcome_matches_jax(convex_runs):
    """test_lbfgs_parity.py's outcome bound: at least 98 % of the gap to the
    optimum closed, and within 5 % of the JAX engine's excess."""
    jhist, thist, initial, optimal = convex_runs
    ours, theirs = float(thist["loss"][-1]), float(jhist["loss"][-1])
    assert ours - optimal < (initial - optimal) * 0.02, (ours, optimal, initial)
    assert abs(ours - theirs) < 0.05 * (initial - optimal) + 1e-6, (ours, theirs)


# 1-D objectives and starts: a shallow quadratic (the search grows the
# step), a steep quartic (it zooms), a quartic with two minima, a wavy
# one, a softplus ramp. (No steep quadratic: the cubic through three of its
# points is degenerate, and the rounding of the trial points decides it.)
LINE_PROBLEMS = [(lambda x: 0.01 * (x - 30.0) ** 2, 0.0),
                 (lambda x: 20.0 * (x - 0.1) ** 4 + jnp.exp(x), 1.0),
                 (lambda x: x ** 4 - 3.0 * x ** 2 + x, 2.0),
                 (lambda x: jnp.sin(3.0 * x) + 0.1 * x ** 2, 0.3),
                 (lambda x: jnp.log(1 + jnp.exp(8 * x)) + 0.5 * x ** 2, 1.5)]


@pytest.mark.parametrize("case", range(len(LINE_PROBLEMS)))
def test_zoom_linesearch_matches_optax(case):
    """zoom_linesearch against optax.scale_by_zoom_linesearch (as lbfgs
    configures it) along the negative gradient, each trial point computed
    as optax computes it: the same number of trials and the same step
    size."""
    import optax

    f, x0 = LINE_PROBLEMS[case]
    fs = lambda v: jnp.sum(f(v))  # noqa: E731
    x = jnp.full((1,), x0, jnp.float32)
    value, grad = jax.value_and_grad(fs)(x)
    ls = optax.scale_by_zoom_linesearch(max_linesearch_steps=20, initial_guess_strategy="one")
    _, st = ls.update(-grad, ls.init(x), x, value=value, grad=grad, value_fn=fs)
    vg = jax.jit(lambda t: jax.value_and_grad(fs)(x + t * (-grad)))

    def evaluate(t):
        v, g = vg(jnp.float32(t))
        return float(v), float((g * -grad).sum())

    t, trials = zoom_linesearch(evaluate, float(value), float(-(grad * grad).sum()))
    assert trials == int(st.info.num_linesearch_steps) > 1
    np.testing.assert_allclose(t, float(st.learning_rate), rtol=1e-6)


def _dip_data():
    """tests/test_lbfgs_dip.py's problem: a 32^2 noisy image, a 6-channel z."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32
    clean = np.stack([np.sin(xx * 6) * 0.5 + 0.5, yy, (xx + yy) / 2], axis=-1)
    noisy = np.clip(clean + rng.normal(scale=0.1, size=clean.shape), 0, 1)
    z = rng.uniform(size=(1, 32, 32, 6)).astype(np.float32) * 0.1
    return torch.from_numpy(noisy.astype(np.float32)[None]), torch.from_numpy(z)


DIP_NET = dict(num_input_channels=6, num_channels_down=[8, 16], num_channels_up=[8, 16],
               num_channels_skip=[4, 4], pad="reflection", upsample_mode="bilinear")


def test_tiny_skip_dip_outcome():
    """test_lbfgs_dip.py's outcome bound on its tiny skip net: after 30
    Adam steps at lr 1e-3 and 40 L-BFGS steps the loss is below half the
    initial one and within 3x of torch.optim.LBFGS's (the reference's
    optimiser, one step of 40 iterations) from the same weights."""
    noisy, z = _dip_data()
    model = Skip(**DIP_NET)
    cfg = teng.FitConfig(num_iter=40, optimizer="lbfgs", lbfgs_warmup=30, log_every=40)
    eng = teng.Engine(model, lambda p, out, aux: mse(out, aux), cfg, device="cpu")
    state = eng.init_state(1, z)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        initial = mse(model(z), noisy).item()
    _, hist = eng.run(state, noisy)
    with torch.no_grad():
        ours = mse(model(z), noisy).item()

    ref = Skip(**DIP_NET)
    ref.load_state_dict(init)
    warm = torch.optim.Adam(ref.parameters(), lr=1e-3)
    for _ in range(30):
        warm.zero_grad()
        mse(ref(z), noisy).backward()
        warm.step()
    opt = torch.optim.LBFGS(ref.parameters(), max_iter=40, tolerance_grad=-1,
                            tolerance_change=-1)

    def closure():
        opt.zero_grad()
        loss = mse(ref(z), noisy)
        loss.backward()
        return loss

    opt.step(closure)
    with torch.no_grad():
        theirs = mse(ref(z), noisy).item()
    assert np.isfinite(hist["loss"]).all() and hist["loss"][-1] < hist["loss"][0]
    assert ours < 0.5 * initial, (ours, initial)
    assert theirs < 0.5 * initial, (theirs, initial)
    assert ours < 3.0 * theirs + 1e-6 and theirs < 3.0 * ours + 1e-6, (ours, theirs)


def _jittered_engine(**over):
    noisy, z = _dip_data()
    cfg = dict(num_iter=3, optimizer="lbfgs", lbfgs_warmup=2, log_every=3, reg_noise_std=0.05,
               param_noise=True, exp_weight=0.9, backtrack=True)
    cfg.update(over)
    metrics = teng.default_metrics(noisy)
    eng = teng.Engine(Skip(**DIP_NET), lambda p, out, aux: mse(out, aux),
                      teng.FitConfig(**cfg), metrics, device="cpu")
    return eng, eng.init_state(2, z), noisy


def test_line_search_evaluates_with_the_steps_noise():
    """With input jitter and weight jitter on, two evaluations of one
    step's closure at the same params give the same loss bit for bit (the
    step's draws are fixed), and the next step draws afresh."""
    eng, state, noisy = _jittered_engine()
    eng.run_chunk(state, noisy, 1)  # the warm-up and one L-BFGS step
    seen = []
    step = ZoomLBFGS.step

    def twice(opt, closure):
        seen.append((closure().item(), closure().item()))
        return step(opt, closure)

    state.opt.step = twice.__get__(state.opt)
    for _ in range(2):
        eng.step(state, noisy)
    (a1, a2), (b1, b2) = seen
    assert a1 == a2 and b1 == b2 and a1 != b1


def test_capture_raises_for_lbfgs_and_run_is_eager():
    """Engine.capture refuses L-BFGS on any device; run_chunk takes eager
    steps (after the Adam warm-up) and the history has each step's
    evaluations."""
    eng, state, noisy = _jittered_engine()
    with pytest.raises(RuntimeError, match="cannot be captured"):
        eng.capture(state, noisy)
    hist = eng.run_chunk(state, noisy, 2)
    assert state.step == 2 + 2 and isinstance(state.opt, ZoomLBFGS)
    assert set(hist) == {"loss", "evals", "psnr_track", "backtracked"}
    assert (hist["evals"] >= 2).all() and torch.isfinite(hist["loss"]).all()


def test_resume_mid_lbfgs_equals_uninterrupted(tmp_path):
    """A checkpoint after the warm-up and 3 L-BFGS steps (the optimizer's
    memory in its state_dict), restored into a fresh state, runs 3 more
    steps equal bit for bit to 6 uninterrupted ones, the warm-up not
    repeated."""
    eng, whole, noisy = _jittered_engine(num_iter=6, log_every=6)
    _, h_whole = eng.run(whole, noisy)
    half = dict(num_iter=3, log_every=3)
    eng1, first, _ = _jittered_engine(**half)
    _, h1 = eng1.run(first, noisy)
    path = tmp_path / "fit.pt"
    save_fit_state(str(path), first)
    eng2, resumed, _ = _jittered_engine(**half)
    restore_fit_state(str(path), resumed)
    _, h2 = eng2.run(resumed, noisy)
    for k in h_whole:
        np.testing.assert_array_equal(np.concatenate([h1[k], h2[k]]), h_whole[k], err_msg=k)
    assert resumed.step == whole.step == 2 + 6
    for k, p in whole.params.items():
        assert torch.equal(p, resumed.params[k]), k
    assert torch.equal(whole.ema_out, resumed.ema_out)


def test_warmup_is_the_adam_fit():
    """The warm-up is lbfgs_warmup steps of the Adam engine at
    lbfgs_warmup_lr without backtracking: the params after it equal an
    Adam fit's from the same seeds."""
    eng, state, noisy = _jittered_engine(lbfgs_warmup=3)
    eng._warmup(state, noisy)
    adam = dataclasses.replace(eng.cfg, optimizer="adam", lr=eng.cfg.lbfgs_warmup_lr,
                               num_iter=3, backtrack=False)
    ref = teng.Engine(Skip(**DIP_NET), eng.loss_fn, adam, eng.metrics_fn, device="cpu")
    rstate = ref.init_state(2, state.z)
    ref.run(rstate, noisy)
    assert state.step == rstate.step == 3 and isinstance(state.opt, ZoomLBFGS)
    for k, p in state.params.items():
        assert torch.equal(p, rstate.params[k]), k
    assert torch.equal(state.ema_out, rstate.ema_out)
