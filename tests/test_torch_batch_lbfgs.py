"""L-BFGS under the port's BatchEngine (fit/lbfgs.BatchZoomLBFGS,
parallel/batch.py) on the CPU: B independent line searches in lockstep
against one ZoomLBFGS a fit, BatchEngine's fit i against Engine(seeds[i])
with L-BFGS, and against the JAX BatchEngine with optimizer='lbfgs'.

Tolerances: BatchZoomLBFGS takes each fit's dot products as a sum over its
row (ZoomLBFGS takes torch.dot) and steps by addcmul, so a fit's values
differ from its own ZoomLBFGS's by f32 rounding only: rtol 1e-5 on the
convex problems, whose line searches take the same trials (counts equal).
Fit i against Engine(seed i), seam off, f32, jitter on: the batched
forward's grouped convolutions add rounding (tests/test_torch_batch.py:
rtol 1e-3 over 5 Adam steps; 1.2e-7 seen here over these steps), losses
at rtol 1e-4 and evaluation counts equal. Against the JAX BatchEngine,
jitter off (the RNG streams cannot match) and seam off (hazards 1, 2),
without a warm-up (the JAX BatchEngine runs none; fit i here is Engine
with seed i, which does, so the comparison sets lbfgs_warmup=0): losses at
rtol 1e-3 (tests/test_torch_engine.py's limit for Engine against the JAX
engine).
"""

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
from dip_tpu.parallel import batch as jbatch  # noqa: E402
from dip_tpu_torch import interop  # noqa: E402
from dip_tpu_torch.fit import engine as teng  # noqa: E402
from dip_tpu_torch.fit.lbfgs import BatchZoomLBFGS, ZoomLBFGS  # noqa: E402
from dip_tpu_torch.models import Skip  # noqa: E402
from dip_tpu_torch.ops.losses import mse, psnr  # noqa: E402
from dip_tpu_torch.parallel import BatchEngine  # noqa: E402

SMALL = dict(num_channels_down=[8, 8], num_channels_up=[8, 8], num_channels_skip=[4, 4],
             upsample_mode="bilinear", pad="reflection")
B, S, DEPTH = 3, 16, 4
SEEDS = [5, 11, 17]


def _data(b=B, seed=0):
    rng = np.random.default_rng(seed)
    zs = (rng.random((b, 1, S, S, DEPTH)) * 0.1).astype(np.float32)
    tgt = rng.random((b, 1, S, S, 3)).astype(np.float32)
    return zs, tgt


def _loss(p, out, aux):
    return mse(out, aux["t"])


def _metrics(out, ema, aux):
    return {"psnr_track": psnr(out, aux["t"])}


def _least_squares(i):
    """Fit i's problem: mean((x A_i^T - b_i)^2) over x (4, 6), A_i (5, 6),
    the fits' curvatures 1, 16 and 0.04 times one another's: their line
    searches take different numbers of trials."""
    rng = np.random.default_rng(40 + i)
    a = torch.from_numpy((rng.normal(size=(5, 6)) * (1.0, 4.0, 0.2)[i]).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(4, 5)).astype(np.float32))
    x0 = torch.from_numpy(rng.normal(scale=0.3, size=(4, 6)).astype(np.float32))
    return a, b, x0


def test_lockstep_searches_are_each_fits_own():
    """B = 3 least-squares problems, 6 steps: BatchZoomLBFGS over the
    stacked x against one ZoomLBFGS a problem, each fit's losses at rtol
    1e-5 and its evaluations a step equal; the fits' searches take
    different numbers of trials, so a fit whose search has ended sits out
    rounds that others still run."""
    probs = [_least_squares(i) for i in range(B)]
    x = torch.stack([p[2] for p in probs]).requires_grad_()
    a = torch.stack([p[0] for p in probs])
    b = torch.stack([p[1] for p in probs])
    opt = BatchZoomLBFGS([x])

    def closure():
        losses = ((x @ a.transpose(1, 2) - b) ** 2).mean((1, 2))
        opt.zero_grad()
        losses.sum().backward()
        return losses.detach()

    batched = [(opt.step(closure), list(opt.last_evals)) for _ in range(6)]
    evals_seen = set()
    for i, (ai, bi, x0) in enumerate(probs):
        xi = x0.clone().requires_grad_()
        one = ZoomLBFGS([xi])

        def closure_i():
            loss = ((xi @ ai.T - bi) ** 2).mean()
            one.zero_grad()
            loss.backward()
            return loss

        for step, (losses, evals) in enumerate(batched):
            loss = one.step(closure_i)
            np.testing.assert_allclose(losses[i].item(), loss.item(), rtol=1e-5,
                                       err_msg=f"fit {i} step {step}")
            assert evals[i] == one.last_evals, (i, step)
            evals_seen.add((step, evals[i]))
    assert len({e for _, e in evals_seen}) > 1


@pytest.mark.parametrize("warmup", [0, 3])
def test_fit_i_is_engine_with_seed_i(warmup):
    """BatchEngine with optimizer='lbfgs' (its `warmup` graphed-on-the-card
    Adam steps, then 4 L-BFGS steps), input and weight jitter on, EMA, seam
    off, f32: fit i's losses a step at rtol 1e-4 and its evaluations a step
    equal to Engine(seeds[i])'s with L-BFGS, and its final params within
    1e-4 of the largest, but the biases of the convs that feed a BN: their
    exact gradient is 0, and the Adam warm-up turns the rounding noise
    there into +-lr steps (hazard 5 of ROADMAP.md; 1.2e-3 seen)."""
    zs, tgt = _data()
    cfg = teng.FitConfig(num_iter=4, optimizer="lbfgs", lbfgs_warmup=warmup, log_every=4,
                         reg_noise_std=0.05, param_noise=True, exp_weight=0.99)
    model = Skip(num_input_channels=DEPTH, up_conv=False, **SMALL)
    be = BatchEngine(model, _loss, cfg, _metrics, device="cpu")
    state = be.init_state(SEEDS, torch.from_numpy(zs))
    state, hist = be.run(state, {"t": torch.from_numpy(tgt)})
    assert hist["evals"].shape == (4, B) and state.step == warmup + 4
    for i in range(B):
        eng = teng.Engine(Skip(num_input_channels=DEPTH, up_conv=False, **SMALL), _loss, cfg,
                          _metrics, device="cpu")
        s = eng.init_state(SEEDS[i], torch.from_numpy(zs[i]))
        _, h = eng.run(s, {"t": torch.from_numpy(tgt[i])})
        np.testing.assert_allclose(hist["loss"][:, i], h["loss"], rtol=1e-4, err_msg=f"fit {i}")
        np.testing.assert_allclose(hist["psnr_track"][:, i], h["psnr_track"], rtol=1e-4)
        np.testing.assert_array_equal(hist["evals"][:, i], h["evals"])
        p_max = max(p.abs().max().item() for p in s.params.values())
        for k, p in s.params.items():
            if k.endswith(".bias") and k != f"convs.{len(model.convs) - 1}.bias":
                continue  # feeds a BN: a gradient of rounding noise (hazard 5)
            assert (state.leaf(k)[i] - p.detach()).abs().max() <= 1e-4 * p_max, (i, k)


def test_matches_jax_batch_engine():
    """3 L-BFGS steps of B fits of a one-scale Skip (the JAX side compiles
    optax's line search inside a vmapped scan: about 25 s for this net, 55 s
    for two scales), no warm-up, jitter off, seam off, from the JAX
    BatchEngine's initial stacked weights (interop.flax_batch_to_torch):
    loss per fit and step at rtol 1e-3."""
    zs, tgt = _data()
    cfg_kw = dict(num_iter=3, optimizer="lbfgs", lbfgs_warmup=0, log_every=3)
    net = dict(SMALL, num_channels_down=[8], num_channels_up=[8], num_channels_skip=[4])
    jbe = jbatch.BatchEngine(FlaxSkip(**net), lambda p, out, aux: jmse(out, aux),
                             jeng.FitConfig(**cfg_kw))
    with dispatch.override(up_conv="off"):
        jstate = jbe.init_state(jax.random.split(jax.random.key(0), B), jnp.asarray(zs))
        init = jax.tree_util.tree_map(np.asarray, jstate.params)
        _, jhist = jbe.run(jstate, jnp.asarray(tgt))

    model = Skip(num_input_channels=DEPTH, up_conv=False, **net)
    be = BatchEngine(model, lambda p, out, aux: mse(out, aux), teng.FitConfig(**cfg_kw),
                     device="cpu")
    state = be.init_state(SEEDS, torch.from_numpy(zs))
    with torch.no_grad():
        for k, v in interop.flax_batch_to_torch(init, model).items():
            state.shards[0].params[k].copy_(v)
    _, hist = be.run(state, torch.from_numpy(tgt))
    assert hist["loss"].shape == (3, B)
    np.testing.assert_allclose(hist["loss"], np.asarray(jhist["loss"]), rtol=1e-3)
