"""The port's BatchEngine (dip_tpu_torch/parallel/batch.py) and device mesh
on the CPU: against the JAX package's BatchEngine on the same stacked
weights, against one Engine per fit, per-fit extra leaves, its refusals,
and a two-entry CPU mesh against no mesh.

Tolerances: the JAX comparison runs the seam off on both sides (f32
throughout) with jitter off (the RNG streams cannot match), losses and
metrics per fit and step at rtol 1e-3, as tests/test_torch_engine.py holds
Engine: BN statistics summed in another order move the trajectories apart
slowly. Against Engine(seeds[i]) the jitter streams are the same and only
the batched arithmetic differs (grouped convolutions, sums over a vmapped
layout): rtol 1e-3 over 5 steps. The first step's gradients: with the seam
off, within 2e-5 of the fit's largest (f32 sums in another order; 7.7e-6
seen); with it on, within 5e-3 (the seam's backward rounds its cotangent
to bf16, and an f32 difference in the last bit can move a bf16 operand by
2^-8 of itself; 6e-4 seen), and the 5-step trajectory at rtol 1e-2 (Adam
turns those differences on near-zero gradients into +-lr steps; 3.1e-3
seen).
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
from dip_tpu.ops.losses import mse as jmse, psnr as jpsnr  # noqa: E402
from dip_tpu.parallel import batch as jbatch  # noqa: E402
from dip_tpu_torch import interop  # noqa: E402
from dip_tpu_torch.fit import engine as teng  # noqa: E402
from dip_tpu_torch.models import Skip  # noqa: E402
from dip_tpu_torch.ops.losses import mse, psnr  # noqa: E402
from dip_tpu_torch.parallel import BatchEngine, make_mesh, shard_batch  # noqa: E402
from dip_tpu_torch.parallel.mesh import Mesh, replicate  # noqa: E402

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
    return {"psnr_track": psnr(out, aux["t"]), "psnr_sm": psnr(ema, aux["t"])}


def _batch(cfg, b=B, mesh=None, **skip):
    model = Skip(num_input_channels=DEPTH, **dict(SMALL, **skip))
    return BatchEngine(model, _loss, cfg, _metrics, mesh=mesh,
                       device=None if mesh is not None else "cpu")


def test_matches_jax_batch_engine():
    """5 steps of B fits, seam off and jitter off, EMA and backtracking on,
    from the JAX BatchEngine's initial stacked weights carried across
    (interop.flax_batch_to_torch): loss and psnr_track per fit and step at
    rtol 1e-3, backtracking's decisions equal."""
    zs, tgt = _data()
    cfg_kw = dict(num_iter=5, lr=1e-3, reg_noise_std=0.0, exp_weight=0.99, backtrack=True,
                  log_every=5)
    jbe = jbatch.BatchEngine(FlaxSkip(**SMALL), lambda p, out, aux: jmse(out, aux),
                             jeng.FitConfig(**cfg_kw),
                             lambda out, ema, aux: {"psnr_track": jpsnr(out, aux)})
    with dispatch.override(up_conv="off"):
        jstate = jbe.init_state(jax.random.split(jax.random.key(0), B), jnp.asarray(zs))
        init = jax.tree_util.tree_map(np.asarray, jstate.params)
        jstate, jhist = jbe.run(jstate, jnp.asarray(tgt))

    model = Skip(num_input_channels=DEPTH, up_conv=False, **SMALL)
    be = BatchEngine(model, lambda p, out, aux: mse(out, aux), teng.FitConfig(**cfg_kw),
                     lambda out, ema, aux: {"psnr_track": psnr(out, aux)}, device="cpu")
    state = be.init_state(SEEDS, torch.from_numpy(zs))
    shard = state.shards[0]
    stacked = interop.flax_batch_to_torch(init, model)
    assert set(stacked) == set(shard.params)
    with torch.no_grad():
        for k, v in stacked.items():
            assert v.shape == shard.params[k].shape, k
            shard.params[k].copy_(v)
            shard.snapshot[k].copy_(v)
    state, hist = be.run(state, torch.from_numpy(tgt))
    assert set(hist) == {"loss", "psnr_track", "backtracked"}
    for k in ("loss", "psnr_track"):
        assert hist[k].shape == (5, B)
        np.testing.assert_allclose(hist[k], np.asarray(jhist[k]), rtol=1e-3, err_msg=k)
    np.testing.assert_array_equal(hist["backtracked"], np.asarray(jhist["backtracked"]))


def test_conv_wgrad_matches_jax_batch_engine():
    """test_matches_jax_batch_engine with the weight-gradient kernels on
    both sides: the JAX package's own switch (dispatch pallas_wgrad='all',
    its Pallas kernels in interpret mode on the CPU, batched by vmap) and
    the port's conv_wgrad='all' (K5/K6's fit axis through ConvFits; their
    plain versions here); 3 steps, seam off, jitter off, per-fit loss at
    rtol 1e-3."""
    from jax.experimental.pallas import tpu as pltpu

    zs, tgt = _data()
    cfg_kw = dict(num_iter=3, lr=1e-3, log_every=3)
    jbe = jbatch.BatchEngine(FlaxSkip(**SMALL), lambda p, out, aux: jmse(out, aux),
                             jeng.FitConfig(**cfg_kw))
    with dispatch.override(up_conv="off", pallas_wgrad="all"), \
            pltpu.force_tpu_interpret_mode():
        jstate = jbe.init_state(jax.random.split(jax.random.key(0), B), jnp.asarray(zs))
        init = jax.tree_util.tree_map(np.asarray, jstate.params)
        _, jhist = jbe.run(jstate, jnp.asarray(tgt))
    model = Skip(num_input_channels=DEPTH, up_conv=False, conv_wgrad="all", **SMALL)
    be = BatchEngine(model, lambda p, out, aux: mse(out, aux), teng.FitConfig(**cfg_kw),
                     device="cpu")
    state = be.init_state(SEEDS, torch.from_numpy(zs))
    with torch.no_grad():
        for k, v in interop.flax_batch_to_torch(init, model).items():
            state.shards[0].params[k].copy_(v)
    _, hist = be.run(state, torch.from_numpy(tgt))
    np.testing.assert_allclose(hist["loss"], np.asarray(jhist["loss"]), rtol=1e-3)


def _engine_fit(cfg, i, zs, **skip):
    eng = teng.Engine(Skip(num_input_channels=DEPTH, **dict(SMALL, **skip)), _loss, cfg,
                      _metrics, device="cpu")
    state = eng.init_state(SEEDS[i], torch.from_numpy(zs[i]))
    return eng, state


@pytest.mark.parametrize("optimizer,up_conv,grad_tol", [
    ("adam", True, 5e-3), ("sgd", True, 5e-3), ("adam", False, 2e-5)])
def test_fit_i_is_engine_with_seed_i(optimizer, up_conv, grad_tol):
    """Jitter on (input jitter from seeds[i] + 1, weight jitter from
    seeds[i] + 2, std(w) per fit), EMA and backtracking, the seam on or
    off: BatchEngine's fit i against Engine.init_state(seeds[i], z_i) run
    alone, the first step's metrics at rtol 1e-5 and gradients within
    `grad_tol` of the fit's largest, then 5 steps' losses and metrics at
    rtol 1e-3 with the seam off, 1e-2 with it on."""
    _fit_i_against_engine(optimizer, up_conv, grad_tol)


@pytest.mark.parametrize("optimizer,up_conv,grad_tol", [
    ("adam", True, 5e-3), ("sgd", True, 5e-3), ("adam", False, 2e-5)])
def test_conv_wgrad_fit_i_is_engine_with_seed_i(optimizer, up_conv, grad_tol):
    """test_fit_i_is_engine_with_seed_i with conv_wgrad='all' on both
    sides, at its limits: under vmap every stride-1 3x3 and 1x1 conv runs
    hopper_wgrad.ConvFits (grouped forward and data gradient, K5/K6's
    weight gradient per fit; their plain versions here), Engine's fit the
    single-fit Functions."""
    _fit_i_against_engine(optimizer, up_conv, grad_tol, conv_wgrad="all")


def _fit_i_against_engine(optimizer, up_conv, grad_tol, **skip):
    zs, tgt = _data()
    cfg = teng.FitConfig(num_iter=5, lr=0.01, optimizer=optimizer, reg_noise_std=0.05,
                         param_noise=True, exp_weight=0.99, backtrack=True, log_every=5)
    be = _batch(cfg, up_conv=up_conv, **skip)
    state = be.init_state(SEEDS, torch.from_numpy(zs))
    aux = {"t": torch.from_numpy(tgt)}
    first = be.step(state, aux)
    shard = state.shards[0]
    grads = {k: p.grad.clone() for k, p in shard.params.items()}
    state, hist = be.run(state, aux)
    for i in range(B):
        eng, s = _engine_fit(cfg, i, zs, up_conv=up_conv, **skip)
        _, m = eng.step(s, {"t": torch.from_numpy(tgt[i])})
        g_max = max(p.grad.abs().max().item() for p in s.params.values())
        worst = max((grads[k][i] - p.grad).abs().max().item() for k, p in s.params.items())
        assert worst <= grad_tol * g_max, (i, worst, g_max)
        for k in m:
            np.testing.assert_allclose(first[k][i].item(), m[k].item(), rtol=1e-5)
        _, h = eng.run(s, {"t": torch.from_numpy(tgt[i])})
        for k in ("loss", "psnr_track", "psnr_sm"):
            np.testing.assert_allclose(hist[k][:, i], h[k], rtol=1e-2 if up_conv else 1e-3,
                                       err_msg=f"{k} fit {i}")
        np.testing.assert_array_equal(hist["backtracked"][:, i], h["backtracked"])


def test_initial_weights_are_engines():
    """Fit i's stacked weights are exactly the weights Engine.init_state
    draws from seeds[i]."""
    zs, _ = _data()
    cfg = teng.FitConfig(num_iter=1)
    state = _batch(cfg).init_state(SEEDS, torch.from_numpy(zs))
    for i in range(B):
        _, s = _engine_fit(cfg, i, zs)
        for k, p in s.params.items():
            assert torch.equal(state.leaf(k)[i], p.detach()), k


def test_run_history_render_and_callback():
    zs, tgt = _data()
    cfg = teng.FitConfig(num_iter=4, lr=0.02, log_every=3, exp_weight=0.9)
    be = _batch(cfg)
    seen = []
    state = be.init_state(SEEDS, torch.from_numpy(zs))
    state, hist = be.run(state, {"t": torch.from_numpy(tgt)},
                         callback=lambda it, h, s: seen.append((it, h["loss"].shape)))
    assert seen == [(3, (3, B)), (4, (1, B))]
    assert hist["loss"].shape == (4, B) and state.step == 4
    assert (hist["loss"][-1] < hist["loss"][0]).all()
    out = be.render(state)
    assert tuple(out.shape) == (B, 1, S, S, 3) and torch.isfinite(out).all()


def test_extra_params_per_fit():
    """Per-fit extra trainable leaves (tests/test_parallel.py's gain): each
    fit's gain trains toward its own target's optimum, independently."""
    zs, _ = _data(b=2)
    tgt = np.stack([np.full((1, S, S, 3), 0.2), np.full((1, S, S, 3), 0.8)]).astype(np.float32)
    cfg = teng.FitConfig(num_iter=30, lr=0.05, log_every=30)
    be = BatchEngine(Skip(num_input_channels=DEPTH, num_channels_down=[8],
                          num_channels_up=[8], num_channels_skip=[2]),
                     lambda p, out, aux: mse(out * p["gain"], aux), cfg, device="cpu")
    state = be.init_state([0, 1], torch.from_numpy(zs),
                          extra_params={"gain": torch.full((2,), 0.5)})
    assert state.leaf("gain").shape == (2,)
    state, hist = be.run(state, torch.from_numpy(tgt))
    assert (hist["loss"][-1] < hist["loss"][0]).all()
    gains = state.leaf("gain").numpy()
    assert not np.allclose(gains, 0.5)
    assert gains[0] != gains[1]


def test_refusals():
    """What BatchEngine refuses, with the reason: a mesh and a device both
    (or neither), and a batch that does not divide by the mesh. L-BFGS and
    the conv weight-gradient kernels, refused before K5/K6 had a fit axis
    and the line searches a lockstep form, are accepted now, at
    construction and at init_state."""
    for cfg, skip in ((teng.FitConfig(optimizer="lbfgs"), {}),
                      (teng.FitConfig(), {"conv_wgrad": "3x3"})):
        _batch(cfg, **skip).init_state(SEEDS, torch.from_numpy(_data()[0]))
    with pytest.raises(ValueError, match="mesh or a device"):
        BatchEngine(Skip(), _loss, teng.FitConfig())
    with pytest.raises(ValueError, match="divide"):
        _batch(teng.FitConfig(), mesh=Mesh(["cpu", "cpu"])).init_state(
            SEEDS, torch.from_numpy(_data()[0]))


def test_two_entry_cpu_mesh_matches_no_mesh():
    """4 fits over a two-entry CPU mesh (two sub-batches of 2, each its
    own model copy) against the same 4 fits on one device: the same
    per-fit history within 1e-5, the same renders, in fit order."""
    zs, tgt = _data(b=4)
    seeds = [1, 2, 3, 4]
    cfg = teng.FitConfig(num_iter=4, lr=0.01, reg_noise_std=0.05, exp_weight=0.99,
                         backtrack=True, log_every=2)
    runs = []
    for mesh in (None, Mesh(["cpu", "cpu"])):
        be = _batch(cfg, b=4, mesh=mesh)
        state = be.init_state(seeds, torch.from_numpy(zs))
        state, hist = be.run(state, {"t": torch.from_numpy(tgt)})
        runs.append((hist, be.render(state), len(state.shards)))
    (h0, r0, n0), (h1, r1, n1) = runs
    assert (n0, n1) == (1, 2)
    for k in h0:
        np.testing.assert_allclose(h1[k], h0[k], rtol=1e-5, err_msg=k)
    torch.testing.assert_close(r1, r0, rtol=1e-5, atol=1e-6)


def test_mesh_helpers():
    mesh = Mesh(["cpu", "cpu"])
    assert mesh.size == 2 and mesh.axis == "data"
    tree = {"a": torch.arange(8.0).reshape(4, 2), "b": [torch.tensor(3.0)], "c": None}
    parts = shard_batch(tree, mesh)
    assert len(parts) == 2
    assert torch.equal(parts[1]["a"], torch.tensor([[4.0, 5.0], [6.0, 7.0]]))
    assert parts[0]["b"][0].item() == parts[1]["b"][0].item() == 3.0 and parts[0]["c"] is None
    with pytest.raises(ValueError, match="divide"):
        shard_batch(torch.zeros(3), mesh)
    copies = replicate({"x": np.ones(2)}, mesh)
    assert len(copies) == 2 and torch.equal(copies[1]["x"], torch.ones(2, dtype=torch.float64))
    with pytest.raises(ValueError):
        Mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()


def test_flax_batch_round_trip():
    """flax_batch_to_torch is flax_trainable_to_torch per fit, stacked."""
    model = Skip(num_input_channels=DEPTH, **SMALL)
    per_fit = []
    for seed in SEEDS:
        model.reset_parameters(torch.Generator().manual_seed(seed))
        per_fit.append(interop.torch_trainable_to_flax(
            {k: p.detach() for k, p in model.named_parameters()}, model))
    batched = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *per_fit)
    stacked = interop.flax_batch_to_torch(batched, model)
    for i, tree in enumerate(per_fit):
        one = interop.flax_trainable_to_torch(tree, model)
        for k, v in one.items():
            assert torch.equal(stacked[k][i], v), k
