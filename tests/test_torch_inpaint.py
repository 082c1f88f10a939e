"""The port's masked-MSE tasks (inpainting and sparse restoration) against
the JAX package, on the CPU: the loss, the pools and Conv's post-down
modes, the masks, every preset's spec and net (through interop), 5-step
trajectories against the JAX Engine, and the weight jitter."""

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
from dip_tpu.models.blocks import Conv as FlaxConv  # noqa: E402
from dip_tpu.ops import dispatch  # noqa: E402
from dip_tpu.ops import losses as jlosses, resample as jresample  # noqa: E402
from dip_tpu.tasks import inpaint as jinpaint, restore as jrestore  # noqa: E402
from dip_tpu.utils import masks as jmasks  # noqa: E402
from dip_tpu_torch import interop  # noqa: E402
from dip_tpu_torch.fit import engine as teng  # noqa: E402
from dip_tpu_torch.models import Skip  # noqa: E402
from dip_tpu_torch.models.blocks import Conv  # noqa: E402
from dip_tpu_torch.ops import losses as tlosses, resample as tresample  # noqa: E402
from dip_tpu_torch.tasks import inpaint as tinpaint, restore as trestore  # noqa: E402
from dip_tpu_torch.utils import masks as tmasks  # noqa: E402

TASKS = {"inpaint": (tinpaint, jinpaint), "restore": (trestore, jrestore)}


def _image(size, seed=0):
    """(image, Bernoulli mask, masked image, gt) as numpy NHWC."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.stack([np.sin(xx / 5) * 0.4 + 0.5, np.cos(yy / 7) * 0.4 + 0.5,
                    (xx + yy) / (2 * size)], -1)[None].astype(np.float32)
    mask = tmasks.get_bernoulli_mask((size, size, 3), 0.5, rng)[None]
    return img * mask, mask, img


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def test_masked_mse_matches_jax():
    """Normalised by the total pixel count, not by the mask's population."""
    rng = np.random.default_rng(1)
    pred, tgt = rng.random((1, 9, 7, 3)), rng.random((1, 9, 7, 3))
    mask = (rng.random((1, 9, 7, 3)) > 0.6).astype(np.float32)
    want = float(jlosses.masked_mse(jnp.asarray(pred, jnp.float32), jnp.asarray(tgt, jnp.float32),
                                    jnp.asarray(mask)))
    got = tlosses.masked_mse(_t(pred), _t(tgt), _t(mask)).item()
    assert abs(got - want) <= 1e-6 * abs(want)
    assert abs(got - float(np.mean(((pred - tgt) * mask) ** 2))) <= 1e-6 * got


@pytest.mark.parametrize("pool", ["avg_pool", "max_pool"])
@pytest.mark.parametrize("window,stride", [(2, None), (3, None), (3, 2)])
def test_pools_match_jax(pool, window, stride):
    x = np.random.default_rng(2).normal(size=(2, 11, 8, 5)).astype(np.float32)
    want = np.asarray(getattr(jresample, pool)(jnp.asarray(x), window, stride))
    got = getattr(tresample, pool)(_t(x), window, stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["avg", "max", "lanczos2", "lanczos3"])
def test_conv_post_down_matches_flax(mode):
    """A stride-2 Conv with a post-down mode: the conv at stride 1, then the
    pool or the fixed Lanczos downsample (phase 0.5, size preserved)."""
    x = np.random.default_rng(3).normal(size=(1, 16, 12, 4)).astype(np.float32)
    fconv = FlaxConv(6, 3, 2, pad="reflection", downsample_mode=mode)
    params = fconv.init(jax.random.key(1), jnp.asarray(x))["params"]
    want = np.asarray(fconv.apply({"params": params}, jnp.asarray(x)))
    conv = Conv(4, 6, 3, 2, pad="reflection", downsample_mode=mode)
    sd = interop.flax_to_state_dict({"Conv_0": jax.tree_util.tree_map(np.asarray, params)})
    conv.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()})
    with torch.no_grad():
        got = conv(_t(x)).numpy()
    assert got.shape == want.shape == (1, 8, 6, 6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,kw", [((256, 256, 3), {}),
                                      ((64, 96, 1), dict(text="DIP", font_size=12, xy=(5, 20)))])
def test_text_mask_matches_jax(shape, kw):
    got, want = tmasks.get_text_mask(shape, **kw), jmasks.get_text_mask(shape, **kw)
    assert got.dtype == want.dtype == np.float32 and 0 < got.mean() < 1
    np.testing.assert_array_equal(got, want)


def test_bernoulli_mask_matches_jax():
    np.testing.assert_array_equal(tmasks.get_bernoulli_mask((20, 30, 3)),
                                  jmasks.get_bernoulli_mask((20, 30, 3)))
    got = tmasks.get_bernoulli_mask((20, 30, 3), 0.5, np.random.default_rng(7))
    want = jmasks.get_bernoulli_mask((20, 30, 3), 0.5, np.random.default_rng(7))
    np.testing.assert_array_equal(got, want)
    assert trestore.get_bernoulli_mask is tmasks.get_bernoulli_mask


# (task, preset, net_type, smallest image the net's reflection pads allow:
# the deepest 3x3 conv needs 2x2, the deepest 5x5 conv 4x4)
PRESETS = [("inpaint", "vase", "skip", 64), ("inpaint", "kate", "skip", 64),
           ("inpaint", "library", "skip", 256), ("inpaint", "library", "skip4", 64),
           ("restore", "barbara", "skip", 64), ("restore", "kate", "skip", 64)]


def _specs(task, preset, net_type, size, **kw):
    tmod, jmod = TASKS[task]
    masked, mask, gt = _image(size)
    if task == "inpaint":
        kw["net_type"] = net_type
    return (tmod.task(masked, mask, preset, gt=gt, **kw),
            jmod.task(masked, mask, preset, gt=gt, **kw))


@pytest.mark.parametrize("task,preset,net_type,size", PRESETS)
def test_preset_spec_and_net_match_jax(task, preset, net_type, size):
    """Every field of the spec, the fit config, and the net: the flax
    params map onto the port's net through interop (zero-width and 128-wide
    skips, 6 scales, 5x5 down-convs, no 1x1 up-convs), strictly and both
    ways, and the two nets agree on the same input (seam off on both
    sides, f32) to 1e-3: a deep net's BNs amplify f32 rounding, and the
    JAX package's own jitted and eager forwards of the 'vase' net differ
    by 7.7e-4, while the port's f32 forward is within 5e-5 of its f64
    forward."""
    t, j = _specs(task, preset, net_type, size)
    for f in ("name", "input_depth", "input_method", "input_var", "spatial_size"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("num_iter", "lr", "reg_noise_std", "param_noise", "backtrack", "exp_weight",
              "optimizer"):
        assert getattr(t.cfg, f) == getattr(j.cfg, f), f
    assert t.spatial_size == (size, size) and set(t.aux) == {"img", "mask", "gt"}

    z = np.random.default_rng(4).random((1, size, size, t.input_depth)).astype(np.float32) * 0.1
    params = jax.jit(j.model.init)(jax.random.key(0), jnp.asarray(z))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = interop.flax_to_state_dict(params)
    t.model.load_state_dict(sd, strict=True)
    back = interop.state_dict_to_flax(t.model.state_dict())
    flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(jax.tree_util.tree_leaves(params))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_array_equal(flat[path], leaf, err_msg=str(path))

    with dispatch.override(up_conv="off"):
        want = np.asarray(jax.jit(j.model.apply)({"params": params}, jnp.asarray(z)))
    t.model.up_conv = False
    with torch.no_grad():
        got = t.model(_t(z)).numpy()
    assert got.shape == want.shape == (1, size, size, 3)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("net_type", ["UNet", "ResNet"])
def test_library_zoo_variants_raise(net_type):
    """The 'library' UNet and ResNet variants build their nets (their
    parity is tests/test_torch_zoo.py's); an unknown net type or preset
    raises."""
    masked, mask, _ = _image(32)
    spec = tinpaint.task(masked, mask, "library", net_type=net_type)
    assert type(spec.model).__name__ == net_type and spec.cfg.lr == 1e-3
    with pytest.raises(ValueError):
        tinpaint.task(masked, mask, "library", net_type="VGG")
    with pytest.raises(ValueError):
        tinpaint.task(masked, mask, "lena")


# small nets for the trajectories: the preset's kind of net at 2 scales,
# and the learning rate of the comparison with JAX (None: the preset's)
SMALL = {
    ("inpaint", "kate"): (dict(num_channels_down=[16, 32], num_channels_up=[16, 32],
                               num_channels_skip=[8, 16], upsample_mode="nearest",
                               pad="reflection"), 1e-3),
    ("restore", "kate"): (dict(num_channels_down=[8, 16], num_channels_up=[8, 16],
                               num_channels_skip=[0, 0], upsample_mode="bilinear",
                               downsample_mode="avg", pad="reflection"), None),
}


def _port_fit(t, cfg, net, z, init, conv_wgrad):
    """(history, render) of the port's engine from the flax init weights."""
    model = Skip(num_input_channels=4, up_conv=False, conv_wgrad=conv_wgrad, **net)
    te = teng.Engine(model, t.loss_fn, cfg, t.metrics_fn, device="cpu")
    state = te.init_state(0, _t(z))
    te.model.load_state_dict(interop.flax_to_state_dict(init))
    if cfg.backtrack:
        state.snapshot = {k: p.detach().clone() for k, p in state.params.items()}
    state, hist = te.run(state, t.aux)
    return hist, te.render(state).numpy()


@pytest.mark.parametrize("task,preset", sorted(SMALL))
def test_trajectory_matches_jax_engine(task, preset):
    """5 steps of the preset's fit (its loss, metrics and backtracking) on a
    small 2-scale net of its kind, jitter and weight noise off (the RNG
    streams cannot match), the seam off on both sides (f32), and every
    weight gradient of the port's net from the kernels' autograd.Functions
    (their plain versions here). Compared per step by the loss and the
    metrics (rtol 1e-3, as tests/test_torch_engine.py), and by the render's
    masked MSE. The inpainting net is compared at lr 1e-3: at the preset's
    1e-2, Adam's first step (lr * sign(g)) turns gradients that are
    rounding noise (a conv bias before a BN, the scale of a BN that feeds a
    BN) into steps that differ on each side, and the losses part by 8e-3
    within 5 steps. At the preset's lr the port with conv_wgrad='all' must
    then match the port with 'off' to 1e-5."""
    net, lr = SMALL[task, preset]
    t, j = _specs(task, preset, "skip", 32, num_iter=5)
    cfg_kw = dict(num_iter=5, reg_noise_std=0.0, param_noise=False, log_every=5,
                  lr=lr or j.cfg.lr)
    jcfg = dataclasses.replace(j.cfg, **cfg_kw)
    tcfg = dataclasses.replace(t.cfg, **cfg_kw)
    z = (np.random.default_rng(5).random((1, 32, 32, 4)) * 0.1).astype(np.float32)

    je = jeng.Engine(FlaxSkip(**net), j.loss_fn, jcfg, j.metrics_fn)
    with dispatch.override(up_conv="off"):
        jstate = je.init_state(jax.random.key(0), jnp.asarray(z))
        init = jax.tree_util.tree_map(np.asarray, jstate.params["net"])
        jstate, jhist = je.run(jstate, j.aux)
        jout = np.array(je.render(jstate))
    thist, tout = _port_fit(t, tcfg, net, z, init, "all")

    assert set(thist) == set(jhist)
    for k, v in jhist.items():
        np.testing.assert_allclose(thist[k], np.asarray(v), rtol=1e-3, err_msg=k)
    assert thist["loss"][-1] < thist["loss"][0]
    img, mask = t.aux["img"].numpy(), t.aux["mask"].numpy()
    np.testing.assert_allclose(np.mean(((tout - img) * mask) ** 2),
                               np.mean(((jout - img) * mask) ** 2), rtol=1e-3)
    if lr is not None:
        cfg = dataclasses.replace(tcfg, lr=t.cfg.lr)
        (on, _), (off, _) = (_port_fit(t, cfg, net, z, init, m) for m in ("all", "off"))
        for k, v in off.items():
            np.testing.assert_allclose(on[k], v, rtol=1e-5, err_msg=k)


def _noise_engine(**cfg):
    model = Skip(num_input_channels=4, num_channels_down=[16, 32], num_channels_up=[16, 32],
                 num_channels_skip=[4, 4], pad="reflection")
    cfg.setdefault("param_noise", True)
    return teng.Engine(model, lambda p, out, aux: tlosses.mse(out, aux),
                       teng.FitConfig(**cfg), device="cpu")


def test_param_noise_statistics():
    """Each 4-D net parameter (a conv weight) seen by a training forward is
    w + N(0,1) * std(w) / 50, std with ddof 0 (jnp.std's): the noise has
    mean 0 and that std, as the JAX package's _jitter_params gives; every
    other leaf, the trainable input z and the master weights are
    untouched, each call draws afresh, and the render sees no noise."""
    z = _t(np.random.default_rng(6).random((1, 32, 32, 4)))
    eng = _noise_engine(opt_input=True)
    state = eng.init_state(0, z)
    master = {k: p.detach().clone() for k, p in state.params.items()}
    seen, again = eng.net_params(state, train=True), eng.net_params(state, train=True)
    assert set(seen) == set(eng.net_keys) and "input" in state.params
    n_4d = 0
    for k, w in seen.items():
        p = state.params[k]
        if p.dim() != 4:
            assert w is p, k
            continue
        n_4d += 1
        d = (w - p).detach()
        assert not torch.equal(d, (again[k] - p).detach()), k
        if p.numel() >= 2000:
            sigma = torch.std(p.detach(), correction=0) / 50
            assert abs(d.mean().item()) < 0.1 * sigma.item(), k
            assert abs(d.std().item() / sigma.item() - 1) < 0.1, k
    assert n_4d == sum(1 for k in eng.net_keys if k.endswith("weight") and "convs" in k)
    for k, p in state.params.items():
        assert torch.equal(p.detach(), master[k]), k
    assert all(eng.net_params(state, train=False)[k] is state.params[k] for k in eng.net_keys)

    # the JAX package's jitter, on the same weights, has the same scale
    k = next(k for k in eng.net_keys if state.params[k].numel() >= 8000)
    w = state.params[k].detach().numpy()
    jw = np.asarray(jeng._jitter_params({"w": jnp.asarray(w)}, jax.random.key(0))["w"])
    assert abs(np.std(jw - w) / (np.std(w) / 50) - 1) < 0.1


def test_param_noise_stream_is_independent_of_input_jitter():
    """The weight jitter has a generator of its own (JAX splits k_param
    from k_jit): draws from the input-jitter stream do not move it, and a
    fit with input jitter sees the same weight noise as one without."""
    z = _t(np.random.default_rng(7).random((1, 32, 32, 4)))
    a, b = _noise_engine(), _noise_engine(reg_noise_std=0.5)
    sa, sb = a.init_state(0, z), b.init_state(0, z)
    assert sb.param_generator is not sb.generator
    torch.randn(1000, generator=sb.generator)
    na, nb = a.net_params(sa, train=True), b.net_params(sb, train=True)
    for k in a.net_keys:
        assert torch.equal(na[k], nb[k]), k
    assert _noise_engine(param_noise=False).init_state(0, z).param_generator is None


def test_param_noise_step_trains_on_noisy_weights(monkeypatch):
    """Engine.step runs its forward on net_params(train=True) and the loss's
    gradient reaches the master weights; bf16 compute casts after the noise
    is added in f32."""
    z = _t(np.random.default_rng(8).random((1, 32, 32, 4)))
    for cd in (None, "bfloat16"):
        eng = _noise_engine(compute_dtype=cd, num_iter=2, log_every=2)
        state = eng.init_state(0, z)
        calls = []
        net_params = eng.net_params

        def spy(s, train, *noise):
            out = net_params(s, train, *noise)
            calls.append((train, {v.dtype for v in out.values()}))
            return out

        monkeypatch.setattr(eng, "net_params", spy)
        before = {k: p.detach().clone() for k, p in state.params.items()}
        state, hist = eng.run(state, torch.zeros(1, 32, 32, 3))
        assert calls == [(True, {torch.float32})] * 2 and np.isfinite(hist["loss"]).all()
        assert all(not torch.equal(p.detach(), before[k]) for k, p in state.params.items()
                   if p.dim() == 4)


def test_tasks_build_without_pil_or_jax():
    """The card has no Pillow: the port's masks module and both tasks import
    and build every preset with PIL blocked (the text mask raises), and
    import no JAX."""
    code = (
        "import sys; sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from dip_tpu_torch.tasks import inpaint, restore\n"
        "from dip_tpu_torch.utils import masks\n"
        "from dip_tpu_torch.ops import hopper_s2d, hopper_wgrad\n"
        "img = np.random.default_rng(0).random((1, 64, 64, 3)).astype(np.float32)\n"
        "m = restore.get_bernoulli_mask((64, 64, 3), 0.5)[None]\n"
        "for p in ('vase', 'kate', 'library'): inpaint.task(img * m, m, p)\n"
        "for p in ('barbara', 'kate'): restore.task(img * m, m, p)\n"
        "try:\n"
        "    masks.get_text_mask((64, 64, 3))\n"
        "    raise SystemExit('the text mask drew without PIL')\n"
        "except ImportError:\n"
        "    pass\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax') for m in sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
