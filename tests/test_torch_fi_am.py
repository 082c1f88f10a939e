"""Feature inversion and activation maximization in the port against the
JAX tasks on the CPU: the specs (the recipes' own 6-scale generator), and
5 steps of each fit against the JAX Engine on the same generator weights,
the same backbone weights (one .pth that both packages read) and the same
z.

The trajectories run each task's loss (backbone, matcher, crop,
preprocessing, the x5 and the recipe's objective) under a generator of
the inversion net's kind cut to a few scales, on both sides: the JAX
package compiles the 6-scale net's step for about a minute on one core,
and at the 128^2 the recipe's net needs here its deepest BNs see 2x2
pixels, whose statistics amplify f32 rounding in the gradients. Feature
inversion: AlexNet at 67^2 (fc6 takes 256 inputs) under 2 scales of the
recipe's top (16/32 channels, 7x7, avg down, nearest up, zero pad) at
68^2. Activation maximization: VGG16 at 32^2 under 3 scales of its bottom
(16/128/128 channels, 5x5/3x3/3x3, reflection pad) at 32^2, whose two
deepest decoder scales take the fused seam at LR 4 and 8 with C = F = 128,
the seams of the recipe's net at 256^2.

Hazards (ROADMAP queue C): jitter and weight jitter are off and lr is
1e-3 (the RNG streams cannot match, and Adam turns rounding noise into
+-lr steps); f32 trajectories run with the seam off on both sides (at
LR < 8 the JAX package takes its true-f32 'dots' seam, the port rounds
the seam's operands to bf16); one seam-on run is held at the seam-on
tolerances of tests/test_torch_skip.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dip_tpu.fit import engine as jeng  # noqa: E402
from dip_tpu.models import Skip as FlaxSkip  # noqa: E402
from dip_tpu.ops import dispatch  # noqa: E402
from dip_tpu.tasks import activation_maximization as jam  # noqa: E402
from dip_tpu.tasks import feature_inversion as jfi  # noqa: E402
from dip_tpu_torch import interop  # noqa: E402
from dip_tpu_torch.models import Skip  # noqa: E402
from dip_tpu_torch.pretrained import backbones as tbb  # noqa: E402
from dip_tpu_torch.tasks import activation_maximization as tam  # noqa: E402
from dip_tpu_torch.tasks import feature_inversion as tfi  # noqa: E402
from dip_tpu_torch.tasks.base import run_task  # noqa: E402

IMSIZE, NET = 67, 128      # the spec tests: AlexNet's crop of the recipe's net
STEPS = 5
# the trajectories' generators (see the module docstring) and their sizes
FI_NET = dict(num_channels_down=[16, 32], num_channels_up=[16, 32], num_channels_skip=[4, 4],
              filter_size_down=[7, 7], filter_size_up=[7, 7], upsample_mode="nearest",
              downsample_mode="avg", pad="zero")
AM_NET = dict(num_channels_down=[16, 128, 128], num_channels_up=[16, 128, 128],
              num_channels_skip=[4] * 3, filter_size_down=[5, 3, 3], filter_size_up=[5, 3, 3],
              upsample_mode="nearest", downsample_mode="avg", pad="reflection")
FI_SIZE, AM_SIZE = 68, 32


def _checkpoint(factory, name, size):
    model = tbb.get_backbone(name, size)
    model.reset_parameters(torch.Generator().manual_seed(11))
    path = factory.mktemp("ckpt") / f"{name}.pth"
    torch.save(model.state_dict(), path)
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """An AlexNet checkpoint at 67^2 with seeded random weights, caffe keys."""
    return _checkpoint(tmp_path_factory, "alexnet_caffe", IMSIZE)


@pytest.fixture(scope="module")
def vgg_weights(tmp_path_factory):
    """A VGG16 checkpoint at 32^2, caffe keys."""
    return _checkpoint(tmp_path_factory, "vgg16_caffe", AM_SIZE)


def _content():
    return np.random.default_rng(0).random((1, IMSIZE, IMSIZE, 3)).astype(np.float32)


def _fields(t, j):
    """The spec's and the fit config's fields, and the generator's
    configuration, equal in both packages."""
    for f in ("name", "input_depth", "input_method", "input_var", "spatial_size"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("num_iter", "lr", "reg_noise_std", "param_noise", "reg_noise_schedule",
              "exp_weight", "backtrack", "optimizer"):
        assert getattr(t.cfg, f) == getattr(j.cfg, f), f
    tm, jm = t.model, j.model
    assert tm.ch_skip == list(jm.num_channels_skip) == [4] * 6
    assert tm.k_up == list(jm.filter_size_up) and tm.k_down == list(jm.filter_size_down)
    assert tm.up_modes == [jm.upsample_mode] * 6 and tm.down_modes == [jm.downsample_mode] * 6
    assert tm.pad == jm.pad and tm.need_sigmoid == jm.need_sigmoid
    assert tm.convs[0].weight.shape[1] == t.input_depth
    out = torch.zeros(1, *t.spatial_size, 3)
    assert tuple(t.postprocess(out).shape) == tuple(j.postprocess(jnp.asarray(out)).shape)


def test_feature_inversion_spec_matches_jax(weights):
    """FeatureInversion's spec and big_run_spec: every field, the stored
    statistics of the content image (relative 1e-5: f32, sums in another
    order), the recipe's defaults (fc6, 3100 steps at lr 1e-3, net at
    256, zero pad; the big run's staged jitter)."""
    content = _content()
    kw = dict(weights_path=weights, imsize=IMSIZE, imsize_net=NET)
    jf = jfi.FeatureInversion("alexnet_caffe", ("fc6", "conv2"), what="gram_matrix", **kw)
    tf = tfi.FeatureInversion("alexnet_caffe", ("fc6", "conv2"), what="gram_matrix", **kw,
                              device="cpu")
    j, t = jf.spec(content), tf.spec(content)
    _fields(t, j)
    assert (t.cfg.num_iter, t.cfg.lr, t.model.pad) == (3100, 1e-3, "zero")
    assert set(t.aux["stored"]) == {"fc6", "conv2"}
    for k, v in t.aux["stored"].items():
        want = np.asarray(j.aux["stored"][k])
        assert tuple(v.shape) == want.shape
        np.testing.assert_allclose(v.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    jb, tb = jfi.big_run_spec(jf, content), tfi.big_run_spec(tf, content)
    _fields(tb, jb)
    assert tb.cfg.reg_noise_schedule == ((10000, 10.0), (15000, 2.0), (20000, 0.5))
    default = tfi.FeatureInversion(device="cpu")
    assert (default.imsize, default.imsize_net) == (227, 256)
    with pytest.raises(ValueError):
        tf.spec(np.zeros((1, 64, 64, 3), np.float32))


@pytest.mark.parametrize("layer", ["conv4", "fc8"])
def test_activation_maximization_spec_matches_jax(weights, layer):
    """The recipe's defaults and its rules: 'maximize' at lr 1e-3 for a
    conv layer, 'am_match' at lr 1e-2 for fc8; jitter 0.03 and weight
    jitter on; reflection padding, so that the two deepest decoder scales
    take the fused seam."""
    kw = dict(weights_path=weights, imsize=IMSIZE, imsize_net=NET)
    j = jam.task(layer=layer, **kw)
    t = tam.task(layer=layer, **kw, device="cpu")
    _fields(t, j)
    assert t.cfg.lr == (1e-2 if layer == "fc8" else 1e-3)
    assert (t.cfg.reg_noise_std, t.cfg.param_noise, t.model.pad) == (0.03, True, "reflection")


def _small(spec, net: dict, size: int):
    """The spec with the trajectories' generator of `net` at size^2 (flax
    or port, as the spec's own model), STEPS steps at lr 1e-3, no jitter."""
    if isinstance(spec.model, Skip):
        model = Skip(num_input_channels=spec.input_depth, **net)
    else:
        model = FlaxSkip(**net)
    cfg = dataclasses.replace(spec.cfg, num_iter=STEPS, lr=1e-3, reg_noise_std=0.0,
                              param_noise=False, log_every=STEPS)
    return dataclasses.replace(spec, model=model, cfg=cfg, spatial_size=(size, size))


def _z(size, depth=32):
    return (np.random.default_rng(5).random((1, size, size, depth)) * 0.1).astype(np.float32)


def _jax_points(spec, z, seam: bool) -> list:
    """STEPS steps of the JAX Engine from its init (the seam on or off):
    at each step's params, (params, loss, render before postprocess,
    gradients of the loss), as numpy. One jitted program takes the
    gradients and the Engine's step together."""
    je = jeng.Engine(spec.model, spec.loss_fn, spec.cfg, spec.metrics_fn)
    zj = jnp.asarray(z)

    def loss_of(p):
        out = spec.model.apply({"params": p}, zj)
        return spec.loss_fn({"net": p}, out, spec.aux), out

    def point_and_step(state):
        (loss, out), g = jax.value_and_grad(loss_of, has_aux=True)(state.params["net"])
        state, metrics = je.step(state, spec.aux)
        return state, (loss, out, g, metrics["loss"])

    with dispatch.override(up_conv="on" if seam else "off"):
        state = je.init_state(jax.random.key(0), zj)
        fn = jax.jit(point_and_step)
        points = []
        for _ in range(STEPS):
            params = jax.tree_util.tree_map(np.asarray, state.params["net"])
            state, (loss, out, g, step_loss) = fn(state)
            np.testing.assert_allclose(float(step_loss), float(loss), rtol=1e-6)
            points.append((params, float(loss), np.asarray(out),
                           jax.tree_util.tree_map(np.asarray, g)))
    return points


def _grad_err(got: dict, want: dict) -> float:
    """Largest gradient error over the net, relative to the largest
    gradient of `want` (as tests/test_torch_skip.py measures it: a conv
    bias before a BN has a gradient that is rounding noise, so no
    per-tensor norm)."""
    g_max = max(float(np.abs(w).max()) for w in want.values())
    return max(float(np.abs(got[k] - want[k]).max()) for k in want) / g_max


def _port_point(model, params, z, loss_of, dtype):
    """The port model at the flax `params` in `dtype`: (render, loss,
    gradients by state_dict name), as float64 numpy."""
    model = model.to(dtype)
    model.load_state_dict(interop.flax_to_state_dict(params, model), strict=True)
    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(z).to(dtype))
    loss = loss_of(out)
    loss.backward()
    grads = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    model.to(torch.float32)
    return out.detach().double().numpy(), loss.item(), grads


def _hold(spec, points, z, ref_loss, tol: dict) -> None:
    """At each JAX point, the port (its model as the spec configures it, in
    f32) against the JAX package and against f64: the port's model with
    the seam off and the task's loss on a backbone in f64 (`ref_loss`).
    The render and the loss within tol['out'] (abs) and tol['loss'] (rel)
    of both; the gradients no further from each than twice the JAX
    package's own distance from f64 plus tol['grad'] of the largest
    gradient. At some points of these random nets a ReLU or a max sits at
    its kink, and either package's f32 gradient leaves f64 by up to 7e-3
    of the largest (10x more with the seam's bf16 operands), so a fixed
    limit would hold the port to what the reference itself misses."""
    seam = spec.model.up_conv
    for i, (params, want_loss, want_out, want_g) in enumerate(points):
        out, loss, got = _port_point(spec.model, params, z,
                                     lambda o: spec.loss_fn(None, o, spec.aux), torch.float32)
        spec.model.up_conv = False
        out64, loss64, g64 = _port_point(spec.model, params, z, ref_loss, torch.float64)
        spec.model.up_conv = seam
        want_g = {k: v.numpy().astype(np.float64)
                  for k, v in interop.flax_to_state_dict(want_g, spec.model).items()}
        ref_err = _grad_err(want_g, g64)
        for what, err in (("jax", _grad_err(got, want_g)), ("f64", _grad_err(got, g64))):
            assert err <= 2 * ref_err + tol["grad"], (i, what, err, ref_err)
        for ref_out, ref_loss_i in ((want_out, want_loss), (out64, loss64)):
            np.testing.assert_allclose(out, ref_out, atol=tol["out"], rtol=0,
                                       err_msg=f"step {i}")
            np.testing.assert_allclose(loss, ref_loss_i, rtol=tol["loss"], err_msg=f"step {i}")
    assert points[-1][1] < points[0][1]


def _extractor64(backbone, layers, weights, size):
    """The task's extractor on a backbone in f64 (same checkpoint)."""
    extract, model, _ = tfi.build_extractor(backbone, layers, weights, size, device="cpu")
    model.double()
    return extract


F32_TOL = dict(out=2e-5, loss=1e-5, grad=2e-3)


def test_feature_inversion_steps_match_jax_engine(weights):
    """5 JAX Engine steps of feature inversion at AlexNet fc6 (the
    recipe's tap), f32, the seam off (the zero-padded net has none); at
    each step's params the port held as _hold says, to F32_TOL (readings:
    render 3.2e-6, loss 1.5e-6 relative, gradients 4.8e-4 of the largest
    from JAX and from f64 where JAX is 9.5e-6 from f64). The steps are held
    at the JAX trajectory's params: Adam's first step is lr * sign(g) per
    element, so the elements whose gradient is rounding noise (a conv bias
    before a BN, weights whose terms cancel) take +-lr steps that differ
    between two free runs, and their losses part by 0.7 % within 4 steps
    here."""
    content = _content()
    kw = dict(weights_path=weights, imsize=IMSIZE)
    j = _small(jfi.task(content, **kw), FI_NET, FI_SIZE)
    t = _small(tfi.task(content, **kw, device="cpu"), FI_NET, FI_SIZE)
    z = _z(FI_SIZE)
    extract = _extractor64("alexnet_caffe", ("fc6",), weights, IMSIZE)
    stored = extract(torch.from_numpy(content).double())["fc6"]

    def ref_loss(out):
        return torch.mean((extract(out[:, :IMSIZE, :IMSIZE])["fc6"] - stored) ** 2)

    _hold(t, _jax_points(j, z, seam=False), z, ref_loss, F32_TOL)
    assert tuple(t.postprocess(torch.zeros(1, FI_SIZE, FI_SIZE, 3)).shape) == (
        1, IMSIZE, IMSIZE, 3)


def test_run_task_renders_the_crop_and_trains_only_the_generator(weights):
    """run_task on the CPU: the render is the classifier's crop of the
    net's output, finite; the backbone's weights take no gradient and do
    not move; the engine trains the generator alone."""
    fi = tfi.FeatureInversion(layers=("conv3",), weights_path=weights, imsize=IMSIZE,
                              imsize_net=NET, num_iter=2, device="cpu")
    before = {k: v.clone() for k, v in fi.backbone.state_dict().items()}
    spec = fi.spec(_content())
    spec = dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, log_every=2))
    out, state, hist = run_task(spec, 0, device="cpu")
    assert tuple(out.shape) == (1, IMSIZE, IMSIZE, 3) and torch.isfinite(out).all()
    assert np.isfinite(hist["loss"]).all() and len(hist["loss"]) == 2
    assert set(state.params) == set(dict(spec.model.named_parameters()))
    for k, p in fi.backbone.named_parameters():
        assert not p.requires_grad and p.grad is None, k
        assert torch.equal(p, before[k]), k


# (name, the Skip's configuration, input size): the inversion net with
# reflection padding (activation maximization's) and zero padding (feature
# inversion's), the flagship's kind of net, one at a size whose halvings
# are ragged (a skip of another size than the upsampled part: that scale
# upsamples and crops), and restoration 'kate''s avg-pool downsampling
SEAM_COUNT_CASES = [
    ("inversion reflection", dict(pad="reflection"), (128, 128)),
    ("inversion zero", dict(pad="zero"), (128, 128)),
    ("flagship kind", dict(num_channels_down=[8] * 4, num_channels_up=[8] * 4,
                           num_channels_skip=[4] * 4, upsample_mode="bilinear",
                           pad="reflection"), (48, 64)),
    ("ragged", dict(num_channels_down=[8] * 4, num_channels_up=[8] * 4,
                    num_channels_skip=[4, 0, 4, 4], pad="reflection"), (44, 76)),
    ("avg down", dict(num_channels_down=[8] * 3, num_channels_up=[8] * 3,
                      num_channels_skip=[0] * 3, downsample_mode="avg",
                      pad="reflection"), (36, 52)),
]


@pytest.mark.parametrize("name,net,size", SEAM_COUNT_CASES)
def test_chip_smoke_counts_the_fused_seams(monkeypatch, name, net, size):
    """chip_smoke.fused_scales, which sets the seam launches the card run
    demands of each fit, against the seams Skip.forward fuses on the CPU
    (each a call of up2_conv3x3); and the
    activation-maximization net at the recipe's 256^2 fuses exactly its two
    deepest scales (LR 4 and 8)."""
    import chip_smoke
    from dip_tpu_torch.models import blocks

    if name.startswith("inversion"):
        model = tfi.inversion_net(pad=net["pad"], num_input_channels=4)
    else:
        model = Skip(num_input_channels=4, **net)
    model.reset_parameters(torch.Generator().manual_seed(0))
    calls = []
    real = blocks.up2_conv3x3

    def counted(x, *args, **kw):
        calls.append(x.shape)
        return real(x, *args, **kw)

    monkeypatch.setattr(blocks, "up2_conv3x3", counted)
    with torch.no_grad():
        model(torch.rand(1, *size, 4, generator=torch.Generator().manual_seed(1)))
    fused = chip_smoke.fused_scales(model, size)
    assert len(calls) == sum(fused)
    if name == "ragged":
        assert 0 < sum(fused) < len(fused)
    assert chip_smoke.fused_scales(tfi.inversion_net(pad="reflection"), (256, 256)) == (
        [False] * 4 + [True] * 2)
    assert chip_smoke.fused_scales(tfi.inversion_net(pad="zero"), (256, 256)) == [False] * 6
