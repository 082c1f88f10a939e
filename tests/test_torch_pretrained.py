"""The port's frozen backbones, LRN, Matcher, checkpoint conversion and
PerceptualLoss against the JAX package on the CPU, on the same weights and
inputs (the flax params carried from the port's init by interop, or read
by both packages from one locally written .pth). f32 on both sides; the
JAX side runs at 'highest' matmul precision (tests/conftest.py)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dip_tpu.pretrained import backbones as jbb  # noqa: E402
from dip_tpu.pretrained import convert as jconvert  # noqa: E402
from dip_tpu.pretrained.matcher import Matcher as JMatcher  # noqa: E402
from dip_tpu.pretrained.perceptual import PerceptualLoss as JPerceptualLoss  # noqa: E402
from dip_tpu_torch import interop  # noqa: E402
from dip_tpu_torch.pretrained import backbones as tbb  # noqa: E402
from dip_tpu_torch.pretrained import convert as tconvert  # noqa: E402
from dip_tpu_torch.pretrained.matcher import Matcher as TMatcher  # noqa: E402
from dip_tpu_torch.pretrained.perceptual import PerceptualLoss as TPerceptualLoss  # noqa: E402

VGG_CONV_TAPS = ("conv1_1", "relu1_2", "pool1", "conv2_2", "pool2", "relu3_1", "conv4_2",
                 "pool4", "relu5_1")
FC_TAPS = {"vgg": ("pool5", "fc6", "relu6", "fc7", "relu7", "fc8"),
           "alexnet": ("pool5", "fc6", "relu6", "fc7", "relu7", "fc8", "softmax")}
# (backbone, input size, taps): conv and pool taps of every backbone at a
# small size, fc taps at one size per family
CASES = [
    ("vgg19_caffe", 48, VGG_CONV_TAPS + ("conv5_4", "pool5")),
    ("vgg16_caffe", 40, VGG_CONV_TAPS + ("conv5_3",)),
    ("vgg19_pytorch_modified", 36, VGG_CONV_TAPS + ("pool5",)),
    ("alexnet_caffe", 67, ("conv1", "relu1", "norm1", "pool1", "conv2", "norm2", "pool2",
                           "conv3", "relu3", "conv4", "conv5", "relu5")),
    ("vgg19_caffe", 32, FC_TAPS["vgg"]),
    ("alexnet_caffe", 67, FC_TAPS["alexnet"]),
]
# forward: max |port - jax| over a tap / max |jax| of that tap; the input
# gradient: max error / max |jax| of the gradient. f32 on both sides, sums
# in another order (readings over CASES: forward 1.1e-6 to 2.2e-6,
# gradient 2.5e-7 to 2.0e-6)
FWD_TOL, GRAD_TOL = 2e-5, 2e-5


@functools.lru_cache(maxsize=None)
def _weights(name, size, seed):
    model = tbb.get_backbone(name, size)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.state_dict()


def _port(name, size, seed=0):
    """The port's backbone with weights drawn from `seed` (drawn once per
    file: the fc layers' draws take most of a second on one core)."""
    model = tbb.get_backbone(name, size)
    model.load_state_dict(_weights(name, size, seed))
    return model


def _check_tree(fmodel, params, x, deepest):
    want = jax.eval_shape(lambda k: fmodel.init(k, jnp.asarray(x), taps=(deepest,)),
                          jax.random.key(0))["params"]
    got = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert jax.tree_util.tree_leaves(got) == jax.tree_util.tree_leaves(want)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name,size,taps", CASES)
def test_backbone_matches_flax(name, size, taps):
    """Every tap within FWD_TOL and the input gradient of a random linear
    functional of all taps within GRAD_TOL; interop's map of the weights
    matches flax's own tree (names, shapes, dtypes) and goes back to the
    port bit for bit; every port parameter is frozen."""
    model = _port(name, size)
    assert all(not p.requires_grad for p in model.parameters())
    fmodel = jbb.get_backbone(name)
    rng = np.random.default_rng(1)
    x = rng.uniform(-60, 60, (1, size, size, 3)).astype(np.float32)
    params = interop.state_dict_to_flax(model.state_dict(), model)
    deepest = "softmax" if name.startswith("alexnet") else "fc8"
    _check_tree(fmodel, params, x, deepest)
    back = interop.flax_to_state_dict(params, model)
    assert set(back) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k

    def f(p, xx):
        return fmodel.apply({"params": p}, xx, taps=taps)

    shapes = jax.eval_shape(f, params, jnp.asarray(x))
    weights = {t: rng.normal(size=shapes[t].shape).astype(np.float32) for t in taps}

    def loss(xx, p):
        acts = f(p, xx)
        return sum(jnp.sum(acts[t] * weights[t]) for t in taps), acts

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(x), params)
    xt = torch.from_numpy(x).requires_grad_()
    got = model(xt, taps)
    assert set(got) == set(taps)
    total = sum(torch.sum(got[t] * torch.from_numpy(weights[t])) for t in taps)
    total.backward()
    for t in taps:
        assert tuple(got[t].shape) == tuple(want[t].shape), t
        assert _rel(got[t].detach().numpy(), np.asarray(want[t])) < FWD_TOL, t
    assert _rel(xt.grad.numpy(), np.asarray(want_g)) < GRAD_TOL


def test_backbone_shapes_and_unknown_taps():
    """The fc6 width follows imsize (9216 for AlexNet at 227, 25088 for VGG
    at 224), computation stops at the deepest tap, unknown taps and
    backbones raise."""
    assert tbb.get_backbone("alexnet_caffe").fc6.weight.shape == (4096, 9216)
    assert tbb.get_backbone("vgg16_caffe").fc6.weight.shape == (4096, 25088)
    assert tbb.get_backbone("vgg19_caffe", 64).fc6.weight.shape == (4096, 2048)
    model = _port("vgg19_caffe", 32)
    calls = []
    model.conv3_1.register_forward_hook(lambda m, i, o: calls.append("conv3_1"))
    model(torch.zeros(1, 32, 32, 3), ("relu2_2",))
    assert calls == []
    with pytest.raises(ValueError):
        model(torch.zeros(1, 32, 32, 3), ("conv9",))
    with pytest.raises(ValueError):
        _port("alexnet_caffe", 67)(torch.zeros(1, 67, 67, 3), ("conv6",))
    with pytest.raises(ValueError):
        tbb.get_backbone("resnet50")


def test_preprocess_matches_jax():
    rgb = np.random.default_rng(2).random((2, 5, 7, 3)).astype(np.float32)
    t = torch.from_numpy(rgb)
    for tf, jf in ((tbb.vgg_preprocess_caffe, jbb.vgg_preprocess_caffe),
                   (tbb.pytorch_preprocess, jbb.pytorch_preprocess)):
        np.testing.assert_allclose(tf(t).numpy(), np.asarray(jf(jnp.asarray(rgb))),
                                   rtol=1e-6, atol=1e-5)
    bgr = tbb.vgg_preprocess_caffe(t)
    np.testing.assert_allclose(tbb.vgg_deprocess_caffe(bgr).numpy(),
                               np.asarray(jbb.vgg_deprocess_caffe(jnp.asarray(bgr.numpy()))),
                               atol=1e-6)
    np.testing.assert_allclose(tbb.vgg_deprocess_caffe(bgr).numpy(), rgb, atol=1e-5)


@pytest.mark.parametrize("size,scale", [(5, 1.0), (5, 60.0), (3, 200.0)])
def test_lrn_matches_flax(size, scale):
    """LRN alone, across channels, with alpha undivided by the window: the
    window term matters only at caffe's activation scale (tens to
    hundreds), and a 3-wide window on 8 channels checks the edges;
    relative 1e-6 (f32, the same sums)."""
    x = (np.random.default_rng(3).normal(size=(2, 6, 5, 8)) * scale).astype(np.float32)
    want = np.asarray(jbb.LRN(size=size).apply({}, jnp.asarray(x)))
    got = tbb.LRN(size=size)(torch.from_numpy(x)).numpy()
    assert _rel(got, want) < 1e-6
    if scale > 1:
        assert np.abs(want - x).max() > 1e-2 * np.abs(x).max()  # the window bites


# (how, loss, method, map_index, window): every match mode x loss, and the
# maximize / am_match objectives on conv taps (a wrapped window at h = 28,
# ws = 20; the whole map at h = 13; an inner window) and on fc taps
MATCHER_CASES = [(how, loss, "match", None, 20) for how in ("features", "gram_matrix")
                 for loss in ("mse", "L1", "smoothL1")]
MATCHER_CASES += [("features", "mse", method, 3, ws) for method in ("maximize", "am_match")
                  for ws in (20, 5)]


@pytest.mark.parametrize("how,loss,method,map_index,ws", MATCHER_CASES)
def test_matcher_matches_jax(how, loss, method, map_index, ws):
    """Each objective's value per tap (relative 1e-6, f32) and its gradient
    with respect to the activations (1e-6 of the largest), on conv taps of
    28^2, 13^2 and 9^2 and an fc tap, the stored targets detached."""
    rng = np.random.default_rng(4)
    acts = {"a": rng.normal(size=(1, 28, 28, 8)) * 1.5, "b": rng.normal(size=(1, 13, 13, 6)),
            "c": rng.normal(size=(1, 9, 9, 5)) * 300, "fc": rng.normal(size=(1, 16)) * 40}
    acts = {k: v.astype(np.float32) for k, v in acts.items()}
    targets = {k: (v + rng.normal(size=v.shape) * 0.8).astype(np.float32)
               for k, v in acts.items()}
    jm = JMatcher(how=how, loss=loss, map_index=map_index, method=method, window_size=ws)
    tm = TMatcher(how=how, loss=loss, map_index=map_index, method=method, window_size=ws)
    jstored = jm.store({k: jnp.asarray(v) for k, v in targets.items()})
    tt = {k: torch.from_numpy(v).requires_grad_() for k, v in targets.items()}
    tstored = tm.store(tt)
    assert all(not v.requires_grad for v in tstored.values())
    for k in targets:
        np.testing.assert_allclose(tstored[k].numpy(), np.asarray(jstored[k]), rtol=1e-5,
                                   atol=1e-7)
    stored = jstored if method == "match" else None

    def per_tap(a):
        return jm.losses(a, stored)

    want = per_tap({k: jnp.asarray(v) for k, v in acts.items()})
    want_g = jax.grad(lambda a: jm.total(a, stored))({k: jnp.asarray(v) for k, v in acts.items()})
    ta = {k: torch.from_numpy(v).requires_grad_() for k, v in acts.items()}
    got = tm.losses(ta, tstored if method == "match" else None)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    tm.total(ta, tstored if method == "match" else None).backward()
    g_max = max(float(np.abs(np.asarray(v)).max()) for v in want_g.values())
    for k in want_g:
        err = float(np.abs(ta[k].grad.numpy() - np.asarray(want_g[k])).max())
        assert err <= 1e-6 * g_max, k


def test_matcher_window_wraps_as_python_slices():
    """At h = 28, ws = 20 the window starts at 14 - 20 = -6 and, cut with
    Python's slice rules, holds rows and columns 22..27 in both packages;
    at h = 13 it holds the whole map. No clamp."""
    x = np.zeros((1, 28, 28, 2), np.float32)
    x[0, 22:, 22:, 1] = 1.0
    x[0, :22, :, 1] = 100.0
    m = TMatcher(method="maximize", map_index=1, window_size=20)
    assert m.losses({"t": torch.from_numpy(x)})["t"].item() == -36.0
    jm = JMatcher(method="maximize", map_index=1, window_size=20)
    assert float(jm.losses({"t": jnp.asarray(x)})["t"]) == -36.0
    y = np.ones((1, 13, 13, 2), np.float32)
    assert m.losses({"t": torch.from_numpy(y)})["t"].item() == -169.0
    with pytest.raises(ValueError):
        TMatcher().losses({"t": torch.from_numpy(y)})  # 'match' without targets
    with pytest.raises(ValueError):
        TMatcher(how="moments")
    with pytest.raises(ValueError):
        TMatcher(loss="huber")


def _state_dict_torchvision(model, depth):
    """The port VGG's weights under torchvision's keys
    ('features.N.*', 'classifier.N.*'), as numpy arrays."""
    idx = {v: k for k, v in (jconvert._VGG19_IDX if depth == 19
                             else jconvert._VGG16_IDX).items()}
    cls = {"fc6": 0, "fc7": 3, "fc8": 6}
    out = {}
    for k, v in model.state_dict().items():
        layer, leaf = k.split(".")
        key = (f"features.{idx[layer]}" if layer in idx else f"classifier.{cls[layer]}")
        out[f"{key}.{leaf}"] = v.clone()
    return out


@pytest.mark.parametrize("name,size,layout", [
    ("vgg16_caffe", 32, "torchvision"), ("vgg19_caffe", 32, "torchvision"),
    ("alexnet_caffe", 67, "caffe")])
def test_convert_checkpoint_matches_jax(tmp_path, name, size, layout):
    """A .pth written here (torchvision's VGG16 / VGG19 keys, or caffe
    AlexNet's 'conv1.weight' ...) through load_torch_weights and
    apply_converted in both packages onto differently seeded backbones:
    every layer is overwritten (the port's equals the checkpoint bit for
    bit) and the taps agree to FWD_TOL. A layer of the wrong shape in the
    checkpoint is skipped in both."""
    src = _port(name, size, seed=7)
    state = (_state_dict_torchvision(src, 16 if "16" in name else 19)
             if layout == "torchvision" else dict(src.state_dict()))
    wrong = "classifier.6.weight" if layout == "torchvision" else "fc8.weight"
    state[wrong] = torch.zeros(3, 5)
    path = tmp_path / f"{name}.pth"
    torch.save(state, path)

    port = _port(name, size, seed=8)
    keep_fc8 = port.fc8.weight.clone()
    conv = tconvert.load_torch_weights(str(path))
    tconvert.apply_converted(port, conv)
    for k, v in src.state_dict().items():
        if k == "fc8.weight":
            assert torch.equal(port.fc8.weight, keep_fc8)
        else:
            assert torch.equal(port.state_dict()[k], v), k
    assert tconvert.load_torch_weights(str(tmp_path / "missing.pth")) is None

    fmodel = jbb.get_backbone(name)
    base = interop.state_dict_to_flax(_port(name, size, seed=8).state_dict(), port)
    jvars = jconvert.apply_converted({"params": base}, jconvert.load_torch_weights(str(path)))
    taps = (("conv3", "fc6", "fc8") if name.startswith("alexnet")
            else ("conv3_2", "pool5", "fc7", "fc8"))
    x = np.random.default_rng(5).uniform(-50, 50, (1, size, size, 3)).astype(np.float32)
    want = jax.jit(lambda v, xx: fmodel.apply(v, xx, taps=taps))(jvars, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x), taps)
    for t in taps:
        assert _rel(got[t].numpy(), np.asarray(want[t])) < FWD_TOL, t


@pytest.mark.parametrize("input_range", ["sigmoid", "tanh"])
def test_perceptual_loss_matches_jax(tmp_path, input_range):
    """PerceptualLoss on VGG16 at 32^2 (features at relu1_2 under mse,
    Gram matrices at conv2_1 under L1) with one checkpoint loaded by both
    packages: the value (relative 1e-5) and the input gradient (1e-4 of
    the largest) in both input ranges; zero on equal inputs."""
    src = _port("vgg16_caffe", 32, seed=3)
    path = tmp_path / "vgg16.pth"
    torch.save(src.state_dict(), path)
    match = [{"layers": ("relu1_2",), "what": "features"},
             {"layers": ("conv2_1",), "what": "gram_matrix", "loss": "L1"}]
    kw = dict(net_type="vgg16_caffe", match=match, weights_path=str(path),
              input_range=input_range, imsize=32)
    jpl = JPerceptualLoss(**kw)
    tpl = TPerceptualLoss(**kw, device="cpu")
    lo = -1.0 if input_range == "tanh" else 0.0
    rng = np.random.default_rng(6)
    x, y = (rng.uniform(lo, 1.0, (1, 32, 32, 3)).astype(np.float32) for _ in range(2))
    want, want_g = jax.value_and_grad(lambda a: jpl(a, jnp.asarray(y)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tpl(xt, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert _rel(xt.grad.numpy(), np.asarray(want_g)) < GRAD_TOL
    assert tpl(torch.from_numpy(x), torch.from_numpy(x)).item() == 0.0


def test_extractor_defaults_to_cuda_and_needs_its_checkpoint(tmp_path):
    """No fallback: build_extractor (and so every FI / AM / perceptual
    entry point) runs on 'cuda' unless told otherwise, and a checkpoint
    path that does not exist raises."""
    from dip_tpu_torch.tasks.feature_inversion import build_extractor

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            build_extractor("alexnet_caffe", ("conv1",), imsize=67)
    with pytest.raises(FileNotFoundError):
        build_extractor("alexnet_caffe", ("conv1",), str(tmp_path / "no.pth"), imsize=67,
                        device="cpu")
