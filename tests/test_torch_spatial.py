"""The port's SpatialEngine (dip_tpu_torch/parallel/spatial.py) on the CPU:
the unsharded path bit for bit what it was before the model's ops took row
blocks, each op on row blocks (ops/rows.Rows) against the same op on the
image over a mesh that repeats 'cpu',
the sharded fit against the port's Engine, against the JAX Engine in this
process and against the JAX SpatialEngine in a subprocess, and the
refusals.

Tolerances. The sharded ops take the same inputs as the unsharded ones:
the f32 forward within 1e-6 and every gradient within 1e-5 of the largest
(sums in another order: each block's conv, the BN sums per block). The
seam's operands are rounded to bf16 on both sides from the same values,
so the seam's op test holds it to the same limits. The fits: in f32 with
the seam off, one step's loss and every gradient within 1e-5 (of the
loss, of the largest gradient), five steps at lr 1e-3 with input and
weight jitter on (the same draws) at rtol 1e-4. With the seam on, BN's
sums in another order move its f32 operands by an ulp, which flips some
of their roundings to bf16 (hazard 2 of ROADMAP.md: the seam rounds its
operands in f32 fits too) and moves those elements by 2^-8 of themselves:
one step's loss within 1e-4, gradients within 5e-3 of the largest
(tests/test_torch_batch.py's seam-on limit; 2.4e-3 seen), the trajectory
at rtol 1e-3. In bf16 every activation is rounded, and a sum in another
order flips roundings everywhere: the loss within 1e-3, the gradients
within 1e-1 of the largest (chip_smoke.BATCH_GRAD_TOL's bf16 limit; 4.2e-2
seen, on a BN-fed conv bias, whose exact gradient is 0), the trajectory at
rtol 5e-3.
"""

import os
import shutil
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
from dip_tpu.ops import dispatch  # noqa: E402
from dip_tpu.ops.losses import mse as jmse  # noqa: E402
from dip_tpu_torch import interop  # noqa: E402
from dip_tpu_torch.fit import engine as teng  # noqa: E402
from dip_tpu_torch.models import DCGAN, Skip, UNet  # noqa: E402
from dip_tpu_torch.models.blocks import Conv, TrainBatchNorm, concat_cropped  # noqa: E402
from dip_tpu_torch.ops.losses import mse  # noqa: E402
from dip_tpu_torch.ops.pad import pad2d  # noqa: E402
from dip_tpu_torch.ops.resample import upsample  # noqa: E402
from dip_tpu_torch.ops.up_conv import Up2, up2_conv3x3, up2_moments  # noqa: E402
from dip_tpu_torch.ops.rows import Rows, cut_rows, gather_rows  # noqa: E402
from dip_tpu_torch.parallel import spatial as SP  # noqa: E402
from dip_tpu_torch.parallel.mesh import Mesh  # noqa: E402

CPU = torch.device("cpu")
FLAG = dict(num_channels_down=[8, 8, 8], num_channels_up=[8, 8, 8],
            num_channels_skip=[4, 4, 4], upsample_mode="bilinear", pad="reflection")
# tests/test_parallel.py's SpatialEngine geometry: 64^2, 8 shards, 1 scale
JAX_NET = dict(num_channels_down=[8], num_channels_up=[8], num_channels_skip=[2])
DEPTH = 4


def _normal(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def _rows(x, n):
    return cut_rows(x, [CPU] * n)


def _check(fn, inputs, n, fwd_tol=1e-6, grad_tol=1e-5, cut=None, fn_rows=None):
    """fn (or fn_rows) over n row blocks against fn on the image: the
    forward within fwd_tol of its largest, each input's gradient (under one
    random cotangent) within grad_tol of the largest. The first `cut`
    inputs (all by default) go in as row blocks, the rest whole."""
    cut = len(inputs) if cut is None else cut
    xs = [t.clone().requires_grad_() for t in inputs]
    ys = [t.clone().requires_grad_() for t in inputs]
    want = fn(*xs)
    got = (fn_rows or fn)(*[_rows(y, n) if i < cut else y for i, y in enumerate(ys)]).gather(CPU)
    assert got.shape == want.shape
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= fwd_tol * scale
    cot = _normal(tuple(want.shape), 99)
    gw = torch.autograd.grad(want, xs, cot.clone())
    gg = torch.autograd.grad(got, ys, cot.clone())
    g_max = max(g.abs().max().item() for g in gw)
    for a, b in zip(gw, gg):
        assert (a - b).abs().max().item() <= grad_tol * g_max


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["zero", "reflection", "replication"])
@pytest.mark.parametrize("p", [1, 2])
def test_halo_pad(n, mode, p):
    """Each block with p halo rows (the mode's own rows past the image's
    top and bottom) is its slice of the padded image, forward and
    backward; at n = 4 with H = 4 every block is one row, so a reflection
    of p rows reads the neighbours' neighbours."""
    x = _normal((1, 4 if n == 4 else 6, 5, 3), 1)
    h = x.shape[1] // n

    def whole(t):
        return pad2d(t, (p, 0), mode)

    def rows(r):
        return Rows([gather_rows(r, k, r.starts[k] - p, r.starts[k] + h + p,
                                 {"zero": "constant", "reflection": "reflect",
                                  "replication": "replicate"}[mode])[:, p if k else 0:
                                                                     h + p if k < n - 1
                                                                     else h + 2 * p]
                     for k in range(n)])

    _check(whole, [x], n, fn_rows=rows)


@pytest.mark.parametrize("mode", ["reflection", "replication"])
def test_pad_backward_leaves_its_cotangent(mode):
    """pad2d's backward with H padded only (the halo tests' reference) folds
    into a copy: the cotangent autograd hands it is not written, so a node
    that shares it sees it whole."""
    x = _normal((1, 6, 5, 3), 15).requires_grad_()
    cot = _normal((1, 8, 5, 3), 16)
    kept = cot.clone()
    torch.autograd.grad(pad2d(x, (1, 0), mode), x, cot)
    assert torch.equal(cot, kept)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("ks,stride,pad,down", [
    (3, 1, "reflection", "stride"), (3, 2, "reflection", "stride"), (5, 2, "zero", "stride"),
    (3, 1, "zero", "stride"), (1, 1, "zero", "stride"), (3, 2, "replication", "avg"),
    (3, 2, "reflection", "max")])
def test_conv(n, ks, stride, pad, down):
    """Conv (stride 1 and 2, every pad, the avg and max post-downs) over
    row blocks against Conv on the image; the thinnest legal blocks: one
    row at stride 1, two at stride 2."""
    conv = Conv(6, 5, ks, stride, True, pad, down)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    x = _normal((1, n * (2 if stride == 2 else 1), 7, 6), 2)
    _check(conv, [x], n)


@pytest.mark.parametrize("n", [2, 4])
def test_conv_wgrad_routed(n):
    """The reflect-padded 3x3 and a 1x1 with conv_wgrad='all' (K5 at halo 0
    and K6's plain versions here) against the same convs unsharded."""
    for ks in (3, 1):
        conv = Conv(6, 5, ks, 1, True, "reflection")
        conv.reset_parameters(torch.Generator().manual_seed(1))
        x = _normal((1, 2 * n, 7, 6), 3)
        _check(lambda t: conv(t, conv_wgrad="all"), [x], n)
        w_whole = torch.autograd.grad(conv(x, conv_wgrad="all").square().sum(), conv.weight)[0]
        w_rows = torch.autograd.grad(
            conv(_rows(x, n), conv_wgrad="all").gather(CPU).square().sum(),
            conv.weight)[0]
        assert (w_rows - w_whole).abs().max() <= 1e-5 * w_whole.abs().max()


@pytest.mark.parametrize("n", [2, 4])
def test_bn_moments_and_affine(n):
    """Train-mode BN with the whole image's moments (the all-reduce of the
    blocks' f32 sums), on a tensor and on (tensor, Up2) parts; and the
    as_affine (s, t) folded into the next conv, against TrainBatchNorm and
    Conv on the image; 1-row blocks at n = 4."""
    bn = TrainBatchNorm(7)
    with torch.no_grad():
        bn.weight.copy_(_normal((7,), 4))
        bn.bias.copy_(_normal((7,), 5))
    x = _normal((1, n, 6, 7), 6) + 0.3
    _check(bn, [x], n)
    conv = Conv(7, 4, 3, 1, True, "reflection")
    conv.reset_parameters(torch.Generator().manual_seed(2))

    def whole(t):
        u, s, t_ = bn(t, as_affine=True)
        return conv(u, s, t_)

    _check(whole, [x], n)
    # (skip, Up2) parts: the Up2 part's HR moments from the LR blocks
    bn2 = TrainBatchNorm(7)
    lr = _normal((1, 2 * n, 3, 4), 7)
    sk = _normal((1, 4 * n, 6, 3), 8)

    def parts_whole(s_, l_):
        a, b = bn2([s_, Up2(l_, "bilinear")])
        return concat_cropped([a, upsample(b.x, 2, "bilinear")])

    xs = [sk.clone().requires_grad_(), lr.clone().requires_grad_()]
    ys = [sk.clone().requires_grad_(), lr.clone().requires_grad_()]
    want = parts_whole(*xs)
    got = parts_whole(_rows(ys[0], n), _rows(ys[1], n)).gather(CPU)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    cot = _normal(tuple(want.shape), 9)
    for a, b in zip(torch.autograd.grad(want, xs, cot), torch.autograd.grad(got, ys, cot)):
        assert (a - b).abs().max() <= 1e-5 * a.abs().max()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("up_mode", ["bilinear", "nearest"])
def test_up2_moments(n, up_mode):
    """The exact moments of the 2x upsample from LR row blocks of one row
    each (n = 4) or two, against up2_moments of the image."""
    x = _normal((1, n * (1 if n == 4 else 2), 5, 3), 10) + 0.5
    for a, b in zip(up2_moments(x, up_mode), up2_moments(_rows(x, n), up_mode)):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ga = torch.autograd.grad(sum(m.sum() for m in up2_moments(xa, up_mode)), xa)[0]
    gb = torch.autograd.grad(sum(m.sum() for m in up2_moments(_rows(xb, n), up_mode)), xb)[0]
    assert (ga - gb).abs().max() <= 1e-5 * ga.abs().max()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_upsample(n, mode):
    """The unfused 2x upsample over 1-row blocks (bilinear: one LR halo row
    a side) against upsample of the image."""
    x = _normal((1, n, 5, 3), 11)
    _check(lambda t: upsample(t, 2, mode), [x], n)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("up_mode,pad", [("bilinear", "reflection"), ("bilinear", "replication"),
                                         ("nearest", "reflection")])
@pytest.mark.parametrize("carry", [False, True])
def test_seam(n, up_mode, pad, carry):
    """The fused seam's plain path over blocks of two LR rows (its least):
    each block's edge-padded LR input with one halo row a side, the
    reflection corrections on the image's outer HR ring only, the carry-in
    per block; against up2_conv3x3 on the image."""
    x = _normal((1, 2 * n, 5, 6), 12)
    kernel = _normal((3, 3, 6, 4), 13) * 0.3
    cy = _normal((1, 4 * n, 10, 4), 14)
    inputs = [x] + ([cy] if carry else []) + [kernel]

    def seam(x_, *rest):
        return up2_conv3x3(x_, rest[-1], up_mode, pad, rest[0] if carry else None)

    _check(seam, inputs, n, cut=len(inputs) - 1)


def _data(size, seed=0):
    rng = np.random.default_rng(seed)
    z = (rng.random((1, size, size, DEPTH)) * 0.1).astype(np.float32)
    tgt = rng.random((1, size, size, 3)).astype(np.float32)
    return z, tgt


def _loss(p, out, aux):
    return mse(out, aux)


def _pair(net, size, n, cfg):
    """(loss, grads, 5-step history) of Engine and of SpatialEngine over
    Mesh(['cpu'] * n), from seed 0."""
    z, tgt = _data(size)
    runs = []
    for sharded in (False, True):
        model = Skip(num_input_channels=DEPTH, **net)
        eng = (SP.SpatialEngine(model, _loss, cfg, mesh=Mesh(["cpu"] * n, axis="sp"))
               if sharded else teng.Engine(model, _loss, cfg, device="cpu"))
        state = eng.init_state(0, torch.from_numpy(z))
        _, m = eng.step(state, torch.from_numpy(tgt))
        grads = {k: p.grad.clone() for k, p in state.params.items()}
        _, hist = eng.run(state, torch.from_numpy(tgt))
        runs.append((m["loss"].item(), grads, hist["loss"], eng.render(state)))
    return runs


# (net, image size, shards, compute dtype, loss tol, grad tol, trajectory rtol)
FITS = {
    "flagship-like seam off": (dict(FLAG, up_conv=False), 64, None, 1e-5, 1e-5, 1e-4),
    "flagship-like seam on": (FLAG, 64, None, 1e-4, 5e-3, 1e-3),
    "jax geometry": (JAX_NET, 64, None, 1e-5, 1e-5, 1e-4),
    "avg-pool down bf16": (dict(FLAG, downsample_mode="avg"), 64, "bfloat16", 1e-3, 1e-1, 5e-3),
    "carry, conv_wgrad, max-pool down": (
        dict(FLAG, seam_carry=True, conv_wgrad="all", downsample_mode="max"), 64, None, 1e-4,
        5e-3, 1e-3),
    "nearest seams, replication pad": (
        dict(FLAG, upsample_mode="nearest", pad="replication"), 64, None, 1e-4, 5e-3, 1e-3),
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(FITS))
def test_spatial_engine_matches_engine(name, n):
    """SpatialEngine against Engine from the same seed, input jitter 0.05
    and weight jitter on (the same draws), EMA 0.99: one step's loss and
    gradients, then five steps at lr 1e-3 and the render, at the limits
    of the module docstring. The JAX test's geometry runs on 8 shards at
    n = 4 (blocks of 8 rows)."""
    net, size, cd, loss_tol, grad_tol, rtol = FITS[name]
    if name == "jax geometry" and n == 4:
        n = 8
    cfg = teng.FitConfig(num_iter=5, lr=1e-3, reg_noise_std=0.05, param_noise=True,
                         exp_weight=0.99, log_every=5, compute_dtype=cd)
    (l0, g0, h0, r0), (l1, g1, h1, r1) = _pair(net, size, n, cfg)
    assert abs(l1 / l0 - 1) <= loss_tol
    g_max = max(v.abs().max().item() for v in g0.values())
    for k in g0:
        assert (g1[k] - g0[k]).abs().max().item() <= grad_tol * g_max, k
    np.testing.assert_allclose(h1, h0, rtol=rtol)
    assert torch.isfinite(r1).all() and (r1 - r0).abs().max() <= 50 * rtol


def test_trainable_input():
    """opt_input: the trainable z's gradient reaches it through the blocks
    (the cut's backward) as it does unsharded; seam off, f32, 1e-5."""
    cfg = teng.FitConfig(num_iter=2, lr=1e-3, opt_input=True, log_every=2)
    (l0, g0, _, _), (l1, g1, _, _) = _pair(dict(FLAG, up_conv=False), 32, 2, cfg)
    assert abs(l1 / l0 - 1) <= 1e-5
    assert (g1["input"] - g0["input"]).abs().max() <= 1e-5 * g0["input"].abs().max()


def test_matches_jax_engine():
    """5 steps of the JAX Engine and of the port's SpatialEngine over 4 CPU
    blocks from the same flax params (interop.flax_to_state_dict), seam off
    on both sides and jitter off (the RNG streams cannot match; hazards 1
    and 2), EMA on: loss per step at rtol 1e-3 (tests/test_torch_engine.py's
    limit for Engine)."""
    z, tgt = _data(32)
    cfg_kw = dict(num_iter=5, lr=0.01, exp_weight=0.99, log_every=5)
    net = dict(FLAG, num_channels_down=[8, 16], num_channels_up=[8, 16], num_channels_skip=[4, 4])
    je = jeng.Engine(FlaxSkip(**net), lambda p, out, aux: jmse(out, aux), jeng.FitConfig(**cfg_kw))
    with dispatch.override(up_conv="off"):
        jstate = je.init_state(jax.random.key(0), jnp.asarray(z))
        init = jax.tree_util.tree_map(np.asarray, jstate.params["net"])
        _, jhist = je.run(jstate, jnp.asarray(tgt))
    se = SP.SpatialEngine(Skip(num_input_channels=DEPTH, up_conv=False, **net), _loss,
                          teng.FitConfig(**cfg_kw), mesh=Mesh(["cpu"] * 4, axis="sp"))
    state = se.init_state(0, torch.from_numpy(z))
    se.model.load_state_dict(interop.flax_to_state_dict(init))
    _, hist = se.run(state, torch.from_numpy(tgt))
    np.testing.assert_allclose(hist["loss"], np.asarray(jhist["loss"]), rtol=1e-3)


_JAX_SPATIAL = """
import jax; jax.config.update('jax_platforms', 'cpu')
import jax.numpy as jnp, numpy as np, sys
from flax import traverse_util
from dip_tpu.fit.engine import FitConfig
from dip_tpu.models import Skip, UNet
from dip_tpu.ops import dispatch
from dip_tpu.ops.losses import mse
from dip_tpu.parallel.spatial import SpatialEngine, make_spatial_mesh
d = np.load(sys.argv[1])
with dispatch.override(up_conv='off'):
    e = SpatialEngine(Skip(num_channels_down=[8], num_channels_up=[8], num_channels_skip=[2]),
                      lambda p, o, a: mse(o, a), FitConfig(num_iter=5, lr=0.02, log_every=5),
                      mesh=make_spatial_mesh(2))
    s = e.init_state(jax.random.key(0), jnp.asarray(d['z']))
    init = traverse_util.flatten_dict(jax.tree_util.tree_map(np.asarray, s.params['net']),
                                      sep='/')
    loss = e.run(s, jnp.asarray(d['t']))[1]['loss']
# the nets of GIVEN from the given weights: each init returns them (a jitted
# flax init of a UNet compiles for over a minute on one core); convs as XLA
# conv ops, the seam off
from dip_tpu.models import DCGAN
losses = {}
for tag, (cls, kw, _) in GIVEN.items():
    net = {'UNet': UNet, 'DCGAN': DCGAN, 'Skip': Skip}[cls](**kw)
    pre = tag + '/w/'
    given = traverse_util.unflatten_dict(
        {k[len(pre):]: d[k] for k in d.files if k.startswith(pre)}, sep='/')

    class Given:
        def init(self, rngs, x, given=given):
            return {'params': given}

        def apply(self, *args, net=net, **kw):
            return net.apply(*args, **kw)

    e = SpatialEngine(net, lambda p, o, a: mse(o, a),
                      FitConfig(num_iter=2, lr=0.01, log_every=2, conv_impl='conv',
                                up_conv='off'),
                      mesh=make_spatial_mesh(2))
    e.engine.model = Given()
    s = e.init_state(jax.random.key(1), jnp.asarray(d[tag + '/z']))
    losses['l/' + tag] = e.run(s, jnp.asarray(d[tag + '/t']))[1]['loss']
np.savez(sys.argv[2], loss=loss, **losses, **{'p/' + k: v for k, v in init.items()})
"""
# the nets whose 2 steps the subprocess takes from the port's weights: tag ->
# (the class, its JAX fields, z's shape), each 32 output rows over 2 blocks:
# a tiny UNet (widths 4-64, blocks of 16 rows: its row rule), DCGAN with
# transposed convs (6 input rows: blocks of 3, and of 6 and 10 after the stem
# gives the last block its 2 extra rows) and the Skip with the lanczos2
# post-down (K7's row form: 3 halo rows a side, replicated at the image's
# edges)
GIVEN = {
    "unet": ("UNet", dict(feature_scale=16, upsample_mode="deconv", norm_kind="instance"),
             (1, 32, 32, 3)),
    "dcgan": ("DCGAN", dict(ndf=8, num_ups=4), (1, 6, 6, 2)),
    "skip lanczos2": ("Skip", dict(num_channels_down=[8, 8], num_channels_up=[8, 8],
                                   num_channels_skip=[4, 4], pad="reflection",
                                   upsample_mode="bilinear", downsample_mode="lanczos2"),
                      (1, 32, 32, 3)),
}


def _given(tag):
    """The port's net of GIVEN[tag], seam off, with the weights the
    subprocess is given."""
    cls, kw, shape = GIVEN[tag]
    port = {"UNet": UNet, "DCGAN": DCGAN, "Skip": Skip}[cls]
    net = port(num_input_channels=shape[-1], **kw, **({"up_conv": False} if cls == "Skip" else {}))
    net.reset_parameters(torch.Generator().manual_seed(6))
    return net


@pytest.fixture(scope="module")
def jax_spatial(tmp_path_factory):
    """The JAX SpatialEngine over 2 forced host devices (as
    tests/test_parallel.py runs it), in one subprocess of about 45 s on one
    core (its own time limit is 240 s): its Skip's fit (the returned
    record's 'p/' params and 'loss') and 2 steps of each net of GIVEN
    from the port's initial weights ('l/' + its tag). Returns (record,
    inputs)."""
    tmp = tmp_path_factory.mktemp("jax_spatial")
    z, tgt = _data(32)
    inputs = dict(z=z, t=tgt)
    from flax import traverse_util

    rng = np.random.default_rng(5)
    for tag, (_, _, shape) in GIVEN.items():
        net = _given(tag)
        inputs[tag + "/z"] = (rng.random(shape) * 0.1).astype(np.float32)
        with torch.no_grad():
            out_shape = tuple(net(torch.from_numpy(inputs[tag + "/z"])).shape)
        inputs[tag + "/t"] = rng.random(out_shape).astype(np.float32)
        flat = traverse_util.flatten_dict(interop.state_dict_to_flax(net.state_dict(), net),
                                          sep="/")
        inputs.update({f"{tag}/w/{k}": np.asarray(v) for k, v in flat.items()})
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    script = f"GIVEN = {GIVEN!r}\n" + _JAX_SPATIAL
    res = subprocess.run([sys.executable, "-c", script, str(tmp / "in.npz"),
                          str(tmp / "out.npz")],
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    return np.load(tmp / "out.npz"), inputs


def test_matches_jax_spatial_engine_subprocess(jax_spatial):
    """The JAX SpatialEngine over 2 forced host devices (its net, here at
    32^2, seam off) against the port's at n = 2 from the JAX fit's initial
    flax params, 5 steps at lr 0.02, jitter off: loss per step at rtol
    1e-3."""
    from flax import traverse_util

    out, inputs = jax_spatial
    init = traverse_util.unflatten_dict({k[2:]: out[k] for k in out.files if k.startswith("p/")},
                                        sep="/")
    se = SP.SpatialEngine(Skip(num_input_channels=DEPTH, up_conv=False, **JAX_NET), _loss,
                          teng.FitConfig(num_iter=5, lr=0.02, log_every=5),
                          mesh=Mesh(["cpu"] * 2, axis="sp"))
    state = se.init_state(0, torch.from_numpy(inputs["z"]))
    se.model.load_state_dict(interop.flax_to_state_dict(init))
    _, hist = se.run(state, torch.from_numpy(inputs["t"]))
    np.testing.assert_allclose(hist["loss"], out["loss"], rtol=1e-3)


def _given_steps(jax_spatial, tag):
    """The port's SpatialEngine over 2 row blocks on the net of GIVEN[tag],
    2 steps from the weights the subprocess was given, jitter off, against
    the JAX SpatialEngine's losses: the first step's and the next one's at
    rtol 1e-3."""
    out, inputs = jax_spatial
    weights = _given(tag).state_dict()
    se = SP.SpatialEngine(_given(tag), _loss, teng.FitConfig(num_iter=2, lr=0.01, log_every=2),
                          mesh=Mesh(["cpu"] * 2, axis="sp"))
    state = se.init_state(0, torch.from_numpy(inputs[tag + "/z"]))
    se.model.load_state_dict(weights)
    _, hist = se.run(state, torch.from_numpy(inputs[tag + "/t"]))
    np.testing.assert_allclose(hist["loss"], out["l/" + tag], rtol=1e-3)


def test_unet_step_matches_jax_spatial_engine(jax_spatial):
    """A tiny UNet (deconv up, instance norm) over 2 row blocks against the
    JAX SpatialEngine (_given_steps). (The biases before the instance norms
    have an exact gradient of 0, so Adam's first step moves them by +-lr on
    either side's rounding noise; they do not move the output.)"""
    _given_steps(jax_spatial, "unet")


@pytest.mark.parametrize("tag", ["dcgan", "skip lanczos2"])
def test_zoo_steps_match_jax_spatial_engine(jax_spatial, tag):
    """DCGAN's unequal blocks (the stem's 2 extra rows, the transposed
    convs' halos) and the Skip's lanczos2 post-down over row blocks (K7's
    row form, seam off) against the JAX SpatialEngine, whose partitioner
    places those halos itself (_given_steps)."""
    _given_steps(jax_spatial, tag)


# the commit before row blocks entered the model's ops (and before BatchEngine
# took conv_wgrad and L-BFGS): the unsharded path must compute what it did
BASE_COMMIT = "68e97081a70dfe2c2d893da28c31a185f08558e3"
_UNSHARDED = """
import sys
import numpy as np, torch
torch.set_num_threads(1)
from dip_tpu_torch.fit import engine as teng
from dip_tpu_torch.models import Skip
from dip_tpu_torch.ops.losses import mse
from dip_tpu_torch.parallel import BatchEngine
NET = dict(num_input_channels=4, num_channels_down=[8, 8, 8], num_channels_up=[8, 8, 8],
           num_channels_skip=[4, 4, 4], upsample_mode='bilinear')
rng = np.random.default_rng(0)
x0 = torch.from_numpy(rng.normal(size=(1, 32, 32, 4)).astype(np.float32))
cot = torch.from_numpy(rng.normal(size=(1, 32, 32, 3)).astype(np.float32))
tgt = torch.from_numpy(rng.random((1, 32, 32, 3)).astype(np.float32))
out = {}
for seam in (True, False):
    for pad in ('reflection', 'replication'):
        for extra in ({}, dict(seam_carry=True, conv_wgrad='all')):
            tag = f'skip/{seam}/{pad}/{bool(extra)}'
            m = Skip(up_conv=seam, pad=pad, **NET, **extra)
            m.reset_parameters(torch.Generator().manual_seed(0))
            x = x0.clone().requires_grad_()
            y = m(x)
            grads = torch.autograd.grad((y * cot).sum(), [x, *m.parameters()])
            out[tag + '/out'] = y.detach()
            for k, g in zip(['input', *dict(m.named_parameters())], grads):
                out[f'{tag}/grad/{k}'] = g
loss = lambda p, o, aux: mse(o, aux)
for opt, kw in (('adam', {}), ('lbfgs', dict(lbfgs_warmup=2))):
    cfg = teng.FitConfig(num_iter=4, lr=1e-3, reg_noise_std=0.05, param_noise=True,
                         exp_weight=0.99, log_every=1, optimizer=opt, **kw)
    eng = teng.Engine(Skip(pad='reflection', **NET), loss, cfg, device='cpu')
    st, hist = eng.run(eng.init_state(3, x0 * 0.1), tgt)
    out[f'engine/{opt}/loss'] = torch.tensor(np.asarray(hist['loss']))
    out.update({f'engine/{opt}/param/{k}': v.detach() for k, v in st.params.items()})
    out[f'engine/{opt}/render'] = eng.render(st)
cfg = teng.FitConfig(num_iter=2, lr=1e-3, reg_noise_std=0.05, param_noise=True,
                     exp_weight=0.99, log_every=1)
be = BatchEngine(Skip(pad='reflection', **NET), loss, cfg, device='cpu')
st, hist = be.run(be.init_state([1, 2], torch.stack([x0 * 0.1, x0 * 0.2])),
                  torch.stack([tgt, tgt]))
out['batch/loss'] = torch.tensor(np.asarray(hist['loss']))
out.update({f'batch/param/{k}': st.leaf(k) for k in st.shards[0].params})
torch.save(out, sys.argv[1])
"""


def test_unsharded_path_bitwise_as_before(tmp_path):
    """The Skip's output and every gradient (the input's included), seam on
    and off, reflection and replication pad, with and without seam_carry
    and conv_wgrad='all'; 4 steps of Engine with Adam and with L-BFGS after
    a 2-step warm-up, jitter and EMA on; 2 steps of a BatchEngine of 2
    fits: bit for bit (torch.equal) what the package of BASE_COMMIT
    computes from the same seed, each tree in its own process on one
    thread. The older package comes from `git archive`."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    git = shutil.which("git")
    if git is None or subprocess.run([git, "cat-file", "-e", BASE_COMMIT + "^{commit}"],
                                     cwd=root, capture_output=True).returncode:
        pytest.skip(f"needs git and the repository's history (commit {BASE_COMMIT[:7]})")
    base = tmp_path / "base"
    base.mkdir()
    tar = subprocess.run([git, "archive", "--format=tar", BASE_COMMIT, "dip_tpu_torch"],
                         cwd=root, capture_output=True, check=True).stdout
    subprocess.run(["tar", "-x", "-C", str(base)], input=tar, check=True)
    runs = {}
    for name, tree in (("base", str(base)), ("now", root)):
        env = dict(os.environ, PYTHONPATH=tree, OMP_NUM_THREADS="1")
        runs[name] = subprocess.Popen([sys.executable, "-c", _UNSHARDED,
                                       str(tmp_path / f"{name}.pt")],
                                      cwd=tmp_path, env=env, stderr=subprocess.PIPE, text=True)
    for name, proc in runs.items():
        _, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err[-2000:]
    was, now = (torch.load(tmp_path / f"{k}.pt") for k in ("base", "now"))
    assert was.keys() == now.keys()
    assert not [k for k in was if not torch.equal(was[k], now[k])]


def test_refusals():
    """Each with its reason: a height that does not divide by the mesh, a
    Skip's block that is not a multiple of 2^scales, a seam over a block of
    one LR row, a UNet's block that is not a multiple of 2^(4 +
    more_layers), a module that is not a net of the zoo; and
    make_spatial_mesh without a CUDA device."""
    cfg = teng.FitConfig(num_iter=1)
    mesh = Mesh(["cpu"] * 4, axis="sp")
    eng = SP.SpatialEngine(Skip(num_input_channels=DEPTH, **FLAG), _loss, cfg, mesh=mesh)
    with pytest.raises(ValueError, match="divide by mesh size"):
        eng.init_state(0, torch.zeros(1, 30, 32, DEPTH))
    with pytest.raises(ValueError, match="2\\^scales"):
        eng.init_state(0, torch.zeros(1, 48, 32, DEPTH))
    state = eng.init_state(0, torch.zeros(1, 32, 32, DEPTH))
    with pytest.raises(ValueError, match="1 LR row at a fused seam"):
        eng.step(state, torch.zeros(1, 32, 32, 3))
    unet = SP.SpatialEngine(UNet(num_input_channels=DEPTH), _loss, cfg, mesh=mesh)
    with pytest.raises(ValueError, match="2\\^\\(4 \\+ more_layers\\) = 16"):
        unet.init_state(0, torch.zeros(1, 32, 32, DEPTH))
    with pytest.raises(ValueError, match="zoo's nets"):
        SP.SpatialEngine(torch.nn.Conv2d(DEPTH, 3, 3), _loss, cfg, mesh=mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SP.make_spatial_mesh()
