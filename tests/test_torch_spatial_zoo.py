"""SpatialEngine over the whole model zoo on the CPU
(dip_tpu_torch/parallel/spatial.py): each op that the zoo's nets run on
row blocks (ops/rows.Rows) against the same op on the image, over a mesh
that repeats 'cpu'; SpatialEngine against Engine for UNet, ResNet,
TextureNet, DCGAN and the Skip with the Lanczos post-down; each net's row
rule; and the zoo's unsharded forwards bit for bit what they were before
their ops took row blocks.

Tolerances (tests/test_torch_spatial.py's). The ops: the f32 forward
within 1e-6 and every gradient within 1e-5 of the largest (sums in
another order: each block's transposed conv and banded products, the
norms' sums per block). The fits, one step and then three at lr 1e-3 with
input and weight jitter on (the same draws) and EMA 0.99, in f32: with no
fused seam, the loss and every gradient within 1e-5 (of the loss, of the
largest gradient), the trajectory at rtol 1e-4; the Skip with its fused
seams, whose operands a sum in another order can flip to the neighbouring
bf16 value (hazard 2 of ROADMAP.md), the loss within 1e-4, the gradients
within 5e-3, the trajectory at rtol 1e-3.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_spatial import CPU, _check, _normal, _rows  # noqa: E402

from dip_tpu_torch.fit import engine as teng  # noqa: E402
from dip_tpu_torch.models import DCGAN, Identity, ResNet, Skip, TextureNet, UNet  # noqa: E402
from dip_tpu_torch.models.blocks import ConvTranspose, GenNoise, InstanceNorm  # noqa: E402
from dip_tpu_torch.ops import rows as R  # noqa: E402
from dip_tpu_torch.ops.losses import mse  # noqa: E402
from dip_tpu_torch.ops.resample import downsample  # noqa: E402
from dip_tpu_torch.parallel import spatial as SP  # noqa: E402
from dip_tpu_torch.parallel.mesh import Mesh  # noqa: E402

W = 16  # image width of the fits (a UNet's four max-pools need 16)


def _recut(heights):
    """Row blocks as the op gets them, re-cut into blocks of `heights` rows
    (gather and cut are differentiable: the gradient reaches the input)."""
    return lambda r: R.cut_rows(r.gather(CPU), [CPU] * len(heights), heights)


@pytest.mark.parametrize("n", [2, 4])
def test_instance_norm(n):
    """InstanceNorm's per-(image, channel) moments over the blocks (the
    mean, then the centred second moment) against the two-pass f32 moments
    of the image; two images, 1-row blocks at n = 4."""
    x = _normal((2, n if n == 4 else 3 * n, 5, 3), 40) * 2 + 0.5
    _check(InstanceNorm(), [x], n)


# (kernel, stride, padding): UNet's and DCGAN's 2x up stage, DCGAN's stem
@pytest.mark.parametrize("ks,stride,pad", [(4, 2, 1), (3, 1, 0)])
@pytest.mark.parametrize("blocks", [2, 4, (1, 3, 2)])
def test_conv_transpose(ks, stride, pad, blocks):
    """ConvTranspose over row blocks (each block's output rows from the
    input rows they read, zero past the image; the stem's 2 extra rows to
    the last block) against the transposed conv of the image: 2 and 4
    equal blocks (1-row blocks at 4), and unequal blocks of 1, 3 and 2
    rows, as DCGAN's stem leaves them."""
    ct = ConvTranspose(3, 4, ks, stride, pad)
    ct.reset_parameters(torch.Generator().manual_seed(41))
    if isinstance(blocks, tuple):
        x = _normal((2, sum(blocks), 5, 3), 42)
        _check(ct, [x], 2, fn_rows=lambda r: ct(_recut(blocks)(r)))
    else:
        _check(ct, [_normal((2, blocks, 5, 3), 42)], blocks)


def test_conv_transpose_blocks_own_their_rows():
    """The stem's output: block k keeps rows [start_k, start_{k+1}), the
    last block 2 more; a 2x stage doubles every block."""
    stem = ConvTranspose(2, 3, 3, 1, 0)
    up = ConvTranspose(3, 3, 4, 2, 1)
    for m in (stem, up):
        m.reset_parameters(torch.Generator().manual_seed(43))
    y = stem(_rows(_normal((1, 4, 5, 2), 44), 2))
    assert y.heights == [2, 4]
    assert up(y).heights == [4, 8]


@pytest.mark.parametrize("heights", [(3, 3), (1, 2, 4)])
def test_gen_noise(heights):
    """GenNoise over row blocks draws the whole image's noise from the
    caller's generator and cuts it into the blocks' rows: the draws of the
    unsharded op, bit for bit, in blocks of the input's heights."""
    x = torch.zeros(2, sum(heights), 5, 3)
    want = GenNoise(4)(x, torch.Generator().manual_seed(45))
    got = GenNoise(4)(R.cut_rows(x, [CPU] * len(heights), heights),
                      torch.Generator().manual_seed(45))
    assert got.heights == list(heights) and torch.equal(got.gather(CPU), want)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", ["relu", "leaky_relu", "sigmoid", "cat_channels"])
def test_per_block_maps(op, n):
    """relu, leaky_relu (DCGAN's slope 0.01), sigmoid and the channel
    concat on row blocks against the same op on the image, and the same
    functions on a tensor are the plain ops."""
    x, y = _normal((1, n, 5, 3), 46), _normal((1, n, 5, 2), 47)
    fn = {"relu": R.relu, "leaky_relu": lambda t: R.leaky_relu(t, 0.01), "sigmoid": R.sigmoid,
          "cat_channels": lambda t, u=y: R.cat_channels([t, u])}[op]
    plain = {"relu": torch.relu(x), "leaky_relu": torch.nn.functional.leaky_relu(x, 0.01),
             "sigmoid": torch.sigmoid(x), "cat_channels": torch.cat([x, y], -1)}[op]
    assert torch.equal(fn(x), plain)
    if op == "cat_channels":
        _check(lambda t, u: R.cat_channels([t, u]), [x, y], n)
    else:
        _check(fn, [x], n)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("ktype", ["lanczos2", "lanczos3"])
def test_downsample_rows(ktype, n):
    """The Lanczos post-down (x2, phase 0.5, preserve size) over row blocks
    (K7's row form here in its plain version: each block with p halo rows
    above and K - f - p below, 'replicate' at the image's top and bottom,
    row pad 0, column pad p) against the downsample of the image; blocks
    of 2 rows at n = 4, so lanczos3's 5 halo rows reach past the
    neighbouring block."""
    x = _normal((1, 2 * n if n == 4 else 6 * n, 9, 3), 48)
    _check(lambda t: downsample(t, 2, ktype, 0.5, True), [x], n)


def test_downsample_rows_refusals():
    """Over row blocks the downsample needs the even-K pre-pad (K - f) / 2
    and block heights that f divides; it raises otherwise."""
    x = _rows(_normal((1, 12, 9, 3), 49), 2)
    with pytest.raises(ValueError, match="pre-pad"):
        downsample(x, 2, "gauss12", 0, True)
    with pytest.raises(ValueError, match="divides"):
        downsample(x, 4, "lanczos2", 0.5, True)


class _NoisyTexture(TextureNet):
    """TextureNet with fill_noise, drawing from a CPU generator of its own
    (seeded at construction), since Engine calls a net with z alone."""

    def __init__(self, **kw):
        super().__init__(fill_noise=True, **kw)
        self.gen = torch.Generator().manual_seed(50)

    def forward(self, x):
        return super().forward(x, self.gen)


SKIP2 = dict(num_input_channels=3, num_channels_down=[8, 8], num_channels_up=[8, 8],
             num_channels_skip=[4, 4], pad="reflection", upsample_mode="bilinear")
# name: (net factory, H / blocks, the loss / gradient / trajectory limits)
F32 = (1e-5, 1e-5, 1e-4)
ZOO = {
    "unet batch deconv": (lambda: UNet(3, 3, feature_scale=16, upsample_mode="deconv",
                                       norm_kind="batch"), 16, F32),
    "unet instance bilinear concat_x": (
        lambda: UNet(3, 3, feature_scale=16, upsample_mode="bilinear", norm_kind="instance",
                     concat_x=True), 16, F32),
    "resnet": (lambda: ResNet(3, 3, num_blocks=2, num_channels=8), 1, F32),
    "texture_nets": (lambda: TextureNet(3, ratios=(4, 2, 1), conv_num=4), 4, F32),
    "texture_nets fill_noise": (lambda: _NoisyTexture(num_input_channels=3, ratios=(4, 2, 1),
                                                      conv_num=4), 4, F32),
    "dcgan convT": (lambda: DCGAN(3, ndf=8, num_ups=4), 1, F32),
    "dcgan upsample": (lambda: DCGAN(3, ndf=8, num_ups=4, need_convT=False), 1, F32),
    "skip lanczos3, no seam": (lambda: Skip(downsample_mode="lanczos3", up_conv=False, **SKIP2),
                               8, F32),
    "skip lanczos2, fused seams": (lambda: Skip(downsample_mode="lanczos2", **SKIP2), 8,
                                   (1e-4, 5e-3, 1e-3)),
}


def _loss(p, out, aux):
    return mse(out, aux)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(ZOO))
def test_spatial_engine_matches_engine(name, n):
    """SpatialEngine over Mesh(['cpu'] * n) against Engine from the same
    seed: one step's loss and gradients, then 3 steps and the render (a
    render of DCGAN's (H + 2) * 4 rows), at the module docstring's
    limits; H / n the net's least legal block (ResNet and DCGAN: one row),
    the Skip's 8 (its seams need 2 LR rows a block)."""
    make, rows, (loss_tol, grad_tol, rtol) = ZOO[name]
    cfg = teng.FitConfig(num_iter=3, lr=1e-3, reg_noise_std=0.05, param_noise=True,
                         exp_weight=0.99, log_every=3)
    z = torch.from_numpy(np.random.default_rng(0).random((1, rows * n, W, 3)).astype(np.float32)
                         * 0.1)
    runs = []
    for sharded in (False, True):
        eng = (SP.SpatialEngine(make(), _loss, cfg, mesh=Mesh(["cpu"] * n, axis="sp"))
               if sharded else teng.Engine(make(), _loss, cfg, device="cpu"))
        state = eng.init_state(0, z)
        with torch.no_grad():
            shape = tuple(eng.render(state).shape)
        tgt = torch.from_numpy(np.random.default_rng(1).random(shape).astype(np.float32))
        _, m = eng.step(state, tgt)
        grads = {k: p.grad.clone() for k, p in state.params.items()}
        _, hist = eng.run(state, tgt)
        runs.append((m["loss"].item(), grads, hist["loss"], eng.render(state)))
    (l0, g0, h0, r0), (l1, g1, h1, r1) = runs
    assert abs(l1 / l0 - 1) <= loss_tol
    g_max = max(v.abs().max().item() for v in g0.values())
    for k in g0:
        assert (g1[k] - g0[k]).abs().max().item() <= grad_tol * g_max, k
    np.testing.assert_allclose(h1, h0, rtol=rtol)
    assert r1.shape == r0.shape and (r1 - r0).abs().max() <= 50 * rtol


# (net, a height that breaks its rule over 2 blocks, the reason's words)
RULES = {
    "unet": (lambda: UNet(3, 3, feature_scale=16, more_layers=1), 32,
             "2\\^\\(4 \\+ more_layers\\) = 32"),
    "texture_nets": (lambda: TextureNet(3, ratios=(8, 4, 2, 1), conv_num=4), 8,
                     "max\\(ratios\\) = 8"),
    "skip": (lambda: Skip(**SKIP2), 4, "2\\^scales = 4"),
    "resnet": (lambda: ResNet(3, 3, num_blocks=1, num_channels=4), 3, "divide by mesh size"),
    "dcgan": (lambda: DCGAN(3, ndf=4, num_ups=4), 1, "divide by mesh size"),
    "identity": (Identity, 5, "divide by mesh size"),
}


@pytest.mark.parametrize("name", list(RULES))
def test_row_rules(name):
    """check_spatial takes every net of the zoo; check_input refuses, with
    the reason, a height outside the net's row rule over 2 blocks, and
    takes the least legal one (twice the rule's multiple)."""
    make, bad, why = RULES[name]
    eng = SP.SpatialEngine(make(), _loss, teng.FitConfig(num_iter=1),
                           mesh=Mesh(["cpu"] * 2, axis="sp"))
    with pytest.raises(ValueError, match=why):
        eng.check_input(torch.zeros(1, bad, W, 3))
    eng.check_input(torch.zeros(1, 2 * SP.row_multiple(eng.model)[0], W, 3))


# the commit before the zoo's ops took row blocks: the unsharded forwards
# must compute what they did
BASE_COMMIT = "15d229d7a703d128c4e1692dc736c797299762df"
_UNSHARDED = """
import sys
import numpy as np, torch
torch.set_num_threads(1)
from dip_tpu_torch.models import DCGAN, ResNet, Skip, TextureNet, UNet
SKIP2 = dict(num_input_channels=3, num_channels_down=[8, 8], num_channels_up=[8, 8],
             num_channels_skip=[4, 4], pad='reflection', upsample_mode='bilinear')
NETS = {
    'unet': (lambda: UNet(3, 3, feature_scale=16, more_layers=1, upsample_mode='deconv'), 64),
    'unet bilinear concat_x': (lambda: UNet(3, 3, feature_scale=16, upsample_mode='bilinear',
                                            norm_kind='batch', concat_x=True), 32),
    'resnet': (lambda: ResNet(3, 3, num_blocks=2, num_channels=8), 16),
    'texture_nets': (lambda: TextureNet(3, ratios=(4, 2, 1), conv_num=4, need_sigmoid=True), 16),
    'texture_nets fill_noise': (lambda: TextureNet(3, ratios=(4, 2, 1), conv_num=4,
                                                   fill_noise=True), 16),
    'dcgan': (lambda: DCGAN(3, ndf=8, num_ups=4), 6),
    'dcgan upsample': (lambda: DCGAN(3, ndf=8, num_ups=4, need_convT=False), 6),
    'skip lanczos2': (lambda: Skip(downsample_mode='lanczos2', **SKIP2), 16),
    'skip lanczos3': (lambda: Skip(downsample_mode='lanczos3', up_conv=False, **SKIP2), 16),
}
out = {}
for name, (make, size) in NETS.items():
    for wgrad in ('off', 'all'):
        rng = np.random.default_rng(0)
        m = make()
        m.reset_parameters(torch.Generator().manual_seed(1))
        m.conv_wgrad = wgrad
        x = torch.from_numpy(rng.normal(size=(1, size, size, 3)).astype(np.float32))
        x.requires_grad_()
        args = (torch.Generator().manual_seed(2),) if 'fill_noise' in name else ()
        y = m(x, *args)
        cot = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(np.float32))
        # fill_noise replaces the input: it has no gradient there
        grads = torch.autograd.grad((y * cot).sum(), [x, *m.parameters()], allow_unused=True)
        tag = f'{name}/{wgrad}'
        out[tag + '/out'] = y.detach()
        for k, g in zip(['input', *dict(m.named_parameters())], grads):
            out[f'{tag}/grad/{k}'] = torch.zeros(0) if g is None else g
torch.save(out, sys.argv[1])
"""


def test_unsharded_zoo_bitwise_as_before(tmp_path):
    """UNet (deconv and instance norm with more_layers, bilinear and batch
    norm with concat_x), ResNet, TextureNet (with and without fill_noise),
    DCGAN (transposed convs, upsample + conv) and the Skip with the
    lanczos2 (fused seams) and lanczos3 post-downs, conv_wgrad 'off' and
    'all': the output and every gradient (the input's included) bit for
    bit (torch.equal) what the package of BASE_COMMIT computes from the
    same seed, each tree in its own process on one thread. The older
    package comes from `git archive`."""
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
