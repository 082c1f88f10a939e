"""The port's public API against the JAX package's: every package
`__init__` exports the JAX `__all__` name for name, the layout helpers
chw_to_hwc / hwc_to_chw bit for bit, the `skip(...)` constructor against
the flax one on the same weights, and an import of every module of
dip_tpu_torch (examples and tools included) that loads neither jax nor
dip_tpu."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dip_tpu.models import skip as jax_skip  # noqa: E402
from dip_tpu.ops import dispatch  # noqa: E402
from dip_tpu.utils import image_io as jio  # noqa: E402
from dip_tpu_torch import interop  # noqa: E402
from dip_tpu_torch.models import skip  # noqa: E402
from dip_tpu_torch.utils import image_io as tio  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("sub", ["", ".fit", ".eval", ".ops", ".utils", ".models"])
def test_exports_are_the_jax_packages(sub):
    """`__all__` of dip_tpu_torch<sub> is dip_tpu<sub>'s, in its order, and
    every name resolves."""
    theirs = importlib.import_module("dip_tpu" + sub)
    ours = importlib.import_module("dip_tpu_torch" + sub)
    assert list(ours.__all__) == list(theirs.__all__)
    for name in ours.__all__:
        assert getattr(ours, name) is not None, name


@pytest.mark.parametrize("shape", [(3, 5, 7), (1, 4, 4), (2, 1, 9)])
def test_layout_helpers_are_bitwise_the_jax_ones(shape):
    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    for ours, theirs, arg in ((tio.chw_to_hwc, jio.chw_to_hwc, x),
                              (tio.hwc_to_chw, jio.hwc_to_chw, x.transpose(1, 2, 0))):
        got, want = ours(arg), theirs(arg)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
    assert np.array_equal(tio.chw_to_hwc(tio.hwc_to_chw(x)), x)


def test_skip_constructor_matches_flax():
    """skip(...) at 3 scales of 8 channels, z of 6 channels: the flax
    params carried through interop.flax_to_state_dict give the same output
    within 1e-5 of its largest, f32, the fused seam off on both sides (the
    port's seam rounds to bf16 at any width, the JAX one only at multiples
    of 128)."""
    kw = dict(num_channels_down=[8] * 3, num_channels_up=[8] * 3, num_channels_skip=[4] * 3,
              upsample_mode="bilinear", pad="reflection")
    z = (np.random.default_rng(1).normal(size=(1, 16, 16, 6)) * 0.1).astype(np.float32)
    fmodel = jax_skip(num_input_channels=6, num_output_channels=3, **kw)
    params = jax.jit(fmodel.init)(jax.random.key(0), jnp.asarray(z))["params"]
    with dispatch.override(up_conv="off"):
        want = np.asarray(fmodel.apply({"params": params}, jnp.asarray(z)))

    model = skip(num_input_channels=6, num_output_channels=3, up_conv=False, **kw)
    assert model.num_output_channels == 3
    model.load_state_dict(interop.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (1, 16, 16, 3)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_skip_defaults():
    """skip()'s defaults are the reference's: a 2-channel input, 3 out."""
    model = skip()
    with torch.no_grad():
        out = model(torch.zeros(1, 32, 32, 2))
    assert out.shape == (1, 32, 32, 3)


def test_every_module_imports_without_jax():
    """Every module of dip_tpu_torch, its examples and tools included, in a
    fresh interpreter: none of them loads jax, flax, optax or dip_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dip_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(dip_tpu_torch.__path__, 'dip_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'dip_tpu')]\n"
        "assert not bad, bad\n"
        "assert {'dip_tpu_torch.examples.fit_batch', 'dip_tpu_torch.tools.reproduce',\n"
        "        'dip_tpu_torch.tools.train_backbone'} <= set(names), names\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split()[-1]) > 50
