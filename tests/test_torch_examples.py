"""The port's nine examples (dip_tpu_torch/examples/) against the JAX
package's examples/*.py, on the reference data's stand-ins
(chip_smoke.write_reference_standins) at 1/8 of their size.

Each JAX script is imported by path and run with the same argv as the
port's, its `run_task` (fit_batch: its `BatchEngine`) replaced in the test
by a stand-in that records what it is handed; nothing in examples/
changes. Both must hand over the same spec: every FitConfig field the two
packages share, every aux array within 1e-6 (of its largest magnitude
where that is above 1), the same net class and parameter count, and the
same input (its method, depth, variance and shape, or the same array).
Feature inversion's aux is the content's features through AlexNet, f32
sums of up to 9216 products in another order on each side, six layers
deep: they are held to 1e-5 of their largest (2.7e-6 at fc6 here). Then each port example runs for 2 steps on the CPU in an empty
directory, as chip_smoke.py's [examples] phase runs it on the card: it
returns 0, prints finite values and writes its images.
"""

import dataclasses
import importlib
import importlib.util
import os
import re
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from dip_tpu_torch.data.synthetic import synthetic_image  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 1 / 8
STEPS = 2
FI_TOL = 1e-5  # feature inversion's stored features, of their largest


def _flat(tree, prefix=""):
    """{path: numpy array} of the array leaves of nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if tree is None:
        return {}
    if hasattr(tree, "detach"):
        tree = tree.detach().cpu().numpy()
    return {prefix: np.asarray(tree)}


def jax_param_count(model, z) -> int:
    """The flax model's parameter count at input z (shapes only)."""
    variables = jax.eval_shape(model.init, jax.random.key(0), jnp.asarray(z))
    return int(sum(np.prod(leaf.shape) for leaf in
                   jax.tree_util.tree_leaves(variables.get("params", {}))))


def _jax_aux(spec) -> dict:
    """{path: array} of a JAX spec's aux, plus the arrays its metrics close
    over, by name less a '_j' suffix (the JAX denoising and SR tasks keep
    their ground truth there, the port's in aux, to move it to the fit's
    device)."""
    arrays = _flat(spec.aux)
    fn = spec.metrics_fn
    for name, cell in zip(getattr(fn, "__code__", None) and fn.__code__.co_freevars or (),
                          getattr(fn, "__closure__", None) or ()):
        if isinstance(cell.cell_contents, (np.ndarray, jax.Array)):
            arrays[f"{name.removesuffix('_j')}/"] = np.asarray(cell.cell_contents)
    return arrays


def _input(spec) -> np.ndarray:
    if spec.net_input is not None:
        return np.asarray(spec.net_input, np.float32)
    return np.zeros((1, *spec.spatial_size, spec.input_depth), np.float32)


def assert_same_spec(t, j, aux_tol=1e-6):
    """The port's TaskSpec `t` against the JAX package's `j`."""
    assert t.name == j.name
    shared = ({f.name for f in dataclasses.fields(t.cfg)}
              & {f.name for f in dataclasses.fields(j.cfg)})
    assert len(shared) >= 15
    for f in sorted(shared):
        assert getattr(t.cfg, f) == getattr(j.cfg, f), f
    for f in ("input_depth", "input_method", "input_var", "spatial_size"):
        assert getattr(t, f) == getattr(j, f), f
    assert (t.net_input is None) == (j.net_input is None)
    np.testing.assert_array_equal(_input(t), _input(j))
    got, want = _flat(t.aux), _jax_aux(j)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        err, top = np.abs(got[k] - w).max(), np.abs(w).max()
        assert err <= aux_tol * max(1.0, top), (k, err, top)
    assert (t.extra_params is None) == (j.extra_params is None)
    assert type(t.model).__name__ == type(j.model).__name__
    assert sum(p.numel() for p in t.model.parameters()) == jax_param_count(j.model, _input(j))


def _out(spec) -> np.ndarray:
    """A render of the spec's shape: 0.5 everywhere."""
    channels = next((v.shape[-1] for v in _flat(spec.aux).values()
                     if v.ndim == 4 and v.shape[-1] in (1, 3)), 3)
    h, w = _input(spec).shape[1:3]
    out = np.full((1, h, w, channels), 0.5, np.float32)
    return out if spec.postprocess is None else np.asarray(spec.postprocess(out))


def recording_run_task(specs):
    """A run_task for either package that records the spec it is handed and
    fits nothing."""
    def run_task(spec, *args, **kwargs):
        specs.append(spec)
        out = _out(spec)
        return out, types.SimpleNamespace(ema_out=out), {"loss": np.zeros(1, np.float32)}
    return run_task


class RecordingBatchEngine:
    """A BatchEngine for either package that records what it is handed and
    fits nothing."""

    seen: dict = {}

    def __init__(self, model, loss_fn, cfg, metrics_fn=None, mesh=None, **kw):
        self.seen.update(model=model, cfg=cfg)

    def init_state(self, seeds, zs, extra_params=None):
        self.seen["zs_shape"] = tuple(zs.shape)

    def run(self, state, targets, callback=None):
        self.seen["targets"] = targets
        return state, {}

    def render(self, state):
        t = self.seen["targets"]
        return torch.full_like(t, 0.5) if isinstance(t, torch.Tensor) else np.full(t.shape, 0.5)


def jax_example(name: str):
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("standins")
    chip_smoke.write_reference_standins(root, SCALE)
    return root


@pytest.fixture(scope="module")
def weights(tmp_path_factory) -> str:
    """A torch checkpoint of AlexNet at a seeded init, which both packages'
    feature inversion load (so that their stored features can agree)."""
    from dip_tpu_torch.pretrained.backbones import get_backbone

    model = get_backbone("alexnet_caffe")
    model.reset_parameters(torch.Generator().manual_seed(3))
    path = str(tmp_path_factory.mktemp("weights") / "alexnet.pth")
    torch.save(model.state_dict(), path)
    return path


def _runs(data, weights, monkeypatch):
    """chip_smoke.example_runs at STEPS iterations (fit_batch: 2 fits at
    64^2), feature inversion on `weights`: {name: (argv, images)}."""
    monkeypatch.setattr(chip_smoke, "EXAMPLE_STEPS", STEPS)
    monkeypatch.setattr(chip_smoke, "EXAMPLE_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "EXAMPLE_SIZE", 64)
    runs = {name: (argv, files) for name, argv, files in chip_smoke.example_runs(data)}
    runs["feature_inversion"] = (runs["feature_inversion"][0] + ["--weights", weights],
                                 runs["feature_inversion"][1])
    return runs


def _jax_specs(name, argv, tmp_path, monkeypatch):
    """The specs the JAX example hands run_task (fit_batch: what it hands
    BatchEngine) for `argv`."""
    jmod = jax_example(name)
    specs = []
    if name == "fit_batch":
        RecordingBatchEngine.seen = {}
        monkeypatch.setattr(jmod, "BatchEngine", RecordingBatchEngine)
        # the port seeds 'disks' and 'texture' from a CRC-32 of the name, the
        # JAX package from Python's per-process hash: hand both the same
        monkeypatch.setattr(jmod, "synthetic_image", synthetic_image)
    else:
        monkeypatch.setattr(jmod, "run_task", recording_run_task(specs))
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    (tmp_path / "jax").mkdir(exist_ok=True)
    monkeypatch.chdir(tmp_path / "jax")
    jmod.main()
    return specs if name != "fit_batch" else dict(RecordingBatchEngine.seen)


NAMES = ["denoising", "inpainting", "super_resolution", "restoration", "flash_no_flash",
         "sr_prior_effect", "feature_inversion", "activation_maximization", "fit_batch"]


@pytest.mark.parametrize("name", NAMES)
def test_example_matches_jax_and_runs(name, data, weights, tmp_path, monkeypatch, capsys):
    argv, files = _runs(data, weights, monkeypatch)[name]
    want = _jax_specs(name, argv, tmp_path, monkeypatch)

    mod = importlib.import_module(f"dip_tpu_torch.examples.{name}")
    specs, seen = [], {}
    if name == "fit_batch":
        real = mod.BatchEngine

        class Recording(real):
            def __init__(self, model, loss_fn, cfg, *a, **kw):
                seen.update(model=model, cfg=cfg)
                super().__init__(model, loss_fn, cfg, *a, **kw)

            def init_state(self, seeds, zs, extra_params=None):
                seen["zs_shape"] = tuple(zs.shape)
                return super().init_state(seeds, zs, extra_params)

            def run(self, state, auxs, callback=None):
                seen["targets"] = auxs
                return super().run(state, auxs, callback)

        monkeypatch.setattr(mod, "BatchEngine", Recording)
    else:
        real = mod.run_task

        def record(spec, *a, **kw):
            specs.append(spec)
            return real(spec, *a, **kw)

        monkeypatch.setattr(mod, "run_task", record)
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    capsys.readouterr()
    assert mod.main([*argv, "--device", "cpu"]) == 0
    text = capsys.readouterr().out

    if name == "fit_batch":
        assert type(seen["model"]).__name__ == type(want["model"]).__name__
        shared = ({f.name for f in dataclasses.fields(seen["cfg"])}
                  & {f.name for f in dataclasses.fields(want["cfg"])})
        for f in shared:
            assert getattr(seen["cfg"], f) == getattr(want["cfg"], f), f
        assert seen["zs_shape"] == want["zs_shape"] == (2, 1, 64, 64, 32)
        np.testing.assert_allclose(seen["targets"].numpy(), np.asarray(want["targets"]),
                                   atol=1e-6, rtol=0)
        z = np.zeros(want["zs_shape"][1:], np.float32)
        assert (sum(p.numel() for p in seen["model"].parameters())
                == jax_param_count(want["model"], z))
    else:
        assert len(specs) == len(want) == (2 if name == "sr_prior_effect" else 1)
        for t, j in zip(specs, want):
            assert_same_spec(t, j, FI_TOL if name == "feature_inversion" else 1e-6)
    values = [float(v) for line in text.splitlines()
              if line.startswith("iter") or "PSNR-Y" in line
              for v in re.findall(r"-?(?:\d+\.\d+|nan|inf)", line)]
    assert values and np.isfinite(values).all(), text
    for f in files:
        assert (tmp_path / "port" / f).exists(), f
