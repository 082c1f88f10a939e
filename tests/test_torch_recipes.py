"""The port's recipe tool (dip_tpu_torch/tools/reproduce.py) against the
JAX package's tools/reproduce.py, on the reference data's stand-ins
(chip_smoke.write_reference_standins) at 1/8 of their size: each of the 13
recipes builds the same spec from the same directory (the JAX tool's
`_run` and `_save` replaced in the test by stand-ins that record and
write nothing) and the same record; the flags; a `--quick` run of f16 and
zebra4 on the CPU whose records carry the JAX tool's keys; the quality
gate's floors and bf16-vs-f32 budget; and the missing data directory."""

import argparse
import importlib.util
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from dip_tpu_torch.tools import reproduce as rp  # noqa: E402
from test_torch_examples import _out, assert_same_spec  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every history key a recipe reads, so that both tools' records take the
# same fields from a fit that ran nothing
HIST = {k: np.array([10.0, 12.0], np.float32) for k in
        ("loss", "psnr_track", "psnr_gt", "psnr_gt_sm", "psnr_hr", "psnr_full")}
RUN_KEYS = {"iters", "seconds", "it_per_s", "quick"}  # the JAX tool's main adds these


def _jax_tool(name):
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("standins")
    chip_smoke.write_reference_standins(root, 1 / 8)
    return root


def _fit(specs):
    def run(spec, *args, **kwargs):
        specs.append(spec)
        out = _out(spec)
        return out, types.SimpleNamespace(ema_out=out), HIST, 1.0
    return run


class RecordingRunner(rp.Runner):
    """A Runner that records the specs it is handed, fits nothing and
    writes nothing."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.specs = []

    def run(self, spec, seed=0):
        return _fit(self.specs)(spec)

    def save(self, name, arr_nhwc):
        return os.path.join(self.outdir, name)


@pytest.mark.parametrize("name", list(rp.RECIPES))
def test_recipe_matches_jax(name, data, tmp_path, monkeypatch):
    """The same specs (as tests/test_torch_examples.py compares them) and
    the same record, paths aside."""
    jrep = _jax_tool("reproduce")
    assert list(jrep.RECIPES) == list(rp.RECIPES)
    jspecs = []
    monkeypatch.setattr(jrep, "DATA", str(data))
    monkeypatch.setattr(jrep, "_run", _fit(jspecs))
    monkeypatch.setattr(jrep, "_save", lambda name, arr: os.path.join(str(tmp_path), name))
    want = jrep.RECIPES[name]()

    r = RecordingRunner(str(data), str(tmp_path), str(tmp_path / "log.jsonl"), "cpu")
    got = rp.RECIPES[name](r)
    assert len(r.specs) == len(jspecs) == (2 if name == "prior_effect" else 1)
    for t, j in zip(r.specs, jspecs):
        assert_same_spec(t, j)
    (rec, _, dt, iters), (jrec, _, jdt, jiters) = got, want
    assert iters == jiters and dt == jdt
    assert set(rec) == set(jrec)
    for k in set(jrec) - {"out"}:
        assert rec[k] == jrec[k], k


def captured_parser(main) -> argparse.ArgumentParser:
    """The parser `main()` builds, caught at its parse_args."""
    captured = {}

    class _Parsed(Exception):
        pass

    def capture(self, args=None, namespace=None):
        captured["parser"] = self
        raise _Parsed

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        main()
    except _Parsed:
        pass
    finally:
        argparse.ArgumentParser.parse_args = real
    return captured["parser"]


def _options(main) -> set[str]:
    return {s for a in captured_parser(main)._actions for s in a.option_strings}


def device_default(main) -> str:
    return next(a.default for a in captured_parser(main)._actions if a.dest == "device")


def test_flags_are_the_jax_tools_plus_device():
    jrep = _jax_tool("reproduce")
    assert _options(rp.main) == _options(jrep.main) | {"--device"}
    assert device_default(rp.main) == "cuda"


def test_quick_run_on_the_cpu(data, tmp_path, monkeypatch):
    """`--only f16,zebra4 --quick --device cpu`: rc 0, one record a recipe
    in reproduce.jsonl, with every key the JAX tool writes for it, finite,
    20 iterations, the images written."""
    monkeypatch.setenv("DIP_REFERENCE_DATA", str(data))
    out = tmp_path / "out"
    assert rp.main(["--only", "f16,zebra4", "--quick", "--device", "cpu"], outdir=str(out)) == 0
    records = [json.loads(line) for line in (out / "reproduce.jsonl").open()]
    assert [r["recipe"] for r in records] == ["denoise/f16 sigma=25", "sr/x4 zebra"]

    jrep = _jax_tool("reproduce")
    monkeypatch.setattr(jrep, "DATA", str(data))
    monkeypatch.setattr(jrep, "_run", _fit([]))
    monkeypatch.setattr(jrep, "_save", lambda name, arr: name)
    for rec, name in zip(records, ("f16", "zebra4")):
        jkeys = set(jrep.RECIPES[name]()[0]) | RUN_KEYS
        assert jkeys <= set(rec), jkeys - set(rec)
        assert rec["iters"] == 20 and rec["quick"] is True and rec["device"] == "cpu"
        assert all(np.isfinite(v) for v in rec.values()
                   if isinstance(v, float) and not isinstance(v, bool))
        assert os.path.exists(rec["out"])


def _fake_recipes(monkeypatch, bests: dict):
    """RECIPES whose gate recipes record the given best PSNR, fitting
    nothing."""
    def fake(name):
        def recipe(r, iters=None):
            key = rp.QUICK_GATE[name][1]
            return ({"recipe": rp.GATE_LABELS[name], f"{key}_best": bests[name]}, {}, 1.0,
                    iters)
        return recipe

    monkeypatch.setattr(rp, "RECIPES", {n: fake(n) for n in rp.QUICK_GATE})


@pytest.mark.parametrize("under,rc", [(0.76, 3), (0.74, 0), (0.0, 0), (-2.0, 0)])
def test_gate_budget(under, rc, data, tmp_path, monkeypatch, capsys):
    """A bf16 gate row `under` dB below its f32 row fails the 0.75 dB budget
    (exit 3) from 0.76 on, and passes at 0.74; the f32 rows come from the
    newest f32 lines of the gate's own log."""
    monkeypatch.setenv("DIP_REFERENCE_DATA", str(data))
    _fake_recipes(monkeypatch, {n: 30.0 for n in rp.QUICK_GATE})
    assert rp.main(["--quick-gate", "--compute-dtype", "float32", "--device", "cpu"],
                   outdir=str(tmp_path)) == 0
    _fake_recipes(monkeypatch, {n: 40.0 for n in rp.QUICK_GATE})  # the newest f32 rows
    assert rp.main(["--quick-gate", "--compute-dtype", "float32", "--device", "cpu"],
                   outdir=str(tmp_path)) == 0
    _fake_recipes(monkeypatch, {"f16": 40.0 - under, "kate": 40.0, "zebra4": 41.0})
    capsys.readouterr()
    assert rp.main(["--quick-gate", "--device", "cpu"], outdir=str(tmp_path)) == rc
    text = capsys.readouterr().out
    delta = round((40.0 - under) - 40.0, 3)
    assert f"delta={delta:+.2f}dB(budget -0.75) {'FAIL' if rc else 'PASS'}" in text
    rows = [json.loads(line) for line in (tmp_path / "gate.jsonl").open()]
    assert rows[-3]["compute_dtype"] == "bfloat16" and rows[-3]["f32_ref_best"] == 40.0


def test_gate_floors(data, tmp_path, monkeypatch, capsys):
    """A row below its recipe's floor fails (exit 3) in either dtype, and
    the budget binds bf16 rows only."""
    monkeypatch.setenv("DIP_REFERENCE_DATA", str(data))
    _fake_recipes(monkeypatch, {"f16": 26.9, "kate": 27.0, "zebra4": 21.5})
    assert rp.main(["--quick-gate", "--compute-dtype", "float32", "--device", "cpu"],
                   outdir=str(tmp_path)) == 3
    assert "gate f16      psnr_gt_best=26.9 floor=27.0 delta=n/a FAIL" in capsys.readouterr().out
    assert rp.gate_verdict(26.9, 27.0, None, "float32") == (True, False)
    assert rp.gate_verdict(27.0, 27.0, -5.0, "float32") == (False, False)
    assert rp.gate_verdict(27.0, 27.0, -0.76, "bfloat16") == (False, True)
    assert rp.gate_verdict(None, 27.0, None, "bfloat16") == (True, False)


def test_without_reference_data_the_tool_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("DIP_REFERENCE_DATA", raising=False)
    with pytest.raises(FileNotFoundError, match="DIP_REFERENCE_DATA"):
        rp.main(["--quick", "--device", "cpu"], outdir=str(tmp_path))
    monkeypatch.setenv("DIP_REFERENCE_DATA", str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError):
        rp.main(["--only", "f16", "--device", "cpu"], outdir=str(tmp_path))
    assert not (tmp_path / "reproduce.jsonl").exists()
