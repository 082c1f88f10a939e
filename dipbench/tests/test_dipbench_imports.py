"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's own name begins with the JAX
package's), and the reference loads nothing of the port."""

from __future__ import annotations

import subprocess
import sys
import types

import json

from dipbench import harness
from dipbench.tests.conftest import BENCH, REPO, run_cell


def test_whole_top_level_names(monkeypatch):
    for name in ("jax", "jaxlib", "flax", "optax", "dip_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "dip_tpu_torch_fake", types.ModuleType("dip_tpu_torch_fake"))
    monkeypatch.setitem(sys.modules, "jaxlike.sub", types.ModuleType("jaxlike.sub"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dip_tpu.ops", types.ModuleType("dip_tpu.ops"))
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    assert harness.forbidden_modules() == ["dip_tpu", "flax"]


def _loaded_after(imports: str) -> set[str]:
    code = (f"import sys\nsys.path.insert(0, {str(REPO)!r})\n{imports}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    return set(out.split())


def test_reference_loads_nothing_of_the_port():
    top = _loaded_after("import dipbench.reference.skip, dipbench.reference.fit, "
                        "dipbench.inputs, dipbench.check, dipbench.flops, dipbench.trace")
    assert not top & {"dip_tpu_torch", *harness.FORBIDDEN}


def test_the_harness_loads_no_jax():
    """The harness, the program and every metric reader, loaded as a run
    loads them."""
    readers = "; ".join(f"harness.reader(Path({str(REPO)!r}), {p.stem!r})"
                        for p in sorted((BENCH / "metrics").glob("*.py")))
    top = _loaded_after("from pathlib import Path\nimport dipbench.program\n"
                        f"from dipbench import harness\n{readers}")
    assert "dip_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_a_reader_that_loads_jax_stops_the_result(checkout):
    """A metric reader that loads a forbidden module when it reads: the run
    exits with another code than 0, prints no result, and names it."""
    (checkout / "dipbench" / "metrics" / "loads_jax.py").write_text(
        "import sys, types\n\n\ndef read(run):\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n    return 1.0\n")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "loads_jax", "unit": "s", "better": "lower",
                                "bound": 0.25, "source": "host_clock"})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_cell(checkout, "f16_denoise.single")
    assert r["rc"] != 0 and "correct" not in r
    assert "['jax']" in r["stderr"]
