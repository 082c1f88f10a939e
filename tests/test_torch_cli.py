"""The port's CLI (`python -m dip_tpu_torch fit|bench|eval-sr`), its data
module (synthetic images, the ImageNet class map) and its profiling
helpers, on the CPU: the flag set against dip_tpu's, the image-free
activation maximization (also with Pillow and PyYAML blocked, as on the
card), feature inversion from a PNG, a YAML config, several images through
FitQueue, and the refused JAX-only switches."""

import argparse
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dip_tpu_torch.cli.main import build_parser, main  # noqa: E402
from dip_tpu_torch.data import SYNTHETIC_SET, reference_data_dir, synthetic_image  # noqa: E402
from dip_tpu_torch.data.imagenet_classes import load_class_map, resolve_class  # noqa: E402
from dip_tpu_torch.utils import profiling  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a small classifier input (AlexNet at 67^2 under a generator at 128^2)
SMALL_AM = ["--imsize", "67", "--window-size", "3", "--device", "cpu"]


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _options(parser: argparse.ArgumentParser) -> dict:
    """subcommand -> its option strings."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {s for a in p._actions for s in a.option_strings}
            for name, p in sub.choices.items()}


def test_flags_are_dip_tpus_plus_device(monkeypatch):
    """Every subcommand takes dip_tpu's flags, each with the same
    choices where it has any (--resample-impl's included, to refuse it),
    plus --device; the same seven tasks."""
    import importlib

    jmain = importlib.import_module("dip_tpu.cli.main")

    def capture(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as got:
        jmain.main(["fit"])
    monkeypatch.undo()
    want = _options(got.value.parser)
    parser, fit = build_parser()
    have = _options(parser)
    assert set(have) == set(want) == {"fit", "bench", "eval-sr"}
    for name in want:
        assert have[name] == want[name] | {"--device"}, name
    sub = next(a for a in got.value.parser._actions
               if isinstance(a, argparse._SubParsersAction))
    choices = {a.dest: a.choices for a in sub.choices["fit"]._actions if a.choices}
    assert {a.dest: a.choices for a in fit._actions if a.choices} == choices
    assert len(choices["task"]) == 7


def test_activation_max_fit_on_the_cpu(tmp_path, capsys):
    """The image-free activation maximization: loss lines, a saved render
    of the classifier's size."""
    out = tmp_path / "am.png"
    assert main(["fit", "--task", "activation_max", "--num-iter", "2", "--log-every", "1",
                 "--out", str(out), *SMALL_AM]) == 0
    stdout = capsys.readouterr().out
    losses = [float(v) for v in re.findall(r"iter\s+\d+\s+loss (\S+)", stdout)]
    assert len(losses) == 2 and np.isfinite(losses).all()
    from PIL import Image

    assert Image.open(out).size == (67, 67)


def test_activation_max_fc_class_by_name(tmp_path, capsys):
    """An fc layer's unit from a class name through a class map the user
    names (--class-map)."""
    cmap = tmp_path / "classes.txt"
    cmap.write_text("{0: 'tench, Tinca tinca', 340: 'zebra', 341: 'hog, pig'}")
    main(["fit", "--task", "activation_max", "--layer", "fc8", "--map-idx", "zebra",
          "--class-map", str(cmap), "--num-iter", "1", *SMALL_AM])
    assert "maximizing fc8[340] = 'zebra'" in capsys.readouterr().out


def test_cli_runs_without_pillow_or_yaml():
    """`python -m dip_tpu_torch fit --task activation_max` with Pillow and
    PyYAML blocked (the card has neither) and JAX absent from the process."""
    code = ("import sys; sys.modules['PIL'] = None; sys.modules['yaml'] = None\n"
            "from dip_tpu_torch.cli.main import main\n"
            f"main(['fit', '--task', 'activation_max', '--num-iter', '1', *{SMALL_AM!r}])\n"
            "assert 'jax' not in sys.modules and 'flax' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "loss" in res.stdout and "done: 1 iters" in res.stdout


def _png(path, size, seed=0):
    from PIL import Image

    img = np.random.default_rng(seed).uniform(size=(size, size, 3)) * 255
    Image.fromarray(img.astype(np.uint8)).save(path)
    return str(path)


def test_feature_inversion_fit_from_a_png(tmp_path, capsys):
    """Feature inversion of a PNG (resized to the classifier's input),
    with a checkpoint given by --weights; a missing checkpoint raises."""
    from dip_tpu_torch.pretrained.backbones import get_backbone

    model = get_backbone("alexnet_caffe", 67)
    model.reset_parameters(torch.Generator().manual_seed(2))
    weights = tmp_path / "alexnet.pth"
    torch.save(model.state_dict(), weights)
    image = _png(tmp_path / "content.png", 80)
    out = tmp_path / "fi.png"
    args = ["fit", "--task", "feature_inversion", "--image", image, "--layer", "conv3",
            "--num-iter", "2", "--imsize", "67", "--device", "cpu", "--out", str(out)]
    main(args + ["--weights", str(weights)])
    assert len(re.findall(r"iter\s+\d+\s+loss", capsys.readouterr().out)) == 1
    from PIL import Image

    assert Image.open(out).size == (67, 67)
    with pytest.raises(FileNotFoundError):
        main(args + ["--weights", str(tmp_path / "none.pth")])


def test_config_yaml_fills_flags(tmp_path, capsys):
    """A YAML config provides the flags (dashes or underscores); flags on
    the command line win; an unknown key raises."""
    cfg = tmp_path / "run.yaml"
    cfg.write_text("task: activation_max\nnum-iter: 3\nlog_every: 1\nimsize: 67\n"
                   "window_size: 3\ndevice: cpu\n")
    main(["fit", "--config", str(cfg), "--num-iter", "1"])
    assert len(re.findall(r"iter\s+\d+\s+loss", capsys.readouterr().out)) == 1
    cfg.write_text("task: activation_max\nbogus: 1\n")
    with pytest.raises(ValueError):
        main(["fit", "--config", str(cfg)])


def test_several_images_go_through_fitqueue(tmp_path, capsys):
    """`fit --image a.png,b.png` runs two fits through FitQueue and saves
    one suffixed render per input."""
    paths = [_png(tmp_path / f"im{i}.png", 64, seed=i) for i in range(2)]
    out = tmp_path / "out.png"
    main(["fit", "--task", "denoise", "--image", ",".join(paths), "--num-iter", "2",
          "--log-every", "1", "--device", "cpu", "--out", str(out)])
    assert (tmp_path / "out_im0.png").exists() and (tmp_path / "out_im1.png").exists()
    stdout = capsys.readouterr().out
    assert "[im0]" in stdout and "[im1]" in stdout and "aggregate it/s" in stdout


@pytest.mark.parametrize("argv,what", [
    (["fit", "--task", "sr", "--image", "x.png", "--resample-impl", "xla"], "--resample-impl"),
    (["eval-sr", "--dir", "x", "--fleet"], "--fleet"),
    (["fit", "--image", "x.png"], "--task"),
    (["fit", "--task", "denoise"], "--image"),
])
def test_refused_arguments(capsys, argv, what):
    """The JAX package's layout and mesh switches are refused with a
    message, not ignored; a fit needs a task, and an image unless it is
    activation maximization."""
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    assert what in capsys.readouterr().err


def test_no_fallback_to_the_cpu():
    """Without a CUDA device the default --device fails, and the bench
    refuses any device but a CUDA one."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            main(["fit", "--task", "activation_max", "--num-iter", "1", "--imsize", "67"])
    with pytest.raises(ValueError):
        main(["bench", "--device", "cpu", "--size", "32", "--iters", "1"])


def test_module_entry_point():
    """`python -m dip_tpu_torch` is the CLI."""
    res = subprocess.run([sys.executable, "-m", "dip_tpu_torch", "eval-sr", "--dir", "x",
                          "--fleet"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2 and "--fleet" in res.stderr


def test_synthetic_images_match_jax_and_repeat_across_processes():
    """The deterministic images equal the JAX package's; 'disks' and
    'texture' (seeded from the name) are the same in two processes."""
    from dip_tpu.data.synthetic import synthetic_image as jsynthetic

    for name in ("bands", "checker", "gradient"):
        for channels in (1, 3):
            np.testing.assert_array_equal(synthetic_image(name, 48, channels),
                                          jsynthetic(name, 48, channels))
    code = ("import hashlib; from dip_tpu_torch.data import synthetic_image as s; "
            "print(hashlib.md5(s('disks', 32).tobytes() + s('texture', 32).tobytes())"
            ".hexdigest())")
    runs = {subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                           text=True, timeout=120, check=True).stdout for _ in range(2)}
    assert len(runs) == 1
    for name in SYNTHETIC_SET:
        img = synthetic_image(name, 32)
        assert img.shape == (32, 32, 3) and img.dtype == np.float32
        assert 0 <= img.min() and img.max() <= 1
    with pytest.raises(ValueError):
        synthetic_image("lena")


def test_class_map_matches_jax(tmp_path, monkeypatch):
    """load_class_map and resolve_class against the JAX package's on one
    map: by index, name, alias; ambiguous and unknown names raise; an
    index needs no map. Only the paths the user gives are read."""
    from dip_tpu.data import imagenet_classes as jclasses

    cmap = tmp_path / "imagenet1000_clsid_to_human.txt"
    cmap.write_text("{0: 'tench, Tinca tinca', 1: 'goldfish, Carassius auratus',\n"
                    " 340: 'zebra', 341: 'hog, pig, grunter', 342: 'wild boar, boar'}")
    assert load_class_map(str(cmap)) == jclasses.load_class_map(str(cmap))
    for q in (340, "340", "zebra", "goldfish", "Tinca tinca", "hog"):
        assert resolve_class(q, str(cmap)) == jclasses.resolve_class(q, str(cmap))
    for q in ("a", "mammoth"):
        with pytest.raises(KeyError):
            resolve_class(q, str(cmap))
    monkeypatch.delenv("DIP_IMAGENET_CLASSMAP", raising=False)
    monkeypatch.delenv("DIP_REFERENCE_DATA", raising=False)
    assert resolve_class(7) == (7, "class 7")
    assert reference_data_dir(required=False) is None
    with pytest.raises(FileNotFoundError):
        reference_data_dir()
    with pytest.raises(FileNotFoundError):
        load_class_map()
    monkeypatch.setenv("DIP_REFERENCE_DATA", str(tmp_path))
    assert reference_data_dir() == str(tmp_path)
    assert resolve_class("zebra") == (340, "zebra")
    monkeypatch.delenv("DIP_REFERENCE_DATA")
    monkeypatch.setenv("DIP_IMAGENET_CLASSMAP", str(cmap))
    assert load_class_map()[342] == "wild boar, boar"


def test_profiling_helpers(tmp_path):
    """trace() writes a Chrome trace of the block; timed_chunk gives the
    median of its repeats; enable_nan_debug turns on anomaly mode."""
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    calls = []
    t = profiling.timed_chunk(lambda n: calls.append(n), 5, warmup=2, repeats=3)
    assert calls == [5] * 5 and t >= 0
    try:
        profiling.enable_nan_debug()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
