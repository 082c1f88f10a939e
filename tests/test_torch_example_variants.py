"""Argument variants of the port's examples against the JAX package's
examples/*.py (presets, masks, nets, layers): the specs they hand
run_task, compared as tests/test_torch_examples.py compares them, neither
side fitting; every example's flags and defaults against the JAX
script's; and every example's default device, the card."""

import importlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

# data and weights are the fixtures the two files share
from test_torch_examples import (FI_TOL, _jax_specs, _runs, assert_same_spec,  # noqa: E402,F401
                                 data, jax_example, recording_run_task, weights)
from test_torch_recipes import captured_parser  # noqa: E402


# argv variants of the same examples: the spec alone, neither side fits
VARIANTS = [
    ("denoising", ["--image", "denoising/snail.jpg", "--preset", "snail", "--sigma", "0"]),
    ("inpainting", ["--image", "inpainting/vase.png", "--mask", "inpainting/vase_mask.png",
                    "--preset", "vase"]),
    ("inpainting", ["--image", "inpainting/library.png", "--mask",
                    "inpainting/library_mask.png", "--preset", "library", "--net", "skip_depth5"]),
    ("inpainting", ["--image", "inpainting/library.png", "--mask", "bernoulli:0.5",
                    "--preset", "library", "--net", "ResNet"]),
    ("restoration", ["--image", "inpainting/kate.png", "--preset", "kate"]),
    ("super_resolution", ["--image", "sr/zebra_GT.png", "--factor", "8", "--net", "identity"]),
    ("activation_maximization", ["--layer", "fc8", "--map-idx", "100", "--tv-weight", "0.5"]),
    ("feature_inversion", ["--image", "inpainting/kate.png", "--layers", "conv3,conv4"]),
]


@pytest.mark.parametrize("name,argv", VARIANTS)
def test_example_variant_matches_jax(name, argv, data, weights, tmp_path, monkeypatch):
    argv = [str(data / a) if "/" in a and ":" not in a else a for a in argv]
    if name == "feature_inversion":
        argv += ["--weights", weights]
    want = _jax_specs(name, argv, tmp_path, monkeypatch)
    mod = importlib.import_module(f"dip_tpu_torch.examples.{name}")
    specs = []
    monkeypatch.setattr(mod, "run_task", recording_run_task(specs))
    assert mod.main([*argv, "--device", "cpu"]) == 0
    assert len(specs) == len(want) == 1
    assert_same_spec(specs[0], want[0], FI_TOL if name == "feature_inversion" else 1e-6)


def test_examples_default_to_cuda(data, weights, tmp_path, monkeypatch):
    """Without --device every example asks for the card, and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run there")
    monkeypatch.chdir(tmp_path)
    for name, (argv, _) in _runs(data, weights, monkeypatch).items():
        mod = importlib.import_module(f"dip_tpu_torch.examples.{name}")
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(argv)


@pytest.mark.parametrize("name", ["denoising", "inpainting", "super_resolution", "restoration",
                                  "flash_no_flash", "sr_prior_effect", "feature_inversion",
                                  "activation_maximization", "fit_batch"])
def test_example_flags_and_defaults_are_the_jax_scripts(name):
    """Each example's options, their defaults and choices are the JAX
    script's, plus --device (default 'cuda')."""
    def parser_of(main):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.required)
                for a in captured_parser(main)._actions if a.dest != "help"}

    ours = parser_of(importlib.import_module(f"dip_tpu_torch.examples.{name}").main)
    assert ours.pop("device") == (("--device",), "cuda", None, False)
    assert ours == parser_of(jax_example(name).main)
