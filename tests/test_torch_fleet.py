"""The fleet SR evaluation (eval_sr_dataset_sharded), `eval-sr --fleet` and
utils/grid.py of the port, on the CPU.

The fleet groups the images by LR shape and runs each group through one
BatchEngine over a mesh (here of CPU entries), padding the last sub-batch
with its last image and dropping the padding's scores; image i of the
sorted list takes seed + i, as the sequential evaluation seeds it. On a
one-entry mesh it starts each fit where eval_sr_dataset does: with the
learning rate at 0 (z, weights and jitter as seeded, no update), the
scores agree within 0.01 dB, the batched forward's last-bit differences
(the seam rounds its operands to bf16) being all that is left. With
updates the tiny 5-scale nets at 64^2 are too ill-conditioned for a
tighter comparison than that: BN over 2x2 maps turns those last bits into
+-lr Adam steps, 0.27 dB apart after two steps. The fit itself is held to
Engine per fit in tests/test_torch_batch.py.
"""

import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
Image = pytest.importorskip("PIL.Image")

from dip_tpu_torch.cli.main import main  # noqa: E402
from dip_tpu_torch.eval import sr_eval  # noqa: E402
from dip_tpu_torch.parallel import batch as pbatch  # noqa: E402
from dip_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from dip_tpu_torch.utils import grid as tgrid  # noqa: E402

STEPS = 2


def _png(path, h, w, seed):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([np.sin(xx / 7) * 0.5 + 0.5, np.cos(yy / 5) * 0.5 + 0.5,
                    (xx + yy) / (h + w)], -1)
    img = img + np.random.default_rng(seed).random(img.shape) * 0.1
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Three images of two sizes: 'a' and 'c' crop to 64x64 (LR 16x16),
    'b' to 64x96 (LR 16x24)."""
    d = tmp_path_factory.mktemp("fleet")
    _png(d / "a.png", 70, 66, 0)
    _png(d / "b.png", 64, 100, 1)
    _png(d / "c.png", 64, 64, 2)
    return d


def test_groups_padding_seeds_and_names(image_dir, monkeypatch):
    """On a two-entry mesh: one program per LR shape, the lone 'b' padded
    to a pair (same seed twice), seeds seed + i + 1 for the weights, the
    per-image names in sorted order with finite scores, the padding's
    score dropped."""
    calls = []
    init = pbatch.BatchEngine.init_state

    def record(self, seeds, zs, extra_params=None):
        calls.append((list(seeds), tuple(zs.shape)))
        return init(self, seeds, zs, extra_params)

    monkeypatch.setattr(pbatch.BatchEngine, "init_state", record)
    res = sr_eval.eval_sr_dataset_sharded(str(image_dir), Mesh(["cpu", "cpu"]), factor=4,
                                          num_iter=STEPS, seed=10, verbose=False)
    assert calls == [([11, 13], (2, 1, 64, 64, 32)), ([12, 12], (2, 1, 64, 96, 32))]
    assert list(res.per_image) == ["a", "b", "c"]
    assert all(np.isfinite(v) and v > 0 for v in res.per_image.values())
    assert res.mean_psnr_y == pytest.approx(np.mean(list(res.per_image.values())))


def test_one_device_fleet_starts_each_fit_as_the_sequential_eval(image_dir, monkeypatch):
    task = sr_eval.super_resolve.task

    def frozen(*args, **kwargs):
        spec = task(*args, **kwargs)
        return dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, lr=0.0))

    monkeypatch.setattr(sr_eval.super_resolve, "task", frozen)
    seq = sr_eval.eval_sr_dataset(str(image_dir), factor=4, num_iter=STEPS, seed=3,
                                  verbose=False, device="cpu")
    fleet = sr_eval.eval_sr_dataset_sharded(str(image_dir), Mesh(["cpu"]), factor=4,
                                            num_iter=STEPS, seed=3, verbose=False)
    assert list(fleet.per_image) == list(seq.per_image)
    for name, score in seq.per_image.items():
        assert abs(fleet.per_image[name] - score) < 0.01, (name, fleet.per_image[name], score)


def test_cli_eval_sr_fleet_on_the_cpu(image_dir, capsys):
    """`eval-sr --fleet --device cpu`: a one-entry CPU mesh, per-image lines
    and the mean."""
    main(["eval-sr", "--dir", str(image_dir), "--factor", "4", "--num-iter", "1", "--fleet",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert all(f"{n}: " in out for n in "abc") and "mean PSNR-Y:" in out


@pytest.mark.parametrize("case", range(4))
def test_image_grid_matches_jax(case, monkeypatch):
    """get_image_grid against the JAX package's, bitwise: RGB, grayscale,
    mixed (grayscale repeated), ragged sizes, several nrow and pads; and
    plot_image_grid without matplotlib returns the grid."""
    from dip_tpu.utils import grid as jgrid

    rng = np.random.default_rng(case)
    shapes = [[(8, 8, 3)] * 5, [(6, 9, 1)] * 3, [(8, 8, 3), (8, 8, 1), (5, 7, 3)],
              [(4, 6, 1), (7, 3, 1)]][case]
    images = [rng.random(s).astype(np.float32) for s in shapes]
    for kw in (dict(), dict(nrow=2), dict(nrow=3, pad=0, pad_value=0.5)):
        want = jgrid.get_image_grid(images, **kw)
        got = tgrid.get_image_grid(images, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want), kw
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    assert np.array_equal(tgrid.plot_image_grid(images, nrow=2),
                          jgrid.get_image_grid(images, 2))
    with pytest.raises(ValueError):
        tgrid.get_image_grid([])
