"""The packed space-to-depth (dip_tpu_torch/ops/hopper_s2d.py) against the
JAX Pallas kernel (dip_tpu/ops/pallas_s2d.py, in interpret mode on the
CPU), and its use in the seam's backward.

The op is a permutation with a round-to-nearest-even cast, so every
comparison here is bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dip_tpu_torch.ops import hopper_s2d as S  # noqa: E402
from dip_tpu_torch.ops import hopper_up_conv as H  # noqa: E402


@pytest.fixture(scope="module")
def jx():
    """jax and the Pallas s2d module, imported here and not at the top so
    that the CUDA test below also runs on a machine without JAX."""
    jax = pytest.importorskip("jax")
    from dip_tpu.ops import pallas_s2d

    return jax, pallas_s2d


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _old_phase_major(dz: torch.Tensor) -> torch.Tensor:
    """The seam backward's dz transform before it became the s2d pack: bf16
    cast, 6-D view, permute, contiguous copy."""
    n, hh, ww, f = dz.shape
    dzq = dz.to(torch.bfloat16).reshape(n, hh // 2, 2, ww // 2, 2, f)
    return dzq.permute(0, 1, 3, 2, 4, 5).reshape(n, hh // 2, ww // 2, 4 * f).contiguous()


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 16, 16, 32), (2, 32, 24, 64)])
def test_plain_version_matches_pallas_bitwise(jx, shape, out_dtype):
    """f32 in, f32 or bf16 out, inside the Pallas kernel's envelope
    (pack_ok: 4C a multiple of 128, H >= 16)."""
    jax, P = jx
    assert P.pack_ok(*shape)
    x = _x(shape, seed=shape[1] + shape[3])
    want = P.s2d_pack(jax.numpy.asarray(x), getattr(jax.numpy, out_dtype))
    got = S.s2d_pack_plain(torch.from_numpy(x), getattr(torch, out_dtype))
    assert tuple(got.shape) == want.shape and str(got.dtype) == f"torch.{want.dtype}"
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, dtype=np.float32))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_backward_matches_jax_vjp(jx, out_dtype):
    """S2DPack's backward, the inverse permutation returned in the input's
    dtype, against jax.vjp of the Pallas op."""
    jax, P = jx
    shape = (1, 16, 16, 32)
    x, ct = _x(shape, seed=1), _x((1, 8, 8, 128), seed=2)
    jdt, tdt = getattr(jax.numpy, out_dtype), getattr(torch, out_dtype)
    out_j, vjp = jax.vjp(lambda a: P.s2d_pack(a, jdt), jax.numpy.asarray(x))
    (dx_j,) = vjp(jax.numpy.asarray(ct, dtype=jdt))
    x_t = torch.from_numpy(x).requires_grad_()
    out_t = S.s2d(x_t, tdt)
    (dx_t,) = torch.autograd.grad(out_t, x_t, torch.from_numpy(ct).to(tdt))
    np.testing.assert_array_equal(out_t.detach().float().numpy(),
                                  np.asarray(out_j, dtype=np.float32))
    assert dx_t.dtype == torch.float32 and tuple(dx_t.shape) == shape
    np.testing.assert_array_equal(dx_t.numpy(), np.asarray(dx_j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["nhwc", "planar"])
def test_seam_dz_pack_equals_old_phase_major(dtype, layout):
    """The seam's dzq is the old phase_major transform, bit for bit, for an
    NHWC or a channel-planar cotangent and a ragged channel count; the
    seam's backward takes it from s2d_pack, once per call."""
    n, hh, ww, f = 2, 12, 20, 24
    a = torch.from_numpy(_x((n, f, hh, ww), seed=3)).to(getattr(torch, dtype))
    dz = a.permute(0, 2, 3, 1) if layout == "planar" else a.permute(0, 2, 3, 1).contiguous()
    want = _old_phase_major(dz)
    for got in (S.s2d_pack(dz, torch.bfloat16), H.phase_major(dz)):
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert torch.equal(got, want)


def test_seam_backward_runs_the_pack(monkeypatch):
    calls = []
    pack = S.s2d_pack

    def counting(x, out_dtype=None):
        calls.append((tuple(x.shape), out_dtype))
        return pack(x, out_dtype)

    monkeypatch.setattr(S, "s2d_pack", counting)
    rng = np.random.default_rng(4)
    xp = torch.from_numpy(rng.normal(size=(1, 6, 6, 8)).astype(np.float32)).requires_grad_()
    e = torch.from_numpy(rng.normal(size=(3, 3, 8, 16)).astype(np.float32)).requires_grad_()
    z = H.up2_conv3x3_hopper(xp, e)
    z.backward(torch.ones_like(z))
    assert calls == [((1, 8, 8, 4), torch.bfloat16)]


def test_wrapper_takes_plain_version_on_cpu_only():
    """On a CPU tensor s2d_pack is its plain version and counts no launch;
    x's dtype when out_dtype is None; odd sizes, other dtypes and a tensor
    on neither the CPU nor a CUDA device raise."""
    x = torch.from_numpy(_x((1, 6, 10, 5), seed=5))
    S.reset_launches()
    assert torch.equal(S.s2d_pack(x), S.s2d_pack_plain(x))
    assert S.s2d_pack(x).dtype == torch.float32
    assert torch.equal(S.s2d_pack(x, torch.bfloat16), S.s2d_pack_plain(x, torch.bfloat16))
    assert S.LAUNCHES == {"s2d_pack": 0}
    with pytest.raises(ValueError):
        S.s2d_pack(x[:, :5])
    with pytest.raises(ValueError):
        S.s2d_pack(x[0])
    with pytest.raises(TypeError):
        S.s2d_pack(x.double())
    with pytest.raises(TypeError):
        S.s2d_pack(x, torch.float16)
    with pytest.raises(ValueError):
        S.s2d_pack(x.to("meta"))


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """The check chip_smoke.py runs: bitwise at the 'kate' seam cotangents,
    NHWC and channel-planar, and at ragged channel counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run python3 chip_smoke.py on the card)")
    from chip_smoke import phase_s2d_parity

    stats = phase_s2d_parity(torch.device("cuda", 0))
    assert stats["max_abs_err"] == 0.0
