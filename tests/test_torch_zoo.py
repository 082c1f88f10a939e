"""The port's model zoo (UNet, ResNet, TextureNet, DCGAN, get_net, their
blocks and gram_matrix) against the flax modules on the same weights, on
the CPU: forward and gradients in f32, and the interop map both ways.
Every port net runs with its weight gradients from the kernels'
autograd.Functions (their plain versions here) and without. get_net and
the 'library' inpainting variants are tests/test_torch_zoo_tasks.py's.
JAX is imported where it is used and not at the top, so that the CUDA
tests at the end also run on a machine without JAX."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dip_tpu_torch import interop, models as tm  # noqa: E402
from dip_tpu_torch.models import blocks as tblocks  # noqa: E402
from dip_tpu_torch.ops import losses as tlosses  # noqa: E402

# name: (net class, its keyword arguments on both sides, input shape)
NETS = {
    "unet deconv more_layers=1 instance": (
        "UNet", dict(feature_scale=16, more_layers=1, upsample_mode="deconv",
                     norm_kind="instance"), (1, 64, 64, 2)),
    "unet bilinear concat_x batch": (
        "UNet", dict(feature_scale=16, upsample_mode="bilinear", concat_x=True,
                     norm_kind="batch"), (1, 32, 32, 3)),
    "unet nearest reflection": (
        "UNet", dict(feature_scale=16, upsample_mode="nearest", pad="reflection"),
        (1, 32, 32, 3)),
    "resnet": ("ResNet", dict(num_blocks=2, num_channels=8), (1, 16, 16, 1)),
    "texture_nets": ("TextureNet", dict(ratios=(4, 2, 1)), (1, 16, 16, 3)),
    "dcgan convT": ("DCGAN", dict(ndf=8, num_ups=5), (1, 4, 4, 2)),
    "dcgan upsample": ("DCGAN", dict(ndf=8, num_ups=5, need_convT=False), (1, 4, 4, 2)),
}


@pytest.fixture(scope="module")
def jx():
    """jax, imported here (see the module docstring)."""
    return pytest.importorskip("jax")


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_round_trip(params, model):
    """flax -> port (strict) -> flax, bit for bit."""
    import jax

    model.load_state_dict(interop.flax_to_state_dict(params, model), strict=True)
    back = dict(jax.tree_util.tree_flatten_with_path(
        interop.state_dict_to_flax(model.state_dict(), model))[0])
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(back) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back[path], leaf, err_msg=str(path))


def flax_params(fmodel, model, z, seed=0):
    """Flax params for `fmodel` on input z: the port model's torch-style
    init (the distribution flax's init draws) carried over by interop,
    held to the tree flax's init makes (paths, shapes, dtypes; traced, not
    compiled: a jitted flax init of a UNet compiles for 15 s on one core),
    and carried back to the port bit for bit."""
    import jax
    import jax.numpy as jnp

    model.reset_parameters(torch.Generator().manual_seed(seed))
    params = interop.state_dict_to_flax(model.state_dict(), model)
    want = jax.eval_shape(fmodel.init, jax.random.key(0), jnp.asarray(z))["params"]
    got = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert jax.tree_util.tree_leaves(got) == jax.tree_util.tree_leaves(want)
    _assert_round_trip(params, model)
    return params


def _grad_err(got: dict, want: dict) -> float:
    """Largest gradient error over the net, relative to its largest gradient
    (a bias before a norm has a gradient that is rounding noise, zero in
    exact arithmetic, so a per-tensor norm would divide noise by noise)."""
    g_max = max(float(np.abs(w).max()) for w in want.values())
    return max(float(np.abs(got[k] - want[k]).max()) for k in want) / g_max


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_matches_flax(jx, name):
    """Forward within 2e-5 and every gradient within 1e-4 of the largest,
    under an MSE, with conv_wgrad 'off' and 'all'; the interop round trip
    bit for bit."""
    jax, jnp = jx, jx.numpy
    from dip_tpu import models as jm

    cls, kw, shape = NETS[name]
    fmodel = getattr(jm, cls)(**kw)

    def make():
        return getattr(tm, cls)(shape[-1], **kw)

    rng = np.random.default_rng(0)
    z = rng.normal(size=shape).astype(np.float32)
    params = flax_params(fmodel, make(), z)

    def loss_fn(p, tgt):
        out = fmodel.apply({"params": p}, jnp.asarray(z))
        return jnp.mean((out - tgt) ** 2), out

    out_shape = jax.eval_shape(lambda p: fmodel.apply({"params": p}, jnp.asarray(z)), params)
    tgt = rng.random(out_shape.shape).astype(np.float32)
    (_, want_out), want_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, tgt)
    for wgrad in ("off", "all"):
        model = make()
        model.conv_wgrad = wgrad
        _assert_round_trip(params, model)
        want = {k: v.numpy() for k, v in interop.flax_to_state_dict(_np_tree(want_g),
                                                                    model).items()}
        out = model(torch.from_numpy(z))
        torch.mean((out - torch.from_numpy(tgt)) ** 2).backward()
        got = {k: p.grad.numpy() for k, p in model.named_parameters()}
        assert out.shape == want_out.shape
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=2e-5,
                                   rtol=0, err_msg=wgrad)
        assert set(got) == set(want) and _grad_err(got, want) < 1e-4, wgrad


def _convt_case(ks, stride, padding, bias):
    import jax
    import jax.numpy as jnp
    from dip_tpu.models import blocks as jblocks

    x = np.random.default_rng(1).normal(size=(2, 5, 6, 3)).astype(np.float32)
    fmod = jblocks.ConvTranspose(4, ks, stride, padding=padding, bias=bias)
    params = _np_tree(fmod.init(jax.random.key(2), jnp.asarray(x))["params"])
    want = np.asarray(fmod.apply({"params": params}, jnp.asarray(x)))
    mod = tblocks.ConvTranspose(3, 4, ks, stride, padding, bias)
    sd = interop.flax_to_state_dict({"ConvTranspose_0": params}, _Holder(mod))
    mod.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        return mod(torch.from_numpy(x)).numpy(), want


class _Holder(torch.nn.Module):
    """One block as a model, for interop's walker."""

    def __init__(self, block):
        super().__init__()
        self.block = block


@pytest.mark.parametrize("case", ["instance_norm", "convT k3 s1 p0", "convT k4 s2 p1",
                                  "convT k4 s2 p1 no bias", "gram_matrix"])
def test_block_matches_jax(jx, case):
    """InstanceNorm (per image and channel over H, W, no affine map), the
    transposed conv (ConvTranspose2d(padding=p) semantics, its kernel
    flipped by interop) and gram_matrix against the JAX package's."""
    jnp = jx.numpy
    from dip_tpu.models import blocks as jblocks
    from dip_tpu.ops import losses as jlosses

    x = np.random.default_rng(3).normal(size=(2, 7, 5, 6)).astype(np.float32) * 2 + 1
    if case == "instance_norm":
        want = np.asarray(jblocks.InstanceNorm().apply({}, jnp.asarray(x)))
        got = tblocks.InstanceNorm()(torch.from_numpy(x)).numpy()
        atol = 2e-5
    elif case == "gram_matrix":
        want = np.asarray(jlosses.gram_matrix(jnp.asarray(x)))
        got = tlosses.gram_matrix(torch.from_numpy(x)).numpy()
        bf = tlosses.gram_matrix(torch.from_numpy(x).to(torch.bfloat16))
        assert bf.dtype == torch.float32
        atol = 1e-5
    else:
        ks, stride, padding = (int(t[1:]) for t in case.split()[1:4])
        got, want = _convt_case(ks, stride, padding, "no bias" not in case)
        atol = 2e-5
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_gen_noise_and_texture_noise():
    """GenNoise: N(0,1) of the input's N, H, W with `features` channels from
    the caller's generator (mean and std of 64k draws within 0.02 of 0 and
    1, the same seed the same draws); TextureNet with fill_noise needs a
    generator and fills each branch with noise of its input's shape."""
    x = torch.zeros(2, 64, 128, 3)
    a = tblocks.GenNoise(4)(x, torch.Generator().manual_seed(0))
    b = tblocks.GenNoise(4)(x, torch.Generator().manual_seed(0))
    assert a.shape == (2, 64, 128, 4) and torch.equal(a, b)
    assert abs(a.mean().item()) < 0.02 and abs(a.std().item() - 1) < 0.02
    net = tm.TextureNet(3, ratios=(4, 2, 1), fill_noise=True)
    net.reset_parameters(torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="generator"):
        net(x)
    with torch.no_grad():
        y1 = net(x, torch.Generator().manual_seed(2))
        y2 = net(x, torch.Generator().manual_seed(3))
    assert y1.shape == (2, 64, 128, 3) and not torch.equal(y1, y2)


def test_chip_smoke_records_every_zoo_wgrad_call(monkeypatch):
    """chip_smoke.py holds K5 and K6 at every call that a [zoo] step makes:
    its recorder, run here on the CPU at 64^2, finds the UNet's and the
    ResNet's distinct calls in both dtypes (16 + 1 and 3 of them), both
    halos and the 1x1 head, puts the wrappers back, and the operands made
    from a record keep its strides."""
    import chip_smoke
    from dip_tpu_torch.ops import hopper_wgrad

    wrappers = hopper_wgrad.wgrad3x3_s1, hopper_wgrad.wgrad1x1
    monkeypatch.setattr(chip_smoke, "FIT_SIZE", 64)
    calls = chip_smoke.zoo_wgrad_calls(torch.device("cpu"))
    assert (hopper_wgrad.wgrad3x3_s1, hopper_wgrad.wgrad1x1) == wrappers
    for dtype in (torch.bfloat16, torch.float32):
        mine = [c for c in calls if c[1] == dtype]
        assert len(mine) == 20
        assert {(c[0], c[2]) for c in mine} == {("wgrad3x3_s1", 1), ("wgrad3x3_s1", 0),
                                                ("wgrad1x1", 0)}
    gen = torch.Generator().manual_seed(0)
    for name, dtype, halo, xs, x_strides, gs, g_strides in calls:
        x = chip_smoke._operand(xs, x_strides, gen, torch.device("cpu"), dtype)
        assert (tuple(x.shape), x.stride(), x.dtype) == (xs, x_strides, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["unet deconv", "unet bilinear", "resnet", "texture_nets",
                                  "dcgan convT", "dcgan upsample"])
def test_zoo_on_card_matches_cpu(name):
    """chip_smoke.py's [small] check of the zoo: the net on the card
    (conv_wgrad 'all') against the same net on the CPU, forward and every
    gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run python3 chip_smoke.py on the card)")
    from chip_smoke import phase_zoo_small_reference

    phase_zoo_small_reference(torch.device("cuda", 0), [name])
