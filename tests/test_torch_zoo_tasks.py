"""get_net and the 'library' inpainting variants with the zoo's nets, UNet
and ResNet, against the JAX package on the CPU: every net type get_net
makes, the spec and the preset's net at full width, and 5-step
trajectories against the JAX Engine (the spec's loss, metrics and lr; the
port's weight gradients from the kernels' autograd.Functions, their plain
versions here)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dip_tpu import models as jm  # noqa: E402
from dip_tpu.fit import engine as jeng  # noqa: E402
from dip_tpu.ops import dispatch  # noqa: E402
from dip_tpu.tasks import inpaint as jinpaint  # noqa: E402
from dip_tpu_torch import interop, models as tm  # noqa: E402
from dip_tpu_torch.fit import engine as teng  # noqa: E402
from dip_tpu_torch.models import blocks as tblocks  # noqa: E402
from dip_tpu_torch.tasks import inpaint as tinpaint  # noqa: E402
from dip_tpu_torch.utils import masks as tmasks  # noqa: E402

from test_torch_zoo import flax_params  # noqa: E402


def _jax_state(eng, net_params, z):
    """The JAX Engine's initial FitState around given net params: what
    Engine.init_state builds, less its jitted flax init (the weights come
    from flax_params; the key only draws jitter, which is off)."""
    trainable = {"net": jax.tree_util.tree_map(jnp.asarray, net_params)}
    out = jax.eval_shape(lambda p: eng.model.apply({"params": p}, jnp.asarray(z)),
                         trainable["net"])
    return jeng.unalias(jeng.FitState(
        params=trainable, opt_state=eng.tx.init(trainable), z=jnp.asarray(z),
        ema_out=jnp.zeros(out.shape, out.dtype), key=jax.random.key(0), snapshot={},
        last_track=jnp.asarray(0.0, jnp.float32), step=jnp.asarray(0, jnp.int32)))


# net type: (upsample mode, input size, output tolerance). The stated 2e-5
# where the readings allow it. Two nets are rounding-bound in f32 and have
# a bound just above their reading (PERF.md gives both readings of each
# net): the full-width skip net chains 20 BNs (port against JAX 5.5e-5; JAX
# is 4.1e-5 from the same net in f64, the port 1.9e-5), and the 6-level
# texture net 30 BNs, four of them over 2x2 pixels at 64^2 (port against
# JAX 5.7e-4; JAX is 1.25e-3 from f64, the port 7.9e-4;
# tests/test_torch_zoo.py holds a 3-level one to 2e-5)
GET_NET = {"skip": ("bilinear", 64, 1e-4), "UNet": ("nearest", 32, 2e-5),
           "ResNet": ("bilinear", 16, 2e-5), "texture_nets": ("nearest", 64, 1e-3),
           "identity": ("nearest", 16, 0.0)}


def _outputs(fmodel, model, z: np.ndarray) -> tuple[np.ndarray, ...]:
    """(port f32, JAX f32, port f64) outputs of a flax net and its port
    counterpart on the same weights (mapped strictly, both ways, bit for
    bit) and input, the seam off on both sides."""
    params = flax_params(fmodel, model, z)
    with dispatch.override(up_conv="off"):
        want = np.asarray(jax.jit(fmodel.apply)({"params": params}, jnp.asarray(z)))
    if hasattr(model, "up_conv"):
        model.up_conv = False
    with torch.no_grad():
        got = model(torch.from_numpy(z)).numpy()
        f64 = model.double()(torch.from_numpy(z).double()).numpy()
    return got, want, f64


def get_net_outputs(net_type: str) -> tuple[np.ndarray, ...]:
    """_outputs of get_net(8, net_type) at GET_NET's size."""
    mode, size, _ = GET_NET[net_type]
    z = np.random.default_rng(4).random((1, size, size, 8)).astype(np.float32)
    return _outputs(jm.get_net(8, net_type, "reflection", mode),
                    tm.get_net(8, net_type, "reflection", mode), z)


@pytest.mark.parametrize("net_type", sorted(GET_NET))
def test_get_net_matches_jax(net_type):
    """get_net returns for every net type the JAX get_net's net: the flax
    param tree maps onto it strictly, both ways, bit for bit, and the
    outputs (seam off on both sides, f32) agree within GET_NET's tolerance
    with JAX's and with the port's own net in f64."""
    mode, size, atol = GET_NET[net_type]
    if net_type == "identity":
        model = tm.get_net(8, net_type, "reflection", mode)
        z = torch.from_numpy(np.random.default_rng(4).random((1, size, size, 8)).astype(
            np.float32))
        assert isinstance(model, tm.Identity) and not list(model.parameters())
        with torch.no_grad():
            assert torch.equal(model(z), z)
        return
    got, want, f64 = get_net_outputs(net_type)
    assert got.shape == want.shape == (1, size, size, 3)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    np.testing.assert_allclose(got, f64, atol=atol, rtol=0)
    with pytest.raises(ValueError):
        tm.get_net(8, "VGG", "zero", "nearest")


def _image(size, seed=0):
    """(masked image, Bernoulli mask, image) as numpy NHWC."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    img = np.stack([np.sin(xx / 5) * 0.4 + 0.5, np.cos(yy / 7) * 0.4 + 0.5,
                    (xx + yy) / (2 * size)], -1)[None].astype(np.float32)
    mask = tmasks.get_bernoulli_mask((size, size, 3), 0.5, np.random.default_rng(seed))[None]
    return img * mask, mask, img


# the preset's net and the size its deepest scale allows (UNet: 5 pools)
LIBRARY = {"UNet": 64, "ResNet": 32}


def library_input(net_type: str) -> np.ndarray:
    size = LIBRARY[net_type]
    return np.random.default_rng(5).random((1, size, size, 1)).astype(np.float32) * 0.1


@pytest.mark.parametrize("net_type", sorted(LIBRARY))
def test_library_spec_and_net_match_jax(net_type):
    """inpaint.task(..., 'library', net_type): every field of the spec and
    its fit config as the JAX task's (lr 1e-3, no jitter), and the preset's
    net at full width (UNet 8-128 channels with more_layers 1, deconv up,
    instance norm; ResNet 8 blocks of 32): the flax params map onto it
    strictly and bit for bit, and the outputs agree within 2e-5 with JAX's
    and with the port's own net in f64."""
    size = LIBRARY[net_type]
    masked, mask, img = _image(size)
    t = tinpaint.task(masked, mask, "library", gt=img, net_type=net_type)
    j = jinpaint.task(masked, mask, "library", gt=img, net_type=net_type)
    for f in ("name", "input_depth", "input_method", "input_var", "spatial_size"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("num_iter", "lr", "reg_noise_std", "param_noise", "backtrack", "exp_weight",
              "optimizer"):
        assert getattr(t.cfg, f) == getattr(j.cfg, f), f
    assert t.cfg.lr == 1e-3 and not t.cfg.param_noise and t.cfg.reg_noise_std == 0
    widths = sorted({m.weight.shape[0] for m in t.model.modules()
                     if isinstance(m, tblocks.Conv)})
    assert widths == ([3, 8, 16, 32, 64, 128] if net_type == "UNet" else [3, 32])
    assert len(t.model.more_down if net_type == "UNet" else t.model.blocks) == (
        1 if net_type == "UNet" else 8)
    got, want, f64 = _outputs(j.model, t.model, library_input(net_type))
    assert got.shape == want.shape == (1, size, size, 3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, f64, atol=2e-5, rtol=0)


# small nets of each preset's kind for the trajectories
SMALL_LIBRARY = {
    "UNet": (dict(feature_scale=16, more_layers=1, upsample_mode="deconv", pad="zero",
                  norm_kind="instance"), 64),
    "ResNet": (dict(num_blocks=2, num_channels=8), 32),
}


@pytest.mark.parametrize("net_type", sorted(SMALL_LIBRARY))
def test_library_trajectory_matches_jax_engine(net_type):
    """5 steps of the 'library' fit (its masked MSE, metrics and lr 1e-3)
    on a small net of the preset's kind, jitter and weight noise off (the
    RNG streams cannot match), every weight gradient of the port's net from
    the kernels' autograd.Functions: the loss and metrics per step (rtol
    1e-3, as tests/test_torch_inpaint.py) and the render's masked MSE."""
    kw, size = SMALL_LIBRARY[net_type]
    masked, mask, img = _image(size, 1)
    t = tinpaint.task(masked, mask, "library", gt=img, net_type=net_type, num_iter=5)
    j = jinpaint.task(masked, mask, "library", gt=img, net_type=net_type, num_iter=5)
    over = dict(num_iter=5, reg_noise_std=0.0, param_noise=False, log_every=5)
    z = (np.random.default_rng(6).random((1, size, size, 1)) * 0.1).astype(np.float32)

    fmodel = getattr(jm, net_type)(**kw)
    model = getattr(tm, net_type)(1, conv_wgrad="all", **kw)
    init = flax_params(fmodel, model, z)
    je = jeng.Engine(fmodel, j.loss_fn, dataclasses.replace(j.cfg, **over), j.metrics_fn)
    jstate, jhist = je.run(_jax_state(je, init, z), j.aux)
    jout = np.array(je.render(jstate))

    te = teng.Engine(model, t.loss_fn, dataclasses.replace(t.cfg, **over), t.metrics_fn,
                     device="cpu")
    state = te.init_state(0, torch.from_numpy(z))
    model.load_state_dict(interop.flax_to_state_dict(init, model))
    state, thist = te.run(state, t.aux)
    tout = te.render(state).numpy()

    assert set(thist) == set(jhist)
    for k, v in jhist.items():
        np.testing.assert_allclose(thist[k], np.asarray(v), rtol=1e-3, err_msg=k)
    assert thist["loss"][-1] < thist["loss"][0]
    np.testing.assert_allclose(np.mean(((tout - img) * mask) ** 2),
                               np.mean(((jout - img) * mask) ** 2), rtol=1e-3)


if __name__ == "__main__":
    # the readings behind the output tolerances: max |port - JAX|, and each
    # side's max distance from the port's net in f64
    def _print(what, got, want, f64):
        print(f"{what}: port vs JAX {np.abs(got - want).max():.3e}, port vs f64 "
              f"{np.abs(got - f64).max():.3e}, JAX vs f64 {np.abs(want - f64).max():.3e}")

    for net_type in sorted(set(GET_NET) - {"identity"}):
        _print(f"get_net {net_type}", *get_net_outputs(net_type))
    for net_type in sorted(LIBRARY):
        masked, mask, img = _image(LIBRARY[net_type])
        spec = jinpaint.task(masked, mask, "library", gt=img, net_type=net_type)
        model = tinpaint.task(masked, mask, "library", gt=img, net_type=net_type).model
        _print(f"'library' {net_type}", *_outputs(spec.model, model, library_input(net_type)))
