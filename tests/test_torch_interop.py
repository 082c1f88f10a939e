"""flax Skip params <-> the port's state_dict (dip_tpu_torch/interop.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dip_tpu.models import Skip as FlaxSkip  # noqa: E402
from dip_tpu_torch import interop  # noqa: E402
from dip_tpu_torch.models import Skip  # noqa: E402

FLAGSHIP = dict(num_channels_down=[128] * 5, num_channels_up=[128] * 5,
                num_channels_skip=[4] * 5, upsample_mode="bilinear",
                pad="reflection")
FLAGSHIP_PARAMS = 2_217_831  # results/torch_baseline.json n_params


@pytest.fixture(scope="module")
def flagship_params():
    """Flagship params as a numpy tree. Their shapes do not depend on the
    spatial size; 64^2 keeps the deepest scale at 2x2 for reflection pads."""
    z = jnp.zeros((1, 64, 64, 32), jnp.float32)
    params = jax.jit(FlaxSkip(**FLAGSHIP).init)(jax.random.key(0), z)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def test_round_trip_flagship(flagship_params):
    sd = interop.flax_to_state_dict(flagship_params)
    model = Skip(num_input_channels=32, **FLAGSHIP)
    model.load_state_dict(sd, strict=True)
    back = interop.state_dict_to_flax(model.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(flagship_params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_flagship_param_count(flagship_params):
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(flagship_params))
    model = Skip(num_input_channels=32, **FLAGSHIP)
    n_port = sum(p.numel() for p in model.parameters())
    assert n_flax == n_port == FLAGSHIP_PARAMS


def test_kernel_layout_hwio_to_oihw(flagship_params):
    sd = interop.flax_to_state_dict(flagship_params)
    k = flagship_params["Conv_2"]["Conv_0"]["kernel"]  # (3, 3, 128, 128) HWIO
    np.testing.assert_array_equal(sd["convs.2.weight"].numpy()[5, 7, 0, 2], k[0, 2, 7, 5])


def test_port_init_matches_torch_conv_default():
    """reset_parameters draws U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every
    conv kernel and bias, and the same weights from the same seed."""
    a = Skip(num_input_channels=32, **FLAGSHIP)
    b = Skip(num_input_channels=32, **FLAGSHIP)
    a.reset_parameters(torch.Generator().manual_seed(0))
    b.reset_parameters(torch.Generator().manual_seed(0))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    for conv in a.convs:
        bound = 1.0 / np.sqrt(conv.weight[0].numel())
        assert conv.weight.abs().max() <= bound and conv.bias.abs().max() <= bound
        if conv.weight.numel() > 10_000:
            assert abs(conv.weight.std().item() - bound / np.sqrt(3)) < 0.03 * bound
    for bn in a.bns:
        assert torch.equal(bn.weight, torch.ones_like(bn.weight))
        assert torch.equal(bn.bias, torch.zeros_like(bn.bias))


def test_unknown_keys_raise():
    with pytest.raises(KeyError):
        interop.flax_to_state_dict({"Dense_0": {}})
    with pytest.raises(KeyError):
        interop.state_dict_to_flax({"head.weight": torch.zeros(1)})


def test_trainable_set_round_trip(flagship_params):
    """The JAX engine's trainable set {'net', 'input', 'down': {'kernel'}}
    -> the port's flat set -> back, exactly; the flat set has the keys of
    the port's Engine state with opt_over='net,input,down'."""
    from dip_tpu_torch.fit.engine import Engine, FitConfig

    rng = np.random.default_rng(0)
    z = rng.random((1, 64, 64, 32)).astype(np.float32)
    kernel = rng.random((16, 16)).astype(np.float32)
    trainable = {"net": flagship_params, "input": z, "down": {"kernel": kernel}}
    flat = interop.flax_trainable_to_torch(trainable)
    back = interop.torch_trainable_to_flax(flat)
    flat_a = jax.tree_util.tree_flatten_with_path(trainable)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))

    eng = Engine(Skip(num_input_channels=32, **FLAGSHIP), lambda p, out, aux: out.mean(),
                 FitConfig(opt_over="net,input,down"), device="cpu")
    state = eng.init_state(0, torch.from_numpy(z), {"down": torch.from_numpy(kernel)})
    assert eng.cfg.opt_input and set(state.params) == set(flat)
    assert interop.flax_trainable_to_torch({"net": {}, "input": z}).keys() == {"input"}
    with pytest.raises(KeyError):
        interop.flax_trainable_to_torch({"net": {}, "noise": z})
