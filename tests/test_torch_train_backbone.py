"""The port's backbone trainer (dip_tpu_torch/tools/train_backbone.py)
against the JAX package's tools/train_backbone.py: the procedural batches
bit for bit; one training step of AlexNet (at a 67^2 input, batch 2) from
the JAX init, exported by the JAX tool's export_torch and loaded by the
port's convert.py: the loss within 1e-5 relative, every gradient within
1e-4 of the largest, and the loss after each side's own Adam step
(optax.adam and torch.optim.Adam at the tool's lr) within 1e-4 relative;
a .pth the port exports read by the JAX convert.py: the same fc6 within
1e-4 of its largest; the flags; and the tool end to end on the CPU."""

import argparse
import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from dip_tpu.pretrained import convert as jconvert  # noqa: E402
from dip_tpu.pretrained.backbones import AlexNet as FlaxAlexNet  # noqa: E402
from dip_tpu.pretrained.backbones import vgg_preprocess_caffe as jpre  # noqa: E402
from dip_tpu_torch.pretrained.convert import apply_converted, load_torch_weights  # noqa: E402
from dip_tpu_torch.pretrained.backbones import vgg_preprocess_caffe  # noqa: E402
from dip_tpu_torch.tools import train_backbone as tb  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMSIZE = 67  # AlexNet's smallest input with a 1x1 pool5: fc6 takes 256 features


def _jax_tool():
    path = os.path.join(REPO, "tools", "train_backbone.py")
    spec = importlib.util.spec_from_file_location("jax_tools_train_backbone", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,n,imsize", [(0, 3, 227), (5, 2, IMSIZE), (1, 16, 227)])
def test_make_batch_is_the_jax_tools(seed, n, imsize):
    jtb = _jax_tool()
    assert tb.N_CLASSES == jtb.N_CLASSES and tb.IMSIZE == jtb.IMSIZE
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):  # and the stream after the first batch
        (x, y), (jx, jy) = tb.make_batch(rng, n, imsize), jtb.make_batch(jrng, n, imsize)
        assert x.dtype == jx.dtype and y.dtype == jy.dtype
        assert np.array_equal(x, jx) and np.array_equal(y, jy)


def _to_torch_layout(tree) -> dict:
    """flax params or grads -> {'conv1.weight': OIHW, ...} as the JAX tool
    exports them."""
    out = {}
    for name, leaves in tree.items():
        k = np.asarray(leaves["kernel"])
        out[f"{name}.weight"] = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
        out[f"{name}.bias"] = np.asarray(leaves["bias"])
    return out


def test_one_training_step_matches_jax(tmp_path):
    jtb = _jax_tool()
    rng = np.random.default_rng(0)
    x0, _ = tb.make_batch(rng, 2, IMSIZE)
    fmodel = FlaxAlexNet()
    params = jax.jit(lambda k, x: fmodel.init(k, x, taps=("fc8",)))(
        jax.random.key(0), jpre(jnp.asarray(x0)))["params"]
    path = str(tmp_path / "init.pth")
    jtb.export_torch(params, path)
    model = tb.trainable_alexnet(1, IMSIZE, device="cpu")
    apply_converted(model, load_torch_weights(path))
    assert all(p.requires_grad for p in model.parameters())

    def jloss(p, x, y):
        logits = fmodel.apply({"params": p}, jpre(x), taps=("fc8",))["fc8"][:, :tb.N_CLASSES]
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    tx = optax.adam(3e-4)
    opt_state = tx.init(params)
    opt = torch.optim.Adam(model.parameters(), lr=3e-4)
    batches = [tb.make_batch(rng, 2, IMSIZE) for _ in range(2)]
    jx, jy = (jnp.asarray(a) for a in batches[0])
    want, grads = jax.jit(jax.value_and_grad(jloss))(params, jx, jy)
    x, y = torch.from_numpy(batches[0][0]), torch.from_numpy(batches[0][1]).long()
    loss, _ = tb.loss_and_accuracy(model, x, y)
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    jg = _to_torch_layout(jax.tree_util.tree_map(np.asarray, grads))
    g = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(g) == sorted(jg)
    top = max(np.abs(v).max() for v in jg.values())
    assert max(np.abs(g[k] - jg[k]).max() for k in jg) <= 1e-4 * top

    updates, opt_state = tx.update(grads, opt_state)
    params = optax.apply_updates(params, updates)
    opt.step()
    want2 = float(jax.jit(jloss)(params, *(jnp.asarray(a) for a in batches[1])))
    with torch.no_grad():
        got2 = tb.loss_and_accuracy(model, torch.from_numpy(batches[1][0]),
                                    torch.from_numpy(batches[1][1]).long())[0].item()
    assert abs(got2 - want2) <= 1e-4 * abs(want2)


def test_port_checkpoint_reads_in_jax(tmp_path):
    x, _ = tb.make_batch(np.random.default_rng(7), 2, IMSIZE)
    model = tb.trainable_alexnet(2, IMSIZE, device="cpu")
    path = str(tmp_path / "port.pth")
    tb.export_torch(model, path)
    state = torch.load(path, weights_only=True)
    assert sorted(state) == sorted(f"{n}.{leaf}" for n in
                                   ("conv1", "conv2", "conv3", "conv4", "conv5", "fc6", "fc7",
                                    "fc8") for leaf in ("weight", "bias"))
    converted = load_torch_weights(path)
    for k, v in model.state_dict().items():
        name, leaf = k.split(".")
        assert torch.equal(converted[name][leaf], v)

    fmodel = FlaxAlexNet()
    variables = jax.jit(lambda k, x: fmodel.init(k, x, taps=("fc6",)))(
        jax.random.key(0), jpre(jnp.asarray(x)))
    variables = jconvert.apply_converted(variables, jconvert.load_torch_weights(path))
    want = np.asarray(fmodel.apply(variables, jpre(jnp.asarray(x)), taps=("fc6",))["fc6"])
    with torch.no_grad():
        got = model(vgg_preprocess_caffe(torch.from_numpy(x)), taps=("fc6",))["fc6"].numpy()
    assert got.shape == want.shape == (2, 4096)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(got).max()


def test_flags_are_the_jax_tools_plus_device():
    from test_torch_recipes import _options, device_default

    assert _options(tb.main) == _options(_jax_tool().main) | {"--device"}
    assert device_default(tb.main) == "cuda"


def test_the_tool_on_the_cpu(tmp_path, capsys):
    """Two training steps, one FI and one AM iteration: rc 0, the two
    records with the JAX tool's keys, the checkpoint and the images."""
    assert tb.main(["--steps", "2", "--batch", "2", "--fi-iters", "1", "--am-iters", "1",
                    "--device", "cpu"], outdir=str(tmp_path)) == 0
    assert "host share" in capsys.readouterr().out
    fi, am = [json.loads(line) for line in (tmp_path / "reproduce.jsonl").open()]
    assert set(fi) == {"recipe", "image", "size", "backbone_test_acc", "train_steps",
                       "fi_iters", "fi_loss_first", "fi_loss_final", "out", "ckpt", "quick"}
    assert set(am) == {"recipe", "image", "size", "backbone_test_acc", "iters",
                       "am_loss_first", "am_loss_final", "out", "quick", "am_argmax",
                       "am_target", "am_margin", "am_logit_gain"}
    for f in (fi["out"], fi["ckpt"], am["out"], str(tmp_path / "fi_trained_content.png")):
        assert os.path.exists(f), f
    assert am["am_target"] == 3 and 0 <= am["am_argmax"] < 10
