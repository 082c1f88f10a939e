"""Checkpoint and resume of the port's fits, on the CPU: a resumed fit is
bit for bit an uninterrupted one."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dip_tpu_torch.fit import engine as teng  # noqa: E402
from dip_tpu_torch.fit.checkpoint import restore_fit_state, save_fit_state  # noqa: E402
from dip_tpu_torch.models import Skip  # noqa: E402
from dip_tpu_torch.ops.losses import mse  # noqa: E402

SMALL = dict(num_channels_down=[8, 16], num_channels_up=[8, 16],
             num_channels_skip=[4, 4], upsample_mode="bilinear", pad="reflection")


def _data():
    rng = np.random.default_rng(0)
    z = torch.from_numpy((rng.random((1, 32, 32, 4)) * 0.1).astype(np.float32))
    tgt = torch.from_numpy(rng.random((1, 32, 32, 3)).astype(np.float32))
    return z, tgt


def _engine(num_iter: int, optimizer: str, channels=SMALL["num_channels_down"]):
    """A fit with every piece of state on: input jitter on a schedule,
    weight jitter, the EMA, backtracking (threshold -0.5, so it restores)
    and a trainable z."""
    cfg = teng.FitConfig(num_iter=num_iter, log_every=3, lr=0.01, optimizer=optimizer,
                         reg_noise_std=0.02, reg_noise_schedule=((4, 0.1),),
                         param_noise=True, exp_weight=0.9, backtrack=True,
                         backtrack_threshold=-0.5, opt_input=True)
    model = Skip(num_input_channels=4, **dict(SMALL, num_channels_down=channels,
                                              num_channels_up=channels))
    z, tgt = _data()
    eng = teng.Engine(model, lambda p, out, aux: mse(out, aux), cfg,
                      teng.default_metrics(tgt), device="cpu")
    return eng, eng.init_state(5, z), tgt


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_resumed_fit_is_bitwise_uninterrupted(tmp_path, optimizer):
    """10 steps against 5, a save, a restore into a fresh engine's state
    and 5 more: the same losses and metrics, params, optimizer state,
    snapshot, EMA, tracked PSNR, step counts and generator states, bit for
    bit."""
    eng, whole, tgt = _engine(10, optimizer)
    whole, h_whole = eng.run(whole, tgt)

    eng1, first, _ = _engine(5, optimizer)
    first, h1 = eng1.run(first, tgt)
    path = str(tmp_path / "fit.pt")
    save_fit_state(path, first)
    eng2, resumed, _ = _engine(5, optimizer)
    resumed = restore_fit_state(path, resumed)
    resumed, h2 = eng2.run(resumed, tgt)

    assert h_whole["backtracked"].sum() >= 1
    for k in h_whole:
        np.testing.assert_array_equal(np.concatenate([h1[k], h2[k]]), h_whole[k], err_msg=k)
    for k in whole.params:
        assert torch.equal(resumed.params[k], whole.params[k]), k
        assert torch.equal(resumed.snapshot[k], whole.snapshot[k]), k
    for a, b in ((resumed.ema_out, whole.ema_out), (resumed.last_track, whole.last_track),
                 (resumed.device_step, whole.device_step)):
        assert torch.equal(a, b)
    assert resumed.step == whole.step == 10
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())
    assert torch.equal(resumed.param_generator.get_state(),
                       whole.param_generator.get_state())
    sa, sb = resumed.opt.state_dict()["state"], whole.opt.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k])), (i, k)


def test_second_save_overwrites(tmp_path):
    """Saves to one path replace each other (the last one wins) and leave
    no other file behind."""
    eng, state, tgt = _engine(2, "adam")
    path = str(tmp_path / "fit.pt")
    state, _ = eng.run(state, tgt)
    save_fit_state(path, state)
    state, _ = eng.run(state, tgt)
    save_fit_state(path, state)
    assert os.listdir(tmp_path) == ["fit.pt"]
    eng2, fresh, _ = _engine(2, "adam")
    fresh = restore_fit_state(path, fresh)
    assert fresh.step == 4 and fresh.device_step.item() == 4
    for k in state.params:
        assert torch.equal(fresh.params[k], state.params[k]), k


def test_template_of_another_shape_raises(tmp_path):
    eng, state, tgt = _engine(2, "adam")
    state, _ = eng.run(state, tgt)
    path = str(tmp_path / "fit.pt")
    save_fit_state(path, state)
    _, wider, _ = _engine(2, "adam", channels=[8, 24])
    with pytest.raises(ValueError, match="shape"):
        restore_fit_state(path, wider)
