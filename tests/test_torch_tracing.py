"""The port's spans (dip_tpu_torch.utils.profiling.span): silent and free
with tracing off, named and nested as the layers are with it on, the fit
bitwise the same either way, and the benchmark's attribution of work to
them (dipbench/spans.py) on a real CPU profile of a tiny Skip and on
synthetic device traces. The graphed fit's launch counters under tracing
need the card (`cuda` marker)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from dip_tpu_torch.fit.engine import Engine, FitConfig  # noqa: E402
from dip_tpu_torch.models import Skip  # noqa: E402
from dip_tpu_torch.ops import launches  # noqa: E402
from dip_tpu_torch.ops.losses import mse, psnr  # noqa: E402
from dip_tpu_torch.parallel import BatchEngine  # noqa: E402
from dip_tpu_torch.utils import profiling  # noqa: E402
from dipbench import spans  # noqa: E402

SMALL = dict(num_input_channels=8, num_channels_down=[8] * 2, num_channels_up=[8] * 2,
             num_channels_skip=[4] * 2, upsample_mode="bilinear", pad="reflection")
CFG = FitConfig(num_iter=4, log_every=2, reg_noise_std=0.03, exp_weight=0.99,
                compute_dtype="bfloat16")
FIT_SPANS = {"dip.fit.jitter", "dip.fit.cast", "dip.fit.forward", "dip.fit.loss",
             "dip.fit.backward", "dip.fit.optimizer", "dip.fit.ema", "dip.fit.metrics"}
MODEL_SPANS = {"dip.model.conv", "dip.model.bn", "dip.model.act", "dip.model.pad",
               "dip.kernels.seam"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _target() -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).random((1, 32, 32, 3)).astype(np.float32))


def _metrics(o, e, a):
    return {"psnr_track": psnr(o, a)}


def _engine(batch: int = 0, device="cpu"):
    """(engine, state, aux, step) of a tiny bf16 Skip fit, or of `batch`
    such fits as one BatchEngine; step() takes one eager step."""
    loss = lambda p, o, a: mse(o, a)  # noqa: E731
    z = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 32, 32, 8))
                         .astype(np.float32))
    if not batch:
        eng = Engine(Skip(**SMALL), loss, CFG, _metrics, device=device)
        state, aux = eng.init_state(0, z), _target().to(device)
        return eng, state, aux, lambda: eng.step(state, aux)[1]
    eng = BatchEngine(Skip(**SMALL), loss, CFG, _metrics, device=device)
    state = eng.init_state(range(batch), z.expand(batch, *z.shape).clone())
    aux = _target().expand(batch, 1, 32, 32, 3).clone().to(device)
    return eng, state, aux, lambda: eng.step(state, aux)


def _profiled(fn, on: bool):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if on:
            with profiling.tracing():
                fn()
        else:
            fn()
    return prof


def test_span_off_is_one_shared_no_op():
    assert profiling.span("dip.fit.forward") is profiling.span("dip.model.conv")
    with profiling.tracing():
        assert profiling.span("dip.fit.forward") is not profiling.span("dip.fit.forward")
        with profiling.tracing():
            pass
        assert profiling.span("x") is not profiling.span("x")  # still on after the inner block
    assert profiling.span("x") is profiling.span("y")


def test_spans_off_record_nothing():
    """A profiler outside the program does not turn the spans on."""
    _, _, _, step = _engine()
    step()
    prof = _profiled(step, on=False)
    names = {e.name for e in prof.events()}
    assert "aten::convolution" in names
    assert not [n for n in names if n.startswith("dip.")]


def _parents(e):
    while e.cpu_parent is not None:
        e = e.cpu_parent
        yield e.name


@pytest.mark.parametrize("batch", [0, 2], ids=["engine", "batch2"])
def test_spans_on_names_and_nesting(batch):
    _, _, _, step = _engine(batch)
    step()
    events = [e for e in _profiled(step, on=True).events() if e.name.startswith("dip.")]
    names = {e.name for e in events}
    assert FIT_SPANS | MODEL_SPANS <= names
    assert ("dip.batch.jitter" in names) == bool(batch)
    for e in events:
        up = list(_parents(e))
        if e.name in ("dip.fit.forward", "dip.fit.loss", "dip.fit.backward"):
            assert up[0] == "Optimizer.step#Adam.step" and "dip.fit.optimizer" in up, e.name
        if e.name in MODEL_SPANS:
            assert "dip.fit.forward" in up, (e.name, up)
        if e.name == "dip.kernels.seam":
            assert up[0] in ("dip.model.conv", "dip.model.bn"), up
        if e.name == "dip.batch.jitter":
            assert up[0] == "dip.fit.jitter", up
        if e.name == "dip.fit.cast":
            assert up[0] == "dip.fit.forward", up


def test_batch_run_spans_its_chunks_and_host_reads():
    eng, state, aux, _ = _engine(batch=2)
    names = [e.name for e in _profiled(lambda: eng.run(state, aux), on=True).events()]
    assert names.count("dip.batch.chunk") == 2 and names.count("dip.batch.host") == 2


def test_trace_writes_the_spans(tmp_path):
    """`trace()` (the CLI's --profile) turns the spans on for its block."""
    _, _, _, step = _engine()
    with profiling.trace(str(tmp_path)):
        step()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert {"dip.fit.forward", "dip.model.conv"} <= {e.get("name") for e in events}


@pytest.mark.parametrize("batch", [0, 2], ids=["engine", "batch2"])
def test_tracing_leaves_the_fit_bitwise(batch):
    """One seed, three steps with the spans off and three with them on
    under a profiler: the same losses, params and EMA, bit for bit."""
    runs = []
    for on in (False, True):
        _, state, _, step = _engine(batch)
        losses = []
        for _ in range(3):
            prof = _profiled(lambda: losses.append(step()["loss"]), on)
            del prof
        shard = state.shards[0] if batch else state
        runs.append((losses, {k: p.detach().clone() for k, p in shard.params.items()},
                     shard.ema_out.clone()))
    (l0, p0, e0), (l1, p1, e1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert torch.equal(e0, e1)


def _backward_node(e):
    while e is not None and not e.name.startswith(spans.BACKWARD):
        e = e.cpu_parent
    return e


def test_backward_ops_go_to_their_forward_span():
    """On a real CPU profile, each aten op of a backward node is owned by
    the span of the forward op of the node's sequence number."""
    _, _, _, step = _engine()
    step()
    prof = _profiled(step, on=True)
    _, hosts = spans.from_profile(prof)
    att = spans.Attribution(hosts)
    by_event = dict(zip((e for e in prof.events() if e.device_type.name == "CPU"
                         and not getattr(e, "is_async", False)), hosts))
    want = {"ConvolutionBackward0": "dip.model.conv", "LeakyReluBackward0": "dip.model.act",
            "_EdgePadBackward": "dip.model.pad", "UpConv3x3Backward": "dip.kernels.seam",
            "SigmoidBackward0": "dip.fit.forward", "MeanBackward0": "dip.fit.loss"}
    seen = dict.fromkeys(want, 0)
    for e, h in by_event.items():
        node = _backward_node(e.cpu_parent)
        if not e.name.startswith("aten::") or node is None:
            continue
        kind = node.name.split(": ")[-1]
        assert att.owner(h) != "dip.fit.backward" or kind == "torch::autograd::AccumulateGrad", \
            (e.name, kind)
        if kind in want:
            assert att.owner(h) == want[kind], (e.name, kind, att.owner(h))
            seen[kind] += 1
    assert all(seen.values()), seen
    assert att.via.get("sequence_nr", 0) > 0 and "no span" not in att.via


def _host(name, start, end, corr=0, parent=None):
    return spans.Host(name, start, end, thread=1, corr=corr, parent=parent)


def test_idle_split_into_bubbles_and_host_gaps():
    """Two replays and a copy; the gap inside replay 1 is a bubble, every
    other gap and the window's edges are host gaps, named by the span
    open at their middle."""
    replay = _host("dip.fit.replay", 0, 4)
    rows = _host("dip.fit.rows", 30, 40)
    hosts = [replay, _host("cudaGraphLaunch", 1, 3, corr=11, parent=replay),
             _host("dip.fit.replay", 4, 8), _host("cudaGraphLaunch", 5, 7, corr=12),
             rows, _host("cudaLaunchKernel", 31, 32, corr=13, parent=rows)]
    ops = [spans.Op("k1", 10, 20, 11), spans.Op("k2", 22, 30, 11),
           spans.Op("k3", 33, 40, 12), spans.Op("k4", 38, 45, 12),
           spans.Op("copy", 50, 51, 13)]
    att = spans.Attribution(hosts)
    replay_of = spans.replays(ops, att)
    assert replay_of == {0: 0, 1: 0, 2: 1, 3: 1}
    bubble, host = spans.split_idle(ops, replay_of, att.span_at, (0, 60))
    assert bubble == 2  # 20 -> 22 inside replay 0; k3 and k4 overlap
    # 0-10 (middle 5: the second replay span), 30-33 (rows), 45-50 and 51-60 (none)
    assert host == {"dip.fit.replay": 10, "dip.fit.rows": 3, spans.OUTSIDE: 14}
    assert bubble + sum(host.values()) == 60 - (10 + 8 + 12 + 1)
    assert att.op_owner(ops[4]) == "dip.fit.rows" and att.op_owner(ops[0]) == "dip.fit.replay"


def test_operations_a_replay_did_not_run_make_host_gaps():
    """Operations without a launch's id are in no replay: every gap
    between them is a host gap."""
    hosts = [_host("cudaGraphLaunch", 0, 1, corr=1), _host("cudaLaunchKernel", 4, 5, corr=3)]
    ops = [spans.Op(f"k{i}", 10 * i, 10 * i + 5, 0) for i in range(3)]
    ops.append(spans.Op("copy", 40, 41, 3))
    assert spans.replays(ops, spans.Attribution(hosts)) == {}
    bubble, host = spans.split_idle(ops, {}, lambda t: None, (0, 50))
    assert bubble == 0 and host == {spans.OUTSIDE: 50 - 16}


def test_owners_cover_every_operation():
    """Each operation has one owner, so the owners sum to the device time;
    an operation no runtime call launched is unattributed."""
    span = _host("dip.model.bn", 0, 10)
    att = spans.Attribution([span, _host("cudaLaunchKernel", 1, 2, corr=5, parent=span)])
    ops = [spans.Op("a", 0, 3, 5), spans.Op("b", 3, 4, 6)]
    owned = spans.owners_us(ops, att)
    assert owned == {"dip.model.bn": [("a", 3)], spans.UNATTRIBUTED: [("b", 1)]}


def test_bench_profile_idle_counts_overlaps_once():
    """bench --profile's busy time is the union of the device operations'
    intervals, the spans' device-side annotations left out."""
    from types import SimpleNamespace as NS

    from dip_tpu_torch import bench

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(a, b, device=cuda, note=False):
        return NS(device_type=device, is_user_annotation=note, time_range=NS(start=a, end=b))

    prof = NS(events=lambda: [ev(0, 10), ev(5, 20), ev(30, 40), ev(0, 100, note=True),
                              ev(0, 50, device=cpu), ev(32, 35)])
    assert bench._busy_us(prof) == 30


@pytest.mark.cuda
def test_graphed_fit_launches_unchanged_under_tracing():
    """A graphed fit with the spans on and a profiler running launches what
    the eager steps of the same seed launch, and ends bitwise the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        launches.reset()
        _, state, _, step = _engine(device=dev)
        eager = [step() for _ in range(4)]
        torch.cuda.synchronize()
        counts = launches.counts()
        launches.reset()
        geng, gstate, gaux, _ = _engine(device=dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]), \
                profiling.tracing():
            gstate, hist = geng.run(gstate, gaux)
        torch.cuda.synchronize()
        assert gstate.graph is not None and launches.counts() == counts
        np.testing.assert_array_equal(hist["loss"],
                                      torch.stack([m["loss"] for m in eager]).cpu().numpy())
        assert all(torch.equal(gstate.params[k], state.params[k]) for k in state.params)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
