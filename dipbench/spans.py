"""The program's own spans on the device trace's clock: which `dip.*` span
launched each device operation, and where the card idles.

The port marks its work with `dip_tpu_torch.utils.profiling.span` (named
`dip.<layer>.<what>`), which records only inside `profiling.tracing()`.
The traced window the harness records (`trace.py`) runs with the spans off
and keeps no correlation ids, so the readers of this module run one
profiler session of their own a process, the first time one of them asks,
on a fresh program of the run's cell (a fixed seed: the work does not
depend on it):

1. the eager pass: one unprofiled eager step through the engine's `step`,
   then `EAGER_STEPS` profiled ones with the spans on, before anything is
   captured (a batch never holds eager activations and a graph pool at
   once);
2. the graphed pass: one unprofiled chunk (which captures the step), then
   `program.run(profile_steps)` profiled with the spans on, as the harness
   times it.

Each device operation of the eager pass gets an owner: its correlation id
leads to the runtime call that launched it, and that call's host parents
up to the innermost `dip.*` span. A backward operation's host stack holds
an `autograd::engine::evaluate_function` node in place of the forward's
spans: its `sequence_nr` leads to the forward op that made the node, and
that op's innermost span owns it. What has no owner is `unattributed`.

In the graphed pass an operation belongs to the replay whose
`cudaGraphLaunch` correlation id it carries (kineto gives a replayed
kernel its launch's id; on the H100 every graphed operation of the
window had one). Each idle interval of the window is a bubble
(between two operations of one replay) or a host gap (anything else,
the window's edges included), named by the innermost `dip.*` span open on
the host at its middle, or `outside`.

Readers return None without a device trace (the CPU), and where the
program has no spans to turn on. The owner table, the host gaps by span
and the mean host time of a `dip.fit.replay` span go to stderr.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import json
import sys
import time
from typing import Callable

from dipbench.trace import kernel_maps, kind_of, merged

PREFIX = "dip."
BACKWARD = "autograd::engine::evaluate_function"
GRAPH_LAUNCH = "cudaGraphLaunch"
WINDOW = "dipbench.window"
UNATTRIBUTED = "unattributed"
OUTSIDE = "outside"
EAGER_STEPS = 3
SEED = 1234567891


@dataclasses.dataclass(eq=False)
class Host:
    """A host event: an op, a span, a runtime call."""
    name: str
    start: float                  # us
    end: float
    thread: int
    corr: int = 0                 # correlation id (a runtime call's matches its device ops')
    seq: int = -1                 # autograd sequence number
    fwd_thread: int = -1          # a backward node's forward thread
    parent: "Host | None" = None


@dataclasses.dataclass
class Op:
    """A device operation."""
    name: str
    start: float                  # us
    end: float
    corr: int = 0


def from_profile(prof) -> tuple[list[Op], list[Host]]:
    """The device operations and host events of a torch.profiler session,
    user annotations on the host kept, with each host event's parent."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, hosts, made = [], [], {}
    events = prof.events()
    for e in events:
        if e.device_type == cuda:
            if not e.is_user_annotation:
                ops.append(Op(e.name, float(e.time_range.start), float(e.time_range.end),
                              int(e.id)))
            continue
        if getattr(e, "is_async", False):
            continue
        fwd_thread = getattr(e, "fwd_thread", None)
        h = Host(e.name, float(e.time_range.start), float(e.time_range.end), int(e.thread),
                 int(e.id), int(getattr(e, "sequence_nr", -1)),
                 -1 if fwd_thread is None else int(fwd_thread))
        made[id(e)] = h
        hosts.append(h)
    for e in events:
        h = made.get(id(e))
        if h is not None and e.cpu_parent is not None:
            h.parent = made.get(id(e.cpu_parent))
    return ops, hosts


def is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
    cudaGraphLaunch, cudaMemcpyAsync, ...)."""
    return name.startswith("cu") and "::" not in name


class Attribution:
    """Owners of host events and device operations, from one session's
    host events."""

    def __init__(self, hosts: list[Host]):
        self.via: dict[str, int] = {}  # how each owner was found, for the report
        self.runtime = {h.corr: h for h in hosts if is_runtime(h.name)}
        self.spans = sorted((h for h in hosts if h.name.startswith(PREFIX)),
                            key=lambda h: h.start)
        self._starts = [h.start for h in self.spans]
        # the forward op that made autograd node (thread, seq): of the ops
        # outside any backward that record that number, the last to start
        # (ops that make no node record the number the next node will get)
        in_backward: dict[int, bool] = {}

        def backward(h: Host | None) -> bool:
            chain = []
            while h is not None and id(h) not in in_backward:
                chain.append(h)
                h = h.parent
            known = in_backward.get(id(h), False) if h is not None else False
            for node in reversed(chain):
                known = known or node.name.startswith(BACKWARD)
                in_backward[id(node)] = known
            return known

        self.forward: dict[tuple[int, int], Host] = {}
        self.forward_seq: dict[int, Host] = {}  # where the threads do not match
        for h in sorted(hosts, key=lambda h: h.start):
            if h.seq >= 0 and not backward(h):
                self.forward[(h.thread, h.seq)] = self.forward_seq[h.seq] = h
        self._seqs = sorted(self.forward_seq)

    def span_at(self, t: float) -> str | None:
        """The innermost `dip.*` span open at time t, on any host thread."""
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0:
            s = self.spans[i]
            if s.end > t:
                return s.name
            i -= 1
        return None

    def owner(self, h: Host) -> str:
        """The innermost `dip.*` span above h; through a backward node, the
        span of the forward op of its sequence number; where the host stack
        names neither, the innermost span open when h (or that forward op)
        started."""
        node, at, how = h, h, "host stack"
        while node is not None:
            if node.name.startswith(PREFIX):
                self._count(how)
                return node.name
            if node.name.startswith(BACKWARD):
                fwd = self._forward_op(node.fwd_thread, node.seq)
                if fwd is not None:
                    node, at, how = fwd, fwd, "sequence_nr"
                    continue
            node = node.parent
        name = self.span_at(at.start)
        self._count("open span" if name else "no span")
        return name or UNATTRIBUTED

    def _forward_op(self, thread: int, seq: int) -> Host | None:
        """The forward op of node `seq`; for a node no op records (an
        in-place op on a view makes a CopySlices, a view of a modified base
        an AsStridedBackward0, after the op's own node), the op of the
        greatest number below it."""
        if seq < 0:  # AccumulateGrad
            return None
        exact = self.forward.get((thread, seq)) or self.forward_seq.get(seq)
        if exact is not None:
            return exact
        i = bisect.bisect_right(self._seqs, seq) - 1
        return self.forward_seq[self._seqs[i]] if i >= 0 else None

    def op_owner(self, op: Op) -> str:
        call = self.runtime.get(op.corr)
        if call is None:
            self._count("no runtime call")
            return UNATTRIBUTED
        return self.owner(call)

    def _count(self, how: str) -> None:
        self.via[how] = self.via.get(how, 0) + 1


def owners_us(ops: list[Op], att: Attribution) -> dict[str, list[tuple[str, float]]]:
    """owner -> [(operation name, us)] of each operation it owns."""
    out: dict[str, list[tuple[str, float]]] = {}
    for op in ops:
        out.setdefault(att.op_owner(op), []).append((op.name, op.end - op.start))
    return out


def replays(ops: list[Op], att: Attribution) -> dict[int, int]:
    """Each replayed operation's replay (index into `ops` -> the launch's
    number): kineto gives an operation a graph replays the correlation id
    of its `cudaGraphLaunch`. An operation another runtime call launched
    is in no replay."""
    launches = sorted((h for h in att.runtime.values() if h.name == GRAPH_LAUNCH),
                      key=lambda h: h.start)
    number = {h.corr: i for i, h in enumerate(launches)}
    return {i: number[op.corr] for i, op in enumerate(ops) if op.corr in number}


def split_idle(ops: list[Op], replay_of: dict[int, int], span_at: Callable[[float], str | None],
               window: tuple[float, float]) -> tuple[float, dict[str, float]]:
    """(bubble us, {span: host-gap us}) of the window's idle time: a gap
    between merged device intervals whose two neighbouring operations are
    of one replay is a bubble; every other gap, and the window's edges, a
    host gap named by the innermost span open at its middle (`outside`)."""
    t0, t1 = window
    inside = [(i, op) for i, op in enumerate(ops) if op.end > t0 and op.start < t1]
    bubble, host = 0.0, {}

    def host_gap(a: float, b: float) -> None:
        if b > a:
            name = span_at((a + b) / 2) or OUTSIDE
            host[name] = host.get(name, 0.0) + (b - a)

    if not inside:
        host_gap(t0, t1)
        return bubble, host
    # merged intervals, each with the operation that ends it and the one that starts it
    runs: list[list] = []  # [start, end, first index, last index]
    for i, op in sorted(inside, key=lambda io: io[1].start):
        a, b = max(op.start, t0), min(op.end, t1)
        if runs and a <= runs[-1][1]:
            if b > runs[-1][1]:
                runs[-1][1], runs[-1][3] = b, i
        else:
            runs.append([a, b, i, i])
    host_gap(t0, runs[0][0])
    for (_, end, _, last), (start, _, first, _) in zip(runs, runs[1:]):
        r = replay_of.get(last)
        if r is not None and r == replay_of.get(first):
            bubble += start - end
        else:
            host_gap(end, start)
    host_gap(runs[-1][1], t1)
    return bubble, host


@dataclasses.dataclass
class Session:
    eager_fit_iters: int
    owners: dict[str, float]          # owner -> device ms a fit-iteration, eager pass
    eager_busy_ms: float              # union of the eager pass's operations, a fit-iteration
    graphed_fit_iters: int
    graphed_ops: int                  # device operations in the graphed window
    graphed_busy_ms: float            # a fit-iteration
    graphed_idle_ms: float            # a fit-iteration: window - busy
    bubble_ms: float                  # a fit-iteration
    host_gaps: dict[str, float]       # span -> ms a fit-iteration
    replay_host_us: float | None      # mean host time of a dip.fit.replay span
    replay_host_us_least: float | None  # its least
    replayed: int                     # of graphed_ops, those a graph replay ran
    seconds: float                    # the session's own wall time

    def owned_ms(self, keep: Callable[[str], bool]) -> float:
        return sum(ms for o, ms in self.owners.items() if keep(o))


_SESSIONS: dict[tuple, Session | None] = {}


def session(run) -> Session | None:
    """The session of `run`'s cell, made the first time a reader asks; None
    on the CPU (no device trace) or where the program has no spans."""
    if run.trace is None or not run.trace.device:
        return None
    key = (str(run.checkout), run.cfg.get("name"), run.fits)
    if key not in _SESSIONS:
        _SESSIONS[key] = _record(run)
    return _SESSIONS[key]


def _cell_traffic(run) -> dict:
    """The traffic of the cell with `run`'s configuration and fits."""
    root = run.checkout
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        if w["config"] != run.cfg.get("name"):
            continue
        traffic = json.loads((root / "dipbench" / "traffic" / f"{w['traffic']}.json").read_text())
        if traffic["fits"] == run.fits:
            return traffic
    raise LookupError(f"no cell of {run.cfg.get('name')!r} with {run.fits} fits")


def _record(run, dev=None) -> Session | None:
    """The session on `dev` (the card by default; the CPU tests pass the
    CPU, whose profile has no device operation)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from dip_tpu_torch.utils import profiling

    if not hasattr(profiling, "tracing"):
        print("# spans: the program has no spans to turn on", file=sys.stderr)
        return None
    from dipbench import inputs
    from dipbench.program import Program

    t_start = time.perf_counter()
    dev = torch.device("cuda") if dev is None else dev
    traffic = _cell_traffic(run)
    program = Program(run.cfg, traffic, inputs.make(run.cfg, run.fits, SEED, dev), dev)
    marks = [time.perf_counter()]
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def eager_step():
        program.engine.step(program.state, program.aux)

    # the eager pass, before any capture
    eager_step()
    sync()
    with profile(activities=activities) as prof, profiling.tracing():
        for _ in range(EAGER_STEPS):
            eager_step()
        sync()
    marks.append(time.perf_counter())
    e_ops, e_hosts = from_profile(prof)
    del prof
    e_att = Attribution(e_hosts)
    e_iters = EAGER_STEPS * run.fits
    owned = owners_us(e_ops, e_att)
    print(f"# spans: eager operations {len(e_ops)}, owners found by " + ", ".join(
        f"{k} {v}" for k, v in e_att.via.items()), file=sys.stderr)

    # the graphed pass
    marks.append(time.perf_counter())
    steps = traffic["profile_steps"]
    program.run(steps)
    sync()
    with profile(activities=activities) as prof, profiling.tracing():
        with record_function(WINDOW):
            program.run(steps)
            sync()
    marks.append(time.perf_counter())
    g_ops, g_hosts = from_profile(prof)
    del prof, program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    g_att = Attribution(g_hosts)
    g_iters = steps * run.fits
    win = next(h for h in g_hosts if h.name == WINDOW)
    in_window = [op for op in g_ops if op.end > win.start and op.start < win.end]
    replay_of = replays(in_window, g_att)
    bubble_us, host_us = split_idle(in_window, replay_of, g_att.span_at, (win.start, win.end))
    busy_us = sum(b - a for a, b in merged([(o.name, max(o.start, win.start), min(o.end, win.end))
                                            for o in in_window]))
    replay_spans = sorted(h.end - h.start for h in g_hosts if h.name == "dip.fit.replay")
    out = Session(
        eager_fit_iters=e_iters,
        owners={o: sum(us for _, us in v) * 1e-3 / e_iters for o, v in owned.items()},
        eager_busy_ms=sum(b - a for a, b in merged([(o.name, o.start, o.end) for o in e_ops]))
        * 1e-3 / e_iters,
        graphed_fit_iters=g_iters,
        graphed_ops=len(in_window),
        graphed_busy_ms=busy_us * 1e-3 / g_iters,
        graphed_idle_ms=(win.end - win.start - busy_us) * 1e-3 / g_iters,
        bubble_ms=bubble_us * 1e-3 / g_iters,
        host_gaps={k: v * 1e-3 / g_iters for k, v in host_us.items()},
        replay_host_us=sum(replay_spans) / len(replay_spans) if replay_spans else None,
        replay_host_us_least=replay_spans[0] if replay_spans else None,
        replayed=len(replay_of),
        seconds=time.perf_counter() - t_start)
    marks.append(time.perf_counter())
    print("# spans: session seconds: program {:.1f}, eager pass {:.1f}, its reading {:.1f}, "
          "graphed pass {:.1f}, its reading {:.1f}".format(
              marks[0] - t_start, *(b - a for a, b in zip(marks, marks[1:]))), file=sys.stderr)
    _report(out, owned, run)
    return out


def _report(s: Session, owned: dict[str, list[tuple[str, float]]], run) -> None:
    """The owner table (ms a fit-iteration by kernel kind), the host gaps
    by span and the replay span's host time, on stderr."""
    root = run.checkout / "dipbench"
    port = {k for m in kernel_maps(root).values() for k in m}
    kinds = json.loads((root / "kernels" / "kinds.json").read_text())["kinds"]
    names = ["port", *(k for k, _ in kinds), "other"]
    p = lambda line: print(line, file=sys.stderr)  # noqa: E731
    p(f"# spans: eager pass {s.eager_fit_iters} fit-iterations, device ms a fit-iteration "
      f"{sum(s.owners.values()):.4f} (busy, overlaps once: {s.eager_busy_ms:.4f}), "
      f"unattributed {s.owners.get(UNATTRIBUTED, 0.0):.4f}")
    p("# spans: owner | ms a fit-iteration | " + " | ".join(names))
    rows = dict.fromkeys(["dip.model.up", UNATTRIBUTED], 0.0) | s.owners
    for owner in sorted(rows, key=lambda o: -rows[o]):
        by_kind = dict.fromkeys(names, 0.0)
        for name, us in owned.get(owner, []):
            by_kind[kind_of(name, port, kinds)] += us * 1e-3 / s.eager_fit_iters
        p(f"# spans: {owner} | {rows[owner]:.4f} | "
          + " | ".join(f"{by_kind[k]:.4f}" for k in names))
    p(f"# spans: graphed pass {s.graphed_fit_iters} fit-iterations, {s.graphed_ops} device "
      f"operations, busy {s.graphed_busy_ms:.4f} idle {s.graphed_idle_ms:.4f} ms a "
      f"fit-iteration: bubbles {s.bubble_ms:.4f}, host gaps {sum(s.host_gaps.values()):.4f} "
      f"({s.replayed} operations in replays)")
    for name, ms in sorted(s.host_gaps.items(), key=lambda kv: -kv[1]):
        p(f"# spans: host gap {name} {ms:.5f} ms a fit-iteration")
    replay = ("none" if s.replay_host_us is None else
              f"mean {s.replay_host_us:.2f}, least {s.replay_host_us_least:.2f}")
    p(f"# spans: dip.fit.replay host us: {replay}; session {s.seconds:.1f} s")


def owned_ms(run, keep: Callable[[str], bool]) -> float | None:
    """Device ms a fit-iteration of the eager pass's operations whose owner
    `keep` accepts; None without a session."""
    s = session(run)
    return None if s is None else s.owned_ms(keep)
