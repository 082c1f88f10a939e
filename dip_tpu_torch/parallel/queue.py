"""Many independent DIP fits on one device: a round-robin fit queue
(counterpart of dip_tpu/parallel/queue.py).

Each fit keeps its own step program (on CUDA, its own CUDA graph, replayed
on its own stream), and the queue round-robins `log_every`-step chunks
across the fits. The graphs are captured first, one job after another;
enqueueing a chunk then does not wait for the device, so the host enqueues
fit B's chunk while fit A's runs, and the fits' kernels share the card
where one fit alone leaves it idle.

The JAX queue lets structurally equal specs share one Engine, since a
flax module holds no weights. The port's Engine trains its model's own
parameters in place, and a graph reads its own fit's buffers, so each job
gets its own copy of the spec's model and its own Engine.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import torch

from dip_tpu_torch.fit.engine import Engine, FitState, concat_history
from dip_tpu_torch.tasks.base import TaskSpec, finish_task, start_task


@dataclasses.dataclass
class _Job:
    name: str
    spec: TaskSpec
    engine: Engine
    state: FitState
    aux: Any
    remaining: int
    it: int = 0
    hist_chunks: list = dataclasses.field(default_factory=list)


class FitQueue:
    """Run many independent DIP fits on one device.

    add() TaskSpecs, then run(), which returns name -> (output after the
    spec's postprocess, state, history). `callback(name, it, history)`, if
    given, gets each job's last chunk as numpy arrays at each round's end
    (a host sync a round); without it the host waits once, at the end.
    """

    def __init__(self, callback: Callable[[str, int, dict], None] | None = None):
        self.jobs: list[_Job] = []
        self.callback = callback

    def add(self, spec: TaskSpec, seed: int, name: str | None = None, *,
            device: torch.device | str) -> "FitQueue":
        """Queue a fit of `spec` seeded as run_task(spec, seed) seeds it,
        on a copy of spec.model."""
        spec = dataclasses.replace(spec, model=copy.deepcopy(spec.model))
        eng, state, aux = start_task(spec, seed, device=device)
        self.jobs.append(_Job(name=name or f"{spec.name}#{len(self.jobs)}", spec=spec,
                              engine=eng, state=state, aux=aux,
                              remaining=spec.cfg.num_iter))
        return self

    def run(self) -> dict[str, tuple[Any, FitState, dict]]:
        active = [j for j in self.jobs if j.remaining > 0]
        # every job's step is captured before any job's replays are
        # enqueued: a capture waits for the device (Engine.capture)
        for job in active:
            job.engine.capture(job.state, job.aux)
        while active:
            # one chunk per job, each enqueued without waiting for the last
            for job in active:
                n = min(job.engine.cfg.log_every, job.remaining)
                job.hist_chunks.append(job.engine.run_chunk(job.state, job.aux, n))
                job.remaining -= n
                job.it += n
            if self.callback is not None:
                for job in active:
                    job.engine.wait()
                    host = {k: v.cpu().numpy() for k, v in job.hist_chunks[-1].items()}
                    job.hist_chunks[-1] = host
                    self.callback(job.name, job.it, host)
            active = [j for j in active if j.remaining > 0]

        results = {}
        for job in self.jobs:
            job.engine.wait()
            history = concat_history(job.hist_chunks)
            results[job.name] = (finish_task(job.spec, job.engine, job.state), job.state,
                                 history)
        return results
