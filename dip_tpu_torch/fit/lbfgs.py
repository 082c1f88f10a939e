"""L-BFGS with a zoom line search, the algorithm of optax.lbfgs() as the
JAX package runs it (`optax.lbfgs(learning_rate=None)`, optax 0.2.6):

  - the direction: -P g, P the L-BFGS inverse Hessian of the last
    MEMORY (param difference, gradient difference) pairs by the two-loop
    recursion, its initial scale gamma = dw.du / du.du of the newest pair
    (the first step: min(1, 1 / |g|));
  - the step size: the zoom line search of Nocedal and Wright (algorithms
    3.5 and 3.6) from a first guess of 1: grow the step by 2 until an
    interval holds a step that meets the strong Wolfe conditions (Armijo
    slope_rtol 1e-4, curvature 0.9; Hager and Zhang's approximate decrease
    test near the minimum, rtol 1e-6), then zoom into it by cubic, then
    quadratic interpolation, then bisection; at most MAX_LINESEARCH_STEPS
    trials, after which the last trial with a sufficient decrease is taken
    (optax's lbfgs sets 20).

A torch.optim.Optimizer over one flat f32 view of its parameters, whose
`step(closure)` takes the closure of torch.optim.LBFGS: it sets the
gradients of the parameters as they stand and returns the loss. The first
call evaluates the current parameters; each trial of the line search
sets the parameters to x + t d and calls it again. The two-loop recursion
runs on the parameters' device; each trial's Wolfe test is read on the
host (the value and the slope, one sync a trial), so a step cannot be
captured in a CUDA graph. The scalar arithmetic of the line search is
f32, as optax's. `BatchZoomLBFGS` runs B fits' L-BFGS at once for
BatchEngine, their line searches in lockstep, one evaluation of all the
fits a round.
"""

from __future__ import annotations

import numpy as np
import torch

MEMORY = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5

_f32 = np.float32


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The minimiser of the cubic through (a, fa) with slope fpa, (b, fb)
    and (c, fc) (nan where there is none)."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    d1 = np.array([[dc ** 2, -(db ** 2)], [-(dc ** 3), db ** 3]], dtype=_f32)
    big_a, big_b = d1 @ np.array([fb - fa - fpa * db, fc - fa - fpa * dc], dtype=_f32) / denom
    radical = big_b * big_b - _f32(3) * big_a * fpa
    return a + (-big_b + np.sqrt(radical)) / (_f32(3) * big_a)


def _quadmin(a, fa, fpa, b, fb):
    """The minimiser of the quadratic through (a, fa) with slope fpa and (b, fb)."""
    db = b - a
    big_b = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (_f32(2) * big_b)


def _decrease_error(t, value, slope, value_init, slope_init):
    """How far (t, value, slope) misses a sufficient decrease: Armijo's, or
    the approximate decrease near the minimum; 0 when met, inf for nan."""
    armijo = value - value_init - _f32(SLOPE_RTOL) * t * slope_init
    approx = np.maximum(slope - _f32(2 * SLOPE_RTOL - 1.0) * slope_init,
                        value - value_init - _f32(APPROX_DEC_RTOL) * abs(value_init))
    err = np.maximum(np.minimum(approx, armijo), _f32(0))
    return _f32(np.inf) if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    err = np.maximum(abs(slope) - _f32(CURV_RTOL) * abs(slope_init), _f32(0))
    return _f32(np.inf) if np.isnan(err) else err


def zoom_search(value_init: float, slope_init: float):
    """optax's zoom_linesearch with its defaults, step for step, as a
    generator: it yields each trial step t and is sent back (value, slope)
    at t, slope the directional derivative there; value_init and
    slope_init are at t = 0. It returns (step size, trials) (the value of
    its StopIteration). Many of them advance in lockstep where many
    independent line searches share one evaluation a round (BatchZoomLBFGS)."""
    v0, s0 = _f32(value_init), _f32(slope_init)
    # the last trial, its decrease error, the interval's ends (low has the
    # lower value), the cubic's third point, and the best trial with a
    # sufficient decrease
    t, value, slope, dec = _f32(0), v0, s0, _f32(np.inf)
    low, high, ref = (_f32(0), v0, s0), (_f32(0), v0, s0), (_f32(0), v0)
    safe, v_safe = _f32(0), v0
    interval_found = done = failed = False
    count = 0
    # numpy's error state is set around the arithmetic only, not across a
    # yield: searches that advance in lockstep interleave
    while not (done or failed):
        with np.errstate(all="ignore"):
            prev = (t, value, slope)
            if not interval_found:
                # grow the step until an interval brackets a Wolfe point
                t = _f32(1) if count == 0 else _f32(INCREASE_FACTOR) * t
            else:
                (lo, v_lo, s_lo), (hi, v_hi, _) = low, high
                delta = abs(hi - lo)
                left, right = min(hi, lo), max(hi, lo)
                cubic = _cubicmin(lo, v_lo, s_lo, hi, v_hi, *ref)
                quad = _quadmin(lo, v_lo, s_lo, hi, v_hi)
                if left + _f32(0.2) * delta < cubic < right - _f32(0.2) * delta:
                    t = _f32(cubic)
                elif left + _f32(0.1) * delta < quad < right - _f32(0.1) * delta:
                    t = _f32(quad)
                else:
                    t = (lo + hi) / _f32(2)
        value, slope = (_f32(v) for v in (yield float(t)))
        with np.errstate(all="ignore"):
            dec = _decrease_error(t, value, slope, v0, s0)
            done = np.maximum(dec, _curvature_error(slope, s0)) <= 0
            last = count + 1 >= MAX_LINESEARCH_STEPS
            if not interval_found:
                if dec <= 0:
                    safe, v_safe = t, value
                set_high = dec > 0 or (value >= prev[1] and count > 0)
                set_low = slope >= 0 and not set_high
                low, high = ((t, value, slope), prev) if set_low else (prev, (t, value, slope))
                ref = low[:2]
                interval_found = set_high or set_low or done
                failed = last and not done
            else:
                if dec <= 0 and value < v_safe:
                    safe, v_safe = t, value
                high_to_mid = dec > 0 or value >= v_lo
                high_to_low = slope * (hi - lo) >= 0 and not high_to_mid
                ref = (hi, v_hi) if high_to_mid or high_to_low else (lo, v_lo)
                if high_to_mid:
                    high = (t, value, slope)
                else:
                    if high_to_low:
                        high = low
                    low = (t, value, slope)
                too_small = delta <= _f32(STEPSIZE_PRECISION)
                failed = (last or (too_small and safe > 0)) and not done
            count += 1
            if failed and (safe > 0 or np.isinf(dec)):
                t = safe
    return float(t), count


def zoom_linesearch(evaluate, value_init: float, slope_init: float) -> tuple[float, int]:
    """The step size along a direction, and the trials it took:
    `evaluate(t)` -> (value, slope) at step t, slope the directional
    derivative there; value_init and slope_init at t = 0 (zoom_search,
    driven by one evaluation a trial)."""
    search = zoom_search(value_init, slope_init)
    t = next(search)
    while True:
        try:
            t = search.send(evaluate(t))
        except StopIteration as stop:
            return stop.value


class ZoomLBFGS(torch.optim.Optimizer):
    """optax.lbfgs(learning_rate=None) over the given f32 parameters (see
    the module docstring). Its state, in `state_dict()`, is the step count,
    the parameters and gradient of the last step, and the memory of
    differences; `last_evals` is the number of closure calls of the last
    step (1 + its line-search trials)."""

    def __init__(self, params):
        super().__init__(params, {})
        self._params = [p for g in self.param_groups for p in g["params"]]
        if any(p.dtype != torch.float32 for p in self._params):
            raise TypeError("ZoomLBFGS takes float32 parameters")
        self.last_evals = 0

    def _flat(self, grads: bool = False) -> torch.Tensor:
        """The parameters (or their gradients, 0 where a parameter has none)
        as one flat f32 vector."""
        return torch.cat([(p if not grads else torch.zeros_like(p) if p.grad is None
                           else p.grad).reshape(-1) for p in self._params])

    def _set(self, flat: torch.Tensor) -> None:
        off = 0
        for p in self._params:
            n = p.numel()
            p.copy_(flat[off:off + n].view_as(p))
            off += n

    def _memory(self, x: torch.Tensor, g: torch.Tensor) -> dict:
        """The state, created at the first step, with the newest pair of
        differences written into it (zeros at the first step)."""
        st = self.state[self._params[0]]
        if not st:
            n = x.numel()
            st.update(count=0, x_prev=torch.zeros_like(x), g_prev=torch.zeros_like(g),
                      dw=x.new_zeros((MEMORY, n)), du=x.new_zeros((MEMORY, n)),
                      rho=x.new_zeros(MEMORY))
        if st["count"] > 0:
            i = (st["count"] - 1) % MEMORY
            dw, du = x - st["x_prev"], g - st["g_prev"]
            curv = torch.dot(du, dw)
            st["dw"][i] = dw
            st["du"][i] = du
            st["rho"][i] = torch.where(curv == 0, 0.0, 1.0 / curv)
        return st

    def _direction(self, st: dict, g: torch.Tensor) -> torch.Tensor:
        """-P g by the two-loop recursion over the memory, oldest pair to
        newest (empty slots have rho 0 and change nothing)."""
        k = st["count"]
        if k > 0:
            dw, du = st["dw"][(k - 1) % MEMORY], st["du"][(k - 1) % MEMORY]
            den = torch.dot(du, du)
            gamma = torch.where(den > 0, torch.dot(du, dw) / den, 1.0)
        else:
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
        order = [(k + j) % MEMORY for j in range(MEMORY)]
        v, alphas = g, {}
        for i in reversed(order):
            alphas[i] = st["rho"][i] * torch.dot(st["dw"][i], v)
            v = v - alphas[i] * st["du"][i]
        v = v * gamma
        for i in order:
            beta = st["rho"][i] * torch.dot(st["du"][i], v)
            v = v + (alphas[i] - beta) * st["dw"][i]
        return -v

    @torch.no_grad()
    def step(self, closure):
        """One L-BFGS step; `closure()` sets the parameters' gradients and
        returns the loss. Returns the loss at the parameters as they were."""
        with torch.enable_grad():
            loss = closure()
        x, g = self._flat(), self._flat(grads=True)
        st = self._memory(x, g)
        d = self._direction(st, g)

        def evaluate(t: float) -> tuple[float, float]:
            self._set(torch.add(x, d, alpha=t))
            with torch.enable_grad():
                value = closure().detach()
            return tuple(torch.stack([value.float(), torch.dot(self._flat(grads=True), d)])
                         .tolist())

        value0, slope0 = torch.stack([loss.detach().float(), torch.dot(g, d)]).tolist()
        t, trials = zoom_linesearch(evaluate, value0, slope0)
        self._set(torch.add(x, d, alpha=t))
        st["x_prev"], st["g_prev"] = x, g
        st["count"] += 1
        self.last_evals = 1 + trials
        return loss


class BatchZoomLBFGS(ZoomLBFGS):
    """ZoomLBFGS for B independent fits at once (parallel/batch.py): every
    parameter has the fits on its leading axis, and `closure()` returns the
    B losses (the gradients it sets are each fit's own: the fits share no
    parameter). Each fit has its own memory, directions and dot products,
    taken on the device over its own (B, P) row. Its B line searches
    (zoom_search) advance in lockstep: each round, one closure call
    evaluates every fit at its own trial x_i + t_i d_i, and one host read
    brings back the B values and slopes; a fit whose search has ended sits
    at its accepted step, and what later rounds compute for it is
    discarded. So no fit's steps depend on another's. `last_evals` holds
    each fit's value-and-gradient evaluations of the last step."""

    def __init__(self, params):
        super().__init__(params)
        self.fits = self._params[0].shape[0]
        if any(p.dim() == 0 or p.shape[0] != self.fits for p in self._params):
            raise ValueError("every parameter needs the fits on its leading axis")
        self.last_evals = [0] * self.fits

    def _flat(self, grads: bool = False) -> torch.Tensor:
        return torch.cat([(p if not grads else torch.zeros_like(p) if p.grad is None
                           else p.grad).reshape(self.fits, -1) for p in self._params], dim=1)

    def _set(self, flat: torch.Tensor) -> None:
        off = 0
        for p in self._params:
            n = p[0].numel()
            p.copy_(flat[:, off:off + n].view_as(p))
            off += n

    def _memory(self, x: torch.Tensor, g: torch.Tensor) -> dict:
        st = self.state[self._params[0]]
        if not st:
            st.update(count=0, x_prev=torch.zeros_like(x), g_prev=torch.zeros_like(g),
                      dw=x.new_zeros((MEMORY, *x.shape)), du=x.new_zeros((MEMORY, *x.shape)),
                      rho=x.new_zeros((MEMORY, self.fits)))
        if st["count"] > 0:
            i = (st["count"] - 1) % MEMORY
            dw, du = x - st["x_prev"], g - st["g_prev"]
            curv = (du * dw).sum(1)
            st["dw"][i] = dw
            st["du"][i] = du
            st["rho"][i] = torch.where(curv == 0, 0.0, 1.0 / curv)
        return st

    def _direction(self, st: dict, g: torch.Tensor) -> torch.Tensor:
        k = st["count"]
        if k > 0:
            dw, du = st["dw"][(k - 1) % MEMORY], st["du"][(k - 1) % MEMORY]
            den = (du * du).sum(1)
            gamma = torch.where(den > 0, (du * dw).sum(1) / den, 1.0)
        else:
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(g, dim=1), max=1.0)
        order = [(k + j) % MEMORY for j in range(MEMORY)]
        v, alphas = g, {}
        for i in reversed(order):
            alphas[i] = st["rho"][i] * (st["dw"][i] * v).sum(1)
            v = v - alphas[i][:, None] * st["du"][i]
        v = v * gamma[:, None]
        for i in order:
            beta = st["rho"][i] * (st["du"][i] * v).sum(1)
            v = v + (alphas[i] - beta)[:, None] * st["dw"][i]
        return -v

    @torch.no_grad()
    def step(self, closure):
        """One L-BFGS step of every fit; `closure()` sets the gradients and
        returns the (B,) losses. Returns the losses at the parameters as
        they were."""
        with torch.enable_grad():
            loss = closure()
        x, g = self._flat(), self._flat(grads=True)
        st = self._memory(x, g)
        d = self._direction(st, g)
        values, slopes = torch.stack([loss.detach().float(), (g * d).sum(1)]).tolist()
        searches = [zoom_search(v, s) for v, s in zip(values, slopes)]
        steps = [next(s) for s in searches]
        ended: list[tuple[float, int] | None] = [None] * self.fits
        while not all(ended):
            t = torch.tensor(steps, dtype=x.dtype, device=x.device)
            self._set(torch.addcmul(x, t[:, None], d))
            with torch.enable_grad():
                value = closure().detach()
            values, slopes = torch.stack([value.float(),
                                          (self._flat(grads=True) * d).sum(1)]).tolist()
            for i, search in enumerate(searches):
                if ended[i] is None:
                    try:
                        steps[i] = search.send((values[i], slopes[i]))
                    except StopIteration as stop:
                        ended[i] = stop.value
                        steps[i] = stop.value[0]
        t = torch.tensor(steps, dtype=x.dtype, device=x.device)
        self._set(torch.addcmul(x, t[:, None], d))
        st["x_prev"], st["g_prev"] = x, g
        st["count"] += 1
        self.last_evals = [1 + trials for _, trials in ended]
        return loss
