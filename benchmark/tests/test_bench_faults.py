"""`correct` at small sizes on the CPU: a sound run of each cell is
correct; its control (the reference computed in TF32 in the program's
place) is not; and a run with the timed path broken underneath is not,
for each fault the cell can have: a step that returns its state
unchanged, half of the batch left out with the rest's mean in its place,
and an answer altered where it is produced. (No cell runs on more than one
chip, so none has an exchange between chips to leave out.) A solver that
never converges is no wrong answer but a declared failure: every plan
falls back, the run counts all of them as failed, and the fallbacks are
judged as what they say."""

import functools

import pytest
import torch

import harness
from conftest import SEED, SMALL, run_small

PT = pytest.importorskip(harness.PORT)
CELLS = sorted(SMALL)
PIPELINE = [c for c in CELLS if not c.endswith("halfspaces1024")]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_small(cell)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = run_small(cell, control=True)
    limits = harness.find_cell(harness.HERE.parent, cell).limits
    assert res["correct"]
    failed = [k for k, v in res["control"].items() if not v <= limits[k]]
    assert failed, res["control"]


def frozen_rollout(x0, u, A, B, C):
    """A rollout whose step returns its state unchanged."""
    xs = x0[..., None, :].expand(*x0.shape[:-1], u.shape[-2] + 1, x0.shape[-1])
    return xs, xs @ C.T


def ipm_without_steps(fn):
    @functools.wraps(fn)
    def solve(*args, **kwargs):
        return fn(*args, **{**kwargs, "max_iters": 0})
    return solve


def half_the_lanes(fn):
    """The QPs of the second half of the batch left out, the first half's
    mean in their place."""
    @functools.wraps(fn)
    def core(*args, **kwargs):
        u, slack, sol, obj = fn(*args, **kwargs)
        n = max(1, u.shape[0] // 2)
        u = u.clone()
        u[n:] = u[:n].mean(0)
        return u, slack, sol, obj
    return core


def half_the_rows(fn):
    @functools.wraps(fn)
    def hs(samples, ego, *args):
        n = max(1, samples.shape[0] // 2)
        out = fn(samples[:n], ego[:n], *args)
        return type(out)(*(torch.cat([t, t.mean(0, keepdim=True).expand(
            samples.shape[0] - n, *t.shape[1:])]) for t in out))
    return hs


def altered_row(fn):
    @functools.wraps(fn)
    def hs(*args):
        out = fn(*args)
        g = out.g_drcvar.clone()
        g[0] += 0.1
        return out._replace(g_drcvar=g)
    return hs


def altered_run(fn):
    @functools.wraps(fn)
    def reduce(result):
        md, conv = fn(result)
        md = md.clone()
        md[0, 1] += 0.5
        return md, conv
    return reduce


M = PT.models
ENV = PT.simulation.environment
FAULTS = {
    "rollout_state_unchanged": (M.pipeline, "simulate_linear_system",
                                lambda fn: frozen_rollout, PIPELINE),
    "half_the_qps": (M.pipeline, "_filter_core", half_the_lanes, PIPELINE),
    "half_the_rows": (ENV, "all_metrics_halfspaces", half_the_rows,
                      ["multi_obstacle_n1000.halfspaces1024",
                       "multi_obstacle_n1000.batch256",
                       "multi_obstacle_n1000.loop"]),
    "altered_halfspace": (ENV, "all_metrics_halfspaces", altered_row,
                          ["multi_obstacle_n1000.halfspaces1024",
                           "multi_obstacle_n1000.batch256",
                           "multi_obstacle_n1000.loop"]),
    "altered_min_distance": (PT.evaluation.monte_carlo, "reduce_runs",
                             altered_run, ["head_on_n20.mc300"]),
}
CASES = [(f, c) for f, (_, _, _, cells) in FAULTS.items() for c in cells]


@pytest.mark.parametrize("fault,cell", CASES, ids=[f"{f}-{c}" for f, c in CASES])
def test_fault_is_not_correct(fault, cell, monkeypatch):
    module, name, breaker, _ = FAULTS[fault]
    monkeypatch.setattr(module, name, breaker(getattr(module, name)))
    res = run_small(cell, seed=SEED + 1)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell", PIPELINE)
def test_a_solver_that_never_converges_fails_every_plan(cell, monkeypatch):
    monkeypatch.setattr(M.mpc_filter, "solve_mpc_qp",
                        ipm_without_steps(M.mpc_filter.solve_mpc_qp))
    res = run_small(cell, seed=SEED + 2)
    assert res["failed"] == res["attempted"] > 0
    assert res["correct"], res["check"]


def test_a_fallback_that_is_not_the_straight_line_is_not_correct(monkeypatch):
    """Plans reported as fallen back are held to the fallback's controls."""
    orig = M.pipeline._filter_core

    def core(*args, **kwargs):
        u, slack, sol, obj = orig(*args, **kwargs)
        return u, slack, sol._replace(converged=torch.zeros_like(sol.converged)), obj
    monkeypatch.setattr(M.pipeline, "_filter_core", core)
    monkeypatch.setattr(M.pipeline, "torch", _NoWhere(torch))
    res = run_small("multi_obstacle_n1000.batch256", seed=SEED + 3)
    assert res["failed"] == res["attempted"]
    assert not res["correct"], res["check"]


class _NoWhere:
    """torch with a `where` that keeps the QP's controls where the
    pipeline would put the fallback's: a fallback reported but not taken."""

    def __init__(self, torch):
        self._torch = torch

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def where(self, cond, a, b):
        if a.dim() == 4 and b.dim() == 4 and cond.dim() == 4:
            return b
        return self._torch.where(cond, a, b)
