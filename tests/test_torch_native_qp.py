"""PyTorch port: `ops/native_qp.py`, the binding to the C++ host solver.

Against the JAX package's binding to the same source with the same flags
(tests/test_native_qp.py's random QPs: the answers agree to 1e-12) and
against scipy (5e-6, as the JAX test); tensors in, a tensor off the host
refused; two processes building into one empty directory both end with
a whole library; `native/` is never written to.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu.ops import (
    native_qp as j_native)
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    native_qp)

REPO = Path(__file__).resolve().parents[1]


def _random_qp(seed, n, m):
    """tests/test_native_qp.py::_random_qp's draw."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    return (L @ L.T + np.eye(n), rng.normal(size=n),
            rng.normal(size=(m, n)), rng.uniform(0.1, 2.0, size=m))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's library, built into a directory of this test run."""
    root = tmp_path_factory.mktemp("torch_native")
    native_qp.build_library(build_root=root)
    return root


@pytest.mark.parametrize("seed,n,m", [(0, 12, 24), (3, 12, 24), (10, 20, 40)])
def test_matches_the_jax_binding(built, seed, n, m):
    P, q, G, h = _random_qp(seed, n, m)
    ours = native_qp.solve_qp_native(P, q, G, h, build_root=built)
    theirs = j_native.solve_qp_native(P, q, G, h)
    assert ours.converged and theirs.converged
    assert ours.iterations == theirs.iterations
    np.testing.assert_allclose(ours.z, theirs.z, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.lam, theirs.lam, rtol=0, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_matches_scipy(built, seed):
    from scipy.optimize import LinearConstraint, minimize

    P, q, G, h = _random_qp(seed, 12, 24)
    sol = native_qp.solve_qp_native(P, q, G, h, build_root=built)
    assert sol.converged
    res = minimize(lambda z: 0.5 * z @ P @ z + q @ z, np.zeros(12),
                   jac=lambda z: P @ z + q,
                   constraints=[LinearConstraint(G, -np.inf, h)],
                   method="trust-constr",
                   options={"gtol": 1e-12, "xtol": 1e-14})
    np.testing.assert_allclose(sol.z, res.x, atol=5e-6)


def test_takes_cpu_tensors_and_refuses_others(built):
    P, q, G, h = _random_qp(2, 8, 16)
    ref = native_qp.solve_qp_native(P, q, G, h, build_root=built)
    sol = native_qp.solve_qp_native(
        *(torch.as_tensor(a, dtype=torch.float32) for a in (P, q, G, h)),
        build_root=built)
    assert sol.converged
    np.testing.assert_allclose(sol.z, ref.z, atol=1e-5)
    with pytest.raises(ValueError, match="runs on the host"):
        native_qp.solve_qp_native(torch.empty(8, 8, device="meta"), q, G, h,
                                  build_root=built)
    with pytest.raises(ValueError, match="expected P"):
        native_qp.solve_qp_native(P[:4], q, G, h, build_root=built)


def test_the_default_build_is_outside_native():
    path = native_qp.library_path()
    assert native_qp.BUILD_ROOT in path.parents
    assert REPO / "native" not in path.parents


_BUILD_AND_SOLVE = """
import sys
import numpy as np
from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import native_qp
root = sys.argv[1]
native_qp.build_library(force=True, build_root=root)
P = 2 * np.eye(4)
sol = native_qp.solve_qp_native(P, -4 * np.ones(4), np.eye(4), np.ones(4),
                                build_root=root)
assert sol.converged and np.allclose(sol.z, 1.0, atol=1e-8), sol
print("BUILT_OK")
"""


def _snapshot(directory: Path) -> dict:
    return {p: p.stat().st_mtime_ns for p in directory.rglob("*")}


def test_two_processes_build_into_one_empty_directory(tmp_path):
    before = _snapshot(REPO / "native")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_SOLVE,
                               str(tmp_path)], env=env, cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for proc, (out, err) in zip(procs, outs):
        assert proc.returncode == 0 and "BUILT_OK" in out, err[-2000:]
    files = sorted(p.relative_to(tmp_path).as_posix()
                   for p in tmp_path.rglob("*") if p.is_file())
    assert files == [native_qp.library_path(tmp_path)
                     .relative_to(tmp_path).as_posix()]
    assert _snapshot(REPO / "native") == before
