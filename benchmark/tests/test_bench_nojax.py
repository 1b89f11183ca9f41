"""No module of the benchmark imports jax, jaxlib, flax or the JAX
package; names are compared whole, by their top-level part (the port's
name begins with the JAX package's)."""

import ast
import sys
from pathlib import Path

import pytest

from conftest import BENCH, SEED, run_small

FORBIDDEN = {"jax", "jaxlib", "flax",
             "dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu"}


def imported_top_levels(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_module_imports_no_jax(path):
    assert not imported_top_levels(path) & FORBIDDEN


def test_scan_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import dr_cvar_mpc_safety_filter_motion_planning_"
                   "collison_avoidance_tpu_torch.models\nimport jaxtyping\n")
    assert not imported_top_levels(src) & FORBIDDEN
    src.write_text("from dr_cvar_mpc_safety_filter_motion_planning_"
                   "collison_avoidance_tpu.ops import x\n")
    assert imported_top_levels(src) & FORBIDDEN


def test_run_refuses_a_process_holding_jax(monkeypatch):
    import harness
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    assert harness.forbidden_modules() == ["jax"]
    with pytest.raises(RuntimeError, match="jax"):
        run_small("multi_obstacle_n1000.halfspaces1024", SEED)


def test_port_name_is_not_flagged(monkeypatch):
    import harness
    name = "dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch"
    monkeypatch.setitem(sys.modules, name + ".fake", type(sys)("x"))
    assert name.split(".")[0] not in harness.forbidden_modules()
