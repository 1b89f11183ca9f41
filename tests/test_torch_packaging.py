"""PyTorch port: an installed package carries what its kernels' build
needs.  `ops/_build.load` hashes and compiles every file of `ops/csrc/`
that `hashed_files()` lists (the sources and the headers they include
with `-I csrc`); pyproject.toml's package-data must ship each one.
"""

import fnmatch
import tomllib
from pathlib import Path

import pytest

from dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops import (
    _build)

ROOT = Path(__file__).resolve().parents[1]
OPS = "dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.ops"


def _package_data():
    with open(ROOT / "pyproject.toml", "rb") as fh:
        config = tomllib.load(fh)
    return config["tool"]["setuptools"]["package-data"][OPS]


@pytest.mark.parametrize("path", _build.hashed_files(), ids=lambda p: p.name)
def test_package_data_ships_every_build_input(path):
    rel = path.relative_to(_build.CSRC.parent).as_posix()
    assert any(fnmatch.fnmatch(rel, glob) for glob in _package_data()), (
        f"{rel} is not covered by {_package_data()}")


def test_the_build_has_sources_and_headers():
    suffixes = {p.suffix for p in _build.hashed_files()}
    assert suffixes == {".cu", ".cuh"}
