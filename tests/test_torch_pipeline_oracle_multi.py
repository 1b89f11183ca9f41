"""PyTorch port, end-to-end control deviation against the scipy oracle
on multi_obstacle (three obstacles); see test_torch_pipeline_oracle.py."""

import pytest
import torch

from test_torch_pipeline_oracle import (DTYPES, METRICS, check_deviation,
                                        oracle_runs)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def multi_obstacle():
    return oracle_runs("multi_obstacle")


@DTYPES
@pytest.mark.parametrize("metric", METRICS)
def test_control_deviation_vs_oracle_multi_obstacle(multi_obstacle, dtype,
                                                    metric):
    check_deviation(*multi_obstacle, dtype, metric)
