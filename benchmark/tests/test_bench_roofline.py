"""The rooflines' byte and operation counts from shapes, the peaks, and the
per-layer readers on traces made by hand (a reader that finds nothing to
read returns None)."""

import pytest

import harness
import roofline
from conftest import BENCH


def test_least_seconds_takes_the_larger_bound():
    assert roofline.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(67e9, 3.35e12) == pytest.approx(1.0)


def test_factor_and_solve_counts():
    assert roofline.factor_work(60) == (60 ** 3 / 3, 2 * 3600 * 4)
    assert roofline.solve_work(60, 1) == (2 * 3600, (3600 + 120) * 4)
    assert roofline.solve_work(64, 65) == (2 * 64 * 64 * 65, (64 * 64 + 2 * 64 * 65) * 4)


def test_qp_work_counts_passes_and_polish():
    n, rows, passes = 60, 330, 15
    f, b = roofline.qp_work(1, n, rows, passes)
    k = 64
    want_f = (passes * (n ** 3 / 3 + 2 * 2 * n * n) + n ** 3 / 3
              + 2 * n * n * (k + 1) + k ** 3 / 3 + 2 * k * k
              + 2 * (2 * n * n + 2 * k * k))
    want_b = 4 * (passes * (2 * n * n + 2 * (n * n + 2 * n)) + 2 * n * n
                  + n * n + 2 * n * (k + 1) + 2 * k * k + k * k + 2 * k
                  + 2 * (n * n + 2 * n + k * k + 2 * k))
    assert f == pytest.approx(want_f)
    assert b == pytest.approx(want_b)
    f768, b768 = roofline.qp_work(768, n, rows, passes)
    assert (f768, b768) == (pytest.approx(768 * f), pytest.approx(768 * b))
    # A QP with few rows selects at most that many in the polish.
    assert roofline.qp_work(1, 4, 5, 1) == roofline.qp_work(1, 4, 5, 1)


def test_halfspace_work_counts_each_byte_once():
    rows, N, ego = 92160, 1000, 1024 * 31 * 4
    f, b = roofline.halfspace_work(rows, N, ego)
    assert b == (rows * N * 2 + ego + rows * 7) * 4
    assert f == rows * N * 8
    # 737 MB of samples: 0.22 ms at 3.35 TB/s, bound by bytes.
    assert roofline.least_seconds(f, b) == pytest.approx(b / 3.35e12)
    assert 0.22e-3 < roofline.least_seconds(f, b) < 0.225e-3


def trace(**kw):
    base = dict(config={"qp_iters": 60}, traffic={}, calls=0, spans={},
                values={}, profiled_values={}, stage_device_s={},
                stage_calls={}, busy_s=0.0, window_s=0.0, profile_calls=0)
    base.update(kw)
    return harness.TraceData(**base)


def reader(name):
    return harness.metric_reader(BENCH, name)


def test_readers_return_none_with_nothing_to_read():
    empty = trace()
    for name in ("mc_draw_ms", "filter_core_ms.rate", "ipm_passes.loop",
                 "qp_roofline", "halfspace_ms", "halfspace_roofline",
                 "device_idle_pct.hs"):
        assert reader(name).read(empty) is None, name


def test_readers_on_a_made_trace():
    ip = reader("ipm_passes.rate")
    qp = reader("qp_roofline")
    hs = reader("halfspace_roofline")
    t = trace(calls=4, spans={"_filter_core": [0.1, 0.3],
                              "run_obstacles": [0.01, 0.03]},
              values={ip.__name__: [14.0, 59.0, 60.0]},
              profiled_values={qp.__name__: [(768, 60, 330, 14.0)],
                               hs.__name__: [(92160, 1000, 1024 * 124)]},
              stage_device_s={"_filter_core": 0.016,
                              "compute_safe_halfspaces_for_trajectory": 2e-3},
              stage_calls={"compute_safe_halfspaces_for_trajectory": 2},
              busy_s=0.25, window_s=1.0)
    assert reader("filter_core_ms.rate").read(t) == pytest.approx(200.0)
    assert reader("mc_draw_ms").read(t) == pytest.approx(10.0)
    assert ip.read(t) == pytest.approx((15 + 60 + 60) / 3)
    least = roofline.least_seconds(*roofline.qp_work(768, 60, 330, 15))
    assert qp.read(t) == pytest.approx(100 * least / 0.016)
    assert reader("halfspace_ms").read(t) == pytest.approx(1.0)
    hs_least = roofline.least_seconds(*roofline.halfspace_work(92160, 1000, 1024 * 124))
    assert hs.read(t) == pytest.approx(100 * hs_least / 2e-3)
    assert reader("device_idle_pct.rate").read(t) == pytest.approx(75.0)


def test_card_line_names_the_peaks():
    line = roofline.card_line()
    assert "3.35 TB/s" in line and "67 TFLOP/s" in line
