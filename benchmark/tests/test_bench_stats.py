"""The end-to-end metrics' arithmetic: a rate is all the work over all the
window; a percentile is over every request, never medians of chunks."""

import pytest

import harness


def test_percentile_over_all_requests():
    # Ten chunks of ten: nine fast chunks and one slow one.  The median of
    # chunk p95s is fast; the p95 of all requests lands in the slow chunk.
    lat = [0.010] * 90 + [0.100] * 10
    spec = {"kind": "percentile", "q": 95}
    assert harness.end_to_end(spec, 0, 1.0, lat) == pytest.approx(100.0)
    chunks = [sorted(lat[i:i + 10])[9] for i in range(0, 100, 10)]
    assert sorted(chunks)[5] == 0.010
    assert harness.end_to_end({"kind": "percentile", "q": 50}, 0, 1.0,
                              lat) == pytest.approx(10.0)


def test_percentile_interpolates_linearly():
    assert harness.percentile([1, 2, 3, 4], 50) == pytest.approx(2.5)
    assert harness.percentile([0, 10], 95) == pytest.approx(9.5)


def test_rate_is_all_units_over_all_time():
    assert harness.end_to_end({"kind": "rate"}, 7680, 3.2, []) == pytest.approx(2400)


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        harness.end_to_end({"kind": "mean"}, 1, 1, [1])


def test_derived_seeds_are_stable_and_distinct():
    a = harness.derive_seed(2 ** 31 + 5, "pool")
    assert a == harness.derive_seed(2 ** 31 + 5, "pool")
    assert a != harness.derive_seed(2 ** 31 + 5, "keep")
    assert a != harness.derive_seed(2 ** 31 + 6, "pool")
    assert 0 <= harness.derive_seed(2 ** 40, "study", 3) < 2 ** 62


def test_union_and_overlap_of_intervals():
    assert harness.busy_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert harness.merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
    assert harness.overlap_us([[0, 3], [5, 6]], [[2, 5.5]]) == pytest.approx(1.5)


def test_breakdown_names_what_the_host_did_in_each_gap():
    kernels = [("k1", 0, 10), ("k2", 20, 30), ("k1", 30, 35), ("k3", 60, 61)]
    cpu = [(0, 100, "stage:x"), (12, 18, "aten::item"), (40, 55, "cudaLaunchKernel")]
    b = harness.breakdown(kernels, cpu)
    assert b["device_ops"][0] == ["k1", pytest.approx(15e-6)]
    assert dict((n, s) for n, s in b["idle_gaps"]) == {
        "aten::item": pytest.approx(10e-6), "cudaLaunchKernel": pytest.approx(25e-6)}
