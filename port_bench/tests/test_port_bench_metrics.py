"""Each metric reader on a small recorded trace and on hand-made runs."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from port_bench import run, spec, trace
from port_bench.counts import peaks

FIXTURE = Path(__file__).parent / "fixtures" / "trace_small.json"


@pytest.fixture
def summary():
    with open(FIXTURE) as f:
        return trace.summarize(json.load(f)["traceEvents"])


def test_summary_of_the_fixture(summary):
    # device intervals [10, 22], [50, 55], [70, 80] µs in a window of [0, 80]
    assert summary["busy_s"] == pytest.approx(27e-6)
    assert summary["window_s"] == pytest.approx(80e-6)
    assert summary["device_events"] == 4
    # each gap goes to the innermost host operation over its midpoint
    assert summary["idle_gaps"] == [["aten::item", pytest.approx(28e-6)],
                                    ["no host operation", pytest.approx(15e-6)],
                                    ["cudaLaunchKernel", pytest.approx(10e-6)]]
    assert summary["device_ops"][0] == ["void windowed_partials<float, 0>(int const*)",
                                        pytest.approx(10e-6)]
    assert len(summary["kernels"]) == 3
    assert sum(len(v) for v in summary["kernel_spans"].values()) == 3


class FakeCell:
    host_build_s = 7.5
    coordinate_seconds = [{"fixed": 0.1, "user": 1.0}, {"fixed": 0.3, "user": 2.0},
                          {"fixed": 0.2, "user": 9.0}]

    def step_work(self):
        return 67e12 * 0.01, 0.0  # 10 ms at the float32 peak

    def kernel_bytes(self):
        return 3.35e12 * 6e-6  # a 6 µs floor


def ctx(summary=None, traced_steps=0):
    return run.Context(cell=FakeCell(), setup_s=12.0, window_s=10.0, steps=4,
                       peak_bytes=3 * 2**30, traced=summary, traced_steps=traced_steps)


def read(name, c):
    return run.read_metrics([{"name": name, "unit": "x"}], c).get(name, {}).get("value")


def test_end_to_end_readers():
    c = ctx()
    assert read("setup_s", c) == 12.0
    assert read("fit_s", c) == 2.5
    assert read("peak_device_gib", c) == 3.0


def test_per_layer_readers_on_the_fixture(summary):
    c = ctx(summary, traced_steps=2)
    assert read("device_idle_pct", c) == pytest.approx(100 * (1 - 27 / 80))
    assert read("launches_per_fit", c) == 1.5
    # 6 µs floor over (10 + 2) µs a launch
    assert read("windowed_rmatvec_roofline", c) == pytest.approx(50.0)
    # a fix-up that overlaps its partials kernel is not counted twice
    overlapped = dict(summary, kernel_spans={"windowed_partials<float>": [(0.0, 10.0)],
                                             "window_fixup<float>": [(4.0, 12.0)]})
    assert read("windowed_rmatvec_roofline", ctx(overlapped, 1)) == pytest.approx(50.0)
    assert read("fit_mfu_pct", c) == pytest.approx(100 * 0.01 / 2.5)
    assert read("coord_s.fixed", c) == pytest.approx(0.2)
    assert read("coord_s.user", c) == pytest.approx(2.0)
    assert read("host_build_s", c) == 7.5


def test_readers_find_nothing_to_read():
    c = ctx()
    for name in ("device_idle_pct", "launches_per_fit", "windowed_rmatvec_roofline",
                 "coord_s.item"):
        assert read(name, c) is None
    no_kernel = ctx({"busy_s": 1.0, "window_s": 2.0, "kernels": {"other": [1.0, 3]},
                     "kernel_spans": {"other": [(0.0, 1.0)]}, "device_ops": [],
                     "idle_gaps": []}, traced_steps=1)
    assert read("windowed_rmatvec_roofline", no_kernel) is None


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = spec.benchmark()
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert callable(run._reader(m["name"]).read), m["name"]


def test_peaks_are_the_data_sheets():
    assert peaks.HBM_BYTES_PER_S == 3.35e12 and peaks.FP32_FLOPS_PER_S == 67e12
