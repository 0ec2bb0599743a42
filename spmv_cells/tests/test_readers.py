"""The trace's summary and the metric readers on a small synthetic run:
known intervals in, known numbers out."""

import pytest

from spmv_cells.lib import result, spec, tracing

# a window of 100 us: two SELL kernels of 30 us, a copy of 14 us and a
# reduction of 1 us; the card idle 100 - 30 - 14 - 30 - 1 = 25 us, of it
# 15 us (two gaps) while the host synchronizes
DEVICE = [
    ("scs_spmv_kernel<double>", 10e-6, 40e-6),
    ("Memcpy DtoD (Device -> Device)", 40e-6, 54e-6),
    ("reduce_kernel", 90e-6, 91e-6),
    ("scs_spmv_kernel<double>", 54e-6, 84e-6),
    ("scs_spmv_kernel<double>", 150e-6, 160e-6),  # outside the window
    (tracing.WINDOW, 10e-6, 84e-6),  # the span's shadow on the card
]
HOST = [
    (tracing.WINDOW, 0.0, 100e-6),
    ("cudaLaunchKernelExC", 0.0, 12e-6),
    ("cudaDeviceSynchronize", 80e-6, 100e-6),
]


def summary():
    return tracing.summarize(DEVICE, HOST, (0.0, 100e-6))


def test_summary():
    s = summary()
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(75e-6)
    assert s.ops["scs_spmv_kernel<double>"][0] == 2
    assert s.device_s() == pytest.approx(75e-6)
    assert s.ops["Memcpy DtoD (Device -> Device)"] == [1, pytest.approx(14e-6)]
    assert s.gaps["cudaLaunchKernelExC"] == [1, pytest.approx(10e-6)]
    assert s.gaps["cudaDeviceSynchronize"] == [2, pytest.approx(15e-6)]
    assert tracing.Summary.from_json(s.to_json()) == s
    b = tracing.breakdown(s)
    assert b["device_ops"][0] == ["scs_spmv_kernel<double>",
                                  pytest.approx(60e-6)]
    assert b["idle_gaps"][0][0] == "cudaDeviceSynchronize"


def record(**run):
    return {"matrix": {"n_rows": 1000, "n_cols": 1000, "nnz": 27000},
            "device_name": "NVIDIA H100 80GB HBM3", "n_cards": 1,
            "build_s": 2.0, "setup_s": 10.0,
            "counters": {"nnz_per_precision": {"dp": 27000},
                         "device_beta": {"dp": 0.9}},
            "runs": [run]}


def ctx(rec):
    return result.Ctx(spec.cell("hpcg_256.spmv_dp"), rec)


def read(name, c):
    return spec.reader(name).read(c)


def test_end_to_end_readers():
    c = ctx(record(window={"calls": 1000, "seconds": 0.5}))
    assert read("spmv_gflops", c) == pytest.approx(2 * 27000 * 1000 / 0.5e9)
    assert read("setup_s", c) == 10.0
    assert read("build_s", c) == 2.0


def test_per_layer_readers():
    # 20 copies of 1 GB, read and written, in 20 ms of device time
    copies = tracing.summarize(
        [("Memcpy DtoD (Device -> Device)", i * 1e-3, (i + 1) * 1e-3)
         for i in range(20)], [(tracing.WINDOW, 0.0, 21e-3)], (0.0, 21e-3))
    c = ctx(record(traced={"calls": 2, "summary": summary().to_json()},
                   host_burst={"calls": 1024, "seconds": 0.02048},
                   copy={"bytes": 2 * 20 * 10**9,
                         "summary": copies.to_json()}))
    assert read("host_us_per_spmv", c) == pytest.approx(20.0)
    assert read("slots_per_nnz", c) == pytest.approx(1 / 0.9)
    assert read("device_idle_pct.spmv", c) == pytest.approx(25.0)
    bytes_ = 27000 * 12 + 1000 * 16
    assert read("spmv_roofline_pct", c) == pytest.approx(
        bytes_ / 3.35e12 / 37.5e-6 * 100)
    assert read("hbm_copy_gbs", c) == pytest.approx(2000.0)


def test_readers_return_nothing_without_their_data():
    """No trace, no device time or an unknown card: nothing, never 0."""
    c = ctx(record(window={"calls": 1, "seconds": 1.0}))
    for name in ("spmv_roofline_pct", "host_us_per_spmv", "hbm_copy_gbs",
                 "device_idle_pct.spmv"):
        assert read(name, c) is None
    idle = tracing.summarize([], HOST, (0.0, 100e-6))
    rec = record(traced={"calls": 2, "summary": idle.to_json()},
                 copy={"bytes": 10, "summary": idle.to_json()})
    assert read("spmv_roofline_pct", ctx(rec)) is None
    assert read("hbm_copy_gbs", ctx(rec)) is None
    rec = record(traced={"calls": 2, "summary": summary().to_json()})
    rec["device_name"] = "cpu"
    assert read("spmv_roofline_pct", ctx(rec)) is None
