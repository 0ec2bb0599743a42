"""The port's headline program, ``bench_torch.py`` (the counterpart of
``bench.py``), and ``uspmv_tpu_torch/runtime/card.py`` on the CPU.

  * the HBM table by card name, and bench.py's ``vs_baseline`` arithmetic
    on the headline's nnz and rows;
  * the progress watchdog (bench.py's three cases, exit 1 when it fires);
  * the program without a CUDA device: the "cuda-unavailable" record, rc 3,
    the durable record file;
  * ``run`` on every case of ``CASES`` at a tiny size with
    ``backend="cpu"``: exactly bench.py's keys plus ``card``,
    ``roofline_gbps`` and ``timing``, every number finite; the exit codes of
    a failed headline, a failed extra and a spent budget;
  * one ``op.spmv`` per tiny case against the JAX ``SpmvOperator`` for the
    same Config (Pallas in interpret mode for the f32 sums, its XLA route
    for ap[dp_sp], as tests/test_torch_operator.py and test_torch_ap.py
    run it), to the reference's unit tolerance of the sums' precision
    (runtime/validate.py: 1e-5 sp, 1e-13 dp).
"""

import dataclasses
import functools
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from uspmv_tpu.config import Config as JConfig
from uspmv_tpu.io import generators as jgen
from uspmv_tpu.runtime.operator import SpmvOperator as JOperator
from uspmv_tpu.runtime.validate import UNIT_TOL

from uspmv_tpu_torch.config import Config
from uspmv_tpu_torch.io import generators as tgen
from uspmv_tpu_torch.runtime import card
from uspmv_tpu_torch.runtime.operator import SpmvOperator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "bench_torch", os.path.join(REPO, "bench_torch.py"))
bench_torch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench_torch)  # top level: definitions only

# bench.py's record (bench.py:162-169, 230-321) and the port's card facts
BENCH_PY_KEYS = {
    "metric", "value", "unit", "vs_baseline", "effective_gbps",
    "n_iterations", "platform", "fem_tet3d_55_gflops",
    "banded_imbalanced_500k_gflops", "powerlaw_cols_500k_gflops",
    "random_imbalanced_500k_gflops", "solve_bcsstk13_gflops",
    "solve_bcsstk13_impl", "ap_sp_hp_gflops", "ap_dp_sp_96_gflops",
}
CARD_KEYS = {"card", "roofline_gbps", "timing"}
# (generator, args, kwargs) of each case at a tiny size; None: the
# headline's matrix, as in CASES
TINY = {
    "headline": ("laplace3d", (8,), {}),
    "fem_tet3d_55": ("fem_tet3d", (5,), {}),
    "banded_imbalanced_500k": ("banded_imbalanced", (2000,),
                               dict(bandwidth=64, avg_nnz_per_row=8,
                                    seed=7)),
    "powerlaw_cols_500k": ("powerlaw_cols", (2000, 8), {}),
    "random_imbalanced_500k": ("random_imbalanced", (2000, 8), {}),
    "solve_bcsstk13": ("fem_tet3d", (5,), {}),
    "ap_sp_hp": None,
    "ap_dp_sp_96": ("laplace3d", (6,), {}),
}


def tiny_matrix(key, gen=tgen):
    name, args, kwargs = TINY[key] or TINY["headline"]
    return getattr(gen, name)(*args, **kwargs)


def tiny_cases():
    """CASES at a tiny size: small matrices, a 1 ms bench, solve k=4."""
    return [dataclasses.replace(
        c, matrix=None if TINY[c.key] is None
        else functools.partial(tiny_matrix, c.key),
        bench_time=0.001, solve_k=4 if c.solve_k else 0)
        for c in bench_torch.CASES]


# ------------------------------------------------------------------ card


@pytest.mark.parametrize("name,rate", [
    ("NVIDIA H100 NVL", 3.9e12),
    ("NVIDIA H100 PCIe", 2.0e12),
    ("NVIDIA H100 80GB HBM3", 3.35e12),
    ("cpu", 50.0e9),
    ("NVIDIA A100-SXM4-80GB", None),
    ("", None),
])
def test_hbm_bytes_per_s_by_card_name(name, rate):
    assert card.hbm_bytes_per_s(name) == rate


def test_vs_baseline_of_the_headline():
    """bench.py's ideal CSR at 80% of 3,350 GB/s on Laplace3D-128:
    (8 * 14,581,760 + 8 * 2,097,152) B in 49.79 us, 585.76 GFLOP/s."""
    # the generator's 7-point stencil: 7 n^3 - 6 n^2 nonzeros
    m = tgen.laplace3d(8)
    assert (m.n_rows, m.nnz) == (8**3, 7 * 8**3 - 6 * 8**2)
    n_rows, nnz = 128**3, 7 * 128**3 - 6 * 128**2
    assert (n_rows, nnz) == (2_097_152, 14_581_760)
    base = bench_torch.baseline_gflops(nnz, n_rows, card.hbm_bytes_per_s(
        "NVIDIA H100 80GB HBM3"))
    assert abs(base - 585.76) <= 0.01
    # vs_baseline = 1 at the baseline's own rate
    t = (8.0 * nnz + 8.0 * n_rows) / (0.8 * 3.35e12)
    assert math.isclose(2.0 * nnz / t / 1e9 / base, 1.0, rel_tol=1e-12)


# -------------------------------------------------------------- watchdog


def test_watchdog_emits_partial_and_exits_nonzero():
    """A run that hangs after the device is up (a graph replay that never
    ends) still prints what was measured, and exits 1."""
    records, exits = [], []
    partial = {"metric": "m", "value": 612.5, "unit": "GFLOP/s",
               "vs_baseline": 1.05}
    bench_torch.Watchdog(0.2, partial, records.append, _exit=exits.append)
    partial["fem_tet3d_55_gflops"] = 210.0  # landed after arming
    time.sleep(1.0)
    assert exits == [1]
    (rec,) = records
    assert rec["value"] == 612.5
    assert rec["fem_tet3d_55_gflops"] == 210.0
    assert rec["error"].startswith("cuda-hung-mid-run")


def test_watchdog_progress_rearms_phase_timer():
    """A healthy but slow run keeps making progress and never fires, even
    when its whole run exceeds the phase deadline."""
    records, exits = [], []
    wd = bench_torch.Watchdog(0.4, {"metric": "m"}, records.append,
                              _exit=exits.append)
    for _ in range(4):  # 0.8 s in all > the deadline; 0.2 s each < it
        time.sleep(0.2)
        wd.progress()
    wd.cancel()
    time.sleep(0.6)
    assert records == [] and exits == []


def test_watchdog_cancel_on_normal_completion():
    records, exits = [], []
    wd = bench_torch.Watchdog(0.2, {"metric": "m"}, records.append,
                              _exit=exits.append)
    wd.cancel()
    time.sleep(0.5)
    assert records == [] and exits == []


# ------------------------------------------------------ the program's exits


def test_no_cuda_device_prints_record_and_exits_3(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               USPMV_OUTPUT_DIR=str(tmp_path))
    p = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")],
                       cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=240)
    assert p.returncode == 3, p.stderr[-2000:]
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    assert rec["error"] == "cuda-unavailable"
    assert rec["value"] is None and "vs_baseline" in rec
    assert rec["metric"].startswith("scs_spmv_gflops (C=1024, sp, Laplace3D")
    assert "-backend cpu" in rec["detail"]
    (line,) = (tmp_path / bench_torch.RECORD_FILE).read_text().splitlines()
    saved = json.loads(line)
    assert saved["_source"] == "bench_torch.py"
    assert {k: saved[k] for k in rec} == rec


@pytest.fixture(scope="module")
def tiny_record():
    records = []
    rc = bench_torch.run(tiny_cases(), backend="cpu", emit=records.append)
    return rc, records


def test_run_every_case_on_cpu(tiny_record):
    rc, records = tiny_record
    assert rc == 0
    (rec,) = records
    assert set(rec) == BENCH_PY_KEYS | CARD_KEYS
    assert rec["metric"] == ("scs_spmv_gflops (C=1024, sp, Laplace3D-128^3, "
                             "cpu)")
    assert rec["platform"] == "cpu" and rec["timing"] == "loop"
    assert rec["card"] == "cpu" and rec["roofline_gbps"] == 50.0
    assert rec["unit"] == "GFLOP/s"
    assert rec["solve_bcsstk13_impl"].startswith("solve-loop[torch-plain-")
    for k, v in rec.items():
        if k not in ("metric", "unit", "platform", "timing", "card",
                     "solve_bcsstk13_impl"):
            assert isinstance(v, (int, float)) and math.isfinite(v), (k, v)
            assert v > 0, (k, v)
    # vs_baseline at the CPU row's rate, on the headline's nnz and rows
    m = tiny_matrix("headline")
    assert math.isclose(rec["vs_baseline"], rec["value"] / bench_torch
                        .baseline_gflops(m.nnz, m.n_rows, 50.0e9),
                        rel_tol=1e-12)


def _broken(*_):
    raise RuntimeError("broken matrix")


def test_failed_headline_exits_1():
    cases = tiny_cases()
    cases[0] = dataclasses.replace(cases[0], matrix=_broken)
    records = []
    assert bench_torch.run(cases, backend="cpu", emit=records.append) == 1
    (rec,) = records
    assert rec["error"] == "headline-bench-failed"
    assert rec["value"] is None and "broken matrix" in rec["detail"]


def test_failed_extra_keeps_headline_and_exits_1():
    cases = tiny_cases()
    cases[2] = dataclasses.replace(cases[2], matrix=_broken)
    records = []
    assert bench_torch.run(cases, backend="cpu", emit=records.append) == 1
    (rec,) = records
    assert rec["value"] > 0 and "error" not in rec
    assert rec["banded_imbalanced_500k_gflops"] == "error: broken matrix"
    assert rec["powerlaw_cols_500k_gflops"] > 0  # the run went on


def test_spent_budget_skips_extras_and_exits_0(monkeypatch):
    monkeypatch.setenv("USPMV_BENCH_BUDGET_S", "-1")
    records = []
    assert bench_torch.run(tiny_cases(), backend="cpu",
                           emit=records.append) == 0
    (rec,) = records
    assert rec["value"] > 0
    for c in bench_torch.CASES[1:]:
        assert rec[c.key + "_gflops"] == "skipped (bench budget)"


# --------------------------------------------- each case against the JAX one


@pytest.mark.parametrize("case", bench_torch.CASES, ids=lambda c: c.key)
def test_case_spmv_matches_jax_operator(case):
    fields = {**bench_torch.SCS, "value_type": "sp", **case.fields,
              "backend": "cpu"}
    op = SpmvOperator.from_mtx(Config(**fields), tiny_matrix(case.key))
    # -dp_emu: the port's native f64 against the JAX XLA route's f64 sums
    # (its df64 interpret path degrades to ~1e-5, tests/test_pallas.py)
    jfields = {**fields, "dp_emulation": False}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jop = JOperator.from_mtx(JConfig(**jfields),
                                 tiny_matrix(case.key, jgen))
    x = np.random.default_rng(7).standard_normal(op.n_rows)
    y = op.to_host(op.spmv(op.make_x(x)))
    want = np.asarray(jop.to_host(jop.spmv(jop.make_x(x))))
    assert y.dtype == want.dtype and y.shape == (op.n_rows,)
    tol = UNIT_TOL["dp" if y.dtype == np.float64 else "sp"]
    assert np.abs(y - want).max() / np.abs(want).max() <= tol
