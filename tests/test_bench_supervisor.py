"""The bench: one process, one JSON line, no swallowed failures.

A complete capture prints one parsed JSON line naming its device and
exits 0; a stage that fails ends the run non-zero with no line; a blown
time budget skips only optional stages; ``--quick`` fails the process on
a regression verdict.  The subprocess tests run the real bench on the
CPU (``--cpu``, asked for explicitly) at tiny sizes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

TINY = {
    "BENCH_NQ": "256",
    "BENCH_NS": "256",
    "BENCH_CPU_NQ": "128",
    "BENCH_SW_B": "32",
    "BENCH_BIG_NS": "0",
    "BENCH_HUGE_NS": "0",
    "BENCH_ZIPF_NS": "0",
    "BENCH_ENGLISH_NS": "0",
    "BENCH_ENGLISH_HUGE_NS": "0",
    "BENCH_SKIP_E2E": "1",
}


def _run_bench(tmp_path, extra_env, argv=("--cpu",)):
    env = {**os.environ, **TINY, **extra_env}
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = str(REPO)
    code = (
        "import sys\nfrom fandom_search import bench\n"
        f"sys.exit(bench.main({list(argv)!r}))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=900, env=env,
        cwd=tmp_path,
    )
    line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else "{}"
    return r, json.loads(line)


def test_cpu_capture_completes_with_one_line(tmp_path):
    r, out = _run_bench(tmp_path, {})
    assert r.returncode == 0, r.stderr[-3000:]
    assert len(r.stdout.strip().splitlines()) == 1
    assert out["metric"] == "shingle_pairs_per_sec"
    assert out["value"] > 0
    assert out["backend"] == "cpu"
    assert out["device_kind"] == "cpu"
    details = json.loads((tmp_path / "bench_details.json").read_text())
    for stage in ("kernel_engine", "kernel_exact", "cpu_oracle", "sw",
                  "sharded", "bucketed_small"):
        assert stage in details["stages_done"], stage
    assert details["kernel_recall_at_10_vs_oracle"] == 1.0
    # nothing else is written beside the details file
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "bench_details.json"]


def test_no_gpu_without_cpu_flag_exits_nonzero(tmp_path):
    r, out = _run_bench(tmp_path, {}, argv=[])
    assert r.returncode not in (0, None)
    assert out == {}
    assert "no GPU" in r.stderr
    assert not (tmp_path / "bench_details.json").exists()


def test_stage_failure_propagates(tmp_path, monkeypatch):
    """A failing stage is not caught: the run raises, prints no line and
    writes no details file."""
    from fandom_search import bench

    for key, val in TINY.items():
        monkeypatch.setenv(key, val)
    monkeypatch.chdir(tmp_path)
    calls = []

    def failing_time(fn, **kw):
        calls.append(1)
        raise RuntimeError("device fault")

    monkeypatch.setattr(bench, "_time", failing_time)
    monkeypatch.setattr(
        "fandom_search.utils.jit_cache.enable_persistent_cache", lambda: None)
    with pytest.raises(RuntimeError, match="device fault"):
        bench.main(["--cpu"])
    assert calls == [1]
    assert not (tmp_path / "bench_details.json").exists()


def test_quick_regression_failure_propagates(tmp_path):
    """--quick FAILS the process when the measured rate is below the
    recorded floor, or the floor was recorded on another device.  The
    record is a GPU capture, so a CPU run can never pass it."""
    expected = REPO / "fandom_search" / "bench_expected.json"
    rec = json.loads(expected.read_text())
    assert rec["kernel_engine_pairs_per_sec"] > 0
    assert rec["device_kind"] != "cpu"
    r, out = _run_bench(tmp_path, {}, argv=["--cpu", "--quick"])
    assert r.returncode == 1, (r.returncode, r.stderr[-2000:])
    assert out["value"] > 0  # the line still emits, parsed, exit code 1
    assert "FAIL" in r.stderr


def test_time_budget_skips_optional_stages(tmp_path):
    """A blown time budget skips OPTIONAL stages (recorded in
    stages_skipped_for_time); the required stages still run and the
    capture completes."""
    r, out = _run_bench(tmp_path, {
        "BENCH_BIG_NS": "2048",          # give the budget a victim
        "BENCH_TIME_BUDGET_S": "1",      # any elapsed blows it
    })
    assert r.returncode == 0, r.stderr[-3000:]
    assert out["value"] > 0
    details = json.loads((tmp_path / "bench_details.json").read_text())
    assert "bucketed_big" in details["stages_skipped_for_time"]
    assert "bucketed_big" not in details["stages_done"]
    assert "bucketed_small" in details["stages_done"]
    # per-stage seconds recorded for every stage that DID run
    assert details["stage_seconds"]["kernel_engine"] >= 0
    assert set(details["stage_seconds"]) == set(details["stages_done"])


def test_skew_recall_accounting_is_identity_not_score_multiset():
    """Regression: a guaranteed entry whose score ties a <=1-match noise
    entry in the exact top-k must NOT be charged as a miss when the
    hybrid returned it (a score-multiset accounting would)."""
    import numpy as np

    from fandom_search.bench import skew_recall_accounting

    dim, thr, n = 128, 3.5, 6
    # one query; exact top-k: guaranteed si=5 at 448/128, noise twin
    # si=9 at the SAME 448/128 score, plus si=7 at 472/128
    evn = np.array([[472 / dim, 448 / dim, 448 / dim]], np.float32)
    ein = np.array([[7, 9, 5]], np.int32)  # noise twin ranked first
    # hybrid returned the guaranteed si=5 (and si=7), NOT the noise 9
    got = {0: {(5, 448), (7, 472)}}
    q_wh = np.zeros((1, n), np.uint32)
    sw_h = np.zeros((10, n), np.uint32)
    q_wh[0] = [1, 2, 3, 4, 5, 6]
    sw_h[5] = [1, 2, 99, 98, 97, 96]   # shares 2 positions: guaranteed
    sw_h[7] = [1, 2, 3, 90, 91, 92]    # shares 3: guaranteed
    sw_h[9] = [1, 80, 81, 82, 83, 84]  # shares 1: embedding noise
    tot, hit, g_tot, g_hit = skew_recall_accounting(
        evn, ein, got, q_wh, sw_h, stride=1, thr=thr, dim=dim,
        guarantee_min=2,
    )
    assert (tot, g_tot) == (3, 2)
    assert g_hit == 2, "guaranteed entry aliased away by a score tie"
    assert hit == 2  # the absent noise twin is the only miss
