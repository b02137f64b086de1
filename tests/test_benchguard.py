"""Bench drift guard (utils/benchguard.py): planted-slowdown dry runs.

VERDICT r4 ask #5: the guard must flag a planted slowdown against the
best-ever round (not just the previous one), track compile_s, label
cross-epoch comparisons, and check compile budgets — demonstrated here
without running any benches.
"""

import json

from chiaroscuro_tpu.utils import benchguard


def _extra(cornell_ms=100.0, nanosuit_ms=250.0, sponza_compile=20.0,
           nanosuit_fwdbwd_compile=10.0):
    return {
        "cornell_16spp": {"ms": cornell_ms, "compile_s": 5.0},
        "nanosuit_cluster": {
            "ms": nanosuit_ms, "compile_s": 8.0,
            "fwdbwd_compile_s": nanosuit_fwdbwd_compile,
        },
        "sponza_scale": {"ms": 2000.0, "fwdbwd_compile_s": sponza_compile},
    }


HISTORY = [
    (2, _extra(cornell_ms=90.0)),    # best cornell: r2 (async epoch)
    (3, _extra(cornell_ms=110.0)),
    (4, _extra(cornell_ms=105.0, nanosuit_ms=240.0)),  # best nanosuit: r4
]


def test_planted_slowdown_vs_best_is_flagged():
    """A 1.25x slowdown vs best-ever that is < 1.3x vs the previous round —
    exactly the r2->r4 cornell decay shape that shipped unflagged."""
    now = _extra(cornell_ms=112.0)   # 1.24x vs r2's 90, only 1.07x vs r4
    f = benchguard.flag_regressions(now, HISTORY, current_round=5)
    hits = [x for x in f["regressions_vs_best"]
            if x["config"] == "cornell_16spp" and x["metric"] == "ms"]
    assert len(hits) == 1
    assert hits[0]["best_round"] == 2 and abs(hits[0]["ratio"] - 112 / 90) < 1e-9
    # r2 was async-timed, r5 is hard-synced: labelled, not suppressed.
    assert hits[0]["best_epoch"] == "async" and hits[0]["cross_epoch"]
    assert not f["regressions_vs_prev"]          # < 1.3x vs r4
    assert any("CROSS-EPOCH" in line
               for line in benchguard.format_findings(f))


def test_within_threshold_not_flagged():
    now = _extra(cornell_ms=99.0)    # 1.10x vs best 90 < 1.15x
    f = benchguard.flag_regressions(now, HISTORY, current_round=5)
    assert not any(x["config"] == "cornell_16spp"
                   for x in f["regressions_vs_best"])


def test_same_epoch_best_not_cross_labelled():
    # r5 and r6 are both pipelined-epoch; a regression between them is
    # same-epoch.  r4 (hardsync) vs r5+ IS cross-epoch by design: r5
    # re-defined `ms` as steady-state pipelined throughput.
    history = HISTORY + [(5, _extra(nanosuit_ms=200.0))]
    now = _extra(nanosuit_ms=260.0)  # 1.3x vs r5's 200 (both pipelined)
    f = benchguard.flag_regressions(now, history, current_round=6)
    hits = [x for x in f["regressions_vs_best"]
            if x["config"] == "nanosuit_cluster" and x["metric"] == "ms"]
    assert len(hits) == 1 and not hits[0]["cross_epoch"]
    assert hits[0]["best_epoch"] == "pipelined"
    # hardsync-vs-pipelined is labelled cross-epoch.
    f4 = benchguard.flag_regressions(
        _extra(nanosuit_ms=300.0), HISTORY, current_round=5)
    hit4 = [x for x in f4["regressions_vs_best"]
            if x["config"] == "nanosuit_cluster" and x["metric"] == "ms"][0]
    assert hit4["cross_epoch"] and hit4["best_epoch"] == "hardsync"


def test_compile_budget_miss_flagged():
    now = _extra(sponza_compile=45.0, nanosuit_fwdbwd_compile=12.0)
    f = benchguard.flag_regressions(now, HISTORY, current_round=5)
    by_cfg = {b["config"]: b for b in f["compile_budget"]}
    assert not by_cfg["sponza_scale"]["ok"]       # 45 > 30s budget
    assert by_cfg["nanosuit_cluster"]["ok"]       # 12 <= 15s budget
    assert any("COMPILE BUDGET MISS" in line
               for line in benchguard.format_findings(f))


def test_compile_time_regression_tracked():
    """compile_s metrics ride the same vs-best check, so a compile-time
    cliff is caught."""
    now = _extra()
    now["nanosuit_cluster"]["compile_s"] = 80.0   # 10x the historical 8s
    f = benchguard.flag_regressions(now, HISTORY, current_round=5)
    assert any(x["config"] == "nanosuit_cluster" and x["metric"] == "compile_s"
               for x in f["regressions_vs_best"])


def test_load_history_roundtrip(tmp_path):
    for n, extra in HISTORY:
        (tmp_path / f"BENCH_r{n:02d}.json").write_text(
            json.dumps({"parsed": {"extra": extra}})
        )
    (tmp_path / "BENCH_rbad.json").write_text("not json")
    hist = benchguard.load_history(str(tmp_path))
    assert [n for n, _ in hist] == [2, 3, 4]
    assert hist[0][1]["cornell_16spp"]["ms"] == 90.0
