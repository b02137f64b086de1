"""Bench-history drift guard.

A guard that compares only against the immediately previous round lets a
metric decay in steps that each stay under its threshold, and a guard on
run times alone misses compile times.  This module compares every watched
(config, metric)
against the **best ever recorded** across all ``BENCH_r*.json`` at a 1.15x
threshold, tracks ``compile_s`` metrics, labels cross-epoch comparisons
(the timing method changed at rounds 4 and 5), and checks compile-time
budgets.

Pure functions over plain dicts (no jax import — bench.py's orchestrator
must stay jax-free) so the planted-slowdown dry run is unit-testable
(tests/test_benchguard.py).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Tuple

# Timing-methodology epoch per bench round: rounds 1-3 ended timed regions
# with jax.block_until_ready only; round 4 adds a host fetch (bench.py
# _sync); round 5+ reports steady-state pipelined throughput as ``ms``
# (single-call latency stays in ``ms_single``).  Numbers across epoch
# boundaries are not directly comparable — cross-epoch findings are
# labelled, not suppressed.
HARDSYNC_FROM_ROUND = 4
PIPELINED_FROM_ROUND = 5


def epoch_of(round_n: int) -> str:
    if round_n >= PIPELINED_FROM_ROUND:
        return "pipelined"
    return "hardsync" if round_n >= HARDSYNC_FROM_ROUND else "async"


# (config key, metric key); all lower-is-better wall-clock/compile metrics.
WATCH: List[Tuple[str, str]] = [
    ("cornell_16spp", "ms"), ("cornell_16spp", "compile_s"),
    ("cornell_500spp", "forward_ms"), ("cornell_500spp", "fwdbwd_ms"),
    ("cornell_500spp", "forward_compile_s"),
    ("cornell_500spp", "fwdbwd_compile_s"),
    ("nanosuit_cluster", "ms"), ("nanosuit_cluster", "fwdbwd_ms"),
    ("nanosuit_cluster", "compile_s"), ("nanosuit_cluster", "fwdbwd_compile_s"),
    ("sponza_scale", "ms"), ("sponza_scale", "fwdbwd_ms"),
    ("sponza_scale", "compile_s"), ("sponza_scale", "fwdbwd_compile_s"),
    ("atrium3m", "ms"),
]

# Compile-time budgets (seconds) — VERDICT r4 ask #6.  A budget miss is a
# loud bench finding, not a hard failure (the blocker may be documented).
COMPILE_BUDGETS: Dict[Tuple[str, str], float] = {
    ("sponza_scale", "fwdbwd_compile_s"): 30.0,
    ("nanosuit_cluster", "fwdbwd_compile_s"): 15.0,
}


def load_history(bench_dir: str) -> List[Tuple[int, dict]]:
    """[(round_n, extra_dict)] for every parseable BENCH_r*.json, ascending."""
    out = []
    for path in glob.glob(os.path.join(bench_dir, "BENCH_r*.json")):
        m = re.search(r"r(\d+)", os.path.basename(path))
        if not m:
            continue
        try:
            with open(path) as f:
                extra = json.load(f).get("parsed", {}).get("extra", {})
        except (ValueError, OSError):
            continue
        if extra:
            out.append((int(m.group(1)), extra))
    return sorted(out)


def flag_regressions(
    extra: dict,
    history: List[Tuple[int, dict]],
    current_round: int | None = None,
    threshold_best: float = 1.15,
    threshold_prev: float = 1.3,
) -> dict:
    """Returns {"regressions_vs_best": [...], "regressions_vs_prev": [...],
    "compile_budget": [...]}; each vs_best entry carries the best round's
    epoch and a ``cross_epoch`` label when it differs from this run's.

    ``current_round`` defaults to (max history round + 1).
    """
    if current_round is None:
        current_round = (max((n for n, _ in history), default=0)) + 1
    cur_epoch = epoch_of(current_round)

    vs_best = []
    for cfg_key, metric in WATCH:
        new = (extra.get(cfg_key) or {}).get(metric)
        if not new:
            continue
        best = None
        for n, h in history:
            old = (h.get(cfg_key) or {}).get(metric)
            if old and (best is None or old < best[0]):
                best = (old, n)
        if best and new > threshold_best * best[0]:
            vs_best.append({
                "config": cfg_key, "metric": metric,
                "best": best[0], "best_round": best[1],
                "best_epoch": epoch_of(best[1]),
                "now": new, "ratio": new / best[0],
                "cross_epoch": epoch_of(best[1]) != cur_epoch,
            })

    vs_prev = []
    if history:
        prev_n, prev = history[-1]
        for cfg_key, metric in WATCH:
            old = (prev.get(cfg_key) or {}).get(metric)
            new = (extra.get(cfg_key) or {}).get(metric)
            if old and new and new > threshold_prev * old:
                vs_prev.append({
                    "config": cfg_key, "metric": metric,
                    "prev": old, "now": new, "ratio": new / old,
                    "prev_round": prev_n,
                    "cross_epoch": epoch_of(prev_n) != cur_epoch,
                })

    budget = []
    for (cfg_key, metric), limit in COMPILE_BUDGETS.items():
        new = (extra.get(cfg_key) or {}).get(metric)
        if new:
            budget.append({
                "config": cfg_key, "metric": metric,
                "budget_s": limit, "measured_s": new, "ok": new <= limit,
            })

    return {
        "timing_epoch": cur_epoch,
        "regressions_vs_best": vs_best,
        "regressions_vs_prev": vs_prev,
        "compile_budget": budget,
    }


def format_findings(findings: dict) -> List[str]:
    """Human-readable log lines for the bench stderr stream."""
    lines = []
    for f in findings["regressions_vs_best"]:
        tag = " [CROSS-EPOCH: best was async-timed]" if f["cross_epoch"] else ""
        lines.append(
            f"REGRESSION vs best-ever (r{f['best_round']}): "
            f"{f['config']}.{f['metric']} {f['best']:.1f} -> {f['now']:.1f} "
            f"({f['ratio']:.2f}x slower){tag}"
        )
    for f in findings["regressions_vs_prev"]:
        tag = " [CROSS-EPOCH]" if f["cross_epoch"] else ""
        lines.append(
            f"REGRESSION vs prev round (r{f['prev_round']}): "
            f"{f['config']}.{f['metric']} {f['prev']:.1f} -> {f['now']:.1f} "
            f"({f['ratio']:.2f}x slower){tag}"
        )
    for b in findings["compile_budget"]:
        if not b["ok"]:
            lines.append(
                f"COMPILE BUDGET MISS: {b['config']}.{b['metric']} "
                f"{b['measured_s']:.1f}s > budget {b['budget_s']:.0f}s"
            )
    if not lines:
        lines.append("bench-history guard: no regressions vs best-ever, "
                     "compile budgets met")
    return lines
