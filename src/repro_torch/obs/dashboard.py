"""Console dashboard + replay summary over the stats() / result feeds
(port of ``repro/obs/dashboard.py``; the same text).

Render-only: everything here reads the documented ``stats()`` schemas
(obs/schema.py) and completed SampleResults, no engine internals.

Rendering holds up on sparse inputs: a replay with no completion (every
request dropped, or an empty result list) still gives a summary table
with "n/a" percentiles, and a stats dict missing optional keys (probe-less
engines) still renders a row; exporters run in postmortem paths where a
crashing renderer would hide the real failure.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _fmt_ms(v: Optional[float]) -> str:
    return f"{v * 1e3:7.1f}" if v is not None else "    n/a"


def _fmt(v: Optional[float], spec: str, width: int) -> str:
    return f"{v:{spec}}" if v is not None else f"{'n/a':>{width}}"


def render_dashboard(stats: Dict) -> str:
    """Per-pool live table from an engine OR fleet stats() dict.

    The defect/fin columns surface the device-probe tier (engine stats
    ``probe_defect_max`` / ``probe_finite_min``): n/a on engines without
    probes, live trajectory-quality numbers with them.
    """
    pools = stats.get("pools", [stats])
    head = (f"{'pool':>4} {'state':<8} {'act/slot':>8} {'queue':>5} "
            f"{'ticks':>7} {'ewma_ms':>8} {'done':>6} {'drop':>5} "
            f"{'miss':>5} {'occ':>5} {'defect':>8} {'fin':>5} "
            f"{'tick':<9}")
    lines = [head, "-" * len(head)]
    for ps in pools:
        pid = ps.get("pool_id")
        active = ps.get("active", 0)
        lines.append(
            f"{('-' if pid is None else pid):>4} "
            f"{ps.get('state', 'active'):<8} "
            f"{active:>4}/{ps.get('slots', 0):<3} {ps.get('queued', 0):>5} "
            f"{ps.get('ticks', 0):>7} {_fmt_ms(ps.get('tick_ewma_s')):>8} "
            f"{ps.get('completed', 0):>6} {ps.get('dropped', 0):>5} "
            f"{ps.get('deadline_missed', 0):>5} "
            f"{_fmt(ps.get('occupancy'), '5.2f', 5)} "
            f"{_fmt(ps.get('probe_defect_max'), '8.3f', 8)} "
            f"{_fmt(ps.get('probe_finite_min'), '5.2f', 5)} "
            f"{ps.get('tick_variant', '?'):<9}")
    if "pools" in stats:      # fleet: totals row
        lines.append("-" * len(head))
        lines.append(
            f"{'all':>4} {'':8} {'':>8} {stats.get('queued', 0):>5} "
            f"{stats.get('ticks', 0):>7} {'':>8} "
            f"{stats.get('completed', 0):>6} "
            f"{stats.get('dropped', 0):>5} {'':>5} "
            f"{_fmt(stats.get('occupancy'), '5.2f', 5)} "
            f"{'':>8} {'':>5} "
            f"mega={stats.get('mega_tick_ratio', 0.0):.2f}")
    return "\n".join(lines)


def summarize_results(results: Sequence) -> Dict:
    """Latency/miss/drop summary over a replay's SampleResults.

    Total on sparse inputs: zero completions, drop-only lists, and
    results lacking a submit timestamp (warm-up traffic, synthetic
    records) all yield a well-formed dict whose percentile fields are
    None — render_summary turns those into "n/a" rather than crashing
    the end-of-replay report.
    """
    results = list(results)
    done = [r for r in results if not r.dropped]
    # warm-up/synthetic results may carry no submit timestamp — their
    # end-to-end latency is undefined, so they drop out of the
    # percentile population (not out of the completion counts)
    timed = [r for r in done if r.submit_t is not None]
    lat = np.asarray([r.latency_s for r in timed]) if timed else None
    misses = sum(1 for r in results if r.deadline_missed)
    out = {
        "requests": len(results),
        "completed": len(done),
        "dropped": sum(1 for r in results if r.dropped),
        "deadline_missed": misses,
        "miss_rate": misses / max(len(results), 1),
    }
    for q in (50, 95, 99):
        out[f"p{q}_latency_s"] = (float(np.percentile(lat, q))
                                  if lat is not None else None)
    if timed:
        out["p50_wait_s"] = float(np.percentile(
            [r.queue_wait_s for r in timed], 50))
        out["p50_service_s"] = float(np.percentile(
            [r.service_s for r in timed], 50))
    defects = [r.quality["defect_mean"] for r in done
               if getattr(r, "quality", None)
               and r.quality.get("defect_mean") is not None]
    out["defect_mean"] = (float(np.mean(defects)) if defects else None)
    return out


def render_summary(summary: Dict, trace_path: Optional[str] = None) -> str:
    """The end-of-replay table the serve CLI prints.

    Every field access tolerates absence/None: a postmortem path may
    hand this a partial summary and still needs a printable table.
    """
    miss_rate = summary.get("miss_rate") or 0.0
    lines = [
        "=== replay summary ===",
        f"requests   {summary.get('requests', 0):>8}",
        f"completed  {summary.get('completed', 0):>8}",
        f"dropped    {summary.get('dropped', 0):>8}",
        f"missed     {summary.get('deadline_missed', 0):>8}  "
        f"(miss rate {miss_rate * 100:.1f}%)",
    ]
    for q in (50, 95, 99):
        v = summary.get(f"p{q}_latency_s")
        lines.append(f"p{q} latency "
                     + (f"{v * 1e3:>8.1f} ms" if v is not None
                        else "     n/a"))
    if summary.get("p50_wait_s") is not None:
        w = summary["p50_wait_s"]
        s = summary.get("p50_service_s")
        lines.append(f"p50 wait   {w * 1e3:>8.1f} ms  / p50 service "
                     + (f"{s * 1e3:.1f} ms" if s is not None else "n/a"))
    if summary.get("defect_mean") is not None:
        lines.append(f"defect     {summary['defect_mean']:>8.4f}  "
                     "(mean step-doubling proxy, probed requests)")
    if trace_path:
        lines.append(f"trace      {trace_path}")
    return "\n".join(lines)
