"""Human-readable telemetry report — the per-stage table behind
``WorkflowResult.telemetry`` (paper Fig. 11 as numbers, not pixels).

``build_telemetry`` folds the run's :class:`EventLog` plus the metrics
registry into one JSON-safe dict:

* ``stages``    — one row per stage kind: worker count, busy seconds,
  samples processed, samples/s against the run wall clock.
* ``instances`` — one row per worker instance: busy % (overlap-merged)
  and wait % (blocked fetch + weight sync).
* ``staleness`` — p50/p95/max of observed weight staleness at the
  consuming train stage.
* ``metrics``   — the raw ``MetricsRegistry.snapshot()``.

``render_report`` renders the stage/instance tables as fixed-width text
for terminals and CI logs.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.obs.registry import MetricsRegistry, quantile

BOOKKEEPING_KINDS = ("wait", "weight_sync")


def build_telemetry(log, registry: Optional[MetricsRegistry],
                    wall_time_s: float, samples_trained: int,
                    staleness_seen: Optional[List[int]] = None) -> dict:
    events = log.events()
    wall = max(float(wall_time_s), 1e-9)

    by_kind: Dict[str, dict] = {}
    for e in events:
        if e.kind in BOOKKEEPING_KINDS:
            continue
        row = by_kind.setdefault(e.kind, {
            "stage": e.kind, "workers": set(), "calls": 0,
            "busy_s": 0.0, "samples": 0})
        row["workers"].add(e.instance)
        row["calls"] += 1
        row["busy_s"] += e.duration
        row["samples"] += int(e.meta.get("n", 0))

    stages = []
    for kind in sorted(by_kind):
        row = by_kind[kind]
        stages.append({
            "stage": kind,
            "workers": len(row["workers"]),
            "calls": row["calls"],
            "busy_s": round(row["busy_s"], 4),
            "samples": row["samples"],
            "samples_per_s": round(row["samples"] / wall, 2),
        })

    instances = {}
    for inst in log.instances():
        instances[inst] = {
            "busy_frac": round(log.busy_fraction(inst), 4),
            "wait_frac": round(log.wait_fraction(inst), 4),
        }

    stale = sorted(float(s) for s in (staleness_seen or []))
    staleness = {
        "count": len(stale),
        "p50": quantile(stale, 0.50) if stale else 0.0,
        "p95": quantile(stale, 0.95) if stale else 0.0,
        "max": stale[-1] if stale else 0.0,
    }

    return {
        "wall_time_s": round(wall, 4),
        "samples_trained": int(samples_trained),
        "throughput": round(samples_trained / wall, 2),
        "stages": stages,
        "instances": instances,
        "staleness": staleness,
        "metrics": registry.snapshot() if registry is not None else {},
    }


def render_report(telemetry: dict) -> str:
    """Fixed-width per-stage / per-instance tables from ``build_telemetry``
    output (or ``WorkflowResult.telemetry``)."""
    lines = [
        f"run: wall {telemetry['wall_time_s']:.2f}s · "
        f"{telemetry['samples_trained']} samples · "
        f"{telemetry['throughput']:.1f} samples/s",
        "",
        f"{'stage':>16s} {'workers':>7s} {'calls':>6s} {'busy_s':>8s} "
        f"{'samples':>8s} {'samples/s':>10s}",
    ]
    for row in telemetry.get("stages", []):
        lines.append(
            f"{row['stage']:>16s} {row['workers']:>7d} {row['calls']:>6d} "
            f"{row['busy_s']:>8.2f} {row['samples']:>8d} "
            f"{row['samples_per_s']:>10.1f}")
    lines += ["", f"{'instance':>16s} {'busy %':>7s} {'wait %':>7s}"]
    for inst, row in sorted(telemetry.get("instances", {}).items()):
        lines.append(f"{inst:>16s} {100 * row['busy_frac']:>6.1f}% "
                     f"{100 * row['wait_frac']:>6.1f}%")
    st = telemetry.get("staleness", {})
    if st.get("count"):
        lines += ["", f"staleness: p50 {st['p50']:.1f} · "
                      f"p95 {st['p95']:.1f} · max {st['max']:.0f} "
                      f"({st['count']} samples)"]
    rollout = _rollout_summary(telemetry.get("metrics", {}))
    if rollout:
        lines += ["", rollout]
    superv = _supervision_summary(telemetry.get("metrics", {}))
    if superv:
        lines += ["", superv]
    recov = _recovery_summary(telemetry.get("metrics", {}))
    if recov:
        lines += ["", recov]
    return "\n".join(lines)


def _metric_values(metrics: dict, name: str) -> List[dict]:
    return metrics.get(name, {}).get("values", [])


def _rollout_summary(metrics: dict) -> str:
    """One-line continuous-batching rollout summary: slot occupancy,
    admissions, KV pages, and the prefill/decode time split."""
    occ = _metric_values(metrics, "rollout_slot_occupancy")
    if not occ:
        return ""
    adm = sum(v["value"] for v in
              _metric_values(metrics, "rollout_admissions_total"))
    pages = sum(v["value"] for v in
                _metric_values(metrics, "rollout_kv_pages_in_use"))
    pre = _metric_values(metrics, "rollout_prefill_seconds")
    dec = _metric_values(metrics, "rollout_decode_step_seconds")
    pre_s = sum(v.get("sum", 0.0) for v in pre)
    dec_s = sum(v.get("sum", 0.0) for v in dec)
    tot = pre_s + dec_s
    split = (f"prefill {100 * pre_s / tot:.0f}% / "
             f"decode {100 * dec_s / tot:.0f}%") if tot > 0 else "idle"
    return (f"rollout: occupancy {occ[-1]['value']:.2f} · "
            f"{int(adm)} admissions · {int(pages)} kv pages · {split} "
            f"({tot:.2f}s)")


def _supervision_summary(metrics: dict) -> str:
    """One-line fault-tolerance summary: replica restarts, in-place stage
    retries, rows requeued after consumer deaths, injected faults."""
    restarts = sum(v["value"] for v in
                   _metric_values(metrics, "replica_restarts_total"))
    retries = sum(v["value"] for v in
                  _metric_values(metrics, "stage_retries_total"))
    requeued = sum(v["value"] for v in
                   _metric_values(metrics, "rows_requeued_total"))
    injected = sum(v["value"] for v in
                   _metric_values(metrics, "faults_injected_total"))
    if not (restarts or retries or requeued or injected):
        return ""
    line = (f"supervision: {int(restarts)} replica restarts · "
            f"{int(retries)} stage retries · "
            f"{int(requeued)} rows requeued")
    if injected:
        line += f" · {int(injected)} faults injected"
    return line


def _recovery_summary(metrics: dict) -> str:
    """One-line durability summary: run snapshots committed (bytes +
    write wall time), warm trainer restarts, duplicate rows dropped."""
    writes = _metric_values(metrics, "checkpoint_write_seconds")
    n_snaps = sum(v.get("count", 0) for v in writes)
    if not n_snaps:
        return ""
    w_s = sum(v.get("sum", 0.0) for v in writes)
    mb = sum(v["value"] for v in
             _metric_values(metrics, "checkpoint_bytes_total")) / 1e6
    restarts = sum(v["value"] for v in
                   _metric_values(metrics, "trainer_restarts_total"))
    dups = sum(v["value"] for v in
               _metric_values(metrics, "rows_dropped_duplicate_total"))
    line = (f"recovery: {int(n_snaps)} snapshots · {mb:.2f} MB · "
            f"{w_s:.2f}s write time · {int(restarts)} trainer restarts")
    if dups:
        line += f" · {int(dups)} duplicate rows dropped"
    return line
