"""Fleet report: the offline cross-process telemetry view of a run.

Counterpart of the JAX package's ``scripts/fleet_report.py``.

Reads the fleet plane's per-process artifacts under a run's obs root
(``<out_root>/obs/p<k>/`` — heartbeat ``registry.json`` snapshots,
``sweeps.jsonl`` barrier-arrival logs, ``breakdown.json`` device-time
attributions; single-process layouts work too) and prints:

1. the worker table — process index, host, pid, heartbeat age, and
   ok / stale / dead status (``PHOTON_FLEET_STALE_X`` heartbeats);
2. the merged fleet registry — counters summed across processes,
   histograms merged BUCKET-EXACT (photon_tpu_torch/obs/fleet.py) with fleet
   p50/p90/p99;
3. per-sweep arrival-skew rows — each iteration's start/arrival
   spread, per-worker skew ratios (1 + sweep-START lateness in units
   of the iteration's unobstructed sweep wall), and flagged stragglers
   (ratio > ``PHOTON_FLEET_STRAGGLER_X``; warm-up rows never flag);
4. the per-coordinate device-time breakdown (compute vs collectives vs
   barrier wait) when the fit published one.

Writes the full document as JSON (``--out``, default
``<obs>/fleet_report.json``). Exit 0 always unless ``--strict``, which
exits 4 when any worker is dead or any straggler was flagged — the CI
lever for lanes that must be skew-clean.

Usage: python -m photon_tpu_torch.cli.fleet_report <out_root_or_obs_dir> [--out P]
"""
from __future__ import annotations

import argparse
import json
import os


def resolve_obs_root(path: str) -> str:
    """Accept either a driver ``out_root`` (obs lives at ``<p>/obs``) or
    the obs directory itself."""
    cand = os.path.join(path, "obs")
    return cand if os.path.isdir(cand) else path


def worker_table(workers: list[dict]) -> str:
    if not workers:
        return "(no worker heartbeats found)"
    header = f"{'proc':>4} {'host':<16} {'pid':>7} {'hb_age_s':>9} {'seq':>5} status"
    lines = [header]
    for w in workers:
        lines.append(
            f"{w['process_index']:>4} {str(w['host'])[:16]:<16} "
            f"{w['pid']:>7} {w['heartbeat_age_s']:>9.2f} "
            f"{w.get('seq', 0):>5} {w['status']}"
            + (" (stopped clean)" if w.get("stopped") else "")
        )
    return "\n".join(lines)


def skew_table(skew: list[dict]) -> str:
    if not skew:
        return "(no per-sweep arrival rows found)"
    procs = sorted(
        {p for r in skew for p in r["arrival_wall_s"]}, key=int
    )
    cols = "".join(f" {'p' + p + '_ratio':>9}" for p in procs)
    lines = [
        f"{'sweep':>5} {'start_skew_s':>12} {'base_sweep_s':>12}{cols}"
        "  stragglers"
    ]
    for r in skew:
        vals = "".join(
            f" {r['skew_ratio'].get(p, float('nan')):>9.3f}" for p in procs
        )
        strag = ",".join(str(p) for p in r["stragglers"]) or "-"
        lines.append(
            f"{r['iteration']:>5} {r.get('start_skew_s', r['skew_s']):>12.3f} "
            f"{r.get('base_sweep_s', r.get('median_sweep_s', 0)):>12.4f}"
            f"{vals}  {strag}"
        )
    return "\n".join(lines)


def counters_table(fleet_snapshot: dict, top: int = 20) -> str:
    counters = fleet_snapshot.get("counters") or {}
    if not counters:
        return "(no fleet counters)"
    rows = sorted(counters.items())[:top] if top else sorted(counters.items())
    width = max(len(k) for k, _ in rows)
    lines = [f"{'fleet counter (summed)':<{width}}  value"]
    for k, v in rows:
        lines.append(f"{k:<{width}}  {v:g}")
    if top and len(counters) > top:
        lines.append(f"... {len(counters) - top} more in the JSON report")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("root", help="run out_root or its obs directory")
    ap.add_argument("--out", default=None, help="JSON report path")
    ap.add_argument(
        "--strict", action="store_true",
        help="exit 4 on any dead worker or flagged straggler",
    )
    args = ap.parse_args(argv)

    from photon_tpu_torch.obs import fleet

    obs_root = resolve_obs_root(args.root)
    doc = fleet.fleet_report(obs_root)

    print(f"[fleet] obs root: {obs_root}")
    print()
    print(worker_table(doc["workers"]))
    print()
    print(counters_table(doc["fleet"]))
    hists = (doc["fleet"].get("histograms") or {})
    if hists:
        print()
        print("fleet histograms (bucket-exact merge):")
        for name, h in sorted(hists.items()):
            print(
                f"  {name}: n={h['count']} p50={h.get('p50')} "
                f"p90={h.get('p90')} p99={h.get('p99')}"
            )
    print()
    print(
        f"per-sweep arrival skew (straggler: start-lateness ratio > "
        f"{doc['straggler_threshold_x']}x):"
    )
    print(skew_table(doc["skew"]))
    if doc["stragglers"]:
        print()
        for s in doc["stragglers"]:
            print(
                f"  STRAGGLER: process {s['process_index']} at sweep "
                f"{s['iteration']} (ratio {s['skew_ratio']}, "
                f"{s['skew_s']:.3f}s spread)"
            )
    for proc, bd in sorted((doc.get("breakdowns") or {}).items()):
        b = bd.get("breakdown", bd)
        print()
        print(f"[{proc}] " + fleet.breakdown_table(b))

    out = args.out or os.path.join(obs_root, "fleet_report.json")
    with open(out, "w") as f:
        json.dump(doc, f, indent=2, default=str, sort_keys=True)
    print(f"\n[fleet] report written: {out}")

    if args.strict:
        dead = [w for w in doc["workers"] if w["status"] == "dead"]
        if dead or doc["stragglers"]:
            print(
                f"[fleet] STRICT FAILURE: {len(dead)} dead workers, "
                f"{len(doc['stragglers'])} straggler flags"
            )
            return 4
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
