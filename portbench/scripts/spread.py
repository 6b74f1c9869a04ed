"""Spread of a cell's runs from sets.sh's result lines: for each end-to-end metric and
set, the median and the distance between the first and third quartiles (Python's
statistics.quantiles, n=4) as a share of the median; the check numbers beside their
limits; the traced runs' per-layer metrics.

    python3 portbench/scripts/spread.py portbench_out/sets/<cell>.jsonl
"""
import json
import statistics
import sys


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(path):
    rows = []
    with open(path) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                print("unreadable line:", line[:200])
    bad = [r for r in rows if r["rc"] != 0 or not r["result"] or not r["result"]["correct"]]
    print(f"{len(rows)} runs, {len(bad)} not correct or failed: {[(r['set'], r['seed']) for r in bad]}")
    sets = sorted({r["set"] for r in rows if r["trace"] == 0})
    names = sorted({m for r in rows if r["trace"] == 0 and r["result"] for m in r["result"]["metrics"]})
    widest = {}
    for m in names:
        for s in sets:
            vals = [r["result"]["metrics"][m]["value"] for r in rows
                    if r["set"] == s and r["trace"] == 0 and r["result"]]
            if len(vals) >= 2:
                sp = spread(vals)
                widest[m] = max(widest.get(m, 0.0), sp)
                print(f"{m} set {s}: n {len(vals)} median {statistics.median(vals):.6g} spread {100 * sp:.3f}% "
                      f"values {[round(v, 6) for v in vals]}")
    for m, sp in widest.items():
        print(f"{m}: widest spread {100 * sp:.3f}%, five times {500 * sp:.3f}%")
    checks = {}
    for r in rows:
        for k, c in ((r["result"] or {}).get("checks") or {}).items():
            checks.setdefault(k, []).append(c["value"])
    for k, v in checks.items():
        print(f"check {k}: max {max(v, key=float)} over {len(v)} runs")
    for r in rows:
        if r["trace"] == 1 and r["result"]:
            res = r["result"]
            print("traced", r["seed"], {k: round(m["value"], 4) for k, m in res["metrics"].items()},
                  "busy_s", res["device"].get("busy_s"), "window_s", res["device"].get("window_s"),
                  "memory_peak_bytes", res["device"]["memory_peak_bytes"])


if __name__ == "__main__":
    main(sys.argv[1])
