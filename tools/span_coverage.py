"""How much of a traced solve the port's own spans name: one ``--trace 1``
run of a cell of ``BENCHMARK.json`` (``tcibench``), then, from its trace,

- for each ``crossinterpolate2`` span (the benchmark's, around the call),
  the share of its wall that no ``tci.*`` span of the same thread covers
  (the largest, the median and the share over all calls);
- the share of the device's idle time that ``Trace.breakdown`` charges to a
  ``tci.*`` span, over every gap and over the ten labels of the result
  line;
- for the gaps that no ``tci.*`` span labels, the label they got and the
  ``tci.*`` span that ended last before each began, with its seconds;
- the ``tci.*`` spans' count and time a solve, by name;
- the solves a second of the traced window (the profiler on).

    python3 tools/span_coverage.py --workload lorentz8d.scan --seed 7 \\
        --seconds 8 [--device cpu --tiny] [--out FILE]

prints one JSON object (and writes it to FILE). ``--tiny`` runs the cell at
the benchmark tests' CPU sizes.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tcibench" / "tests"))


def _union(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def unlabeled_gaps(tr) -> dict:
    """The idle gaps whose label (the innermost span open when the gap
    began, Trace.breakdown's rule) is none of the program's: by label, the
    seconds, and by the tci.* span that ended last before the gap began."""
    spans = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
         for e in tr.events if e.get("cat") == "user_annotation"),
        key=lambda s: s[0])
    ended = sorted((b, n) for a, b, n in spans if n.startswith("tci."))
    out, end = {}, tr.lo
    for a, b in tr.busy_intervals() + [[tr.hi, tr.hi]]:
        if a > end:
            active = [s for s in spans if s[0] <= end <= s[1]]
            label = (min(active, key=lambda s: s[1] - s[0])[2]
                     if active else "no span")
            if not label.startswith("tci."):
                before = [n for t, n in ended if t <= end]
                last = before[-1] if before else "none"
                entry = out.setdefault(label, {"seconds": 0.0, "after": {}})
                entry["seconds"] += (a - end) / 1e6
                entry["after"][last] = (entry["after"].get(last, 0.0)
                                        + (a - end) / 1e6)
        end = max(end, b)
    return out


def coverage(tr) -> dict:
    spans = [e for e in tr.events if e.get("cat") == "user_annotation"]
    ours = [e for e in spans if e["name"].startswith("tci.")]
    unnamed, walls = [], []
    for e in (e for e in spans if e["name"] == "crossinterpolate2"):
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        inner = [(max(a, float(s["ts"])),
                  min(b, float(s["ts"]) + float(s["dur"])))
                 for s in ours if s.get("tid") == e.get("tid")]
        walls.append(b - a)
        unnamed.append(b - a - _union([(x, y) for x, y in inner if y > x]))
    gaps = tr.breakdown(top=10 ** 6)["idle_gaps"]
    top = tr.breakdown()["idle_gaps"]
    idle = tr.window_s - tr.busy_s
    nsolves = len(tr.spans_named("tcibench_solve")) or 1
    by_name = {}
    for s in ours:
        n, t = by_name.get(s["name"], (0, 0.0))
        by_name[s["name"]] = (n + 1, t + float(s["dur"]) / 1e3)
    return {
        "traced_solves_per_s": len(tr.spans_named("tcibench_solve"))
        / tr.window_s,
        "calls": len(walls),
        "unnamed_share_max": max(u / w for u, w in zip(unnamed, walls))
        if walls else None,
        "unnamed_share_median": statistics.median(
            u / w for u, w in zip(unnamed, walls)) if walls else None,
        "unnamed_share_total": sum(unnamed) / sum(walls) if walls else None,
        "idle_s": idle,
        "idle_labeled_tci_share": sum(v for k, v in gaps
                                      if k.startswith("idle in tci."))
        / idle if idle > 0 else None,
        "idle_labeled_tci_share_top10": sum(
            v for k, v in top if k.startswith("idle in tci.")) / idle
        if idle > 0 else None,
        "idle_gaps_top10": top,
        "unlabeled_gaps": unlabeled_gaps(tr),
        "spans_per_solve": {k: [n / nsolves, t / nsolves]
                            for k, (n, t) in sorted(by_name.items())},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from tcibench import core
    from tcibench.trace import Trace

    kept = []
    record = Trace.record.__func__

    def keep(cls, body):
        out, tr = record(cls, body)
        kept.append(tr)
        return out, tr

    Trace.record = classmethod(keep)
    overrides = None
    if args.tiny:
        from tiny import TINY
        overrides = TINY.get(args.workload.split(".")[0])
    line, _ = core.run_cell(args.workload, args.seed, args.seconds, True,
                            time.perf_counter(), device=args.device,
                            overrides=overrides)
    out = {"workload": args.workload, "seed": args.seed,
           "correct": line["correct"], "metrics": line["metrics"],
           **coverage(kept[0])}
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
