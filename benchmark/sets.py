"""Run one cell several times, each run a new process as the check runs it,
and print the spread of each metric and the numbers its check compared.

    python3 benchmark/sets.py --workload <cell> --seconds <s> --seeds 1 2 3 ... [--trace 1] [--out file.jsonl]

Each run's result line (with its seed, exit code and wall seconds) is
appended to ``--out``; the summary gives, per metric, every value, the
median and the spread (Q3 - Q1) / median by ``statistics.quantiles(n=4)``,
and, per compared number, the largest value and its limit. The first run
of a call builds the port's kernels; its ``setup_s`` is reported apart.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def run_once(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(BENCH / "run.py"), "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=BENCH.parent, capture_output=True, text=True)
    out = {"seed": seed, "trace": trace, "rc": proc.returncode, "wall_s": time.perf_counter() - t}
    lines = proc.stdout.strip().splitlines()
    try:
        out["result"] = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        out["stderr"] = proc.stderr[-4000:]
    return out


def spread(values):
    return statistics.quantiles(values, n=4) if len(values) >= 2 else [values[0]] * 3


def summary(runs) -> dict:
    ok = [r for r in runs if "result" in r]
    metrics, checks = {}, {}
    for i, r in enumerate(ok):
        for k, v in r["result"]["metrics"].items():
            if k == "setup_s" and i == 0:
                k = "setup_s.first"
            metrics.setdefault(k, []).append(v["value"])
        for k, v in r["result"].get("checks", {}).items():
            c = checks.setdefault(k, {"max": 0.0, "limit": v["limit"], "values": []})
            c["max"] = max(c["max"], v["value"])
            c["values"].append(v["value"])
    table = {}
    for k, vals in metrics.items():
        q1, q2, q3 = spread(vals)
        table[k] = {"values": vals, "median": q2, "spread": (q3 - q1) / q2 if q2 else None}
    return {"runs": len(runs), "failed_runs": [r["seed"] for r in runs if "result" not in r],
            "incorrect": [r["seed"] for r in ok if not r["result"]["correct"]], "metrics": table, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    runs = []
    for seed in args.seeds:
        r = run_once(args.workload, seed, args.seconds, args.trace)
        runs.append(r)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
        brief = {k: v["value"] for k, v in r.get("result", {}).get("metrics", {}).items()}
        print(json.dumps({"seed": seed, "rc": r["rc"], "wall_s": round(r["wall_s"], 1),
                          "correct": r.get("result", {}).get("correct"), "metrics": brief}), flush=True)
        if "stderr" in r:
            print(r["stderr"][-2000:], flush=True)
    print(json.dumps(summary(runs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
