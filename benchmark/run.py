"""Run one cell of the benchmark of ``ihmr_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port. Set-up (imports, the
port's kernel build, inputs and weights made from the seed, the warm-up of
the cell's shapes) is timed as ``setup_s``. With ``--trace 0`` the cell's
traffic runs for ``--seconds`` and the end-to-end metrics are printed; with
``--trace 1`` a bounded stretch of it runs under the profiler and the
per-layer metrics are printed. Then the program's state is freed and the
plain reference checks what the timed path produced. The last line of
standard output is one JSON object; the numbers compared, each with its
limit, are the last lines of standard error and the last key of that
object. A run exits with 1 and prints no result where there is no card, or
where a module of JAX or of the JAX package has been loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the port and of the libraries it uses stays in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    from benchmark import harness

    import torch

    t_torch = time.perf_counter() - T0
    workload, config = harness.cell_files(args.workload, BENCH)
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"needs {workload['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    man = harness.manifest(ROOT)
    result = run_cell(args.workload, workload, config, man, args.seed, args.seconds, args.trace, torch.device("cuda"),
                      {"torch_imported": t_torch})
    found = harness.forbidden_modules()
    if found:
        print("loaded modules of JAX or of the JAX package: " + ", ".join(found), file=sys.stderr)
        return 1
    print(json.dumps({"timing": result["timing"], "notes": result.get("notes")}), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


def run_cell(cell: str, workload, config, man, seed: int, seconds: float, trace: int, device, marks=None) -> dict:
    """Set-up, the window or the traced stretch, then the check -> the result object.
    ``marks``: seconds from the start to points of set-up already passed."""
    import torch

    from benchmark import harness

    driver = harness.driver_class(workload, BENCH)(config, workload["params"], seed, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    driver.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T0
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": workload["chips"]}
    breakdown = None
    records = None
    if trace:
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        records = driver.traced()
        if cuda:
            records["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    else:
        window = driver.window(seconds)
    t_window = time.perf_counter()
    dev_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0
    driver.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check(records)
    timing = {"setup_s": setup_s, "run_s": t_window - T0 - setup_s, "check_s": time.perf_counter() - t_window,
              "setup_marks_s": dict(marks or {}, **{k: v - T0 for k, v in getattr(driver, "marks", {}).items()})}
    if not trace:
        timing["units_s"] = window["units_s"]
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if trace:
        dev_info["busy_s"] = records["busy_s"]
        dev_info["window_s"] = records["window_s"]
        breakdown = records["breakdown"]
        for m in harness.cell_metrics(man, cell, "per_layer"):
            value = harness.read_metric(m["name"], records, BENCH)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        attempted, failed = records["attempted"], records["failed"]
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        for m in harness.cell_metrics(man, cell, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        attempted, failed = window["attempted"], window["failed"]
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["timing"] = timing
    if records is not None:
        result["notes"] = records.get("notes", {})
    result["checks"] = checks
    return result


if __name__ == "__main__":
    sys.exit(main())
