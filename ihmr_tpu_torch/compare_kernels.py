"""Time the port's K1, K2 and K3 against other sources of the same kernels, on the card.

    python3 -m ihmr_tpu_torch.compare_kernels --exact OTHER/exact_collision.cu \\
        --nearest OTHER/nearest_centroid.cu --bn OTHER/bn_stats.cu [--sass DIR]

Builds each given source and the package's own with the package's nvcc
flags (``build.NVCC_FLAGS``; ptxas's register and spill report is printed),
checks on the main paths' inputs at B=128 (``kernel_cases.exact_main_inputs``,
``nearest_main_inputs``) that both give the same outputs, bit for bit (K3:
each within 1e-5 of a float64 sum and the same bits on a second call, on
the 53 BatchNorm shapes of a ResNet-50 step at B=64, fp32 and bf16), then
times them in turns (given, package, package, given): device time alone
(``timing.cold_ms``, a CUDA graph replay with a cold L2) and with the host
(``timing.cuda_ms``, CUDA events around one ctypes call). Each source must
export the package's C entry point (``ihmr_exact_collision_forward``,
``ihmr_nearest_centroid_forward``, ``ihmr_bn_stats_forward``) with the
package's arguments. With ``--sass DIR`` each library's
``cuobjdump -sass`` goes to DIR, and the instructions of each loop of the
kernels are printed (static counts: a loop's rarely taken paths included).
The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
from pathlib import Path

import torch

from ihmr_tpu_torch.build import BUILD_DIR, PACKAGE_DIR, SOURCES, build_sources, nvcc_path
from ihmr_tpu_torch.kernel_cases import RESNET50_BN, exact_main_inputs, nearest_main_inputs
from ihmr_tpu_torch.ops import bn_stats as K3
from ihmr_tpu_torch.ops import exact_collision as K
from ihmr_tpu_torch.ops import nearest_centroid as NC
from ihmr_tpu_torch.timing import cold_ms, cuda_ms

# kernel -> (C entry point, its ctypes arguments)
ENTRY = {
    "exact_collision": ("ihmr_exact_collision_forward", K._FORWARD_ARGS),
    "nearest_centroid": ("ihmr_nearest_centroid_forward", NC._FORWARD_ARGS),
    "bn_stats": ("ihmr_bn_stats_forward", K3._FORWARD_ARGS),
}


def sass_loops(sass: str):
    """{function: [(first, last, instructions)]} of every backward branch in
    a ``cuobjdump -sass`` listing: the loops, with the instructions between
    the branch target and the branch, nested loops included."""
    out, fn, addrs, branches = {}, None, [], []

    def close():
        if fn is not None:
            out[fn] = [(t, b, sum(1 for a in addrs if t <= a <= b)) for t, b in branches]

    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            close()
            fn, addrs, branches = head.group(1), [], []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if ins and fn is not None:
            addr = int(ins.group(1), 16)
            addrs.append(addr)
            target = re.search(r"BRA (0x[0-9a-f]+)", ins.group(2))
            if target and int(target.group(1), 16) < addr:
                branches.append((int(target.group(1), 16), addr))
    close()
    return {(re.search(r"([a-z_]+_kernel)E", k) or re.match(r"(.*)", k)).group(1): v for k, v in out.items()}


def _entry(lib_path: Path, kernel: str):
    symbol, argtypes = ENTRY[kernel]
    fn = getattr(ctypes.CDLL(str(lib_path)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check(err):
    if err != 0:
        raise RuntimeError(f"kernel launch failed: cudaError {err}")


def exact_runner(fn, q, tri, bounds, n_tri):
    N, Vp, _ = q.shape

    def run():
        depth = torch.empty((N, Vp), dtype=torch.float32, device=q.device)
        dirs = torch.empty((N, Vp, 3), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream().cuda_stream
        _check(fn(q.data_ptr(), tri.data_ptr(), bounds.data_ptr(), depth.data_ptr(), dirs.data_ptr(),
                  N, Vp, tri.shape[1], n_tri, stream))
        return depth, dirs

    return run


def nearest_runner(fn, q, cent, n_tri):
    N, Vp, _ = q.shape

    def run():
        index = torch.empty((N, Vp), dtype=torch.int32, device=q.device)
        _check(fn(q.data_ptr(), cent.data_ptr(), index.data_ptr(), N, Vp, cent.shape[1], n_tri,
                  torch.cuda.current_stream().cuda_stream))
        return (index,)

    return run


def compare_bn(libs, reps):
    """K3: both libraries on the training step's shapes, fp32 and bf16 ->
    {dtype: {"shapes": [...], "step_ms": {version: [two readings]}}}."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        rows, step = [], {v: [0.0, 0.0] for v in libs}
        for (C, H, W), n in RESNET50_BN.items():
            x = (torch.randn((64, C, H, W), generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
            x64 = x.double()
            ref_s, ref_q, ref_a = x64.sum((0, 2, 3)), (x64 * x64).sum((0, 2, 3)), x64.abs().sum((0, 2, 3))
            runs = {v: (lambda fn=_entry(lib, "bn_stats"), x=x: K3._launch_kernel(x, fn)) for v, lib in libs.items()}
            for v, run in runs.items():
                s, q = run()
                again = run()
                torch.cuda.synchronize()
                err = max(float(((s.double() - ref_s).abs() / ref_a).max()), float(((q.double() - ref_q).abs() / ref_q).max()))
                if err > 1e-5 or not (torch.equal(s, again[0]) and torch.equal(q, again[1])):
                    raise AssertionError(f"bn_stats {v} on {(64, C, H, W)} {name}: error {err:.3e} or bits differ")
            times = {v: [] for v in libs}
            for v in ("given", "package", "package", "given"):
                times[v].append(cold_ms(runs[v], reps))
            for v in libs:
                step[v] = [a + n * t for a, t in zip(step[v], times[v])]
            bound = (x.numel() * x.element_size() + 8 * C) / 3.35e12 * 1e3
            slower = min(times["package"]) > max(times["given"])
            rows.append(dict(shape=[64, C, H, W], count=n, ms=times, bound_ms=bound, package_slower=slower))
            print(f"  bn_stats {name} {(64, C, H, W)} x{n}: given {times['given'][0]:.4f} / {times['given'][1]:.4f} ms, "
                  f"package {times['package'][0]:.4f} / {times['package'][1]:.4f} ms, bound {bound:.4f} ms"
                  + (" (package slower in both turns)" if slower else ""), flush=True)
            del x, x64
        print(f"  bn_stats {name} per step (53 launches): given {step['given'][0]:.4f} / {step['given'][1]:.4f} ms, "
              f"package {step['package'][0]:.4f} / {step['package'][1]:.4f} ms", flush=True)
        out[name] = dict(shapes=rows, step_ms=step)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--exact", type=Path, help="another exact_collision.cu")
    ap.add_argument("--nearest", type=Path, help="another nearest_centroid.cu")
    ap.add_argument("--bn", type=Path, help="another bn_stats.cu")
    ap.add_argument("--sass", type=Path, help="write each library's cuobjdump -sass here")
    ap.add_argument("--reps", type=int, default=10, help="calls per cold_ms graph")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    given = {k: p for k, p in (("exact_collision", args.exact), ("nearest_centroid", args.nearest),
                                ("bn_stats", args.bn)) if p}
    out_dir = BUILD_DIR / "compare"
    jobs = {}
    for kernel, src in given.items():
        jobs[f"{kernel}.given"] = (src.resolve(), out_dir / f"lib{kernel}-given.so")
        jobs[f"{kernel}.package"] = (PACKAGE_DIR / SOURCES[kernel], out_dir / f"lib{kernel}-package.so")
    for name, info in build_sources(jobs).items():
        print(f"build {name}: {info['seconds']:.1f}s\n{info['log'].strip()}", flush=True)
    if args.sass:
        args.sass.mkdir(parents=True, exist_ok=True)
        cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
        for name, (_, lib) in jobs.items():
            sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True).stdout
            (args.sass / f"{name}.sass").write_text(sass)
            for fn, loops in sass_loops(sass).items():
                if fn.endswith(("collision_kernel", "centroid_kernel", "runs_kernel", "tiles_kernel")):
                    print(f"sass {name} {fn}: loops (first, last, instructions) "
                          + ", ".join(f"({a:#x}, {b:#x}, {n})" for a, b, n in loops), flush=True)

    dev = torch.device("cuda")
    runners = {}
    if "exact_collision" in given:
        q, tri = exact_main_inputs(dev)
        qp, tp, bounds = K.pad_inputs(q, tri)
        runners["exact_collision"] = {v: exact_runner(_entry(jobs[f"exact_collision.{v}"][1], "exact_collision"),
                                                      qp, tp, bounds, tri.shape[1]) for v in ("given", "package")}
    if "nearest_centroid" in given:
        q, cent = nearest_main_inputs(dev)
        qp, cp = NC.pad_inputs(q, cent)
        runners["nearest_centroid"] = {v: nearest_runner(_entry(jobs[f"nearest_centroid.{v}"][1], "nearest_centroid"),
                                                         qp, cp, cent.shape[1]) for v in ("given", "package")}

    result = {"card": smi}
    if "bn_stats" in given:
        result["bn_stats"] = compare_bn({v: jobs[f"bn_stats.{v}"][1] for v in ("given", "package")}, args.reps)
    for kernel, run in runners.items():
        outs = {v: r() for v, r in run.items()}
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs["given"], outs["package"]))
        print(f"{kernel}: package and given outputs bit-equal at B=128: {same}", flush=True)
        if not same:
            raise AssertionError(f"{kernel}: the two sources disagree")
        times = {v: {"cold_ms": [], "cuda_ms": []} for v in run}
        for v in ("given", "package", "package", "given"):
            times[v]["cold_ms"].append(cold_ms(run[v], args.reps))
            times[v]["cuda_ms"].append(cuda_ms(run[v], 20))
            print(f"  {kernel} {v}: device alone {times[v]['cold_ms'][-1]:.4f} ms, "
                  f"with the host {times[v]['cuda_ms'][-1]:.4f} ms", flush=True)
        result[kernel] = times
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
