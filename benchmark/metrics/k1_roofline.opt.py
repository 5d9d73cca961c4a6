"""Share of its roofline that the exact-collision kernel K1 reaches on the
traced batch: the least time the chip could take for the work these meshes
need (``counts/exact_collision.py``: the larger of operations over peak
FLOP/s and bytes over peak bytes/s) over K1's device time."""

from benchmark.harness import kernel_seconds


def read(rec):
    seconds, n = kernel_seconds(rec, "exact_collision_kernel")
    if not n or "k1_flops" not in rec:
        return None
    return 100.0 * max(rec["k1_flops"] / rec["peak_flops_per_s"], rec["k1_bytes"] / rec["peak_bytes_per_s"]) / seconds
