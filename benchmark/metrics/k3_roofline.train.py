"""Share of its roofline that the BatchNorm-statistics kernel K3 reaches over
the traced steps: every BatchNorm input read once over peak bytes/s
(``counts/resnet.py::bn_input_bytes``) over K3's device time."""

from benchmark.harness import kernel_seconds


def read(rec):
    seconds, n = kernel_seconds(rec, "bn_stats_")
    if not n or "k3_bytes" not in rec:
        return None
    return 100.0 * (rec["k3_bytes"] / rec["peak_bytes_per_s"]) / seconds
