"""The traced window's model operations (counted from shapes in ``counts/``)
per second, as a share of the chip's peak FLOP/s in the configuration's
precision."""


def read(rec):
    if not rec.get("flops") or not rec.get("window_s"):
        return None
    return 100.0 * rec["flops"] / rec["window_s"] / rec["peak_flops_per_s"]
