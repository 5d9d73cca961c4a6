"""Share of the traced window in which no operation ran on the device:
1 - (union of the device operations' intervals) / wall time."""


def read(rec):
    if not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
