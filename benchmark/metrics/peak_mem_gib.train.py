"""Peak device memory allocated over the traced window (``max_memory_allocated``
after a reset), in GiB."""


def read(rec):
    return rec["memory_peak_bytes"] / 2**30 if "memory_peak_bytes" in rec else None
