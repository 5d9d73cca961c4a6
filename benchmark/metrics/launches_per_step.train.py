"""Device kernels per train step over the traced steps."""


def read(rec):
    if not rec.get("steps") or not rec.get("kernels"):
        return None
    return len(rec["kernels"]) / rec["steps"]
