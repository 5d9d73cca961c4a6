"""Device kernels per Adam step of the OPT engine: the kernels that start
inside the traced batch's ``optimize_batch`` span (its payload rebuilds and
final pass included) over the steps of its schedule."""


def read(rec):
    span = [(s, e) for n, s, e in rec.get("spans", ()) if n == "optimize_batch"]
    if not span or not rec.get("steps"):
        return None
    s, e = span[0]
    return sum(1 for _n, a, _b in rec["kernels"] if s <= a <= e) / rec["steps"]
