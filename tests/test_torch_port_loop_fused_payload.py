"""The merged per-block payload builder (``IHMR_PAYLOAD_FUSED=1``: the
engines' module constant ``_PAYLOAD_FUSED``, read at import and looked up
at call time): every superblock's frozen triangles come from one
``pair_select_tris`` call over both directions. Held to the JAX package's
``optimize_batch`` with its switch on, on the same inputs (harness, inputs
and bounds: tests/torch_port_modes.py); the port's builder must have run.
The builder picks the faces the default pair does (up to centroid rounding),
so the run is not required to leave the default path."""

import jax

from ihmr_tpu.refine import opt_engine as JE
from ihmr_tpu_torch.refine import opt_engine as TE
from tests.torch_port_modes import check_against_jax
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_fused_payload_builder_matches_jax(monkeypatch):
    calls = []
    inner = TE.pair_select_tris

    def counting(*args):
        calls.append(args[0].shape)
        return inner(*args)

    monkeypatch.setattr(JE, "_PAYLOAD_FUSED", True)
    monkeypatch.setattr(TE, "_PAYLOAD_FUSED", True)
    monkeypatch.setattr(TE, "pair_select_tris", counting)
    jax.clear_caches()  # JAX reads the switch while tracing
    try:
        check_against_jax("fused payload", dict(save_mid_freq=2), must_differ_from_default=False)
    finally:
        jax.clear_caches()
    assert calls, "the merged builder did not run"


def test_payload_switch_reads_the_environment_as_jax():
    """Read at import, as in the JAX package: on for any value but "0"."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = f"import sys; sys.path.insert(0, {root!r}); import ihmr_tpu_torch.refine.opt_engine as m; print(m._PAYLOAD_FUSED)"
    seen = {}
    for value in ("1", "0", None):
        env = {k: v for k, v in os.environ.items() if k != "IHMR_PAYLOAD_FUSED"}
        if value is not None:
            env["IHMR_PAYLOAD_FUSED"] = value
        out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
        seen[value] = out.stdout.strip()
    assert seen == {"1": "True", "0": "False", None: "False"}, seen
