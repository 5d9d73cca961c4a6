"""The reference's grid field in the loop (``loop_collision_fast=False``,
``collision_backend="grid"``, the CLI's ``--loop_collision_backend grid``):
both hands' penetration grids rebuilt once a superblock, live queries
sampled trilinearly; the final metric measures with the exact kernel. The
build is cut as the JAX package's escalation test cuts it (res 8, every
4th face); ``grid_num_candidates=1``, so that both packages take the
argmin face (at K>1 JAX's CPU sort keeps another subset of tied bf16 ranks
than the port's lowest-index rule; the K-candidate depth is held to JAX
on its own in tests/test_torch_port_kcandidate.py). Held to the JAX
package's ``optimize_batch`` on the same inputs (harness, inputs and
bounds: tests/torch_port_modes.py)."""

from tests.torch_port_modes import check_against_jax
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_grid_in_the_loop_matches_jax():
    check_against_jax(
        "grid in the loop",
        dict(save_mid_freq=2, loop_collision_fast=False, collision_backend="grid", grid_res=8,
             grid_face_subsample=4, grid_num_candidates=1),
    )
