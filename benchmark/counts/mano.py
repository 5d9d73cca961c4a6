"""Operations of the MANO decode and of IHMR-OPT's work, from shapes.

One multiply-add is 2 operations. A hand's decode (``decode_flops``):

    shape blend      778 * 3 * 10        (shapedirs . betas)
    pose blend       135 * 2334          (posedirs^T vec(R - I))
    joint regressor  16 * 778 * 3
    kinematic chain  15 * (27 + 9)       (a 3x3 product and a rotated offset per joint)
    rest removal     16 * 9
    skinning         778 * 16 * 12 + 778 * 9   (blend 16 affine transforms, apply one)

multiply-adds; Rodrigues, the mirror, the anchor and the losses are
element-wise and left out. A gradient step costs 3 x its forward.

A nearest-face rank (``rank_flops``) is 8 operations per (query, face)
pair: the centroid dot product (3 multiplies, 2 adds), |c|^2 - 2 q.c (a
multiply and a subtract) and the compare of the arg-min.
"""

from __future__ import annotations

from typing import Dict, List

from . import exact_collision

VERTS, FACES = 778, 1538


def decode_flops() -> int:
    macs = 778 * 3 * 10 + 135 * 2334 + 16 * 778 * 3 + 15 * (27 + 9) + 16 * 9 + 778 * 16 * 12 + 778 * 9
    return 2 * macs


def rank_flops(queries: int, faces: int) -> int:
    return 8 * queries * faces


def opt_batch_flops(batch: int, stages: List[Dict], knobs: Dict, k1_pairs: int) -> Dict[str, int]:
    """Operations of one OPT batch after its encoder: the Adam steps (decode
    forward and backward of 2B hands, the depth of each strided query against
    its frozen triangle), the payload rebuilds (a decode and the nearest-face
    rank of both directions), and the final pass (a decode, the exact
    depths over ``k1_pairs`` (query, triangle) pairs, the ray-parity test of
    every vertex against every face of the other hand at 20 operations a
    pair)."""
    hands = 2 * batch
    queries = -(-VERTS // knobs["loop_collision_subsample"])
    faces = -(-FACES // knobs["loop_collision_face_subsample"])
    steps = sum(s["epoch"] + 1 for s in stages)
    rebuilds = 0
    for s in stages:
        blocks = -(-(s["epoch"] + 1) // knobs["save_mid_freq"])
        rebuilds += -(-blocks // knobs["reselect_every_blocks"])
    step = 3 * (hands * decode_flops() + hands * queries * exact_collision.FLOP_PER_PAIR)
    rebuild = hands * decode_flops() + rank_flops(hands * queries, faces)
    final = hands * decode_flops() + k1_pairs * exact_collision.FLOP_PER_PAIR + 20 * hands * VERTS * FACES
    return {"steps": steps * step, "rebuilds": rebuilds * rebuild, "final": final}
