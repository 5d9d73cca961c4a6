"""The port's stage-hoisted OPT engine against JAX's, in lockstep, step by step.

    JAX_PLATFORMS=cpu python -m tests.test_torch_port_opt_lockstep --batch 32 --seed 0
        [--threads N] [--no_stage_hoist] [--out FILE]

Both packages run each stage of ``opt_default`` from identical entry params
(JAX's result of the stage before): JAX's ``_run_one_stage_hoisted``
(``ihmr_tpu/refine/opt_engine.py``, what ``run_all_stages_hoisted`` runs
for each stage) jitted as the engine jits it, and the port's
``refine/opt_engine.py::run_stage`` with ``OptConfig()``.

Every step is recorded on both sides, so the runner needs no bisection. On
the JAX side ``JaxRecorder`` patches the names the stage program calls
(``compute_losses``, ``pair_indices``, ``pair_tris_at``,
``pair_depths_at_tris``, ``joints_2d_loss``, ``finger_reg_loss``) with
wrappers that pass their values to the host through ordered
``jax.debug.callback``s. They only read: the runner checks that the recorded
program's stage result has the same bits as the unrecorded one's. On the
port's side ``ihmr_tpu_torch.engine_drift.Recorder`` does the same. Per
gradient evaluation t (the params after t optimizer steps) both record the
params, the in-loop contact set, the region of each contacting query's
frozen triangle that holds its closest point (face, edge or vertex), the
signs of the L1 2D residuals and the finger-prior kinks; per payload rebuild the nearest-face picks (and, on
the JAX side, the frozen triangles and scale).

Per sample whose params leave ``TOL`` (5e-5) at some evaluation, or whose stage
result ends apart: the first evaluation above the bound, the first
evaluation where a discrete choice differs (and its kind), the gap at that
evaluation, and the snapshot each side kept. A choice made at evaluation t
moves the params from t + 1 on, so the sample is explained when its first
differing choice comes before its first evaluation above the bound. If it
leaves the bound first, the port's gradient at JAX's params of the
evaluation before is held to JAX's: within SAME_PARAMS_GRAD_TOL the two
compute the same function there and the trajectories drift apart through
fp32 rounding alone ("drift"); beyond it the port computes something else
(a fault).
For that choice the port is also evaluated at JAX's params of that step with
JAX's payload: whether it makes JAX's choice from the same params, and the
margin of the choice there. At every rebuild the port's gradient at JAX's
params, with JAX's payload, is held to JAX's gradient (a jitted
``compute_losses`` gradient), and the port's payload built from JAX's
params to JAX's recorded payload.

The tier-1 case below runs the orient stage (collision in the loop, the L1
2D residuals) at B=2 for 21 steps with one JAX compile (the pose stage's
program takes ~85 s to compile on one core); a second test holds the
losses to JAX's derivatives at their kinks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ihmr_tpu.data.synthetic import make_opt_inputs as jax_make_opt_inputs
from ihmr_tpu.losses import losses as JL
from ihmr_tpu.mano.loader import synthetic_mano_model as jax_synthetic
from ihmr_tpu.refine import opt_engine as JE
from ihmr_tpu.refine import schedule as JS
from ihmr_tpu_torch.engine_drift import Recorder
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.refine import OptBatch, OptConfig
from ihmr_tpu_torch.refine import opt_engine as TE
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = 5e-5  # the JAX package's bound between its own engines over a short horizon
# at JAX's params, the port's gradient within this of JAX's (relative to the
# sample's largest entry): fp32 sums in another order, measured <= 7.3e-6
SAME_PARAMS_GRAD_TOL = 1e-5
KINDS = ("nearest-face pick", "contact set", "closest-point region", "L1 residual sign", "finger-prior sign")


def T(x):
    return torch.tensor(np.asarray(x))


def jax_closest_regions(p, tri):
    """``engine_drift.closest_regions`` in JAX, on the predicates of
    ``ihmr_tpu.ops.collision.point_triangle_closest``."""
    p, tri = jax.lax.stop_gradient(p), jax.lax.stop_gradient(tri)
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    ab, ac = b - a, c - a
    ap, bp, cp = p - a, p - b, p - c
    d1, d2 = jnp.sum(ab * ap, -1), jnp.sum(ac * ap, -1)
    d3, d4 = jnp.sum(ab * bp, -1), jnp.sum(ac * bp, -1)
    d5, d6 = jnp.sum(ab * cp, -1), jnp.sum(ac * cp, -1)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
    region = jnp.zeros(d1.shape, jnp.int32)
    for code, inside in enumerate((
        (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0), (vb <= 0) & (d2 >= 0) & (d6 <= 0),
        (vc <= 0) & (d1 >= 0) & (d3 <= 0), (d6 >= 0) & (d5 <= d6), (d3 >= 0) & (d4 <= d3), (d1 <= 0) & (d2 <= 0),
    ), start=1):
        region = jnp.where(inside, code, region)
    return region


class JaxRecorder:
    """Per-evaluation params and choices, per-rebuild picks and triangles of
    one run of JAX's hoisted stage program, through ordered host callbacks
    placed by patching the names the program calls."""

    def __init__(self, groups):
        self.groups = tuple(groups)
        self.evals = []  # {group: (B, d)} at each gradient evaluation
        self.picks = []  # (evaluation index, idx_r, idx_l) at each payload rebuild
        self.tris = []  # (tri_r, tri_l) at each payload rebuild
        self.scales = []  # the frozen AABB scale at each payload rebuild
        self.contacts = []  # (B, 2*Vq) bool, one per evaluation
        self.regions = []  # (B, 2*Vq) int8: closest_regions of the queries in contact, -1 elsewhere
        self.l1_signs = []  # (B, 84) int8
        self.finger_signs = []  # (B, 20) int8
        self._j2d_calls = 0

    @staticmethod
    def _host(fn):
        return lambda *xs: fn(*[np.array(x) for x in xs])

    @contextlib.contextmanager
    def patched(self):
        rec = self
        saved = {n: getattr(JE, n) for n in ("compute_losses", "pair_indices", "pair_tris_at", "pair_depths_at_tris",
                                             "pair_aabb_scale")}
        saved_l = {n: getattr(JL, n) for n in ("joints_2d_loss", "finger_reg_loss")}

        def compute_losses(model, p, batch, weights, config, in_loop=False, **kw):
            if in_loop:
                rec._j2d_calls = 0
                jax.debug.callback(
                    rec._host(lambda *xs: rec.evals.append(dict(zip(rec.groups, xs)))),
                    *[p[k] for k in rec.groups], ordered=True)
            return saved["compute_losses"](model, p, batch, weights, config, in_loop=in_loop, **kw)

        def pair_indices(*args):
            idx = saved["pair_indices"](*args)
            jax.debug.callback(rec._host(lambda r, l: rec.picks.append((len(rec.evals), r, l))), *idx,
                               ordered=True)
            return idx

        def pair_tris_at(*args):
            tris = saved["pair_tris_at"](*args)
            jax.debug.callback(rec._host(lambda r, l: rec.tris.append((r, l))), *tris, ordered=True)
            return tris

        def pair_aabb_scale(*args):
            scale = saved["pair_aabb_scale"](*args)
            jax.debug.callback(rec._host(rec.scales.append), scale, ordered=True)
            return scale

        def pair_depths_at_tris(q_r, q_l, tri_r, tri_l, **kwargs):
            depths = saved["pair_depths_at_tris"](q_r, q_l, tri_r, tri_l, **kwargs)
            region = jnp.concatenate([jax_closest_regions(q_r, tri_r), jax_closest_regions(q_l, tri_l)], axis=1)
            region = jnp.where(depths > 0, region, -1).astype(jnp.int8)
            jax.debug.callback(rec._host(lambda d, r: (rec.contacts.append(d > 0), rec.regions.append(r))),
                               depths, jax.lax.stop_gradient(region), ordered=True)
            return depths

        def joints_2d_loss(gt, pred, weight):
            # in the loop, compute_losses calls it for the ground-truth log
            # first and for the self-consistency targets second
            rec._j2d_calls += 1
            if rec._j2d_calls == 2:
                sign = (jnp.sign(gt - pred) * (weight > 0)).reshape(gt.shape[0], -1).astype(jnp.int8)
                jax.debug.callback(rec._host(lambda s: rec.l1_signs.append(s)), sign, ordered=True)
            return saved_l["joints_2d_loss"](gt, pred, weight)

        def finger_reg_loss(joints_3d):
            B = joints_3d.shape[0]
            chains = jax.lax.stop_gradient(joints_3d)[:, JL.FINGER_JOINT_IDXS, :].reshape(B, 10, 4, 3)
            bones = chains[:, :, :3, :] - chains[:, :, 1:, :]
            f0, f1, f2 = bones[:, :, 0], bones[:, :, 1], bones[:, :, 2]
            c01, c12 = jnp.cross(f0, f1), jnp.cross(f1, f2)
            c1, c2 = jnp.sum(f2 * c01, axis=-1), jnp.sum(c01 * c12, axis=-1)
            signs = jnp.concatenate([jnp.sign(c1), (c2 < 0).astype(c1.dtype)], axis=1).astype(jnp.int8)
            jax.debug.callback(rec._host(lambda s: rec.finger_signs.append(s)), signs, ordered=True)
            return saved_l["finger_reg_loss"](joints_3d)

        jax.clear_caches()
        try:
            JE.compute_losses, JE.pair_indices = compute_losses, pair_indices
            JE.pair_tris_at, JE.pair_depths_at_tris = pair_tris_at, pair_depths_at_tris
            JE.pair_aabb_scale = pair_aabb_scale
            JL.joints_2d_loss, JL.finger_reg_loss = joints_2d_loss, finger_reg_loss
            yield
        finally:
            for n, v in saved.items():
                setattr(JE, n, v)
            for n, v in saved_l.items():
                setattr(JL, n, v)
            jax.clear_caches()


_jax_stage = jax.jit(JE._run_one_stage_hoisted, static_argnames=("stage", "config"))


def jax_inputs(batch, seed):
    jm = jax_synthetic()
    jp, jb = jax_make_opt_inputs(jm, batch=batch, seed=seed)
    return jm, jp, jb


def torch_batch(jb):
    return OptBatch(**{f.name: T(getattr(jb, f.name)) for f in dataclasses.fields(OptBatch)})


def run_jax_stage(jm, entry, jb, stage, check_unrecorded=False):
    """JAX's hoisted stage program from ``entry`` -> (result params as numpy,
    the JaxRecorder). With ``check_unrecorded`` the program also runs without
    the recorder (a second compile) and the two results must have the same
    bits."""
    cfg = JE.OptConfig(save_mid_freq=10)
    rec = JaxRecorder(stage.update_params)
    with rec.patched():
        out = jax.tree_util.tree_map(np.asarray, _jax_stage(jm, entry, jb, stage=stage, config=cfg))
    if check_unrecorded:
        plain = jax.tree_util.tree_map(np.asarray, _jax_stage(jm, entry, jb, stage=stage, config=cfg))
        for k in out:
            assert np.array_equal(out[k], plain[k]), f"the recorder changed JAX's stage result ({k})"
    return out, rec


def run_port_stage(tm, entry, tb, stage, hoist=True):
    """The port's ``run_stage`` from ``entry`` (torch tensors), on its hoisted
    engine or (``hoist=False``) its full decode -> (result params, the
    engine_drift Recorder)."""
    rec = Recorder()
    with rec.patched():
        out = TE.run_stage(tm, entry, tb, stage, OptConfig(stage_hoist_decode=hoist))
    return out, rec


def _gap(a, b, groups):
    """Per-sample largest |a - b| over ``groups`` -> (B,) numpy."""
    return np.max([np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)).reshape(len(a[k]), -1).max(1)
                   for k in groups], axis=0)


def _snapshot_kept(evals, best, groups, freq):
    """Per sample, the snapshot evaluation whose params the stage kept (-1: none)."""
    B = len(best[groups[0]])
    kept = np.full(B, -1)
    for j0 in range(0, len(evals), freq):
        same = np.all([np.all(evals[j0][k] == best[k], axis=1) for k in groups], axis=0)
        kept = np.where(same & (kept < 0), j0, kept)
    return kept


def _port_at(tm, tb, stage, entry, params, payload, hoist=True):
    """The port's in-loop loss at ``params`` (numpy, the stage's groups) with
    the frozen ``payload`` -> (gradients, contact set, closest-point regions,
    L1 signs, finger signs) as numpy (None for a term the weights skip)."""
    rec = Recorder()
    fwd = TE._make_stage_forward(tm, stage, entry) if hoist else None
    frozen = {k: v for k, v in entry.items() if k not in stage.update_params}
    leaves = {k: T(params[k]).requires_grad_(True) for k in stage.update_params}
    with rec.patched():
        total, _ = TE.compute_losses(tm, {**frozen, **leaves}, tb, stage.weights, OptConfig(), in_loop=True,
                                     coll_tris=payload, fwd_fn=fwd)
    grads = torch.autograd.grad(total, list(leaves.values()))
    first = [lst[0].numpy() if lst else None for lst in (rec.contacts, rec.regions, rec.l1_signs, rec.finger_signs)]
    return ({k: g.numpy() for k, g in zip(leaves, grads)}, *first)


def _jax_grad(jm, jb, stage):
    cfg = JE.OptConfig(save_mid_freq=10)

    @jax.jit
    def grad(entry, sub, tris):
        fwd = JE._make_stage_forward(jm, stage, entry)
        frozen = {k: v for k, v in entry.items() if k not in stage.update_params}
        return jax.grad(lambda s: JE.compute_losses(jm, {**frozen, **s}, jb, stage.weights, cfg, in_loop=True,
                                                     coll_tris=tris, fwd_fn=fwd)[0])(sub)

    return grad


def lockstep_stage(jm, tm, jentry, jb, tb, stage, check_unrecorded=False, hoist=True, check_rebuilds=True):
    """One stage on both sides from ``jentry`` -> (report dict, JAX's result).
    ``hoist=False`` runs the port's full decode against JAX's hoisted engine;
    ``check_rebuilds=False`` skips the port-at-JAX's-params checks at every
    rebuild (and with them a compile of JAX's gradient)."""
    groups = list(stage.update_params)
    freq = JE.OptConfig().save_mid_freq
    jout, jrec = run_jax_stage(jm, jentry, jb, stage, check_unrecorded)
    tentry = {k: T(v) for k, v in jentry.items()}
    tout, trec = run_port_stage(tm, tentry, tb, stage, hoist)
    tout = {k: v.numpy() for k, v in tout.items()}
    n = len(jrec.evals)
    tevals = [{k: tentry[k].numpy() for k in groups}] + [{k: s[k].numpy() for k in groups} for s in trec.steps[:-1]]
    assert len(tevals) == n == stage.epoch + 1, (len(tevals), n)
    assert len(trec.picks) == len(jrec.picks) and [p[0] for p in trec.picks] == [p[0] for p in jrec.picks]
    gaps = np.stack([_gap(a, b, groups) for a, b in zip(jrec.evals, tevals)])  # (n, B)
    B = gaps.shape[1]
    rebuilds = [p[0] for p in jrec.picks]

    def per_eval(a, b):  # (n, B) counts of differing choices
        return np.stack([(np.asarray(x) != y.numpy()).reshape(B, -1).sum(1) for x, y in zip(a, b)])

    diff = {
        "contact set": per_eval(jrec.contacts, trec.contacts),
        "closest-point region": per_eval(jrec.regions, trec.regions),
        "L1 residual sign": per_eval(jrec.l1_signs, trec.l1_signs),
        "finger-prior sign": per_eval(jrec.finger_signs, trec.finger_signs),
    }
    pick_diff = np.zeros((n, B), int)
    for (t, jr, jl), (_, tr, tl) in zip(jrec.picks, trec.picks):
        pick_diff[t] = (jr != tr.numpy()).sum(1) + (jl != tl.numpy()).sum(1)
    diff = {"nearest-face pick": pick_diff, **diff}
    kept_j = _snapshot_kept(jrec.evals, jout, groups, freq)
    kept_t = _snapshot_kept(tevals, tout, groups, freq)
    end_gap = _gap(jout, tout, groups)

    # at every rebuild: the port from JAX's params, with JAX's payload
    jgrad = _jax_grad(jm, jb, stage) if check_rebuilds else None
    rebuild_checks = []
    for r, t in enumerate(rebuilds if check_rebuilds else []):
        jpay = (*jrec.tris[r], jrec.scales[r])
        g_t, c_t, r_t, l1_t, f_t = _port_at(tm, tb, stage, tentry, jrec.evals[t], tuple(T(x) for x in jpay), hoist)
        g_j = jgrad(jentry, jrec.evals[t], tuple(jnp.asarray(x) for x in jpay))
        gscale = max(float(np.abs(np.asarray(g_j[k])).max()) for k in groups)
        ggap = max(float(np.abs(g_t[k] - np.asarray(g_j[k])).max()) for k in groups) / max(gscale, 1e-30)
        fwd = TE._make_stage_forward(tm, stage, tentry) if hoist else None
        prec = Recorder()
        with prec.patched():
            ptri = TE._lazy_coll_payload(tm, {**tentry, **{k: T(v) for k, v in jrec.evals[t].items()}}, OptConfig(),
                                         fwd)
        same_pick = np.concatenate([prec.picks[0][1].numpy() == jrec.picks[r][1],
                                    prec.picks[0][2].numpy() == jrec.picks[r][2]], axis=1)
        tri_gap = max(float(np.abs(ptri[i].numpy() - jpay[i]).reshape(B, -1, 9)[same_pick.reshape(B, 2, -1)[:, i]]
                            .max(initial=0.0)) for i in range(2))
        rebuild_checks.append(dict(
            step=t, grad_rel_gap=ggap, picks_differing=int((~same_pick).sum()), tri_gap_where_picks_agree=tri_gap,
            contacts_differing=int((c_t != jrec.contacts[t]).sum()),
            regions_differing=int((r_t != jrec.regions[t]).sum()),
            l1_signs_differing=int((l1_t != jrec.l1_signs[t]).sum()),
            finger_signs_differing=int((f_t != jrec.finger_signs[t]).sum())))

    samples = []
    for b in range(B):
        over = np.nonzero(gaps[:, b] > TOL)[0]
        if not len(over) and end_gap[b] <= TOL:
            continue
        t_over = int(over[0]) if len(over) else None
        firsts = {k: int(np.nonzero(d[:, b])[0][0]) for k, d in diff.items() if d[:, b].any()}
        first = min(firsts.items(), key=lambda kv: (kv[1], KINDS.index(kv[0]))) if firsts else None
        snapshot_differs = bool(kept_j[b] != kept_t[b])
        drift_grad_gap = None
        if first is not None and (t_over is None or first[1] < t_over):
            verdict = "choice first"
        elif t_over is None and snapshot_differs:
            verdict = "snapshot choice"
        else:
            # no choice differs before the sample leaves the bound: hold the
            # port's gradient to JAX's at JAX's params of the evaluation before
            t = max(t_over - 1, 0)
            r = max(i for i, s0 in enumerate(rebuilds) if s0 <= t) if rebuilds else None
            tpay = None if r is None else tuple(T(x) for x in (*jrec.tris[r], jrec.scales[r]))
            g_t = _port_at(tm, tb, stage, tentry, jrec.evals[t], tpay, hoist)[0]
            g_j = (jgrad or _jax_grad(jm, jb, stage))(jentry, jrec.evals[t], None if r is None else tuple(
                jnp.asarray(x) for x in (*jrec.tris[r], jrec.scales[r])))
            drift_grad_gap = max(float(np.abs(g_t[k][b] - np.asarray(g_j[k])[b]).max()) for k in groups) / max(
                max(float(np.abs(np.asarray(g_j[k])[b]).max()) for k in groups), 1e-30)
            verdict = ("drift: no choice differs and the gradients agree at JAX's params"
                       if drift_grad_gap <= SAME_PARAMS_GRAD_TOL else
                       "FAULT: left the bound before any choice differed, the gradients differ at JAX's params")
        s = dict(sample=b, first_eval_over_tol=t_over, end_gap=float(end_gap[b]), max_gap=float(gaps[:, b].max()),
                 first_choice=None if first is None else dict(kind=first[0], step=first[1],
                                                              count=int(diff[first[0]][first[1], b])),
                 gap_at_first_choice=None if first is None else float(gaps[first[1], b]),
                 first_step_by_kind=firsts, snapshot_jax=int(kept_j[b]), snapshot_port=int(kept_t[b]),
                 verdict=verdict, drift_grad_gap=drift_grad_gap)
        if first is not None and first[0] != "nearest-face pick":
            # the port at JAX's params of that evaluation, with JAX's payload
            t = first[1]
            r = max(i for i, s0 in enumerate(rebuilds) if s0 <= t) if rebuilds else None
            tpay = None if r is None else tuple(T(x) for x in (*jrec.tris[r], jrec.scales[r]))
            _, c_t, r_t, l1_t, f_t = _port_at(tm, tb, stage, tentry, jrec.evals[t], tpay, hoist)
            mine = {"contact set": c_t, "closest-point region": r_t, "L1 residual sign": l1_t,
                    "finger-prior sign": f_t}[first[0]]
            theirs = {"contact set": jrec.contacts, "closest-point region": jrec.regions,
                      "L1 residual sign": jrec.l1_signs, "finger-prior sign": jrec.finger_signs}[first[0]][t]
            s["same_params_choice_differs"] = int((mine[b] != theirs[b]).sum())
        samples.append(s)
    report = dict(
        stage="+".join(groups), steps=n, rebuilds=len(rebuilds),
        samples_over_tol_at_end=int((end_gap > TOL).sum()), samples_over_1e_4_at_end=int((end_gap > 1e-4).sum()),
        samples_over_tol_at_any_step=int((gaps > TOL).any(0).sum()), max_end_gap=float(end_gap.max()),
        samples_with_choice_differences={k: int((d > 0).any(0).sum()) for k, d in diff.items()},
        contacts_seen=int(sum(c.sum() for c in jrec.contacts)),
        faults=sum(s["verdict"].startswith("FAULT") for s in samples),
        rebuild_checks=rebuild_checks, samples=samples,
    )
    return report, jout


def _print_stage(r):
    print(f"stage {r['stage']} ({r['steps']} steps, {r['rebuilds']} rebuilds): samples above tol at the end "
          f"{r['samples_over_tol_at_end']} (above 1e-4 {r['samples_over_1e_4_at_end']}), at any step "
          f"{r['samples_over_tol_at_any_step']}; largest end gap {r['max_end_gap']:.3e}; samples whose choices "
          f"differ at some step {r['samples_with_choice_differences']}; faults {r['faults']}", flush=True)
    if r["rebuild_checks"]:
        rc = r["rebuild_checks"]
        print(f"  at JAX's params, every rebuild: gradient gap (relative to the largest entry) max "
              f"{max(c['grad_rel_gap'] for c in rc):.3e}; picks differing {[c['picks_differing'] for c in rc]}; "
              f"triangle gap where picks agree max {max(c['tri_gap_where_picks_agree'] for c in rc):.3e}; contact / "
              f"region / L1 / finger choices differing {[(c['contacts_differing'], c['regions_differing'], c['l1_signs_differing'], c['finger_signs_differing']) for c in rc]}")
    for s in r["samples"]:
        fc = s["first_choice"]
        fc_txt = "no choice differs" if fc is None else (
            f"first differing choice: {fc['kind']} at step {fc['step']} ({fc['count']}), gap there "
            f"{s['gap_at_first_choice']:.3e}" + (f", from JAX's params {s['same_params_choice_differs']} differ"
                                                 if "same_params_choice_differs" in s else ""))
        drift = "" if s["drift_grad_gap"] is None else f" (gradient gap at JAX's params {s['drift_grad_gap']:.3e})"
        print(f"  sample {s['sample']}: {s['verdict']}{drift}; first step above tol {s['first_eval_over_tol']}; {fc_txt}; "
              f"end gap {s['end_gap']:.3e} (max {s['max_gap']:.3e}); snapshot kept JAX {s['snapshot_jax']} / port "
              f"{s['snapshot_port']}")


def run_lockstep(batch, seed, hoist=True):
    """Every stage of ``opt_default`` in lockstep, each from JAX's result of
    the stage before -> the stages' reports."""
    jm, jp, jb = jax_inputs(batch, seed)
    tm, tb = synthetic_mano_model(device="cpu"), torch_batch(jb)
    entry = jax.tree_util.tree_map(np.asarray, jp)
    reports = []
    for stage in JS.opt_default:
        r, entry = lockstep_stage(jm, tm, entry, jb, tb, stage, check_unrecorded=True, hoist=hoist)
        _print_stage(r)
        reports.append(r)
    return reports


def test_losses_take_jax_derivatives_at_their_kinks():
    """An L1 residual, a shape difference or a finger-prior term exactly at 0
    in fp32: JAX's |x| has derivative +1 there and its min(0, x) splits the
    gradient in half; the port's losses give the same gradients, bit for
    bit, on inputs whose arithmetic is exact (small integers)."""
    from ihmr_tpu_torch.losses import losses as TL

    rng = np.random.RandomState(0)
    gt = rng.randint(-3, 4, (2, 42, 2)).astype(np.float32)
    pred = gt.copy()
    pred[:, ::3] += rng.randint(-2, 3, pred[:, ::3].shape)  # the rest of the residuals exactly 0
    weight = np.ones((2, 42, 1), np.float32)
    jg = jax.grad(lambda p: JL.joints_2d_loss(jnp.asarray(gt), p, jnp.asarray(weight))[0])(jnp.asarray(pred))
    tp = T(pred).requires_grad_(True)
    TL.joints_2d_loss(T(gt), tp, T(weight))[0].backward()
    np.testing.assert_array_equal(tp.grad.numpy(), np.asarray(jg))

    shape = rng.randint(-3, 4, (2, 20)).astype(np.float32)
    init = shape.copy()
    init[:, ::2] += 1.0
    jg = jax.grad(lambda x: JL.mano_shape_loss(jnp.asarray(init), x, jnp.ones((2, 1))) + JL.shape_residual_loss(
        x, jnp.asarray(init)))(jnp.asarray(shape))
    ts = T(shape).requires_grad_(True)
    (TL.mano_shape_loss(T(init), ts, torch.ones((2, 1))) + TL.shape_residual_loss(ts, T(init))).backward()
    np.testing.assert_array_equal(ts.grad.numpy(), np.asarray(jg))

    # every finger chain planar (C1 = 0) with its last two bones parallel (C2 = 0)
    joints = rng.randint(-3, 4, (2, 42, 3)).astype(np.float32)
    chain = np.array([[0, 0, 0], [1, 0, 0], [2, 1, 0], [3, 2, 0]], np.float32)
    joints[:, JL.FINGER_JOINT_IDXS] = np.tile(chain, (10, 1)) + rng.randint(-2, 3, (2, 1, 3))
    jg = jax.grad(lambda j: JL.finger_reg_loss(j)[0])(jnp.asarray(joints))
    tj = T(joints).requires_grad_(True)
    TL.finger_reg_loss(tj)[0].backward()
    c1, c2 = TL.finger_terms(T(joints))
    assert float(c1.abs().max()) == 0.0 and float(c2.abs().max()) == 0.0
    np.testing.assert_array_equal(tj.grad.numpy(), np.asarray(jg))


def test_orient_stage_in_lockstep_with_jax():
    """The orient stage (collision in the loop, the L1 2D residuals) at B=2,
    seed 0, 21 steps (a superblock and a one-step tail with its own payload),
    from ``make_opt_inputs``' params, one JAX compile: the queries meet the
    other hand's faces, no discrete choice differs, every step's params
    agree to 5e-5, the stage result too, and each side keeps the same
    snapshot."""
    jm, jp, jb = jax_inputs(2, 0)
    tm, tb = synthetic_mano_model(device="cpu"), torch_batch(jb)
    stage = dataclasses.replace(JS.opt_default[1], epoch=20)
    r, _ = lockstep_stage(jm, tm, jax.tree_util.tree_map(np.asarray, jp), jb, tb, stage, check_rebuilds=False)
    assert r["steps"] == 21 and r["rebuilds"] == 2 and r["contacts_seen"] > 0
    assert r["samples_with_choice_differences"] == {k: 0 for k in KINDS}, r
    assert r["samples_over_tol_at_any_step"] == 0 and r["max_end_gap"] <= TOL, r
    assert r["faults"] == 0 and not r["samples"]


if __name__ == "__main__":
    import argparse
    import time

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=None, help="torch CPU threads")
    ap.add_argument("--out", default=None, help="write the report as JSON here")
    ap.add_argument("--no_stage_hoist", action="store_true", help="run the port's full-decode engine instead")
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    reports = run_lockstep(args.batch, args.seed, hoist=not args.no_stage_hoist)
    verdicts = [s["verdict"] for r in reports for s in r["samples"]]
    kinds = [s["first_choice"]["kind"] if s["first_choice"] else "none" for r in reports for s in r["samples"]]
    summary = dict(batch=args.batch, seed=args.seed, tol=TOL, seconds=time.perf_counter() - t0,
                   verdicts={v: verdicts.count(v) for v in sorted(set(verdicts))},
                   first_choice_kinds={k: kinds.count(k) for k in sorted(set(kinds))})
    print(f"over the stages: {summary}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(summary, stages=reports), f, indent=1)
    print(json.dumps(summary), flush=True)
