"""Weighted-Voronoi-Tessellation particle regularisation
(reference wvt_relax.c:25-225, after Diehl+ 2012) — the benchmark hot loop.

Each iteration: (1) SPH density + adaptive hsml over the rebuilt block
structure, (2) relative error vs the analytic model density with the
reference's data-dependent early-stop / step-shrink heuristics (host-side
scalars), (3) a per-particle metric length from the model density globally
renormalised to unit box volume, (4) a kernel-weighted repulsion step with
periodic wrap.  Relaxation is done in units of the boxsize.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .. import constants as const
from ..ops import blocks as blk
from ..ops import stream as stream_ops
from ..particles import HaloArrays, Particles
from ..scene import Scene
from ..utils.logging import stage_log
from ..utils.memory import scaled
from . import sph as sph_mod

NUMITER = 64            # wvt_relax.c:7
ERRDIFF_LIMIT = 0.01    # wvt_relax.c:8
# The reference rebuilds its tree every iteration (TREEBUILDFREQUENCY=1,
# wvt_relax.c:6) because its neighbour lists are exact-radius.  Our
# candidate lists carry >=20% radius slack (sph._CAP_FACTOR, _SYM_MARGIN)
# while particles move <~1% of h per step, so the block/candidate
# structure is reused across iterations; correctness is guarded by the
# hsml cap: a particle whose h outgrows the build-time search radius is
# flagged `saturated`, which forces a rebuild.
import os as _os

REBUILD_EVERY = int(_os.environ.get("TOYCLUSTER_REBUILD_EVERY", 32))
# full-rebuild trigger on ACCUMULATED drift since the last sort (in
# units of the local metric h, max-lane): candidate-list refreshes keep
# pair coverage exact at _DRIFT_BUDGET granularity, so the only reason
# to re-sort is Hilbert-block compactness decay (swollen bboxes =>
# more streamed tiles).  Max-lane drift overstates the typical lane by
# ~5x, so 2.0 here means typical lanes moved ~0.4 h — where the
# tile inflation starts to cost more than a build.
# REBUILD_EVERY stays as a hard cadence cap (env-tunable).
_SORT_DRIFT_BUDGET = float(_os.environ.get(
    "TOYCLUSTER_SORT_DRIFT_BUDGET", "2.0"))
# chunk-refined skip bits (16-particle chunk-hull cross tests with
# per-receiver-chunk caps): strictly tighter than the member-bbox test
# (still conservative); False restores the block-bbox test
_CHUNK_BITS = True
# superblock-list compaction budget in candidate ELEMENTS (the copies
# cost 8 B/element); 0 disables compaction outright for memory-tight runs
_COMPACT_BUDGET = int(_os.environ.get(
    "TOYCLUSTER_COMPACT_BUDGET", str(1 << 27)))
_SYM_MARGIN = 1.1       # displacement-radius slack for inter-build drift
_FAC_MAX = 2.0          # cap-ratchet ceiling (see fac_gas note below)
# enforced inter-build drift budget: a pair's separation changes by at
# most 2*step*dmax_rel in units of the pair range 0.5*(hm_i+hm_j).
# What the budget must bound is NOT the _SYM_MARGIN slack (0.1) itself
# but the truncation ERROR of pairs that drift into range after the
# candidate lists were built: such a pair starts >= (slack - D) outside
# the support edge, so with cumulative drift D it ends at most
# u >= 1 - (D - 0.1) inside.  WC6 has 8th-order contact at u=1 —
# w(0.85) ~ 1e-5 of w(0) — so D = 0.25 keeps the missed weight orders
# below the |wkNgb-295| < 0.05 contract granularity (the displacement
# kernel shares the same soft edge).  The budget binds only for the
# 0.1-0.4 h outlier lanes (~6-8 iterations), i.e. at the same cadence
# as the scheduled REBUILD_EVERY; a max-lane accumulation tighter than
# this rebuilt EVERY iteration and cost 2x the whole bench.
#
# m4 (cubic spline) has only 3rd-order edge contact — w(0.85) ~ 7e-3,
# NOT negligible — so its budget stays strictly below the slack:
# D < 0.1 means no pair can enter the uncovered region AT ALL and
# structure reuse is exactly truncation-free (the REBUILD_EVERY=8 vs =1
# equivalence test runs m4 and asserts pid-matched positions).
_DRIFT_BUDGET = 0.25            # wc6
_DRIFT_BUDGET_HARD_EDGE = 0.09  # kernels without high-order contact


def _drift_budget(kernel):
    return _DRIFT_BUDGET if kernel == "wc6" else _DRIFT_BUDGET_HARD_EDGE
# effective solve/stream cap: the skip bits stream every block within
# the row's cap, so streamed volume scales with (cap/h)^3 — the build
# cap carries 1.2-2x slack (fac ratchet) purely for list coverage.
# Solving against min(build_cap, margin*h_warm) instead prunes that
# slack exactly (bits remain exact for any h <= cap_eff); lanes that
# genuinely outgrow the margin saturate and re-enter via the existing
# retry/accept machinery with h_prev = the clamped h, gaining another
# margin factor per pass.  Cold lanes (no warm h) keep the wider slack.
# default 1.02: the cap-slack lever saturates near there, where the
# block/chunk hull geometry takes over.  Tighter margins trade a few
# accept-band clamps per iteration (self-healing, final clean solve
# unaffected) for less kernel volume; the adaptive escalation
# (margin_warm) still lifts it on retry-prone configs.
_BITS_MARGIN_WARM = float(_os.environ.get(
    "TOYCLUSTER_BITS_MARGIN_WARM", "1.02"))
_BITS_MARGIN_COLD = 1.25


def _accept_band(n_gas, it=None):
    """Saturated-lane count below which the loop accepts the capped h
    for this iteration instead of rebuilding (the reference's
    NGBMAX-truncation role, globals.h:50).

    The band is WIDE (2%) for the first iterations: at a cold-started
    1e7 merger ~1% of lanes (sparse outskirts) saturate the model-cap
    at it=0-1 and used to trigger two full rebuild storms — failed
    solves plus freshly-minted program shapes, ~60-100 s — before
    ratcheting to the same capped state the band now accepts outright.
    Accepted lanes self-heal: the accept path ratchets their cap 1.6x
    per iteration, and everything is still moving O(h) per step that
    early.  From it=3 the tight steady-state band guards the contract."""
    base = max(32, n_gas // 20_000)
    if it is not None and it < 3:
        return max(base, n_gas // 50)
    return base


@jax.jit
def _error_stats(rho_sph, rho_model):
    err = jnp.abs(rho_sph - rho_model) / rho_model
    return err.max(), err.mean()


def _metric_hsml(rho_model, mpart, desnngb):
    """h_i = (NNGB m / rho / (4pi/3))^(1/3), renormalised so the total
    kernel volume matches the unit box (wvt_relax.c:108-124)."""
    return _model_fields_from_rho(rho_model, mpart, desnngb)[2]


def _model_fields_from_rho(rho_model, mpart, desnngb):
    """(rho_model, h0_model, h_box) with ONE cube root per particle:
    h0_model is the unrenormalised metric base, h_box the box-volume
    renormalised metric (wvt_relax.c:108-124); the kernel-volume sum is
    taken over the base (no cube of a cube root)."""
    base = desnngb * mpart / rho_model / const.FOURPITHIRD
    h0_model = base ** (1.0 / 3.0)
    h_box = h0_model * (desnngb / base.sum()
                        / const.FOURPITHIRD) ** (1.0 / 3.0)
    return rho_model, h0_model, h_box


@jax.jit
def _move(pos_gas, delta_box, boxsize):
    pos = pos_gas + delta_box * boxsize
    return pos - jnp.floor(pos / boxsize) * boxsize


def _warm_ratio(rho_model, rho_model_prev):
    """Model-ratio warm-start predictor: the converged h tracks the
    metric base h0_model ∝ rho_model^(-1/3), so after a WVT move the
    previous iteration's solved h is corrected by
    (rho_model(old pos)/rho_model(new pos))^(1/3) — measured 8x
    tighter |wkNgb - DESNNGB| at the sweep-0 measurement (p50 26 ->
    3.2 on a 6k m4/50 relaxation), which both cuts Newton sweeps and
    lets the stream kernel's speculative accept fire on the first
    pass.  Takes the MODEL DENSITIES (the loop already retains the
    previous iteration's rho_model, so the predictor costs no standing
    memory at 1e8).  Clipped: pathological lanes must not fling the
    solve outside its bracket."""
    ratio = jnp.where(
        rho_model_prev > 0,
        (rho_model_prev / jnp.maximum(rho_model, 1e-30)) ** (1.0 / 3.0),
        1.0)
    return jnp.clip(ratio, 1.0 / 1.5, 1.5)


# -------------------------------------------------------------------------
# Whole-iteration jit: model density, metric, per-class fused kernels,
# scatters, error stats and saturation count compile into ONE program —
# the host dispatches once per iteration instead of ~15 separate calls.
# Class receiver ids ride as dynamic args (quantized sizes keep the jit
# signature stable across rebuilds).
# -------------------------------------------------------------------------

_ITER_FN_CACHE: dict = {}


_LARGE_N = 8_000_000  # gas count at 16 GiB of device memory (scaled to
#                       the device) above which the iteration runs as
#                       jitted prologue/epilogue + host-slabbed stream
#                       calls: one mega-program outgrows the memory


def _make_large_iter_fn(n_gas, n_padded, mpart, boxsize, desnngb,
                        kernel, cool_core, beta=None, interpret=False):
    """Large-N WVT iteration: same signature/results as the mega-jit
    iter_fn, but the stream kernel runs per receiver-row slab as its own
    dispatch so peak device memory scales with the slab, not the
    particle count.  A few extra dispatches are noise against the tens
    of seconds such an iteration takes."""
    nb = n_padded // blk.BLOCK
    pad = n_padded - n_gas
    _SLAB = 65536

    @jax.jit
    def prologue(pos_gas, h_prev, rhom_prev, h_cap_pad, sat_mask, ha,
                 n_gas_d, margin_w):
        rho_model, h0_model, h_box = _model_fields_from_rho(
            sph_mod.global_density_model(pos_gas, ha, boxsize,
                                         cool_core, beta=beta),
            mpart, desnngb)
        h0 = jnp.where(h_prev > 0, h_prev * _warm_ratio(
            rho_model, rhom_prev), h0_model)

        def pad1(x):
            if pad == 0:
                return x
            return jnp.concatenate(
                [x, jnp.broadcast_to(x[-1:], (pad,) + x.shape[1:])])

        pos_pad = (pos_gas if pad == 0 else jnp.concatenate(
            [pos_gas, jnp.broadcast_to(pos_gas[-1], (pad, 3))]))
        valid = jnp.arange(n_padded) < n_gas_d
        h0_s = pad1(h0)
        hm_s = pad1(h_box)
        # effective solve/stream cap (see _BITS_MARGIN_*); lanes flagged
        # in sat_mask (saturated on the previous attempt) get the FULL
        # build cap — the margin clamp would otherwise grow them only
        # 1.1x per rebuild attempt (measured at 1e8: n_sat fell 35%/
        # attempt and burned through _MAX_REBUILDS).  margin_w is the
        # HOST-FED adaptive warm margin (see the loop): it escalates
        # when retries trip so the steady state pays streamed volume,
        # not double solves
        margin = jnp.where(pad1(h_prev > 0), margin_w,
                           _BITS_MARGIN_COLD)
        cap_eff_pad = jnp.where(
            pad1(sat_mask),
            h_cap_pad, jnp.minimum(h_cap_pad, h0_s * margin))
        hm_src = jnp.where(valid, hm_s, 0.0)
        pos_t = pos_pad.reshape(nb, blk.BLOCK, 3).transpose(0, 2, 1)
        src = jnp.concatenate(
            [pos_t, hm_src.reshape(nb, 1, blk.BLOCK)], axis=1)
        pos_b = pos_pad.reshape(nb, blk.BLOCK, 3)
        # NB pos_t is NOT returned: receiver coords come from src slabs
        # (one less particle-sized standing array)
        return (rho_model, hm_s, h0_s.reshape(nb, blk.BLOCK),
                hm_s.reshape(nb, blk.BLOCK), src,
                pos_b.min(axis=1), pos_b.max(axis=1),
                hm_src.reshape(nb, blk.BLOCK).max(axis=1),
                cap_eff_pad)

    @jax.jit
    def epilogue(pos_gas, rho, hsml, vf, delta, rho_model, hm_s,
                 h_cap_pad, cap_eff_pad, done_f, fac_gas, n_gas_d,
                 step, err_last, it_d):
        valid = jnp.arange(n_padded) < n_gas_d
        done = done_f > 0.5
        still_growable = h_cap_pad < sph_mod.hard_h_cap(
            boxsize, n_gas) * 0.999
        saturated = (~done) | (hsml >= cap_eff_pad * 0.999)
        growable = fac_gas < _FAC_MAX * 0.999
        gpad = jnp.concatenate(
            [growable, jnp.zeros((pad,), bool)]) if pad else growable
        n_sat = jnp.where(valid & saturated & still_growable & gpad,
                          1, 0).sum()
        err = jnp.abs(rho[:n_gas] - rho_model) / rho_model
        drel = jnp.where(valid,
                         jnp.linalg.norm(delta, axis=1)
                         / jnp.maximum(hm_s, 1e-30), 0.0)
        dmax_rel = jnp.max(drel)
        row_drel = drel.reshape(-1, blk.BLOCK).max(axis=1)
        p999_rel = jnp.percentile(row_drel, 99.9)
        err_mean = err.mean()
        err_diff = (err_last - err_mean) / err_mean
        step_new = jnp.where((err_diff < 0.01) & (it_d > 1),
                             step * 0.8, step)
        pos_new = pos_gas + delta[:n_gas] * (step_new * boxsize)
        pos_new = pos_new - jnp.floor(pos_new / boxsize) * boxsize
        # accept-path cap ratchet on device (see _get_iter_fn epilogue)
        band = jnp.where(it_d < 3,
                         jnp.int32(_accept_band(n_gas, 0)),
                         jnp.int32(_accept_band(n_gas)))
        accept = (n_sat > 0) & (n_sat <= band)
        fac_new = jnp.where(
            accept & (hsml[:n_gas] >= h_cap_pad[:n_gas] * 0.999),
            jnp.minimum(fac_gas * 1.6, _FAC_MAX), fac_gas)
        return (rho[:n_gas], hsml[:n_gas], vf[:n_gas], pos_new,
                rho_model, err.max(), err_mean, n_sat, dmax_rel,
                p999_rel, step_new, fac_new, saturated[:n_gas])

    def iter_fn(pos_gas, h_prev, rhom_prev, h_cap_pad, sat_mask,
                margin_w, cand_idx, count, class_ids, tail, ha,
                fac_gas, n_gas_d, step, err_last, it_d):
        (rho_model, hm_s, h0_b, hm_b, src,
         bb_lo, bb_hi, bhm, cap_eff_pad) = prologue(
            pos_gas, h_prev, rhom_prev, h_cap_pad, sat_mask, ha,
            n_gas_d, margin_w)
        cap_b = cap_eff_pad.reshape(nb, blk.BLOCK)
        cnt_all = jnp.minimum(count, cand_idx.shape[1])
        ctab = (stream_ops.build_chunk_tab(src[:, :3, :], src[:, 3, :])
                if _CHUNK_BITS else None)
        outs = [[] for _ in range(5)]  # rho, h, vf, done, delta
        for s0 in range(0, nb, _SLAB):
            s1 = min(s0 + _SLAB, nb)
            ids = jnp.arange(s0, s1, dtype=jnp.int32)
            bits, safe = stream_ops.stream_skip_bits(
                bb_lo, bb_hi, bhm, ids, cand_idx[s0:s1],
                cap_b[s0:s1], hm_b[s0:s1], float(boxsize), sb=True,
                chunk_tab=ctab)
            rho_s, h_s2, vf_s, _wk, done_s, delta_s = stream_ops.stream_wvt(
                src, cand_idx[s0:s1], cnt_all[s0:s1],
                src[s0:s1, :3, :], h0_b[s0:s1], cap_b[s0:s1],
                hm_b[s0:s1], float(mpart), float(boxsize),
                kernel=kernel, desnngb=desnngb,
                sb_mode=True, bits=bits, safe=safe, interpret=interpret)
            for o, r in zip(outs, (rho_s, h_s2, vf_s, done_s, delta_s)):
                o.append(r)
        rho, hsml, vf, done, delta = (jnp.concatenate(o) for o in outs)
        return epilogue(pos_gas, rho.reshape(-1), hsml.reshape(-1),
                        vf.reshape(-1), delta.reshape(-1, 3), rho_model,
                        hm_s, h_cap_pad, cap_eff_pad,
                        done.reshape(-1).astype(jnp.float32), fac_gas,
                        n_gas_d, step, err_last, it_d)

    return iter_fn


def _get_iter_fn(class_shape, n_gas, n_padded, mpart, boxsize, desnngb,
                 kernel, cool_core, engine, tail_shape=None, beta=None):
    from ..ops import pair_ops

    # _CHUNK_BITS is read at trace time inside iter_fn; key on the
    # current value so an in-process A/B flip cannot reuse a stale trace
    key = (class_shape, n_gas, n_padded, mpart, boxsize, desnngb, kernel,
           cool_core, engine, tail_shape, beta, _CHUNK_BITS)
    if key in _ITER_FN_CACHE:
        return _ITER_FN_CACHE[key]
    stream = sph_mod.is_stream(engine)
    interpret = engine == "stream_interpret"

    if stream and n_gas > scaled(_LARGE_N):
        fn = _make_large_iter_fn(n_gas, n_padded, mpart, boxsize,
                                 desnngb, kernel, cool_core, beta=beta,
                                 interpret=interpret)
        _ITER_FN_CACHE[key] = fn
        return fn

    nb = n_padded // blk.BLOCK
    pad = n_padded - n_gas

    @jax.jit
    def iter_fn(pos_gas, h_prev, rhom_prev, h_cap_pad, sat_mask,
                margin_w, cand_idx, count, class_ids, tail, ha,
                fac_gas, n_gas_d, step, err_last, it_d):
        # n_gas_d: DYNAMIC scalar — a static bound would constant-fold
        # the (n_padded,) iota comparison in the XLA compiler (minutes
        # at 1e7; see positions._census_counts)
        growable = fac_gas < _FAC_MAX * 0.999
        rho_model, h0_model, h_box = _model_fields_from_rho(
            sph_mod.global_density_model(pos_gas, ha, boxsize,
                                         cool_core, beta=beta),
            mpart, desnngb)
        h0 = jnp.where(h_prev > 0, h_prev * _warm_ratio(
            rho_model, rhom_prev), h0_model)

        def pad1(x):
            if pad == 0:
                return x
            return jnp.concatenate(
                [x, jnp.broadcast_to(x[-1:], (pad,) + x.shape[1:])])

        pos_pad = (pos_gas if pad == 0 else jnp.concatenate(
            [pos_gas, jnp.broadcast_to(pos_gas[-1], (pad, 3))]))
        valid = jnp.arange(n_padded) < n_gas_d
        h0_s = pad1(h0)
        hm_s = pad1(h_box)

        pos_t = pos_pad.reshape(nb, blk.BLOCK, 3).transpose(0, 2, 1)
        hm_src = jnp.where(valid, hm_s, 0.0)
        hm_blocks = hm_src.reshape(nb, 1, blk.BLOCK).astype(jnp.float32)
        h0_b = h0_s.reshape(nb, blk.BLOCK)
        hm_b = hm_s.reshape(nb, blk.BLOCK)
        if stream:
            # effective cap (see _BITS_MARGIN_*): streamed volume scales
            # with (cap/h)^3, so solve against a tight margin over the
            # warm h instead of the slack-laden build cap.  Lanes in
            # sat_mask (saturated last attempt) get the full build cap;
            # margin_w is the host-fed adaptive warm margin — see the
            # large-path prologue note.
            margin = jnp.where(pad1(h_prev > 0), margin_w,
                               _BITS_MARGIN_COLD)
            cap_eff_pad = jnp.where(
                pad1(sat_mask),
                h_cap_pad, jnp.minimum(h_cap_pad, h0_s * margin))
        else:
            cap_eff_pad = h_cap_pad
        cap_b = cap_eff_pad.reshape(nb, blk.BLOCK)

        outs = [jnp.zeros((n_padded,), jnp.float32) for _ in range(5)]
        outs.append(jnp.zeros((n_padded, 3), jnp.float32))
        if stream:
            # stream kernel: ONE superblock-granular call over every
            # receiver row with dynamic per-row trip counts — no count
            # classes, no padded grid steps, no far-tail special case,
            # one program shape per list width.  cand_idx holds
            # SUPERBLOCK ids (sph._build_neighbours_sb); the skip bits
            # re-test each member block against CURRENT positions every
            # iteration (median per-iteration drift is 1-10% of h, so
            # build-time pruning would need ruinous margins).
            src_blocks = jnp.concatenate([pos_t, hm_blocks], axis=1)
            cnt_all = jnp.minimum(count, cand_idx.shape[1])
            pos_b = pos_pad.reshape(nb, blk.BLOCK, 3)
            bb_lo = pos_b.min(axis=1)
            bb_hi = pos_b.max(axis=1)
            bhm = hm_src.reshape(nb, blk.BLOCK).max(axis=1)
            bucket_widths = (tuple(w for _, w in class_shape[1:])
                             if class_shape else None)
            # chunk cross test: 16-particle chunk hulls both sides +
            # per-receiver-chunk caps close most of the block-bbox
            # slack, cutting the kernel's computed tiles
            ctab = (stream_ops.build_chunk_tab(pos_t, hm_src.reshape(
                nb, blk.BLOCK)) if _CHUNK_BITS else None)
            bits, safe = stream_ops.stream_skip_bits(
                bb_lo, bb_hi, bhm, jnp.arange(nb, dtype=jnp.int32),
                cand_idx, cap_b, hm_b, float(boxsize), sb=True,
                bucket_ids=(tuple(class_ids) if class_shape else None),
                bucket_widths=bucket_widths, chunk_tab=ctab)
            # compact each row's list to the superblocks the kernel will
            # actually touch (the bits already encode this).
            # Budget-gated: the compacted copies (cand_it + pos_it)
            # double the width-proportional live memory, which the
            # largest configs cannot spare for a small kernel win
            # (TOYCLUSTER_COMPACT_BUDGET elements; 0 disables it).
            if cand_idx.shape[0] * cand_idx.shape[1] <= _COMPACT_BUDGET:
                cand_it, pos_it, cnt_it = stream_ops.compact_sb_lists(
                    cand_idx, cnt_all, bits, do_disp=True)
            else:
                cand_it, pos_it, cnt_it = cand_idx, None, cnt_all
            rho, h, vf, wk, done, delta = stream_ops.stream_wvt(
                src_blocks, cand_it, cnt_it, pos_t, h0_b, cap_b,
                hm_b, float(mpart), float(boxsize),
                kernel=kernel, desnngb=desnngb, sb_mode=True,
                bits=bits, safe=safe, cand_pos=pos_it,
                interpret=interpret)
            outs = [rho.reshape(-1), h.reshape(-1), vf.reshape(-1),
                    wk.reshape(-1), done.reshape(-1).astype(jnp.float32),
                    delta.reshape(-1, 3)]
        else:
            for (m, s_rows), ids in zip(class_shape, class_ids):
                idc = jnp.maximum(ids, 0)
                rows = cand_idx[idc][:, :m]
                rows = jnp.where((ids >= 0)[:, None], rows, -1)
                cnt = jnp.where(ids >= 0, count[idc], 0)
                bi = blk.BlockIndex(
                    order=jnp.arange(n_padded, dtype=jnp.int32),
                    pos=pos_pad, valid=valid,
                    bb_lo=jnp.zeros((nb, 3)), bb_hi=jnp.zeros((nb, 3)),
                    sb_lo=jnp.zeros((1, 3)), sb_hi=jnp.zeros((1, 3)))
                sel = pair_ops.BlockSelection(ids=ids, cand=rows)
                res = pair_ops.solve_density(
                    bi, sel, h0_s, h_cap_pad, mpart, boxsize,
                    kernel=kernel, desnngb=desnngb)
                delta = pair_ops.wvt_displacement(
                    bi, sel, hm_s, 1.0, boxsize, kernel=kernel)
                res_list = [res.rho, res.hsml, res.var_hsml_fac,
                            res.wk_ngb, res.done.astype(jnp.float32),
                            delta]
                pidx = (idc[:, None] * blk.BLOCK
                        + jnp.arange(blk.BLOCK,
                                     dtype=jnp.int32)).reshape(-1)
                pidx = jnp.where(jnp.repeat(ids >= 0, blk.BLOCK), pidx,
                                 n_padded)
                for k, r in enumerate(res_list):
                    outs[k] = outs[k].at[pidx].set(r, mode="drop")

        if tail_shape is not None:
            # far-tail rows (XLA engine): superblock-granular lists
            # expanded to member blocks
            t_ids, sb_rows, sb_cnt = tail
            idc = jnp.maximum(t_ids, 0)
            if stream:
                raise RuntimeError(
                    "superblock builds carry no far-tail rows")
            else:
                bi = blk.BlockIndex(
                    order=jnp.arange(n_padded, dtype=jnp.int32),
                    pos=pos_pad, valid=valid,
                    bb_lo=jnp.zeros((nb, 3)), bb_hi=jnp.zeros((nb, 3)),
                    sb_lo=jnp.zeros((1, 3)), sb_hi=jnp.zeros((1, 3)))
                from ..models.sph import expand_tail_rows
                sel = pair_ops.BlockSelection(
                    ids=t_ids, cand=expand_tail_rows(sb_rows, nb))
                res = pair_ops.solve_density(
                    bi, sel, h0_s, h_cap_pad, mpart, boxsize,
                    kernel=kernel, desnngb=desnngb)
                dlt = pair_ops.wvt_displacement(
                    bi, sel, hm_s, 1.0, boxsize, kernel=kernel)
                res_list = [res.rho, res.hsml, res.var_hsml_fac,
                            res.wk_ngb, res.done.astype(jnp.float32),
                            dlt]
            pidx = (idc[:, None] * blk.BLOCK
                    + jnp.arange(blk.BLOCK, dtype=jnp.int32)).reshape(-1)
            pidx = jnp.where(jnp.repeat(t_ids >= 0, blk.BLOCK), pidx,
                             n_padded)
            for k, r in enumerate(res_list):
                outs[k] = outs[k].at[pidx].set(r, mode="drop")

        rho, hsml, vf, wk, done_f, delta = outs
        done = done_f > 0.5
        # saturation against the cap the solver actually used: lanes
        # clamped at the warm-h margin self-heal next iteration (their
        # h_prev moves to the clamped h, buying another margin factor)
        still_growable = h_cap_pad < sph_mod.hard_h_cap(
            boxsize, n_gas) * 0.999
        saturated = (~done) | (hsml >= cap_eff_pad * 0.999)
        n_sat = jnp.where(valid & saturated & still_growable
                          & pad1(growable), 1, 0).sum()

        err = jnp.abs(rho[:n_gas] - rho_model) / rho_model
        # worst per-particle displacement in units of the local metric
        # hsml (pre-step) — a drift diagnostic (median is 1-10% of h per
        # iteration, which is why skip bits are recomputed every pass)
        drel = jnp.where(valid,
                         jnp.linalg.norm(delta, axis=1)
                         / jnp.maximum(hm_s, 1e-30), 0.0)
        dmax_rel = jnp.max(drel)
        # p99.9 of the PER-BLOCK max drift: the pair-coverage budget
        # only needs d_i + d_j bounded per pair, and a block's max
        # bounds every lane in it — 2x this covers all pairs not
        # touching a top-0.1% mover block (see _DRIFT_BUDGET notes)
        row_drel = drel.reshape(-1, blk.BLOCK).max(axis=1)
        p999_rel = jnp.percentile(row_drel, 99.9)
        # step shrink + speculative move ON DEVICE (wvt_relax.c:94-101
        # ordering): the loop fetches ONE batch of scalars per iteration
        # and either adopts pos_new or discards it (stop / rebuild)
        err_mean = err.mean()
        err_diff = (err_last - err_mean) / err_mean
        step_new = jnp.where((err_diff < 0.01) & (it_d > 1),
                             step * 0.8, step)
        pos_new = pos_gas + delta[:n_gas] * (step_new * boxsize)
        pos_new = pos_new - jnp.floor(pos_new / boxsize) * boxsize
        # accept-path cap ratchet ON DEVICE (mirrors the host accept
        # branch) so the loop can speculatively dispatch it+1 before
        # fetching this iteration's n_sat: for n_sat in the accept band
        # the only state change is fac_gas, now pre-applied here
        band = jnp.where(it_d < 3,
                         jnp.int32(_accept_band(n_gas, 0)),
                         jnp.int32(_accept_band(n_gas)))
        accept = (n_sat > 0) & (n_sat <= band)
        fac_new = jnp.where(
            accept & (hsml[:n_gas] >= h_cap_pad[:n_gas] * 0.999),
            jnp.minimum(fac_gas * 1.6, _FAC_MAX), fac_gas)
        return (rho[:n_gas], hsml[:n_gas], vf[:n_gas], pos_new,
                rho_model, err.max(), err_mean, n_sat, dmax_rel,
                p999_rel, step_new, fac_new, saturated[:n_gas])

    _ITER_FN_CACHE[key] = iter_fn
    return iter_fn


def regularise_sph_particles(scene: Scene, ha: HaloArrays,
                             parts: Particles, *, log=stage_log,
                             checkpoint_path: str | None = None,
                             checkpoint_every: int = 16,
                             return_fresh: bool = False,
                             engine: str | None = None):
    """`checkpoint_path` enables WVT checkpoint/resume (absent in the
    reference — SURVEY.md §5): loop state (gas positions, step, error
    history, iteration) is saved as NPZ every `checkpoint_every`
    iterations and restored on restart.

    With `return_fresh`, returns (parts, fresh): fresh=True means the
    loop stopped WITHOUT applying a final move, so parts.rho/hsml/
    var_hsml_fac already hold the full-contract density solve at the
    final positions — the pipeline's find_sph_quantities stage is then
    redundant (the reference always re-runs it, main.c:52; we skip).

    `parts` may arrive as a ONE-ELEMENT LIST (holder): the caller
    dropped its own reference so that large-N runs can release the
    particle buffers the loop never reads (see the offload note below).

    `engine` defaults to the backend's (ops.stream.pair_engine)."""
    import numpy as _np
    import os as _os

    if isinstance(parts, list):
        parts = parts.pop()
    cfg = scene.config
    n_gas = parts.n_gas
    if n_gas == 0:
        return (parts, False) if return_fresh else parts
    boxsize = scene.boxsize
    mpart = scene.mpart_gas
    desnngb = cfg.desnngb
    cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                 if cfg.double_beta_cool_cores else None)
    beta_u = sph_mod.uniform_beta(scene)

    # step size (wvt_relax.c:48-56)
    if cfg.sph_kernel == "m4":
        step = 0.035
    else:
        step = 0.0085
        if scene.mtotal < 1e5:
            step /= 2.0

    err_last = math.inf
    err_diff_last = math.inf
    max_iter = min(cfg.wvt_max_iter, NUMITER)
    err_limit = cfg.wvt_err_diff_limit
    it0 = 0

    # ---- gas-local loop state --------------------------------------
    # The loop works on GAS-ONLY arrays and accumulates the Hilbert
    # permutation across builds (order_acc), applying it to the full
    # particle set ONCE at the end: per-build permute_gas (eleven
    # particle-count gathers) and the per-iteration full-pos scatter
    # copied ~4 GB per iteration at 1e8-total scenes and pushed the
    # standing memory over the device's.
    pos_gas = jnp.array(parts.pos[:n_gas])
    h_prev = jnp.array(parts.hsml[:n_gas])
    # ---- large-N device-memory offload -------------------------------
    # Through the whole relaxation the loop reads ONLY pos[:n_gas] and
    # hsml[:n_gas] (both copied above).  At 1e8 total particles the
    # remaining Particles fields pin ~3 GB of device memory doing nothing:
    # pid+halo (0.8 GB, needed only for the final permute — parked on
    # host), the DM half of pos (0.6 GB, kept device-side untouched),
    # and five all-zero gas fields (1 GB, recreated afterwards: u is
    # first written by the temperature stage, rho/hsml/var_hsml_fac/
    # rho_model are installed from the loop results).  The caller must
    # pass `parts` via the holder-list protocol for the buffers to
    # actually free (a plain argument stays pinned by the caller frame).
    # (the threshold is sized for 16 GiB of device memory and scaled to
    # the device; TOYCLUSTER_WVT_OFFLOAD_N sets it outright)
    offload = n_gas >= int(_os.environ.get(
        "TOYCLUSTER_WVT_OFFLOAD_N", str(scaled(20_000_000))))
    if offload:
        n_total_off = parts.n_total
        pid_h = _np.array(parts.pid)    # np.array: device->host COPY
        halo_h = _np.array(parts.halo)  # (asarray views are read-only)
        pos_dm_dev = jnp.array(parts.pos[n_gas:])
        vel_off, bfld_off, apot_off = parts.vel, parts.bfld, parts.apot
        parts = None
    # model density at each particle's PREVIOUS position (see
    # _warm_ratio); 0 = no prediction (cold start / checkpoint resume).
    # Aliased to the retained rho_model_l after each iteration, so the
    # predictor costs no standing memory.
    rhom_prev = jnp.zeros((n_gas,), jnp.float32)
    order_acc = jnp.arange(n_gas, dtype=jnp.int32)
    rho_l = hsml_l = vf_l = rho_model_l = None

    if checkpoint_path and _os.path.exists(checkpoint_path):
        ck = _np.load(checkpoint_path)
        pos_gas = jnp.asarray(ck["pos_gas"])
        step = float(ck["step"])
        err_last = float(ck["err_last"])
        err_diff_last = float(ck["err_diff_last"])
        it0 = int(ck["it"]) + 1
        log("wvt_resume", it=it0, step=step)

    state = None
    its_since_build = 0
    drift_acc = 0.0        # since the last candidate refresh OR build
    sort_drift_acc = 0.0   # since the last full (re-sorting) build
    iter_fn = None
    class_ids = None
    engine = engine or stream_ops.pair_engine()
    stream = sph_mod.is_stream(engine)
    fresh = False
    # persistent per-particle cap factor (loop order, permuted at each
    # build): lanes whose h keeps growing >20% per iteration (sparse
    # outskirts of merger configs) would otherwise saturate and force a
    # rebuild + re-solve EVERY iteration once the rebuild resets their
    # cap to 1.2x h_prev.  With the skip bits pruning the density tiles
    # to the actual h, a ratcheted cap costs only list width, not flops.
    # Runaway guard: past _FAC_MAX a lane accepts the cap-clamped h —
    # the reference's NGBMAX=2360 list cap (globals.h:50) role.
    fac_gas = jnp.full((n_gas,), sph_mod._CAP_FACTOR, jnp.float32)
    # cold-start cap boost for the sparse tail: at a 1e7 merger, ~1% of
    # lanes (the rcut-taper outskirts, where the local model rho badly
    # underestimates the h that reaches back into the bulk) saturate
    # the 1.2x model cap and ratchet to _FAC_MAX over TWO rebuild
    # storms at it=0/1 — each a full failed solve plus new program
    # shapes.  Boosting the
    # top-2% metric-h lanes straight to the ratchet's endpoint skips
    # the storms; warm resumes (h_prev > 0) never take this path.
    if not bool((h_prev > 0).any()):
        rho0_m = sph_mod.global_density_model(
            pos_gas, ha, boxsize, cool_core, beta=beta_u)
        h0m = (desnngb * mpart / rho0_m
               / const.FOURPITHIRD) ** (1.0 / 3.0)
        fac_gas = jnp.where(
            h0m > jnp.percentile(h0m, 98.0), _FAC_MAX,
            sph_mod._CAP_FACTOR).astype(jnp.float32)
        del rho0_m, h0m
    # margin-clamp lift mask (all-False on the normal path): lanes that
    # saturated on a rebuild attempt solve against the FULL build cap on
    # the retry instead of crawling up at _BITS_MARGIN_WARM per attempt
    sat_false = jnp.zeros((n_gas,), bool)
    # host-feedback adaptive warm margin: every retry means the 1.1
    # clamp mispredicted enough lanes to cost a rebuild + double solve
    # (about two iterations' work), so the
    # margin escalates 1.15x per trip (streamed volume rises only
    # (1.15)^3 = 1.5x for the escalation) and decays after 8 quiet
    # iterations.  1e6-scale runs never trip it and stay at 1.1.
    margin_warm = _BITS_MARGIN_WARM
    quiet_iters = 0

    # one-deep speculative pipeline: iteration it+1 is dispatched with
    # it's DEVICE outputs (pos_new, hsml, fac_new, step_new, err_mean)
    # before it's scalars are fetched, hiding the host round trip plus
    # all host-side python behind device compute.  The
    # speculation is exact for the n_sat==0 and accept paths (the cap
    # ratchet moved into iter_fn); a rebuild or stop discards the
    # in-flight result.  Scheduled rebuilds are predicted from
    # its_since_build; drift rebuilds from drift_acc + the last
    # increment, so true mispredictions are rare.
    pending = None     # (it, outputs) dispatched with the current state
    drift_inc_last = 0.0
    # the in-flight output tuple pins ~24 B/particle of device memory —
    # free at 1e6, meaningful at 5e7 on 16 GiB — so speculation is
    # capped by size (scaled to the device's memory)
    speculate = (int(_os.environ.get("TOYCLUSTER_SPECULATE", "1"))
                 and n_gas <= scaled(20_000_000))
    drift_budget = _drift_budget(cfg.sph_kernel)

    for it in range(it0, max_iter + 1):
        # ONE neighbour structure serves the density solve AND the
        # displacement pass (the reference builds one tree per iteration
        # and walks it twice, wvt_relax.c:66-171); the structure is
        # reused across REBUILD_EVERY iterations
        if (its_since_build >= REBUILD_EVERY
                or sort_drift_acc > _SORT_DRIFT_BUDGET
                or (state is not None and state.tail is not None)):
            state = None
            pending = None
        elif drift_acc > drift_budget and state is not None:
            # accumulated drift spent the candidate lists' slack: the
            # sort/membership stays valid (the skip bits and prologue
            # bboxes track current positions anyway) — refresh ONLY
            # the candidate lists, at ~1/4 the full-build cost and
            # with unchanged program shapes.  Outlier lanes trip this
            # every ~2 iterations at 1e6.
            if state.sb and stream and rho_model_l is not None:
                hm_w = (_metric_hsml(rho_model_l, mpart, desnngb)
                        * boxsize * _SYM_MARGIN)
                state = sph_mod.refresh_candidates(
                    state, pos_gas, hm_w, boxsize)
                b_ids, b_widths = state.buckets
                class_shape = ("bits",) + tuple(
                    (ids.shape[0], w)
                    for ids, w in zip(b_ids, b_widths))
                class_ids = b_ids
                iter_fn = _get_iter_fn(
                    class_shape, n_gas, state.index.n_padded,
                    float(mpart), float(boxsize), desnngb,
                    cfg.sph_kernel, cool_core, engine,
                    tail_shape=None, beta=beta_u)
                drift_acc = 0.0
                pending = None
                log("wvt_refresh", it=it, max_cand=state.max_cand,
                    classes=class_shape)
            else:
                state = None
                pending = None

        grow_mask = None   # per-particle: only saturated lanes get the
        #                    grown cap, so windows stay tight
        sat_mask = sat_false   # margin-clamp lift for retry attempts
        accept_note = None     # deferred wvt_accept marker (logged after
        #                        the wvt event so interval-attributing
        #                        profilers book the iteration compute to
        #                        "wvt", not to the accept marker)
        for attempt in range(sph_mod._MAX_REBUILDS + 1):
            if state is None:
                rho_model, h0_model, h_box = _model_fields_from_rho(
                    sph_mod.global_density_model(
                        pos_gas, ha, boxsize, cool_core, beta=beta_u),
                    mpart, desnngb)
                h0 = jnp.where(h_prev > 0, h_prev, h0_model)
                if grow_mask is not None:
                    fac_gas = jnp.where(grow_mask,
                                        jnp.minimum(fac_gas * 1.6,
                                                    _FAC_MAX),
                                        fac_gas)
                h_cap_gas = jnp.minimum(
                    jnp.maximum(h0, h0_model) * fac_gas,
                    sph_mod.hard_h_cap(boxsize, n_gas))
                state = sph_mod.build_neighbours(
                    pos_gas, h_cap_gas, boxsize, engine=engine,
                    radius_sym_gas=h_box * boxsize * _SYM_MARGIN)
                del rho_model, h_box, h0_model, h0, h_cap_gas
                # adopt the sorted layout (peano.c:85-126 analogue) on
                # the LOOP arrays; order_acc composes for the end
                order = state.index.order
                order_acc = order_acc[order]
                pos_gas = state.index.pos[:n_gas]
                h_prev = h_prev[order]
                rhom_prev = rhom_prev[order]
                fac_gas = fac_gas[order]
                if sat_mask is not sat_false:
                    sat_mask = sat_mask[order]
                del order
                # the sorted positions and permutation are adopted into
                # the loop arrays; dropping them from the retained state
                # frees ~1 GB at 5e7 gas
                state = state._replace(index=state.index._replace(
                    pos=jnp.zeros((state.index.n_padded, 0),
                                  jnp.float32),
                    order=jnp.zeros((0,), jnp.int32)))
                if stream:
                    # the stream kernel needs no count classes (one call
                    # covers all rows), but the skip-bits pass runs per
                    # count BUCKET — the bucket shapes key the program
                    b_ids, b_widths = state.buckets
                    class_shape = ("bits",) + tuple(
                        (ids.shape[0], w)
                        for ids, w in zip(b_ids, b_widths))
                    class_ids = b_ids
                else:
                    sels = sph_mod.classed_selections(state)
                    class_shape = tuple((m, len(ids)) for m, ids in sels)
                    class_ids = tuple(jnp.asarray(ids)
                                      for _, ids in sels)
                tail_shape = (None if state.tail is None else
                              (len(state.tail[0]),
                               state.tail[1].shape[1]))
                iter_fn = _get_iter_fn(
                    class_shape, n_gas, state.index.n_padded,
                    float(mpart), float(boxsize), desnngb,
                    cfg.sph_kernel, cool_core, engine,
                    tail_shape=tail_shape, beta=beta_u)
                its_since_build = 0
                drift_acc = 0.0
                sort_drift_acc = 0.0
                mem = (jax.local_devices()[0].memory_stats() or {})
                from ..utils.memory import est_live_gib
                log("wvt_build", it=it, attempt=attempt,
                    max_cand=state.max_cand, classes=class_shape,
                    tail=tail_shape,
                    n_sat=int(n_sat_d) if attempt else 0,
                    hbm_gib=round(mem.get("bytes_in_use", 0) / 2**30, 2),
                    hbm_peak_gib=round(
                        mem.get("peak_bytes_in_use", 0) / 2**30, 2),
                    hbm_est_gib=est_live_gib(
                        state, pos_gas, h_prev, rhom_prev, fac_gas))

            if pending is not None and pending[0] == it:
                out = pending[1]
            else:
                # the cold-start/big-move phase keeps the COLD margin
                # (warm-h prediction is unreliable until err settles)
                mw = (max(margin_warm, _BITS_MARGIN_COLD)
                      if err_last > 0.15 else margin_warm)
                out = iter_fn(pos_gas, h_prev, rhom_prev, state.h_cap,
                              sat_mask, jnp.float32(mw),
                              state.cand.idx,
                              state.cand.count, class_ids, state.tail,
                              ha, fac_gas, jnp.int32(n_gas),
                              jnp.float32(step), jnp.float32(err_last),
                              jnp.int32(it))
            pending = None
            (rho, hsml, vf, pos_new, rho_model_s, err_max_d,
             err_mean_d, n_sat_d, dmax_rel_d, p999_rel_d, step_new_d,
             fac_new_d, sat_d) = out
            del out  # the tuple would pin ~1.5 GB at 5e7 gas
            # speculate it+1 BEFORE fetching it's scalars, unless a
            # rebuild is predictable from host state.  A stop rule
            # firing wastes the one in-flight dispatch at the very end
            # of the relaxation — far cheaper than forgoing the overlap
            # on every iteration past 25.
            predict_rebuild = (
                its_since_build + 1 >= REBUILD_EVERY
                or drift_acc + 1.5 * drift_inc_last > drift_budget
                or (sort_drift_acc + 1.5 * drift_inc_last
                    > _SORT_DRIFT_BUDGET)
                or state.tail is not None)
            # ... and so is the convergence stop near the end: once
            # err_diff has decayed under ~2x the limit past it=25, the
            # next fetch will almost surely break — an in-flight
            # discarded iteration would still execute on the device and
            # stall the epilogue behind it (~1 full iteration of wall)
            predict_stop = (it >= 25
                            and err_diff_last < err_limit * 2.0)
            if (speculate and it < max_iter and not predict_rebuild
                    and not predict_stop):
                pending = (it + 1, iter_fn(
                    pos_new, hsml, rho_model_s, state.h_cap,
                    sat_false, jnp.float32(margin_warm),
                    state.cand.idx,
                    state.cand.count, class_ids, state.tail, ha,
                    fac_new_d, jnp.int32(n_gas), step_new_d,
                    err_mean_d, jnp.int32(it + 1)))
            # ONE host transfer for every loop scalar — each separate
            # float() is a host round trip
            (err_max, err_mean, n_sat, dmax_rel_v, p999_rel_v,
             step_new) = map(
                float, jax.device_get((err_max_d, err_mean_d, n_sat_d,
                                       dmax_rel_d, p999_rel_d,
                                       step_new_d)))
            n_sat = int(n_sat)
            if n_sat == 0:
                fac_gas = fac_new_d
                break
            if n_sat <= _accept_band(n_gas, it):
                # a handful of freshly-saturated lanes each iteration is
                # the steady state of merger configs; accept their
                # capped h now (the reference accepts NGBMAX-truncated
                # lists the same way, globals.h:50) — the cap-factor
                # ratchet for the next build is pre-applied in fac_new_d
                # (device, so the speculative dispatch above stays
                # valid).  The accepted lanes carry a capped/unconverged
                # h this iteration: record the contract
                # deviation so flagship artifacts can report it
                fac_gas = fac_new_d
                accept_note = n_sat
                break
            # saturation: the build-time search radius no longer covers
            # the needed h — rebuild, growing the cap ONLY for the
            # cap-limited lanes.  Free this attempt's outputs first: at
            # 5e7 gas they are ~1.5 GB that must not ride through the
            # next build+solve.
            pending = None
            grow_mask = hsml >= state.h_cap[:n_gas] * 0.999
            # how many lanes are saturated at the BUILD cap (vs merely
            # at the margin clamp)?  One scalar sync on the (rare) retry
            # path only.
            n_grow = int(jnp.where(grow_mask, 1, 0).sum())
            sat_mask = sat_d   # lift the margin clamp for these lanes
            # feedback: the warm margin mispredicted enough lanes to
            # cost this retry — widen it for subsequent iterations
            margin_warm = min(margin_warm * 1.15, 1.6)
            quiet_iters = 0
            h_prev = hsml
            # positions are unchanged on the retry: prev-model = current
            # model, so the predictor's ratio is exactly 1
            rhom_prev = rho_model_s
            del rho, hsml, vf, pos_new
            if n_grow > _accept_band(n_gas):
                # lanes genuinely outgrew the build-time search radius:
                # the candidate lists cannot cover them — full rebuild
                # with grown caps
                state = None
            # else: margin-clamp saturation only.  The build cap still
            # covers every lane (the candidate lists were built for it),
            # so KEEP the structure and re-solve with sat_mask lifting
            # the clamp — saves the sort+build and, early in a
            # relaxation when list widths are still growing, the
            # iteration-program recompile a rebuild would mint.  The
            # early phase of a 1e7 relaxation paid several of these
            # (the margin escalates 1.1 -> ~1.45 there).
        else:
            raise RuntimeError(
                f"hsml solve saturated for {n_sat} particles after "
                f"{sph_mod._MAX_REBUILDS} rebuilds")
        its_since_build += 1
        quiet_iters += 1
        if quiet_iters >= 8 and margin_warm > _BITS_MARGIN_WARM:
            margin_warm = max(margin_warm / 1.15, _BITS_MARGIN_WARM)
            quiet_iters = 0

        rho_l, hsml_l, vf_l, rho_model_l = rho, hsml, vf, rho_model_s
        h_prev = hsml
        rhom_prev = rho_model_s

        err_diff = (err_last - err_mean) / err_mean

        log("wvt", it=it, err_max=round(err_max, 4),
            err_mean=round(err_mean, 5), err_diff=round(err_diff, 5),
            step=step, margin=round(margin_warm, 3))
        if accept_note is not None:
            # zero-width marker AFTER the wvt event: the iteration's
            # compute is booked to "wvt" by interval-attributing
            # profilers (run_flagship), and the accept count stays
            # visible for contract accounting
            log("wvt_accept", it=it, n_accept=accept_note)

        # stopping rules (host), then adopt the device-side post-shrink
        # move (wvt_relax.c:94-101 ordering — pos_new was computed with
        # step_new, which only the continuing loop uses)
        if err_diff < err_limit and it > 25:
            fresh = True
            break
        if err_diff < 0 and err_diff_last < 0 and it > 10:
            fresh = True
            break
        step = step_new
        err_last = err_mean
        err_diff_last = err_diff

        pos_gas = pos_new
        # accumulate the applied drift against the rebuild budget (both
        # pair endpoints move, hence the factor 2).  For wc6 the pair
        # budget accumulates the p99.9 of PER-BLOCK max drift: a
        # block's max bounds every lane in it, so 2x the block p99.9
        # bounds d_i + d_j for every pair not touching a top-0.1% mover
        # block — and pairs that do touch one sit in the same
        # missed-weight class the 0.25-vs-0.1-slack budget already
        # tolerates (8th-order edge contact, see _DRIFT_BUDGET).
        # Hard-edge kernels (m4) keep the strict global max: their
        # budget admits NO uncovered pairs at all.
        pair_drel = (p999_rel_v if cfg.sph_kernel == "wc6"
                     else dmax_rel_v)
        drift_inc_last = 2.0 * pair_drel * step
        drift_acc += drift_inc_last
        # the sort budget tracks Hilbert-block compactness decay, which
        # IS driven by the worst movers — keep the global max there
        sort_drift_acc += 2.0 * dmax_rel_v * step
        del pos_new

        if checkpoint_path and (it + 1) % checkpoint_every == 0:
            # saved in ORIGINAL particle order so a fresh process (with
            # identity order_acc) resumes cleanly
            pos_ck = jnp.zeros_like(pos_gas).at[order_acc].set(pos_gas)
            with open(checkpoint_path, "wb") as fh:
                _np.savez(fh, pos_gas=_np.asarray(pos_ck), step=step,
                          err_last=err_last, err_diff_last=err_diff_last,
                          it=it)

    # fold the accumulated permutation into the full particle set once,
    # then install the loop results (already in the final order)
    state = None
    pending = None
    if offload:
        # rebuild Particles from the parked pieces: the gas permutation
        # is applied host-side to pid/halo (numpy gather),
        # pos is reassembled from the final loop positions + the
        # untouched DM half, and the zero gas fields are recreated
        ord_h = _np.asarray(order_acc)
        pid_h[:n_gas] = pid_h[:n_gas][ord_h]
        halo_h[:n_gas] = halo_h[:n_gas][ord_h]
        zeros_g = jnp.zeros((n_gas,), jnp.float32)
        parts = Particles(
            pos=jnp.concatenate([pos_gas, pos_dm_dev]),
            vel=vel_off, pid=jnp.asarray(pid_h),
            halo=jnp.asarray(halo_h), u=zeros_g,
            rho=rho_l if rho_l is not None else zeros_g,
            hsml=hsml_l if hsml_l is not None else zeros_g,
            var_hsml_fac=vf_l if vf_l is not None else zeros_g,
            rho_model=(rho_model_l if rho_model_l is not None
                       else zeros_g),
            bfld=bfld_off, apot=apot_off)
        return (parts, fresh) if return_fresh else parts
    parts = sph_mod.permute_gas(parts, order_acc)
    parts = parts._replace(pos=parts.pos.at[:n_gas].set(pos_gas))
    if rho_l is not None:
        parts = parts._replace(rho=rho_l, hsml=hsml_l,
                               var_hsml_fac=vf_l,
                               rho_model=rho_model_l)
    return (parts, fresh) if return_fresh else parts
