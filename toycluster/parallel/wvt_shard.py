"""Sharded production WVT iteration: the block-sparse engine under
`shard_map` over a 1-D device mesh.

This is the real multi-chip path (not a toy): each shard owns a contiguous
range of Hilbert-sorted particle blocks and runs the full production
iteration — block bboxes, candidate search, adaptive-hsml SPH density
solve (pair_ops.solve_density, the sph.c:80-214 contract), error stats,
metric renormalisation, and the kernel-weighted WVT displacement
(wvt_relax.c:126-171) — with collectives where the reference used shared
memory:

* `all_gather` — source positions + block bboxes/radii + source metric
  hsml ride the interconnect (the analogue of the shared `P[]` array and of the tree
  gather, tree.c:25-111);
* `psum`      — metric-volume renormalisation and mean-error reductions
  (wvt_relax.c:73-124);
* `pmax`      — max density error and candidate-overflow indicator.

Receiver-side arrays (h0/cap rows, candidate lists, accumulators) stay
shard-local.  Source-side memory is bounded by the halo mode:

* `halo='ring'` (stream engine default) — only per-block METADATA is
  all-gathered (bbox lo/hi + max source hm + search radius: 32 B per
  128-particle block, i.e. 25 MB at 1e8).  The O(N/D) source shards
  are then rotated around the ring once per iteration with
  `ppermute`; each pass keeps just the visiting superblocks that some
  local receiver's candidate list needs, packed into a static
  O(boundary) buffer.  Peak per-chip source bytes are
  O(N/D + max_remote_sb) instead of O(N): at 1e8 over 8 chips the
  gather path replicates 2.0 GB of sources per chip, the ring holds
  2 x 200 MB rotation buffers + the boundary buffer (200 MB at the
  default max_remote_sb = nsl) + 25 MB metadata.  Buffer overflow is
  *reported* via `cand_overflow` (the dump-slot sources stay hm=0,
  i.e. inert), never silently wrong-shaped — same convention as the
  candidate-list width.
* `halo='gather'` (XLA path, and available for the stream engine) —
  source positions + metric hsml are replicated per chip via
  `all_gather`, the analogue of the shared `P[]` array (tree.c:25-111).

Static-shape notes (SPMD has no host retry loop): the candidate list
width `max_cand` is fixed per compile; overflow is *reported* (pmax'd
count excess) rather than retried, and saturated hsml lanes keep their
capped value (the NGBMAX=2360 cap plays the same role in the reference,
globals.h:50).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from .. import constants as const
from ..ops import pair_ops
from ..ops.blocks import BLOCK, BlockIndex, _interval_dist2
from ..ops.stream import FAN as _FAN
from ..ops.stream import pair_engine, stream_skip_bits, stream_wvt
from ..ops.keys import hilbert_order
from ..particles import HaloArrays
from ..models.sph import global_density_model, hard_h_cap

_CAP_FACTOR = 1.35   # candidate-radius margin over the warm-start hsml
_CAND_CHUNK = 64     # receiver blocks per candidate-sweep chunk


class ShardStepResult(NamedTuple):
    pos: jnp.ndarray        # (N,3) new positions, original order
    rho: jnp.ndarray        # (N,) SPH density
    hsml: jnp.ndarray       # (N,) solved smoothing length (warm start)
    rho_model: jnp.ndarray  # (N,) model density at the OLD positions —
    #                         feed back as rhom_prev for the
    #                         model-ratio warm start (wvt._warm_ratio)
    err_mean: jnp.ndarray   # () mean |rho-rho_model|/rho_model
    err_max: jnp.ndarray    # ()
    n_saturated: jnp.ndarray  # () lanes that hit the hsml cap
    cand_overflow: jnp.ndarray  # () max candidate-count excess (<=0 ok)


def _local_candidates(lo_l, hi_l, rad_l, lo_all, hi_all, rad_all, boxsize,
                      max_cand):
    """Per local receiver block, global candidate-block ids within
    max(rad_i, (rad_i+rad_j)/2) — the union of the density gather range
    (radius_i, tree.c:25) and the WVT symmetric pair range
    ((h_i+h_j)/2, wvt_relax.c:158) so one list serves both passes."""
    nb = lo_all.shape[0]
    nbl = lo_l.shape[0]
    nchunk = -(-nbl // _CAND_CHUNK)
    padb = nchunk * _CAND_CHUNK - nbl
    lo_c = jnp.concatenate([lo_l, jnp.broadcast_to(lo_l[-1], (padb, 3))])
    hi_c = jnp.concatenate([hi_l, jnp.broadcast_to(hi_l[-1], (padb, 3))])
    rad_c = jnp.concatenate([rad_l, jnp.zeros((padb,), rad_l.dtype)])

    def chunk_fn(args):
        lo_i, hi_i, rad_i = args
        d2 = _interval_dist2(lo_i[:, None, :], hi_i[:, None, :],
                             lo_all[None], hi_all[None], boxsize)
        rng = jnp.maximum(rad_i[:, None],
                          0.5 * (rad_i[:, None] + rad_all[None, :]))
        hit = d2 <= rng * rng
        ids = jnp.broadcast_to(jnp.arange(nb, dtype=jnp.int32), hit.shape)
        idx = jnp.sort(jnp.where(hit, ids, nb), axis=1)[:, :max_cand]
        if idx.shape[1] < max_cand:
            idx = jnp.pad(idx, ((0, 0), (0, max_cand - idx.shape[1])),
                          constant_values=nb)
        count = hit.sum(axis=1)
        return (jnp.where(idx >= nb, -1, idx).astype(jnp.int32), count)

    idx, count = jax.lax.map(
        chunk_fn, (lo_c.reshape(nchunk, _CAND_CHUNK, 3),
                   hi_c.reshape(nchunk, _CAND_CHUNK, 3),
                   rad_c.reshape(nchunk, _CAND_CHUNK)))
    idx = idx.reshape(-1, max_cand)[:nbl]
    count = count.reshape(-1)[:nbl]
    return idx, jnp.maximum(count.max() - max_cand, -1)


def sharded_wvt_iteration(mesh: Mesh, ha: HaloArrays, *, n_real: int,
                          boxsize: float, mpart: float, desnngb: int,
                          kernel: str = "wc6", max_cand: int = 256,
                          cool_core=None, engine: str = "auto",
                          halo: str = "auto", max_remote_sb=None):
    """Build the jittable sharded iteration.

    Returns `step_fn(pos, hsml_prev, step) -> ShardStepResult` operating on
    (N,3)/(N,) arrays where N = n_real padded up to a multiple of
    BLOCK * mesh size (padding repeats real particles and is masked out of
    every pair sum and reduction).

    `engine`: 'auto' takes the backend's engine (ops.stream.pair_engine:
    the Triton stream kernel on a GPU, the XLA pair operators on the
    CPU); 'xla' forces the XLA path; 'stream' forces the compiled stream
    kernel; 'stream_interpret' runs the stream kernel through the Pallas
    interpreter (CPU-mesh equivalence tests).

    `halo`: 'ring' bounds per-chip source memory at O(N/D + boundary)
    (stream engine only — see the module docstring); 'gather'
    replicates sources per chip; 'auto' picks 'ring' for the stream
    engine.  `max_remote_sb` sizes the ring's boundary buffer in
    superblocks (default: one shard's worth, nsl).
    """
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]
    if engine == "auto":
        engine = pair_engine()
    interpret = engine == "stream_interpret"
    use_stream = engine in ("stream", "stream_interpret")
    if halo == "auto":
        halo = "ring" if use_stream else "gather"
    if halo == "ring" and not use_stream:
        raise ValueError("halo='ring' requires the stream engine")

    def _prologue(pos_l, hprev_l, rhomp_l, valid_l):
        """Shared per-iteration quantities: model density, warm-start
        caps, metric hsml (global renorm), current block bboxes and
        search radii.  Runs identically in the candidate-build and the
        iterate programs so structure reuse never changes the math."""
        nbl = pos_l.shape[0] // BLOCK
        rho_model_l = global_density_model(pos_l, ha, boxsize, cool_core)
        h0_model_l = (desnngb * mpart / rho_model_l
                      / const.FOURPITHIRD) ** (1.0 / 3.0)
        from ..models.wvt import _warm_ratio
        h_guess_l = jnp.where(
            hprev_l > 0, hprev_l * _warm_ratio(rho_model_l, rhomp_l),
            h0_model_l)
        cap_l = jnp.minimum(jnp.maximum(h_guess_l, h0_model_l)
                            * _CAP_FACTOR,
                            hard_h_cap(boxsize, n_real))

        # WVT metric hsml, global volume renorm (wvt_relax.c:108-124)
        hm_l = h0_model_l
        v_sum = jax.lax.psum((jnp.where(valid_l, hm_l, 0.0) ** 3).sum(),
                             axis)
        hm_l = hm_l * (desnngb / v_sum / const.FOURPITHIRD) ** (1.0 / 3.0)

        # local block bboxes + combined search radii
        blocks_l = pos_l.reshape(nbl, BLOCK, 3)
        lo_l = blocks_l.min(axis=1)
        hi_l = blocks_l.max(axis=1)
        rad_part = jnp.maximum(cap_l, hm_l * boxsize)
        rad_l = rad_part.reshape(nbl, BLOCK).max(axis=1)
        return (rho_model_l, h_guess_l, cap_l, hm_l, lo_l, hi_l, rad_l)

    def cand_body(pos_l, hprev_l, rhomp_l, valid_l):
        """Candidate-list build at the CURRENT positions — the sharded
        analogue of the single-chip structure build.  Lists carry
        _CAP_FACTOR slack so they stay valid while accumulated drift is
        below the kernel's drift budget (models/wvt._drift_budget)."""
        nbl = pos_l.shape[0] // BLOCK
        (_, _, _, _, lo_l, hi_l, rad_l) = _prologue(
            pos_l, hprev_l, rhomp_l, valid_l)
        nb_all = n_dev * nbl
        lo_all = jax.lax.all_gather(lo_l, axis, tiled=True)
        hi_all = jax.lax.all_gather(hi_l, axis, tiled=True)
        rad_all = jax.lax.all_gather(rad_l, axis, tiled=True)
        if use_stream:
            ns = nb_all // _FAN
            sb_lo = lo_all.reshape(ns, _FAN, 3).min(axis=1)
            sb_hi = hi_all.reshape(ns, _FAN, 3).max(axis=1)
            sb_rad = rad_all.reshape(ns, _FAN).max(axis=1)
            m_sb = min(max(16, max_cand // 4), ns)
            cand_sb, overflow = _local_candidates(
                lo_l, hi_l, rad_l, sb_lo, sb_hi, sb_rad, boxsize, m_sb)
        else:
            cand_sb, overflow = _local_candidates(
                lo_l, hi_l, rad_l, lo_all, hi_all, rad_all, boxsize,
                max_cand)
        cnt = (cand_sb >= 0).sum(axis=1).astype(jnp.int32)
        return cand_sb, cnt, jax.lax.pmax(overflow, axis)

    def body(pos_l, hprev_l, rhomp_l, valid_l, cand_sb, cnt, step):
        nbl = pos_l.shape[0] // BLOCK
        ax = jax.lax.axis_index(axis)

        (rho_model_l, h_guess_l, cap_l, hm_l, lo_l, hi_l,
         rad_l) = _prologue(pos_l, hprev_l, rhomp_l, valid_l)

        rec_ids = (ax.astype(jnp.int32) * nbl
                   + jnp.arange(nbl, dtype=jnp.int32))
        cap_b = cap_l.reshape(nbl, BLOCK)
        h0_b = h_guess_l.reshape(nbl, BLOCK)
        hm_b = hm_l.reshape(nbl, BLOCK)

        if use_stream:
            # the production stream engine, shard-local: identical
            # structures to the single-chip path (wvt._get_iter_fn stream
            # branch) with a combined [local | halo] source array
            # standing in for the local one.  Candidate lists are
            # superblock-granular (level-1 bboxes reduced over _FAN
            # member blocks); the skip bits re-test each member block vs
            # CURRENT positions inside the shard.
            nb_all = n_dev * nbl
            hm_src_l = jnp.where(valid_l, hm_l, 0.0)
            src_l = jnp.concatenate(
                [pos_l.reshape(nbl, BLOCK, 3).transpose(0, 2, 1),
                 hm_src_l.reshape(nbl, 1, BLOCK)], axis=1)
            bhm_l = hm_src_l.reshape(nbl, BLOCK).max(axis=1)
            # per-BLOCK metadata rides a cheap all_gather in both halo
            # modes: 32 B per 128 particles (25 MB at 1e8)
            lo_all = jax.lax.all_gather(lo_l, axis, tiled=True)
            hi_all = jax.lax.all_gather(hi_l, axis, tiled=True)
            bhm_all = jax.lax.all_gather(bhm_l, axis, tiled=True)
            ns = nb_all // _FAN
            overflow = jnp.int32(-1)
            # skip bits address candidate LIST SLOTS, so they are
            # computed against the CURRENT global metadata regardless of
            # where the source blocks physically live after the exchange
            # — and regardless of which (re)build produced the lists
            bits, safe = stream_skip_bits(
                lo_all, hi_all, bhm_all, rec_ids, cand_sb, cap_b, hm_b,
                float(boxsize), sb=True)

            if halo == "ring":
                nsl = nbl // _FAN    # local superblocks (shard-aligned
                #                      by pad_for_mesh)
                src_sb = src_l.reshape(nsl, _FAN, 4, BLOCK)
                # default boundary buffer: one shard's worth (generous —
                # the Hilbert boundary is a surface), floored for tiny
                # meshes and never larger than all remote superblocks
                R = (int(max_remote_sb) if max_remote_sb
                     else min(max(nsl, 256), max(ns - nsl, 1)))
                # which global superblocks some local receiver needs
                need = jnp.zeros((ns,), bool).at[
                    jnp.where(cand_sb >= 0, cand_sb, ns)
                ].set(True, mode="drop")
                # slot R of the halo buffer is the overflow dump: it
                # stays all-zero (hm=0 sources are inert in the kernel)
                buf = jnp.zeros((R + 1, _FAN, 4, BLOCK), src_l.dtype)
                slot_map = jax.lax.dynamic_update_slice(
                    jnp.full((ns,), -1, jnp.int32),
                    jnp.arange(nsl, dtype=jnp.int32),
                    (ax.astype(jnp.int32) * nsl,))
                perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
                visiting = src_sb
                off = jnp.int32(0)
                for k in range(1, n_dev):
                    visiting = jax.lax.ppermute(visiting, axis, perm)
                    owner = jnp.mod(ax.astype(jnp.int32) - k, n_dev)
                    want = jax.lax.dynamic_slice(
                        need, (owner * nsl,), (nsl,))
                    rank = jnp.cumsum(want.astype(jnp.int32)) - 1
                    slots = jnp.where(want, off + rank, jnp.int32(2**30))
                    buf = buf.at[
                        jnp.where(slots < R, slots, jnp.int32(2**30))
                    ].set(visiting, mode="drop")
                    slot_map = jax.lax.dynamic_update_slice(
                        slot_map,
                        jnp.where(want, nsl + jnp.minimum(slots, R),
                                  jnp.int32(-1)),
                        (owner * nsl,))
                    off = off + want.sum(dtype=jnp.int32)
                overflow = jnp.maximum(overflow, off - R)
                src = jnp.concatenate([src_sb, buf], axis=0).reshape(
                    -1, 4, BLOCK)
                cand_k = jnp.where(
                    cand_sb >= 0,
                    slot_map[jnp.clip(cand_sb, 0, ns - 1)], -1)
            else:
                pos_all = jax.lax.all_gather(pos_l, axis, tiled=True)
                hm_src_all = jax.lax.all_gather(hm_src_l, axis,
                                                tiled=True)
                src = jnp.concatenate(
                    [pos_all.reshape(nb_all, BLOCK, 3).transpose(
                        0, 2, 1),
                     hm_src_all.reshape(nb_all, 1, BLOCK)], axis=1)
                cand_k = cand_sb
            overflow = jax.lax.pmax(overflow, axis)
            xi = pos_l.reshape(nbl, BLOCK, 3).transpose(0, 2, 1)
            rho_b, h_b, _vf, _wk, done_b, delta_b = stream_wvt(
                src, cand_k, cnt, xi, h0_b, cap_b, hm_b, float(mpart),
                float(boxsize), kernel=kernel, desnngb=desnngb,
                sb_mode=True, bits=bits, safe=safe, interpret=interpret)
            rho_r = rho_b.reshape(-1)
            hsml_r = h_b.reshape(-1)
            done_r = done_b.reshape(-1) > 0.5
            sat_l = (~done_r) | (hsml_r >= cap_l * 0.999)
            # stream delta is unscaled (step applied by the caller, as in
            # the single-chip loop)
            delta = delta_b.reshape(-1, 3) * step
        else:
            pos_all = jax.lax.all_gather(pos_l, axis, tiled=True)
            valid_all = jax.lax.all_gather(valid_l, axis, tiled=True)
            hm_all = jax.lax.all_gather(hm_l, axis, tiled=True)
            lo_all = jax.lax.all_gather(lo_l, axis, tiled=True)
            hi_all = jax.lax.all_gather(hi_l, axis, tiled=True)
            cand = cand_sb
            overflow = jnp.int32(-1)

            dummy3 = jnp.zeros((1, 3), pos_l.dtype)
            bi = BlockIndex(order=jnp.arange(pos_all.shape[0],
                                             dtype=jnp.int32),
                            pos=pos_all, valid=valid_all, bb_lo=lo_all,
                            bb_hi=hi_all, sb_lo=dummy3, sb_hi=dummy3)
            sel = pair_ops.BlockSelection(ids=rec_ids, cand=cand)

            # SPH density + adaptive hsml (receiver rows shard-local)
            res = pair_ops.solve_density(
                bi, sel, h0_b, cap_b, mpart, boxsize, kernel=kernel,
                desnngb=desnngb)
            rho_r, hsml_r, sat_l = res.rho, res.hsml, res.saturated
            # displacement pass reusing the same candidate lists
            delta = pair_ops.wvt_displacement(
                bi, sel, hm_all, step, boxsize, kernel=kernel)

        n_sat = jax.lax.psum(
            jnp.where(valid_l, sat_l, False).sum(), axis)

        # error stats vs the model (wvt_relax.c:74-87)
        err = jnp.abs(rho_r - rho_model_l) / rho_model_l
        err = jnp.where(valid_l, err, 0.0)
        err_max = jax.lax.pmax(err.max(), axis)
        err_mean = (jax.lax.psum(err.sum(), axis)
                    / jax.lax.psum(valid_l.sum().astype(err.dtype), axis))

        new_pos = pos_l + delta * boxsize
        new_pos = new_pos - jnp.floor(new_pos / boxsize) * boxsize

        # max displacement this step in units of the local metric h —
        # the sharded analogue of the single-chip loop's drift
        # accumulator (models/wvt: drift_acc vs _drift_budget)
        dr = jnp.sqrt((delta * delta).sum(axis=-1))
        drift = jax.lax.pmax(
            jnp.where(valid_l, dr / hm_l, 0.0).max(), axis)

        return (new_pos, rho_r, hsml_r, rho_model_l, err_mean, err_max,
                n_sat, overflow, drift)

    sharded_body = shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
                  P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P(), P(), P(),
                   P(), P()),
        # pallas_call emits vma-less ShapeDtypeStructs, which the
        # default check_vma=True rejects inside shard_map
        check_vma=False)

    sharded_cand = shard_map(
        cand_body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P()),
        check_vma=False)

    def _assert_padded(n):
        assert n % (BLOCK * n_dev) == 0, (
            f"N={n} must be a multiple of BLOCK*n_devices="
            f"{BLOCK * n_dev}; pad with pad_for_mesh()")
        if use_stream:
            assert (n // (BLOCK * n_dev)) % _FAN == 0, (
                f"stream engine needs each shard's block count divisible "
                f"by _FAN={_FAN}; pad with pad_for_mesh()")

    @jax.jit
    def _sort(pos, hsml_prev, rhom_prev):
        order = hilbert_order(pos, boxsize)
        return pos[order], hsml_prev[order], rhom_prev[order], order

    @jax.jit
    def _build(pos_s, hprev_s, rhomp_s, valid_s):
        return sharded_cand(pos_s, hprev_s, rhomp_s, valid_s)

    @jax.jit
    def _iterate(pos_s, hprev_s, rhomp_s, valid_s, cand, cnt, step):
        return sharded_body(pos_s, hprev_s, rhomp_s, valid_s, cand, cnt,
                            jnp.float32(step))

    class _ShardEngine:
        """step_fn with a structure-reuse API.

        Calling the engine runs one fully-fresh iteration (sort + build
        + iterate + unsort) — the original `step_fn(pos, hsml, step)`
        contract, numerics unchanged.  The reuse API (`sort`, `build`,
        `iterate`) lets regularise_sharded keep the Hilbert order and
        candidate lists across iterations under the drift budget, as
        the single-chip loop does."""
        n_real_ = n_real
        use_stream_ = use_stream

        def sort(self, pos, hsml_prev, rhom_prev):
            _assert_padded(pos.shape[0])
            pos_s, h_s, rm_s, order = _sort(pos, hsml_prev, rhom_prev)
            return pos_s, h_s, rm_s, order

        def build(self, pos_s, hprev_s, rhomp_s, valid_s):
            return _build(pos_s, hprev_s, rhomp_s, valid_s)

        def iterate(self, pos_s, hprev_s, rhomp_s, valid_s, cand, cnt,
                    step):
            return _iterate(pos_s, hprev_s, rhomp_s, valid_s, cand, cnt,
                            step)

        def __call__(self, pos, hsml_prev, step, rhom_prev=None):
            if rhom_prev is None:
                rhom_prev = jnp.zeros((pos.shape[0],), jnp.float32)
            n = pos.shape[0]
            pos_s, h_s, rm_s, order = self.sort(pos, hsml_prev,
                                                rhom_prev)
            valid_s = order < n_real
            cand, cnt, overflow_b = self.build(pos_s, h_s, rm_s,
                                               valid_s)
            out = self.iterate(pos_s, h_s, rm_s, valid_s, cand, cnt,
                               step)
            new_pos_s, rho_s, hs_s, rhom_s = out[:4]
            inv = jnp.zeros((n,), order.dtype).at[order].set(
                jnp.arange(n, dtype=order.dtype))
            return ShardStepResult(
                pos=new_pos_s[inv], rho=rho_s[inv], hsml=hs_s[inv],
                rho_model=rhom_s[inv],
                err_mean=out[4], err_max=out[5], n_saturated=out[6],
                cand_overflow=jnp.maximum(out[7], overflow_b))

    return _ShardEngine()


def pad_for_mesh(pos, n_dev):
    """Pad (N,3) positions (repeating the last particle) up to a multiple
    of BLOCK * _FAN * n_dev — shard-divisible AND per-shard
    superblock-aligned (the stream engine groups _FAN consecutive blocks
    into superblocks that must not straddle a shard boundary, so the
    ring exchange can move whole superblocks); returns
    (padded_pos, n_real)."""
    n = pos.shape[0]
    q = BLOCK * _FAN * n_dev
    n_pad = -(-n // q) * q
    if n_pad > n:
        pos = jnp.concatenate(
            [pos, jnp.broadcast_to(pos[-1], (n_pad - n, 3))])
    return pos, n


def shard_array(mesh, x):
    """Place an array with its leading axis sharded over the mesh."""
    return jax.device_put(
        x, NamedSharding(mesh, P(mesh.axis_names[0])))


def regularise_sharded(mesh, ha, pos_gas, *, boxsize, mpart, desnngb,
                       kernel="wc6", max_cand=256, step=0.0085,
                       max_iter=64, err_diff_limit=0.01, cool_core=None,
                       log=None, engine="auto", halo="auto",
                       max_remote_sb=None, rebuild_every=None,
                       checkpoint_path=None, checkpoint_every=8):
    """Full multi-chip WVT relaxation loop: the sharded iteration under
    the reference's host-side early-stop / step-shrink control flow
    (wvt_relax.c:94-101), with the single-chip loop's production
    machinery:

    * structure reuse — the Hilbert sort and candidate lists persist
      across iterations; a full rebuild runs every `rebuild_every`
      iterations (default: models/wvt.REBUILD_EVERY) OR when the
      accumulated max-lane drift since the last build exceeds the
      kernel's drift budget (models/wvt._drift_budget), whichever
      first — the same cadence contract as the single-chip loop;
    * checkpoint/resume — `checkpoint_path` (NPZ) saves (pos, hsml,
      rho_model, it, step, err trail) in ORIGINAL particle order every
      `checkpoint_every` iterations and resumes from it when present.
    """
    import math

    import numpy as np

    from ..models.wvt import REBUILD_EVERY, _drift_budget

    if rebuild_every is None:
        rebuild_every = REBUILD_EVERY
    drift_budget = _drift_budget(kernel)

    pos, n_real = pad_for_mesh(pos_gas, mesh.devices.size)
    n = pos.shape[0]
    hsml = jnp.zeros((n,), jnp.float32)
    rhom = jnp.zeros((n,), jnp.float32)
    err_last = math.inf
    err_diff_last = math.inf
    it0 = 0

    if checkpoint_path:
        import os
        if os.path.exists(checkpoint_path):
            ck = np.load(checkpoint_path)
            pos = jnp.asarray(ck["pos"])
            hsml = jnp.asarray(ck["hsml"])
            rhom = jnp.asarray(ck["rhom"])
            it0 = int(ck["it"]) + 1
            step = float(ck["step"])
            err_last = float(ck["err_last"])
            err_diff_last = float(ck["err_diff_last"])
            if log:
                log("wvt_shard_resume", it=it0, step=step,
                    err_last=err_last)

    pos = shard_array(mesh, pos)
    hsml = shard_array(mesh, hsml)
    rhom = shard_array(mesh, rhom)
    eng = sharded_wvt_iteration(
        mesh, ha, n_real=n_real, boxsize=boxsize, mpart=mpart,
        desnngb=desnngb, kernel=kernel, max_cand=max_cand,
        cool_core=cool_core, engine=engine, halo=halo,
        max_remote_sb=max_remote_sb)

    # loop state lives in SORTED space between rebuilds; order_total
    # maps sorted slots back to original particle ids
    pos_s = h_s = rm_s = valid_s = cand = cnt = None
    order_total = None
    its_since_build = 0
    drift_acc = 0.0

    def _unsort(x, order):
        inv = jnp.zeros((n,), order.dtype).at[order].set(
            jnp.arange(n, dtype=order.dtype))
        return x[inv]

    out = None
    for it in range(it0, max_iter + 1):
        if (pos_s is None or its_since_build >= rebuild_every
                or drift_acc > drift_budget):
            if pos_s is not None:
                # leave sorted space before re-sorting
                pos = _unsort(pos_s, order_total)
                h_host = _unsort(h_s, order_total)
                rm_host = _unsort(rm_s, order_total)
            else:
                h_host, rm_host = hsml, rhom
            pos_s, h_s, rm_s, order_total = eng.sort(pos, h_host,
                                                     rm_host)
            valid_s = order_total < n_real
            cand, cnt, overflow_b = eng.build(pos_s, h_s, rm_s, valid_s)
            its_since_build = 0
            drift_acc = 0.0
            if log:
                log("wvt_shard_build", it=it,
                    overflow=int(overflow_b))
        out = eng.iterate(pos_s, h_s, rm_s, valid_s, cand, cnt, step)
        (new_pos_s, rho_s, hsml_s, rhom_s, err_mean, err_max, n_sat,
         overflow, drift) = out
        err_mean = float(err_mean)
        drift_acc += float(drift)
        its_since_build += 1
        err_diff = (err_last - err_mean) / err_mean
        if log:
            log("wvt_shard", it=it, err_max=round(float(err_max), 4),
                err_mean=round(err_mean, 5), err_diff=round(err_diff, 5),
                step=step, overflow=int(overflow),
                drift=round(float(drift), 4))
        stop = ((err_diff < err_diff_limit and it > 25)
                or (err_diff < 0 and err_diff_last < 0 and it > 10))
        if err_diff < 0.01 and it > 1 and not stop:
            step *= 0.8
        if not stop:
            err_last = err_mean
            err_diff_last = err_diff
            pos_s, h_s, rm_s = new_pos_s, hsml_s, rhom_s
        if checkpoint_path and not stop and (
                (it + 1 - it0) % checkpoint_every == 0):
            np.savez(checkpoint_path,
                     pos=np.asarray(_unsort(pos_s, order_total)),
                     hsml=np.asarray(_unsort(h_s, order_total)),
                     rhom=np.asarray(_unsort(rm_s, order_total)),
                     it=it, step=step, err_last=err_last,
                     err_diff_last=err_diff_last)
        if stop:
            break

    # final state in original order: positions BEFORE the rejected move
    # (the reference keeps the last accepted state on early-stop), with
    # the density/hsml of the final accepted solve
    pos_f = _unsort(pos_s, order_total)[:n_real]
    rho_f = _unsort(out[1], order_total)[:n_real]
    hsml_f = _unsort(out[2], order_total)[:n_real]
    return pos_f, rho_f, hsml_f
