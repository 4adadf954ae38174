"""Block-sparse neighbour engine: equal-count particle blocks.

The device-native replacement for the reference's octree walk
(tree.c:25-111):

1. sort particles along a Morton curve (ops/keys.py);
2. partition the sorted order into fixed-size blocks of B particles —
   equal-count blocks adapt their spatial extent to the local density,
   exactly the property the adaptive smoothing lengths need (h scales with
   interparticle spacing, so a block's neighbourhood is O(1) blocks);
3. per block, an axis-aligned bounding box and a search radius;
4. a two-level bounding-box sweep (superblocks of S blocks) produces, for
   every receiver block, a fixed-size padded list of candidate source
   blocks whose boxes intersect the receiver's search volume under the
   periodic minimum-image metric.

All pair interactions (SPH density, hsml solve, WVT displacement, curl)
are then fixed-shape (B x M*B) masked computations per block — no pointer
chasing, no dynamic shapes.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

BLOCK = 128        # particles per block (B)
SUPER = 8          # blocks per superblock (S): small superblocks keep the
#                    level-2 candidate test/compaction width tight


class BlockIndex(NamedTuple):
    order: jnp.ndarray       # (N,) permutation: sorted <- original
    pos: jnp.ndarray         # (P, 3) sorted positions, padded to P = nb*B
    valid: jnp.ndarray       # (P,) padding mask
    bb_lo: jnp.ndarray       # (nb, 3) block bbox minima
    bb_hi: jnp.ndarray       # (nb, 3)
    sb_lo: jnp.ndarray       # (ns, 3) superblock bbox minima
    sb_hi: jnp.ndarray       # (ns, 3)

    @property
    def n_blocks(self) -> int:
        return self.bb_lo.shape[0]

    @property
    def n_padded(self) -> int:
        return self.pos.shape[0]


_KD_REFINE = bool(int(__import__("os").environ.get(
    "TOYCLUSTER_KD_REFINE", "1")))


def _kd_refine_segments(spos, order, nseg):
    """Re-partition each SUPER*BLOCK Hilbert segment into compact
    blocks by recursive median splits on the widest axis.

    Hilbert-slice blocks have bbox aspect ~1.9 (p50) — the elongation
    inflates the block-gap cushion of every per-iteration skip test, so
    the stream kernel computes ~27% more (B,B) tiles than compact
    blocks would (measured at 1e6: density-kept member blocks p50 80
    vs 58 under a kd ordering).  Candidates are superblock-granular, so
    refining WITHIN each 1024-particle segment keeps the candidate
    lists identical while shrinking member-block bboxes; the splits
    never cross a segment, so the sort-adoption contract (padding is a
    strict suffix) survives.  Segments are Hilbert-contiguous and never
    straddle the periodic wrap."""
    m0 = SUPER * BLOCK
    seg = spos[:nseg * m0].reshape(nseg, m0, 3)
    idx = order[:nseg * m0].reshape(nseg, m0)
    m = m0
    while m > BLOCK:
        v = seg.reshape(-1, m, 3)
        i = idx.reshape(-1, m)
        ext = v.max(axis=1) - v.min(axis=1)
        ax = jnp.argmax(ext, axis=1)
        key = jnp.where((ax == 0)[:, None], v[:, :, 0],
                        jnp.where((ax == 1)[:, None], v[:, :, 1],
                                  v[:, :, 2]))
        _, x, y, z, i = jax.lax.sort(
            (key, v[:, :, 0], v[:, :, 1], v[:, :, 2], i),
            dimension=1, num_keys=1)
        seg = jnp.stack([x, y, z], axis=2).reshape(nseg, m0, 3)
        idx = i.reshape(nseg, m0)
        m //= 2
    return (jnp.concatenate([seg.reshape(-1, 3), spos[nseg * m0:]]),
            jnp.concatenate([idx.reshape(-1), order[nseg * m0:]]))


def build_blocks(pos, boxsize, order=None) -> BlockIndex:
    """Sort positions along the Hilbert curve and build block/superblock
    bounding boxes.  Padding repeats the last particle (masked out of all
    pair sums via `valid`)."""
    from .keys import hilbert_order

    n = pos.shape[0]
    if order is None:
        order = hilbert_order(pos, boxsize)
    spos = pos[order]
    if _KD_REFINE:
        nseg = n // (SUPER * BLOCK)
        if nseg > 0:
            spos, order = _kd_refine_segments(spos, order, nseg)

    nb = -(-n // BLOCK)
    p = nb * BLOCK
    pad = p - n
    if pad:
        spos = jnp.concatenate([spos, jnp.broadcast_to(spos[-1], (pad, 3))])
    valid = jnp.arange(p) < n

    blocks = spos.reshape(nb, BLOCK, 3)
    bb_lo = blocks.min(axis=1)
    bb_hi = blocks.max(axis=1)

    ns = -(-nb // SUPER)
    sp = ns * SUPER
    pad_lo = jnp.concatenate(
        [bb_lo, jnp.broadcast_to(bb_lo[-1], (sp - nb, 3))])
    pad_hi = jnp.concatenate(
        [bb_hi, jnp.broadcast_to(bb_hi[-1], (sp - nb, 3))])
    sb_lo = pad_lo.reshape(ns, SUPER, 3).min(axis=1)
    sb_hi = pad_hi.reshape(ns, SUPER, 3).max(axis=1)

    return BlockIndex(order=order, pos=spos, valid=valid, bb_lo=bb_lo,
                      bb_hi=bb_hi, sb_lo=sb_lo, sb_hi=sb_hi)


def _interval_dist2(lo1, hi1, lo2, hi2, boxsize):
    """Squared min-image distance between two AABBs on a 3-torus."""
    c1 = 0.5 * (lo1 + hi1)
    c2 = 0.5 * (lo2 + hi2)
    w = 0.5 * (hi1 - lo1) + 0.5 * (hi2 - lo2)
    d = c1 - c2
    d = d - boxsize * jnp.round(d / boxsize)
    gap = jnp.maximum(jnp.abs(d) - w, 0.0)
    return jnp.sum(gap * gap, axis=-1)


class CandidateList(NamedTuple):
    idx: jnp.ndarray       # (nb, M) candidate block ids, -1 padded
    count: jnp.ndarray     # (nb,) true candidate counts
    overflow: jnp.ndarray  # () max(count) - M, positive means truncation
    sb_overflow: jnp.ndarray  # () superblock-budget excess (level 1)
    sb_count: jnp.ndarray = None  # (nb,) level-1 superblock hit counts


def default_max_super(ns: int, max_cand: int) -> int:
    """Superblock budget: bounds the level-2 test/compaction width
    (max_super*SUPER) — kept tight; callers grow it on sb_overflow."""
    return min(ns, max(64, max_cand // SUPER))


_CAND_CHUNK = 512  # receiver blocks per chunk to bound temporaries


def _compact_left(hitb, cand, nb, max_cand):
    """Left-compaction of the hit candidate ids into a fixed-width sorted
    list (a sort rather than a cumsum+scatter, which serialises per row
    on some backends)."""
    idx = jnp.sort(jnp.where(hitb, cand, nb), axis=1)[:, :max_cand]
    if idx.shape[1] < max_cand:  # tiny problems: fewer blocks than M
        idx = jnp.pad(idx, ((0, 0), (0, max_cand - idx.shape[1])),
                      constant_values=nb)
    return idx


@partial(jax.jit, static_argnames=("max_cand", "max_super", "symmetric"))
def find_candidates(bi: BlockIndex, radius, boxsize, *, max_cand: int,
                    max_super: int | None = None, symmetric: bool = False,
                    radius_sym=None) -> CandidateList:
    """Per receiver block, the blocks whose bbox lies within its search
    radius (min-image).  `radius` is (nb,) per-block; with
    `symmetric=True` the pair range is (radius_i + radius_j)/2 (the WVT
    displacement semantics, wvt_relax.c:158), otherwise radius_i (gather).
    With `radius_sym` (nb,) given, the range is the *union*
    max(radius_i, (radius_sym_i + radius_sym_j)/2) — one candidate list
    serving both the density gather pass and the symmetric displacement
    pass of a WVT iteration.

    Two-level sweep: superblock boxes first (O(nb*ns) tests), then the
    blocks of the hit superblocks, chunked over receiver blocks to keep
    temporaries bounded.  Returns fixed-shape padded candidate lists and an
    overflow indicator — callers must check `overflow <= 0` (host-side) and
    re-run with a larger `max_cand` if positive.
    """
    nb = bi.n_blocks
    ns = bi.sb_lo.shape[0]
    if max_super is None:
        max_super = default_max_super(ns, max_cand)

    # superblock radius: conservative per-superblock max of block radii
    def pad_sb(r):
        pad = jnp.full((ns * SUPER - nb,), 0.0, r.dtype)
        return jnp.concatenate([r, pad])

    rad_blocks = pad_sb(radius)
    sb_rad = rad_blocks.reshape(ns, SUPER).max(axis=1)
    if radius_sym is not None:
        sym_blocks = pad_sb(radius_sym)
        sb_sym = sym_blocks.reshape(ns, SUPER).max(axis=1)

    nchunk = -(-nb // _CAND_CHUNK)
    pad_blocks = nchunk * _CAND_CHUNK - nb

    def pad_rc(x, fill=None):
        filler = (jnp.broadcast_to(x[-1], (pad_blocks,) + x.shape[1:])
                  if fill is None else
                  jnp.zeros((pad_blocks,) + x.shape[1:], x.dtype))
        return jnp.concatenate([x, filler])

    lo_pad = pad_rc(bi.bb_lo)
    hi_pad = pad_rc(bi.bb_hi)
    rad_pad = pad_rc(radius, fill=0)
    sym_pad = (pad_rc(radius_sym, fill=0) if radius_sym is not None
               else rad_pad)

    def rng_fn(rad_i, sym_i, rad_j, sym_j):
        if radius_sym is not None:
            return jnp.maximum(rad_i, 0.5 * (sym_i + sym_j))
        if symmetric:
            return 0.5 * (rad_i + rad_j)
        return rad_i

    def chunk_fn(args):
        lo_i, hi_i, rad_i, sym_i = args   # (C,3),(C,3),(C,),(C,)
        # level 1: chunk x superblocks
        d2 = _interval_dist2(lo_i[:, None, :], hi_i[:, None, :],
                             bi.sb_lo[None, :, :], bi.sb_hi[None, :, :],
                             boxsize)                    # (C, ns)
        rng = rng_fn(rad_i[:, None], sym_i[:, None], sb_rad[None, :],
                     sb_sym[None, :] if radius_sym is not None else None)
        hit = d2 <= rng * rng
        sb_ids = jnp.broadcast_to(jnp.arange(ns, dtype=jnp.int32),
                                  hit.shape)
        ms = min(max_super, ns)
        sb_cand = jnp.sort(jnp.where(hit, sb_ids, ns), axis=1)[:, :ms]
        sb_over = hit.sum(axis=1).max() - ms

        # level 2: blocks of the hit superblocks
        cand = (sb_cand[:, :, None] * SUPER
                + jnp.arange(SUPER, dtype=jnp.int32)[None, None, :]
                ).reshape(lo_i.shape[0], ms * SUPER)
        ok_sb = cand < ns * SUPER
        cc = jnp.minimum(cand, nb - 1)
        d2b = _interval_dist2(lo_i[:, None, :], hi_i[:, None, :],
                              bi.bb_lo[cc], bi.bb_hi[cc], boxsize)
        rngb = rng_fn(rad_i[:, None], sym_i[:, None], rad_blocks[cc],
                      sym_blocks[cc] if radius_sym is not None else None)
        hitb = (d2b <= rngb * rngb) & ok_sb & (cand < nb)
        idx = _compact_left(hitb, cand, nb, max_cand)
        count = hitb.sum(axis=1)
        return (jnp.where(idx >= nb, -1, idx).astype(jnp.int32),
                count, count.max() - max_cand, sb_over,
                hit.sum(axis=1))

    idx, count, over, sb_over, sb_count = jax.lax.map(
        chunk_fn, (lo_pad.reshape(nchunk, _CAND_CHUNK, 3),
                   hi_pad.reshape(nchunk, _CAND_CHUNK, 3),
                   rad_pad.reshape(nchunk, _CAND_CHUNK),
                   sym_pad.reshape(nchunk, _CAND_CHUNK)))
    return CandidateList(idx=idx.reshape(-1, max_cand)[:nb],
                         count=count.reshape(-1)[:nb],
                         overflow=over.max(),
                         sb_overflow=sb_over.max(),
                         sb_count=sb_count.reshape(-1)[:nb])


@partial(jax.jit, static_argnames=("max_cand",))
def _find_candidates_super_k(bi: BlockIndex, rec_ids, radius,
                             radius_sym, boxsize, *,
                             max_cand: int) -> CandidateList:
    """Single-pass superblock candidate sweep at list width max_cand —
    see find_candidates_super for semantics."""
    nb = bi.n_blocks
    ns = bi.sb_lo.shape[0]

    def pad_sb(r):
        pad = jnp.full((ns * SUPER - nb,), 0.0, r.dtype)
        return jnp.concatenate([r, pad])

    sb_sym = pad_sb(radius_sym).reshape(ns, SUPER).max(axis=1)
    t = rec_ids.shape[0]
    nchunk = -(-t // _CAND_CHUNK)
    rec_pad = jnp.concatenate(
        [rec_ids, jnp.full((nchunk * _CAND_CHUNK - t,), -1, jnp.int32)])

    def chunk_fn(rec):
        idc = jnp.maximum(rec, 0)
        lo_i = bi.bb_lo[idc]
        hi_i = bi.bb_hi[idc]
        rad_i = radius[idc]
        sym_i = radius_sym[idc]
        d2 = _interval_dist2(lo_i[:, None, :], hi_i[:, None, :],
                             bi.sb_lo[None], bi.sb_hi[None], boxsize)
        rng = jnp.maximum(rad_i[:, None],
                          0.5 * (sym_i[:, None] + sb_sym[None, :]))
        hit = (d2 <= rng * rng) & (rec >= 0)[:, None]
        # DISTANCE-ordered compaction: when a row overflows max_cand it
        # keeps its NEAREST superblocks — the analogue of the
        # reference's NGBMAX=2360 neighbour-list truncation
        # (globals.h:50); affected lanes accept a capped h via the
        # callers' saturation policy
        key = jnp.where(hit, d2, jnp.inf)
        # top-k nearest (a full argsort is quadratic-ish in ns at the
        # 1e8 scale: ns ~ 1e5 superblocks)
        k = min(max_cand, ns)
        _, idx = jax.lax.top_k(-key, k)
        idx = idx.astype(jnp.int32)
        hit_sel = jnp.take_along_axis(hit, idx, axis=1)
        idx = jnp.where(hit_sel, idx, -1)
        if k < max_cand:
            idx = jnp.pad(idx, ((0, 0), (0, max_cand - k)),
                          constant_values=-1)
        count = hit.sum(axis=1)
        return idx, count

    idx, count = jax.lax.map(
        chunk_fn, rec_pad.reshape(nchunk, _CAND_CHUNK))
    idx = idx.reshape(-1, idx.shape[-1])[:t]
    count = count.reshape(-1)[:t]
    return CandidateList(idx=idx, count=count,
                         overflow=count.max() - max_cand,
                         sb_overflow=jnp.zeros((), jnp.int32))


_K_PROBE = 256       # probe width of the two-pass candidate search
_SUBSET_MEMO: dict = {}   # ns -> sticky quantized fallback-row count


def find_candidates_super(bi: BlockIndex, rec_ids, radius, radius_sym,
                          boxsize, *, max_cand: int) -> CandidateList:
    """SUPERBLOCK-granular candidate lists for a subset of receiver
    blocks — the far-tail rows whose block-granular lists overflow (their
    bbox+radius windows sweep in the dense center's thousands of blocks;
    SUPER-fold compression keeps the lists bounded with exact coverage,
    the kernels mask the non-hit blocks of each hit superblock).

    rec_ids: (T,) receiver block ids (-1 padded); radius/radius_sym are
    the full (nb,) per-block arrays.  Ranges use the conservative
    per-superblock max of the member radii, so the hit set is a superset
    of the block-granular one.

    TWO-PASS when max_cand > _K_PROBE: the top_k that distance-orders
    each row's list costs O(ns * k) per row, and at merger scales a
    HANDFUL of outskirt rows (FAC_MAX caps) force the sticky width to
    ~1500 while p50 counts sit below 100 — paying k=1500 for every row
    made the candidate sweep the dominant build/refresh cost at
    config-3 widths.  Pass 1 probes at
    k=_K_PROBE (hit COUNTS are exact regardless of k); only rows whose
    count exceeds the probe re-run at the full width.  The output is
    IDENTICAL to the single-pass form: a row with count <= k keeps all
    its hits in the same distance order either way
    (tests/test_neighbor_engine.py::test_two_pass_candidates_exact)."""
    if max_cand <= _K_PROBE:
        return _find_candidates_super_k(bi, rec_ids, radius, radius_sym,
                                        boxsize, max_cand=max_cand)
    probe = _find_candidates_super_k(bi, rec_ids, radius, radius_sym,
                                     boxsize, max_cand=_K_PROBE)
    counts = np.asarray(probe.count)       # one host sync — the
    #                                        callers sync counts anyway
    t = counts.shape[0]
    idx = jnp.concatenate(
        [probe.idx,
         jnp.full((t, max_cand - _K_PROBE), -1, jnp.int32)], axis=1)
    over_rows = np.nonzero(counts > _K_PROBE)[0]
    if over_rows.size:
        ns = bi.sb_lo.shape[0]
        m = max(64, 1 << (int(over_rows.size) - 1).bit_length())
        m = max(m, _SUBSET_MEMO.get(ns, 0))
        _SUBSET_MEMO[ns] = m
        rec_np = np.asarray(rec_ids)
        sub_ids = np.full((m,), -1, np.int32)
        n_over = min(over_rows.size, m)
        sub_ids[:n_over] = rec_np[over_rows[:n_over]]
        full = _find_candidates_super_k(
            bi, jnp.asarray(sub_ids), radius, radius_sym, boxsize,
            max_cand=max_cand)
        tgt = np.full((m,), t, np.int64)
        tgt[:n_over] = over_rows[:n_over]
        idx = idx.at[jnp.asarray(tgt)].set(full.idx, mode="drop")
    return CandidateList(idx=idx, count=probe.count,
                         overflow=jnp.int32(int(counts.max())
                                            - max_cand),
                         sb_overflow=jnp.zeros((), jnp.int32))
