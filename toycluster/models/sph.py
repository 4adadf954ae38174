"""SPH density / smoothing-length driver (reference sph.c:13-75).

`find_sph_quantities` replaces the reference's sort -> serial octree ->
per-particle tree walks with: Morton sort of the gas block (the analogue of
Sort_Particles_By_Peano_Key, peano.c:46), equal-count block index +
bounding-box candidate lists (ops/blocks.py), and the fixed-shape masked
Newton/bisection hsml solve (ops/pair_ops.py).  The initial guess comes
from the analytic model density instead of the tree-node density
(tree.c:113-121) — same intent, better prior.

Like the reference, the gas block is physically permuted into curve order;
halo membership rides along in `parts.halo`.
"""

from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as const
from ..ops import blocks as blk
from ..ops import pair_ops
from ..ops import stream as stream_ops
from ..particles import HaloArrays, Particles, gas_density_device
from ..scene import Scene

_CAP_FACTOR = 1.2      # candidate radius margin over the model-based h0
_MAX_REBUILDS = 5
# chunk-refined skip bits (see models/wvt.py _CHUNK_BITS)
_CHUNK_BITS = True
_MS_CAP = 512          # superblock-budget ceiling: rows needing more go
#                        to the exact superblock-granular tail path
_SB_WIDTH_CAP = 1536   # superblock-list width ceiling at 16 GiB of device
#                        memory (scaled to the device by utils.memory):
#                        overflowing rows keep their NEAREST superblocks
#                        (distance-ordered lists — the NGBMAX analogue).
#                        Width-proportional arrays (lists + skip bits +
#                        bbox gathers) scale as n_blocks * width; the
#                        truncation is absorbed by the saturation policy
#                        (the reference's NGBMAX=2360 plays the same
#                        role, globals.h:50)


def _sb_width_cap() -> int:
    from ..utils.memory import scaled
    return scaled(_SB_WIDTH_CAP)


def hard_h_cap(boxsize: float, n_gas: int) -> float:
    """Global hsml escape hatch for the density solve.

    The reference's outer grow-and-research loop is UNBOUNDED
    (sph.c:36-64): it keeps enlarging hsml — across the periodic wrap —
    until every particle meets the |wkNgb-DESNNGB| contract.  The block
    engine needs a bound because candidate radii approaching the box
    make every superblock a candidate of every other:

    * large N: clamp at boxsize/3 (lanes this extreme accept their
      capped h — the reference's NGBMAX truncation plays the same
      role, globals.h:50).  No production-scale lane has ever needed
      more (contract 1.0 at 1e6-1e8).
    * small N (whole domain fits one candidate row, i.e. the superblock
      count is within the width cap — true below ~1.5e6 gas at 16 GiB
      of device memory): all-to-all
      candidate coverage is already affordable, so the cap rises to
      0.49*boxsize, the min-image validity limit.  Box-corner lanes in
      tiny-N configs (config 1: 32^3) genuinely need h beyond box/3 to
      collect DESNNGB neighbours across the wrap; capping them at box/3
      left 0.9% of config-1 lanes 100+ neighbours short.
    """
    n_blocks = -(-max(int(n_gas), 1) // blk.BLOCK)
    n_sb = -(-n_blocks // blk.SUPER)
    return 0.49 * boxsize if n_sb <= _sb_width_cap() else boxsize / 3.0


def is_stream(engine: str) -> bool:
    """'stream' runs the compiled Triton kernels, 'stream_interpret' the
    same kernels through the Pallas interpreter (CPU tests)."""
    return engine in ("stream", "stream_interpret")


def uniform_beta(scene) -> float | None:
    """The single beta shared by every gas-bearing halo, or None.
    Passed as a STATIC exponent into the per-iteration model-density
    evaluation (beta=2/3 closed form skips the per-particle pow)."""
    betas = {float(h.beta) for h in scene.halos if h.mass_gas > 0}
    return betas.pop() if len(betas) == 1 else None


def global_density_model(pos_box, ha: HaloArrays, boxsize, cool_core=None,
                         beta=None):
    """max over gas-bearing halos of the beta-model density at a box
    position (wvt_relax.c:227-256).

    lax.fori_loop over halos: Python-unrolled, a ~70-halo substructure
    scene keeps O(halos) particle-sized temporaries live inside the
    surrounding jit (out of memory at large N) and bloats the program."""
    boxhalf = boxsize / 2.0

    def body(j, rho):
        r = jnp.linalg.norm(pos_box - (ha.d_com[j] + boxhalf), axis=-1)
        rho_j = gas_density_device(r, ha, j, cool_core, beta=beta)
        rho_j = jnp.where(ha.mass_gas[j] > 0, rho_j, 0.0)
        return jnp.maximum(rho, rho_j).astype(rho.dtype)

    # init derived from pos_box so the carry is device-varying under
    # shard_map (a plain zeros carry is "unvarying" and fori_loop
    # rejects the mismatch)
    return jax.lax.fori_loop(
        0, ha.n_halos, body,
        jnp.zeros_like(pos_box[..., 0]).astype(jnp.float32))


def model_hsml(pos_box, ha, mpart, desnngb, boxsize, cool_core=None,
               beta=None):
    """h0 = (DESNNGB m / rho_model / (4pi/3))^(1/3) — the WVT metric form
    (wvt_relax.c:115) reused as the density-solve warm start."""
    rho = global_density_model(pos_box, ha, boxsize, cool_core,
                               beta=beta)
    return (desnngb * mpart / rho / const.FOURPITHIRD) ** (1.0 / 3.0)


def permute_gas(parts: Particles, order) -> Particles:
    """Physically reorder the gas block (the cycle-leader permutation of
    peano.c:85-126, as a gather)."""
    n_gas = parts.n_gas

    def perm(arr):
        return arr.at[:n_gas].set(arr[:n_gas][order])

    def perm_gas(arr):  # lazy gas fields may be unallocated (see
        #                 particles.empty_particles)
        return arr[order] if arr.shape[0] == n_gas else arr

    return parts._replace(
        pos=perm(parts.pos),
        vel=(perm(parts.vel) if parts.vel.shape[0] else parts.vel),
        pid=perm(parts.pid),
        halo=perm(parts.halo), u=perm_gas(parts.u),
        rho=perm_gas(parts.rho), hsml=perm_gas(parts.hsml),
        var_hsml_fac=perm_gas(parts.var_hsml_fac),
        rho_model=perm_gas(parts.rho_model), bfld=perm_gas(parts.bfld),
        apot=perm_gas(parts.apot))


class NeighbourState(NamedTuple):
    """Reusable block structure of the (already permuted) gas positions.

    `tail`: far-tail receiver rows whose block-granular candidate lists
    would overflow the 4096 cap (their bbox+radius windows sweep in the
    dense center) carry SUPERBLOCK-granular lists instead —
    (ids (T,), sb_idx (T, M_sb), sb_count (T,)) or None."""
    index: blk.BlockIndex
    cand: blk.CandidateList
    h_cap: jnp.ndarray     # (P,) padded sorted layout
    max_cand: int
    tail: Optional[tuple] = None
    sb: bool = False       # cand.idx holds SUPERBLOCK ids (stream
    #                        engine: one list entry per superblock; no
    #                        tail)
    buckets: Optional[tuple] = None  # (ids_tuple, widths_tuple):
    #                        count buckets for the per-iteration skip-
    #                        bits pass (rows run at their bucket width,
    #                        not the padded list width — the bbox
    #                        gather scales with processed width)


def _pad_sorted(x, order, n_padded, fill_last=True):
    xs = x[order]
    pad = n_padded - xs.shape[0]
    if pad:
        filler = jnp.broadcast_to(xs[-1:], (pad,) + xs.shape[1:])
        xs = jnp.concatenate([xs, filler])
    return xs


# last successful candidate-list width per mode: reusing it across calls
# keeps the jit shapes stable (avoids recompile flip-flop in the WVT loop)
_LAST_MAX_CAND: dict = {}
_BUCKET_MEMO: dict = {}  # nb -> skip-bits bucket widths ever emitted
_TRIM_MEMO: dict = {}    # nb -> widest post-trim list this process saw


def _build_neighbours_sb(pos_gas, h_cap_gas, boxsize, *,
                         symmetric=False, radius_sym_gas=None):
    """Superblock-granular candidate lists for EVERY receiver block —
    the stream engine's structure.  One level-1 bbox sweep, no
    per-block compaction, no far-tail special case: member blocks that
    miss the range are pruned per iteration by the stream kernel's skip
    bits, which re-test the exact per-block criterion against CURRENT
    positions (fresher than any build-time level 2)."""
    key = ("sball", symmetric, radius_sym_gas is not None)
    bi = blk.build_blocks(pos_gas, boxsize)
    h_cap = _pad_sorted(h_cap_gas, bi.order, bi.n_padded)
    radius = h_cap.reshape(bi.n_blocks, blk.BLOCK).max(axis=1)
    if radius_sym_gas is not None:
        sym = _pad_sorted(radius_sym_gas, bi.order, bi.n_padded)
        radius_sym = sym.reshape(bi.n_blocks, blk.BLOCK).max(axis=1)
    elif symmetric:
        radius_sym = radius
        radius = jnp.zeros_like(radius)
    else:
        radius_sym = jnp.zeros_like(radius)
    cand = _sb_candidates(bi, key, radius, radius_sym, boxsize)
    cand, buckets = _trim_and_buckets(cand, search_key=key)
    return NeighbourState(index=bi, cand=cand, h_cap=h_cap,
                          max_cand=cand.idx.shape[1], tail=None, sb=True,
                          buckets=buckets)


def _sb_candidates(bi, key, radius, radius_sym, boxsize):
    """Superblock candidate search with the sticky/grow-on-overflow
    width policy."""
    ns = bi.sb_lo.shape[0]
    # even cap: the skip-bit packing needs an even superblock width
    # (m_blocks = M * _FAN must land on 16); an overflowing row at an
    # odd ns truncates its one farthest superblock instead (the
    # distance-ordered NGBMAX-style truncation the callers absorb)
    # round ns UP to even: rounding down at a tiny odd superblock count
    # silently dropped every row's farthest superblock (observed as a
    # 1.3% curl mismatch at N=3000, ns=3) — the extra column beyond ns
    # is plain -1 padding, so rounding up costs nothing
    width_cap = max(2, min(_SB_WIDTH_CAP, (ns + 1) & ~1))
    # start width: growing on overflow costs a full recompile + solve
    # of the iteration program at the new shape — large runs pre-seed
    # it via env
    start = int(os.environ.get("TOYCLUSTER_SB_WIDTH_START", "192"))
    m_sb = min(_LAST_MAX_CAND.get(key, start), width_cap)
    rec = jnp.arange(bi.n_blocks, dtype=jnp.int32)
    while True:
        cand = blk.find_candidates_super(bi, rec, radius, radius_sym,
                                         boxsize, max_cand=m_sb)
        over = int(cand.overflow)
        if over <= 0 or m_sb >= width_cap:
            break
        m_sb = min(-(-int((m_sb + over) * 1.12) // 64) * 64, width_cap)
    _LAST_MAX_CAND[key] = m_sb
    return cand


def _trim_and_buckets(cand, search_key=None):
    """Width trim + count buckets for the skip-bits pass.

    The trim cuts the sticky build width to the pow2-quantized need
    (the skip-bits pass pays for every padded column).  Stickiness is
    bounded BOTH ways: never below a width this process already emitted
    for this row count UNLESS that memo exceeds 2x the current need —
    the cold-start rebuild storm of a 1e7 merger grows the width
    128 -> 1536 at it=0 (genuine transient need), and an unbounded memo
    then pinned EVERY later iteration at 12x the steady width.
    Shrinking costs one program recompile and repays it within a
    handful of iterations; the 2x headroom absorbs pow2-boundary wobble
    without thrash.
    """
    counts = np.asarray(cand.count)
    nb_rows = len(counts)
    w_need = max(int(counts.max()), 1)
    w_q = max(64, 1 << (w_need - 1).bit_length())
    w_q = max(w_q, min(_TRIM_MEMO.get(nb_rows, 0), 2 * w_q))
    w_q = min(w_q, cand.idx.shape[1])
    _TRIM_MEMO[nb_rows] = w_q
    if search_key is not None:
        # let the sticky SEARCH width decay with the need too (top_k
        # cost scales with it); an under-width search self-corrects
        # through the overflow-grow loop
        _LAST_MAX_CAND[search_key] = min(
            _LAST_MAX_CAND.get(search_key, w_q), max(192, 2 * w_q))
    if w_q < cand.idx.shape[1]:
        cand = cand._replace(idx=cand.idx[:, :w_q])
    # count buckets: p50 counts sit ~10x below the padded width, and
    # the skip-bits bbox gather scales with the width each row is
    # processed at.  Sticky-quantized sizes keep the per-iteration jit
    # shapes stable across rebuilds.
    width_full = cand.idx.shape[1]
    b_ids, b_widths = [], []
    prev = 0
    # ladder start 64: finer ladders cost more than they save (a
    # 16-start adds two buckets and each bucket pays a full
    # (S, nw_full) result scatter — the bits-word write, not the
    # member gather, binds below width 64)
    w = int(os.environ.get("TOYCLUSTER_BUCKET_MIN_W", "64"))
    seen = _BUCKET_MEMO.setdefault(nb_rows, set())
    while prev < width_full:
        w_eff = min(w, width_full)
        sel = np.where((np.minimum(counts, width_full) > prev)
                       & (np.minimum(counts, width_full) <= w_eff))[0]
        # sticky presence: once a width bucket exists for this nb, keep
        # emitting it even when it (temporarily) empties — a vanishing
        # bucket would change the iteration program's shape signature
        if len(sel) or w_eff in seen:
            seen.add(w_eff)
            padded = np.full(
                _quantize_size(len(sel), nb_rows, -w_eff), -1,
                np.int32)
            padded[:len(sel)] = sel
            b_ids.append(jnp.asarray(padded))
            b_widths.append(w_eff)
        prev = w_eff
        w *= 2
    return cand, (tuple(b_ids), tuple(b_widths))


@partial(jax.jit, static_argnames=("nb", "boxsize"))
def _refresh_bboxes(pos_sorted_pad, nb, boxsize):
    """Block + superblock bboxes from CURRENT sorted positions.

    WRAP-AWARE: drifted members of a boundary block may have wrapped
    to the far side of the box; a naive min/max bbox then spans the
    whole box and the candidate search degenerates (observed: width
    blow-up to every superblock).  Re-centre members on the block's
    first particle with min-image deltas — blocks are far smaller than
    box/2, so the re-centred bbox is exact (it may extend outside
    [0, box); _interval_dist2 wraps centre deltas, so that is fine)."""
    pb = pos_sorted_pad.reshape(nb, blk.BLOCK, 3)
    ref = pb[:, :1, :]
    d = pb - ref
    d = d - boxsize * jnp.round(d / boxsize)
    bb_lo = ref[:, 0] + d.min(axis=1)
    bb_hi = ref[:, 0] + d.max(axis=1)
    ns = -(-nb // blk.SUPER)
    padb = ns * blk.SUPER - nb
    if padb:
        lo_p = jnp.concatenate(
            [bb_lo, jnp.broadcast_to(bb_lo[-1:], (padb, 3))])
        hi_p = jnp.concatenate(
            [bb_hi, jnp.broadcast_to(bb_hi[-1:], (padb, 3))])
    else:
        lo_p, hi_p = bb_lo, bb_hi
    sb_lo = lo_p.reshape(ns, blk.SUPER, 3).min(axis=1)
    sb_hi = hi_p.reshape(ns, blk.SUPER, 3).max(axis=1)
    return bb_lo, bb_hi, sb_lo, sb_hi


def refresh_candidates(state: "NeighbourState", pos_sorted_gas,
                       radius_sym_gas, boxsize):
    """Drift refresh: rebuild the candidate lists and skip-bit buckets
    from CURRENT positions while keeping the sort / block membership.

    The stream kernel's skip bits re-test every candidate block against
    current positions each iteration, but the candidate LISTS carry
    build-time slack (_SYM_MARGIN): once accumulated drift spends that
    slack, the lists — not the sort — are what must be rebuilt.  A
    bbox sweep + superblock search skips the sort and the block
    re-layout of a full build, and the sticky width/bucket machinery keeps
    the iteration-program shapes unchanged (no recompile).  The
    reference rebuilds its whole tree every iteration for the same
    correctness reason (wvt_relax.c:6, tree.c).

    pos_sorted_gas: (n_gas, 3) CURRENT positions in the state's sorted
    order.  radius_sym_gas: (n_gas,) world-unit symmetric reach
    (metric h * boxsize * margin), sorted order.
    """
    assert state.sb, "refresh is only wired for the superblock engine"
    bi = state.index
    nb = bi.n_blocks
    n_gas = pos_sorted_gas.shape[0]
    pad = bi.n_padded - n_gas
    if pad:
        pos_pad = jnp.concatenate(
            [pos_sorted_gas,
             jnp.broadcast_to(pos_sorted_gas[-1:], (pad, 3))])
    else:
        pos_pad = pos_sorted_gas
    bb_lo, bb_hi, sb_lo, sb_hi = _refresh_bboxes(pos_pad, nb,
                                                 float(boxsize))
    bi2 = bi._replace(bb_lo=bb_lo, bb_hi=bb_hi, sb_lo=sb_lo,
                      sb_hi=sb_hi)
    radius = state.h_cap.reshape(nb, blk.BLOCK).max(axis=1)
    sym_pad = jnp.concatenate(
        [radius_sym_gas, jnp.zeros((pad,), jnp.float32)]) if pad \
        else radius_sym_gas
    radius_sym = sym_pad.reshape(nb, blk.BLOCK).max(axis=1)
    key = ("sball", False, True)
    cand = _sb_candidates(bi2, key, radius, radius_sym, boxsize)
    cand, buckets = _trim_and_buckets(cand, search_key=key)
    return state._replace(index=bi2, cand=cand,
                          max_cand=cand.idx.shape[1], buckets=buckets)


def build_neighbours(pos_gas, h_cap_gas, boxsize, *, engine,
                     max_cand=None, symmetric=False, radius_sym_gas=None):
    if is_stream(engine):
        return _build_neighbours_sb(pos_gas, h_cap_gas, boxsize,
                                    symmetric=symmetric,
                                    radius_sym_gas=radius_sym_gas)
    return _build_neighbours_blocks(pos_gas, h_cap_gas, boxsize,
                                    max_cand=max_cand,
                                    symmetric=symmetric,
                                    radius_sym_gas=radius_sym_gas)


def _build_neighbours_blocks(pos_gas, h_cap_gas, boxsize, *,
                             max_cand=None, symmetric=False,
                             radius_sym_gas=None):
    """Sort + block + candidate search; retries with larger candidate lists
    on overflow (host-checked).  With `radius_sym_gas` (per-particle, the
    WVT metric search length) the candidate range is the union of the
    density gather range and the symmetric displacement pair range, so
    ONE structure serves the whole WVT iteration (the reference reuses
    its tree the same way, wvt_relax.c:66-171)."""
    key = ("combined" if radius_sym_gas is not None
           else "sym" if symmetric else "gather",)
    bi = blk.build_blocks(pos_gas, boxsize)
    ns = bi.sb_lo.shape[0]
    if max_cand is None:
        max_cand = _LAST_MAX_CAND.get(key, 2048)
    max_super = _LAST_MAX_CAND.get(key + ("sb",))
    h_cap = _pad_sorted(h_cap_gas, bi.order, bi.n_padded)
    radius = h_cap.reshape(bi.n_blocks, blk.BLOCK).max(axis=1)
    radius_sym = None
    if radius_sym_gas is not None:
        sym = _pad_sorted(radius_sym_gas, bi.order, bi.n_padded)
        radius_sym = sym.reshape(bi.n_blocks, blk.BLOCK).max(axis=1)
    tail = None
    ms_cap = min(ns, _MS_CAP)
    while True:
        ms = (min(max_super, ns) if max_super is not None
              else min(blk.default_max_super(ns, max_cand), ms_cap))
        cand = blk.find_candidates(bi, radius, boxsize, max_cand=max_cand,
                                   max_super=ms, symmetric=symmetric,
                                   radius_sym=radius_sym)
        sb_over = int(cand.sb_overflow)
        if sb_over > 0 and ms < ms_cap:
            # superblock budget too small: grow it (bounded — rows past
            # the cap become tail rows below, never a memory blow-up)
            max_super = min(ms_cap,
                            -(-int((ms + sb_over) * 1.12) // 32) * 32)
            continue
        counts = np.asarray(cand.count)
        sb_counts = np.asarray(cand.sb_count)
        # rows over EITHER budget get exact superblock-granular lists
        # (their bbox+radius windows sweep in the dense center; level-2
        # counts of sb-overflowed rows are undercounted, so flag those
        # too)
        flagged = (counts > max_cand) | (sb_counts > ms)
        if not flagged.any():
            break
        over = int(cand.overflow)
        need = int((max_cand + max(over, 0)) * 1.12)
        if need <= 4096 and int(cand.sb_overflow) <= 0:
            # the block-granular width can still absorb everything
            max_cand = min(4096, -(-need // 128) * 128)
            continue
        tail_ids = np.where(flagged)[0]
        t_pad = np.full(_quantize_size(len(tail_ids), bi.n_blocks, -1),
                        -1, np.int32)
        t_pad[: len(tail_ids)] = tail_ids
        sym = radius_sym if radius_sym is not None else radius
        m_sb = _LAST_MAX_CAND.get(key + ("tail",), 1024)
        while True:
            cand_sb = blk.find_candidates_super(
                bi, jnp.asarray(t_pad), radius, sym, boxsize,
                max_cand=m_sb)
            if int(cand_sb.overflow) <= 0:
                break
            m_sb = -(-int((m_sb + int(cand_sb.overflow)) * 1.12)
                     // 128) * 128
        _LAST_MAX_CAND[key + ("tail",)] = m_sb
        tail = (t_pad, cand_sb.idx, jnp.where(
            jnp.asarray(t_pad) >= 0, cand_sb.count, 0))
        break
    _LAST_MAX_CAND[key] = max_cand
    _LAST_MAX_CAND[key + ("sb",)] = ms
    return NeighbourState(index=bi, cand=cand, h_cap=h_cap,
                          max_cand=max_cand, tail=tail)


# -------------------------------------------------------------------------
# count-classed execution: the candidate-count distribution is heavily
# skewed (central blocks ~30 candidates, outskirt blocks ~1000+), so
# running every block at the global max width would waste ~10x memory and
# flops.  Blocks are bucketed by count and each bucket runs at its own
# static width.
# -------------------------------------------------------------------------

_CLASS_EDGES = (128, 512, 2048, 4096)


_CLASS_SIZE_MEMO: dict = {}


def _quantize_size(n: int, nb: int, m: int = 0) -> int:
    """Round a selection size up onto a coarse geometric grid
    {nb, nb/4, nb/16, nb/64} so the jit shapes repeat across WVT
    iterations even as class memberships drift; sizes are sticky per
    (class, nb) — a membership wobble across a grid boundary must not
    recompile the whole-iteration program.

    The grid is deliberately COARSE with an nb/64 floor: the 1e8
    config-5 run showed saturation retries walking a fine 2x grid one
    step per rebuild (95 -> 762 -> 1525 -> 3051 rows), each step a
    fresh program shape costing a full recompile.  Padded
    rows are cnt-gated in every consumer, so over-padding a secondary
    bucket to nb/64 costs ~3% extra bbox gathers — noise against one
    recompile."""
    size = max(nb, 64)
    floor = max(n, 64, nb // 64)
    while size // 4 >= floor:
        size //= 4
    key = (m, nb)
    prev = _CLASS_SIZE_MEMO.get(key)
    if prev is not None and n <= prev:
        size = prev   # never shrink: a recompile costs far more than
        #               the cnt-gated padded rows
    _CLASS_SIZE_MEMO[key] = size
    return size


def classed_selections(state: NeighbourState):
    """Host-side bucketing of receiver blocks by candidate count; each
    bucket is padded (ids = -1) to a quantized size for shape stability.
    Far-tail rows (state.tail) are excluded — they run on their own
    superblock-granular path."""
    counts = np.asarray(state.cand.count)
    if state.tail is not None:
        excl = state.tail[0]
        counts = counts.copy()
        counts[excl[excl >= 0]] = np.iinfo(np.int32).max
    nb = len(counts)
    sels = []
    lo = 0
    for edge in _CLASS_EDGES:
        m = min(edge, state.max_cand)
        if m <= lo:
            break
        ids = np.where((counts > lo) & (counts <= m))[0].astype(np.int32)
        lo = m
        if len(ids):
            padded = np.full(_quantize_size(len(ids), nb, m), -1,
                             np.int32)
            padded[: len(ids)] = ids
            sels.append((m, padded))
        if m >= state.max_cand:
            break
    return sels


def expand_tail_rows(sb_rows, nb):
    """(T, M_sb) superblock ids -> (T, M_sb*SUPER) block ids.  Invalid
    entries map to -1.  The only invariant consumers may rely on is
    PER-ENTRY validity (entry >= 0): -1s are NOT confined to row tails —
    when nb % SUPER != 0 the tail superblock expands to mid-row -1s
    wherever a distance-ordered list places it.  pair_ops._gather masks
    each entry independently (cidx >= 0), so this is safe."""
    t, m = sb_rows.shape
    e = (jnp.maximum(sb_rows, 0)[:, :, None] * blk.SUPER
         + jnp.arange(blk.SUPER, dtype=jnp.int32))
    ok = (sb_rows >= 0)[:, :, None] & (e < nb)
    return jnp.where(ok, e, -1).reshape(t, m * blk.SUPER)


def run_classed(state: NeighbourState, fn, tail_fn=None):
    """Run `fn(sel, m) -> tuple of (S*BLOCK, ...) arrays` per count class
    and scatter the results into (P, ...) sorted-layout arrays.

    When the state carries far-tail rows (superblock-granular candidate
    lists, see NeighbourState.tail), `tail_fn(ids, sb_rows, sb_cnt)` must
    be supplied to process them."""
    bi = state.index
    p = bi.n_padded
    outs = None

    def scatter(ids, res):
        nonlocal outs
        if outs is None:
            outs = [jnp.zeros((p,) + r.shape[1:], r.dtype) for r in res]
        pidx = (jnp.maximum(ids, 0)[:, None] * blk.BLOCK
                + jnp.arange(blk.BLOCK, dtype=jnp.int32)).reshape(-1)
        pidx = jnp.where(jnp.repeat(ids >= 0, blk.BLOCK), pidx, p)
        for k, r in enumerate(res):
            outs[k] = outs[k].at[pidx].set(r, mode="drop")

    for m, ids_np in classed_selections(state):
        ids = jnp.asarray(ids_np)
        rows = state.cand.idx[jnp.maximum(ids, 0)][:, :m]
        rows = jnp.where((ids >= 0)[:, None], rows, -1)
        sel = pair_ops.BlockSelection(ids=ids, cand=rows)
        scatter(ids, fn(sel, m))
    if state.tail is not None:
        if tail_fn is None:
            raise RuntimeError(
                "neighbour state carries far-tail rows but the caller "
                "provided no tail_fn")
        t_ids, sb_rows, sb_cnt = state.tail
        ids = jnp.asarray(t_ids)
        scatter(ids, tail_fn(ids, sb_rows, sb_cnt))
    return outs


def _density_stream(state, h0_sorted, mpart, boxsize, kernel, desnngb,
                    interpret=False):
    """One full-row superblock-granular density solve through the stream
    kernel: per-member distance bounds (exact here — positions are fixed
    during the solve) prune the non-hit member blocks in-kernel; the
    displacement pass is compiled out.  Returns DensityResult fields in
    the padded sorted layout."""
    bi = state.index
    nb = bi.n_blocks
    pos_t = bi.pos.reshape(nb, blk.BLOCK, 3).transpose(0, 2, 1)
    # the source-validity mask rides in the kernel's hm plane
    vm_blocks = bi.valid.astype(jnp.float32).reshape(nb, 1, blk.BLOCK)
    src_blocks = jnp.concatenate([pos_t, vm_blocks], axis=1)
    h0_b = h0_sorted.reshape(nb, blk.BLOCK)
    cap_b = state.h_cap.reshape(nb, blk.BLOCK)
    bk = state.buckets or (None, None)
    ctab = (stream_ops.build_chunk_tab(
        pos_t, jnp.zeros((nb, blk.BLOCK), jnp.float32))
        if _CHUNK_BITS else None)
    bits, safe = stream_ops.stream_skip_bits(
        bi.bb_lo, bi.bb_hi, None, jnp.arange(nb, dtype=jnp.int32),
        state.cand.idx, cap_b, None, float(boxsize), sb=True,
        bucket_ids=bk[0], bucket_widths=bk[1], chunk_tab=ctab)
    rho, h, vf, wk, done, _ = stream_ops.stream_wvt(
        src_blocks, state.cand.idx, state.cand.count, pos_t, h0_b, cap_b,
        h0_b, float(mpart), float(boxsize), kernel=kernel,
        desnngb=desnngb, do_disp=False, sb_mode=True, bits=bits,
        safe=safe, interpret=interpret)
    sat = (~done) | (h >= cap_b * 0.999)
    return [x.reshape(-1) for x in (rho, h, vf, wk, done, sat)]


def find_sph_quantities(scene: Scene, ha: HaloArrays, parts: Particles,
                        *, return_state: bool = False,
                        engine: str | None = None):
    """Density + adaptive hsml for all gas particles (sph.c:13-75).
    Returns the gas-permuted Particles (and the NeighbourState for reuse by
    the B-field curl when requested).  `engine` defaults to the backend's
    (ops.stream.pair_engine)."""
    cfg = scene.config
    n_gas = parts.n_gas
    if n_gas == 0:
        return (parts, None) if return_state else parts
    engine = engine or stream_ops.pair_engine()
    cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                 if cfg.double_beta_cool_cores else None)
    boxsize = scene.boxsize
    mpart = scene.mpart_gas
    desnngb = cfg.desnngb

    pos_gas = parts.pos[:n_gas]
    h0_model = model_hsml(pos_gas, ha, mpart, desnngb, boxsize, cool_core)
    # warm start from the previous hsml when available (sph.c:23-26)
    h_prev = parts.hsml[:n_gas]
    h0 = jnp.where(h_prev > 0, h_prev, h0_model)

    cap_factor = _CAP_FACTOR
    h_hard = hard_h_cap(boxsize, n_gas)
    for attempt in range(_MAX_REBUILDS):
        # global escape hatch (see hard_h_cap): particles at the clamp
        # accept their capped h
        h_cap_gas = jnp.minimum(jnp.maximum(h0, h0_model) * cap_factor,
                                h_hard)
        state = build_neighbours(pos_gas, h_cap_gas, boxsize, engine=engine)
        bi = state.index
        h0_sorted = _pad_sorted(h0, bi.order, bi.n_padded)

        if is_stream(engine):
            res = pair_ops.DensityResult(*_density_stream(
                state, h0_sorted, mpart, boxsize, cfg.sph_kernel, desnngb,
                interpret=engine == "stream_interpret"))
        else:
            def density_class(sel, m):
                return pair_ops.solve_density(
                    bi, sel, h0_sorted, state.h_cap, mpart, boxsize,
                    kernel=cfg.sph_kernel, desnngb=desnngb)

            def density_tail(ids, sb_rows, sb_cnt):
                sel = pair_ops.BlockSelection(
                    ids=ids, cand=expand_tail_rows(sb_rows, bi.n_blocks))
                return pair_ops.solve_density(
                    bi, sel, h0_sorted, state.h_cap, mpart, boxsize,
                    kernel=cfg.sph_kernel, desnngb=desnngb)

            res = pair_ops.DensityResult(
                *run_classed(state, density_class, density_tail))
        # particles whose cap hit the global clamp keep their capped h
        still_growable = state.h_cap < h_hard * 0.999
        n_sat = int((res.saturated & still_growable)[:n_gas].sum())
        if n_sat == 0:
            break
        # analogue of the reference's grow-and-research (sph.c:36-64)
        inv = jnp.zeros_like(bi.order).at[bi.order].set(
            jnp.arange(n_gas))
        h0 = res.hsml[inv]
        cap_factor *= 1.6
    else:
        raise RuntimeError(f"hsml solve saturated for {n_sat} particles "
                           f"after {_MAX_REBUILDS} rebuilds")

    # the neighbour contract (sph.c:159-166): fraction of gas lanes at
    # |wkNgb - DESNNGB| < NNGBDEV.  Recorded so callers (bench.py, the
    # flagship runners) can turn a contract regression red instead of
    # silently recording it in an artifact JSON.
    contract_ok = jnp.abs(res.wk_ngb - desnngb) < const.NNGBDEV
    global last_contract_frac
    last_contract_frac = float(
        jnp.where(bi.valid, contract_ok, False).sum()) / n_gas

    parts = permute_gas(parts, bi.order)
    parts = parts._replace(
        rho=res.rho[:n_gas], hsml=res.hsml[:n_gas],
        var_hsml_fac=res.var_hsml_fac[:n_gas])
    if not return_state:
        return parts
    # after permute_gas the particle layout IS the sorted layout: re-key the
    # index with the identity order so downstream consumers (sph_curl) can
    # scatter results straight back
    state = state._replace(index=bi._replace(
        order=jnp.arange(n_gas, dtype=bi.order.dtype)))
    return parts, state


# contract fraction of the most recent find_sph_quantities call (module
# scalar, not a Particles field: the pytree must stay trace-stable)
last_contract_frac: float = float("nan")
