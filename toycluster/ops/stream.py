"""Superblock stream engine: the WVT density solve + displacement and the
SPH curl as Pallas kernels through Triton, and the plain-XLA skip-bit and
list-compaction passes that feed them.

The XLA path (ops/pair_ops.py) writes a dense (G, B, M*B) masked distance
tile to device memory and gathers the sources again on every Newton
sweep.  Here each kernel program owns `rows` receivers of one 128-particle
receiver block and walks that block's candidate list (superblocks of SUPER
contiguous member blocks) with a dynamic trip count: h, the Newton
bracket, the done mask and the per-receiver sums stay in registers, and a
member block's (4, 128) source rows are read once per sweep.  Programs
carry nothing between them, so they spread over the SMs in any order.

Per-member skip bits (two per block, 16 blocks per int32 word) prune
exact-zero work only:
  bit0: block beyond the row's max cap          -> skip the density tile
  bit1: block within the displacement pair range -> compute the disp tile
so every gated variant (inline bits, precomputed bits, chunk-refined
bits, compacted lists) gives bit-identical results.

The solve contract is pair_ops.solve_density's (sph.c:156-195):
|wkNgb - DESNNGB| < NNGBDEV via guarded Newton with bisection bounds,
Dehnen+12 WC6 bias correction, grad-h factor.  The pair math is
elementwise f32 (no dot products), so no TF32 arises.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .. import constants as const
from ..utils.memory import scaled
from .blocks import BLOCK, SUPER

FAN = SUPER          # member blocks per superblock list entry
# speculative-accept window |wkNgb - DESNNGB| < sqrt(NNGBDEV*DESNNGB/kappa)
# (see _wvt_kernel update): kappa = 20 keeps the first-order extrapolated
# sums of accepted lanes within ~1.5e-4 of a re-measured solve (kappa = 5
# left m4 lanes 3e-4 off)
_SPEC_KAPPA = 20.0
_N_CHUNKS = 8        # sub-chunks per block in the chunk cross test
_BITS_CHUNK = 1024   # rows per chunk in stream_skip_bits (bounds temps)
_ROWS = 32           # receivers per kernel program
_NUM_WARPS = 8
_NUM_STAGES = 2
_WC6_NORM = 1365.0 / (64.0 * const.PI)


def pair_engine(platform: str | None = None) -> str:
    """The pair-operator engine this backend runs: 'stream' (the Triton
    kernels below) on a GPU, 'xla' (ops/pair_ops.py) on the CPU.  Any
    other backend has no engine and raises."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "stream"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no pair engine for backend {platform!r}")


def _check_interpret(interpret: bool):
    if interpret and jax.default_backend() == "gpu":
        raise RuntimeError("stream kernels never run in interpret mode on "
                           "a GPU")


# --------------------------- skip bits (XLA) ---------------------------

def build_chunk_tab(pos_t, hm_src_b, n_chunks=_N_CHUNKS):
    """(nb, n_chunks*8) f32 chunk-geometry table for stream_skip_bits'
    chunk cross test: per 16-particle chunk of each 128-particle block,
    [cen xyz, ext xyz, chunk max source hm, 0].  Pad lanes are copies
    of a real particle (position) with hm zeroed, so chunk hulls stay
    exact bounds of the block's real content.  Takes the (nb, 3, B)
    source layout so the min/max runs over the minor axis."""
    nb, _, B = pos_t.shape
    csz = B // n_chunks
    pc = pos_t.reshape(nb, 3, n_chunks, csz)
    lo = pc.min(axis=3)
    hi = pc.max(axis=3)                       # (nb, 3, nc)
    bh = hm_src_b.reshape(nb, n_chunks, csz).max(axis=2)
    tab = jnp.concatenate(
        [(0.5 * (lo + hi)).transpose(0, 2, 1),
         (0.5 * (hi - lo)).transpose(0, 2, 1),
         bh[..., None], jnp.zeros_like(bh[..., None])], axis=-1)
    return tab.reshape(nb, n_chunks * 8).astype(jnp.float32)


@partial(jax.jit, static_argnames=("boxsize", "sb", "margin_frac",
                                   "bucket_widths"))
def stream_skip_bits(bb_lo, bb_hi, bhm, idc, block_rows, cap_rows,
                     hm_rows, boxsize, sb=False, margin_frac=0.0,
                     bucket_ids=None, bucket_widths=None, chunk_tab=None):
    """Packed per-candidate-block skip words for the stream kernels.

    Two bits per block, 16 blocks per int32 word:
      bit0: the block's bbox distance to the receiver block exceeds the
            row's max cap -> every density pair is out of range, skip;
      bit1: within the displacement pair range 0.5*(max hm_i + max hm_j)
            -> compute the displacement tile.
    Chunked over rows (lax.map) so the (rows, M, 3) gather/arithmetic
    temporaries stay bounded (the bound scales with device memory).

    bb_lo/bb_hi: (nb, 3) CURRENT-position block bboxes; bhm: (nb,)
    per-block max source hm in box units (None -> disp bit 0 everywhere);
    idc: (S,) receiver block ids (clamped); block_rows: (S, Mb) candidate
    BLOCK ids, -1 invalid — or SUPERBLOCK ids with sb=True (expanded to
    member blocks inside the row chunks, never materialised whole);
    cap_rows: (S, B) world-unit caps; hm_rows: (S, B) receiver hm in box
    units (ignored when bhm is None).  Returns (S, ceil(Mb*/16)) int32
    where Mb* is the (expanded) block count padded to 16.

    bucket_ids / bucket_widths (optional, build-time count bucketing):
    matched tuples of row-id arrays (-1 padded) and their static
    candidate-list widths.  Rows run at their bucket's width instead of
    the full padded width (p50 counts sit ~10x below it).

    margin_frac inflates both thresholds by (1+margin_frac) for callers
    that reuse the bits across several iterations.

    Returns (bits, safe): `safe` is a (S,) int32 flag, 1 where the
    receiver block's half-extent plus its maximum pair range stays below
    ~box/2 on every axis — the validity condition of the kernels'
    hoisted periodic wrap (sources wrapped once against the row centre).
    Rows with safe=0 fall back to per-pair min-image wrapping in-kernel.

    chunk_tab (sb mode only): (nb, CHUNKS*8) per-16-particle-chunk
    geometry from build_chunk_tab.  Replaces the member-level block-bbox
    test with an 8x8 chunk-bbox CROSS test per (receiver, member) pair,
    against per-RECEIVER-CHUNK max cap/hm instead of the row max:
    strictly tighter, still conservative (a chunk bbox bounds its
    particles, so any true in-range pair keeps its member).
    """
    assert chunk_tab is None or sb, "chunk test needs superblock lists"
    S, Mb = block_rows.shape
    nb_blocks = bb_lo.shape[0]
    qscale = float(2 ** 22) / float(boxsize)
    mf = 1.0 + float(margin_frac)
    pad16 = (-Mb) % (2 if sb else 16)
    if pad16:
        block_rows = jnp.concatenate(
            [block_rows, jnp.full((S, pad16), -1, block_rows.dtype)],
            axis=1)
        Mb += pad16
    hq = (jnp.minimum(cap_rows.max(axis=1) * mf * qscale,
                      float(2 ** 30)).astype(jnp.int32) + 1)
    hmi = (hm_rows.max(axis=1) if bhm is not None
           else jnp.zeros((S,), jnp.float32))
    if chunk_tab is not None:
        ncc = chunk_tab.shape[1] // 8      # receiver/source chunks per block
        csz = cap_rows.shape[1] // ncc
        hq8 = (jnp.minimum(
            cap_rows.reshape(S, ncc, csz).max(axis=2) * mf * qscale,
            float(2 ** 30)).astype(jnp.int32) + 1)
        hm8 = (hm_rows.reshape(S, ncc, csz).max(axis=2)
               if bhm is not None else jnp.zeros((S, ncc), jnp.float32))
    else:
        hq8 = hm8 = None

    # hoisted-wrap validity: receiver half-extent + max pair range must
    # stay below box/2 on every axis
    r_pair = cap_rows.max(axis=1) * mf
    if bhm is not None:
        r_pair = jnp.maximum(
            r_pair, 0.5 * (hmi + bhm.max()) * float(boxsize) * mf)
    half_ext = 0.5 * (bb_hi[jnp.minimum(idc, nb_blocks - 1)]
                      - bb_lo[jnp.minimum(idc, nb_blocks - 1)])
    safe = jnp.all(half_ext + r_pair[:, None] < 0.49 * float(boxsize),
                   axis=1).astype(jnp.int32)

    # one packed 8-wide gather row per candidate block
    cen = 0.5 * (bb_lo + bb_hi)
    ext = 0.5 * (bb_hi - bb_lo)
    packed = jnp.concatenate(
        [cen, ext,
         (bhm if bhm is not None
          else jnp.zeros((nb_blocks,), bb_lo.dtype))[:, None],
         jnp.zeros((nb_blocks, 1), bb_lo.dtype)], axis=1)   # (nb, 8)
    if chunk_tab is not None:
        ncc_s = chunk_tab.shape[1] // 8

    def run_rows(idc_b, rows_b, hq_b, hmi_b, hq8_b=None, hm8_b=None):
        """Chunked skip-word computation for one bucket of rows."""
        s_rows, m_w = rows_b.shape
        mbx = m_w * FAN if sb else m_w
        if chunk_tab is not None:
            mbx *= ncc_s * ncc_s               # 8x8 cross-test temps
        chunk = min(_BITS_CHUNK, s_rows,
                    max(32, scaled(8 << 20) // max(mbx, 1)))
        nchunk = -(-s_rows // chunk)
        s_pad = nchunk * chunk

        def pad(x, fill=0):
            p = s_pad - x.shape[0]
            if not p:
                return x
            return jnp.concatenate(
                [x, jnp.full((p,) + x.shape[1:], fill, x.dtype)])

        def chunk_fn(args):
            idc_c, rows_c, hq_c, hmi_c = args[:4]
            if sb:
                e = (jnp.maximum(rows_c, 0)[:, :, None] * FAN
                     + jnp.arange(FAN, dtype=jnp.int32))
                ok = (rows_c >= 0)[:, :, None] & (e < nb_blocks)
                rows_c = jnp.where(ok, e, -1).reshape(
                    rows_c.shape[0], -1)
            rowsc = jnp.maximum(rows_c, 0)
            valid = rows_c >= 0
            if chunk_tab is not None:
                hq8_c, hm8_c = args[4], args[5]
                C, Mbx = rows_c.shape
                cj = chunk_tab[rowsc].reshape(C, Mbx, ncc_s, 8)
                ci = chunk_tab[idc_c].reshape(C, ncc_s, 8)
                # (C, Mbx, rc, mc, 3) pairwise chunk-bbox gaps
                d = (ci[:, None, :, None, :3]
                     - cj[:, :, None, :, :3])
                d = d - boxsize * jnp.round(d / boxsize)
                gap = jnp.maximum(
                    jnp.abs(d) - (ci[:, None, :, None, 3:6]
                                  + cj[:, :, None, :, 3:6]), 0.0)
                gd = jnp.sqrt((gap * gap).sum(-1))    # (C,Mbx,rc,mc)
                dq = jnp.minimum(gd * qscale,
                                 float(2 ** 30)).astype(jnp.int32)
                dens_any = (dq <= hq8_c[:, None, :, None]).any(
                    axis=(2, 3))
                dens_skip = ~dens_any | ~valid
                if bhm is None:
                    dk = jnp.zeros(rows_c.shape, bool)
                else:
                    thr = (0.5 * (hm8_c[:, None, :, None]
                                  + cj[:, :, None, :, 6])
                           * boxsize * mf)
                    dk = (gd <= thr).any(axis=(2, 3)) & valid
            else:
                pj = packed[rowsc]              # (C, Mb, 8) one gather
                pi = packed[idc_c]              # (C, 8)
                d = pi[:, None, :3] - pj[:, :, :3]
                d = d - boxsize * jnp.round(d / boxsize)
                gap = jnp.maximum(jnp.abs(d) - (pi[:, None, 3:6]
                                                + pj[:, :, 3:6]), 0.0)
                gd = jnp.sqrt((gap * gap).sum(-1))
                dq = jnp.minimum(gd * qscale,
                                 float(2 ** 30)).astype(jnp.int32)
                dens_skip = (dq > hq_c[:, None]) | ~valid
                if bhm is None:
                    dk = jnp.zeros(rows_c.shape, bool)
                else:
                    dk = (gd <= 0.5 * (hmi_c[:, None] + pj[:, :, 6])
                          * boxsize * mf) & valid
            b2 = (dens_skip.astype(jnp.int32)
                  | (dk.astype(jnp.int32) << 1))
            b2 = b2.reshape(b2.shape[0], -1, 16)
            shifts = jnp.arange(16, dtype=jnp.int32) * 2
            return (b2 << shifts).sum(axis=2).astype(jnp.int32)

        mapped = [
            pad(idc_b).reshape(nchunk, chunk),
            pad(rows_b, -1).reshape(nchunk, chunk, m_w),
            pad(hq_b).reshape(nchunk, chunk),
            pad(hmi_b).reshape(nchunk, chunk)]
        if chunk_tab is not None:
            mapped += [
                pad(hq8_b).reshape(nchunk, chunk, ncc_s),
                pad(hm8_b).reshape(nchunk, chunk, ncc_s)]
        words = jax.lax.map(chunk_fn, tuple(mapped))
        return words.reshape(s_pad, -1)[:s_rows]

    idc_cl = jnp.minimum(idc, nb_blocks - 1)
    nw_full = (Mb * FAN if sb else Mb) // 16
    if bucket_ids is None:
        return run_rows(idc_cl, block_rows, hq, hmi, hq8, hm8), safe

    out = jnp.zeros((S, nw_full), jnp.int32)
    for ids, w in zip(bucket_ids, bucket_widths):
        idr = jnp.maximum(ids, 0)
        wb = run_rows(idc_cl[idr], block_rows[:, :w][idr], hq[idr],
                      hmi[idr],
                      None if hq8 is None else hq8[idr],
                      None if hm8 is None else hm8[idr])
        tgt = jnp.where(ids >= 0, ids, S)
        out = out.at[tgt, :wb.shape[1]].set(wb, mode="drop")
    return out, safe


def compact_sb_lists(cand, cnt, bits, *, do_disp=True):
    """Per-iteration superblock-list compaction from the skip bits.

    Reorder each row's superblock list so the superblocks with at least
    one useful member come FIRST (stable sort keeps the distance order)
    and shrink the dynamic trip count to just those — the kernel maps
    compacted slots back to their original skip-bit positions through
    `pos_it`.  No shapes change, so no recompiles.

    A superblock is useless iff every member's 2-bit field is 1
    (dens-skip, no disp-keep): its 16-bit half-word equals 0x5555.
    Density-only callers test just the dens bits (& 0x5555 == 0x5555).

    Returns (cand_it, pos_it, cnt_it).
    """
    S, M = cand.shape
    w = bits
    if do_disp:
        lo_use = (w & 0xFFFF) != 0x5555
        hi_use = jax.lax.shift_right_logical(w, 16) != 0x5555
    else:
        lo_use = (w & 0x5555) != 0x5555
        hi_use = (jax.lax.shift_right_logical(w, 16) & 0x5555) != 0x5555
    sb_useful = jnp.stack([lo_use, hi_use], axis=2).reshape(S, -1)[:, :M]
    in_list = (jnp.arange(M, dtype=jnp.int32)[None, :]
               < jnp.minimum(cnt, M)[:, None])
    keep = sb_useful & in_list & (cand >= 0)
    pos = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32), (S, M))
    _, cand_it, pos_it = jax.lax.sort(
        ((~keep).astype(jnp.int32), cand.astype(jnp.int32), pos),
        dimension=1, is_stable=True, num_keys=1)
    cnt_it = keep.sum(axis=1).astype(jnp.int32)
    return cand_it, pos_it, cnt_it


def _inline_bits(cand, nb, sb_mode, m_blocks, dens_skip=None, dkeep=None):
    """Skip words packed from per-block arrays: the kernels have no other
    candidate-validity mask, so padded (-1) entries and past-nb
    superblock members are always marked dens-skip / no-disp (else block
    0 would be double-counted)."""
    S = cand.shape[0]
    if sb_mode:
        e = (jnp.maximum(cand, 0)[:, :, None] * FAN
             + jnp.arange(FAN, dtype=jnp.int32))
        validb = ((cand >= 0)[:, :, None] & (e < nb)).reshape(S, m_blocks)
    else:
        validb = cand >= 0
    skip = ~validb if dens_skip is None else dens_skip | ~validb
    keep = (jnp.zeros_like(validb) if dkeep is None
            else dkeep & validb)
    b2 = (skip.astype(jnp.int32) | (keep.astype(jnp.int32) << 1))
    b2 = b2.reshape(S, m_blocks // 16, 16)
    shifts = jnp.arange(16, dtype=jnp.int32) * 2
    return (b2 << shifts).sum(axis=2).astype(jnp.int32)


def _pad_lists(cand, sb_mode, *extra):
    """Pad the list width so expanded block counts land on 16 (the skip
    word packing).  `extra` are (array, fill, per_block) triples padded
    alongside (per-block arrays widen by FAN per superblock)."""
    S, M = cand.shape
    mult = 2 if sb_mode else 16
    pad = (-M) % mult
    if not pad:
        return (cand,) + tuple(a for a, _, _ in extra)
    out = [jnp.concatenate([cand, jnp.full((S, pad), -1, cand.dtype)],
                           axis=1)]
    for a, fill, per_block in extra:
        if a is None:
            out.append(None)
            continue
        w = pad * (FAN if (per_block and sb_mode) else 1)
        out.append(jnp.concatenate(
            [a, jnp.full((S, w), fill, a.dtype)], axis=1))
    return tuple(out)


def _row_refs(xi, r_pair, safe, boxsize):
    """(S, 4) f32 per-row [centre xyz, safe]: the reference point the
    kernels centre pairs on, and the hoisted-wrap validity flag."""
    xlo = xi.min(axis=2)
    xhi = xi.max(axis=2)
    if safe is None:
        safe = jnp.all(0.5 * (xhi - xlo) + r_pair[:, None]
                       < 0.49 * float(boxsize), axis=1)
    return jnp.concatenate(
        [0.5 * (xlo + xhi), safe.astype(jnp.float32)[:, None]],
        axis=1).astype(jnp.float32)


def _src_flat(src_blocks, nb, sb_mode):
    """(nb*rows, B) source table; superblock mode pads a partial last
    superblock with zero rows (zero hm / validity -> inert)."""
    src = src_blocks.reshape(-1, src_blocks.shape[-1]).astype(jnp.float32)
    if sb_mode:
        need = -(-nb // FAN) * FAN * src_blocks.shape[1]
        if src.shape[0] < need:
            src = jnp.concatenate(
                [src, jnp.zeros((need - src.shape[0], src.shape[1]),
                                jnp.float32)])
    return src


def _wrap(x, boxsize, inv_box):
    # min-image wrap; floor(x + 0.5) instead of round (the Triton
    # lowering has no round, and exact halves never reach kernel support)
    return x - boxsize * jnp.floor(x * inv_box + 0.5)


def _m4_w_dw(r, h):
    """Cubic spline kernel and derivative (sph.c:442-466)."""
    u = r / h
    wi = 2.546479089470 + 15.278874536822 * (u - 1.0) * u * u
    wo = 5.092958178941 * (1.0 - u) ** 3
    w = jnp.where(u < 0.5, wi, jnp.where(u < 1.0, wo, 0.0)) / (h * h * h)
    di = u * (45.836623610466 * u - 30.557749073644)
    do = -15.278874536822 * (1.0 - u) ** 2
    dw = jnp.where(u < 0.5, di, jnp.where(u < 1.0, do, 0.0)) \
        / (h * h * h * h)
    return w, dw


def _m4_flat(u):
    wi = 2.546479089470 + 15.278874536822 * (u - 1.0) * u * u
    wo = 5.092958178941 * (1.0 - u) ** 3
    return jnp.where(u < 0.5, wi, jnp.where(u < 1.0, wo, 0.0))


def _stream(n_grp, fan, cand_at, bits_fn, n_rows, keep_fn, tile_fn, acc):
    """One loop over the member blocks of a row's list entries: test each
    member's skip field and run `tile_fn(row0, b2, acc)` on the kept
    ones (row0 = the member's first row in the flattened source table).
    The members are not unrolled: one tile body keeps the Triton
    compile short."""
    def body(i, acc):
        g = i // fan
        f = i - g * fan
        b2 = bits_fn(g, f)
        row0 = (jnp.maximum(cand_at(g), 0) * fan + f) * n_rows
        return jax.lax.cond(keep_fn(b2), partial(tile_fn, row0, b2),
                            lambda a: a, acc)
    return jax.lax.fori_loop(0, n_grp * fan, body, acc)


def _wvt_kernel(kernel_kind, desnngb, mpart, boxsize, n_sweeps, fan,
                do_disp, rows, n_words,
                cand_ref, cnt_ref, bits_ref, pos_ref, ref_ref, xi_ref,
                h0_ref, cap_ref, hm_ref, src_ref, out_ref):
    f32 = jnp.float32
    nsub = BLOCK // rows
    p = pl.program_id(0)
    s = p // nsub
    lanes = pl.ds(pl.multiple_of((p % nsub) * rows, rows), rows)
    inv_box = 1.0 / boxsize

    xr = [ref_ref[s, d] for d in range(3)]
    safe = ref_ref[s, 3] > 0.5
    xi_c = [xi_ref[s, d, lanes][:, None] - xr[d] for d in range(3)]
    cap_v = cap_ref[s, lanes]                            # (R,)
    hm_i = hm_ref[s, lanes][:, None]                     # (R, 1)
    n_grp = cnt_ref[s]

    def cand_at(g):
        return cand_ref[s, g]

    def bits_fn(g, f):
        idx = pos_ref[s, g] * fan + f
        word = bits_ref[s, jnp.minimum(idx >> 4, n_words - 1)]
        return (word >> (2 * (idx & 15))) & 3

    def load_src(row0, wrap):
        """Member source rows centred on the row's reference point.
        Safe rows wrap the centred row once (any in-range pair then
        lands at its min-image separation, far ones only farther);
        unsafe rows re-wrap per pair in the tile."""
        t = [src_ref[row0 + d, :][None, :] - xr[d] for d in range(3)]
        if not wrap:
            t = [_wrap(x, boxsize, inv_box) for x in t]
        return t, src_ref[row0 + 3, :][None, :]

    def tile_r2(t, wrap):
        r2 = jnp.zeros((rows, BLOCK), f32)
        dx = []
        for d in range(3):
            dd = xi_c[d] - t[d]
            if wrap:
                dd = _wrap(dd, boxsize, inv_box)
            dx.append(dd)
            r2 = r2 + dd * dd
        return r2, dx

    def dens_sums(u, vj, h, r):
        """Raw per-receiver density sums of one tile (WC6 from u, M4
        from r); norm_sums applies the h-dependent normalisation."""
        if kernel_kind == "m4":
            w, dw = _m4_w_dw(r, h)
            return (jnp.sum(w * vj, axis=1), jnp.sum(r * dw * vj, axis=1))
        t = jnp.maximum(1.0 - u, 0.0) * vj
        t2 = t * t
        t4 = t2 * t2
        t7 = t4 * t2 * t
        wpoly = 1.0 + u * (8.0 + u * (25.0 + 32.0 * u))
        dpoly = u * u * (1.0 + u * (7.0 + 16.0 * u))
        return jnp.sum(t4 * t4 * wpoly, axis=1), jnp.sum(t7 * dpoly, axis=1)

    def disp_coef(r2, r, inv_r, hj):
        """Masked flat-kernel displacement coefficient w(u)/r in world
        units (hm rides box units; w * dx/r is unit-free)."""
        hbar = (hm_i + hj) * (0.5 * boxsize)
        mask = (r2 < hbar * hbar) & (r2 > 0.0) & (hj > 0.0)
        u = jnp.where(mask, r / hbar, 1.0)
        if kernel_kind == "m4":
            wflat = _m4_flat(u)
        else:
            t = jnp.maximum(1.0 - u, 0.0)
            t2 = t * t
            t4 = t2 * t2
            wflat = t4 * t4 * (1.0 + u * (8.0 + u * (25.0 + 32.0 * u)))
        return jnp.where(mask, wflat, 0.0) * inv_r

    def branch(pass_fn, acc):
        """Row-level branch on the hoisted-wrap validity."""
        return jax.lax.cond(safe, partial(pass_fn, False),
                            partial(pass_fn, True), acc)

    def density_pass(h):
        inv_h2 = 1.0 / (h * h)

        def run(wrap, acc):
            def tile(row0, b2, acc):
                t, hj = load_src(row0, wrap)
                r2, _ = tile_r2(t, wrap)
                vj = (hj > 0).astype(f32)
                if kernel_kind == "m4":
                    sw, sr = dens_sums(None, vj, h, jnp.sqrt(r2))
                else:
                    sw, sr = dens_sums(jnp.sqrt(r2 * inv_h2), vj, h, None)
                return acc[0] + sw, acc[1] + sr
            return _stream(n_grp, fan, cand_at, bits_fn, 4,
                           lambda b2: (b2 & 1) == 0, tile, acc)

        zero = jnp.zeros((rows,), f32)
        return branch(run, (zero, zero))

    def union_pass(h):
        """Sweep 0 with the displacement: one stream over the union of
        the density and displacement member sets, each part gated by its
        own skip bit, sharing the pair distances."""
        inv_h = 1.0 / h

        def run(wrap, acc):
            def tile(row0, b2, acc):
                t, hj = load_src(row0, wrap)
                r2, dx = tile_r2(t, wrap)
                inv_r = jax.lax.rsqrt(jnp.maximum(r2, 1e-30))
                r = r2 * inv_r

                def dens(a):
                    vj = (hj > 0).astype(f32)
                    sw, sr = dens_sums(r * inv_h, vj, h, r)
                    return (a[0] + sw, a[1] + sr) + a[2:]

                def disp(a):
                    coef = disp_coef(r2, r, inv_r, hj)
                    return a[:2] + tuple(
                        a[2 + d] + jnp.sum(coef * dx[d], axis=1)
                        for d in range(3))

                acc = jax.lax.cond((b2 & 1) == 0, dens, lambda a: a, acc)
                return jax.lax.cond((b2 & 2) == 2, disp, lambda a: a, acc)
            return _stream(n_grp, fan, cand_at, bits_fn, 4,
                           lambda b2: ((b2 & 1) == 0) | ((b2 & 2) == 2),
                           tile, acc)

        zero = jnp.zeros((rows,), f32)
        return branch(run, (zero,) * 5)

    def norm_sums(h, raw_w, raw_rdw):
        if kernel_kind == "m4":
            return raw_w, raw_rdw
        inv_h = 1.0 / h
        norm_h3 = _WC6_NORM * inv_h * inv_h * inv_h
        return raw_w * norm_h3, raw_rdw * (-22.0 * norm_h3)

    spec_win = (const.NNGBDEV * desnngb / _SPEC_KAPPA) ** 0.5

    def update(k, h, lo, hi, done, raw_w, raw_rdw):
        """Newton/bisection h update (sph.c:175-195) with SPECULATIVE
        ACCEPT: the Newton contraction of wkNgb(h) is quadratic, so a
        lane whose deviation is already < spec_win takes its in-range
        Newton step and freezes without the confirming density sweep;
        the epilogue first-order-extrapolates its sums over h - h_meas.
        The reference always re-measures (sph.c:159-166); the kappa-
        scaled window keeps accepted lanes inside |wkNgb-295| < 0.05."""
        sum_w, sum_rdw = norm_sums(h, raw_w, raw_rdw)
        wk_ngb = const.FOURPITHIRD * h * h * h * sum_w
        rho = mpart * sum_w
        drho = -mpart * (3.0 / h * sum_w + sum_rdw / h)
        ngb_dev = jnp.abs(wk_ngb - desnngb)
        now_done = ngb_dev < const.NNGBDEV
        omega = 1.0 + drho * h / (3.0 * jnp.maximum(rho, 1e-30))
        fac = 1.0 - (wk_ngb - desnngb) / (
            3.0 * jnp.maximum(wk_ngb, 1e-30) * omega)
        fac = jnp.clip(fac, 1.0 / 1.24, 1.24)
        hi_n = jnp.where(wk_ngb > desnngb, h, hi)
        lo_n = jnp.where(wk_ngb < desnngb, h, lo)
        h_bis = (0.5 * (lo_n * lo_n * lo_n + hi_n * hi_n * hi_n)) \
            ** (1.0 / 3.0)
        h_new = jnp.where(ngb_dev < 0.5 * desnngb, h * fac, h_bis)
        h_new = jnp.minimum(h_new, cap_v)
        spec = ((done < 0.5) & ~now_done & (ngb_dev < spec_win)
                & (h * fac < cap_v))
        freeze = (done > 0.5) | now_done
        keep = freeze | spec
        # sums always correspond to this update's input h; only lanes
        # that continue move to h_new before their next measurement
        return (k + 1, jnp.where(freeze, h, h_new),
                jnp.where(keep, h, h_new), lo_n, hi_n,
                jnp.where(keep, 1.0, 0.0).astype(f32), raw_w, raw_rdw)

    def newton(state):
        k, h, _, lo, hi, done, _, _ = state
        raw_w, raw_rdw = density_pass(h[:, None])
        return update(k, h, lo, hi, done, raw_w, raw_rdw)

    def cond(state):
        return (state[0] < n_sweeps) & (jnp.min(state[5]) < 0.5)

    h0c = jnp.minimum(h0_ref[s, lanes], cap_v)
    zero = jnp.zeros((rows,), f32)
    if do_disp:
        raw_w, raw_rdw, *disp_acc = union_pass(h0c[:, None])
    else:
        raw_w, raw_rdw = density_pass(h0c[:, None])
        disp_acc = (zero, zero, zero)
    state = update(jnp.int32(0), h0c, zero, cap_v, zero, raw_w, raw_rdw)
    _, h, h_meas, _, _, done_f, raw_w, raw_rdw = jax.lax.while_loop(
        cond, newton, state)
    # the sums correspond to h_meas (== h except for speculatively
    # accepted lanes): extrapolate sum_w to h through
    # d(sum_w)/dh = -(3 sum_w + sum_rdw)/h
    sum_w, sum_rdw = norm_sums(h_meas, raw_w, raw_rdw)
    sum_w = sum_w - (3.0 * sum_w + sum_rdw) / h_meas * (h - h_meas)

    wk_ngb = const.FOURPITHIRD * h * h * h * sum_w
    rho = mpart * sum_w
    drho = -mpart * (3.0 / h * sum_w + sum_rdw / h)
    now_done = jnp.abs(wk_ngb - desnngb) < const.NNGBDEV
    rho_out = rho
    if kernel_kind == "wc6":  # Dehnen+12 (sph.c:202-210)
        w0 = _WC6_NORM / (h * h * h)
        rho_out = rho + (-0.0116 * (desnngb * 0.01) ** (-2.236)
                         * mpart * w0)
    dnorm = hm_ref[s, lanes] * (1.0 if kernel_kind == "m4" else _WC6_NORM)
    outs = (rho_out, h,
            1.0 / (1.0 + h / (3.0 * jnp.maximum(rho, 1e-30)) * drho),
            wk_ngb, jnp.where((done_f > 0.5) | now_done, 1.0, 0.0),
            dnorm * disp_acc[0], dnorm * disp_acc[1], dnorm * disp_acc[2])
    for k, v in enumerate(outs):
        out_ref[s, k, lanes] = v.astype(f32)


def _compiler_params():
    return pl_triton.CompilerParams(num_warps=_NUM_WARPS,
                                    num_stages=_NUM_STAGES)


@partial(jax.jit,
         static_argnames=("kernel", "desnngb", "n_sweeps", "interpret",
                          "mpart", "boxsize", "sb_mode", "do_disp"))
def stream_wvt(src_blocks, cand, cnt, xi, h0, cap, hm_i, mpart, boxsize,
               gdist=None, dkeep=None, *, kernel="wc6", desnngb=295,
               n_sweeps=16, interpret=False, sb_mode=False, do_disp=True,
               bits=None, safe=None, cand_pos=None):
    """Fused density solve + WVT displacement over candidate lists.

    src_blocks: (nb, 4, B) sorted sources — rows 0-2 coords (world), row
    3 the metric hsml in box units (0 on invalid lanes; doubles as the
    validity mask).  cand (S, M) block ids (-1 padded) or superblock ids
    with sb_mode; cnt (S,) true counts (clamped to the list width, so
    lists truncated at build time are safe); xi (S, 3, B), h0/cap/hm_i
    (S, B) receivers.  Skip words come from `bits` (stream_skip_bits,
    with `cand_pos` the compacted-slot map of compact_sb_lists) or are
    packed inline from `gdist` (S, M_blocks) world-unit distance lower
    bounds and `dkeep` (S, M_blocks) displacement keeps.  `safe` (S,)
    marks rows where the hoisted periodic wrap is valid; None computes
    it here.  Returns (rho, hsml, var_fac, wk_ngb, done, delta) as
    (S, B) arrays and (S, B, 3) (delta None without do_disp).
    """
    _check_interpret(interpret)
    S = cand.shape[0]
    nb = src_blocks.shape[0]
    f32 = jnp.float32
    cand, cand_pos, gdist, dkeep = _pad_lists(
        cand, sb_mode, (cand_pos, 0, False), (gdist, jnp.inf, True),
        (dkeep, False, True))
    M = cand.shape[1]
    m_blocks = M * FAN if sb_mode else M
    nw = m_blocks // 16
    if bits is None:
        qscale = float(2 ** 22) / float(boxsize)
        hq = jnp.minimum(cap.max(axis=1) * qscale,
                         float(2 ** 30)).astype(jnp.int32) + 1
        dens_skip = None
        if gdist is not None:
            dens_skip = jnp.minimum(gdist * qscale, float(2 ** 30)).astype(
                jnp.int32) > hq[:, None]
        bits = _inline_bits(cand, nb, sb_mode, m_blocks, dens_skip,
                            jnp.ones((S, m_blocks), bool) if dkeep is None
                            else dkeep)
    elif bits.shape[1] != nw:
        raise ValueError(f"skip-bit width {bits.shape[1]} != expected {nw} "
                         f"(m_blocks={m_blocks})")
    if cand_pos is None:
        cand_pos = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32), (S, M))
    cnt = jnp.minimum(cnt.astype(jnp.int32), M)

    r_pair = cap.max(axis=1)
    if do_disp:
        r_pair = jnp.maximum(
            r_pair, 0.5 * (hm_i.max(axis=1) + src_blocks[:, 3, :].max())
            * float(boxsize))
    refs = _row_refs(xi, r_pair, safe, boxsize)

    kern = partial(_wvt_kernel, kernel, float(desnngb), float(mpart),
                   float(boxsize), n_sweeps, FAN if sb_mode else 1,
                   do_disp, _ROWS, nw)
    out = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((S, 8, BLOCK), f32),
        grid=(S * (BLOCK // _ROWS),), interpret=interpret,
        backend="triton", compiler_params=_compiler_params(),
        name="stream_wvt",
    )(cand.astype(jnp.int32), cnt, bits.astype(jnp.int32),
      cand_pos.astype(jnp.int32), refs, xi.astype(f32), h0.astype(f32),
      cap.astype(f32), hm_i.astype(f32), _src_flat(src_blocks, nb, sb_mode))
    rho, h, vf, wk, done_f = (out[:, k, :] for k in range(5))
    delta = out[:, 5:8, :].transpose(0, 2, 1) if do_disp else None
    return rho, h, vf, wk, done_f > 0.5, delta


# --------------------------- stream SPH curl ---------------------------
# B_i = (-m/rho_i) varHsmlFac_i sum_j dW(r,h_i)/r (d x (A_i - A_j)),
# Price JCP 2010 eq. 79 (sph.c:216-300), on the same candidate machinery
# as the WVT density.  The pair difference dA = A_i - A_j is formed PER
# PAIR inside the tile: splitting into receiver/source partial sums
# (S0 x A_i - T) nearly cancels wherever A varies slowly and costs up to
# 5e-2 relative error in f32, while the per-pair dA is cancellation-free.

_CROWS = 8  # source rows per block: x0 x1 x2 valid a0 a1 a2 pad


def _curl_kernel(kernel_kind, boxsize, fan, rows, n_words,
                 cand_ref, cnt_ref, bits_ref, ref_ref, xi_ref, h_ref,
                 wfac_ref, ap_ref, src_ref, out_ref):
    f32 = jnp.float32
    nsub = BLOCK // rows
    p = pl.program_id(0)
    s = p // nsub
    lanes = pl.ds(pl.multiple_of((p % nsub) * rows, rows), rows)
    inv_box = 1.0 / boxsize

    xr = [ref_ref[s, d] for d in range(3)]
    safe = ref_ref[s, 3] > 0.5
    xi_c = [xi_ref[s, d, lanes][:, None] - xr[d] for d in range(3)]
    ai = [ap_ref[s, d, lanes][:, None] for d in range(3)]
    h_i = h_ref[s, lanes][:, None]
    wfac = wfac_ref[s, lanes]
    inv_h = 1.0 / h_i
    h2 = h_i * h_i
    inv_h5 = inv_h * inv_h * inv_h * inv_h * inv_h
    n_grp = cnt_ref[s]

    def cand_at(g):
        return cand_ref[s, g]

    def bits_fn(g, f):
        idx = g * fan + f
        word = bits_ref[s, jnp.minimum(idx >> 4, n_words - 1)]
        return (word >> (2 * (idx & 15))) & 3

    def run(wrap, acc):
        def tile(row0, b2, acc):
            t = [src_ref[row0 + d, :][None, :] - xr[d] for d in range(3)]
            if not wrap:
                t = [_wrap(x, boxsize, inv_box) for x in t]
            vj = src_ref[row0 + 3, :][None, :]
            r2 = jnp.zeros((rows, BLOCK), f32)
            dx = []
            for d in range(3):
                dd = xi_c[d] - t[d]
                if wrap:
                    dd = _wrap(dd, boxsize, inv_box)
                dx.append(dd)
                r2 = r2 + dd * dd
            mask = (r2 < h2) & (r2 > 0.0) & (vj > 0.0)
            u = jnp.sqrt(r2) * inv_h
            # w = dW(r, h_i)/dr / r, with dW/dr per ops/kernels.py
            if kernel_kind == "m4":
                inv_u = jax.lax.rsqrt(jnp.maximum(r2, 1e-30)) * h_i
                inner = 45.836623610466 * u - 30.557749073644
                tt = jnp.maximum(1.0 - u, 0.0)
                outer = -15.278874536822 * tt * tt * inv_u
                w = jnp.where(u < 0.5, inner, outer) * inv_h5
            else:
                tt = jnp.maximum(1.0 - u, 0.0)
                t3 = tt * tt * tt
                w = (_WC6_NORM * inv_h5 * (-22.0) * t3 * t3 * tt
                     * (16.0 * u * u + 7.0 * u + 1.0))
            w = jnp.where(mask, w, 0.0)
            da = [ai[d] - src_ref[row0 + 4 + d, :][None, :]
                  for d in range(3)]
            return (acc[0] + jnp.sum(w * (dx[2] * da[1] - dx[1] * da[2]),
                                     axis=1),
                    acc[1] + jnp.sum(w * (dx[0] * da[2] - dx[2] * da[0]),
                                     axis=1),
                    acc[2] + jnp.sum(w * (dx[1] * da[0] - dx[0] * da[1]),
                                     axis=1))
        return _stream(n_grp, fan, cand_at, bits_fn, _CROWS,
                       lambda b2: (b2 & 1) == 0, tile, acc)

    zero = jnp.zeros((rows,), f32)
    acc = jax.lax.cond(safe, partial(run, False), partial(run, True),
                       (zero, zero, zero))
    for d in range(3):
        out_ref[s, d, lanes] = wfac * acc[d]


@partial(jax.jit,
         static_argnames=("kernel", "mpart", "boxsize", "sb_mode",
                          "interpret"))
def stream_curl(src_blocks, cand, cnt, xi, hsml, wfac, apot_t, mpart,
                boxsize, *, kernel="wc6", sb_mode=False, bits=None,
                safe=None, interpret=False):
    """Stream SPH curl.

    src_blocks: (nb, 8, B) sorted sources — rows 0-2 coords (world),
    row 3 validity (1/0), rows 4-6 the vector potential, row 7 padding.
    cand (S, M) block ids (-1 padded) or superblock ids with sb_mode;
    cnt (S,); xi (S, 3, B); hsml/wfac (S, B) solved smoothing length
    and the per-receiver factor -mpart*varHsmlFac/rho; apot_t (S, 3, B)
    receiver vector potential.  `bits`/`safe` as in stream_wvt (density
    bit only; None packs validity inline with no distance pruning).
    Returns (S, B, 3) curl in receiver order."""
    del mpart  # carried by wfac
    _check_interpret(interpret)
    S = cand.shape[0]
    nb = src_blocks.shape[0]
    f32 = jnp.float32
    (cand,) = _pad_lists(cand, sb_mode)
    M = cand.shape[1]
    m_blocks = M * FAN if sb_mode else M
    nw = m_blocks // 16
    if bits is None:
        bits = _inline_bits(cand, nb, sb_mode, m_blocks)
    elif bits.shape[1] != nw:
        raise ValueError(f"skip-bit width {bits.shape[1]} != expected {nw}")
    cnt = jnp.minimum(cnt.astype(jnp.int32), M)
    refs = _row_refs(xi, hsml.max(axis=1), safe, boxsize)

    kern = partial(_curl_kernel, kernel, float(boxsize),
                   FAN if sb_mode else 1, _ROWS, nw)
    out = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((S, 3, BLOCK), f32),
        grid=(S * (BLOCK // _ROWS),), interpret=interpret,
        backend="triton", compiler_params=_compiler_params(),
        name="stream_curl",
    )(cand.astype(jnp.int32), cnt, bits.astype(jnp.int32), refs,
      xi.astype(f32), hsml.astype(f32), wfac.astype(f32),
      apot_t.astype(f32), _src_flat(src_blocks, nb, sb_mode))
    return out.transpose(0, 2, 1)
