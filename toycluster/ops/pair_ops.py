"""Fixed-shape pair operators over the block-sparse neighbour structure.

Each operator processes a *selection* of receiver blocks (ops/blocks.py
candidate lists are heavily skewed — central blocks see ~30 candidates,
tapered outskirt blocks a thousand — so the driver buckets blocks by
candidate count and invokes each operator once per count class with that
class's static width M; see models/sph.py).  Per chunk of G receiver
blocks: gather the candidate blocks' particles ((G, M*B) source lanes),
build the masked periodic pairwise-distance matrix, and accumulate.

This is the XLA path (the CPU engine, and the reference the GPU kernels of
ops/stream.py are checked against); ops/stream.py fuses the same
contracts into Triton kernels.

Operators (reference counterparts):
* solve_density — SPH density + adaptive hsml Newton/bisection solve with
  the |wkNgb - DESNNGB| < NNGBDEV contract and Dehnen+12 bias correction
  (sph.c:13-214)
* wvt_displacement — WVT repulsion step (wvt_relax.c:126-171)
* sph_curl — B = rot(A), Price JCP 2010 eq. 79 (sph.c:216-300)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import constants as const
from .blocks import BLOCK, BlockIndex
from .kernels import kernel_fns

_G = 4  # receiver blocks per map step


class BlockSelection(NamedTuple):
    """A subset of receiver blocks plus their candidate lists.

    ids:  (S,) int32 receiver block ids, -1 padded
    cand: (S, M) int32 candidate block ids, -1 padded
    """
    ids: jnp.ndarray
    cand: jnp.ndarray


def full_selection(bi: BlockIndex, cand_idx) -> BlockSelection:
    nb = bi.n_blocks
    return BlockSelection(ids=jnp.arange(nb, dtype=jnp.int32),
                          cand=cand_idx)


def _chunked(sel: BlockSelection):
    """Pad the selection to a multiple of _G and reshape to chunks."""
    s = sel.ids.shape[0]
    nchunk = -(-s // _G)
    pad = nchunk * _G - s
    ids = jnp.concatenate([sel.ids, jnp.full((pad,), -1, jnp.int32)])
    cand = jnp.concatenate(
        [sel.cand, jnp.full((pad, sel.cand.shape[1]), -1, jnp.int32)])
    return (ids.reshape(nchunk, _G),
            cand.reshape(nchunk, _G, sel.cand.shape[1]))


def _min_image(d, boxsize):
    return d - boxsize * jnp.round(d / boxsize)


def _gather(bi: BlockIndex, ids, cidx):
    """(G,B,3) receiver coords, (G,M*B,3) sources, (G,M*B) source mask,
    (G,M*B) source indices, (G,B) receiver indices (into sorted layout)."""
    pos_b = bi.pos.reshape(-1, BLOCK, 3)
    valid_b = bi.valid.reshape(-1, BLOCK)
    ids_c = jnp.maximum(ids, 0)
    xi = pos_b[ids_c]                                   # (G,B,3)
    cc = jnp.maximum(cidx, 0)                           # (G,M)
    xj = pos_b[cc].reshape(_G, -1, 3)                   # (G,M*B,3)
    vj = (valid_b[cc] & (cidx >= 0)[:, :, None]).reshape(_G, -1)
    src = (cc[:, :, None] * BLOCK
           + jnp.arange(BLOCK, dtype=jnp.int32)).reshape(_G, -1)
    rcv = ids_c[:, None] * BLOCK + jnp.arange(BLOCK, dtype=jnp.int32)
    return xi, xj, vj, src, rcv


def _r2(xi, xj, boxsize):
    r2 = 0.0
    for d in range(3):
        dd = _min_image(xi[:, :, None, d] - xj[:, None, :, d], boxsize)
        r2 = r2 + dd * dd
    return r2


class DensityResult(NamedTuple):
    rho: jnp.ndarray           # (S*B,)
    hsml: jnp.ndarray
    var_hsml_fac: jnp.ndarray
    wk_ngb: jnp.ndarray
    done: jnp.ndarray
    saturated: jnp.ndarray


@partial(jax.jit, static_argnames=("kernel", "desnngb", "max_iter"))
def solve_density(bi: BlockIndex, sel: BlockSelection, hsml0, h_cap,
                  mpart, boxsize, *, kernel="wc6", desnngb=295,
                  max_iter=32) -> DensityResult:
    """Adaptive-hsml SPH density over the selected blocks.

    Solves (4pi/3) h^3 sum_j W(r_ij,h) = DESNNGB to |wkNgb - DESNNGB| <
    NNGBDEV by guarded Newton-Raphson with bisection bounds (the
    reference's scheme, sph.c:156-195) as masked fixed-shape sweeps over
    the precomputed candidate distances.  `hsml0`/`h_cap` are (P,) arrays
    in sorted layout; `h_cap` is the radius the candidate lists were built
    for — particles pushing h to the cap are flagged `saturated` (the
    caller rebuilds with a larger cap, the analogue of the reference's
    grow-and-research loop, sph.c:36-64).  Results are (S*B,) in selection
    order.
    """
    w_fn, dw_fn, _ = kernel_fns(kernel)
    nngbdev = const.NNGBDEV
    ids_c, cand_c = _chunked(sel)
    # hsml0/h_cap may be (P,) global sorted layout or (S, B) receiver rows
    # (the sharded path passes rows so receiver-only arrays never need an
    # all_gather)
    s = sel.ids.shape[0]

    def rows(x):
        if x.ndim == 2 and x.shape[0] == s:
            r = x
        else:
            r = x.reshape(-1, BLOCK)[jnp.maximum(sel.ids, 0)]
        pad = ids_c.size - s
        if pad:
            r = jnp.concatenate([r, jnp.zeros((pad, BLOCK), r.dtype)])
        return r.reshape(-1, _G, BLOCK)

    h0_c = rows(hsml0)
    cap_c = rows(h_cap)

    def chunk_fn(args):
        ids, cidx, h0, cap = args
        xi, xj, vj, _, _ = _gather(bi, ids, cidx)
        r = jnp.sqrt(_r2(xi, xj, boxsize))               # (G,B,MB)
        vjf = vj[:, None, :].astype(r.dtype)

        def sums(h):
            w = w_fn(r, h[..., None]) * vjf
            dw = dw_fn(r, h[..., None]) * vjf
            wk_ngb = const.FOURPITHIRD * h**3 * w.sum(-1)
            rho = mpart * w.sum(-1)
            drho = -mpart * ((3.0 / h)[..., None] * w
                             + (r / h[..., None]) * dw).sum(-1)
            return wk_ngb, rho, drho

        def body(state):
            it, h, lo, hi, done = state
            wk_ngb, rho, drho = sums(h)
            ngb_dev = jnp.abs(wk_ngb - desnngb)
            now_done = ngb_dev < nngbdev
            # Newton near the root (sph.c:175-184)
            omega = 1.0 + drho * h / (3.0 * jnp.maximum(rho, 1e-30))
            fac = 1.0 - (wk_ngb - desnngb) / (
                3.0 * jnp.maximum(wk_ngb, 1e-30) * omega)
            fac = jnp.clip(fac, 1.0 / 1.24, 1.24)
            h_newton = h * fac
            # bisection elsewhere (sph.c:186-195)
            hi_b = jnp.where(wk_ngb > desnngb, h, hi)
            lo_b = jnp.where(wk_ngb < desnngb, h, lo)
            h_bisect = (0.5 * (lo_b**3 + hi_b**3)) ** (1.0 / 3.0)
            use_newton = ngb_dev < 0.5 * desnngb
            h_new = jnp.where(use_newton, h_newton, h_bisect)
            h_new = jnp.minimum(h_new, cap)
            h = jnp.where(done | now_done, h, h_new)
            return it + 1, h, lo_b, hi_b, done | now_done

        def cond(state):
            it, _, _, _, done = state
            return (~jnp.all(done)) & (it < max_iter)

        h = jnp.minimum(h0, cap)
        # init `done` as h<0 (all False) rather than jnp.zeros: under
        # shard_map the carry must share h's varying-manual-axes type
        state = (0, h, jnp.zeros_like(h), cap, h < 0)
        _, h, _, _, done = jax.lax.while_loop(cond, body, state)

        wk_ngb, rho, drho = sums(h)
        var_fac = 1.0 / (1.0 + h / (3.0 * jnp.maximum(rho, 1e-30)) * drho)
        if kernel == "wc6":  # Dehnen+12 WC6 bias correction (sph.c:202-210)
            rho = rho + (-0.0116 * (desnngb * 0.01) ** (-2.236)
                         * mpart * w_fn(jnp.zeros_like(h), h))
        saturated = (~done) | (h >= cap * 0.999)
        return rho, h, var_fac, wk_ngb, done, saturated

    out = jax.lax.map(chunk_fn, (ids_c, cand_c, h0_c, cap_c))
    return DensityResult(*[o.reshape(-1)[: s * BLOCK] for o in out])


@partial(jax.jit, static_argnames=("kernel",))
def wvt_displacement(bi: BlockIndex, sel: BlockSelection, hsml_box, step,
                     boxsize, *, kernel="wc6"):
    """WVT repulsion: delta_i = sum_j step * h_i * W(r/hbar) * (dx/r) in
    box units, pair cut r < hbar = (h_i+h_j)/2 (wvt_relax.c:126-171).
    `hsml_box` is the (P,) dimensionless metric hsml in sorted layout;
    returns (S*B, 3) in selection order."""
    _, _, wflat = kernel_fns(kernel)
    ids_c, cand_c = _chunked(sel)
    h_b = hsml_box.reshape(-1, BLOCK)

    def chunk_fn(args):
        ids, cidx = args
        xi, xj, vj, src, _ = _gather(bi, ids, cidx)
        h_i = h_b[jnp.maximum(ids, 0)]
        h_j = hsml_box[src]                              # (G,MB)
        hbar = 0.5 * (h_i[:, :, None] + h_j[:, None, :])
        dx = [_min_image(xi[:, :, None, d] - xj[:, None, :, d], boxsize)
              / boxsize for d in range(3)]
        r2 = dx[0] ** 2 + dx[1] ** 2 + dx[2] ** 2
        r = jnp.sqrt(r2)
        mask = (r2 < hbar * hbar) & (r2 > 0.0) & vj[:, None, :]
        w = jnp.where(mask, wflat(r / hbar), 0.0)
        inv_r = jnp.where(mask, 1.0 / jnp.maximum(r, 1e-30), 0.0)
        coef = step * h_i[:, :, None] * w * inv_r
        return jnp.stack([(coef * dx[d]).sum(-1) for d in range(3)],
                         axis=-1)

    out = jax.lax.map(chunk_fn, (ids_c, cand_c))
    return out.reshape(-1, 3)[: sel.ids.shape[0] * BLOCK]


@partial(jax.jit, static_argnames=("kernel",))
def sph_curl(bi: BlockIndex, sel: BlockSelection, hsml, rho, var_fac,
             apot, mpart, boxsize, *, kernel="wc6"):
    """B_i = sum_j (-m/rho_i) dW(r,h_i)/r varHsmlFac_i (d x dA), Price JCP
    2010 eq. 79 (sph.c:216-300).  Inputs (P,)/(P,3) in sorted layout;
    returns (S*B, 3) in selection order."""
    _, dw_fn, _ = kernel_fns(kernel)
    ids_c, cand_c = _chunked(sel)
    h_b = hsml.reshape(-1, BLOCK)
    rho_b = rho.reshape(-1, BLOCK)
    vf_b = var_fac.reshape(-1, BLOCK)

    def chunk_fn(args):
        ids, cidx = args
        xi, xj, vj, src, rcv = _gather(bi, ids, cidx)
        idc = jnp.maximum(ids, 0)
        h_i, rho_i, vf_i = h_b[idc], rho_b[idc], vf_b[idc]
        dx = [_min_image(xi[:, :, None, d] - xj[:, None, :, d], boxsize)
              for d in range(3)]
        r2 = dx[0] ** 2 + dx[1] ** 2 + dx[2] ** 2
        r = jnp.sqrt(r2)
        h = h_i[:, :, None]
        mask = (r2 < h * h) & (r2 > 0.0) & vj[:, None, :]
        dw = jnp.where(mask, dw_fn(r, h), 0.0)
        inv_r = jnp.where(mask, 1.0 / jnp.maximum(r, 1e-30), 0.0)
        weight = (-mpart / rho_i[:, :, None]) * dw * inv_r \
            * vf_i[:, :, None]
        ai = apot[rcv]                                   # (G,B,3)
        aj = apot[src]                                   # (G,MB,3)
        dA = [ai[:, :, None, d] - aj[:, None, :, d] for d in range(3)]
        bx = (weight * (dx[2] * dA[1] - dx[1] * dA[2])).sum(-1)
        by = (weight * (dx[0] * dA[2] - dx[2] * dA[0])).sum(-1)
        bz = (weight * (dx[1] * dA[0] - dx[0] * dA[1])).sum(-1)
        return jnp.stack([bx, by, bz], axis=-1)

    out = jax.lax.map(chunk_fn, (ids_c, cand_c))
    return out.reshape(-1, 3)[: sel.ids.shape[0] * BLOCK]
