"""Magnetic field from a density-scaled vector potential
(reference magnetic_field.c, Bonafede+ 2010).

A_i = max over gas halos of (rho_model/rho0)^eta, identical in all three
components (magnetic_field.c:33-69); B = rot(A) via the SPH curl operator
over the block-sparse neighbour structure (sph.c:216-300); then a global
normalisation to Bfld_Norm with per-particle caps (18 uG main halos / 2 uG
subhalos, magnetic_field.c:71-131).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import blocks as blk
from ..ops import pair_ops
from ..ops import stream as stream_ops
from ..particles import HaloArrays, Particles, gas_density_device
from ..scene import Scene
from . import positions as pos_mod
from . import sph as sph_mod

BMAX = 18e-6       # magnetic_field.c:4
BMAX_SUB = 2e-6    # magnetic_field.c:113-114

def set_vector_potential(scene: Scene, ha: HaloArrays, parts: Particles
                         ) -> Particles:
    cfg = scene.config
    n_gas = parts.n_gas
    boxhalf = scene.boxhalf
    cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                 if cfg.double_beta_cool_cores else None)
    pos = parts.pos[:n_gas]

    def body(j, a_max):  # fori: see sph.global_density_model
        r = jnp.linalg.norm(pos - (ha.d_com[j] + boxhalf), axis=-1)
        rho_j = gas_density_device(r, ha, j, cool_core)
        a_j = (rho_j / ha.rho0[j]) ** jnp.float32(cfg.bfld_eta)
        a_j = jnp.where(ha.mass_gas[j] > 0, a_j, 0.0)
        return jnp.maximum(a_max, a_j)

    a_max = jax.lax.fori_loop(0, ha.n_halos, body,
                              jnp.zeros((n_gas,), jnp.float32))
    return parts._replace(apot=jnp.repeat(a_max[:, None], 3, axis=1))


def normalise_field(scene: Scene, ha: HaloArrays, bfld, pos_gas
                    ) -> jnp.ndarray:
    """Scale so max|B| sqrt(3) -> Bfld_Norm, then cap (the reference caps
    by the *DM* ownership rule because it passes the particle index as the
    type argument, magnetic_field.c:109 — all but particle 0 take the DM
    branch; we apply the DM branch uniformly)."""
    max_b = jnp.sqrt((bfld ** 2).sum(axis=-1).max())
    norm = scene.config.bfld_norm / max_b / jnp.sqrt(3.0)
    bfld = bfld * norm
    owner = pos_mod.halo_containing_dm(pos_gas - scene.boxhalf, ha,
                                       scene.sub_first, scene.boxsize)
    bmax = jnp.where(owner > 1, BMAX_SUB, BMAX).astype(jnp.float32)
    b2 = (bfld ** 2).sum(axis=-1)
    scale = jnp.where(b2 > bmax * bmax,
                      bmax / jnp.sqrt(jnp.maximum(b2, 1e-45)), 1.0)
    return bfld * scale[:, None]


def _curl_stream(scene, parts, state: sph_mod.NeighbourState,
                 interpret: bool = False):
    """SPH curl through the stream kernel (ops/stream.py stream_curl):
    sources stream once per receiver row through the superblock
    candidate lists, with the same member skip-bit pass the density
    solve uses."""
    n_gas = parts.n_gas
    bi = state.index
    nb = bi.n_blocks
    pad = lambda x: sph_mod._pad_sorted(x, bi.order, bi.n_padded)  # noqa: E731
    h_s = pad(parts.hsml[:n_gas])
    rho_s = pad(parts.rho[:n_gas])
    vf_s = pad(parts.var_hsml_fac[:n_gas])
    apot_s = pad(parts.apot[:n_gas])

    pos_t = bi.pos.reshape(nb, blk.BLOCK, 3).transpose(0, 2, 1)
    valid_b = bi.valid.astype(jnp.float32).reshape(nb, 1, blk.BLOCK)
    ap_t = apot_s.reshape(nb, blk.BLOCK, 3).transpose(0, 2, 1)
    src8 = jnp.concatenate(
        [pos_t, valid_b, ap_t,
         jnp.zeros((nb, 1, blk.BLOCK), jnp.float32)], axis=1)
    h_b = h_s.reshape(nb, blk.BLOCK)
    wfac_b = jnp.where(
        bi.valid, -float(scene.mpart_gas) * vf_s / rho_s,
        0.0).reshape(nb, blk.BLOCK)

    bk = state.buckets or (None, None)
    ids_all = jnp.arange(nb, dtype=jnp.int32)
    bits, safe = stream_ops.stream_skip_bits(
        bi.bb_lo, bi.bb_hi, None, ids_all, state.cand.idx, h_b, None,
        float(scene.boxsize), sb=True, bucket_ids=bk[0],
        bucket_widths=bk[1])
    out = stream_ops.stream_curl(
        src8, state.cand.idx, state.cand.count, pos_t, h_b, wfac_b,
        ap_t, float(scene.mpart_gas), float(scene.boxsize),
        kernel=scene.config.sph_kernel, sb_mode=True, bits=bits,
        safe=safe, interpret=interpret)
    return jnp.zeros((n_gas, 3), jnp.float32).at[bi.order].set(
        out.reshape(-1, 3)[:n_gas])


def make_magnetic_field(scene: Scene, ha: HaloArrays, parts: Particles,
                        state: sph_mod.NeighbourState | None = None,
                        engine: str | None = None) -> Particles:
    """Full pipeline stage (magnetic_field.c:12-26).  Requires gas already
    in block (Morton) order with solved rho/hsml (find_sph_quantities);
    `state` reuses that neighbour structure when it suits the engine
    (default: the backend's, ops.stream.pair_engine)."""
    n_gas = parts.n_gas
    if n_gas == 0:
        return parts
    engine = engine or stream_ops.pair_engine()
    parts = set_vector_potential(scene, ha, parts)

    if sph_mod.is_stream(engine):
        if state is None or not state.sb:
            # the stream engine's structure is superblock-granular; build
            # a fresh gather-range one at the final positions (exact
            # coverage, no cap slack needed — positions are fixed)
            state = sph_mod._build_neighbours_sb(
                parts.pos[:n_gas], parts.hsml[:n_gas], scene.boxsize)
        bfld = _curl_stream(scene, parts, state,
                            interpret=engine == "stream_interpret")
        bfld = normalise_field(scene, ha, bfld, parts.pos[:n_gas])
        return parts._replace(bfld=bfld)

    if state is None or state.sb:
        # XLA engine: block-granular lists feed the pair operator below
        state = sph_mod._build_neighbours_blocks(
            parts.pos[:n_gas], parts.hsml[:n_gas], scene.boxsize)
        # positions are already block-ordered; order must be identity
    bi = state.index

    def pad1(x):
        p = bi.n_padded - x.shape[0]
        return jnp.concatenate([x, jnp.broadcast_to(x[-1:], (p,)
                                                    + x.shape[1:])])

    h_s, rho_s, vf_s = (pad1(parts.hsml), pad1(parts.rho),
                        pad1(parts.var_hsml_fac))
    apot_s = pad1(parts.apot)

    def curl_class(sel, m):
        return (pair_ops.sph_curl(
            bi, sel, h_s, rho_s, vf_s, apot_s, scene.mpart_gas,
            scene.boxsize, kernel=scene.config.sph_kernel),)

    def curl_tail(ids, sb_rows, sb_cnt):
        sel = pair_ops.BlockSelection(
            ids=ids, cand=sph_mod.expand_tail_rows(sb_rows, bi.n_blocks))
        return curl_class(sel, sel.cand.shape[1])

    (bfld_sorted,) = sph_mod.run_classed(state, curl_class, curl_tail)
    # map back through the (near-identity) sort of this build
    bfld = jnp.zeros((n_gas, 3), jnp.float32).at[bi.order].set(
        bfld_sorted[:n_gas])

    bfld = normalise_field(scene, ha, bfld, parts.pos[:n_gas])
    return parts._replace(bfld=bfld)
