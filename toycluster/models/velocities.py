"""DM velocity sampling from the Eddington distribution function
(reference velocities.c:38-159).

The f(E) and potential tables are built host-side in float64
(models/eddington.py); per-particle rejection sampling runs on device as a
masked `lax.while_loop` with counter-based keys, reproducing the reference's
bounded-retry semantics (90,000 tries then v=0, velocities.c:80-95).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as const
from ..ops.interp import SplineTable, batched_spline_eval, \
    flat_gather, spline_eval
from ..particles import HaloArrays, Particles
from ..scene import Scene
from .eddington import build_distribution_function, RMIN



class VelocityTables(NamedTuple):
    """Device export of one halo's f(E) + potential profile."""
    fE: SplineTable             # f(E), ascending E knots
    psi_gas: SplineTable        # gas potential spline (zeros if no gas)
    has_gas: jnp.ndarray        # scalar bool
    psi_rmax: jnp.ndarray       # point-mass continuation beyond r_max
    r_max: jnp.ndarray
    a_hernq: jnp.ndarray
    mass_dm: jnp.ndarray
    mtotal: jnp.ndarray
    G: jnp.ndarray


def build_velocity_tables(scene: Scene, i: int) -> VelocityTables:
    h = scene.halos[i]
    df = build_distribution_function(
        mass_dm=h.mass_dm, a_hernq=h.a_hernq, G=scene.units.G,
        mass_table=h.mass_table, r_sample_gas=h.r_sample_gas,
        has_gas=h.npart_gas > 0)
    f32 = jnp.float32
    if df.psi.gas is not None:
        gas_sp = df.psi.gas.spline
        psi_gas = SplineTable(jnp.asarray(gas_sp.x, f32),
                              jnp.asarray(gas_sp.y, f32),
                              jnp.asarray(gas_sp.m2, f32))
        psi_rmax = jnp.asarray(df.psi.gas.psi_rmax, f32)
        r_max = jnp.asarray(df.psi.gas.r_max, f32)
    else:
        # dummy spline at the REAL table length: gas-free halos must
        # not mint their own sampler program shape (each distinct shape
        # is a fresh XLA compile, and ~50-subhalo scenes would pay one
        # per halo)
        from .eddington import NTABLE
        z = jnp.zeros((NTABLE,), f32)
        psi_gas = SplineTable(jnp.linspace(0.0, 1.0, NTABLE, dtype=f32),
                              z, z)
        psi_rmax = jnp.asarray(0.0, f32)
        r_max = jnp.asarray(1.0, f32)
    return VelocityTables(
        fE=SplineTable(jnp.asarray(df.spline.x, f32),
                       jnp.asarray(df.spline.y, f32),
                       jnp.asarray(df.spline.m2, f32)),
        psi_gas=psi_gas, has_gas=jnp.asarray(df.psi.gas is not None),
        psi_rmax=psi_rmax, r_max=r_max,
        a_hernq=jnp.asarray(h.a_hernq, f32),
        mass_dm=jnp.asarray(h.mass_dm, f32),
        mtotal=jnp.asarray(h.mtotal, f32),
        G=jnp.asarray(scene.units.G, f32))


def potential_device(vt: VelocityTables, r):
    """psi(r) = G M_dm/(r+a) + psi_gas(r) (velocities.c:323-331,437-447)."""
    psi = vt.G * vt.mass_dm / (r + vt.a_hernq)
    inside = spline_eval(vt.psi_gas, jnp.minimum(r, vt.r_max))
    outside = vt.psi_rmax * vt.r_max / jnp.maximum(r, vt.r_max)
    gas = jnp.where(r < vt.r_max, inside, outside)
    return psi + jnp.where(vt.has_gas, gas, 0.0)


_VTAB_V = 256  # speed nodes per CDF row
_VCHUNK = 1 << 18        # sampler page for host halos (one program shape)
_VCHUNK_SMALL = 1 << 14  # sampler shape for subhaloes


@partial(jax.jit, static_argnames=("n_rows",))
def _speed_cdf_table(vt: VelocityTables, r_lo, r_hi, n_rows=512):
    """Tabulated speed CDFs on a log-r grid.

    The reference rejection-samples p(v) proportional to v^2 f(psi(r) -
    v^2/2) per particle with up to 90,000 uniform draws
    (velocities.c:62-95) — a serial-CPU idiom whose low-acceptance
    central lanes make a data-dependent while_loop run minutes on an
    accelerator.  The device-native equivalent draws from the SAME
    distribution by inverting its CDF: one cumulative-trapezoid table
    per radius row, one table lookup per particle, zero loops."""
    r = jnp.geomspace(r_lo, r_hi, n_rows)
    psi = potential_device(vt, r)                         # (R,)
    vmax = jnp.sqrt(2.0 * psi)
    u = jnp.linspace(0.0, 1.0, _VTAB_V)
    v = vmax[:, None] * u[None, :]                        # (R, V)
    e = psi[:, None] - 0.5 * v * v                        # = -E_tot
    f = jnp.maximum(spline_eval(vt.fE, e), 0.0)
    integ = v * v * f
    seg = 0.5 * (integ[:, 1:] + integ[:, :-1])            # trapezoid
    cdf = jnp.concatenate(
        [jnp.zeros((n_rows, 1)), jnp.cumsum(seg, axis=1)], axis=1)
    norm = cdf[:, -1:]
    cdf = cdf / jnp.maximum(norm, 1e-30)
    return r, cdf, vmax, (norm[:, 0] > 0)


def _invert_cdf_rows(cdf, rows, uu):
    """v/vmax for uniform draws uu against per-row CDFs (bisection on the
    _VTAB_V nodes, gather-based — branch-free)."""
    lo = jnp.zeros_like(rows)
    hi = jnp.full_like(rows, _VTAB_V - 1)
    for _ in range(9):  # 2^9 > _VTAB_V
        mid = (lo + hi) // 2
        c = cdf[rows, mid]
        go_hi = uu > c
        lo = jnp.where(go_hi, mid, lo)
        hi = jnp.where(go_hi, hi, mid)
    lo = jnp.minimum(lo, _VTAB_V - 2)
    c0 = cdf[rows, lo]
    c1 = cdf[rows, lo + 1]
    frac = jnp.clip((uu - c0) / jnp.maximum(c1 - c0, 1e-30), 0.0, 1.0)
    return (lo + frac) / (_VTAB_V - 1)


@jax.jit
def sample_speeds(key, vt: VelocityTables, r):
    """Draw |v| ~ 4 pi v^2 f(E)/M for particles at radii r — the exact
    target distribution of the reference's rejection loop
    (velocities.c:62-95), sampled by inverse-CDF tables (see
    _speed_cdf_table).  Rows whose f(E) integrates to zero fall back to
    v=0 (the reference's 90,000-try fallback, velocities.c:94)."""
    n = r.shape[0]
    r = jnp.maximum(jnp.float32(RMIN), r)
    r_lo = jnp.float32(RMIN)
    r_hi = jnp.maximum(jnp.max(r), r_lo * 2.0)
    rtab, cdf, vmax_tab, ok_row = _speed_cdf_table(vt, r_lo, r_hi)
    n_rows = rtab.shape[0]

    x = (jnp.log(r / r_lo) / jnp.log(r_hi / r_lo)) * (n_rows - 1)
    x = jnp.clip(x, 0.0, n_rows - 1 - 1e-4)
    row = x.astype(jnp.int32)
    frac = x - row
    uu = jax.random.uniform(key, (n,))
    u0 = _invert_cdf_rows(cdf, row, uu)
    u1 = _invert_cdf_rows(cdf, jnp.minimum(row + 1, n_rows - 1), uu)
    u_v = (1.0 - frac) * u0 + frac * u1
    # exact per-particle escape speed (not the row's) bounds the draw
    vmax = jnp.sqrt(2.0 * potential_device(vt, r))
    v = u_v * vmax
    good = ok_row[row] | ok_row[jnp.minimum(row + 1, n_rows - 1)]
    return jnp.where(good, v, 0.0)


# ---------------------------------------------------------------------------
# Batched all-halo sampler.
#
# The per-halo chunked path above (sample_speeds per _VCHUNK page) is kept
# for tests and small scenes, but at config-5 scale (73 halos, 5e7 DM) its
# host orchestration dominates: ~200 paged sampler dispatches plus per-halo
# slice/concat programs, each a host round-trip.  The batched path below
# samples every DM particle of every halo in ONE program family: a vmapped
# per-halo CDF-table build, then fixed-shape pages of gather-based inverse
# transforms indexed by each particle's halo id.  Same target distribution
# (velocities.c:62-95), same v=0 fallback, ~4 dispatches total.
# ---------------------------------------------------------------------------

_VPAGE = 1 << 23  # particles per sampler page (fixed program shape)


def stack_velocity_tables(vts):
    """Stack per-halo VelocityTables into one (H, ...) pytree."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *vts)


# flat_gather / batched_spline_eval moved to ops/interp.py (shared with
# the temperature stage); keep the private aliases for local call sites
_flat_gather = flat_gather
_batched_spline_eval = batched_spline_eval


def _batched_potential(vt: VelocityTables, hid, r):
    """potential_device with stacked (H, ...) tables and per-particle halo
    ids (velocities.c:323-331,437-447)."""
    psi = vt.G[hid] * vt.mass_dm[hid] / (r + vt.a_hernq[hid])
    r_max = vt.r_max[hid]
    inside = _batched_spline_eval(vt.psi_gas, hid, jnp.minimum(r, r_max))
    outside = vt.psi_rmax[hid] * r_max / jnp.maximum(r, r_max)
    gas = jnp.where(r < r_max, inside, outside)
    return psi + jnp.where(vt.has_gas[hid], gas, 0.0)


@partial(jax.jit, static_argnames=("n_halos",))
def _page_radius_max(dx, dy, dz, halo, n_halos):
    """Per-halo max radius over one page of halo-centred coordinate
    columns (split columns dodge (N, 3) gather tile-padding — see
    _shift_origin_jit)."""
    r = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    return jax.ops.segment_max(r, halo, num_segments=n_halos)


@jax.jit
def _build_cdf_pack(vts: VelocityTables, r_his):
    """vmapped per-halo speed-CDF tables; r_his (H,) per-halo max radius."""
    r_lo = jnp.float32(RMIN)
    return jax.vmap(
        lambda vt, rh: _speed_cdf_table(
            vt, r_lo, jnp.maximum(rh, r_lo * 2.0)))(vts, r_his)


@jax.jit
def _sample_page(key, vts: VelocityTables, cdf, ok_row, r_his,
                 pos_x, pos_y, pos_z, halo, bulk):
    """Sample one fixed-shape page of DM velocities: inverse-CDF speed
    from the particle's halo row pair, exact per-particle escape-speed
    bound, isotropic direction, plus the halo bulk velocity."""
    n = halo.shape[0]
    n_rows = cdf.shape[1]
    r_lo = jnp.float32(RMIN)
    r = jnp.sqrt(pos_x * pos_x + pos_y * pos_y + pos_z * pos_z)
    r = jnp.maximum(r_lo, r)
    r_hi = jnp.maximum(jnp.take(r_his, halo), r_lo * 2.0)
    x = (jnp.log(r / r_lo) / jnp.log(r_hi / r_lo)) * (n_rows - 1)
    x = jnp.clip(x, 0.0, n_rows - 1 - 1e-4)
    row = x.astype(jnp.int32)
    frac = x - row
    flat0 = halo * n_rows + row
    flat1 = halo * n_rows + jnp.minimum(row + 1, n_rows - 1)
    cdf2 = cdf.reshape(-1, cdf.shape[2])
    k_u, k_d = jax.random.split(key)
    uu = jax.random.uniform(k_u, (n,))
    u0 = _invert_cdf_rows(cdf2, flat0, uu)
    u1 = _invert_cdf_rows(cdf2, flat1, uu)
    u_v = (1.0 - frac) * u0 + frac * u1
    vmax = jnp.sqrt(2.0 * _batched_potential(vts, halo, r))
    ok2 = ok_row.reshape(-1)
    good = ok2[flat0] | ok2[flat1]
    v = jnp.where(good, u_v * vmax, 0.0)
    dirs = _sphere_dirs(k_d, n)
    cols = [v * dirs[:, d] + jnp.take(bulk[:, d], halo) for d in range(3)]
    return jnp.stack(cols, axis=1)


def _sample_dm_batched(key, scene, ha, parts, bulk_vel_stack):
    """All-halo DM velocity assignment (the batched path)."""
    n_gas = scene.npart_gas
    n_dm = parts.n_total - n_gas
    n_halos = scene.nhalos
    centers = ha.d_com + scene.boxhalf
    halo_dm = parts.halo[n_gas:]
    pos_dm = parts.pos[n_gas:]

    vts = stack_velocity_tables(
        [build_velocity_tables(scene, i) for i in range(n_halos)])

    # pass 1: per-halo max radius (pages, host-accumulated)
    r_hi = np.zeros(n_halos, np.float32)
    # pre-split columns once; page slices stay fixed-shape except the tail
    for c0 in range(0, n_dm, _VPAGE):
        c1 = min(c0 + _VPAGE, n_dm)
        h = halo_dm[c0:c1]
        page_max = _page_radius_max(
            pos_dm[c0:c1, 0] - jnp.take(centers[:, 0], h),
            pos_dm[c0:c1, 1] - jnp.take(centers[:, 1], h),
            pos_dm[c0:c1, 2] - jnp.take(centers[:, 2], h),
            h, n_halos)
        r_hi = np.maximum(r_hi, np.asarray(page_max, np.float32))
    r_his = jnp.asarray(r_hi)

    cdf_r, cdf, _vmax_tab, ok_row = _build_cdf_pack(vts, r_his)

    pages = []
    for k, c0 in enumerate(range(0, n_dm, _VPAGE)):
        c1 = min(c0 + _VPAGE, n_dm)
        npad = _VPAGE - (c1 - c0) if (c1 - c0) < _VPAGE and n_dm > _VPAGE \
            else 0
        h = halo_dm[c0:c1]
        px = pos_dm[c0:c1, 0] - jnp.take(centers[:, 0], h)
        py = pos_dm[c0:c1, 1] - jnp.take(centers[:, 1], h)
        pz = pos_dm[c0:c1, 2] - jnp.take(centers[:, 2], h)
        if npad:  # tail page re-uses the full-page program shape
            z = jnp.zeros((npad,), jnp.float32)
            px, py, pz = (jnp.concatenate([a, z]) for a in (px, py, pz))
            h = jnp.concatenate([h, jnp.zeros((npad,), h.dtype)])
        page = _sample_page(jax.random.fold_in(key, 7000 + k), vts, cdf,
                            ok_row, r_his, px, py, pz, h,
                            bulk_vel_stack)
        pages.append(page[:c1 - c0] if npad else page)
    return jnp.concatenate(pages) if len(pages) > 1 else pages[0]


def _sphere_dirs(key, n):
    k1, k2 = jax.random.split(key)
    cos_t = 2.0 * jax.random.uniform(k1, (n,)) - 1.0
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = 2.0 * const.PI * jax.random.uniform(k2, (n,))
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t],
                     axis=-1)


def _wc2(r, h):
    """WC2 kernel used to taper subhalo gas bulk velocities
    (velocities.c:161-167)."""
    u = r / h
    t = jnp.maximum(1.0 - u, 0.0)
    return 21.0 / 2.0 / const.PI / h**3 * t**4 * (1.0 + 4.0 * u)


def slow_substructure_bulk_velocities(scene: Scene, host_df, rng) -> list:
    """SLOW_SUBSTRUCTURE: each subhalo orbits like a test particle of the
    host's f(E) (velocities.c:500-565); returns the per-halo bulk-velocity
    list with subhalo entries replaced."""
    import numpy as np
    bulks = [np.asarray(h.bulk_vel, np.float64) for h in scene.halos]
    host = scene.halos[scene.config.sub_host]
    for i in range(scene.sub_first, scene.nhalos):
        h = scene.halos[i]
        d = np.asarray(h.d_com) - np.asarray(host.d_com)
        r = float(np.linalg.norm(d))
        psi = float(host_df.psi(max(r, RMIN)))
        vmax = (2 * psi) ** 0.5
        qmax = 4 * const.PI * vmax**2 / h.mtotal * float(host_df(psi))
        v = 0.0
        for _ in range(90_000):
            lower = qmax * rng.random()
            v = vmax * rng.random()
            e_tot = 0.5 * v * v - psi
            q = 4 * const.PI * v**2 / h.mtotal * float(host_df(-e_tot))
            if q >= lower:
                break
        v *= scene.config.zero_e_orbit_frac
        ct = 2 * rng.random() - 1
        ph = 2 * const.PI * rng.random()
        st = (max(0.0, 1 - ct * ct)) ** 0.5
        bulks[i] = v * np.array([st * np.cos(ph), st * np.sin(ph), ct])
    return bulks


def add_bulk_velocities(parts: Particles, ha: HaloArrays) -> Particles:
    """The Shift_Origin bulk-velocity add (setup.c:452-467), DEFERRED to
    the velocity stage so the lazy (0, 3) vel array stays unallocated
    through the WVT loop (1.2 GB at 1e8 total particles).  Behaviour
    parity note: the reference adds BulkVel here AND again in
    Make_velocities (gas: velocities.c:119-151; DM's copy is overwritten
    by the sampled assignment at velocities.c:100), so host gas ends at
    2x BulkVel — both adds are reproduced, in the reference's order."""
    vel = parts.vel
    if vel.shape[0] != parts.n_total:
        vel = jnp.zeros((parts.n_total, 3), jnp.float32)
    # per-COLUMN gathers (see positions._shift_origin_jit note)
    vel = jnp.stack(
        [vel[:, d] + jnp.take(ha.bulk_vel[:, d], parts.halo)
         for d in range(3)], axis=1)
    return parts._replace(vel=vel)


def _sample_dm_per_halo(key, scene, ha, parts, bulk_vel):
    """Legacy per-halo chunked sampler (TOYCLUSTER_VEL_PER_HALO=1):
    sampler calls run at exactly TWO shapes (_VCHUNK_SMALL for subhaloes,
    _VCHUNK paged for hosts).  Superseded by _sample_dm_batched for the
    dispatch-count reasons documented there; kept for A/B validation."""
    n_gas = scene.npart_gas
    boxhalf = scene.boxhalf
    dm_offsets = []
    off = n_gas
    for h in scene.halos:
        dm_offsets.append(off)
        off += h.npart_dm

    dm_chunks = []
    for i, h in enumerate(scene.halos):
        if h.npart_dm == 0:
            continue
        vt = build_velocity_tables(scene, i)
        sl = slice(dm_offsets[i], dm_offsets[i] + h.npart_dm)
        d = parts.pos[sl] - (ha.d_com[i] + boxhalf)
        r = jnp.linalg.norm(d, axis=-1)
        ki = jax.random.fold_in(key, 1000 + i)
        n_q = (_VCHUNK_SMALL if h.npart_dm <= _VCHUNK_SMALL
               else _VCHUNK)
        parts_v = []
        for k, c0 in enumerate(range(0, h.npart_dm, n_q)):
            c1 = min(c0 + n_q, h.npart_dm)
            r_pad = jnp.concatenate(
                [r[c0:c1],
                 jnp.broadcast_to(r[c1 - 1:c1], (n_q - (c1 - c0),))])
            kc = jax.random.fold_in(ki, 2 * k)
            v = sample_speeds(kc, vt, r_pad)[:c1 - c0]
            dirs = _sphere_dirs(jax.random.fold_in(kc, 1),
                                n_q)[:c1 - c0]
            parts_v.append(v[:, None] * dirs)
        dm_chunks.append(jnp.concatenate(parts_v) + bulk_vel[i])
    return jnp.concatenate(dm_chunks)


def make_velocities(key, scene: Scene, ha: HaloArrays, parts: Particles
                    ) -> Particles:
    """Assign DM peculiar velocities per halo, then add bulk velocities
    (gas of subhalos tapered by a WC2 kernel weight) (velocities.c:38-159).
    """
    boxhalf = scene.boxhalf
    parts = add_bulk_velocities(parts, ha)
    vel = parts.vel
    n_gas = scene.npart_gas
    cfg = scene.config

    bulk_vel = [jnp.asarray(h.bulk_vel, jnp.float32) for h in scene.halos]

    # SLOW_SUBSTRUCTURE: replace subhalo bulks before any sampling
    if (cfg.substructure and cfg.slow_substructure
            and scene.nhalos > scene.sub_first
            and any(h.npart_dm for h in scene.halos)):
        import numpy as np
        from .eddington import build_distribution_function
        host_df = build_distribution_function(
            mass_dm=scene.halos[0].mass_dm,
            a_hernq=scene.halos[0].a_hernq, G=scene.units.G,
            mass_table=scene.halos[0].mass_table,
            r_sample_gas=scene.halos[0].r_sample_gas,
            has_gas=scene.halos[0].npart_gas > 0)
        bulks = slow_substructure_bulk_velocities(
            scene, host_df, np.random.default_rng(cfg.seed + 99))
        bulk_vel = [jnp.asarray(b, jnp.float32) for b in bulks]

    n_dm = parts.n_total - n_gas
    if n_dm:
        import os as _os
        if _os.environ.get("TOYCLUSTER_VEL_PER_HALO"):
            dm_vel = _sample_dm_per_halo(key, scene, ha, parts, bulk_vel)
        else:
            dm_vel = _sample_dm_batched(key, scene, ha, parts,
                                        jnp.stack(bulk_vel))
        vel = jnp.concatenate([vel[:n_gas], dm_vel])

    # gas bulk velocities (velocities.c:119-151)
    if n_gas:
        sub_hh = jnp.asarray(
            [h.r_sample_gas * 1.1 for h in scene.halos], jnp.float32)
        vel = vel.at[:n_gas].add(_gas_bulk_jit(
            parts.pos[:n_gas], parts.halo[:n_gas],
            jnp.stack(bulk_vel), ha.d_com, sub_hh, scene.sub_first,
            scene.nhalos, boxhalf))

    return parts._replace(vel=vel)


@partial(jax.jit, static_argnums=(5, 6))
def _gas_bulk_jit(pos, gas_halo, bulk_stack, d_com, sub_hh, sub_first,
                  n_halos, boxhalf):
    """Per-COLUMN gathers (see positions._shift_origin_jit); subhalo
    WC2 tapers via fori_loop."""
    bulk = jnp.stack(
        [jnp.take(bulk_stack[:, d], gas_halo) for d in range(3)],
        axis=1)

    def body(i, wk):
        hh = sub_hh[i]
        norm = 21.0 / 2.0 / const.PI / hh**3
        r = jnp.linalg.norm(pos - (d_com[i] + boxhalf), axis=-1)
        return jnp.where(gas_halo == i, _wc2(r, hh) / norm, wk)

    wk = jax.lax.fori_loop(sub_first, n_halos, body,
                           jnp.ones(pos.shape[:1], jnp.float32))
    return bulk * wk[:, None]
