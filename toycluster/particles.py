"""Device particle state (SoA pytrees).

Replaces the reference's global AoS arrays `P[]`/`SphP[]`
(globals.h:161-180) with immutable jnp struct-of-arrays pytrees; the
reference's per-halo slice pointers (setup.c:253-264) become a `halo`
membership array.  Layout matches the reference: gas particles first
([0, npart_gas)), DM after, each grouped by halo.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from .scene import Scene


class Particles(NamedTuple):
    """All particles. Gas first, then DM (io.c block order relies on this)."""
    pos: jnp.ndarray          # (N,3) f32, box coords after shift_origin
    vel: jnp.ndarray          # (N,3) f32
    pid: jnp.ndarray          # (N,)  uint32
    halo: jnp.ndarray         # (N,)  int32 halo membership
    # gas-only fields, shape (Ngas,) / (Ngas,3); empty arrays when DM-only
    u: jnp.ndarray
    rho: jnp.ndarray
    hsml: jnp.ndarray
    var_hsml_fac: jnp.ndarray
    rho_model: jnp.ndarray
    bfld: jnp.ndarray
    apot: jnp.ndarray

    @property
    def n_total(self) -> int:
        return self.pos.shape[0]

    @property
    def n_gas(self) -> int:
        return self.u.shape[0]

    @property
    def gas_pos(self) -> jnp.ndarray:
        return self.pos[: self.n_gas]

    def is_gas_index(self):
        return jnp.arange(self.n_total) < self.n_gas


def empty_particles(n_gas: int, n_dm: int) -> Particles:
    n = n_gas + n_dm
    f3 = jnp.zeros((n, 3), jnp.float32)
    return Particles(
        # vel is LAZY like bfld/apot (allocated by the velocity stage,
        # velocities.add_bulk_velocities): nothing reads it before then
        # and a (1e8, 3) zeros buffer costs 1.2 GB through the WVT loop
        pos=f3, vel=jnp.zeros((0, 3), jnp.float32),
        pid=jnp.zeros((n,), jnp.uint32),
        halo=jnp.zeros((n,), jnp.int32),
        u=jnp.zeros((n_gas,), jnp.float32),
        rho=jnp.zeros((n_gas,), jnp.float32),
        hsml=jnp.zeros((n_gas,), jnp.float32),
        var_hsml_fac=jnp.zeros((n_gas,), jnp.float32),
        rho_model=jnp.zeros((n_gas,), jnp.float32),
        # bfld/apot are LAZY (allocated by the B-field stage): 1.2 GB
        # of zeros at 5e7 gas otherwise rides through the whole WVT loop
        bfld=jnp.zeros((0, 3), jnp.float32),
        apot=jnp.zeros((0, 3), jnp.float32),
    )


class HaloArrays(NamedTuple):
    """Per-halo model parameters stacked for device-side vectorisation
    (the device twin of `struct HaloProperties`, globals.h:132-159)."""
    d_com: jnp.ndarray          # (H,3)
    bulk_vel: jnp.ndarray       # (H,3)
    r_sample_gas: jnp.ndarray   # (H,)
    r_sample_dm: jnp.ndarray
    r200: jnp.ndarray
    rcut: jnp.ndarray
    rho0: jnp.ndarray
    beta: jnp.ndarray
    rcore: jnp.ndarray
    have_cuspy: jnp.ndarray     # (H,) f32 0/1
    is_stripped: jnp.ndarray    # (H,) bool
    a_hernq: jnp.ndarray
    mass_corr_fac: jnp.ndarray
    mass_gas: jnp.ndarray
    mass_dm: jnp.ndarray
    # inverse cumulative gas mass splines r(M), stacked knots (H,K)
    minv_x: jnp.ndarray
    minv_y: jnp.ndarray
    minv_m2: jnp.ndarray

    @property
    def n_halos(self) -> int:
        return self.d_com.shape[0]


def halo_arrays_from_scene(scene: Scene, dtype=jnp.float32) -> HaloArrays:
    hs = scene.halos
    H = len(hs)

    def stack(fn, shape=()):
        return jnp.asarray(np.array([fn(h) for h in hs], np.float64), dtype)

    ntab = max((h.mass_table.r.shape[0] for h in hs
                if h.mass_table is not None), default=2)
    minv_x = np.zeros((H, ntab))
    minv_y = np.zeros((H, ntab))
    minv_m2 = np.zeros((H, ntab))
    for i, h in enumerate(hs):
        if h.mass_table is not None:
            sp = h.mass_table.inv_spline
            minv_x[i], minv_y[i], minv_m2[i] = sp.x, sp.y, sp.m2
        else:
            minv_x[i] = np.arange(ntab)  # degenerate but monotone

    return HaloArrays(
        d_com=stack(lambda h: h.d_com),
        bulk_vel=stack(lambda h: h.bulk_vel),
        r_sample_gas=stack(lambda h: h.r_sample_gas),
        r_sample_dm=stack(lambda h: h.r_sample_dm),
        r200=stack(lambda h: h.r200),
        rcut=stack(lambda h: h.rcut),
        rho0=stack(lambda h: h.rho0),
        beta=stack(lambda h: h.beta),
        rcore=stack(lambda h: max(h.rcore, 1e-30)),
        have_cuspy=stack(lambda h: 1.0 if h.have_cuspy else 0.0),
        is_stripped=jnp.asarray([h.is_stripped for h in hs]),
        a_hernq=stack(lambda h: h.a_hernq),
        mass_corr_fac=stack(lambda h: h.mass_corr_fac),
        mass_gas=stack(lambda h: h.mass_gas),
        mass_dm=stack(lambda h: h.mass_dm),
        minv_x=jnp.asarray(minv_x, dtype),
        minv_y=jnp.asarray(minv_y, dtype),
        minv_m2=jnp.asarray(minv_m2, dtype),
    )


def gas_density_device(r, ha: HaloArrays, j: int, cool_core=None,
                       beta=None):
    """Device twin of Gas_density_profile (setup.c:598-615) for halo j.

    `beta` (static python float) short-circuits the per-particle pow
    when every halo shares one beta: the default beta=2/3 gives the
    closed form 1/(1+x^2), far cheaper than the pow in the WVT
    iteration's rho_model stage, which evaluates this for every
    particle x halo."""
    taper = 1.0 + (r / ha.rcut[j]) ** 4
    x2 = 1.0 + (r / ha.rcore[j]) ** 2
    if beta is not None and abs(beta - 2.0 / 3.0) < 1e-12:
        xp = 1.0 / x2
    elif beta is not None:
        xp = x2 ** (-1.5 * float(beta))
    else:
        xp = x2 ** (-1.5 * ha.beta[j])
    rho = ha.rho0[j] * xp / taper
    if cool_core is not None:
        rho0_fac, rc_fac = cool_core
        rho_cc = (ha.rho0[j] * rho0_fac
                  / (1.0 + (r / (ha.rcore[j] / rc_fac)) ** 2) / taper)
        rho = rho + ha.have_cuspy[j] * rho_cc
    return rho
