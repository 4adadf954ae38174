"""Stacked-table temperature evaluation vs the literal per-halo masked
loop (temperature.c:8-44 semantics): one batched gather-eval program
must reproduce the per-halo spline_eval/where chain exactly."""

import jax
import jax.numpy as jnp
import numpy as np

from toycluster import STOCK_PAR, parse_par_file
from toycluster.models import positions as pos_mod
from toycluster.models import temperature as temp_mod
from toycluster.models.tables import build_energy_table
from toycluster.ops.interp import SplineTable, spline_eval
from toycluster.particles import halo_arrays_from_scene
from toycluster.scene import build_scene


def _loop_reference_u(scene, parts):
    """The pre-batching implementation: per-halo table, masked where."""
    cfg = scene.config
    n_gas = parts.n_gas
    cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                 if cfg.double_beta_cool_cores else None)
    u = jnp.zeros((n_gas,), jnp.float32)
    gas_halo = parts.halo[:n_gas]
    pos = parts.pos[:n_gas]
    for i, h in enumerate(scene.halos):
        if h.mass_table is None:
            continue
        etab = build_energy_table(
            h.mass_table, rho0=h.rho0, beta=h.beta, rc=h.rcore,
            rcut=h.rcut, is_cuspy=h.have_cuspy, a_hernq=h.a_hernq,
            mdm=h.mass_dm, boxsize=scene.boxsize, G=scene.units.G,
            no_rcut_in_t=cfg.no_rcut_in_t, cool_core=cool_core)
        table = SplineTable.from_host(etab.spline)
        d = pos - (jnp.asarray(h.d_com, jnp.float32) + scene.boxhalf)
        r = jnp.linalg.norm(d, axis=-1)
        u = jnp.where(gas_halo == i,
                      spline_eval(table, r).astype(jnp.float32), u)
    return np.asarray(u)


def test_batched_matches_masked_loop_two_halo():
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=8000, mass_ratio=1.0)
    scene = build_scene(cfg)
    ha = halo_arrays_from_scene(scene)
    parts = pos_mod.make_positions(jax.random.PRNGKey(4), scene, ha)
    parts = pos_mod.shift_origin(parts, ha, scene.boxsize)
    u_new = np.asarray(temp_mod.make_temperatures(scene, parts).u)
    u_old = _loop_reference_u(scene, parts)
    # same table rows, same radii: differences only from the bisection
    # vs searchsorted knot lookup at exact-knot queries (same segment
    # by clamping) and f32 summation order in the radius
    np.testing.assert_allclose(u_new, u_old, rtol=2e-6, atol=0)
    assert (u_new > 0).all()
