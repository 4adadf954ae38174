import jax
import numpy as np
import pytest

from toycluster import STOCK_PAR, parse_par_file
from toycluster.models import positions as pos_mod
from toycluster.models import velocities as vel_mod
from toycluster.particles import halo_arrays_from_scene
from toycluster.scene import build_scene


def hernquist_sigma_r2(r, m, a, G):
    """Hernquist 1990 eq. 10 (isotropic radial dispersion)."""
    x = r / a
    return (G * m / (12 * a)
            * (12 * r * (r + a) ** 3 / a ** 4 * np.log((r + a) / r)
               - r / (r + a) * (25 + 52 * x + 42 * x ** 2 + 12 * x ** 3)))


@pytest.fixture(scope="module")
def dm_only():
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=30000, baryon_fraction=0.0)
    scene = build_scene(cfg)
    ha = halo_arrays_from_scene(scene)
    key = jax.random.PRNGKey(7)
    parts = pos_mod.make_positions(key, scene, ha)
    parts = pos_mod.shift_origin(parts, ha, scene.boxsize)
    parts = vel_mod.make_velocities(key, scene, ha, parts)
    return scene, parts


def test_speeds_bounded_by_escape_velocity(dm_only):
    scene, parts = dm_only
    h = scene.halos[0]
    d = np.asarray(parts.pos) - scene.boxhalf
    r = np.maximum(0.1, np.linalg.norm(d, axis=-1))
    vt = vel_mod.build_velocity_tables(scene, 0)
    psi = np.asarray(vel_mod.potential_device(vt, r.astype(np.float32)))
    v = np.linalg.norm(np.asarray(parts.vel), axis=-1)
    assert (v <= np.sqrt(2 * psi) * (1 + 1e-5)).all()
    # rejection must succeed for essentially all particles
    assert np.mean(v == 0) < 1e-3


def test_velocity_dispersion_matches_jeans(dm_only):
    """<v^2>(r) vs 3 sigma_r^2 from the analytic isotropic Hernquist
    solution; the truncated sampling deviates only near R_sample."""
    scene, parts = dm_only
    h = scene.halos[0]
    G = scene.units.G
    d = np.asarray(parts.pos) - scene.boxhalf
    r = np.linalg.norm(d, axis=-1)
    v2 = (np.asarray(parts.vel) ** 2).sum(axis=-1)
    edges = h.a_hernq * np.array([0.1, 0.2, 0.4, 0.7, 1.0, 1.5])
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (r > lo) & (r < hi)
        assert sel.sum() > 400
        r_mid = np.median(r[sel])
        expected = 3 * hernquist_sigma_r2(r_mid, h.mass_dm, h.a_hernq, G)
        got = v2[sel].mean()
        assert got == pytest.approx(expected, rel=0.08), (lo, hi)


def test_isotropy(dm_only):
    scene, parts = dm_only
    vel = np.asarray(parts.vel)
    v2 = (vel ** 2).sum(axis=-1).mean()
    for k in range(3):
        assert (vel[:, k] ** 2).mean() == pytest.approx(v2 / 3, rel=0.05)
        assert abs(vel[:, k].mean()) < 0.05 * np.sqrt(v2)
