import jax
import numpy as np
import pytest

from toycluster import STOCK_PAR, parse_par_file
from toycluster.models import profiles
from toycluster.models.ids import id_stride, make_ids
from toycluster.models import positions as pos_mod
from toycluster.particles import halo_arrays_from_scene
from toycluster.scene import build_scene


def cfg_small(**kw):
    return parse_par_file(STOCK_PAR).replace(
        ntotal=20000, **kw)


@pytest.fixture(scope="module")
def single_scene():
    scene = build_scene(cfg_small())
    return scene, halo_arrays_from_scene(scene)


def radii(pos):
    return np.linalg.norm(np.asarray(pos), axis=-1)


def test_dm_radial_profile_matches_hernquist(single_scene):
    scene, ha = single_scene
    h = scene.halos[0]
    key = jax.random.PRNGKey(0)
    pos, acc = pos_mod.sample_halo_dm(key, ha, 0, 40000, scene.sub_first,
                                      scene.boxsize)
    assert bool(acc.all())
    r = radii(pos)
    assert r.max() <= h.r_sample_dm * 1.001
    # empirical CDF vs Hernquist M(<r)/M(<rmax)
    for frac in (0.25, 0.5, 0.75):
        q = frac * h.mass_corr_fac
        r_expect = profiles.hernquist_sample_radius(q, h.a_hernq)
        emp = np.mean(r < r_expect)
        assert emp == pytest.approx(frac, abs=0.02)


def test_gas_radial_profile_matches_mass_table(single_scene):
    scene, ha = single_scene
    h = scene.halos[0]
    key = jax.random.PRNGKey(1)
    pos, acc = pos_mod.sample_halo_gas(key, ha, 0, 40000, scene.boxsize)
    assert bool(acc.all())
    r = radii(pos)
    # box rejection clips the corners: all samples inside the half-box cube
    assert np.abs(np.asarray(pos)).max() <= scene.boxsize / 2 + 1e-3
    for frac in (0.2, 0.5, 0.8):
        r_expect = h.mass_table.radius(frac * h.mass_gas)
        # conditional CDF: P(r < r_q | inside box); for r_q well inside the
        # box the cube clipping only rescales by the acceptance rate
        inside_frac = np.mean(r < r_expect)
        # acceptance = fraction of total mass inside the cube
        assert inside_frac >= frac - 0.02


def test_gas_profile_cdf_unclipped(single_scene):
    # use radii far inside the box where clipping is irrelevant
    scene, ha = single_scene
    h = scene.halos[0]
    key = jax.random.PRNGKey(2)
    pos, _ = pos_mod.sample_halo_gas(key, ha, 0, 40000, scene.boxsize)
    r = radii(pos)
    for frac in (0.1, 0.3, 0.5):
        r_q = h.mass_table.radius(frac * h.mass_gas)
        assert np.mean(r < r_q) == pytest.approx(
            frac / _cube_acceptance(h, scene), abs=0.02)


def _cube_acceptance(h, scene):
    # fraction of the sampled gas mass that survives the cube rejection;
    # estimated from the mass inside the inscribed sphere plus corners —
    # bounded between M(box/2) and M(sqrt3 box/2) shares
    lo = h.mass_table.mass(scene.boxsize / 2) / h.mass_gas
    hi = 1.0
    return (lo + hi) / 2  # loose; tolerance above absorbs it


def test_two_halo_ownership(single_scene):
    scene = build_scene(cfg_small(mass_ratio=0.5))
    ha = halo_arrays_from_scene(scene)
    key = jax.random.PRNGKey(3)
    # halo 1 DM must live inside its sampling sphere with x>0
    pos, acc = pos_mod.sample_halo_dm(key, ha, 1, 5000, scene.sub_first,
                                      scene.boxsize)
    assert bool(acc.all())
    pos_abs = np.asarray(pos) + np.asarray(ha.d_com)[1]
    assert (pos_abs[:, 0] > 0).all()
    r1 = np.linalg.norm(pos_abs - np.asarray(ha.d_com)[1], axis=-1)
    assert (r1 < scene.halos[1].r_sample_dm).all()
    # halo 0 DM must NOT satisfy halo 1's ownership test
    pos0, acc0 = pos_mod.sample_halo_dm(key, ha, 0, 5000, scene.sub_first,
                                        scene.boxsize)
    pos0_abs = np.asarray(pos0) + np.asarray(ha.d_com)[0]
    r1 = np.linalg.norm(pos0_abs - np.asarray(ha.d_com)[1], axis=-1)
    in_h1 = (r1 < scene.halos[1].r_sample_dm) & (pos0_abs[:, 0] > 0)
    assert not in_h1.any()
    # gas ownership is the density argmax (positions.c:363-385)
    gpos, gacc = pos_mod.sample_halo_gas(key, ha, 1, 5000, scene.boxsize)
    owner = pos_mod.halo_containing_gas(
        gpos + np.asarray(ha.d_com)[1], ha, scene.boxsize)
    assert (np.asarray(owner) == 1).all()


def test_shift_origin_wraps(single_scene):
    scene, ha = single_scene
    key = jax.random.PRNGKey(4)
    parts = pos_mod.make_positions(key, scene, ha)
    parts = pos_mod.shift_origin(parts, ha, scene.boxsize)
    p = np.asarray(parts.pos)
    assert p.min() >= 0.0
    assert p.max() <= scene.boxsize
    assert parts.n_total == scene.ntotal


def test_id_stride():
    assert id_stride(1000) == 200
    assert id_stride(1 << 20) == 128
    assert 1_000_000 % id_stride(1_000_000) == 0
    assert id_stride(1_000_000) >= 128


def test_make_ids_matches_reference_loop():
    n_gas, n_total = 1000, 2000
    ids = make_ids(n_gas, n_total)
    # replicate the reference's serial loop (ids.c:25-39)
    delta = id_stride(n_gas)
    ref = np.empty(n_gas, np.uint32)
    idv, start = 1 - delta, 1
    for k in range(n_gas):
        idv += delta
        if idv > n_gas:
            start += 1
            idv = start
        ref[k] = idv
    assert (ids[:n_gas] == ref).all()
    assert (ids[n_gas:] == np.arange(n_gas, n_total) + 1).all()
    # ids are a permutation of 1..n_gas
    assert set(ids[:n_gas]) == set(range(1, n_gas + 1))


def test_mass_census_matches_mass200():
    """Show_mass_in_r200 (positions.c:142-216): the sampled mass inside
    each halo's R200 must reproduce its Mass200 within sampling noise —
    the reference's headline sampling oracle."""
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=40000, mass_ratio=0.5)
    scene = build_scene(cfg)
    ha = halo_arrays_from_scene(scene)
    parts = pos_mod.make_positions(jax.random.PRNGKey(5), scene, ha)
    parts = pos_mod.shift_origin(parts, ha, scene.boxsize)

    recs = pos_mod.show_mass_in_r200(scene, parts)
    assert len(recs) == 2
    from toycluster import constants as const
    for rec, h in zip(recs, scene.halos):
        m200_msol = h.mtotal200 * scene.units.mass / const.MSOL2CGS
        # two-halo overlap + finite-N noise: the census must land within
        # ~10% of the model Mass200 at this particle count
        assert rec["total_mass_r200"] == pytest.approx(m200_msol,
                                                       rel=0.10)
        # gas calibration (setup.c:93-99) is tighter than the DM census
        m200_gas = h.mass200_gas * scene.units.mass / const.MSOL2CGS
        assert rec["gas_mass_r200"] == pytest.approx(m200_gas, rel=0.12)
    # effective baryon fraction lands near bf within noise
    assert recs[0]["bf_eff_r200"] == pytest.approx(
        scene.cosmo.baryon_fraction, rel=0.25)


def test_stage_tables_render():
    """The reference stdout tables (unit.c:9-17, cosmo.c:22-33,
    setup.c:117-190, setup.c:313-327) render without error and carry the
    headline numbers."""
    import io
    import sys
    from toycluster.utils import logging as tlog

    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=2000, mass_ratio=0.5)
    scene = build_scene(cfg)
    cap = io.StringIO()
    err0 = sys.stderr
    sys.stderr = cap
    try:
        tlog.report_units(scene.units)
        tlog.report_cosmology(scene.cosmo, cfg.redshift)
        tlog.report_halo_setup(scene)
        tlog.report_kinematics(scene)
    finally:
        sys.stderr = err0
    out = cap.getvalue()
    assert "Setting System of Units" in out
    assert f"Unit Length = {scene.units.length:g} cm" in out
    assert "rho_crit(0)" in out
    assert "Halo Setup : <0>" in out and "Halo Setup : <1>" in out
    assert f"R200              = {scene.halos[0].r200:g} kpc" in out
    assert "Kinematics of Collision" in out
    assert f"Initial Distance    = {scene.d_clusters:g} kpc" in out
