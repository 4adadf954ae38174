import math

import numpy as np
import pytest

from toycluster import STOCK_PAR, constants as const
from toycluster import parse_par_file
from toycluster.scene import build_scene


def small_cfg(**kw):
    cfg = parse_par_file(STOCK_PAR)
    return cfg.replace(ntotal=20000, **kw)


def test_single_cluster_scene():
    scene = build_scene(small_cfg())
    assert scene.nhalos == 1
    h = scene.halos[0]
    # R200 consistency: M200 = Delta rho_crit (4pi/3) R200^3
    rho_crit = scene.cosmo.critical_density(scene.config.redshift)
    delta = scene.cosmo.overdensity_parameter()
    m200 = (delta * rho_crit * const.FOURPITHIRD
            * (h.r200 * scene.units.length) ** 3 / scene.units.mass)
    assert m200 == pytest.approx(h.mtotal200, rel=1e-12)
    # boxsize = floor(7.5 R200) (setup.c:65)
    assert scene.boxsize == math.floor(7.5 * h.r200)
    # halo 0 fills the box (setup.c:73-77)
    assert h.r_sample_dm == scene.boxsize / 2
    assert h.r_sample_gas == pytest.approx(math.sqrt(3) * scene.boxsize / 2)
    assert h.rcut == pytest.approx(1.4 * h.r200)
    # rho0 calibration: M_gas(R200) == gas share of M200 (setup.c:93-99)
    assert h.mass_table.mass(h.r200) == pytest.approx(h.mass200_gas,
                                                      rel=1e-5)
    # gas/DM split of mass200 by baryon fraction (setup.c:50-51)
    assert h.mass200_gas / h.mtotal200 == pytest.approx(0.17 / 1.17)
    # c_nfw in the expected Duffy08 range for a 1e15 Msol cluster at z=0.87
    assert 2.0 < h.c_nfw < 5.0
    # particle counts: ~50/50 split (setup.c:189-201)
    assert scene.npart_gas + scene.npart_dm == scene.ntotal
    assert abs(scene.npart_gas - scene.npart_dm) / scene.ntotal < 0.25
    # particle masses consistent with halo masses
    assert scene.mpart_gas * scene.npart_gas == pytest.approx(h.mass_gas)
    assert scene.mpart_dm * scene.npart_dm == pytest.approx(h.mass_dm,
                                                            rel=1e-3)
    # effective baryon fraction should be below bf_200 (known behaviour)
    assert 0.05 < h.bf_eff < 0.25


def test_dm_only_scene():
    scene = build_scene(small_cfg(baryon_fraction=0.0))
    assert scene.dm_only
    assert scene.npart_gas == 0
    h = scene.halos[0]
    assert h.npart_gas == 0
    assert h.mass_gas == 0.0
    assert h.npart_dm == pytest.approx(20000, abs=2)
    assert scene.mpart_dm == pytest.approx(scene.mtotal / 20000)


def test_merger_scene_kinematics():
    scene = build_scene(small_cfg(mass_ratio=0.5))
    assert scene.nhalos == 2
    h0, h1 = scene.halos
    # mass split (setup.c:36-37)
    assert h0.mtotal200 == pytest.approx(1e5 / 1.5)
    assert h1.mtotal200 == pytest.approx(1e5 - h0.mtotal200)
    # initial separation & CoM preservation (setup.c:276-293)
    d = 0.9 * (h0.r200 + h1.r200)
    assert h1.d_com[0] - h0.d_com[0] == pytest.approx(d)
    assert (h0.mtotal200 * h0.d_com[0] + h1.mtotal200 * h1.d_com[0]
            ) == pytest.approx(0.0, abs=1e-6 * d)
    # impact parameter in y
    assert h1.d_com[1] - h0.d_com[1] == pytest.approx(50.0)
    # zero-energy orbit velocity, scaled by ZeroEOrbitFrac (setup.c:295-302)
    G = scene.units.G
    v0 = math.sqrt(2 * G * h1.mtotal200 / (d * (1 + 1 / 0.5))) * 0.8
    assert scene.vel_merger[0] == pytest.approx(v0)
    # v1 = -Mtot200/M1_200 * v0 (setup.c:298-299); NB this is the
    # reference's convention, it does not conserve momentum by design
    assert scene.vel_merger[1] == pytest.approx(
        -1e5 / h1.mtotal200 * scene.vel_merger[0])
    # COMET orbit: no bulk velocity stamped at setup (setup.c:305-311)
    assert h0.bulk_vel == (0.0, 0.0, 0.0)
    # direct orbit: stamped
    scene2 = build_scene(small_cfg(mass_ratio=0.5, orbit="direct"))
    assert scene2.halos[0].bulk_vel[0] == pytest.approx(
        scene2.vel_merger[0])


def test_giveparams_scene():
    scene = build_scene(small_cfg(give_params=True, mass_ratio=0.5))
    h0, h1 = scene.halos
    assert h0.c_nfw == 4.0 and h1.c_nfw == 4.089
    assert h0.beta == 0.54 and h1.beta == 0.79
    assert h0.rcore == 30.0 and h1.rcore == 300.0
    assert scene.vel_merger == (0.0, 0.0)


def test_cuspy_bitmask():
    scene = build_scene(small_cfg(cuspy=1, mass_ratio=0.5))
    h0, h1 = scene.halos
    assert h0.have_cuspy and not h1.have_cuspy
    assert h0.rcore == pytest.approx(h0.rs / 9)
    assert h1.rcore == pytest.approx(h1.rs / 3)
