import math

import numpy as np
import pytest

from toycluster import STOCK_PAR, parse_par_file
from toycluster.models import profiles
from toycluster.models.substructure import (
    gao04_radius_fraction, nfw_mass, setup_substructure,
    subhalo_mass_function, MIN_DENSITY_CONTRAST)
from toycluster.scene import build_scene


@pytest.fixture(scope="module")
def sub_scene():
    # ntotal large enough that MIN_SUBHALO_MASS < the Giocoli mass cap,
    # so the mass function actually gets sampled (substructure.c:116-160)
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=200000, sph_kernel="m4", substructure=True)
    base = build_scene(cfg)
    return base, setup_substructure(base, seed=5)


def test_subhalos_created_and_budgeted(sub_scene):
    base, scene = sub_scene
    assert scene.nhalos > scene.sub_first
    # particle budget conserved: subhalos drawn from the host's allocation
    # (substructure.c:403-405)
    assert sum(h.npart_gas for h in scene.halos) == base.npart_gas
    assert sum(h.npart_dm for h in scene.halos) == base.npart_dm
    host = scene.halos[0]
    subs = scene.halos[scene.sub_first:]
    assert all(s.npart_dm > 0 for s in subs)
    # mass fraction targets Giocoli 0.22 sqrt(1+z) of the host DM within
    # sampling tolerance (last subhalo granularity)
    m_sub = sum(s.mass_dm for s in subs)
    frac = 0.22 * math.sqrt(1 + scene.config.redshift)
    limit = frac * base.halos[0].mass200_dm
    min_mass = 10 * scene.config.desnngb * (base.mpart_gas
                                            + base.mpart_dm)
    # the loop may overshoot by at most ~max(0.05*limit, MIN_SUBHALO_MASS)
    assert m_sub <= limit + max(0.05 * limit, min_mass) + 1e-6
    assert m_sub >= 0.5 * limit
    # several distinct masses -> the Giocoli function was sampled
    assert len({round(s.mass_dm, 3) for s in subs}) > 2


def test_subhalo_placement_constraints(sub_scene):
    base, scene = sub_scene
    host = scene.halos[0]
    subs = scene.halos[scene.sub_first:]
    soft = scene.grav_softening
    for i, s in enumerate(subs):
        r = np.linalg.norm(np.array(s.d_com) - np.array(host.d_com))
        assert r <= host.r200 * (1 + 1e-6)
        # density contrast (substructure.c:253-259)
        rho_host = profiles.hernquist_density(r, host.mass_dm,
                                              host.a_hernq)
        rho_sub = profiles.hernquist_density(3 * soft, s.mass_dm,
                                             s.a_hernq)
        assert rho_sub >= rho_host * MIN_DENSITY_CONTRAST * 0.999
        # no overlaps (substructure.c:232-245)
        for t in subs[:i]:
            d = np.linalg.norm(np.array(s.d_com) - np.array(t.d_com))
            assert d >= (s.r_sample_gas + t.r_sample_gas) * 0.999
        # internal consistency of the NFW fixed point
        assert s.r200 == pytest.approx(s.rs * s.c_nfw)
        assert s.a_hernq == pytest.approx(
            profiles.hernquist_a_from_nfw(s.rs, s.c_nfw))
        assert s.mass200_dm == pytest.approx(
            nfw_mass(s.c_nfw, s.rs, s.r200,
                     overdensity=scene.cosmo.overdensity_parameter(),
                     rho_crit0_code=scene.cosmo.rho_crit0
                     / scene.units.density), rel=1e-6)
        # Kepler-ish bulk velocity present (non-slow path)
        assert np.linalg.norm(s.bulk_vel) > 0


def test_gao04_inversion_monotone():
    xs = [gao04_radius_fraction(q, 4.0) for q in (0.1, 0.3, 0.6, 0.9)]
    assert all(b > a for a, b in zip(xs, xs[1:]))
    assert 0 < xs[0] and xs[-1] <= 1.0
    # closure: profile(x) == q
    ac = 0.244 * 4.0
    for q, x in zip((0.1, 0.3, 0.6, 0.9), xs):
        val = (1 + ac) * x ** 2.75 / (1 + ac * x ** 2)
        assert val == pytest.approx(q, abs=2e-3)


def test_mass_function_shape():
    # dN/dm ~ m^-0.9 at low mass: ratio check
    kw = dict(host_m200_dm=8e4, redshift=0.5, unit_mass=1.989e43)
    lo = subhalo_mass_function(1e1, **kw) / 1e1
    hi = subhalo_mass_function(1e2, **kw) / 1e2
    assert lo / hi == pytest.approx(10 ** 1.9, rel=0.05)


def test_sampling_with_substructure(sub_scene):
    """End-to-end position sampling over host + subhalos: ownership rules
    must place each subhalo's DM inside its sampling sphere."""
    import jax
    from toycluster.models import positions as pos_mod
    from toycluster.particles import halo_arrays_from_scene

    base, scene = sub_scene
    ha = halo_arrays_from_scene(scene)
    key = jax.random.PRNGKey(2)
    i = scene.sub_first  # first subhalo
    s = scene.halos[i]
    pos, acc = pos_mod.sample_halo_dm(key, ha, i, min(s.npart_dm, 2000),
                                      scene.sub_first, scene.boxsize)
    assert bool(acc.all())
    r = np.linalg.norm(np.asarray(pos), axis=-1)
    assert r.max() <= s.r_sample_dm * 1.001
