import numpy as np
import pytest

from toycluster import constants as const
from toycluster.models import profiles
from toycluster.models.tables import (build_mass_table,
                                          build_potential_table,
                                          build_energy_table)
from toycluster.utils.splines import NaturalSpline


def test_natural_spline_matches_function():
    # sin on [0, pi] has sin''=0 at both ends -> natural BC is exact
    x = np.linspace(0, np.pi, 200)
    y = np.sin(x)
    sp = NaturalSpline.build(x, y)
    xq = np.linspace(0.05, np.pi - 0.05, 777)
    assert np.allclose(sp(xq), np.sin(xq), atol=1e-8)
    assert np.allclose(sp.deriv2(xq), -np.sin(xq), atol=1e-3)


def test_mass_table_matches_beta23_closed_form():
    # beta = 2/3: quadrature table must match the closed form (setup.c:724)
    rho0, rc, rcut = 3.7e-5, 100.0, 2000.0
    tab = build_mass_table(rho0, 2.0 / 3.0, rc, rcut, False,
                           r_sample_gas=3000.0)
    r = np.geomspace(1.0, 3000.0, 64)
    expected = profiles.mass_profile_beta23(r, rho0, rc, rcut)
    got = tab.mass(r)
    assert np.allclose(got, expected, rtol=2e-5)


def test_mass_table_inverse_roundtrip():
    tab = build_mass_table(1e-4, 0.54, 50.0, 1500.0, False, 2500.0)
    r = np.geomspace(5.0, 2400.0, 32)
    m = tab.mass(r)
    assert np.allclose(tab.radius(m), r, rtol=1e-4)


def test_mass_table_monotone():
    tab = build_mass_table(1e-4, 0.54, 50.0, 1500.0, False, 2500.0)
    assert np.all(np.diff(tab.m) >= 0)


def test_hernquist_relations():
    m, a = 7.3e4, 300.0
    r = np.geomspace(1, 5000, 50)
    # M(<r) is the volume integral of rho
    from scipy.integrate import quad
    for ri in (10.0, 300.0, 2000.0):
        num, _ = quad(lambda s: 4 * np.pi * s * s
                      * profiles.hernquist_density(s, m, a), 0, ri)
        assert num == pytest.approx(profiles.hernquist_mass(ri, m, a),
                                    rel=1e-6)
    # inverse CDF roundtrip: q = M(<r)/m
    q = np.linspace(0.01, 0.95, 20)
    rq = profiles.hernquist_sample_radius(q, a)
    assert np.allclose(profiles.hernquist_mass(rq, m, a) / m, q, rtol=1e-12)


def test_gas_potential_table_matches_point_mass_far_field():
    # far outside the sampling radius the gas potential must be ~ G M_tot / r
    G = 43007.1 / 1e10  # arbitrary-ish G in code units
    tab = build_mass_table(1e-4, 0.54, 50.0, 1500.0, False, 2500.0)
    pot = build_potential_table(tab, G, 2500.0)
    mtot = tab.mass(2500.0)
    r = 8000.0
    assert pot(r) == pytest.approx(G * mtot / r, rel=0.05)
    # psi decreases outward and is positive
    rr = np.geomspace(2, 2400, 64)
    psi = pot(rr)
    assert np.all(np.diff(psi) < 0)
    assert np.all(psi > 0)


def test_energy_table_matches_analytic_beta23():
    """Hydrostatic u(r) vs the closed form for beta=2/3 without taper.

    The analytic oracle (temperature.c:51-83) assumes no rcut taper and an
    untapered DM+gas mass; with NO_RCUT_IN_T pushing rcut to 1e5-1e6 the
    numeric profile matches it in the cluster interior.
    """
    G = 6.673e-8 / 3.085678e21**3 * 1.989e43 * (3.085678e21 / 1e5) ** 2
    rho0, rc = 3.0e-5, 120.0
    a, mdm = 350.0, 8e4
    boxsize = 6000.0
    tab = build_mass_table(rho0, 2.0 / 3.0, rc, 1e5, False,
                           r_sample_gas=boxsize * np.sqrt(3.0))
    etab = build_energy_table(tab, rho0=rho0, beta=2.0 / 3.0, rc=rc,
                              rcut=1.4e3, is_cuspy=False, a_hernq=a, mdm=mdm,
                              boxsize=boxsize, G=G, no_rcut_in_t=True)
    r = np.geomspace(5, 1500, 24)
    u_ana = profiles.internal_energy_beta23_analytic(
        r, rho0, rc, a, mdm, rmax=boxsize, G=G)
    u_num = etab(r)
    # rmax conventions differ slightly (boxsize vs sqrt3*boxsize) -> few %
    assert np.allclose(u_num, u_ana, rtol=0.08)
