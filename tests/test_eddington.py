import numpy as np
import pytest

from toycluster.models import profiles
from toycluster.models.eddington import build_distribution_function


G = 6.673e-8 / 3.085678e21**3 * 1.989e43 * (3.085678e21 / 1e5) ** 2


def test_fE_matches_analytic_hernquist():
    """Pure Hernquist halo: the numerical Eddington inversion must reproduce
    the analytic f(E) (velocities.c:346-358) to ~1e-3 relative accuracy —
    the reference's own documented accuracy (velocities.c:182-184)."""
    mass_dm, a = 8.5e4, 420.0
    df = build_distribution_function(mass_dm=mass_dm, a_hernq=a, G=G,
                                     mass_table=None, r_sample_gas=None,
                                     has_gas=False)
    # compare over the energy range relevant for sampling: E = psi(r) for
    # r in [1, 5000] kpc
    r = np.geomspace(1.0, 5000.0, 64)
    E = profiles.hernquist_psi(r, mass_dm, a, G)
    f_num = df(E)
    f_ana = profiles.hernquist_fE(E, mass_dm, a, G)
    rel = np.abs(f_num - f_ana) / f_ana
    assert np.median(rel) < 2e-3
    assert rel.max() < 2e-2


def test_fE_monotone_and_positive():
    df = build_distribution_function(mass_dm=1e5, a_hernq=300.0, G=G,
                                     mass_table=None, r_sample_gas=None,
                                     has_gas=False)
    # f(E) rises toward more-bound energies
    inner = (df.E > df.E.max() * 1e-6) & (df.E < df.E.max() * 0.99)
    assert (np.diff(df.fE[inner]) >= -1e-12 * df.fE.max()).all()
    assert (df.fE >= 0).all()


def test_fE_with_gas_potential_differs():
    from toycluster.models.tables import build_mass_table
    tab = build_mass_table(3e-5, 0.54, 120.0, 1500.0, False, 2500.0)
    df_gas = build_distribution_function(
        mass_dm=8e4, a_hernq=350.0, G=G, mass_table=tab,
        r_sample_gas=2500.0, has_gas=True)
    df_dm = build_distribution_function(
        mass_dm=8e4, a_hernq=350.0, G=G, mass_table=None,
        r_sample_gas=None, has_gas=False)
    # deeper potential with gas
    r = 100.0
    E_gas = df_gas.psi(r)
    E_dm = df_dm.psi(r)
    assert E_gas > E_dm
    # at the same (mid-range) energy the DFs must differ measurably
    E = 0.5 * E_dm
    assert abs(df_gas(E) - df_dm(E)) / df_dm(E) > 0.01
