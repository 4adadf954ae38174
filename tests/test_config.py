import math
import textwrap

import pytest

from toycluster import STOCK_PAR, Config, parse_par_file
from toycluster.units import units_from_config
from toycluster.cosmology import Cosmology


REFERENCE_PAR = STOCK_PAR


def test_parse_reference_par_file():
    cfg = parse_par_file(REFERENCE_PAR)
    assert cfg.output_file == "./IC_single_0"
    assert cfg.ntotal == 1_000_000
    assert cfg.mtot200 == 1e5
    assert cfg.mass_ratio == 0.0
    assert cfg.impact_param == 50.0
    assert cfg.zero_e_orbit_frac == 0.8
    assert cfg.cuspy == 0
    assert cfg.redshift == 0.87
    assert cfg.bfld_norm == 20e-6
    assert cfg.bfld_eta == 0.5
    assert cfg.baryon_fraction == 0.17
    assert cfg.unit_length_cm == 3.085678e21
    assert cfg.unit_mass_g == 1.989e43
    assert cfg.unit_vel_cgs == 1e5
    # h_100 / Bfld_Scale appear in the file but are never parsed by the
    # reference (io.c tag table) -> must not leak into the config.
    assert cfg.nhalos == 1


def test_parse_giveparams_tags():
    cfg = parse_par_file(REFERENCE_PAR, give_params=True)
    assert cfg.c_nfw_given == (4.0, 4.089)
    assert cfg.beta_given == (0.54, 0.79)
    assert cfg.rc_given == (30.0, 300.0)
    assert cfg.v_com_given == (0.0, 0.0)


def test_missing_tag_raises(tmp_path):
    p = tmp_path / "bad.par"
    p.write_text("Output_file x\nNtotal 100\n")
    with pytest.raises(ValueError, match="missing"):
        parse_par_file(str(p))


def test_duplicate_tag_first_wins(tmp_path):
    src = open(REFERENCE_PAR).read()
    p = tmp_path / "dup.par"
    p.write_text("Ntotal 555\n" + src)
    cfg = parse_par_file(str(p))
    assert cfg.ntotal == 555


def test_comment_lines_ignored(tmp_path):
    src = open(REFERENCE_PAR).read()
    p = tmp_path / "c.par"
    p.write_text("%Ntotal 7\n" + src)
    cfg = parse_par_file(str(p))
    assert cfg.ntotal == 1_000_000


def test_defaults_match_shipped_makefile():
    cfg = Config()
    assert cfg.beta == 0.54
    assert cfg.nfw_concentration_model == "duffy08"
    assert cfg.orbit == "comet"
    assert cfg.no_rcut_in_t is True
    assert cfg.sph_kernel == "wc6"
    assert cfg.desnngb == 295


def test_units_derivation():
    cfg = parse_par_file(REFERENCE_PAR)
    u = units_from_config(cfg)
    # unit.c:5-7
    assert u.time == pytest.approx(3.085678e21 / 1e5)
    assert u.energy == pytest.approx(1.989e43 * 1e10)
    assert u.density == pytest.approx(1.989e43 / 3.085678e21**3)
    # G in code units (setup.c:27): Grav/L^3*M*T^2
    G = 6.673e-8 / 3.085678e21**3 * 1.989e43 * (3.085678e21 / 1e5) ** 2
    assert u.G == pytest.approx(G)


def test_temperature_roundtrip():
    cfg = parse_par_file(REFERENCE_PAR)
    u = units_from_config(cfg)
    assert u.u2t(u.t2u(1e7)) == pytest.approx(1e7)
    # ~1e8 K cluster gas at u ~ 2e6 (km/s)^2
    assert 5e7 < u.u2t(2.1e6) < 2e8


def test_cosmology_values():
    cos = Cosmology()
    assert cos.Ez(0) == pytest.approx(1.0)
    # Mo, v.d.Bosch, White (3.75)
    assert cos.Ez(1.0) == pytest.approx(math.sqrt(0.7 + 0.3 * 8))
    # rho_crit(0) ~ 9.2e-30 g/cm^3 for h=0.7
    assert cos.rho_crit0 == pytest.approx(9.2e-30, rel=0.01)
    # Pierpaoli Delta for (0.3, 0.7) is ~ 100 (times Omega_M ~ flat-LCDM 97)
    delta = cos.overdensity_parameter()
    assert 90 < delta < 110
    # a2t/t2a reproduce the reference's formulas verbatim (cosmo.c:93-113).
    # NB the reference's pair is mutually inconsistent (a2t uses sqrt(Om),
    # t2a uses sqrt(OL)) so we check each against its own closed form.
    h0 = 100.0 * 1e5 / 3.08568025e21 / 1000.0 * 0.7
    t = cos.a2t_cgs(0.5)
    assert t == pytest.approx(
        2 / 3 / (math.sqrt(0.3) * h0)
        * math.asinh((0.5 * (0.7 / 0.3) ** (1 / 3)) ** 1.5), rel=1e-12)
    a = cos.t2a_cgs(t)
    assert a == pytest.approx(
        (0.3 / 0.7) ** (1 / 3)
        * math.sinh(1.5 * math.sqrt(0.7) * h0 * t) ** (2 / 3), rel=1e-12)
    assert cos.omega_m_z(0) == pytest.approx(0.3)
