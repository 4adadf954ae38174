"""Numeric parity of the repo's scene construction against the COMPILED
reference Setup() (setup.c:21-344 built unmodified by
tests/golden/build.sh with gslstub QAG + cspline).  The goldens (setup_table_*.txt) are PARITY lines printed by
tests/golden/gen_setup.c for the stock cluster.par (single halo) and a
merger variant (Mass_Ratio=0.3125, Cuspy=1 — exercises the two-halo
orbit, cuspy core radius, and zero-energy velocity paths)."""

import math
import os

import pytest

from toycluster import STOCK_PAR, parse_par_file
from toycluster.scene import build_scene

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
RTOL = 1e-5


def _load(path):
    glob, halos = {}, {}
    with open(path) as fh:
        for line in fh:
            t = line.split()
            if not t or t[0] != "PARITY" or t[1] in ("begin", "end"):
                continue
            if t[1] == "global":
                glob[t[2]] = float(t[3])
            else:
                halos.setdefault(int(t[2]), {})[t[3]] = float(t[4])
    return glob, halos


def _scene(parfile, **over):
    cfg = parse_par_file(parfile, **over)
    return build_scene(cfg)


def _check(scene, glob, halos):
    def close(a, b, what, rtol=RTOL):
        denom = max(abs(a), abs(b), 1e-30)
        assert abs(a - b) / denom <= rtol, \
            f"{what}: repo {a!r} vs reference {b!r}"

    close(scene.boxsize, glob["Boxsize"], "boxsize")
    close(scene.mtotal, glob["Mtotal"], "mtotal")
    close(scene.mpart_gas, glob["Mpart0"], "mpart_gas")
    close(scene.mpart_dm, glob["Mpart1"], "mpart_dm")
    close(scene.grav_softening, glob["GravSoftening"], "softening")
    close(scene.vel_merger[0], glob["VelMerger0"], "vel_merger0")
    close(scene.vel_merger[1], glob["VelMerger1"], "vel_merger1")

    assert len(scene.halos) == len(halos)
    for i, h in enumerate(scene.halos):
        r = halos[i]
        assert h.npart_gas == int(r["Npart0"]), f"halo {i} npart_gas"
        assert h.npart_dm == int(r["Npart1"]), f"halo {i} npart_dm"
        close(h.mtotal, r["Mtotal"], f"halo {i} mtotal")
        close(h.mtotal200, r["Mtotal200"], f"halo {i} mtotal200")
        close(h.mass_gas, r["Mass0"], f"halo {i} mass_gas")
        close(h.mass_dm, r["Mass1"], f"halo {i} mass_dm")
        close(h.mass_corr_fac, r["MassCorrFac"], f"halo {i} qmax")
        close(h.c_nfw, r["C_nfw"], f"halo {i} c_nfw")
        close(h.rs, r["Rs"], f"halo {i} rs")
        close(h.r200, r["R200"], f"halo {i} r200")
        close(h.r500, r["R500"], f"halo {i} r500")
        close(h.a_hernq, r["A_hernq"], f"halo {i} a_hernq")
        # rho0 comes out of the two-pass spline-table calibration
        # (setup.c:93-99): quadrature/spline implementation noise sets
        # its floor, so allow 1e-4 relative
        close(h.rho0, r["Rho0"], f"halo {i} rho0", rtol=1e-4)
        close(h.beta, r["Beta"], f"halo {i} beta")
        close(h.rcore, r["Rcore"], f"halo {i} rcore")
        close(h.rcut, r["Rcut"], f"halo {i} rcut")
        close(h.bf_eff, r["Bf_eff"], f"halo {i} bf_eff", rtol=1e-4)
        close(h.r_sample_gas, r["R_Sample0"], f"halo {i} r_sample_gas")
        close(h.r_sample_dm, r["R_Sample1"], f"halo {i} r_sample_dm")
        close(h.d_com[0], r["D_CoM0"], f"halo {i} d_com0")
        close(h.d_com[1], r["D_CoM1"], f"halo {i} d_com1")
        close(h.bulk_vel[0], r["BulkVel0"], f"halo {i} bulk_vel0")


def test_setup_parity_single():
    glob, halos = _load(os.path.join(GOLDEN_DIR,
                                     "setup_table_cluster.txt"))
    _check(_scene(STOCK_PAR), glob, halos)


def test_setup_parity_merger_cuspy():
    glob, halos = _load(os.path.join(GOLDEN_DIR,
                                     "setup_table_merger.txt"))
    _check(_scene(STOCK_PAR, mass_ratio=0.3125,
                  cuspy=1), glob, halos)
