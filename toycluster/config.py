"""Run configuration.

One runtime `Config` replaces the reference's two-tier configuration:

* the run-time parameter file (``cluster.par`` tag table, reference
  src/io.c:298-507), parsed here with the same grammar (``%`` comments, first
  two whitespace tokens, duplicate tags ignored after the first occurrence,
  missing core tag -> error, unknown tags silently ignored);
* every compile-time ``-D`` feature flag of the reference Makefile
  (Makefile:4-25) hoisted into a config field, so no rebuild is needed to
  switch model variants.

Defaults match the shipped Makefile: ``-DNFWC_DUFFY08 -DBETA=0.54 -DCOMET
-DNO_RCUT_IN_T`` with the WC6 kernel.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

from . import constants as const

# the stock parameter file shipped with the package (single cluster, 1e6
# particles in R200, B-field on): the base of every preset and test scene
STOCK_PAR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "cluster.par")


@dataclass(frozen=True)
class Config:
    # --- runtime parameter-file tags (src/io.c:311-443) ---
    output_file: str = "./IC_out"
    ntotal: int = 1_000_000           # "Ntotal": particles in R200
    mtot200: float = 1e5              # "Mtotal": total mass in R200 [code units]
    redshift: float = 0.0             # "Redshift"
    mass_ratio: float = 0.0           # "Mass_Ratio": 0 -> single cluster
    impact_param: float = 0.0         # "ImpactParam" [code length]
    zero_e_orbit_frac: float = 1.0    # "ZeroEOrbitFrac"
    cuspy: int = 0                    # "Cuspy" bitmask: bit i -> halo i cool-core
    bfld_norm: float = 0.0            # "Bfld_Norm": B0 [Gauss]
    bfld_eta: float = 0.5             # "Bfld_Eta": B ~ rho^eta (Bonafede+ 2010)
    baryon_fraction: float = 0.17     # "bf": baryon fraction inside R200
    unit_length_cm: float = 3.085678e21      # "UnitLength_in_cm" (1 kpc)
    unit_mass_g: float = 1.989e43            # "UnitMass_in_g" (1e10 Msol)
    unit_vel_cgs: float = 1e5                # "UnitVelocity_in_cm_per_s" (km/s)

    # --- hoisted compile-time flags (Makefile:4-25) ---
    beta: float = 0.54                # -DBETA (code default 2/3, Makefile 0.54)
    nfw_concentration_model: str = "duffy08"  # -DNFWC_DUFFY08 | "buote07"
    orbit: str = "comet"              # -DCOMET | "parabola" | "direct"
    double_beta_cool_cores: bool = False      # -DDOUBLE_BETA_COOL_CORES
    give_params: bool = False         # -DGIVEPARAMS
    no_rcut_in_t: bool = True         # -DNO_RCUT_IN_T
    substructure: bool = False        # -DSUBSTRUCTURE
    sub_host: int = 0                 # -DSUBHOST
    slow_substructure: bool = False   # -DSLOW_SUBSTRUCTURE
    report_subhalos: bool = False     # -DREPORTSUBHALOS
    add_third_subhalo: bool = False   # -DADD_THIRD_SUBHALO
    third_halo_only: bool = False     # -DTHIRD_HALO_ONLY
    sph_kernel: str = "wc6"           # -DSPH_CUBIC_SPLINE -> "m4"

    # --- -DGIVEPARAMS extra tags (src/io.c:368-401) ---
    c_nfw_given: Sequence[float] = (4.0, 4.089)
    v_com_given: Sequence[float] = (0.0, 0.0)
    rc_given: Sequence[float] = (30.0, 300.0)
    beta_given: Sequence[float] = (0.54, 0.79)

    # --- -DADD_THIRD_SUBHALO tags (src/io.c:403-433) ---
    sub_first_mass: float = 0.0
    sub_first_pos: Sequence[float] = (0.0, 0.0, 0.0)
    sub_first_vel: Sequence[float] = (0.0, 0.0, 0.0)

    # --- -DDOUBLE_BETA_COOL_CORES tags (src/io.c:435-443) ---
    rho0_fac: float = 50.0
    rc_fac: float = 40.0

    # --- framework-only knobs (no reference counterpart) ---
    seed: int = 14041981              # reference thread-RNG seed base (main.c:20)
    wvt_max_iter: int = 64            # NUMITER (wvt_relax.c:7)
    wvt_err_diff_limit: float = 0.01  # ERRDIFF_LIMIT (wvt_relax.c:8)

    @property
    def desnngb(self) -> int:
        return const.desnngb(self.sph_kernel)

    @property
    def nhalos(self) -> int:
        """Number of main halos before substructure (io.c:500-504)."""
        return 1 if self.mass_ratio == 0 else 2

    def validate(self) -> "Config":
        if self.ntotal <= 0:
            raise ValueError("Ntotal must be positive")
        if self.mass_ratio < 0:
            raise ValueError("Mass_Ratio must be >= 0")
        if self.sph_kernel not in ("wc6", "m4"):
            raise ValueError(f"unknown sph_kernel {self.sph_kernel!r}")
        if self.nfw_concentration_model not in ("duffy08", "buote07"):
            raise ValueError(
                f"unknown nfw_concentration_model {self.nfw_concentration_model!r}")
        if self.orbit not in ("comet", "parabola", "direct"):
            raise ValueError(f"unknown orbit {self.orbit!r}")
        return self

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw).validate()


# .par tag table: tag -> (config field, type). Mirrors src/io.c:311-443.
# Types: the reference parses "Ntotal"/"Cuspy" with atoi and the rest with
# atof; "Mtotal" feeds Param.Mtot200 and "bf" feeds Cosmo.Baryon_Fraction.
_CORE_TAGS = {
    "Output_file": ("output_file", str),
    "Ntotal": ("ntotal", int),
    "Mtotal": ("mtot200", float),
    "Redshift": ("redshift", float),
    "Mass_Ratio": ("mass_ratio", float),
    "ImpactParam": ("impact_param", float),
    "ZeroEOrbitFrac": ("zero_e_orbit_frac", float),
    "Cuspy": ("cuspy", int),
    "Bfld_Norm": ("bfld_norm", float),
    "Bfld_Eta": ("bfld_eta", float),
    "bf": ("baryon_fraction", float),
    "UnitLength_in_cm": ("unit_length_cm", float),
    "UnitMass_in_g": ("unit_mass_g", float),
    "UnitVelocity_in_cm_per_s": ("unit_vel_cgs", float),
}

_GIVEPARAMS_TAGS = {  # only read when give_params=True (io.c:368-401)
    "c_nfw_0": ("c_nfw_given", 0), "c_nfw_1": ("c_nfw_given", 1),
    "v_com_0": ("v_com_given", 0), "v_com_1": ("v_com_given", 1),
    "rc_0": ("rc_given", 0), "rc_1": ("rc_given", 1),
    "beta_0": ("beta_given", 0), "beta_1": ("beta_given", 1),
}

_THIRD_SUBHALO_TAGS = {
    "SubFirstMass": ("sub_first_mass", None),
    "SubFirstPos0": ("sub_first_pos", 0),
    "SubFirstPos1": ("sub_first_pos", 1),
    "SubFirstPos2": ("sub_first_pos", 2),
    "SubFirstVel0": ("sub_first_vel", 0),
    "SubFirstVel1": ("sub_first_vel", 1),
    "SubFirstVel2": ("sub_first_vel", 2),
}

_COOL_CORE_TAGS = {
    "Rho0_Fac": ("rho0_fac", None),
    "Rc_Fac": ("rc_fac", None),
}


def _parse_int(s: str) -> int:
    # atoi semantics would truncate at the first non-digit; accept plain and
    # scientific notation for convenience.
    try:
        return int(s)
    except ValueError:
        return int(float(s))


def parse_par_file(path: str, **flag_overrides) -> Config:
    """Parse a reference-format ``cluster.par`` file into a Config.

    ``flag_overrides`` sets the hoisted compile-time fields (e.g.
    ``beta=0.54, orbit="comet", give_params=True``) and may override any
    parsed tag.  Grammar matches src/io.c:448-496: per line, the first two
    whitespace-separated tokens are (tag, value); ``%``-initial tags are
    comments; the first occurrence of a tag wins; unknown tags are ignored;
    a missing active tag is an error.
    """
    base = Config(**{k: v for k, v in flag_overrides.items()
                     if k in {f.name for f in dataclasses.fields(Config)}})

    tags = dict(_CORE_TAGS)
    active_extra = {}
    if base.give_params:
        active_extra.update(_GIVEPARAMS_TAGS)
    if base.add_third_subhalo:
        active_extra.update(_THIRD_SUBHALO_TAGS)
    if base.double_beta_cool_cores:
        active_extra.update(_COOL_CORE_TAGS)

    seen: dict[str, str] = {}
    with open(path, "r") as fd:
        for line in fd:
            toks = line.split()
            if len(toks) < 2:
                continue
            tag, value = toks[0], toks[1]
            if tag.startswith("%"):
                continue
            if tag in seen:
                continue  # duplicate tags ignored after first (io.c:461-465)
            seen[tag] = value

    updates: dict = {}
    for tag, (fieldname, typ) in tags.items():
        if tag not in seen:
            raise ValueError(
                f"Value for tag '{tag}' missing in parameter file '{path}'.")
        updates[fieldname] = _parse_int(seen[tag]) if typ is int else typ(seen[tag])

    for tag, (fieldname, idx) in active_extra.items():
        if tag not in seen:
            raise ValueError(
                f"Value for tag '{tag}' missing in parameter file '{path}'.")
        val = float(seen[tag])
        if idx is None:
            updates[fieldname] = val
        else:
            cur = list(updates.get(fieldname, getattr(base, fieldname)))
            cur[idx] = val
            updates[fieldname] = tuple(cur)

    # explicit overrides win over file values
    for k, v in flag_overrides.items():
        updates[k] = v

    return base.replace(**updates)
