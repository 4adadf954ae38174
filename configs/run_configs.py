"""The five benchmark configurations of BASELINE.json, as runnable presets.

    python configs/run_configs.py <1..5> [ntotal=...] [output_file=...]

1. Single beta-model halo, no B-field, ~32^3 SPH particles (par defaults)
2. Single NFW halo + Bonafede+2010 magnetic field, 1e6 particles
3. Equal-mass two-cluster merger, zero-energy orbit, 1e7 particles
4. 1:3 mass-ratio merger with Giocoli 2010 substructure, 1e7 particles
5. Three-halo configuration (merger + ADD_THIRD_SUBHALO), comet setup,
   1e8 particles full WVT relaxation
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from toycluster import STOCK_PAR, parse_par_file  # noqa: E402
from toycluster.pipeline import make_ics  # noqa: E402

PRESETS = {
    1: dict(ntotal=2 * 32**3, bfld_norm=0.0, output_file="IC_config1"),
    2: dict(ntotal=1_000_000, output_file="IC_config2"),
    3: dict(ntotal=10_000_000, mass_ratio=1.0, zero_e_orbit_frac=1.0,
            orbit="comet", output_file="IC_config3"),
    4: dict(ntotal=10_000_000, mass_ratio=1.0 / 3.0, substructure=True,
            output_file="IC_config4"),
    5: dict(ntotal=100_000_000, mass_ratio=0.5, add_third_subhalo=True,
            substructure=True, orbit="comet", sub_first_mass=1e3,
            output_file="IC_config5"),
}


def main():
    idx = int(sys.argv[1])
    overrides = dict(kv.split("=", 1) for kv in sys.argv[2:])
    for k, v in overrides.items():
        try:
            overrides[k] = int(v)
        except ValueError:
            try:
                overrides[k] = float(v)
            except ValueError:
                pass
    cfg = parse_par_file(STOCK_PAR, **{**PRESETS[idx], **overrides})
    make_ics(cfg)


if __name__ == "__main__":
    main()
