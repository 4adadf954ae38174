"""Per-halo / per-round wall breakdown of the position-sampling stage at
config-5 scale (72 halos, 1e8 particles).

Candidate costs are (a) per-round host syncs (~2 per halo x 144 halo
samples), (b) first-load cost of the ~15 distinct quantized program
shapes, or (c) genuine draw compute.  This script times every
`_rejection_fill` round with explicit barriers to separate the three.

    python scripts/profile_positions.py [ntotal]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import numpy as np

from toycluster import STOCK_PAR, parse_par_file
from toycluster.scene import build_scene
from toycluster.particles import halo_arrays_from_scene
from toycluster.models import positions as pos_mod
from configs.run_configs import PRESETS

NTOTAL = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000_000


def main():
    preset = {**PRESETS[5], "ntotal": NTOTAL}
    preset.pop("output_file", None)
    cfg = parse_par_file(STOCK_PAR, **preset)
    scene = build_scene(cfg)
    from toycluster.models.substructure import setup_substructure
    if cfg.substructure:
        scene = setup_substructure(scene, seed=cfg.seed + 7)
    ha = halo_arrays_from_scene(scene)
    print(f"halos={scene.nhalos} ntotal={scene.ntotal} "
          f"gas={scene.npart_gas} dm={scene.npart_dm}", flush=True)

    # wrap the round engine to time each program execution + sync
    rounds = []
    orig_fill = pos_mod._rejection_fill

    def timed_fill(key, n, round_fn, p_est=0.92):
        t0 = time.perf_counter()
        out = orig_fill(key, n, round_fn, p_est)
        rounds.append((n, time.perf_counter() - t0))
        return out

    pos_mod._rejection_fill = timed_fill

    key = jax.random.PRNGKey(cfg.seed)
    t0 = time.perf_counter()
    per_halo = []
    for i, h in enumerate(scene.halos):
        ki = jax.random.fold_in(key, i)
        kg, kd = jax.random.split(ki)
        th0 = time.perf_counter()
        n0 = len(rounds)
        if h.npart_gas:
            pos_mod.sample_halo_gas(kg, ha, jax.numpy.int32(i),
                                    h.npart_gas, scene.boxsize, None)
        tg = time.perf_counter()
        if h.npart_dm:
            pos_mod.sample_halo_dm(kd, ha, jax.numpy.int32(i),
                                   h.npart_dm, scene.sub_first,
                                   scene.boxsize)
        td = time.perf_counter()
        per_halo.append({
            "halo": i, "n_gas": h.npart_gas, "n_dm": h.npart_dm,
            "gas_s": round(tg - th0, 3), "dm_s": round(td - tg, 3),
            "n_rounds": len(rounds) - n0,
        })
        if i < 3 or (td - th0) > 2.0:
            print(f"  halo {i:3d} gas={h.npart_gas:>9d} "
                  f"{tg - th0:7.2f}s  dm={h.npart_dm:>9d} "
                  f"{td - tg:7.2f}s  rounds={len(rounds) - n0}",
                  flush=True)
    total = time.perf_counter() - t0
    gas_s = sum(p["gas_s"] for p in per_halo)
    dm_s = sum(p["dm_s"] for p in per_halo)
    sub_s = sum(p["gas_s"] + p["dm_s"] for p in per_halo
                if p["halo"] >= scene.sub_first)
    print(f"TOTAL {total:.1f}s  gas {gas_s:.1f}s  dm {dm_s:.1f}s  "
          f"subhalos {sub_s:.1f}s  rounds={len(rounds)}", flush=True)
    out = {
        "ntotal": NTOTAL, "nhalos": scene.nhalos,
        "total_s": round(total, 1), "gas_s": round(gas_s, 1),
        "dm_s": round(dm_s, 1), "subhalo_s": round(sub_s, 1),
        "n_rounds": len(rounds),
        "per_halo": per_halo,
    }
    with open("/tmp/profile_positions.json", "w") as fh:
        json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
