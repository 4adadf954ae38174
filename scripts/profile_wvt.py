"""Per-phase wall-clock breakdown of one WVT iteration on the GPU."""

import time

import jax
import jax.numpy as jnp
import numpy as np

from toycluster import STOCK_PAR, parse_par_file
from toycluster.scene import build_scene
from toycluster.particles import halo_arrays_from_scene
from toycluster.models import positions as pos_mod, sph as sph_mod
from toycluster.ops import blocks as blk, pair_ops

N = 2_000_000


def t(label, fn, *a, **k):
    t0 = time.perf_counter()
    out = fn(*a, **k)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    # run again for the steady-state number
    t0 = time.perf_counter()
    out = fn(*a, **k)
    jax.block_until_ready(out)
    dt2 = time.perf_counter() - t0
    print(f"{label:28s} first={dt:7.3f}s steady={dt2:7.3f}s", flush=True)
    return out


def main():
    cfg = parse_par_file(STOCK_PAR).replace(ntotal=N)
    scene = build_scene(cfg)
    ha = halo_arrays_from_scene(scene)
    key = jax.random.PRNGKey(1)
    parts = pos_mod.make_positions(key, scene, ha)
    parts = pos_mod.shift_origin(parts, ha, scene.boxsize)
    pos = parts.pos[: parts.n_gas]
    boxsize = scene.boxsize
    desnngb = cfg.desnngb
    mpart = scene.mpart_gas

    h0 = t("model_hsml", sph_mod.model_hsml, pos, ha, mpart, desnngb,
           boxsize)
    h_cap = jnp.minimum(h0 * 1.4, boxsize / 3.0)

    bi = t("build_blocks", blk.build_blocks, pos, boxsize)
    h_cap_s = sph_mod._pad_sorted(h_cap, bi.order, bi.n_padded)
    radius = h_cap_s.reshape(bi.n_blocks, blk.BLOCK).max(axis=1)
    cand = t("find_candidates", blk.find_candidates, bi, radius, boxsize,
             max_cand=2048)
    print("overflow", int(cand.overflow), "counts p50/p99/max:",
          *np.percentile(np.asarray(cand.count), [50, 99, 100]).astype(int))

    h0_s = sph_mod._pad_sorted(h0, bi.order, bi.n_padded)
    state = sph_mod.NeighbourState(index=bi, cand=cand, h_cap=h_cap_s,
                                   max_cand=2048)
    sels = sph_mod.classed_selections(state)
    print("classes:", [(m, len(ids)) for m, ids in sels])

    def density_all():
        def f(sel, m):
            return pair_ops.solve_density(bi, sel, h0_s, h_cap_s, mpart,
                                          boxsize, kernel="wc6",
                                          desnngb=desnngb)
        return sph_mod.run_classed(state, f)

    res = t("solve_density (cold h)", density_all)
    hsml = res[1]

    # warm-start pass: h already solved
    h_warm = hsml

    def density_warm():
        def f(sel, m):
            return pair_ops.solve_density(bi, sel, h_warm, h_cap_s, mpart,
                                          boxsize, kernel="wc6",
                                          desnngb=desnngb)
        return sph_mod.run_classed(state, f)

    t("solve_density (warm h)", density_warm)

    def displacement():
        def f(sel, m):
            return (pair_ops.wvt_displacement(bi, sel, h0_s / boxsize,
                                              0.0085, boxsize),)
        return sph_mod.run_classed(state, f)

    t("wvt_displacement", displacement)

    rho_model = t("global_density_model", sph_mod.global_density_model,
                  pos, ha, boxsize)


if __name__ == "__main__":
    main()
