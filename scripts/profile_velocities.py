"""Profile the velocity stage (velocities.c:38-159 analogue) at scale.

Builds the config-5 scene (3 halos + ~70 subhaloes) but SYNTHESIZES the
particle positions (isotropic radii per halo) so the stage can be timed
in isolation without the 1e8 upstream pipeline.  Positions only feed
radius lookups and halo-id gathers, so synthetic ones exercise the same
program shapes and data volumes as the real run.

    python scripts/profile_velocities.py [ntotal] [config_idx]

Prints a per-component wall table and one JSON line.
"""

import functools
import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp
import numpy as np

from toycluster import STOCK_PAR, parse_par_file
from toycluster.scene import build_scene
from toycluster.particles import (empty_particles,
                                      halo_arrays_from_scene)

NTOTAL = int(float(sys.argv[1])) if len(sys.argv) > 1 else 100_000_000
CFG_IDX = int(sys.argv[2]) if len(sys.argv) > 2 else 5

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/configs")
from run_configs import PRESETS  # noqa: E402

TIMES = {}


def _timed(mod, name):
    fn = getattr(mod, name)

    @functools.wraps(fn)
    def wrap(*a, **k):
        t0 = time.perf_counter()
        r = fn(*a, **k)
        r = jax.block_until_ready(r)
        dt = time.perf_counter() - t0
        c, s = TIMES.get(name, (0, 0.0))
        TIMES[name] = (c + 1, s + dt)
        return r

    setattr(mod, name, wrap)


def main():
    import toycluster.models.velocities as V
    import toycluster.models.eddington as E

    for nm in ("build_velocity_tables", "stack_velocity_tables",
               "_build_cdf_pack", "_sample_page", "_page_radius_max",
               "add_bulk_velocities", "slow_substructure_bulk_velocities",
               "_gas_bulk_jit"):
        _timed(V, nm)
    _timed(E, "build_distribution_function")

    cfg = parse_par_file(STOCK_PAR, **{**PRESETS[CFG_IDX], "ntotal": NTOTAL})
    scene = build_scene(cfg)
    if cfg.substructure:
        from toycluster.models.substructure import setup_substructure
        scene = setup_substructure(scene, seed=cfg.seed + 7)
    ha = halo_arrays_from_scene(scene)

    n_gas = scene.npart_gas
    n_dm = scene.ntotal - n_gas
    print(f"scene: nhalos={scene.nhalos} sub_first={scene.sub_first} "
          f"n_gas={n_gas} n_dm={n_dm}", flush=True)

    # synthetic positions: gas uniform in box; DM isotropic in each halo
    key = jax.random.PRNGKey(0)
    kg, kd_r, kd_u = jax.random.split(key, 3)
    t0 = time.perf_counter()
    pos_gas = jax.random.uniform(kg, (n_gas, 3), jnp.float32,
                                 0.0, scene.boxsize)
    halo_np = np.zeros(scene.ntotal, np.int32)
    ofs = n_gas
    centers = np.asarray(ha.d_com) + scene.boxhalf
    rmaxs = np.array([max(h.r200 * 1.5, 1.0) for h in scene.halos],
                     np.float32)
    cnts = np.array([h.npart_dm for h in scene.halos], np.int64)
    assert cnts.sum() == n_dm, (cnts.sum(), n_dm)
    hid = np.repeat(np.arange(scene.nhalos, dtype=np.int32), cnts)
    halo_np[ofs:] = hid
    dirs = np.array(jax.random.normal(kd_u, (n_dm, 3), jnp.float32))
    dirs /= np.maximum(np.linalg.norm(dirs, axis=1, keepdims=True), 1e-9)
    rr = np.asarray(jax.random.uniform(kd_r, (n_dm,), jnp.float32)) \
        ** (1.0 / 3.0) * rmaxs[hid]
    pos_dm = centers[hid] + dirs * rr[:, None]
    pos = jnp.concatenate([pos_gas, jnp.asarray(pos_dm, jnp.float32)])
    parts = empty_particles(n_gas, n_dm)._replace(
        pos=pos, halo=jnp.asarray(halo_np))
    jax.block_until_ready(parts.pos)
    print(f"synthetic state built in {time.perf_counter()-t0:.1f}s",
          flush=True)

    t0 = time.perf_counter()
    out = V.make_velocities(jax.random.PRNGKey(1), scene, ha, parts)
    jax.block_until_ready(out.vel)
    total = time.perf_counter() - t0

    rows = sorted(TIMES.items(), key=lambda kv: -kv[1][1])
    acc = 0.0
    print(f"\n{'component':<38}{'calls':>6}{'total s':>10}")
    for nm, (c, s) in rows:
        print(f"{nm:<38}{c:>6}{s:>10.2f}")
        acc += s
    print(f"{'(unattributed)':<38}{'':>6}{total-acc:>10.2f}")
    print(f"{'TOTAL make_velocities':<38}{'':>6}{total:>10.2f}")
    print(json.dumps({"metric": "velocities_stage_s", "value": round(
        total, 2), "ntotal": NTOTAL, "config": CFG_IDX, "components": {
            k: round(v[1], 2) for k, v in rows}}))


if __name__ == "__main__":
    main()
