"""End-to-end IC pipeline — the reference's `main()` (main.c:11-72) as a
library function.

Stages (gas stages skipped when baryon fraction is zero, main.c:50-63):
  setup -> positions -> ids -> shift origin -> [WVT relax -> SPH density ->
  B field -> reassign -> temperatures] -> velocities -> kinematics -> output
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import Config
from .scene import Scene, build_scene
from .particles import Particles, HaloArrays, halo_arrays_from_scene
from .models import ids as ids_mod
from .models import positions as pos_mod
from .utils.logging import stage_log


def make_ics(cfg: Config, *, seed: Optional[int] = None,
             write: bool = True, log=stage_log,
             check: bool = False, profile_dir: Optional[str] = None,
             wvt_checkpoint: Optional[str] = None, mesh=None):
    """Run the full pipeline; returns (scene, particles).

    check: audit the neighbour engine by comparing a random subsample of
      the solved SPH densities against direct summation (SURVEY.md §5
      "--check mode").
    profile_dir: capture a jax.profiler trace of the WVT hot loop.
    wvt_checkpoint: NPZ path for WVT checkpoint/resume.
    mesh: optional jax.sharding.Mesh — runs the WVT relaxation (the
      dominant stage) sharded over the mesh via
      parallel.wvt_shard.regularise_sharded (structure reuse + the
      ppermute ring halo exchange), then the remaining stages
      single-chip.  The multi-chip analogue of the reference's
      OpenMP-parallel Regularise_sph_particles (wvt_relax.c:25).
    """
    t0 = time.perf_counter()
    scene = build_scene(cfg)
    log("setup", scene=scene)
    if log is stage_log:  # reference stdout tables (SURVEY.md §5)
        from .utils import logging as tlog
        tlog.report_units(scene.units)
        tlog.report_cosmology(scene.cosmo, cfg.redshift)
        tlog.report_halo_setup(scene)
        tlog.report_kinematics(scene)

    if cfg.substructure:
        from .models.substructure import setup_substructure
        scene = setup_substructure(scene, seed=cfg.seed + 7)
        log("substructure", nhalos=scene.nhalos,
            nsub=scene.nhalos - scene.sub_first)
        if cfg.report_subhalos and log is stage_log:
            from .utils import logging as tlog
            tlog.report_subhalos(scene)  # substructure.c:74-103

    ha = halo_arrays_from_scene(scene)
    key = jax.random.PRNGKey(cfg.seed if seed is None else seed)

    from .utils.memory import est_live_gib, peak_gib

    parts = pos_mod.make_positions(key, scene, ha)
    jax.block_until_ready(parts.pos)  # truthful stage attribution
    log("positions", n=parts.n_total,
        hbm_est_gib=est_live_gib(parts, ha), peak_gib=peak_gib())

    pid = ids_mod.make_ids(scene.npart_gas, scene.ntotal)
    parts = parts._replace(pid=jnp.asarray(pid))

    parts = pos_mod.shift_origin(parts, ha, scene.boxsize)
    jax.block_until_ready(parts.pos)
    log("shift_origin")
    pos_mod.show_mass_in_r200(scene, parts, log=log)  # main.c:48

    if not scene.dm_only:
        from .models import wvt, sph, bfield, temperature
        if profile_dir:
            jax.profiler.start_trace(profile_dir)
        if mesh is not None:
            from .parallel import wvt_shard
            cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                         if cfg.double_beta_cool_cores else None)
            step = 0.035 if cfg.sph_kernel == "m4" else (
                0.0085 / (2.0 if scene.mtotal < 1e5 else 1.0))
            n_gas = parts.n_gas
            pos_gas, _, _ = wvt_shard.regularise_sharded(
                mesh, ha, parts.pos[:n_gas], boxsize=scene.boxsize,
                mpart=scene.mpart_gas, desnngb=cfg.desnngb,
                kernel=cfg.sph_kernel, step=step,
                max_iter=min(cfg.wvt_max_iter, wvt.NUMITER),
                err_diff_limit=cfg.wvt_err_diff_limit,
                cool_core=cool_core, log=log,
                checkpoint_path=wvt_checkpoint)
            rhom = sph.global_density_model(pos_gas, ha, scene.boxsize,
                                            cool_core)
            parts = parts._replace(
                pos=parts.pos.at[:n_gas].set(pos_gas), rho_model=rhom)
            wvt_fresh = False
            log("wvt_sharded", n_devices=int(mesh.devices.size))
        else:
            # holder-list protocol: drop this frame's reference so the
            # WVT loop can release the particle buffers it never reads
            # (~3 GB at 1e8 — see the offload note in models/wvt.py)
            holder = [parts]
            del parts
            parts, wvt_fresh = wvt.regularise_sph_particles(
                scene, ha, holder, log=log,
                checkpoint_path=wvt_checkpoint, return_fresh=True)
        if profile_dir:
            jax.profiler.stop_trace()
        if wvt_fresh:
            # the WVT loop stopped before a final move: parts already
            # hold the full-contract density solve at the final
            # positions, so the stand-alone pass is redundant (the
            # B-field stage builds its own neighbour structure)
            nstate = None
            log("sph_quantities", reused="wvt-final")
        else:
            parts, nstate = sph.find_sph_quantities(scene, ha, parts,
                                                    return_state=True)
            jax.block_until_ready(parts.rho)
            log("sph_quantities",
                hbm_est_gib=est_live_gib(parts, ha, nstate),
                peak_gib=peak_gib())
        if check:
            _check_density(scene, parts, log)
        if cfg.bfld_norm:
            parts = bfield.make_magnetic_field(scene, ha, parts, nstate)
            # barrier for truthful attribution: without it the async
            # curl dispatch drains into the next host-syncing stage
            jax.block_until_ready(parts.bfld)
            log("magnetic_field", hbm_est_gib=est_live_gib(parts, ha),
                peak_gib=peak_gib())
        cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                     if cfg.double_beta_cool_cores else None)
        parts, _ = pos_mod.reassign_gas_to_halos(parts, ha, scene.boxsize,
                                                 cool_core)
        jax.block_until_ready(parts.halo)
        log("reassign")
        pos_mod.show_mass_in_r200(scene, parts, log=log)  # main.c:60
        parts = temperature.make_temperatures(scene, parts)
        jax.block_until_ready(parts.u)
        log("temperatures", hbm_est_gib=est_live_gib(parts, ha),
            peak_gib=peak_gib())

    from .models import velocities, kinematics
    parts = velocities.make_velocities(key, scene, ha, parts)
    jax.block_until_ready(parts.vel)
    log("velocities", hbm_est_gib=est_live_gib(parts, ha),
        peak_gib=peak_gib())

    parts = kinematics.apply_kinematics(scene, parts)
    jax.block_until_ready(parts.vel)
    log("kinematics")

    if write:
        from .io.gadget import write_scene_snapshot
        write_scene_snapshot(cfg.output_file, scene, parts)
        log("output", path=cfg.output_file,
            dt=time.perf_counter() - t0)

    return scene, parts


def _check_density(scene, parts, log, n_sample=512):
    """Audit the block-sparse engine against direct summation on a random
    subsample; raises on disagreement beyond float32 pair-sum tolerance."""
    from .ops.brute import density_at
    n_gas = parts.n_gas
    idx = np.linspace(0, n_gas - 1, min(n_sample, n_gas)).astype(int)
    rho_direct = density_at(parts.pos[idx], parts.hsml[idx],
                            parts.pos[:n_gas], scene.mpart_gas,
                            scene.boxsize,
                            kernel=scene.config.sph_kernel,
                            desnngb=scene.config.desnngb)
    rel = jnp.abs(rho_direct - parts.rho[idx]) / parts.rho[idx]
    worst = float(rel.max())
    log("check_density", n=len(idx), worst_rel_err=round(worst, 6))
    if worst > 5e-3:
        raise RuntimeError(
            f"density check failed: worst rel err {worst:.2e}")
