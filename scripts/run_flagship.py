"""Flagship benchmark: BASELINE.json config 3 — equal-mass two-cluster
merger, 1e7 particles, full pipeline to WVT convergence on one chip.

Records the BASELINE metric (wall-clock to converged IC), the WVT
convergence trajectory, the WC6/295 neighbour contract at production
settings (sph.c:159-166), the direct-summation density audit, and the
device-memory footprint.  Writes flagship_config<N>.json in the working
directory and prints the same record.

    python scripts/run_flagship.py [config_index] [ntotal=...]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from toycluster import STOCK_PAR, parse_par_file, constants as const
from toycluster.pipeline import make_ics
from configs.run_configs import PRESETS

IDX = int(sys.argv[1]) if len(sys.argv) > 1 else 3


def main():
    overrides = dict(kv.split("=", 1) for kv in sys.argv[2:])
    for k, v in overrides.items():
        try:
            overrides[k] = int(v)
        except ValueError:
            try:
                overrides[k] = float(v)
            except ValueError:
                pass
    preset = {**PRESETS[IDX], **overrides}
    preset.setdefault("output_file", f"/tmp/IC_config{IDX}")
    if not preset["output_file"].startswith("/"):
        preset["output_file"] = "/tmp/" + preset["output_file"]
    cfg = parse_par_file(STOCK_PAR, **preset)

    wvt_log = []
    stage_t = {}
    stage_n = {}
    stage_hbm = {}   # stage-boundary live-buffer estimates
    t_last = [time.perf_counter()]

    def log(stage, **kw):
        now = time.perf_counter()
        dt = now - t_last[0]
        t_last[0] = now
        stage_t[stage] = stage_t.get(stage, 0.0) + dt
        stage_n[stage] = stage_n.get(stage, 0) + 1
        if "hbm_est_gib" in kw:
            stage_hbm[stage] = max(stage_hbm.get(stage, 0.0),
                                   kw["hbm_est_gib"])
        if stage == "wvt":
            wvt_log.append(kw)
        print(f"[{now - t0:9.2f}s] {stage}: " + " ".join(
            f"{k}={v}" for k, v in kw.items() if k != "scene"),
            flush=True)

    t0 = time.perf_counter()
    ckpt = os.environ.get("TOYCLUSTER_WVT_CKPT")  # resume 1e8 runs
    scene, parts = make_ics(cfg, log=log, check=True, wvt_checkpoint=ckpt)
    jax.block_until_ready(parts.pos)
    wall = time.perf_counter() - t0

    # WC6/295 contract at production settings (sph.c:159-166): invert
    # the Dehnen+12 bias correction to recover wkNgb from rho and hsml
    desnngb = cfg.desnngb
    h = parts.hsml
    rho = parts.rho
    if cfg.sph_kernel == "wc6":
        w0 = 1365.0 / (64.0 * const.PI) / (h ** 3)
        rho_raw = rho - (-0.0116 * (desnngb * 0.01) ** (-2.236)
                         * scene.mpart_gas * w0)
    else:
        rho_raw = rho
    wk = const.FOURPITHIRD * h ** 3 * rho_raw / scene.mpart_gas
    dev = np.abs(np.asarray(wk) - desnngb)
    frac_ok = float((dev < const.NNGBDEV + 1e-3).mean())

    mem = jax.local_devices()[0].memory_stats() or {}
    # B-field evidence: the record must prove a real
    # BFLD block, not just a stage that ran (magnetic_field.c:71-131)
    bstats = None
    if cfg.bfld_norm and parts.bfld.shape[0]:
        from toycluster.models.bfield import BMAX, BMAX_SUB
        n_gas = parts.n_gas
        bmag = np.asarray(jnp.linalg.norm(parts.bfld, axis=-1))
        bstats = {
            "b_max_uG": round(float(bmag.max()) * 1e6, 4),
            "b_median_uG": round(float(np.median(bmag)) * 1e6, 6),
            "b_nonzero_frac": round(float((bmag > 0).mean()), 6),
            "b_finite_frac": round(float(np.isfinite(bmag).mean()), 6),
            # cap census: explains a b_max that sits exactly at a cap
            # (magnetic_field.c:113-114 — BMAX_SUB=2uG in subhaloes)
            "cap_frac_18uG": round(
                float((bmag >= BMAX * 0.999).mean()), 8),
            "cap_frac_sub_2uG": round(
                float((bmag >= BMAX_SUB * 0.999).mean()), 8),
        }
        # at-scale B validation: per host halo, median
        # |B| per log-r bin against the Bonafede+2010 scaling
        # B proportional to (rho_model/rho0)^eta (magnetic_field.c:33-69).
        # Pre-cap bins must show a near-constant |B| / (rho/rho0)^eta.
        eta = cfg.bfld_eta
        pos_g = np.asarray(parts.pos[:n_gas])
        halo_g = np.asarray(parts.halo[:n_gas])
        rhom_g = np.asarray(parts.rho_model[:n_gas])
        profiles = []
        for i in range(min(scene.sub_first, 3)):
            h_i = scene.halos[i]
            if h_i.mass_gas <= 0 or h_i.rho0 <= 0:
                continue
            c = np.asarray(h_i.d_com, np.float64) + scene.boxhalf
            sel = halo_g == i
            if sel.sum() < 1000:
                continue
            r = np.linalg.norm(pos_g[sel] - c, axis=-1)
            b_i = bmag[:n_gas][sel]
            x_i = (rhom_g[sel] / h_i.rho0) ** eta
            edges = np.geomspace(max(h_i.r200 / 100, 1.0), h_i.r200, 13)
            med_b, med_x, cnt = [], [], []
            for lo, hi in zip(edges[:-1], edges[1:]):
                m = (r >= lo) & (r < hi)
                cnt.append(int(m.sum()))
                med_b.append(float(np.median(b_i[m])) if m.any() else None)
                med_x.append(float(np.median(x_i[m])) if m.any() else None)
            ratios = [b / x for b, x, n in zip(med_b, med_x, cnt)
                      if b and x and n > 200 and b < BMAX * 0.999]
            scatter = (round(float(np.std(ratios) / np.mean(ratios)), 4)
                       if len(ratios) >= 3 else None)
            profiles.append({
                "halo": i, "r200": round(h_i.r200, 1),
                "r_edges_kpc": [round(e, 2) for e in edges],
                "median_B_G": med_b, "median_rho_scaling": med_x,
                "bin_counts": cnt,
                # fractional scatter of |B|/(rho/rho0)^eta across
                # populated pre-cap bins: ~0 means the field tracks the
                # Bonafede scaling at scale
                "scaling_ratio_scatter": scatter,
            })
        bstats["radial_profiles"] = profiles
    out = {
        "config": IDX,
        "ntotal": cfg.ntotal,
        "n_gas": parts.n_gas,
        "kernel": cfg.sph_kernel,
        "desnngb": desnngb,
        "wall_clock_s": round(wall, 1),
        "wvt_iterations": len(wvt_log),
        "wvt_err_mean_final": wvt_log[-1]["err_mean"] if wvt_log else None,
        "wvt_err_mean_first": wvt_log[0]["err_mean"] if wvt_log else None,
        "stage_seconds": {k: round(v, 1) for k, v in stage_t.items()},
        "stage_counts": stage_n,
        "contract_frac_within_NNGBDEV": round(frac_ok, 5),
        "contract_median_dev": round(float(np.median(dev)), 4),
        "contract_p999_dev": round(float(np.percentile(dev, 99.9)), 4),
        "hbm_peak_bytes": mem.get("peak_bytes_in_use"),
        "hbm_peak_gib": round(mem.get("peak_bytes_in_use", 0) / 2**30, 2),
        # standing (stage-boundary) live-buffer estimates; kernel
        # transients ride on top
        "stage_hbm_est_gib": stage_hbm,
        "device": str(jax.devices()[0]),
        "overrides": sys.argv[2:],
        "output_file": cfg.output_file,
        "snapshot_bytes": os.path.getsize(cfg.output_file)
        if os.path.exists(cfg.output_file) else None,
        "bfield": bstats,
        # full per-iteration relaxation trajectory (wvt_relax.c:91-92's
        # printed oracle)
        "wvt_trajectory": wvt_log,
    }
    path = f"flagship_config{IDX}.json"   # in the working directory
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
