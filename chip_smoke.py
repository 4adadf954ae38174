#!/usr/bin/env python3
"""Proof that the IC pipeline runs on the GPU, one process, random data
from fixed seeds.

    python chip_smoke.py               # one GPU: phases 1-5
    python chip_smoke.py --four-cards  # four GPUs: the sharded path only

One card:
  1. device check (a GPU, or exit non-zero) and the card's name, power
     limit, memory limit and JAX version;
  2. the compiled Triton kernels against the XLA pair operators on
     receiver rows from centre to outskirts of a freshly sampled 5e6-gas
     cluster (h/rho/displacement and curl), and one WVT iteration at
     5e6 gas timed with each engine;
  3. the cold WVT err_mean trajectory at 1e6 gas against its pinned
     digits;
  4. BASELINE config 2 (1e6 particles with a B-field) end to end through
     make_ics from the in-repo parameter file: neighbour contract,
     snapshot read-back, stage seconds, and the curl stage timed with
     each engine.
Four cards: the sharded WVT step (ring halo over the Triton kernel) on a
4-GPU mesh against the single-card step, then make_ics(mesh=4 cards) at
config-3 geometry with 2e6 particles.

The last line of stdout is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# WVT err_mean at 1e6 gas, iterations 0-3, cold start (PRNGKey(1) sample)
TRAJ_PINNED = (0.20677, 0.07789, 0.04372, 0.03366)
TRAJ_RTOL = 0.01


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def device_check(n_cards):
    import jax
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX found {devs[0].platform!r} devices")
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, found {len(devs)}")
    card = card_line()
    stats = devs[0].memory_stats() or {}
    print(f"card: {card}")
    print(f"device_kind: {devs[0].device_kind}  count: {len(devs)}  "
          f"bytes_limit: {stats.get('bytes_limit')}  "
          f"jax: {jax.__version__}", flush=True)
    return card


def timed(fn, *a, **k):
    import jax
    t = time.perf_counter()
    out = fn(*a, **k)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t


def _sample(ntotal, seed, **over):
    import jax
    from toycluster import STOCK_PAR, parse_par_file
    from toycluster.models import positions as pos_mod
    from toycluster.particles import halo_arrays_from_scene
    from toycluster.scene import build_scene
    cfg = parse_par_file(STOCK_PAR).replace(ntotal=ntotal, **over)
    scene = build_scene(cfg)
    ha = halo_arrays_from_scene(scene)
    parts = pos_mod.make_positions(jax.random.PRNGKey(seed), scene, ha)
    parts = pos_mod.shift_origin(parts, ha, scene.boxsize)
    return cfg, scene, ha, parts


def _rows_centre_to_outskirts(bi, centre, n_rows):
    """Receiver blocks at evenly spaced quantiles of their distance from
    the cluster centre."""
    import jax.numpy as jnp
    import numpy as np
    cen = np.asarray(0.5 * (bi.bb_lo + bi.bb_hi))
    r = np.linalg.norm(cen - np.asarray(centre), axis=1)
    order = np.argsort(r)
    pick = order[np.linspace(0, len(order) - 1, n_rows).astype(int)]
    return jnp.asarray(np.unique(pick).astype(np.int32))


def _pow2_width(counts, width):
    """Chunk list width: the pow2 ceiling of the chunk's largest count
    (few distinct shapes, so few compiles)."""
    need = max(int(counts.max()), 1)
    return min(1 << (need - 1).bit_length(), width)


def kernel_checks(card, n_gas=5_000_000, n_rows=512):
    """Phase 2: the compiled kernels against pair_ops on the same
    superblock lists, and a WVT iteration timed with each engine."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from toycluster import constants as const
    from toycluster.models import bfield as bf_mod
    from toycluster.models import sph as sph_mod
    from toycluster.models import wvt
    from toycluster.ops import blocks as blk
    from toycluster.ops import pair_ops
    from toycluster.ops import stream as so

    cfg, scene, ha, parts = _sample(2 * n_gas, 11)
    box, mpart, desnngb = scene.boxsize, scene.mpart_gas, cfg.desnngb
    pos = parts.pos[:n_gas]
    rho_m, h0_m, h_box = wvt._model_fields_from_rho(
        sph_mod.global_density_model(pos, ha, box), mpart, desnngb)
    cap_gas = h0_m * sph_mod._CAP_FACTOR
    state = sph_mod.build_neighbours(
        pos, cap_gas, box, engine="stream",
        radius_sym_gas=h_box * box * wvt._SYM_MARGIN)
    bi = state.index
    nb = bi.n_blocks
    pad = lambda x: sph_mod._pad_sorted(x, bi.order, bi.n_padded)  # noqa
    h0_s, cap_s = pad(h0_m), state.h_cap
    hm_s = jnp.where(bi.valid, pad(h_box), 0.0)
    rows = _rows_centre_to_outskirts(bi, ha.d_com[0] + scene.boxhalf,
                                     n_rows)
    ids = rows
    cand = state.cand.idx[ids]
    cnt = jnp.minimum(state.cand.count[ids], cand.shape[1])
    print(f"kernel check: n_gas={n_gas} rows={len(ids)} list width="
          f"{cand.shape[1]} counts p50/max={int(jnp.median(cnt))}/"
          f"{int(cnt.max())}", flush=True)

    pos_t = bi.pos.reshape(nb, blk.BLOCK, 3).transpose(0, 2, 1)
    src = jnp.concatenate([pos_t, hm_s.reshape(nb, 1, blk.BLOCK)], axis=1)
    rb = lambda x: x.reshape(nb, blk.BLOCK)[ids]  # noqa: E731
    bits, safe = so.stream_skip_bits(
        bi.bb_lo, bi.bb_hi, hm_s.reshape(nb, blk.BLOCK).max(axis=1), ids,
        cand, rb(cap_s), rb(hm_s), float(box), sb=True)
    run_k = (lambda: so.stream_wvt(
        src, cand, cnt, pos_t[ids], rb(h0_s), rb(cap_s), rb(hm_s),
        float(mpart), float(box), kernel=cfg.sph_kernel, desnngb=desnngb,
        sb_mode=True, bits=bits, safe=safe))
    _, t_k0 = timed(run_k)
    (rho_k, h_k, vf_k, wk_k, done_k, d_k), t_k = timed(run_k)

    # XLA reference over the same lists, expanded to member blocks, in
    # chunks of rows sorted by count (bounded (G, B, M*B) tiles)
    order = np.argsort(np.asarray(cnt))
    out_x = {k: np.zeros((len(ids), blk.BLOCK) + s, np.float32)
             for k, s in (("rho", ()), ("h", ()), ("done", ()),
                          ("delta", (3,)))}
    for c0 in range(0, len(order), 32):
        sl = order[c0:c0 + 32]
        w = _pow2_width(np.asarray(cnt)[sl], cand.shape[1])
        sb_rows = jnp.where(jnp.arange(cand.shape[1])[None, :w]
                            < cnt[sl][:, None], cand[sl][:, :w], -1)
        sel = pair_ops.BlockSelection(
            ids=ids[sl], cand=sph_mod.expand_tail_rows(sb_rows, nb))
        res, dlt = (
            pair_ops.solve_density(bi, sel, h0_s, cap_s, mpart, box,
                                   kernel=cfg.sph_kernel, desnngb=desnngb),
            pair_ops.wvt_displacement(bi, sel, hm_s, 1.0, box,
                                      kernel=cfg.sph_kernel))
        out_x["rho"][sl] = np.asarray(res.rho).reshape(-1, blk.BLOCK)
        out_x["h"][sl] = np.asarray(res.hsml).reshape(-1, blk.BLOCK)
        out_x["done"][sl] = np.asarray(res.done).reshape(-1, blk.BLOCK)
        out_x["delta"][sl] = np.asarray(dlt).reshape(-1, blk.BLOCK, 3)

    v = np.asarray(rb(bi.valid))
    done_x = out_x["done"].astype(bool) & v
    done_p = np.asarray(done_k) & v
    cover = done_p.sum() / max(done_x.sum(), 1)
    both = done_x & done_p
    hk, hx = np.asarray(h_k)[both], out_x["h"][both]
    rk, rx = np.asarray(rho_k)[both], out_x["rho"][both]
    bulk = (np.isclose(hk, hx, rtol=2e-3)
            & np.isclose(rk, rx, rtol=2e-3)).mean()
    wk_dev = np.abs(np.asarray(wk_k)[both] - desnngb).max()
    a = out_x["delta"][v]
    b = np.asarray(d_k)[v]
    scale = np.abs(a).max()
    d_err = np.abs(b - a) / (2e-4 * np.abs(a) + 1e-6 * scale)
    print(f"wvt kernel vs xla: done coverage {cover:.4f}, h/rho bulk match "
          f"{bulk:.4f}, max|wk-{desnngb}| {wk_dev:.4f}, displacement "
          f"max err/tol {d_err.max():.3f}", flush=True)
    print(f"wvt kernel on these rows: {t_k:.4f} s (first call "
          f"{t_k0:.2f} s; {card})", flush=True)
    check(cover >= 0.97, f"done coverage {cover:.4f} < 0.97")
    check(bulk > 0.98, f"h/rho bulk match {bulk:.4f} <= 0.98")
    check(wk_dev < const.NNGBDEV + 1e-3, f"max|wk - n| {wk_dev:.4f}")
    check(d_err.max() <= 1.0, f"displacement err/tol {d_err.max():.3f}")

    # curl on the same rows: receivers take the XLA-solved h/rho/vf
    parts = bf_mod.set_vector_potential(scene, ha, parts)
    ap_s = pad(parts.apot[:n_gas])
    ap_t = ap_s.reshape(nb, blk.BLOCK, 3).transpose(0, 2, 1)
    src8 = jnp.concatenate(
        [pos_t, bi.valid.astype(jnp.float32).reshape(nb, 1, blk.BLOCK),
         ap_t, jnp.zeros((nb, 1, blk.BLOCK), jnp.float32)], axis=1)
    h_r = jnp.asarray(out_x["h"])
    rho_r = jnp.asarray(np.where(v, out_x["rho"], 1.0))
    res_vf = jnp.ones_like(h_r)
    wfac = jnp.where(jnp.asarray(v), -float(mpart) * res_vf / rho_r, 0.0)
    bits_c, safe_c = so.stream_skip_bits(
        bi.bb_lo, bi.bb_hi, None, ids, cand, h_r, None, float(box),
        sb=True)
    run_c = (lambda: so.stream_curl(
        src8, cand, cnt, pos_t[ids], h_r, wfac, ap_t[ids], float(mpart),
        float(box), kernel=cfg.sph_kernel, sb_mode=True, bits=bits_c,
        safe=safe_c))
    _, t_c0 = timed(run_c)
    b_k, t_c = timed(run_c)
    h_full = jnp.zeros((bi.n_padded,), jnp.float32).at[
        (ids[:, None] * blk.BLOCK + jnp.arange(blk.BLOCK)).reshape(-1)
    ].set(h_r.reshape(-1))
    rho_full = jnp.ones((bi.n_padded,), jnp.float32).at[
        (ids[:, None] * blk.BLOCK + jnp.arange(blk.BLOCK)).reshape(-1)
    ].set(rho_r.reshape(-1))
    b_x = np.zeros((len(ids), blk.BLOCK, 3), np.float32)
    for c0 in range(0, len(order), 32):
        sl = order[c0:c0 + 32]
        w = _pow2_width(np.asarray(cnt)[sl], cand.shape[1])
        sb_rows = jnp.where(jnp.arange(cand.shape[1])[None, :w]
                            < cnt[sl][:, None], cand[sl][:, :w], -1)
        sel = pair_ops.BlockSelection(
            ids=ids[sl], cand=sph_mod.expand_tail_rows(sb_rows, nb))
        bx = pair_ops.sph_curl(bi, sel, h_full, rho_full,
                               jnp.ones_like(h_full), ap_s, mpart, box,
                               kernel=cfg.sph_kernel)
        b_x[sl] = np.asarray(bx).reshape(-1, blk.BLOCK, 3)
    bk = np.asarray(b_k)[v]
    bx = b_x[v]
    nrm = np.linalg.norm(bx, axis=1)
    rel = np.linalg.norm(bk - bx, axis=1) / (nrm + 1e-6 * nrm.max())
    med, p99 = float(np.median(rel)), float(np.percentile(rel, 99))
    print(f"curl kernel vs xla: median rel err {med:.2e}, p99 {p99:.2e}; "
          f"kernel on these rows {t_c:.4f} s (first {t_c0:.2f} s; "
          f"{card})", flush=True)
    check(med <= 1e-5, f"curl median rel err {med:.2e} > 1e-5")
    check(p99 <= 1e-3, f"curl p99 rel err {p99:.2e} > 1e-3")
    del state, bi, src, src8, parts
    wvt_iteration_times(card, cfg, scene, ha, pos, iters=4)


_COMPILE_S = [0.0]


def _count_compiles():
    """Accumulate XLA backend-compile seconds (jax.monitoring), so timed
    windows can say how much of their wall was compilation."""
    import jax

    def on_event(event, duration, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            _COMPILE_S[0] += duration

    jax.monitoring.register_event_duration_secs_listener(on_event)


def wvt_iteration_times(card, cfg, scene, ha, pos_gas, iters=2,
                        engines=("stream", "xla")):
    """One WVT relaxation of `iters` iterations (plus it=0) per engine on
    the same sample; prints each iteration's wall seconds, the compile
    seconds inside it, and its structure events."""
    import dataclasses
    import jax.numpy as jnp
    from toycluster.models import wvt
    from toycluster.particles import empty_particles

    sc = dataclasses.replace(scene, config=cfg.replace(wvt_max_iter=iters))
    for engine in engines:
        parts = empty_particles(scene.npart_gas, scene.npart_dm)
        parts = parts._replace(
            pos=parts.pos.at[:scene.npart_gas].set(pos_gas),
            halo=jnp.zeros((parts.n_total,), jnp.int32))
        stamps = [(time.perf_counter(), _COMPILE_S[0])]
        events = [[]]

        def log(stage, **kw):
            if stage == "wvt":
                stamps.append((time.perf_counter(), _COMPILE_S[0]))
                events.append([])
            elif stage in ("wvt_build", "wvt_refresh"):
                events[-1].append(stage[4:])
            elif stage == "wvt_accept":   # logged after its iteration
                events[-2].append("accept")

        out = wvt.regularise_sph_particles(sc, ha, parts, log=log,
                                           engine=engine)
        out.pos.block_until_ready()
        its = [f"{b[0] - a[0]:.3f}s(compile {b[1] - a[1]:.1f}s"
               f"{' ' + '+'.join(e) if e else ''})"
               for a, b, e in zip(stamps, stamps[1:], events)]
        print(f"wvt iteration seconds at {scene.npart_gas} gas, engine "
              f"{engine}: {', '.join(its)} ({card})", flush=True)
        del out, parts


def wvt_trajectory(card, n_gas=1_000_000, iters=3):
    """Phase 3: cold err_mean trajectory, iterations 0..iters."""
    import dataclasses
    from toycluster.models import wvt
    cfg, scene, ha, parts = _sample(2 * n_gas, 1, wvt_max_iter=iters)
    errs = []
    t0 = time.perf_counter()

    def log(stage, **kw):
        if stage == "wvt":
            errs.append(kw["err_mean"])

    wvt.regularise_sph_particles(
        dataclasses.replace(scene, config=cfg), ha, parts, log=log)
    print(f"wvt trajectory at {n_gas} gas, cold: err_mean "
          f"{' / '.join(f'{e:.5f}' for e in errs)} "
          f"({time.perf_counter() - t0:.1f} s incl. compile; {card})",
          flush=True)
    check(len(errs) >= len(TRAJ_PINNED), f"only {len(errs)} iterations")
    for k, (e, ref) in enumerate(zip(errs, TRAJ_PINNED)):
        check(abs(e - ref) <= TRAJ_RTOL * ref,
              f"err_mean[{k}] = {e:.5f}, pinned {ref} (rtol {TRAJ_RTOL})")


def config2(card):
    """Phase 4: BASELINE config 2 through make_ics, as the CLI runs it."""
    import jax
    import numpy as np
    from configs.run_configs import PRESETS
    from toycluster import STOCK_PAR, parse_par_file
    from toycluster.io.gadget import read_snapshot
    from toycluster.models import bfield as bf_mod
    from toycluster.models import sph as sph_mod
    from toycluster.particles import halo_arrays_from_scene
    from toycluster.pipeline import make_ics
    from toycluster.utils.logging import stage_log

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "IC_config2")
        cfg = parse_par_file(STOCK_PAR, **{**PRESETS[2],
                                           "output_file": out})
        marks = [("start", time.perf_counter(), {})]

        def log(stage, **kw):
            marks.append((stage, time.perf_counter(), dict(kw)))
            stage_log(stage, **kw)

        t0 = time.perf_counter()
        scene, parts = make_ics(cfg, log=log)
        wall = time.perf_counter() - t0
        snap = read_snapshot(out)
    stage_s = {}
    for (_, ta, _), (st, tb, _) in zip(marks, marks[1:]):
        stage_s[st] = stage_s.get(st, 0.0) + (tb - ta)
    for st, dt in stage_s.items():
        print(f"config2 stage {st}: {dt:.3f} s ({card})")
    peaks = [kw["peak_gib"] for _, _, kw in marks
             if kw.get("peak_gib") is not None]
    print(f"config2 wall {wall:.2f} s, peak device GiB "
          f"{max(peaks) if peaks else 'not reported'} ({card})", flush=True)
    for k in ("pos", "vel", "ids", "u", "rho", "hsml", "bfld"):
        check(snap.get(k) is not None, f"snapshot lacks {k}")
        check(np.isfinite(snap[k].astype(np.float64)).all(),
              f"snapshot {k} not finite")
    check(snap["pos"].shape == (scene.ntotal, 3), "snapshot pos shape")

    ha = halo_arrays_from_scene(scene)
    sph_mod.find_sph_quantities(scene, ha, parts)
    contract = sph_mod.last_contract_frac
    print(f"config2 WC6/{cfg.desnngb} contract {contract:.5f}", flush=True)
    check(contract >= 0.999, f"contract {contract:.5f} < 0.999")

    # the curl stage through each engine, on the finished IC
    for engine in ("stream", "xla"):
        ts = []
        for _ in range(2):
            t = time.perf_counter()
            res = bf_mod.make_magnetic_field(scene, ha, parts,
                                             engine=engine)
            jax.block_until_ready(res.bfld)
            ts.append(round(time.perf_counter() - t, 3))
        print(f"config2 curl stage, engine {engine}: {ts[1]} s warm "
              f"({ts[0]} s first; {card})", flush=True)


def four_cards(card, ntotal=2_000_000):
    """The sharded WVT step on a 4-GPU mesh (ring halo over the Triton
    kernel) against the single-card step, then make_ics on 4 cards."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from configs.run_configs import PRESETS
    from toycluster import STOCK_PAR, parse_par_file
    from toycluster.ops.blocks import BLOCK
    from toycluster.ops.stream import FAN
    from toycluster.parallel import wvt_shard
    from toycluster.parallel.mesh import make_mesh
    from toycluster.pipeline import make_ics

    cfg, scene, ha, parts = _sample(ntotal, 3)
    outs = {}
    for ndev, halo in ((1, "gather"), (4, "ring")):
        mesh = make_mesh(ndev)
        pos, n_real = wvt_shard.pad_for_mesh(parts.pos[:parts.n_gas], ndev)
        pos = wvt_shard.shard_array(mesh, pos)
        hsml = wvt_shard.shard_array(
            mesh, jnp.zeros((pos.shape[0],), jnp.float32))
        # full-width lists and halo buffer (every superblock): a cold
        # start's outskirt rows reach far, and the sharded step reports
        # overflow, never grows
        n_sb = pos.shape[0] // (BLOCK * FAN)
        step = wvt_shard.sharded_wvt_iteration(
            mesh, ha, n_real=n_real, boxsize=scene.boxsize,
            mpart=scene.mpart_gas, desnngb=cfg.desnngb,
            kernel=cfg.sph_kernel, max_cand=4 * n_sb, engine="stream",
            halo=halo, max_remote_sb=n_sb)
        out, t = timed(step, pos, hsml, 0.0085)
        out2, t2 = timed(step, pos, hsml, 0.0085)
        check(int(out.cand_overflow) <= 0, f"{ndev}-card overflow")
        check(len(pos.sharding.device_set) == ndev
              and len(out.rho.sharding.device_set) == ndev,
              f"arrays not on {ndev} device(s)")
        outs[ndev] = out
        print(f"sharded step on {ndev} card(s), halo {halo}: {t2:.3f} s "
              f"warm ({t:.2f} s first; {card})", flush=True)
    a, b = outs[1], outs[4]
    n = parts.n_gas
    rho_rel = np.abs(np.asarray(b.rho[:n]) / np.asarray(a.rho[:n]) - 1)
    h_rel = np.abs(np.asarray(b.hsml[:n]) / np.asarray(a.hsml[:n]) - 1)
    print(f"4 vs 1 card: rho rel p50/max {np.median(rho_rel):.2e}/"
          f"{rho_rel.max():.2e}, hsml {np.median(h_rel):.2e}/"
          f"{h_rel.max():.2e}, err_mean {float(a.err_mean):.6f}/"
          f"{float(b.err_mean):.6f}", flush=True)
    check(np.isclose(float(a.err_mean), float(b.err_mean), rtol=1e-3),
          "err_mean differs across meshes")
    check((rho_rel < 2e-4).mean() > 0.999, "rho differs across meshes")

    with tempfile.TemporaryDirectory() as tmp:
        cfg3 = parse_par_file(STOCK_PAR, **{
            **PRESETS[3], "ntotal": ntotal,
            "output_file": os.path.join(tmp, "IC_config3_4cards")})
        overflow = []

        def log(stage, **kw):
            if stage == "wvt_shard":
                overflow.append(kw["overflow"])

        t = time.perf_counter()
        _, p = make_ics(cfg3, mesh=make_mesh(4), log=log)
        jax.block_until_ready(p.pos)
        wall = time.perf_counter() - t
    check(bool(np.isfinite(np.asarray(p.rho)).all()), "4-card IC rho")
    print(f"make_ics on 4 cards, config-3 geometry, {ntotal} particles: "
          f"{wall:.1f} s, {len(overflow)} WVT iterations, max candidate "
          f"overflow {max(overflow)} ({card})", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded path")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    try:
        card = device_check(n_cards)
        _count_compiles()
        if args.four_cards:
            four_cards(card)
        else:
            kernel_checks(card)
            wvt_trajectory(card)
            config2(card)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    import jax
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
