"""Position sampling (device, jitted).

Replaces the reference's per-thread erand48 rejection loops
(positions.c:25-133) with vmapped inverse-CDF draws + oversampled batch
rejection under counter-based `jax.random` keys: each round draws one
oversized iid batch, tests acceptance, and compacts the accepted lanes
into the output buffer with a single drop-mode scatter; a host-checked
loop issues further (rate-adapted) rounds for any shortfall.  Lanes are
iid and acceptance is per-lane, so keeping the accepted prefix of an
oversampled batch draws from exactly the reference's conditional
distribution — with ~2 device dispatches instead of a device-side
`lax.while_loop` around the draw.
Positions are sampled around each halo's centre; `shift_origin` moves them
into the periodic box afterwards (setup.c:427-500).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as const
from ..ops.interp import SplineTable, spline_eval
from ..particles import HaloArrays, Particles, empty_particles, \
    gas_density_device
from ..scene import Scene

_MAX_REJECT_ROUNDS = 4096  # safety cap; reference loops unboundedly


def _sphere_dirs(key, n):
    """Isotropic unit vectors via (theta, phi) draws (positions.c:58-65)."""
    k1, k2 = jax.random.split(key)
    cos_t = 2.0 * jax.random.uniform(k1, (n,)) - 1.0
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = 2.0 * const.PI * jax.random.uniform(k2, (n,))
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t],
                     axis=-1)


def halo_containing_gas(pos_abs, ha: HaloArrays, boxsize, cool_core=None):
    """Which halo owns a gas particle at absolute centred coords:
    the halo with the largest beta-model density at that point among
    non-stripped halos with r < R_sample_gas (positions.c:363-385).

    lax.fori_loop over halos (not a Python unroll): substructure scenes
    carry ~50 halos and this runs INSIDE the rejection-sampler programs
    — unrolled it multiplied their compile size ~50x."""
    n = pos_abs.shape[0]

    def body(j, carry):
        best, rho_max = carry
        r = jnp.linalg.norm(pos_abs - ha.d_com[j], axis=-1)
        rho = gas_density_device(r, ha, j, cool_core)
        ok = ((rho > rho_max) & (r < ha.r_sample_gas[j])
              & ~ha.is_stripped[j])
        return (jnp.where(ok, j, best), jnp.where(ok, rho, rho_max))

    best, _ = jax.lax.fori_loop(
        0, ha.n_halos, body,
        (jnp.zeros((n,), jnp.int32), jnp.zeros((n,), pos_abs.dtype)))
    oob = jnp.any(pos_abs > boxsize, axis=-1)  # positions.c:337-338
    return jnp.where(oob, -1, best)


def halo_containing_dm(pos_abs, ha: HaloArrays, sub_first, boxsize):
    """DM ownership: halo 1 if within its sampling radius and x>0, else the
    first subhalo whose sampling radius contains the point, else 0
    (positions.c:342-361)."""
    n = pos_abs.shape[0]
    best = jnp.zeros((n,), jnp.int32)
    if ha.n_halos > 1 and sub_first > 1:
        r1 = jnp.linalg.norm(pos_abs - ha.d_com[1], axis=-1)
        best = jnp.where((r1 < ha.r_sample_dm[1]) & (pos_abs[:, 0] > 0),
                         1, best)

    # first matching subhalo wins (break in the reference) -> scan high
    # to low so the lowest matching j lands last
    def body(k, best):
        j = ha.n_halos - 1 - k
        rj = jnp.linalg.norm(pos_abs - ha.d_com[j], axis=-1)
        return jnp.where(rj < ha.r_sample_dm[j], j, best)

    best = jax.lax.fori_loop(0, max(ha.n_halos - sub_first, 0), body,
                             best)
    oob = jnp.any(pos_abs > boxsize, axis=-1)
    return jnp.where(oob, -1, best)


def _quant_batch(m: int) -> int:
    """Round a draw-batch size up to 2 mantissa bits ({4,5,6,7} x 2^k):
    few distinct program shapes per process (compile reuse) without the
    ~2x padding waste of plain pow2 rounding."""
    m = max(int(m), 1024)
    k = (m - 1).bit_length() - 3  # ≥ 8 lanes, so k ≥ 0 after max above
    step = 1 << k
    return -(-m // step) * step


def _compact_fill(out, c, n_t, cand, ok):
    """Compact the accepted lanes of one round into out[c:...] via a
    drop-mode scatter: accepted lane j lands at c + (number of accepted
    lanes before j); rejected lanes and overshoot past the buffer edge
    scatter-drop.  n_t is the DYNAMIC fill target (<= buffer size)."""
    nq = out.shape[0]
    tgt = jnp.where(ok, c + jnp.cumsum(ok) - 1, nq)
    out = out.at[tgt].set(cand, mode="drop")
    return out, jnp.minimum(c + ok.sum(), n_t)


def _dm_round_impl(sub, out, c, n_t, ha, i, sub_first: int,
                   boxsize: float, m: int):
    """One DM rejection round: Hernquist inverse-CDF draw of m iid lanes
    (positions.c:48-65) + foreign-halo acceptance + compaction."""
    kd, kr = jax.random.split(sub)
    dirs = _sphere_dirs(kd, m)
    sq = jnp.sqrt(jax.random.uniform(kr, (m,)) * ha.mass_corr_fac[i])
    r = ha.a_hernq[i] * sq / (1.0 - sq)
    cand = dirs * r[:, None]
    ok = halo_containing_dm(cand + ha.d_com[i], ha, sub_first,
                            boxsize) == i
    return _compact_fill(out, c, n_t, cand, ok)


_dm_round = partial(jax.jit, static_argnums=(6, 7, 8))(_dm_round_impl)


def _gas_round_impl(sub, out, c, n_t, ha, i, boxsize: float, cool_core,
                    m: int):
    """One gas rejection round: tabulated M(<r) inversion draw
    (positions.c:105-106) + foreign-halo/out-of-box acceptance +
    compaction."""
    table = SplineTable(ha.minv_x[i], ha.minv_y[i], ha.minv_m2[i])
    kd, kr = jax.random.split(sub)
    dirs = _sphere_dirs(kd, m)
    mass = jax.random.uniform(kr, (m,)) * ha.mass_gas[i]
    r = spline_eval(table, mass)
    cand = dirs * r[:, None]
    owner = halo_containing_gas(cand + ha.d_com[i], ha, boxsize,
                                cool_core)
    inside = jnp.all(jnp.abs(cand) <= boxsize / 2.0, axis=-1)
    ok = (owner == i) & inside
    return _compact_fill(out, c, n_t, cand, ok)


_gas_round = partial(jax.jit, static_argnums=(6, 7, 8))(_gas_round_impl)


@partial(jax.jit, static_argnums=(6, 7, 8))
def _dm_rounds_batched(subs, outs, cs, n_ts, idxs, ha, sub_first: int,
                       boxsize: float, m: int):
    """One DM round for a BATCH of halos in a single program (vmap over
    the halo axis) — substructure scenes carry ~70 subhalos and the
    sequential per-halo path costs ~2 host round-trips each."""
    def one(sub, out, c, n_t, i):
        return _dm_round_impl(sub, out, c, n_t, ha, i, sub_first,
                              boxsize, m)

    return jax.vmap(one)(subs, outs, cs, n_ts, idxs)


@partial(jax.jit, static_argnums=(6, 7, 8))
def _gas_rounds_batched(subs, outs, cs, n_ts, idxs, ha, boxsize: float,
                        cool_core, m: int):
    """One gas round for a BATCH of halos in a single program."""
    def one(sub, out, c, n_t, i):
        return _gas_round_impl(sub, out, c, n_t, ha, i, boxsize,
                               cool_core, m)

    return jax.vmap(one)(subs, outs, cs, n_ts, idxs)


def _size_classes(ns, max_ratio=8):
    """Group halo target counts into classes with bounded max/min ratio
    so one padded batch shape per class wastes at most ~max_ratio x the
    smallest member's lanes.  Returns a list of index-arrays into ns."""
    order = np.argsort(ns)
    classes, cur = [], [order[0]]
    for j in order[1:]:
        if ns[j] <= max_ratio * ns[cur[0]]:
            cur.append(j)
        else:
            classes.append(np.asarray(cur))
            cur = [j]
    classes.append(np.asarray(cur))
    return classes


def _batched_fill(key, ha, idxs, ns, kind, boxsize, sub_first=0,
                  cool_core=None, p_est=0.92):
    """Sample MANY small halos together: one vmapped program execution
    and ONE host sync per round for the whole batch, instead of the
    sequential path's per-halo program + per-round sync (at 70 subhalos
    that is ~280 blocking host round-trips).  Distribution-identical
    to the sequential engine: lanes stay iid per halo, acceptance is
    per-lane, compaction keeps draw order (positions.c:25-133 contract).

    idxs/ns: host int arrays of halo indices and fill targets.
    Returns {halo_index: (pos (n, 3) device, acc (n,) bool)}."""
    idxs = np.asarray(idxs)
    ns = np.asarray(ns)
    results = {}
    for cls in _size_classes(ns):
        cidx, cns = idxs[cls], ns[cls]
        H = len(cidx)
        nq = _quant_batch(int(cns.max()))
        outs = jnp.zeros((H, nq, 3), jnp.float32)
        cs = jnp.zeros((H,), jnp.int32)
        n_ts = jnp.asarray(cns, jnp.int32)
        didx = jnp.asarray(cidx, jnp.int32)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(didx)
        filled = np.zeros(H, np.int64)
        p = np.full(H, p_est)
        m = None
        for r in range(_MAX_REJECT_ROUNDS):
            need = (cns - filled) / np.maximum(p, 0.01) * 1.08
            m_need = _quant_batch(float(need.max()))
            # shape reuse across catch-up rounds (see _rejection_fill)
            if m is None or m_need > 4 * m:
                m = m_need
            subs = jax.vmap(lambda k: jax.random.fold_in(k, r))(keys)
            if kind == "dm":
                outs, cs = _dm_rounds_batched(
                    subs, outs, cs, n_ts, didx, ha, int(sub_first),
                    float(boxsize), m)
            else:
                outs, cs = _gas_rounds_batched(
                    subs, outs, cs, n_ts, didx, ha, float(boxsize),
                    cool_core, m)
            new_filled = np.asarray(cs).astype(np.int64)  # ONE sync
            p = np.maximum((new_filled - filled) / m, 0.01)
            filled = new_filled
            if (filled >= cns).all():
                break
        for j in range(H):
            acc = (np.arange(cns[j]) <
                   filled[j]) if filled[j] < cns[j] else np.ones(
                       cns[j], bool)
            # acc stays a HOST array: the under-fill check in
            # make_positions then costs no device round-trip per halo
            results[int(cidx[j])] = (outs[j, : cns[j]], acc)
    return results


def _rejection_fill(key, n, round_fn, p_est=0.92):
    """Oversample + compact (host-checked rounds): the batch-rejection
    engine shared by the position samplers.  Each round is ONE program
    (`round_fn(sub, out, c, n_t, m)`), with round sizes adapted to the
    measured acceptance rate — usually a single round suffices.
    Equivalent in distribution to the reference's per-particle rejection
    loops (positions.c:48-133): lanes are iid, acceptance is per-lane,
    and compaction keeps accepted lanes in draw order.

    The output buffer is batch-quantized (static shape reuse across the
    ~50 halos of a substructure scene); the true target n rides as a
    dynamic scalar and callers slice [:n]."""
    nq = _quant_batch(n)
    out = jnp.zeros((nq, 3), jnp.float32)
    c = jnp.int32(0)
    n_t = jnp.int32(n)
    filled = 0
    m = None
    for _ in range(_MAX_REJECT_ROUNDS):
        m_need = _quant_batch((n - filled) / max(p_est, 0.01) * 1.08)
        # reuse the FIRST round's batch shape for catch-up rounds: a
        # smaller m would mint a new program (a fresh compile), while
        # redrawing the full batch costs little device time; only grow
        # the shape if the acceptance estimate collapsed
        if m is None or m_need > 4 * m:
            m = m_need
        key, sub = jax.random.split(key)
        out, c = round_fn(sub, out, c, n_t, m)
        new_filled = int(c)   # one host sync per round; rounds are few
        p_est = max((new_filled - filled) / m, 0.01)
        filled = new_filled
        if filled >= n:
            return out, jnp.ones((nq,), bool)
    # unreachable for physical configs (acceptance is bounded below by
    # the halo's own density support); mirror the reference's bounded
    # fallback (velocities.c:94-95 pattern): unfilled lanes report False
    return out, jnp.arange(nq) < filled


def sample_halo_dm(key, ha: HaloArrays, i, n: int, sub_first: int,
                   boxsize: float):
    """Hernquist inverse-CDF sampling with foreign-halo rejection
    (positions.c:48-88) via the oversample+compact engine.  The halo
    index i is DYNAMIC (a traced scalar) and buffer/batch sizes are
    quantized, so substructure scenes (~50 halos) compile a handful of
    programs instead of one per halo.  Returns (pos (n, 3), acc (n,))."""
    def round_fn(sub, out, c, n_t, m):
        return _dm_round(sub, out, c, n_t, ha, i, sub_first,
                         float(boxsize), m)

    pos, acc = _rejection_fill(key, n, round_fn)
    return pos[:n], acc[:n]


def sample_halo_gas(key, ha: HaloArrays, i, n: int, boxsize: float,
                    cool_core=None):
    """Beta-model sampling by inverting the tabulated M(<r), with
    foreign-halo and out-of-box rejection (positions.c:90-133).
    Dynamic halo index / quantized buffers — see sample_halo_dm."""
    def round_fn(sub, out, c, n_t, m):
        return _gas_round(sub, out, c, n_t, ha, i, float(boxsize),
                          cool_core, m)

    pos, acc = _rejection_fill(key, n, round_fn)
    return pos[:n], acc[:n]


def _warn_underfill(acc, i, kind):
    """Surface an exhausted rejection budget instead of silently leaving
    unfilled lanes at the halo centre (the zeros of the output buffer).
    Mirrors the reference's bounded-fallback reporting style
    (velocities.c:94-95 prints nothing; we at least warn)."""
    if isinstance(acc, np.ndarray):
        n_bad = int(acc.size) - int(acc.sum())
    else:  # device array: one scalar sync (host halos only, <= 4)
        n_bad = int(np.size(acc)) - int(jnp.sum(acc))
    if n_bad:
        import warnings
        warnings.warn(
            f"halo {i} {kind} sampling under-filled after bounded "
            f"rejection rounds: {n_bad} lanes left at the halo centre",
            RuntimeWarning, stacklevel=2)


def make_positions(key, scene: Scene, ha: HaloArrays) -> Particles:
    """Sample all halos; returns Particles with centred per-halo coords
    (gas first, then DM, both grouped by halo, matching setup.c:253-264)."""
    cfg = scene.config
    cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                 if cfg.double_beta_cool_cores else None)
    parts = empty_particles(scene.npart_gas, scene.npart_dm)

    # subhalos go through the batched engine (one program + one sync per
    # round for the whole population); host halos keep the sequential
    # path (few of them, and their big lane counts dominate compute)
    sub_idx = [i for i in range(scene.sub_first, scene.nhalos)]
    batch_gas, batch_dm = {}, {}
    if len(sub_idx) >= 4:
        kb_g = jax.random.fold_in(key, scene.nhalos + 1)
        kb_d = jax.random.fold_in(key, scene.nhalos + 2)
        gi = [i for i in sub_idx if scene.halos[i].npart_gas]
        if gi:
            batch_gas = _batched_fill(
                kb_g, ha, gi, [scene.halos[i].npart_gas for i in gi],
                "gas", scene.boxsize, cool_core=cool_core)
        di = [i for i in sub_idx if scene.halos[i].npart_dm]
        if di:
            batch_dm = _batched_fill(
                kb_d, ha, di, [scene.halos[i].npart_dm for i in di],
                "dm", scene.boxsize, sub_first=scene.sub_first)

    gas_chunks, gas_halo = [], []
    dm_chunks, dm_halo = [], []
    for i, h in enumerate(scene.halos):
        ki = jax.random.fold_in(key, i)
        kg, kd = jax.random.split(ki)
        if h.npart_gas:
            if i in batch_gas:
                pos, acc = batch_gas[i]
            else:
                pos, acc = sample_halo_gas(kg, ha, jnp.int32(i),
                                           h.npart_gas,
                                           scene.boxsize, cool_core)
            _warn_underfill(acc[:h.npart_gas], i, "gas")
            gas_chunks.append(pos[:h.npart_gas])
            gas_halo.append(jnp.full((h.npart_gas,), i, jnp.int32))
        if h.npart_dm:
            if i in batch_dm:
                pos, acc = batch_dm[i]
            else:
                pos, acc = sample_halo_dm(kd, ha, jnp.int32(i),
                                          h.npart_dm,
                                          scene.sub_first, scene.boxsize)
            _warn_underfill(acc[:h.npart_dm], i, "dm")
            dm_chunks.append(pos[:h.npart_dm])
            dm_halo.append(jnp.full((h.npart_dm,), i, jnp.int32))

    pos = jnp.concatenate(
        [c for c in gas_chunks + dm_chunks] or
        [jnp.zeros((0, 3), jnp.float32)])
    halo = jnp.concatenate(
        [c for c in gas_halo + dm_halo] or [jnp.zeros((0,), jnp.int32)])
    return parts._replace(pos=pos, halo=halo)


def shift_origin(parts: Particles, ha: HaloArrays, boxsize: float
                 ) -> Particles:
    """Move halos to their CoM offsets, shift the origin to the box
    corner and wrap periodically (setup.c:427-500).  The reference adds
    the bulk velocities here too; this pipeline defers them to the
    velocity stage (velocities.add_bulk_velocities) — nothing between
    the two reads vel, halo ids ride every permutation, and the deferral
    keeps the lazy (0, 3) vel unallocated through the WVT loop."""
    pos = _shift_origin_jit(parts.pos, parts.halo, ha.d_com, boxsize)
    return parts._replace(pos=pos)


@jax.jit
def _shift_origin_jit(pos, halo, d_com, boxsize):
    # per-COLUMN gathers: (N,) gathers keep the working set at the
    # column size, whatever layout the backend picks for an (N, 3) one.
    cols_p = []
    for d in range(3):
        sh = jnp.take(d_com[:, d], halo)
        pd = pos[:, d] + sh + boxsize / 2.0
        pd = pd - jnp.floor(pd / boxsize) * boxsize
        cols_p.append(pd)
    return jnp.stack(cols_p, axis=1)


def reassign_gas_to_halos(parts: Particles, ha: HaloArrays, boxsize: float,
                          cool_core=None):
    """Post-relaxation halo membership + stable resort of the gas block by
    halo id (positions.c:264-329).  Returns (particles, per-halo gas counts).
    """
    n_gas = parts.n_gas
    pos_centered = parts.gas_pos - boxsize / 2.0
    owner = halo_containing_gas(pos_centered, ha, boxsize, cool_core)
    order = jnp.argsort(owner, stable=True)
    counts = jnp.bincount(jnp.maximum(owner, 0), length=ha.n_halos)

    def permute_gas(arr):
        return arr.at[:n_gas].set(arr[:n_gas][order]) if arr.ndim else arr

    def permute_gasonly(arr):  # lazy fields may be unallocated
        return arr[order] if arr.shape[0] == n_gas else arr

    new = parts._replace(
        pos=permute_gas(parts.pos),
        vel=(permute_gas(parts.vel) if parts.vel.shape[0]
             else parts.vel),
        pid=permute_gas(parts.pid),
        halo=parts.halo.at[:n_gas].set(owner[order]),
        u=permute_gasonly(parts.u), rho=permute_gasonly(parts.rho),
        hsml=permute_gasonly(parts.hsml),
        var_hsml_fac=permute_gasonly(parts.var_hsml_fac),
        rho_model=permute_gasonly(parts.rho_model),
        bfld=permute_gasonly(parts.bfld),
        apot=permute_gasonly(parts.apot))
    return new, counts


@jax.jit
def _census_counts(pos, halo, n_gas, centers, r200s, sub_first):
    """Per-halo (inside-gas, inside-dm, own-gas, own-dm) particle counts
    in one compiled program (positions.c:152-207 reductions).

    n_gas/sub_first are DYNAMIC scalars on purpose: with a static bound
    the iota comparison constant-folds a 1e7-element array in XLA's HLO
    evaluator at COMPILE time — minutes where the dynamic form takes
    about a second — and the folded executable often failed to land in
    the persistent cache."""
    is_gas = jnp.arange(pos.shape[0]) < n_gas

    def one(i):
        own = halo == i
        member = own | ((i == 0) & (sub_first >= 0)
                        & (halo >= sub_first))
        r2 = ((pos - centers[i]) ** 2).sum(axis=-1)
        inside = member & (r2 < r200s[i] ** 2)
        return jnp.stack([
            (inside & is_gas).sum(), (inside & ~is_gas).sum(),
            (own & is_gas).sum(), (own & ~is_gas).sum()])

    return jax.lax.map(one, jnp.arange(centers.shape[0]))


def show_mass_in_r200(scene, parts, *, log=None):
    """R200 mass census — the reference's headline sampling oracle
    (positions.c:142-216, called at main.c:48,60): per host halo (all
    halos under REPORTSUBHALOS), count this halo's own particles — plus,
    for halo 0, every subhalo's particles — inside its R200 sphere and
    report the gas/DM mass budget and the effective baryon fraction.

    Device reductions over the membership array replace the reference's
    per-halo particle-slice loops.  Returns the per-halo records.
    """
    import sys

    from .. import constants as const

    msph = scene.mpart_gas * scene.units.mass / const.MSOL2CGS
    mdm = scene.mpart_dm * scene.units.mass / const.MSOL2CGS
    boxhalf = scene.boxhalf
    n_gas = parts.n_gas
    n_show = (scene.nhalos if scene.config.report_subhalos
              else scene.sub_first)

    # ONE jitted device program for all halos (lax.map): per-halo eager
    # reductions would each pay a fresh single-op compile
    centers = jnp.asarray(
        np.array([scene.halos[i].d_com for i in range(n_show)],
                 np.float64), jnp.float32) + boxhalf
    r200s = jnp.asarray(
        np.array([scene.halos[i].r200 for i in range(n_show)]),
        jnp.float32)
    has_subs = scene.sub_first < scene.nhalos
    counts = np.asarray(_census_counts(
        parts.pos, parts.halo, n_gas, centers, r200s,
        scene.sub_first if has_subs else -1))

    records = []
    for i in range(n_show):
        h = scene.halos[i]
        n_sph, n_dm, own_sph, own_dm = (int(c) for c in counts[i])
        m200 = n_sph * msph + n_dm * mdm
        # external budget vs the halo's OWN current membership (the
        # reference updates Halo[].Npart at reassignment,
        # positions.c:264-329, so these are live counts, not the plan)
        ext_gas = (own_sph - n_sph) * msph
        ext_dm = (own_dm - n_dm) * mdm
        rec = dict(halo=i, r200=h.r200, gas_mass_r200=n_sph * msph,
                   dm_mass_r200=n_dm * mdm, total_mass_r200=m200,
                   ext_gas_mass=ext_gas, ext_dm_mass=ext_dm,
                   bf_eff_r200=(n_sph * msph / (n_dm * mdm)
                                if n_dm else 0.0))
        records.append(rec)
        print(f"\nSampling of Halo <{i}> (r200 = {h.r200:g} kpc):\n"
              f"   Gas Mass in R200    = {rec['gas_mass_r200']:g} Msol \n"
              f"   DM Mass in R200     = {rec['dm_mass_r200']:g} Msol \n"
              f"   Total Mass in R200  = {m200:g} Msol \n"
              f"   External Gas Mass   = {ext_gas:g} Msol \n"
              f"   External DM  Mass   = {ext_dm:g} Msol \n"
              f"   Total External Mass = {ext_gas + ext_dm:g} Msol \n"
              f"   Effective bf in r200= {rec['bf_eff_r200']:g} ",
              file=sys.stderr, flush=True)
    if log is not None:
        log("mass_census", halos=[
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in r.items()} for r in records])
    return records
