"""Multi-chip sharding of the PRODUCTION block-sparse WVT iteration on the
virtual 8-device CPU mesh (conftest forces the CPU platform + 8 devices).

The sharded step (parallel/wvt_shard.py) must be numerically equivalent to
the same computation on a single device — pure particle data parallelism
where all_gather/psum/pmax replace the reference's shared memory and
OpenMP reductions (wvt_relax.c:73-124)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from toycluster import STOCK_PAR, parse_par_file
from toycluster.models import positions as pos_mod
from toycluster.parallel import wvt_shard
from toycluster.parallel.mesh import make_mesh
from toycluster.particles import halo_arrays_from_scene
from toycluster.scene import build_scene


@pytest.fixture(scope="module")
def small_scene():
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=6144, sph_kernel="m4")
    scene = build_scene(cfg)
    ha = halo_arrays_from_scene(scene)
    parts = pos_mod.make_positions(jax.random.PRNGKey(3), scene, ha)
    parts = pos_mod.shift_origin(parts, ha, scene.boxsize)
    return cfg, scene, ha, parts


def _run_step(ndev, cfg, scene, ha, parts):
    mesh = make_mesh(ndev)
    pos, n_real = wvt_shard.pad_for_mesh(parts.pos[:parts.n_gas], ndev)
    pos = wvt_shard.shard_array(mesh, pos)
    hsml = wvt_shard.shard_array(
        mesh, jnp.zeros((pos.shape[0],), jnp.float32))
    step_fn = wvt_shard.sharded_wvt_iteration(
        mesh, ha, n_real=n_real, boxsize=scene.boxsize,
        mpart=scene.mpart_gas, desnngb=cfg.desnngb,
        kernel=cfg.sph_kernel, max_cand=64)
    out = step_fn(pos, hsml, 0.035)
    assert int(out.cand_overflow) <= 0
    return n_real, out


def test_graft_entry_compiles():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    new_pos, rho = out
    assert new_pos.shape == args[0].shape
    assert bool(jax.numpy.isfinite(rho).all())


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
def test_dryrun_multichip():
    import __graft_entry__ as ge
    ge.dryrun_multichip(min(8, jax.device_count()))


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
def test_sharded_production_step_matches_single_device(small_scene):
    """rho, solved hsml, positions, and the psum/pmax error stats of the
    full production iteration agree across mesh sizes."""
    cfg, scene, ha, parts = small_scene
    n1, out1 = _run_step(1, cfg, scene, ha, parts)
    n8, out8 = _run_step(min(8, jax.device_count()), cfg, scene, ha,
                         parts)
    assert n1 == n8
    np.testing.assert_allclose(np.asarray(out1.rho[:n1]),
                               np.asarray(out8.rho[:n1]),
                               rtol=2e-4)
    np.testing.assert_allclose(np.asarray(out1.hsml[:n1]),
                               np.asarray(out8.hsml[:n1]), rtol=2e-4)
    np.testing.assert_allclose(np.asarray(out1.pos[:n1]),
                               np.asarray(out8.pos[:n1]),
                               rtol=1e-4, atol=1e-2)
    assert float(out1.err_mean) == pytest.approx(float(out8.err_mean),
                                                 rel=1e-3)
    assert float(out1.err_max) == pytest.approx(float(out8.err_max),
                                                rel=1e-3)


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
def test_sharded_step_solves_density_contract(small_scene):
    """The sharded solve must honour the SPH neighbour-number contract
    (sph.c:159-166): (4pi/3) h^3 rho / m ~ DESNNGB within the kernel-shape
    factor for the bulk of particles."""
    cfg, scene, ha, parts = small_scene
    n_real, out = _run_step(min(8, jax.device_count()), cfg, scene, ha,
                            parts)
    rho = np.asarray(out.rho[:n_real])
    h = np.asarray(out.hsml[:n_real])
    assert (rho > 0).all() and (h > 0).all()
    ngb_vol = 4.0 * np.pi / 3.0 * h ** 3 * rho / scene.mpart_gas
    frac = np.abs(ngb_vol / cfg.desnngb - 1.0)
    assert np.median(frac) < 0.2


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
def test_sharded_stream_engine_matches_xla(small_scene):
    """The production stream engine under shard_map (the GPU path, run
    here through the Pallas interpreter) must agree with the
    sharded XLA pair-operator engine — same candidate semantics as the
    single-chip equivalence tests, but across the all-gathered source
    layout (tree.c:25-111 gather semantics)."""
    cfg, scene, ha, parts = small_scene
    ndev = min(8, jax.device_count())
    mesh = make_mesh(ndev)
    pos, n_real = wvt_shard.pad_for_mesh(parts.pos[:parts.n_gas], ndev)
    pos = wvt_shard.shard_array(mesh, pos)
    hsml = wvt_shard.shard_array(
        mesh, jnp.zeros((pos.shape[0],), jnp.float32))

    outs = {}
    for engine in ("xla", "stream_interpret"):
        step_fn = wvt_shard.sharded_wvt_iteration(
            mesh, ha, n_real=n_real, boxsize=scene.boxsize,
            mpart=scene.mpart_gas, desnngb=cfg.desnngb,
            kernel=cfg.sph_kernel, max_cand=64, engine=engine)
        outs[engine] = step_fn(pos, hsml, 0.035)
        assert int(outs[engine].cand_overflow) <= 0

    a, b = outs["xla"], outs["stream_interpret"]
    np.testing.assert_allclose(np.asarray(a.rho[:n_real]),
                               np.asarray(b.rho[:n_real]), rtol=2e-4)
    np.testing.assert_allclose(np.asarray(a.hsml[:n_real]),
                               np.asarray(b.hsml[:n_real]), rtol=2e-4)
    np.testing.assert_allclose(np.asarray(a.pos[:n_real]),
                               np.asarray(b.pos[:n_real]),
                               rtol=1e-4, atol=1e-2)
    assert float(a.err_mean) == pytest.approx(float(b.err_mean),
                                              rel=1e-3)


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
def test_ring_halo_matches_gather(small_scene):
    """The ppermute ring halo exchange (O(N/D + boundary) per-chip
    source memory) must reproduce the all_gather source layout
    bit-for-bit: the kernel sees the same source superblocks, just
    relocated through the boundary buffer's slot map."""
    cfg, scene, ha, parts = small_scene
    ndev = min(8, jax.device_count())
    mesh = make_mesh(ndev)
    pos, n_real = wvt_shard.pad_for_mesh(parts.pos[:parts.n_gas], ndev)
    pos = wvt_shard.shard_array(mesh, pos)
    hsml = wvt_shard.shard_array(
        mesh, jnp.zeros((pos.shape[0],), jnp.float32))

    outs = {}
    for halo in ("gather", "ring"):
        step_fn = wvt_shard.sharded_wvt_iteration(
            mesh, ha, n_real=n_real, boxsize=scene.boxsize,
            mpart=scene.mpart_gas, desnngb=cfg.desnngb,
            kernel=cfg.sph_kernel, max_cand=64,
            engine="stream_interpret", halo=halo)
        outs[halo] = step_fn(pos, hsml, 0.035)
        assert int(outs[halo].cand_overflow) <= 0
    a, b = outs["gather"], outs["ring"]
    np.testing.assert_array_equal(np.asarray(a.rho[:n_real]),
                                  np.asarray(b.rho[:n_real]))
    np.testing.assert_array_equal(np.asarray(a.hsml[:n_real]),
                                  np.asarray(b.hsml[:n_real]))
    np.testing.assert_array_equal(np.asarray(a.pos[:n_real]),
                                  np.asarray(b.pos[:n_real]))


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
def test_ring_halo_overflow_is_reported(small_scene):
    """An undersized boundary buffer must be REPORTED via cand_overflow
    (the static-shape convention: report, never retry or silently
    truncate into wrong shapes)."""
    cfg, scene, ha, parts = small_scene
    ndev = min(8, jax.device_count())
    mesh = make_mesh(ndev)
    pos, n_real = wvt_shard.pad_for_mesh(parts.pos[:parts.n_gas], ndev)
    pos = wvt_shard.shard_array(mesh, pos)
    hsml = wvt_shard.shard_array(
        mesh, jnp.zeros((pos.shape[0],), jnp.float32))
    step_fn = wvt_shard.sharded_wvt_iteration(
        mesh, ha, n_real=n_real, boxsize=scene.boxsize,
        mpart=scene.mpart_gas, desnngb=cfg.desnngb,
        kernel=cfg.sph_kernel, max_cand=64,
        engine="stream_interpret", halo="ring", max_remote_sb=1)
    out = step_fn(pos, hsml, 0.035)
    # at this N every shard needs most other shards' superblocks; a
    # 1-superblock buffer cannot hold them
    assert int(out.cand_overflow) > 0


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
def test_regularise_sharded_converges(small_scene):
    """The full multi-chip relaxation loop drives the density error down
    (the reference's convergence oracle, wvt_relax.c:91-92)."""
    cfg, scene, ha, parts = small_scene
    mesh = make_mesh(min(8, jax.device_count()))
    errs = []

    def log(stage, **kw):
        if stage == "wvt_shard":
            errs.append(kw["err_mean"])

    pos, rho, hsml = wvt_shard.regularise_sharded(
        mesh, ha, parts.pos[:parts.n_gas], boxsize=scene.boxsize,
        mpart=scene.mpart_gas, desnngb=cfg.desnngb, kernel=cfg.sph_kernel,
        max_cand=64, step=0.035, max_iter=8, log=log)
    assert len(errs) >= 5
    assert errs[-1] < 0.7 * errs[0]
    assert np.isfinite(np.asarray(pos)).all()
    # production-tolerance contract on the CONVERGED sharded state: the
    # warm-started solve must hit the neighbour-volume count within the
    # kernel-shape factor (a real solver regression shows up here, not
    # in the loose single-cold-step median of the test above)
    ngb_vol = (4.0 * np.pi / 3.0 * np.asarray(hsml) ** 3
               * np.asarray(rho) / scene.mpart_gas)
    frac = np.abs(ngb_vol / cfg.desnngb - 1.0)
    assert np.median(frac) < 0.05


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
@pytest.mark.slow
def test_sharded_structure_reuse_equivalence(small_scene):
    """Sharded structure reuse (rebuild_every=4 under the drift budget)
    must track the rebuild-every-iteration loop to float32 pair-sum
    noise — the multi-chip analogue of test_rebuild_every_equivalence
    (tests/test_wvt.py)."""
    cfg, scene, ha, parts = small_scene
    mesh = make_mesh(min(8, jax.device_count()))

    def run(rebuild_every):
        errs = []

        def log(stage, **kw):
            if stage == "wvt_shard":
                errs.append(kw["err_mean"])

        pos, rho, _ = wvt_shard.regularise_sharded(
            mesh, ha, parts.pos[:parts.n_gas], boxsize=scene.boxsize,
            mpart=scene.mpart_gas, desnngb=cfg.desnngb,
            kernel=cfg.sph_kernel, max_cand=64, step=0.035, max_iter=6,
            log=log, rebuild_every=rebuild_every)
        return np.asarray(pos), np.asarray(rho), errs

    pos4, rho4, errs4 = run(4)
    pos1, rho1, errs1 = run(1)
    assert len(errs4) == len(errs1)
    np.testing.assert_allclose(errs4, errs1, rtol=2e-2)
    box = scene.boxsize
    d = np.abs(pos4 - pos1)
    d = np.minimum(d, box - d)  # periodic metric
    assert d.max() < 2e-3 * box
    np.testing.assert_allclose(rho4, rho1, rtol=2e-2)


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
@pytest.mark.slow
def test_sharded_checkpoint_resume(small_scene, tmp_path):
    """A sharded run interrupted mid-relaxation and resumed from its NPZ
    checkpoint must land where the uninterrupted run lands (the
    single-chip loop's checkpoint contract, models/wvt)."""
    cfg, scene, ha, parts = small_scene
    mesh = make_mesh(min(8, jax.device_count()))
    ck = str(tmp_path / "wvt_shard_ck.npz")

    def run(max_iter, checkpoint_path=None):
        errs = []

        def log(stage, **kw):
            if stage == "wvt_shard":
                errs.append((kw["it"], kw["err_mean"]))

        pos, _, _ = wvt_shard.regularise_sharded(
            mesh, ha, parts.pos[:parts.n_gas], boxsize=scene.boxsize,
            mpart=scene.mpart_gas, desnngb=cfg.desnngb,
            kernel=cfg.sph_kernel, max_cand=64, step=0.035,
            max_iter=max_iter, log=log,
            checkpoint_path=checkpoint_path, checkpoint_every=2)
        return np.asarray(pos), errs

    run(3, checkpoint_path=ck)               # writes it=1, it=3
    pos_res, errs_res = run(6, checkpoint_path=ck)   # resumes at it=4
    pos_ref, errs_ref = run(6)               # uninterrupted
    assert errs_res[0][0] == 4
    ref_tail = dict(errs_ref)
    for it, e in errs_res:
        assert e == pytest.approx(ref_tail[it], rel=2e-2)
    box = scene.boxsize
    d = np.abs(pos_res - pos_ref)
    d = np.minimum(d, box - d)
    assert d.max() < 2e-3 * box


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
@pytest.mark.slow
def test_make_ics_mesh_entry(small_scene, tmp_path):
    """make_ics(mesh=...) runs the WVT stage sharded over the mesh and
    the remaining stages single-chip — multi-chip as a PIPELINE
    capability, not just a library path."""
    from toycluster.pipeline import make_ics

    cfg, scene, ha, parts = small_scene
    cfg = cfg.replace(wvt_max_iter=4,
                      output_file=str(tmp_path / "mesh_ics"))
    mesh = make_mesh(min(8, jax.device_count()))
    logs = []

    def log(stage, **kw):
        logs.append(stage)

    scene2, parts2 = make_ics(cfg, log=log, mesh=mesh, write=True)
    assert "wvt_sharded" in logs
    n_gas = parts2.n_gas
    assert bool((parts2.rho[:n_gas] > 0).all())
    assert bool((parts2.u[:n_gas] > 0).all())
    assert np.isfinite(np.asarray(parts2.vel)).all()
    from toycluster.io.gadget import read_snapshot
    snap = read_snapshot(cfg.output_file)
    assert snap["header"].npart[0] == n_gas
    assert np.isfinite(snap["pos"]).all()


# ---------------------------------------------------------------------------
# Sharded pipeline stages beyond WVT (parallel/stages.py): standalone
# density, SPH curl, DM speed sampling — each must match the 1-device
# result (mesh-size independence).
# ---------------------------------------------------------------------------

@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
def test_sharded_density_matches_single_device(small_scene):
    from toycluster.parallel import stages
    cfg, scene, ha, parts = small_scene
    pos = parts.pos[:parts.n_gas]
    kw = dict(boxsize=scene.boxsize, mpart=scene.mpart_gas,
              desnngb=cfg.desnngb, kernel=cfg.sph_kernel, max_cand=64)
    r1 = stages.sharded_density(make_mesh(1), ha, pos, **kw)
    r8 = stages.sharded_density(make_mesh(min(8, jax.device_count())),
                                ha, pos, **kw)
    for a, b in zip(r1, r8):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4)
    # contract sanity: the solve hit the neighbour window
    wk = np.asarray(r8[3])
    assert np.median(np.abs(wk - cfg.desnngb)) < 1.0


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
def test_sharded_curl_matches_single_device(small_scene):
    from toycluster.parallel import stages
    cfg, scene, ha, parts = small_scene
    n_gas = parts.n_gas
    pos = parts.pos[:n_gas]
    mesh8 = make_mesh(min(8, jax.device_count()))
    rho, hsml, vf, _ = stages.sharded_density(
        mesh8, ha, pos, boxsize=scene.boxsize, mpart=scene.mpart_gas,
        desnngb=cfg.desnngb, kernel=cfg.sph_kernel, max_cand=64)
    # synthetic but smooth vector potential
    apot = jnp.stack([jnp.sin(pos[:, 0] / scene.boxsize * 6.0),
                      jnp.cos(pos[:, 1] / scene.boxsize * 6.0),
                      pos[:, 2] / scene.boxsize], axis=1)
    kw = dict(boxsize=scene.boxsize, mpart=scene.mpart_gas,
              kernel=cfg.sph_kernel, max_cand=64)
    b1, m1 = stages.sharded_curl(make_mesh(1), pos, hsml, rho, vf,
                                 apot, **kw)
    b8, m8 = stages.sharded_curl(mesh8, pos, hsml, rho, vf, apot, **kw)
    np.testing.assert_allclose(np.asarray(b1), np.asarray(b8),
                               rtol=3e-4, atol=1e-8)
    np.testing.assert_allclose(float(m1), float(m8), rtol=3e-4)
    assert float(m8) > 0


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
def test_sharded_dm_speeds_match_single_device(small_scene):
    from toycluster.models import velocities as vel_mod
    from toycluster.parallel import stages
    cfg, scene, ha, parts = small_scene
    n_gas = parts.n_gas
    d = parts.pos[n_gas:] - (ha.d_com[0] + scene.boxhalf)
    r = jnp.linalg.norm(d, axis=-1)
    vt = vel_mod.build_velocity_tables(scene, 0)
    key = jax.random.PRNGKey(11)
    v1 = stages.sharded_dm_speeds(make_mesh(1), vt, r, key=key)
    v8 = stages.sharded_dm_speeds(make_mesh(min(8, jax.device_count())),
                                  vt, r, key=key)
    # counter-based per-particle keys: BIT-identical across mesh sizes
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v8))
    psi = np.asarray(vel_mod.potential_device(vt, jnp.maximum(r, 0.1)))
    v = np.asarray(v8)
    assert (v <= np.sqrt(2 * psi) * (1 + 1e-5)).all()
    assert (v > 0).mean() > 0.999


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
def test_sharded_dm_velocities_mesh_invariant(small_scene):
    from toycluster.models import velocities as vel_mod
    from toycluster.parallel import stages
    cfg, scene, ha, parts = small_scene
    n_gas = parts.n_gas
    d = parts.pos[n_gas:] - (ha.d_com[0] + scene.boxhalf)
    r = jnp.linalg.norm(d, axis=-1)
    vt = vel_mod.build_velocity_tables(scene, 0)
    key = jax.random.PRNGKey(13)
    bulk = jnp.asarray([120.0, -40.0, 7.0], jnp.float32)
    v1 = stages.sharded_dm_velocities(make_mesh(1), vt, r, key=key,
                                      bulk_vel=bulk)
    v8 = stages.sharded_dm_velocities(
        make_mesh(min(8, jax.device_count())), vt, r, key=key,
        bulk_vel=bulk)
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v8))
    # speeds bounded by the escape speed around the bulk frame
    psi = np.asarray(vel_mod.potential_device(vt, jnp.maximum(r, 0.1)))
    sp = np.linalg.norm(np.asarray(v8) - np.asarray(bulk), axis=-1)
    assert (sp <= np.sqrt(2 * psi) * (1 + 1e-5)).all()
    # isotropy: mean peculiar direction ~ 0
    pec = np.asarray(v8) - np.asarray(bulk)
    nz = sp > 0
    mean_dir = (pec[nz] / sp[nz, None]).mean(axis=0)
    assert np.abs(mean_dir).max() < 0.05


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
def test_sharded_gas_bulk_matches_single_chip(small_scene):
    from toycluster.models.velocities import _gas_bulk_jit
    from toycluster.parallel import stages
    cfg, scene, ha, parts = small_scene
    n_gas = parts.n_gas
    bulk_stack = jnp.asarray(
        np.stack([h.bulk_vel for h in scene.halos]), jnp.float32)
    bulk_stack = bulk_stack + 55.0  # make the add observable
    sub_hh = jnp.asarray([h.r_sample_gas * 1.1 for h in scene.halos],
                         jnp.float32)
    args = dict(sub_first=scene.sub_first, n_halos=scene.nhalos,
                boxhalf=scene.boxhalf)
    dv1 = stages.sharded_gas_bulk(
        make_mesh(1), parts.pos[:n_gas], parts.halo[:n_gas],
        bulk_stack, ha.d_com, sub_hh, **args)
    dv8 = stages.sharded_gas_bulk(
        make_mesh(min(8, jax.device_count())), parts.pos[:n_gas],
        parts.halo[:n_gas], bulk_stack, ha.d_com, sub_hh, **args)
    np.testing.assert_array_equal(np.asarray(dv1), np.asarray(dv8))
    ref = _gas_bulk_jit(parts.pos[:n_gas], parts.halo[:n_gas],
                        bulk_stack, ha.d_com, sub_hh, scene.sub_first,
                        scene.nhalos, scene.boxhalf)
    np.testing.assert_array_equal(np.asarray(dv8), np.asarray(ref))


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
def test_sharded_temperature_matches_single_device(small_scene):
    from toycluster.models import temperature as temp_mod
    from toycluster.parallel import stages
    cfg, scene, ha, parts = small_scene
    n_gas = parts.n_gas
    tables = temp_mod.build_energy_tables_stacked(scene)
    d_com = jnp.asarray(np.stack([h.d_com for h in scene.halos]),
                        jnp.float32)
    pos, halo = parts.pos[:n_gas], parts.halo[:n_gas]
    u1 = stages.sharded_temperature(make_mesh(1), tables, d_com, pos,
                                    halo, boxhalf=scene.boxhalf)
    u8 = stages.sharded_temperature(
        make_mesh(min(8, jax.device_count())), tables, d_com, pos, halo,
        boxhalf=scene.boxhalf)
    # pure elementwise gather-eval: BIT-identical across mesh sizes
    np.testing.assert_array_equal(np.asarray(u1), np.asarray(u8))
    # and identical to the single-chip pipeline stage itself
    u_pipe = temp_mod.make_temperatures(scene, parts).u
    np.testing.assert_array_equal(np.asarray(u8), np.asarray(u_pipe))
    assert (np.asarray(u8) > 0).all()


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
def test_sharded_halo_sample_mesh_invariant(small_scene):
    from toycluster.parallel import stages
    cfg, scene, ha, parts = small_scene
    key = jax.random.PRNGKey(21)
    n = 4096
    kw = dict(boxsize=scene.boxsize, key=key,
              sub_first=scene.sub_first, cool_core=None)
    p1g = stages.sharded_halo_sample(make_mesh(1), ha, 0, n, "gas", **kw)
    p8g = stages.sharded_halo_sample(
        make_mesh(min(8, jax.device_count())), ha, 0, n, "gas", **kw)
    # fixed lane grid + counter-based per-lane keys: BIT-identical
    np.testing.assert_array_equal(np.asarray(p1g), np.asarray(p8g))
    p8d = stages.sharded_halo_sample(
        make_mesh(min(8, jax.device_count())), ha, 0, n, "dm", **kw)
    p1d = stages.sharded_halo_sample(make_mesh(1), ha, 0, n, "dm", **kw)
    np.testing.assert_array_equal(np.asarray(p1d), np.asarray(p8d))
    # support bounds
    assert (np.abs(np.asarray(p8g)) <= scene.boxsize / 2 + 1e-3).all()
    r_dm = np.linalg.norm(np.asarray(p8d), axis=-1)
    assert (r_dm <= float(ha.r_sample_dm[0]) * 1.001).all()


@pytest.mark.skipif(jax.device_count() < 2,
                    reason="needs multiple (virtual) devices")
def test_sharded_halo_sample_matches_sequential_distribution(small_scene):
    from scipy import stats
    from toycluster.parallel import stages
    cfg, scene, ha, parts = small_scene
    n = 8192
    mesh = make_mesh(min(8, jax.device_count()))
    p_sh = stages.sharded_halo_sample(
        mesh, ha, 0, n, "gas", boxsize=scene.boxsize,
        key=jax.random.PRNGKey(2), sub_first=scene.sub_first,
        cool_core=None)
    p_sq, acc = pos_mod.sample_halo_gas(
        jax.random.PRNGKey(3), ha, jnp.int32(0), n, scene.boxsize)
    r_sh = np.linalg.norm(np.asarray(p_sh), axis=-1)
    r_sq = np.linalg.norm(np.asarray(p_sq), axis=-1)
    d, p = stats.ks_2samp(r_sh, r_sq)
    assert p > 0.01, f"KS D={d:.4f} p={p:.4g}"
