"""WVT relaxation: error-vs-iteration must fall and the SPH density field
must approach the analytic model (the reference's printed per-iteration
error stats are its convergence oracle, wvt_relax.c:91-92)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from toycluster import STOCK_PAR, parse_par_file
from toycluster.models import positions as pos_mod
from toycluster.models import sph as sph_mod
from toycluster.models import wvt
from toycluster.particles import halo_arrays_from_scene
from toycluster.scene import build_scene
from toycluster.utils.logging import silent_log


@pytest.fixture(scope="module")
def relaxed():
    # the M4/cubic-spline variant (DESNNGB=50) resolves convergence at
    # test-scale particle counts; WC6's 295-neighbour contract needs the
    # production N ~ 1e6 (covered by bench.py)
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=8000, wvt_max_iter=12, sph_kernel="m4")
    scene = build_scene(cfg)
    ha = halo_arrays_from_scene(scene)
    key = jax.random.PRNGKey(11)
    parts = pos_mod.make_positions(key, scene, ha)
    parts = pos_mod.shift_origin(parts, ha, scene.boxsize)

    errs = []

    def log(stage, **kw):
        if stage == "wvt":
            errs.append(kw["err_mean"])

    parts = wvt.regularise_sph_particles(scene, ha, parts, log=log)
    return scene, ha, parts, errs


@pytest.mark.slow
def test_error_decreases(relaxed):
    scene, ha, parts, errs = relaxed
    assert len(errs) >= 5
    # mean relative density error must drop substantially from the raw
    # sampling (first iteration) to the relaxed state...
    assert errs[-1] < 0.5 * errs[0]
    # ...and stay at the converged floor without diverging again
    assert errs[-1] <= 1.05 * min(errs)


@pytest.mark.slow
def test_neighbour_contract_after_relaxation(relaxed):
    scene, ha, parts, errs = relaxed
    parts2 = sph_mod.find_sph_quantities(scene, ha, parts)
    rho = np.asarray(parts2.rho)
    hsml = np.asarray(parts2.hsml)
    assert (rho > 0).all() and (hsml > 0).all()
    assert np.isfinite(hsml).all()
    # the solved state satisfies (4pi/3) h^3 rho / m ~ DESNNGB — the
    # kernel-weighted contract |wkNgb-DESNNGB|<0.05 implies this volume
    # count matches within the kernel-shape/bias factor (a few per cent)
    wk_est = 4.18879032135 * hsml**3 * rho / scene.mpart_gas
    assert abs(np.median(wk_est) / scene.config.desnngb - 1) < 0.1


@pytest.mark.slow
def test_density_tracks_model(relaxed):
    scene, ha, parts, errs = relaxed
    pos = parts.pos[: parts.n_gas]
    rho_model = sph_mod.global_density_model(pos, ha, scene.boxsize)
    err = np.abs(np.asarray(parts.rho) - np.asarray(rho_model)) \
        / np.asarray(rho_model)
    # after 12 iterations at this resolution the bulk should be within ~15%
    assert np.median(err) < 0.15


@pytest.mark.slow
def test_rebuild_every_equivalence(monkeypatch):
    """Structure reuse (REBUILD_EVERY=8) with the enforced drift budget
    must track the rebuild-every-iteration reference behavior
    (wvt_relax.c:6) to float32 pair-sum noise — a regression here means
    displacement pairs are being truncated between rebuilds."""
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=8000, wvt_max_iter=9, sph_kernel="m4")
    scene = build_scene(cfg)
    ha = halo_arrays_from_scene(scene)

    def run(rebuild_every):
        monkeypatch.setattr(wvt, "REBUILD_EVERY", rebuild_every)
        key = jax.random.PRNGKey(11)
        parts = pos_mod.make_positions(key, scene, ha)
        parts = pos_mod.shift_origin(parts, ha, scene.boxsize)
        # real per-particle ids BEFORE the relaxation: the loop re-sorts
        # by Hilbert key at every rebuild, and the two runs rebuild at
        # different cadences — matching final states by SLOT (the
        # pipeline assigns pids only after WVT) compares different
        # particles
        n_gas = parts.n_gas
        parts = parts._replace(pid=parts.pid.at[:n_gas].set(
            jnp.arange(1, n_gas + 1, dtype=parts.pid.dtype)))
        errs = []

        def log(stage, **kw):
            if stage == "wvt":
                errs.append(kw["err_mean"])

        parts = wvt.regularise_sph_particles(scene, ha, parts, log=log)
        n_gas = parts.n_gas
        order = np.argsort(np.asarray(parts.pid[:n_gas]))
        return (np.asarray(parts.pos[:n_gas])[order],
                np.asarray(parts.rho)[order], errs)

    pos8, rho8, errs8 = run(8)
    pos1, rho1, errs1 = run(1)

    # error trajectories must agree closely (same physics, different
    # summation orders)
    assert len(errs8) == len(errs1)
    np.testing.assert_allclose(errs8, errs1, rtol=2e-2)
    # pid-matched final state: float32 pair-sum noise only
    box = scene.boxsize
    d = np.abs(pos8 - pos1)
    d = np.minimum(d, box - d)   # periodic metric
    assert d.max() < 2e-3 * box
    np.testing.assert_allclose(rho8, rho1, rtol=2e-2)


def test_wvt_large_path_inkernel_bits_wiring(monkeypatch):
    """The LARGE-N slab iteration (_make_large_iter_fn, forced by
    shrinking _LARGE_N) through the stream kernel (interpret mode) must
    reproduce the single-program stream iteration exactly: per-slab
    skip bits without buckets or list compaction gate the same
    exact-zero tiles."""
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=3000, wvt_max_iter=2, sph_kernel="m4")
    scene = build_scene(cfg)
    ha = halo_arrays_from_scene(scene)
    key = jax.random.PRNGKey(5)
    parts0 = pos_mod.make_positions(key, scene, ha)
    parts0 = pos_mod.shift_origin(parts0, ha, scene.boxsize)

    def run(large_n):
        monkeypatch.setattr(wvt, "_LARGE_N", large_n)
        return wvt.regularise_sph_particles(scene, ha, parts0,
                                            log=silent_log,
                                            engine="stream_interpret")

    ref = run(10**9)
    new = run(1000)
    np.testing.assert_array_equal(np.asarray(ref.pos),
                                  np.asarray(new.pos))
    np.testing.assert_array_equal(np.asarray(ref.rho),
                                  np.asarray(new.rho))
    np.testing.assert_array_equal(np.asarray(ref.hsml),
                                  np.asarray(new.hsml))


def test_find_sph_quantities_inkernel_bits_wiring(monkeypatch):
    """The standalone density pass (find_sph_quantities, sph.c:13-75)
    through the stream kernel (interpret mode): chunk-refined and
    block-bbox skip bits gate only exact-zero tiles, so both give the
    same densities exactly — and they match the XLA engine to solver
    tolerance."""
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=3000, sph_kernel="m4")
    scene = build_scene(cfg)
    ha = halo_arrays_from_scene(scene)
    key = jax.random.PRNGKey(9)
    parts0 = pos_mod.make_positions(key, scene, ha)
    parts0 = pos_mod.shift_origin(parts0, ha, scene.boxsize)

    def run(chunk_bits, engine="stream_interpret"):
        monkeypatch.setattr(sph_mod, "_CHUNK_BITS", chunk_bits)
        return sph_mod.find_sph_quantities(scene, ha, parts0,
                                           engine=engine)

    ref = run(False)
    new = run(True)
    np.testing.assert_array_equal(np.asarray(ref.rho),
                                  np.asarray(new.rho))
    np.testing.assert_array_equal(np.asarray(ref.hsml),
                                  np.asarray(new.hsml))
    xla = run(True, engine="xla")
    n = new.n_gas
    by_pid = [np.argsort(np.asarray(p.pid[:n])) for p in (new, xla)]
    rho_s, rho_x = (np.asarray(p.rho)[o] for p, o in zip((new, xla),
                                                           by_pid))
    assert np.isclose(rho_s, rho_x, rtol=2e-3).mean() > 0.98


@pytest.mark.slow
def test_offload_path_equivalence(monkeypatch):
    """The large-N device-memory offload (pid/halo parked on host, DM pos split,
    zero gas fields dropped) must reproduce the default path exactly:
    same positions, densities, ids and halo membership after the
    relaxation, whether parts arrive plain or via the holder list."""
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=6000, wvt_max_iter=4, sph_kernel="m4")
    scene = build_scene(cfg)
    ha = halo_arrays_from_scene(scene)
    key = jax.random.PRNGKey(23)
    parts0 = pos_mod.make_positions(key, scene, ha)
    parts0 = pos_mod.shift_origin(parts0, ha, scene.boxsize)

    def run(offload_n):
        monkeypatch.setenv("TOYCLUSTER_WVT_OFFLOAD_N", str(offload_n))
        return wvt.regularise_sph_particles(
            scene, ha, [parts0], log=silent_log)

    ref = run(10**9)   # threshold never reached: default path
    new = run(1)       # force the offload path
    for field in ("pos", "pid", "halo", "rho", "hsml", "var_hsml_fac",
                  "rho_model", "u"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, field)),
            np.asarray(getattr(new, field)), err_msg=field)
    assert new.n_gas == ref.n_gas and new.n_total == ref.n_total
