"""Block-sparse neighbour engine vs O(N^2) brute force (the reference's own
validation pattern: Find_ngb_simple as drop-in for the tree,
wvt_relax.c:134)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from toycluster import STOCK_PAR, constants as const
from toycluster.ops import blocks as blk
from toycluster.ops import brute, pair_ops
from toycluster.ops.keys import morton_keys


BOX = 1000.0
N = 3000
DESNNGB = 64  # small-N test target (contract identical to 295 at scale)


@pytest.fixture(scope="module")
def cloud():
    """Centrally concentrated point cloud (plummer-ish) in a periodic box —
    exercises the multi-scale hsml range."""
    rng = np.random.default_rng(42)
    r = 80.0 * (rng.random(N) ** 2 / (1 - rng.random(N) * 0.7))
    r = np.clip(r, 0, 420.0)
    u = rng.normal(size=(N, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = (BOX / 2 + r[:, None] * u).astype(np.float32)
    return jnp.asarray(pos % BOX)


def _h0(pos):
    # crude local-scale guess from radius
    c = jnp.asarray([BOX / 2] * 3)
    r = jnp.linalg.norm(pos - c, axis=-1)
    return jnp.clip(8.0 + r * 0.15, 8.0, 80.0).astype(jnp.float32)


@pytest.fixture(scope="module")
def solved(cloud):
    """Solve with the production saturation-retry loop: enlarge the
    candidate cap for particles that want h beyond it (sph.c:36-64
    analogue)."""
    pos = cloud
    h0 = _h0(pos)
    bi = blk.build_blocks(pos, BOX)

    def pad(x):
        xs = x[bi.order]
        padn = bi.n_padded - xs.shape[0]
        return jnp.concatenate([xs, jnp.broadcast_to(xs[-1:], (padn,))])

    h0s = pad(h0)
    cap_factor = 3.0
    for _ in range(5):
        h_cap = h0s * cap_factor
        radius = h_cap.reshape(bi.n_blocks, blk.BLOCK).max(axis=1)
        cand = blk.find_candidates(bi, radius, BOX, max_cand=64)
        assert int(cand.overflow) <= 0
        sel = pair_ops.full_selection(bi, cand.idx)
        res = pair_ops.solve_density(bi, sel, h0s, h_cap, 1.0, BOX,
                                     kernel="wc6", desnngb=DESNNGB)
        if int(res.saturated[:N].sum()) == 0:
            break
        h0s = res.hsml
        cap_factor = 2.0
    return bi, cand, res, pad


def test_morton_keys_locality(cloud):
    keys = morton_keys(cloud, BOX)
    order = jnp.argsort(keys)
    sorted_pos = np.asarray(cloud)[np.asarray(order)]
    # successive particles along the curve are spatially close on median
    d = np.linalg.norm(np.diff(sorted_pos, axis=0), axis=1)
    assert np.median(d) < 30.0


def test_density_matches_brute_force(cloud, solved):
    bi, cand, res, pad = solved
    rho_b, h_b, vf_b, wk_b, done_b = brute.brute_density(
        cloud, _h0(cloud), 1.0, BOX, kernel="wc6", desnngb=DESNNGB)
    n = N
    # map block results (sorted layout) back to original order
    inv = np.asarray(bi.order)
    rho_blk = np.zeros(n, np.float32)
    h_blk = np.zeros(n, np.float32)
    wk_blk = np.zeros(n, np.float32)
    rho_blk[inv] = np.asarray(res.rho[:n])
    h_blk[inv] = np.asarray(res.hsml[:n])
    wk_blk[inv] = np.asarray(res.wk_ngb[:n])

    done_frac = float(np.asarray(res.done[:n]).mean())
    assert done_frac > 0.999
    # the neighbour-number contract (sph.c:159-166)
    ok = np.asarray(res.done[:n])
    inv_ok = np.zeros(n, bool)
    inv_ok[inv] = ok
    assert np.abs(wk_blk[inv_ok] - DESNNGB).max() < const.NNGBDEV + 1e-3
    # block engine == brute force where both converged
    both = inv_ok & np.asarray(done_b)
    assert both.mean() > 0.99
    np.testing.assert_allclose(h_blk[both], np.asarray(h_b)[both],
                               rtol=2e-3)
    np.testing.assert_allclose(rho_blk[both], np.asarray(rho_b)[both],
                               rtol=2e-3)


def test_displacement_matches_brute_force(cloud, solved):
    bi, cand, res, pad = solved
    # metric hsml in box units
    h_box = _h0(cloud) / BOX * 1.2
    d_brute = brute.brute_wvt_displacement(cloud, h_box, 0.01, BOX)
    h_sorted = pad(h_box)
    radius = (h_sorted.reshape(bi.n_blocks, blk.BLOCK).max(axis=1) * BOX)
    cand_s = blk.find_candidates(bi, radius, BOX, max_cand=64,
                                 symmetric=True)
    assert int(cand_s.overflow) <= 0
    d_blk_sorted = pair_ops.wvt_displacement(
        bi, pair_ops.full_selection(bi, cand_s.idx), h_sorted, 0.01, BOX)
    d_blk = np.zeros((N, 3), np.float32)
    d_blk[np.asarray(bi.order)] = np.asarray(d_blk_sorted[:N])
    np.testing.assert_allclose(d_blk, np.asarray(d_brute), rtol=1e-3,
                               atol=1e-9)


def test_curl_matches_brute_force(cloud, solved):
    bi, cand, res, pad = solved
    n = N
    rng = np.random.default_rng(1)
    apot_orig = jnp.asarray(rng.random((n, 3)), jnp.float32)
    inv = np.asarray(bi.order)
    # sorted-layout inputs
    apot_sorted = jnp.concatenate(
        [apot_orig[bi.order],
         jnp.zeros((bi.n_padded - n, 3), jnp.float32)])
    b_sorted = pair_ops.sph_curl(bi, pair_ops.full_selection(bi, cand.idx),
                                 res.hsml, res.rho, res.var_hsml_fac,
                                 apot_sorted, 1.0, BOX)
    b_blk = np.zeros((n, 3), np.float32)
    b_blk[inv] = np.asarray(b_sorted[:n])

    rho_o = np.zeros(n, np.float32)
    h_o = np.zeros(n, np.float32)
    vf_o = np.zeros(n, np.float32)
    rho_o[inv] = np.asarray(res.rho[:n])
    h_o[inv] = np.asarray(res.hsml[:n])
    vf_o[inv] = np.asarray(res.var_hsml_fac[:n])
    b_brute = brute.brute_curl(cloud, jnp.asarray(h_o), jnp.asarray(rho_o),
                               jnp.asarray(vf_o), apot_orig, 1.0, BOX)
    scale = np.abs(np.asarray(b_brute)).max()
    np.testing.assert_allclose(b_blk, np.asarray(b_brute), rtol=5e-3,
                               atol=1e-4 * scale)


def test_superblock_curl_matches_brute_force(cloud, solved, monkeypatch):
    """The B-field stage's superblock curl path (the stream kernel over
    superblock lists, which never materialises a block-granular
    candidate table; interpret mode here) must agree with brute-force
    direct summation (sph.c:216-300)."""
    from types import SimpleNamespace
    from toycluster.models import bfield, sph as sph_mod
    bi, cand, res, pad = solved
    n = N
    inv = np.asarray(bi.order)
    rng = np.random.default_rng(1)
    apot_orig = jnp.asarray(rng.random((n, 3)), jnp.float32)
    rho_o = np.zeros(n, np.float32)
    h_o = np.zeros(n, np.float32)
    vf_o = np.zeros(n, np.float32)
    rho_o[inv] = np.asarray(res.rho[:n])
    h_o[inv] = np.asarray(res.hsml[:n])
    vf_o[inv] = np.asarray(res.var_hsml_fac[:n])

    state = sph_mod._build_neighbours_sb(cloud, jnp.asarray(h_o), BOX)
    assert state.sb
    scene = SimpleNamespace(mpart_gas=1.0, boxsize=BOX,
                            config=SimpleNamespace(sph_kernel="wc6"))
    parts = SimpleNamespace(n_gas=n, pos=cloud, hsml=jnp.asarray(h_o),
                            rho=jnp.asarray(rho_o),
                            var_hsml_fac=jnp.asarray(vf_o),
                            apot=apot_orig)
    b_sb = np.asarray(bfield._curl_stream(scene, parts, state,
                                          interpret=True))

    b_brute = brute.brute_curl(cloud, jnp.asarray(h_o), jnp.asarray(rho_o),
                               jnp.asarray(vf_o), apot_orig, 1.0, BOX)
    scale = np.abs(np.asarray(b_brute)).max()
    np.testing.assert_allclose(b_sb, np.asarray(b_brute), rtol=5e-3,
                               atol=1e-4 * scale)


@pytest.mark.slow
def test_corner_lanes_grow_past_box_third():
    """Tiny-N periodic corner lanes need h beyond boxsize/3 to collect
    DESNNGB neighbours across the wrap — the reference's grow loop is
    unbounded (sph.c:36-64), so the contract must still close there.
    Regression: the old global boxsize/3 escape hatch left 0.9% of
    config-1 (32^3) lanes 100+ neighbours short.
    """
    from toycluster import parse_par_file
    from toycluster.models import positions as pos_mod
    from toycluster.models import sph as sph_mod
    from toycluster.particles import halo_arrays_from_scene
    from toycluster.scene import build_scene

    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=8000, sph_kernel="m4")
    scene = build_scene(cfg)
    ha = halo_arrays_from_scene(scene)
    parts = pos_mod.make_positions(jax.random.PRNGKey(11), scene, ha)
    parts = pos_mod.shift_origin(parts, ha, scene.boxsize)
    parts = sph_mod.find_sph_quantities(scene, ha, parts)

    h = np.asarray(parts.hsml[:parts.n_gas])
    rho = np.asarray(parts.rho[:parts.n_gas])
    wk = const.FOURPITHIRD * h ** 3 * rho / scene.mpart_gas
    dev = np.abs(wk - cfg.desnngb)
    # adaptive cap must be in play (lanes genuinely past box/3)...
    assert (h > scene.boxsize / 3.0).sum() > 0
    assert h.max() < 0.5 * scene.boxsize  # min-image validity limit
    # ...and the contract must close for every lane (m4 has no bias
    # correction, so wk here is the solver's own convergence target)
    assert (dev < const.NNGBDEV + 1e-3).mean() >= 0.999


def test_hard_h_cap_thresholds():
    from toycluster.models.sph import _SB_WIDTH_CAP, hard_h_cap

    box = 1000.0
    # whole domain within one candidate row -> min-image limit
    assert hard_h_cap(box, 4000) == pytest.approx(0.49 * box)
    n_small = _SB_WIDTH_CAP * blk.BLOCK * blk.SUPER
    assert hard_h_cap(box, n_small) == pytest.approx(0.49 * box)
    # beyond it -> the box/3 escape hatch (all-to-all unaffordable)
    assert hard_h_cap(box, n_small + blk.BLOCK * blk.SUPER) \
        == pytest.approx(box / 3.0)


def test_two_pass_candidates_exact():
    """The probe-then-fallback candidate search (blocks.py
    find_candidates_super, max_cand > _K_PROBE) must return exactly the
    single-pass result: same ids, order, counts, overflow."""
    import jax

    rng = np.random.default_rng(4)
    n = 400_000   # ~390 superblocks: rows can exceed the probe width
    box = 1000.0
    # clustered cloud: a dense core so a few rows genuinely exceed the
    # probe width while most stay far below it
    core = rng.normal(500.0, 20.0, size=(n // 2, 3))
    rest = rng.uniform(0.0, box, size=(n - n // 2, 3))
    pos = jnp.asarray(np.clip(np.concatenate([core, rest]), 0.0,
                              box - 1e-3), jnp.float32)
    bi = blk.build_blocks(pos, box)
    nb = bi.n_blocks
    radius = jnp.full((nb,), 40.0, jnp.float32)
    # oversized reach on a few receivers: forces their counts past the
    # probe width
    radius = radius.at[:3].set(700.0)
    sym = jnp.zeros((nb,), jnp.float32)
    rec = jnp.arange(nb, dtype=jnp.int32)

    two = blk.find_candidates_super(bi, rec, radius, sym, box,
                                    max_cand=512)
    ref = blk._find_candidates_super_k(bi, rec, radius, sym, box,
                                       max_cand=512)
    assert int(two.count.max()) > blk._K_PROBE  # fallback engaged
    np.testing.assert_array_equal(np.asarray(two.idx),
                                  np.asarray(ref.idx))
    np.testing.assert_array_equal(np.asarray(two.count),
                                  np.asarray(ref.count))
    assert int(two.overflow) == int(ref.overflow)
