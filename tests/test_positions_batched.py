"""Batched subhalo position sampling: one vmapped program + one host
sync per round for the whole subhalo population must draw from the same
per-halo conditional distribution as the sequential per-halo engine
(positions.c:25-133)."""

import jax
import numpy as np
import pytest
from scipy import stats

from toycluster import STOCK_PAR, parse_par_file
from toycluster.models import positions as pos_mod
from toycluster.particles import halo_arrays_from_scene
from toycluster.scene import build_scene


@pytest.fixture(scope="module")
def sub_scene():
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=60000, mass_ratio=1.0 / 3.0, substructure=True,
        sph_kernel="m4")
    scene = build_scene(cfg)
    from toycluster.models.substructure import setup_substructure
    scene = setup_substructure(scene, seed=11)
    return scene, halo_arrays_from_scene(scene)


def test_size_classes_bounded_ratio():
    ns = np.array([1000, 1200, 9000, 64, 80, 70000])
    classes = pos_mod._size_classes(ns, max_ratio=8)
    covered = np.concatenate(classes)
    assert sorted(covered.tolist()) == list(range(len(ns)))
    for cls in classes:
        assert ns[cls].max() <= 8 * ns[cls].min()


def test_batched_fill_counts_and_support(sub_scene):
    scene, ha = sub_scene
    assert scene.nhalos > scene.sub_first + 3, "need several subhalos"
    idxs = [i for i in range(scene.sub_first, scene.nhalos)
            if scene.halos[i].npart_dm]
    ns = [scene.halos[i].npart_dm for i in idxs]
    res = pos_mod._batched_fill(jax.random.PRNGKey(2), ha, idxs, ns,
                                "dm", scene.boxsize,
                                sub_first=scene.sub_first)
    assert set(res) == set(idxs)
    for i, n in zip(idxs, ns):
        pos, acc = res[i]
        assert pos.shape == (n, 3)
        assert bool(acc.all()), f"subhalo {i} under-filled"
        r = np.linalg.norm(np.asarray(pos), axis=-1)
        assert (r <= ha.r_sample_dm[i] * 1.001).all()


def test_batched_matches_sequential_distribution(sub_scene):
    """KS per halo: batched vs sequential draws of the same subhalo's
    radial law (the two engines share the acceptance predicate, so the
    conditional distributions must agree)."""
    scene, ha = sub_scene
    # the most populated subhalo gives the tightest KS
    subs = [(scene.halos[i].npart_dm, i)
            for i in range(scene.sub_first, scene.nhalos)]
    n_big, i_big = max(subs)
    n = max(2000, n_big)
    res = pos_mod._batched_fill(jax.random.PRNGKey(5), ha, [i_big], [n],
                                "dm", scene.boxsize,
                                sub_first=scene.sub_first)
    r_b = np.linalg.norm(np.asarray(res[i_big][0]), axis=-1)
    pos_s, acc = pos_mod.sample_halo_dm(
        jax.random.PRNGKey(6), ha, i_big, n, scene.sub_first,
        scene.boxsize)
    r_s = np.linalg.norm(np.asarray(pos_s), axis=-1)
    d, p = stats.ks_2samp(r_b, r_s)
    assert p > 0.01, f"KS D={d:.4f} p={p:.4g}"


def test_make_positions_uses_batch_and_orders_by_halo(sub_scene):
    scene, ha = sub_scene
    parts = pos_mod.make_positions(jax.random.PRNGKey(9), scene, ha)
    halo = np.asarray(parts.halo)
    n_gas = scene.npart_gas
    # gas block then DM block, each grouped by halo in index order
    assert (np.diff(halo[:n_gas]) >= 0).all()
    assert (np.diff(halo[n_gas:]) >= 0).all()
    for i, h in enumerate(scene.halos):
        assert (halo[:n_gas] == i).sum() == h.npart_gas
        assert (halo[n_gas:] == i).sum() == h.npart_dm
    # every subhalo's centred sample lies within its sampling radius
    for i in range(scene.sub_first, scene.nhalos):
        sel = (halo == i) & (np.arange(scene.ntotal) >= n_gas)
        if sel.any():
            r = np.linalg.norm(np.asarray(parts.pos)[sel], axis=-1)
            assert (r <= ha.r_sample_dm[i] * 1.001).all()
