"""Final snapshot particle-order parity with the reference.

The reference writes the gas block resorted by owner halo id after the
post-relaxation reassignment (positions.c:285, positions.c:405-443 —
a STABLE sort, qsort replaced by an index merge) while the DM block
keeps sampling order (halo-grouped, setup.c:253-264).  Particle ids are
assigned BEFORE the resort and travel with their particles (ids.c:8-44),
so the snapshot's ID block records both orderings — this is what makes
the strided-ID domain-decomposition trick work downstream.  These tests
pin that contract on the device pipeline.
"""

import jax
import numpy as np
import pytest

from toycluster import STOCK_PAR, parse_par_file
from toycluster.models import positions as pos_mod
from toycluster.models.ids import make_ids
from toycluster.particles import halo_arrays_from_scene
from toycluster.scene import build_scene


@pytest.fixture(scope="module")
def reassigned():
    """Two-halo merger at tiny N, positions sampled and reassigned —
    no relaxation (ordering semantics do not depend on it)."""
    import jax.numpy as jnp

    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=4096, mass_ratio=1.0)
    scene = build_scene(cfg)
    ha = halo_arrays_from_scene(scene)
    parts = pos_mod.make_positions(jax.random.PRNGKey(3), scene, ha)
    parts = parts._replace(
        pid=jnp.asarray(make_ids(scene.npart_gas, scene.ntotal)))
    parts = pos_mod.shift_origin(parts, ha, scene.boxsize)
    before = parts
    after, counts = pos_mod.reassign_gas_to_halos(parts, ha,
                                                  scene.boxsize, None)
    return scene, before, after, np.asarray(counts)


def test_gas_block_sorted_by_halo(reassigned):
    scene, before, after, counts = reassigned
    owner = np.asarray(after.halo[: scene.npart_gas])
    assert (np.diff(owner) >= 0).all(), \
        "gas block must be non-decreasing in owner halo id"
    # both halos of the merger actually own gas (the fixture is a real
    # two-cluster scene, not a degenerate single-owner case)
    assert (counts > 0).sum() >= 2
    assert counts.sum() == scene.npart_gas


def test_gas_resort_is_stable(reassigned):
    """positions.c's resort preserves sampling order within a halo: the
    pre-sort index sequence of each halo's particles must be increasing."""
    scene, before, after, _ = reassigned
    n_gas = scene.npart_gas
    # recover each particle's pre-sort index through its (unique) id
    pid_before = np.asarray(before.pid[:n_gas])
    pid_after = np.asarray(after.pid[:n_gas])
    presort_index = np.empty(pid_before.max() + 1, np.int64)
    presort_index[pid_before] = np.arange(n_gas)
    idx = presort_index[pid_after]
    owner = np.asarray(after.halo[:n_gas])
    for h in np.unique(owner):
        seq = idx[owner == h]
        assert (np.diff(seq) > 0).all(), \
            f"halo {h}: sampling order not preserved by the resort"


def test_resort_permutes_ids_with_particles(reassigned):
    """Ids move WITH their particles: the (id -> position) map is the
    same before and after the resort, only the memory order changes."""
    scene, before, after, _ = reassigned
    n_gas = scene.npart_gas
    pid_b = np.asarray(before.pid[:n_gas])
    pid_a = np.asarray(after.pid[:n_gas])
    assert set(pid_a.tolist()) == set(pid_b.tolist())
    pos_b = np.asarray(before.pos[:n_gas])
    pos_a = np.asarray(after.pos[:n_gas])
    lookup = {int(p): i for i, p in enumerate(pid_b)}
    take = np.array([lookup[int(p)] for p in pid_a[:512]])
    np.testing.assert_array_equal(pos_a[:512], pos_b[take])


def test_dm_block_keeps_sampling_order(reassigned):
    """The reassignment touches ONLY the gas block: DM stays in
    halo-grouped sampling order with sequential ids n_gas+1..N
    (ids.c:12-14; positions.c resorts gas only)."""
    scene, before, after, _ = reassigned
    n_gas = scene.npart_gas
    np.testing.assert_array_equal(np.asarray(after.pos[n_gas:]),
                                  np.asarray(before.pos[n_gas:]))
    np.testing.assert_array_equal(
        np.asarray(after.pid[n_gas:]),
        np.arange(n_gas, scene.ntotal, dtype=np.uint32) + 1)


def test_snapshot_records_final_order(tmp_path):
    """The writer emits arrays in memory order — the snapshot's ID block
    is exactly parts.pid, so the resorted-gas + sampling-order-DM
    semantics survive into the file (io.c:228-244 block order)."""
    from toycluster.io.gadget import read_snapshot, \
        write_scene_snapshot

    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=4096, mass_ratio=1.0)
    scene = build_scene(cfg)
    ha = halo_arrays_from_scene(scene)
    parts = pos_mod.make_positions(jax.random.PRNGKey(3), scene, ha)
    import jax.numpy as jnp
    parts = parts._replace(
        pid=jnp.asarray(make_ids(scene.npart_gas, scene.ntotal)),
        vel=jnp.zeros_like(parts.pos),
        u=jnp.ones((scene.npart_gas,), jnp.float32),
        rho=jnp.ones((scene.npart_gas,), jnp.float32),
        hsml=jnp.ones((scene.npart_gas,), jnp.float32),
        rho_model=jnp.ones((scene.npart_gas,), jnp.float32))
    parts = pos_mod.shift_origin(parts, ha, scene.boxsize)
    parts, _ = pos_mod.reassign_gas_to_halos(parts, ha, scene.boxsize,
                                             None)
    out = str(tmp_path / "ic_order")
    write_scene_snapshot(out, scene, parts)
    snap = read_snapshot(out)
    np.testing.assert_array_equal(snap["ids"], np.asarray(parts.pid))
    n_gas = scene.npart_gas
    owner = np.asarray(parts.halo[:n_gas])
    assert (np.diff(owner) >= 0).all()
    np.testing.assert_array_equal(
        snap["ids"][n_gas:],
        np.arange(n_gas, scene.ntotal, dtype=np.uint32) + 1)
