"""Hilbert-key correctness: the sorted traversal of a full sub-grid must be
a continuous curve (every step moves to a face-adjacent cell) and a
bijection — the properties the reference's Peano-Hilbert machinery
guarantees (peano.c:128-284)."""

import numpy as np
import jax.numpy as jnp

from toycluster.ops.keys import hilbert_keys, morton_keys


def _grid(n):
    g = np.arange(n)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)


def test_hilbert_bijective_and_continuous():
    n = 32  # sub-cube of the 1024^3 key grid -> one contiguous curve span
    cells = _grid(n) + 0.5
    boxsize = 1024.0
    keys = np.asarray(hilbert_keys(jnp.asarray(cells), boxsize))
    assert len(set(keys.tolist())) == n ** 3  # bijective on the grid
    order = np.argsort(keys)
    path = cells[order]
    steps = np.abs(np.diff(path, axis=0)).sum(axis=1)
    # Hilbert property: every consecutive pair of cells is face-adjacent
    assert (steps == 1).all()


def test_hilbert_beats_morton_locality():
    rng = np.random.default_rng(3)
    pos = jnp.asarray(rng.random((20000, 3)).astype(np.float32) * 1000.0)
    def span(keys):
        order = np.argsort(np.asarray(keys))
        p = np.asarray(pos)[order]
        # worst block bbox diagonal over equal-count blocks of 128
        nb = len(p) // 128
        q = p[: nb * 128].reshape(nb, 128, 3)
        diag = np.linalg.norm(q.max(1) - q.min(1), axis=1)
        return diag.max()
    s_h = span(hilbert_keys(pos, 1000.0))
    s_m = span(morton_keys(pos, 1000.0))
    # Morton seams produce box-scale blocks; Hilbert chains stay compact
    # (worst contiguous chain ~ 2x the equal-volume cube diagonal ~ 322)
    assert s_h < 0.65 * 1000.0
    assert s_h <= s_m
