"""The stream-curl path of the B-field stage (the Triton kernel in
interpret mode on the superblock neighbour structure) must match the XLA
pair operator on the block-granular structure (magnetic_field.c:12-26 /
sph.c:216-300)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from toycluster import STOCK_PAR, parse_par_file
from toycluster.models import bfield as bf_mod
from toycluster.models import positions as pos_mod
from toycluster.models import sph as sph_mod
from toycluster.ops import pair_ops
from toycluster.particles import halo_arrays_from_scene
from toycluster.scene import build_scene


@pytest.fixture(scope="module")
def curl_setup():
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=8192, sph_kernel="m4")
    scene = build_scene(cfg)
    ha = halo_arrays_from_scene(scene)
    parts = pos_mod.make_positions(jax.random.PRNGKey(6), scene, ha)
    parts = pos_mod.shift_origin(parts, ha, scene.boxsize)
    parts, _ = sph_mod.find_sph_quantities(scene, ha, parts,
                                           return_state=True)
    parts = bf_mod.set_vector_potential(scene, ha, parts)
    n_gas = parts.n_gas
    state = sph_mod._build_neighbours_sb(
        parts.pos[:n_gas], parts.hsml[:n_gas], scene.boxsize)
    return scene, ha, parts, state


def _curl_xla(scene, parts):
    n_gas = parts.n_gas
    state = sph_mod._build_neighbours_blocks(
        parts.pos[:n_gas], parts.hsml[:n_gas], scene.boxsize)
    bi = state.index
    pad = lambda x: sph_mod._pad_sorted(x, bi.order, bi.n_padded)  # noqa: E731
    h_s, rho_s, vf_s, apot_s = (pad(parts.hsml[:n_gas]),
                                pad(parts.rho[:n_gas]),
                                pad(parts.var_hsml_fac[:n_gas]),
                                pad(parts.apot[:n_gas]))

    def curl_class(sel, m):
        return (pair_ops.sph_curl(bi, sel, h_s, rho_s, vf_s, apot_s,
                                  scene.mpart_gas, scene.boxsize,
                                  kernel=scene.config.sph_kernel),)

    def curl_tail(ids, sb_rows, sb_cnt):
        sel = pair_ops.BlockSelection(
            ids=ids, cand=sph_mod.expand_tail_rows(sb_rows, bi.n_blocks))
        return curl_class(sel, sel.cand.shape[1])

    (b,) = sph_mod.run_classed(state, curl_class, curl_tail)
    return jnp.zeros((n_gas, 3), jnp.float32).at[bi.order].set(b[:n_gas])


def test_curl_stream_matches_slabbed_xla(curl_setup):
    scene, ha, parts, state = curl_setup
    b_xla = np.asarray(_curl_xla(scene, parts))
    b_stream = np.asarray(bf_mod._curl_stream(scene, parts, state,
                                              interpret=True))
    scale = np.abs(b_xla).max()
    assert scale > 0
    np.testing.assert_allclose(b_stream, b_xla, rtol=5e-4,
                               atol=2e-5 * scale)


def test_make_magnetic_field_engines_agree(curl_setup):
    """The whole stage (vector potential, curl, normalisation and caps)
    gives the same field through either engine."""
    scene, ha, parts, _ = curl_setup
    out_s = bf_mod.make_magnetic_field(scene, ha, parts,
                                       engine="stream_interpret")
    out_x = bf_mod.make_magnetic_field(scene, ha, parts, engine="xla")
    a, b = np.asarray(out_x.bfld), np.asarray(out_s.bfld)
    assert np.isfinite(b).all() and np.abs(b).max() > 0
    np.testing.assert_allclose(b, a, rtol=5e-4, atol=2e-5 * np.abs(a).max())
