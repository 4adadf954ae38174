"""Statistical parity of the CDF-inversion speed sampler against the
LITERAL reference rejection sampler (velocities.c:62-104).

The production sampler (models/velocities.sample_speeds) draws |v| by
inverting the CDF of 4 pi v^2 f(psi - v^2/2); the reference instead
rejection-samples with the Ascasibar+2005 envelope qmax = 4 pi vmax^2
f(psi) (a true bound: v^2 <= vmax^2 and f is increasing in binding
energy, so the rejection is exact and both methods target the SAME
distribution).  This test implements the reference's loop verbatim
(numpy, vectorised over lanes) and two-sample-KS-compares the speed
distributions per radius bin, for a DM-only halo and a gas-potential
halo.  The recorded bound lives in PARITY.md.
"""

import jax
import numpy as np
import pytest
from scipy.stats import ks_2samp

from toycluster import STOCK_PAR, parse_par_file
from toycluster.models import velocities as vel_mod
from toycluster.models.eddington import RMIN, build_distribution_function
from toycluster.scene import build_scene

N_PER_BIN = 4000
N_BINS = 8


def _reference_rejection_speeds(df, mtotal, r, n, rng, max_tries=90_000):
    """velocities.c:71-95, vectorised over n lanes at one radius:
    qmax = 4 pi vmax^2 f(psi) / M; per try, accept v = vmax*u2 when
    4 pi v^2 f(psi - v^2/2) / M >= qmax*u1; v=0 after 90k tries."""
    psi = float(df.psi(max(r, RMIN)))
    vmax = np.sqrt(2.0 * psi)
    fourpi = 4.0 * np.pi
    qmax = fourpi * vmax**2 / mtotal * float(df(psi))
    v = np.zeros(n)
    todo = np.ones(n, bool)
    tries = 0
    while todo.any() and tries < max_tries:
        k = int(todo.sum())
        lower = qmax * rng.random(k)
        vc = vmax * rng.random(k)
        q = fourpi * vc**2 / mtotal * np.asarray(df(psi - 0.5 * vc * vc))
        ok = q >= lower
        idx = np.where(todo)[0]
        v[idx[ok]] = vc[ok]
        todo[idx[ok]] = False
        tries += 1
    v[todo] = 0.0
    return v


def _cdf_sampler_speeds(scene, halo_idx, r, n, seed):
    vt = vel_mod.build_velocity_tables(scene, halo_idx)
    r_arr = jax.numpy.full((n,), np.float32(r))
    return np.asarray(vel_mod.sample_speeds(
        jax.random.PRNGKey(seed), vt, r_arr))


def _ks_parity(cfg, halo_idx=0):
    scene = build_scene(cfg)
    h = scene.halos[halo_idx]
    df = build_distribution_function(
        mass_dm=h.mass_dm, a_hernq=h.a_hernq, G=scene.units.G,
        mass_table=h.mass_table, r_sample_gas=h.r_sample_gas,
        has_gas=h.npart_gas > 0)
    rng = np.random.default_rng(5)
    radii = np.geomspace(0.05 * h.a_hernq, 1.5 * h.r_sample_dm, N_BINS)
    worst = (None, 0.0, 1.0)
    for k, r in enumerate(radii):
        v_ref = _reference_rejection_speeds(df, h.mtotal, r, N_PER_BIN,
                                            rng)
        v_cdf = _cdf_sampler_speeds(scene, halo_idx, r, N_PER_BIN,
                                    seed=100 + k)
        assert (v_ref > 0).mean() > 0.999
        assert (v_cdf > 0).mean() > 0.999
        res = ks_2samp(v_ref, v_cdf)
        if res.pvalue < worst[2]:
            worst = (r, res.statistic, res.pvalue)
        # p > 0.01 at every radius bin; D at
        # N=4000/4000 p=0.01 is ~0.036
        assert res.pvalue > 0.01, (
            f"KS parity failed at r={r:.3g}: D={res.statistic:.4f} "
            f"p={res.pvalue:.4g}")
    return worst


def test_speed_distribution_parity_dm_only():
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=20000, baryon_fraction=0.0)
    r, d, p = _ks_parity(cfg)
    print(f"dm-only worst bin: r={r:.4g} D={d:.4f} p={p:.4g}")


def test_speed_distribution_parity_gas_potential():
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=20000)
    r, d, p = _ks_parity(cfg)
    print(f"gas-potential worst bin: r={r:.4g} D={d:.4f} p={p:.4g}")
