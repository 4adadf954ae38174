"""Unit tests for the candidate-width stickiness policy
(sph._trim_and_buckets) and the iteration-dependent accept band
(wvt._accept_band) — the cold-start fixes."""

import jax.numpy as jnp
import numpy as np

from toycluster.models import sph
from toycluster.models.wvt import _accept_band
from toycluster.ops.blocks import CandidateList


def _cand(nb_rows, width, max_count):
    counts = np.full((nb_rows,), 8, np.int32)
    counts[0] = max_count
    idx = np.full((nb_rows, width), -1, np.int32)
    for r in range(nb_rows):
        idx[r, :counts[r]] = np.arange(counts[r])
    return CandidateList(idx=jnp.asarray(idx),
                         count=jnp.asarray(counts),
                         overflow=jnp.int32(0),
                         sb_overflow=jnp.int32(0))


def test_trim_width_shrinks_back_after_transient():
    nb_rows = 7777   # unique key: isolates the module-level memo
    sph._TRIM_MEMO.pop(nb_rows, None)
    sph._BUCKET_MEMO.pop(nb_rows, None)
    # transient blow-up: need 1500 -> width 1536
    c1, _ = sph._trim_and_buckets(_cand(nb_rows, 1536, 1500))
    assert c1.idx.shape[1] == 1536
    assert sph._TRIM_MEMO[nb_rows] == 1536
    # need collapses to 100 (pow2 need = 128): the memo may hold the
    # width at most at 2x the need, not at the blown-up 1536
    c2, _ = sph._trim_and_buckets(_cand(nb_rows, 1536, 100))
    assert c2.idx.shape[1] == 256, c2.idx.shape
    assert sph._TRIM_MEMO[nb_rows] == 256
    # stable thereafter (2x headroom absorbs pow2 wobble)
    c3, _ = sph._trim_and_buckets(_cand(nb_rows, 1536, 120))
    assert c3.idx.shape[1] == 256
    # growth is always honoured immediately
    c4, _ = sph._trim_and_buckets(_cand(nb_rows, 1536, 700))
    assert c4.idx.shape[1] == 1024
    sph._TRIM_MEMO.pop(nb_rows, None)
    sph._BUCKET_MEMO.pop(nb_rows, None)


def test_trim_never_cuts_below_need():
    nb_rows = 7778
    sph._TRIM_MEMO.pop(nb_rows, None)
    sph._BUCKET_MEMO.pop(nb_rows, None)
    c, _ = sph._trim_and_buckets(_cand(nb_rows, 512, 300))
    assert c.idx.shape[1] >= 300
    # every listed candidate of the widest row survived the trim
    assert int((np.asarray(c.idx[0]) >= 0).sum()) == 300
    sph._TRIM_MEMO.pop(nb_rows, None)
    sph._BUCKET_MEMO.pop(nb_rows, None)


def test_search_width_decays_with_need():
    key = ("unit-test", 0, 0)
    sph._LAST_MAX_CAND[key] = 1536
    nb_rows = 7779
    sph._TRIM_MEMO.pop(nb_rows, None)
    sph._BUCKET_MEMO.pop(nb_rows, None)
    sph._trim_and_buckets(_cand(nb_rows, 1536, 100), search_key=key)
    assert sph._LAST_MAX_CAND[key] == 256
    sph._LAST_MAX_CAND.pop(key, None)
    sph._TRIM_MEMO.pop(nb_rows, None)
    sph._BUCKET_MEMO.pop(nb_rows, None)


def test_accept_band_wide_early_tight_late():
    n = 5_000_000
    assert _accept_band(n, 0) == n // 50
    assert _accept_band(n, 2) == n // 50
    assert _accept_band(n, 3) == n // 20_000
    assert _accept_band(n) == n // 20_000
    # small N floors
    assert _accept_band(1000, 0) >= 32
    assert _accept_band(1000) == 32
