"""Device-memory accounting and the memory-derived size thresholds.

`est_live_gib` sums the unique live device-array buffers reachable from
the objects a stage holds.  It exists only because an earlier backend
returned an empty `memory_stats()`; on the GPU `peak_gib` reads the
allocator's own peak, and the stage logs record both.

`mem_scale` turns the size thresholds of the WVT loop and the neighbour
build, which were sized for a device with 16 GiB, into the device's own
terms: its `bytes_limit` over 16 GiB.  Where no limit is reported (the
CPU), the factor is 1, so the tests that drive those paths keep doing
so."""

from __future__ import annotations

import functools

import jax

_SIZED_FOR_BYTES = 16 * 2**30


def _stats() -> dict:
    return jax.local_devices()[0].memory_stats() or {}


@functools.lru_cache(maxsize=None)
def mem_scale() -> float:
    """Device bytes_limit / 16 GiB, or 1.0 when no limit is reported."""
    limit = _stats().get("bytes_limit")
    return limit / _SIZED_FOR_BYTES if limit else 1.0


def scaled(n: int) -> int:
    """A threshold sized for 16 GiB, in this device's terms."""
    return int(n * mem_scale())


def peak_gib() -> float | None:
    """The allocator's peak bytes in use (GiB), or None where the backend
    reports no statistics."""
    peak = _stats().get("peak_bytes_in_use")
    return None if peak is None else round(peak / 2**30, 3)


def est_live_gib(*objs) -> float:
    """Estimated GiB of unique device buffers reachable from *objs.

    Dedup is by buffer pointer where the backend exposes it (donated /
    aliased arrays count once), by array identity otherwise."""
    seen = set()
    total = 0
    for o in objs:
        if o is None:
            continue
        for leaf in jax.tree_util.tree_leaves(o):
            if not isinstance(leaf, jax.Array):
                continue
            try:
                key = leaf.unsafe_buffer_pointer()
            except Exception:
                key = id(leaf)
            if key in seen:
                continue
            seen.add(key)
            total += leaf.nbytes
    return round(total / 2**30, 3)
