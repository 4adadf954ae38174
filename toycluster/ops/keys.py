"""Space-filling-curve keys (device).

Device-native replacement for the reference's 128-bit Peano-Hilbert keys +
serial heapsort + cycle-leader permutation (peano.c:46-126, sort.c:185-195):
a 30-bit Hilbert key in uint32 (Skilling's transpose algorithm, branch-free
over the particle axis) and `jnp.argsort`.  The key only drives *locality*
of the equal-count particle blocks (ops/blocks.py) — the neighbour search
itself is exact via bounding boxes — so 10 bits/dim is enough resolution at
any N.  Hilbert (not Morton) matters: the curve is continuous, so
equal-count blocks never straddle a curve seam and their bounding boxes
stay compact — a Morton block crossing an octant boundary can span the
whole box and blow up every candidate list.
"""

from __future__ import annotations

import jax.numpy as jnp

MORTON_BITS = 10  # per dimension


def _expand_bits10(v):
    """Spread the low 10 bits of v over 30 bits (x -> x with 2-bit gaps)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_keys(pos, boxsize):
    """Morton key per particle for positions in [0, boxsize)^3."""
    scale = (1 << MORTON_BITS) / boxsize
    cell = jnp.clip((pos * scale).astype(jnp.uint32), 0,
                    (1 << MORTON_BITS) - 1)
    x = _expand_bits10(cell[:, 0])
    y = _expand_bits10(cell[:, 1])
    z = _expand_bits10(cell[:, 2])
    return (x << 2) | (y << 1) | z


def _axes_to_transpose(x, y, z, bits):
    """Skilling 2004 AxestoTranspose, vectorised branch-free over lanes.
    Bit-plane loops are static Python loops (trace-friendly)."""
    X = [x, y, z]
    q = 1 << (bits - 1)
    while q > 1:
        Q = jnp.uint32(q)
        P = jnp.uint32(q - 1)
        for i in range(3):
            cond = (X[i] & Q) != 0
            # invert X[0] where bit set; else exchange low bits X[0]<->X[i]
            t = (X[0] ^ X[i]) & P
            X0_inv = X[0] ^ P
            X0_exc = X[0] ^ t
            Xi_exc = X[i] ^ t
            X[0] = jnp.where(cond, X0_inv, X0_exc)
            if i != 0:
                X[i] = jnp.where(cond, X[i], Xi_exc)
        q >>= 1
    # Gray encode
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = jnp.zeros_like(X[0])
    q = 1 << (bits - 1)
    while q > 1:
        t = jnp.where((X[2] & jnp.uint32(q)) != 0,
                      t ^ jnp.uint32(q - 1), t)
        q >>= 1
    return [xi ^ t for xi in X]


def hilbert_keys(pos, boxsize, bits=MORTON_BITS):
    """30-bit Hilbert key per particle for positions in [0, boxsize)^3."""
    scale = (1 << bits) / boxsize
    cell = jnp.clip((pos * scale).astype(jnp.uint32), 0, (1 << bits) - 1)
    tx, ty, tz = _axes_to_transpose(cell[:, 0], cell[:, 1], cell[:, 2],
                                    bits)
    # transposed form -> interleaved key, X[0] most significant per triplet
    return ((_expand_bits10(tx) << 2) | (_expand_bits10(ty) << 1)
            | _expand_bits10(tz))


def hilbert_order(pos, boxsize):
    """Permutation sorting particles along the Hilbert curve
    (the Sort_Particles_By_Peano_Key analogue, peano.c:46)."""
    return jnp.argsort(hilbert_keys(pos, boxsize))
