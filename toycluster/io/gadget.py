"""Gadget-1 snapshot writer (reference src/io.c:13-287, src/io.h).

Byte-level layout: every block is framed as an F90 unformatted record pair —
an 8-byte label record (4-char tag + int32 "nextblock" size) followed by the
data record, each bracketed by int32 record lengths.  Blocks, in order:
HEAD, POS, VEL, ID, U, RHO, HSML, BFLD, RHOM (io.h:31-41); gas-only blocks
(U/RHO/HSML/BFLD/RHOM) cover particle type 0, the rest all 6 types.  Data is
float32 / uint32 little-endian; particle masses ride in the header only
(equal-mass types, io.c:50-53).  Empty blocks are still written with their
framing, faithful to add_block (io.c:85-133).

A reader is provided for round-trip tests and downstream tooling.
"""

from __future__ import annotations

import functools
import os
import struct
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

_HEADER_FMT = "<6i6d d d i i 6I i i d d d d i i 6I 64s"
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)
assert _HEADER_SIZE == 256


@dataclass
class GadgetHeader:
    npart: list
    mass: list
    time: float = 0.0
    redshift: float = 0.0
    flag_sfr: int = 0
    flag_feedback: int = 0
    npart_total: list = None
    flag_cooling: int = 0
    num_files: int = 1
    boxsize: float = 0.0
    omega0: float = 1.0          # io.c:63
    omega_lambda: float = 0.7    # io.c:64
    hubble_param: float = 0.7    # io.c:65 (Cosmo.h_100)
    flag_stellarage: int = 0
    flag_metals: int = 0

    def __post_init__(self):
        if self.npart_total is None:
            self.npart_total = list(self.npart)

    def pack(self) -> bytes:
        return struct.pack(
            _HEADER_FMT, *self.npart, *self.mass, self.time, self.redshift,
            self.flag_sfr, self.flag_feedback, *self.npart_total,
            self.flag_cooling, self.num_files, self.boxsize, self.omega0,
            self.omega_lambda, self.hubble_param, self.flag_stellarage,
            self.flag_metals, 0, 0, 0, 0, 0, 0, b"")

    @classmethod
    def unpack(cls, raw: bytes) -> "GadgetHeader":
        v = struct.unpack(_HEADER_FMT, raw)
        return cls(npart=list(v[0:6]), mass=list(v[6:12]), time=v[12],
                   redshift=v[13], flag_sfr=v[14], flag_feedback=v[15],
                   npart_total=list(v[16:22]), flag_cooling=v[22],
                   num_files=v[23], boxsize=v[24], omega0=v[25],
                   omega_lambda=v[26], hubble_param=v[27],
                   flag_stellarage=v[28], flag_metals=v[29])


def _rec(payload: bytes) -> bytes:
    n = struct.pack("<i", len(payload))
    return n + payload + n


def _block(label: str, payload: bytes) -> bytes:
    """Label record + data record (io.c:117-128)."""
    lab = label.encode("ascii")[:4].ljust(4)
    head = _rec(lab + struct.pack("<i", len(payload) + 8))
    return head + _rec(payload)


# block table: (label, gas_only, values_per_element, dtype)
BLOCKS = (
    ("POS ", False, 3, np.float32),
    ("VEL ", False, 3, np.float32),
    ("ID  ", False, 1, np.uint32),
    ("U   ", True, 1, np.float32),
    ("RHO ", True, 1, np.float32),
    ("HSML", True, 1, np.float32),
    ("BFLD", True, 3, np.float32),
    ("RHOM", True, 1, np.float32),
)


# The writer streams every block rather than fetching whole arrays: a
# snapshot at 1e8 particles is 4.2 GB, more than the host should hold
# twice.  Device rows are sliced into ~8 MB chunks, a thread pool keeps a
# read-ahead window of fetches in flight, and the main thread writes
# chunks to disk in order under the F90 framing — bytes identical to the
# whole-buffer path.
_FETCH_THREADS = int(os.environ.get("TOYCLUSTER_FETCH_THREADS", "48"))
_FETCH_CHUNK_BYTES = 8 * 1024 * 1024


def _is_device_array(arr) -> bool:
    return hasattr(arr, "addressable_shards")  # jax.Array, any backend


def _chunk_rows(shape, itemsize) -> int:
    row_bytes = itemsize * (int(np.prod(shape[1:])) if len(shape) > 1 else 1)
    return max(1, _FETCH_CHUNK_BYTES // max(row_bytes, 1))


@functools.lru_cache(maxsize=None)
def _chunk_taker(rows: int):
    """One jitted dynamic-slice per chunk-row count.  `arr[s:s+rows]`
    bakes the start offset into the HLO, so every distinct chunk start
    would mint a fresh compile (~143 for the POS block alone at 1e8).  A
    traced start argument compiles once per (shape, rows) and turns the
    block into pure transfer."""
    import jax

    @jax.jit
    def take(a, s):
        return jax.lax.dynamic_slice_in_dim(a, s, rows)

    return take


def _fetch_chunk(take, arr, s, rows, n, dtype):
    """Fetch rows [s, s+rows) as numpy; dynamic_slice clamps the start
    when s + rows > n, so trim the overlap off the front of the tail."""
    assert rows <= n, f"chunk rows {rows} > array rows {n}"
    chunk = np.asarray(take(arr, min(s, n - rows)))
    if s + rows > n:
        chunk = chunk[rows - (n - s):]
    return np.ascontiguousarray(chunk, dtype)


def _write_block_streamed(fp, label, arr, vpe, dtype, pool):
    """Emit one framed block, fetching device chunks through the pool
    with a read-ahead window while earlier chunks hit the disk."""
    arr_np = None if _is_device_array(arr) else np.asarray(arr)
    n = arr.shape[0]
    nbytes = n * vpe * np.dtype(dtype).itemsize
    lab = label.encode("ascii")[:4].ljust(4)
    fp.write(_rec(lab + struct.pack("<i", nbytes + 8)))
    fp.write(struct.pack("<i", nbytes))
    if arr_np is not None:
        np.ascontiguousarray(arr_np, dtype).tofile(fp)
    elif n:
        rows = min(n, _chunk_rows(arr.shape, np.dtype(dtype).itemsize))
        take = _chunk_taker(rows)
        window: deque = deque()
        starts = list(range(0, n, rows))
        it = iter(starts)
        depth = max(2, 2 * _FETCH_THREADS)
        for s in starts[:depth]:
            window.append(pool.submit(_fetch_chunk, take, arr, s, rows,
                                      n, dtype))
            next(it)
        while window:
            chunk = window.popleft().result()
            for s in it:
                window.append(pool.submit(_fetch_chunk, take, arr, s,
                                          rows, n, dtype))
                break
            chunk.tofile(fp)
    fp.write(struct.pack("<i", nbytes))


def write_snapshot(path: str, *, header: GadgetHeader, pos, vel, ids,
                   u=None, rho=None, hsml=None, bfld=None, rho_model=None):
    """Write all blocks in reference order. Gas-only arrays may be None or
    empty when npart[0] == 0 (the framing is still emitted).  Arrays may
    be numpy or jax device arrays — device data streams through the
    chunked fetcher instead of one blocking whole-array transfer."""
    n_gas = header.npart[0]
    data = {
        "POS ": pos, "VEL ": vel, "ID  ": ids,
        "U   ": u, "RHO ": rho, "HSML": hsml, "BFLD": bfld,
        "RHOM": rho_model,
    }
    pool = ThreadPoolExecutor(_FETCH_THREADS)
    try:
        with open(path, "wb") as fp:
            fp.write(_block("HEAD", header.pack()))
            for label, gas_only, vpe, dtype in BLOCKS:
                arr = data[label]
                if gas_only:
                    arr = (np.zeros((0, vpe), dtype) if arr is None
                           else arr[:n_gas])
                _write_block_streamed(fp, label, arr, vpe, dtype, pool)
    finally:
        pool.shutdown(wait=False)


def read_snapshot(path: str) -> dict:
    """Read a reference-format snapshot back into numpy arrays."""
    out = {}
    with open(path, "rb") as fp:
        raw = fp.read()
    off = 0

    def take(n):
        nonlocal off
        chunk = raw[off:off + n]
        off += n
        return chunk

    def record():
        (n,) = struct.unpack("<i", take(4))
        payload = take(n)
        (n2,) = struct.unpack("<i", take(4))
        assert n == n2, "corrupt F90 record"
        return payload

    while off < len(raw):
        head = record()
        label = head[:4].decode("ascii")
        payload = record()
        if label == "HEAD":
            out["header"] = GadgetHeader.unpack(payload)
        else:
            out[label.strip()] = payload

    hdr = out["header"]
    n_all = sum(hdr.npart)
    n_gas = hdr.npart[0]

    def arr(label, n, vpe, dtype):
        if label not in out:
            return None
        a = np.frombuffer(out[label], dtype)
        return a.reshape(n, vpe) if vpe > 1 else a

    return {
        "header": hdr,
        "pos": arr("POS", n_all, 3, np.float32),
        "vel": arr("VEL", n_all, 3, np.float32),
        "ids": arr("ID", n_all, 1, np.uint32),
        "u": arr("U", n_gas, 1, np.float32),
        "rho": arr("RHO", n_gas, 1, np.float32),
        "hsml": arr("HSML", n_gas, 1, np.float32),
        "bfld": arr("BFLD", n_gas, 3, np.float32),
        "rho_model": arr("RHOM", n_gas, 1, np.float32),
    }


def write_scene_snapshot(path: str, scene, parts) -> GadgetHeader:
    """Assemble the header from a Scene and dump a Particles pytree.
    Device arrays pass through to the streaming writer unfetched."""
    import numpy as _np
    npart = [scene.npart_gas, scene.npart_dm, 0, 0, 0, 0]
    mass = [scene.mpart_gas, scene.mpart_dm, 0.0, 0.0, 0.0, 0.0]
    header = GadgetHeader(npart=npart, mass=mass,
                          boxsize=float(scene.boxsize),
                          hubble_param=scene.cosmo.h_100)
    write_snapshot(
        path, header=header,
        pos=parts.pos, vel=parts.vel, ids=parts.pid,
        u=parts.u, rho=parts.rho, hsml=parts.hsml,
        bfld=(parts.bfld if parts.bfld.shape[0] == parts.n_gas else
              _np.zeros((parts.n_gas, 3), _np.float32)),
        rho_model=parts.rho_model)
    return header
