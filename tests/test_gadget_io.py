import struct

import numpy as np
import pytest

from toycluster.io.gadget import (GadgetHeader, read_snapshot,
                                      write_snapshot, BLOCKS)


def _mk(n_gas=5, n_dm=7):
    n = n_gas + n_dm
    rng = np.random.default_rng(0)
    return dict(
        header=GadgetHeader(npart=[n_gas, n_dm, 0, 0, 0, 0],
                            mass=[0.1, 0.2, 0, 0, 0, 0], boxsize=1000.0),
        pos=rng.random((n, 3), np.float32),
        vel=rng.random((n, 3), np.float32),
        ids=np.arange(1, n + 1, dtype=np.uint32),
        u=rng.random(n_gas).astype(np.float32),
        rho=rng.random(n_gas).astype(np.float32),
        hsml=rng.random(n_gas).astype(np.float32),
        bfld=rng.random((n_gas, 3), np.float32),
        rho_model=rng.random(n_gas).astype(np.float32),
    )


def test_roundtrip(tmp_path):
    d = _mk()
    p = str(tmp_path / "snap")
    write_snapshot(p, **d)
    r = read_snapshot(p)
    assert r["header"].npart == d["header"].npart
    assert r["header"].boxsize == 1000.0
    assert r["header"].omega0 == 1.0 and r["header"].omega_lambda == 0.7
    np.testing.assert_array_equal(r["pos"], d["pos"])
    np.testing.assert_array_equal(r["vel"], d["vel"])
    np.testing.assert_array_equal(r["ids"], d["ids"])
    np.testing.assert_array_equal(r["u"], d["u"])
    np.testing.assert_array_equal(r["bfld"], d["bfld"])
    np.testing.assert_array_equal(r["rho_model"], d["rho_model"])


def test_byte_level_framing(tmp_path):
    """Golden-format check of the F90 record layout (io.c:41-128):
    HEAD label record is 8 bytes (4 chars + int32 nextblock), the header
    record is 256 bytes, and every record is bracketed by int32 lengths."""
    d = _mk(2, 3)
    p = str(tmp_path / "snap")
    write_snapshot(p, **d)
    raw = open(p, "rb").read()
    # label record of HEAD
    assert struct.unpack("<i", raw[0:4])[0] == 8
    assert raw[4:8] == b"HEAD"
    assert struct.unpack("<i", raw[8:12])[0] == 256 + 8  # nextblock
    assert struct.unpack("<i", raw[12:16])[0] == 8
    # header record
    assert struct.unpack("<i", raw[16:20])[0] == 256
    assert struct.unpack("<i", raw[276:280])[0] == 256
    # first data block: POS, 3 floats per particle, 5 particles... (2+3)
    off = 280
    assert struct.unpack("<i", raw[off:off+4])[0] == 8
    assert raw[off+4:off+8] == b"POS "
    n_pos_bytes = struct.unpack("<i", raw[off+8:off+12])[0] - 8
    assert n_pos_bytes == 5 * 3 * 4
    # total size: 16-byte label record + (payload+8) data record per block
    expected = 16 + (256 + 8)  # HEAD
    npart_all, n_gas = 5, 2
    for label, gas_only, vpe, dtype in BLOCKS:
        n = n_gas if gas_only else npart_all
        expected += 16 + (n * vpe * 4 + 8)
    assert len(raw) == expected


def test_empty_gas_blocks_still_framed(tmp_path):
    """DM-only snapshots keep the gas block framing (add_block writes the
    label + zero-length data records regardless, io.c:85-133)."""
    n_dm = 4
    header = GadgetHeader(npart=[0, n_dm, 0, 0, 0, 0],
                          mass=[0, 0.5, 0, 0, 0, 0], boxsize=10.0)
    pos = np.zeros((n_dm, 3), np.float32)
    p = str(tmp_path := str(tmp_path) + "/snap")
    write_snapshot(p, header=header, pos=pos, vel=pos,
                   ids=np.arange(1, 5, dtype=np.uint32))
    r = read_snapshot(p)
    assert r["u"].size == 0
    assert r["header"].npart[1] == 4
    raw = open(p, "rb").read()
    assert b"RHOM" in raw and b"BFLD" in raw


def test_header_packs_to_256():
    h = GadgetHeader(npart=[1] * 6, mass=[0.5] * 6)
    assert len(h.pack()) == 256
    h2 = GadgetHeader.unpack(h.pack())
    assert h2.npart == [1] * 6
    assert h2.mass == [0.5] * 6


def test_device_streamed_bytes_match_numpy(tmp_path, monkeypatch):
    """Device arrays stream through chunked dynamic-slice fetches; the
    file must be byte-identical to the whole-buffer numpy path,
    including a ragged tail chunk (n not divisible by chunk rows)."""
    import jax.numpy as jnp
    from toycluster.io import gadget

    # 12-byte rows / 64-byte chunks -> 5 rows per chunk; n=23 gives a
    # 3-row tail that exercises the clamped-start trim in _fetch_chunk.
    monkeypatch.setattr(gadget, "_FETCH_CHUNK_BYTES", 64)
    gadget._chunk_taker.cache_clear()
    kw = _mk(n_gas=9, n_dm=14)
    p_np = str(tmp_path / "snap_np")
    write_snapshot(p_np, **kw)
    dev = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    p_dev = str(tmp_path / "snap_dev")
    write_snapshot(p_dev, **dev)
    gadget._chunk_taker.cache_clear()
    assert open(p_dev, "rb").read() == open(p_np, "rb").read()


# ---------------------------------------------------------------------------
# Golden-byte parity vs the ACTUAL reference writer: tests/golden/ holds
# binaries produced by compiling /root/reference/src/io.c UNMODIFIED
# (io.c uses no GSL symbols; stub headers satisfy the includes — see
# tests/golden/build.sh) against the deterministic dyadic-rational
# particle set below (tests/golden/gen_golden.c).  Every value is exactly
# representable in float32, so the numpy mirror is bit-identical to the
# C fill loops.
# ---------------------------------------------------------------------------

def _golden_particles(n_gas, n_dm):
    n = n_gas + n_dm
    i = np.arange(n, dtype=np.float64)
    d = np.arange(3, dtype=np.float64)
    pos = ((i[:, None] * 8 + d) * 0.5).astype(np.float32)
    vel = ((i[:, None] * 4 + d) * 0.25 - 3.0).astype(np.float32)
    ids = (np.arange(n) + 1000).astype(np.uint32)
    g = np.arange(n_gas, dtype=np.float64)
    return dict(
        pos=pos, vel=vel, ids=ids,
        u=(g * 1.5).astype(np.float32),
        rho=(g * 0.75 + 0.5).astype(np.float32),
        hsml=(g * 2.0 + 1.0).astype(np.float32),
        bfld=((g[:, None] * 4 + d) * 0.125 - 1.0).astype(np.float32),
        rho_model=(g * 0.375).astype(np.float32),
    )


@pytest.mark.parametrize("golden,n_gas,n_dm,m_gas", [
    ("golden_mixed.bin", 7, 9, 0.25),
    ("golden_dmonly.bin", 0, 9, 0.0),
])
def test_golden_vs_reference(tmp_path, golden, n_gas, n_dm, m_gas):
    import os
    ref = os.path.join(os.path.dirname(__file__), "golden", golden)
    d = _golden_particles(n_gas, n_dm)
    header = GadgetHeader(npart=[n_gas, n_dm, 0, 0, 0, 0],
                          mass=[m_gas, 0.5, 0, 0, 0, 0],
                          boxsize=6400.0, hubble_param=0.7)
    p = str(tmp_path / "snap")
    write_snapshot(p, header=header, **{k: v for k, v in d.items()
                                        if k != "ids"}, ids=d["ids"])
    ours = open(p, "rb").read()
    theirs = open(ref, "rb").read()
    assert ours == theirs, (
        f"byte mismatch vs reference writer: len {len(ours)} vs "
        f"{len(theirs)}; first diff at "
        f"{next((k for k in range(min(len(ours), len(theirs))) if ours[k] != theirs[k]), -1)}")
