"""Profile the streaming snapshot writer (io.c:117-128 analogue) alone.

Builds synthetic device arrays with config-5 shapes (ntotal=1e8,
n_gas=5e7 -> 4.2 GB snapshot) and times write_snapshot to a tmp file,
per block. Positions/velocities are random device data: byte content
does not affect the transfer path.

    python scripts/profile_writer.py [ntotal] [out_path]
"""

import json
import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp
import numpy as np

from toycluster.io import gadget

NTOTAL = int(float(sys.argv[1])) if len(sys.argv) > 1 else 100_000_000
OUT = sys.argv[2] if len(sys.argv) > 2 else "/tmp/IC_writer_profile"

BLOCK_TIMES = {}
_orig = gadget._write_block_streamed


def _timed_block(fp, label, arr, vpe, dtype, pool):
    t0 = time.perf_counter()
    _orig(fp, label, arr, vpe, dtype, pool)
    fp.flush()
    BLOCK_TIMES[label] = time.perf_counter() - t0


def main():
    gadget._write_block_streamed = _timed_block
    n_gas = NTOTAL // 2
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 5)
    pos = jax.random.uniform(ks[0], (NTOTAL, 3), jnp.float32, 0.0, 1e4)
    vel = jax.random.normal(ks[1], (NTOTAL, 3), jnp.float32)
    ids = jnp.arange(1, NTOTAL + 1, dtype=jnp.uint32)
    u = jax.random.uniform(ks[2], (n_gas,), jnp.float32)
    rho = jax.random.uniform(ks[3], (n_gas,), jnp.float32, 1e-8, 1e-5)
    hsml = rho * 2.0
    bfld = jax.random.normal(ks[4], (n_gas, 3), jnp.float32) * 1e-6
    rhom = rho * 1.1
    jax.block_until_ready((pos, vel, ids, u, rho, hsml, bfld, rhom))

    hdr = gadget.GadgetHeader(
        npart=[n_gas, NTOTAL - n_gas, 0, 0, 0, 0],
        mass=[1e-5, 2e-5, 0, 0, 0, 0], boxsize=1e4)

    t0 = time.perf_counter()
    gadget.write_snapshot(OUT, header=hdr, pos=pos, vel=vel, ids=ids,
                          u=u, rho=rho, hsml=hsml, bfld=bfld,
                          rho_model=rhom)
    total = time.perf_counter() - t0
    nbytes = os.path.getsize(OUT)
    print(f"{'block':<8}{'seconds':>10}{'MB/s':>10}")
    sizes = {"POS ": NTOTAL * 12, "VEL ": NTOTAL * 12, "ID  ": NTOTAL * 4,
             "U   ": n_gas * 4, "RHO ": n_gas * 4, "HSML": n_gas * 4,
             "BFLD": n_gas * 12, "RHOM": n_gas * 4}
    for lab, dt in BLOCK_TIMES.items():
        mbs = sizes.get(lab, 0) / dt / 1e6 if dt else 0.0
        print(f"{lab!r:<8}{dt:>10.2f}{mbs:>10.1f}")
    print(json.dumps({
        "metric": "snapshot_write_s", "value": round(total, 2),
        "ntotal": NTOTAL, "bytes": nbytes,
        "eff_MBps": round(nbytes / total / 1e6, 1),
        "threads": gadget._FETCH_THREADS,
        "chunk_mb": gadget._FETCH_CHUNK_BYTES // (1024 * 1024),
        "blocks": {k.strip(): round(v, 2) for k, v in BLOCK_TIMES.items()},
    }))
    os.unlink(OUT)


if __name__ == "__main__":
    main()
