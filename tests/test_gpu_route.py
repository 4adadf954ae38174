"""The GPU route, checked without a GPU: the Triton kernels lower for
CUDA, the backend switch picks the right engine, interpret mode never
reaches a GPU, the compile cache lands where it should, the in-repo
parameter file is complete, and chip_smoke.py refuses a CPU-only host."""

import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import pytest

from toycluster import STOCK_PAR, parse_par_file
from toycluster.ops import blocks as blk
from toycluster.ops import stream as so

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, M, NB, B = 16, 6, 64, blk.BLOCK


def _spec(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _lower_cuda(fn, *specs):
    return jax.jit(fn).trace(*specs).lower(lowering_platforms=("cuda",))


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
@pytest.mark.parametrize("do_disp", [True, False])
def test_stream_wvt_lowers_for_cuda(kernel, do_disp):
    fn = partial(so.stream_wvt, mpart=1.0, boxsize=1000.0, kernel=kernel,
                 desnngb=64, sb_mode=True, do_disp=do_disp)

    def call(src, cand, cnt, xi, h0, cap, hm, bits):
        return fn(src, cand, cnt, xi, h0, cap, hm, bits=bits)

    low = _lower_cuda(call, _spec((NB, 4, B)), _spec((S, M), jnp.int32),
                      _spec((S,), jnp.int32), _spec((S, 3, B)),
                      _spec((S, B)), _spec((S, B)), _spec((S, B)),
                      _spec((S, M * so.FAN // 16), jnp.int32))
    assert "triton" in low.as_text().lower()


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
def test_stream_curl_lowers_for_cuda(kernel):
    fn = partial(so.stream_curl, mpart=1.0, boxsize=1000.0, kernel=kernel,
                 sb_mode=True)
    low = _lower_cuda(fn, _spec((NB, 8, B)), _spec((S, M), jnp.int32),
                      _spec((S,), jnp.int32), _spec((S, 3, B)),
                      _spec((S, B)), _spec((S, B)), _spec((S, 3, B)))
    assert "triton" in low.as_text().lower()


@pytest.mark.parametrize("platform,engine", [
    ("cpu", "xla"), ("gpu", "stream"), ("tpu", None)])
def test_pair_engine_switch(platform, engine):
    if engine is None:
        with pytest.raises(RuntimeError, match=platform):
            so.pair_engine(platform)
    else:
        assert so.pair_engine(platform) == engine


def test_interpret_mode_refused_on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    cand = jnp.zeros((1, 2), jnp.int32)
    z = jnp.zeros((1, B), jnp.float32)
    with pytest.raises(RuntimeError, match="interpret"):
        so.stream_wvt(jnp.zeros((1, 4, B)), cand, jnp.ones((1,), jnp.int32),
                      jnp.zeros((1, 3, B)), z + 1, z + 1, z, 1.0, 100.0,
                      sb_mode=True, interpret=True)


def _cache_dir_in_fresh_process(env):
    code = ("import jax, toycluster; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("preset", [True, False])
def test_compile_cache_dir(preset, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if preset:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
        assert _cache_dir_in_fresh_process(env) == str(tmp_path)
    else:
        assert (_cache_dir_in_fresh_process(env)
                == os.path.join(os.path.realpath(ROOT), ".jax_cache"))


def test_stock_par_in_package_parses_every_tag_group():
    assert os.path.dirname(STOCK_PAR) == os.path.join(
        os.path.realpath(ROOT), "toycluster")
    cfg = parse_par_file(STOCK_PAR, give_params=True,
                         add_third_subhalo=True,
                         double_beta_cool_cores=True)
    assert cfg.ntotal == 1_000_000 and cfg.bfld_norm == 20e-6
    assert cfg.c_nfw_given == (4.0, 4.089)
    assert cfg.sub_first_mass == 1e3
    assert cfg.sub_first_pos == (200.0, 200.0, 0.0)
    assert cfg.sub_first_vel == (0.0, 0.0, 0.0)
    assert (cfg.rho0_fac, cfg.rc_fac) == (50.0, 40.0)


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
