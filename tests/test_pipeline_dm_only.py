"""End-to-end DM-only slice: setup -> sample -> ids -> shift -> velocities ->
kinematics -> Gadget write -> read back (the bf=0 path of main.c:50)."""

import numpy as np
import pytest

from toycluster import STOCK_PAR, parse_par_file
from toycluster.io.gadget import read_snapshot
from toycluster.pipeline import make_ics
from toycluster.utils.logging import silent_log


def test_dm_only_end_to_end(tmp_path):
    out = str(tmp_path / "ic_dm")
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=10000, baryon_fraction=0.0, output_file=out)
    scene, parts = make_ics(cfg, log=silent_log)

    snap = read_snapshot(out)
    hdr = snap["header"]
    assert hdr.npart[0] == 0
    assert hdr.npart[1] == scene.npart_dm
    assert hdr.boxsize == scene.boxsize
    assert hdr.mass[1] == pytest.approx(scene.mpart_dm)
    assert hdr.redshift == 0 and hdr.time == 0

    pos = snap["pos"]
    assert pos.shape == (scene.npart_dm, 3)
    assert pos.min() >= 0 and pos.max() <= scene.boxsize
    # ids sequential for DM
    np.testing.assert_array_equal(
        snap["ids"], np.arange(1, scene.npart_dm + 1, dtype=np.uint32))
    # velocities sane: bounded, nonzero
    v = np.linalg.norm(snap["vel"], axis=1)
    assert (v > 0).mean() > 0.99
    assert v.max() < 1e4  # km/s scale


def test_merger_dm_only_comet(tmp_path):
    out = str(tmp_path / "ic_merger")
    cfg = parse_par_file(STOCK_PAR).replace(
        ntotal=8000, baryon_fraction=0.0, mass_ratio=0.5, output_file=out)
    scene, parts = make_ics(cfg, log=silent_log)
    snap = read_snapshot(out)
    pos, vel = snap["pos"], snap["vel"]
    h1 = scene.halos[1]
    d = pos - (np.array(h1.d_com) + scene.boxhalf)
    r2 = (d ** 2).sum(axis=1)
    in_ball = r2 < h1.r200 ** 2
    # comet stamp: particles in halo-1 ball carry vx_infa relative bulk
    assert in_ball.sum() > 100
    mean_in = vel[in_ball, 0].mean()
    mean_out = vel[~in_ball, 0].mean()
    # infalling cluster moves in -x (v1 < 0), host in +x (v0 > 0)
    assert scene.vel_merger[1] < 0 < scene.vel_merger[0]
    assert mean_in < 0.5 * scene.vel_merger[1]
    assert mean_out == pytest.approx(scene.vel_merger[0], rel=0.2)
