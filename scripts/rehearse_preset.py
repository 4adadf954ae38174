"""CPU rehearsal of a flagship preset at reduced N / few WVT iterations.

Smoke-tests a BASELINE config preset (configs/run_configs.py) through the
FULL pipeline (main.c:11-72 stage order) on the CPU backend before
spending GPU hours on the real run: every stage executes — scene setup,
substructure, positions, census, WVT (capped), fresh SPH solve, the
direct-summation density audit, B-field, temperatures, velocities,
kinematics, snapshot write.  Catches preset/config bugs, not performance.

    python scripts/rehearse_preset.py <1..5> [ntotal=...] [wvt_max_iter=...]
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "configs"))

from toycluster import STOCK_PAR, parse_par_file  # noqa: E402
from toycluster.pipeline import make_ics         # noqa: E402
from run_configs import PRESETS                      # noqa: E402


def main():
    idx = int(sys.argv[1])
    overrides = dict(kv.split("=", 1) for kv in sys.argv[2:])
    for k, v in overrides.items():
        try:
            overrides[k] = int(v)
        except ValueError:
            try:
                overrides[k] = float(v)
            except ValueError:
                pass
    preset = {**PRESETS[idx], **overrides}
    preset.setdefault("wvt_max_iter", 4)
    if not preset["output_file"].startswith("/"):
        preset["output_file"] = "/tmp/" + preset["output_file"]
    cfg = parse_par_file(STOCK_PAR, **preset)

    def log(stage, **kw):
        print(f"{stage}: " + " ".join(
            f"{k}={v}" for k, v in kw.items() if k != "scene"), flush=True)

    scene, parts = make_ics(cfg, log=log, check=True)
    print(f"rehearsal OK: config {idx}, {parts.n_gas} gas, "
          f"{cfg.output_file}")


if __name__ == "__main__":
    main()
