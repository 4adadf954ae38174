"""Command-line driver: ``python -m toycluster <parfile> [flag=value...]``

Replaces ``./Toycluster cluster.par`` (main.c:11-72).  Compile-time flags of
the reference Makefile are runtime options here, e.g.::

    python -m toycluster cluster.par beta=0.54 orbit=comet ntotal=100000
"""

from __future__ import annotations

import sys

from .config import parse_par_file
from .pipeline import make_ics


def _coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Usage: python -m toycluster <parameterfile> [field=value...]",
              file=sys.stderr)
        return 1
    overrides = {}
    for tok in argv[1:]:
        k, _, v = tok.partition("=")
        overrides[k] = _coerce(v)
    cfg = parse_par_file(argv[0], **overrides)
    make_ics(cfg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
