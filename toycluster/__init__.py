"""toycluster — a JAX galaxy-cluster-merger initial-conditions engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
jdonnert/Toycluster (a C99+OpenMP SPH/N-body IC generator): analytic
NFW/beta-model cluster profiles, Hernquist+Eddington dark-matter sampling,
WC6 SPH density with adaptive smoothing lengths, weighted-Voronoi (WVT)
particle regularisation, hydrostatic temperatures, Bonafede+2010 magnetic
fields from a vector potential, merger-orbit kinematics, substructure, and
Gadget-1 snapshot output.

Architecture: host-side float64 NumPy for the tiny analytic setup tables,
device-side jitted/vmapped samplers and a block-sparse Hilbert-sorted
neighbour engine (equal-count particle blocks + bounding-box candidate
search + Pallas/Triton stream kernels on the GPU, fixed-shape XLA pair
operators on the CPU) for all O(N·k) SPH operators.
"""

__version__ = "0.1.0"

import os as _os


def _enable_compilation_cache():
    """Persist XLA compiles across processes.  Where
    JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    set here; otherwise the cache is <checkout>/.jax_cache."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    root = _os.path.realpath(_os.path.join(_os.path.dirname(__file__),
                                           _os.pardir))
    jax.config.update("jax_compilation_cache_dir",
                      _os.path.join(root, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_enable_compilation_cache()

from .config import STOCK_PAR, Config, parse_par_file  # noqa: F401
from .units import Units, units_from_config  # noqa: F401
from .cosmology import Cosmology, cosmology_from_config  # noqa: F401
