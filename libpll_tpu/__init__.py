"""libpll_tpu — a phylogenetic likelihood engine in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of libpll
(conditional likelihoods, GTR/empirical models, Γ+I rate heterogeneity,
ascertainment-bias correction, analytic branch-length derivatives, Fitch and
Sankoff parsimony, tree objects/moves/traversals, FASTA/PHYLIP/Newick I/O),
with sites sharded data-parallel across device meshes.  It runs on NVIDIA
GPUs (and on the CPU, where the tests run).

Float64 is the engine's reference precision (like the C library); importing
this package enables jax x64 support. Performance paths use explicit float32.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)
# True-IEEE matmul accumulation: XLA's "default" f32 matmul precision may
# run in TF32 (~1e-3 relative error) on a GPU — unacceptable for a
# likelihood engine whose f32 fast path claims f32 accuracy.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache.  JAX itself reads JAX_COMPILATION_CACHE_DIR;
# without it (and without a directory set before import) the cache lives at
# a fixed path inside the checkout, so that every process of this checkout
# finds what an earlier one compiled.
if _jax.config.jax_compilation_cache_dir is None:
    _cache = _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")
    try:
        _os.makedirs(_cache, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", _cache)
        _jax.config.update("jax_persistent_cache_min_compile_time_secs",
                           2.0)
    except OSError:  # read-only checkout: run without the cache
        pass

from .engine.modelopt import ModelOptResult, optimize_model
from .engine.partition import (ASC_FELSENSTEIN, ASC_LEWIS, ASC_NONE,
                               ASC_STAMATAKIS, Operation, Partition)
from .errors import PllError
from .io import maps
from .models.gamma import compute_gamma_cats
from .utils.constants import (GAMMA_RATES_MEAN, GAMMA_RATES_MEDIAN,
                              SCALE_BUFFER_NONE)

__version__ = "0.1.0"
