"""betacores_tpu — JAX framework for robust Bayesian coreset construction
(capabilities of dionman/beta-cores, WSDM 2021), run on a GPU.

Public API mirrors the reference's exports (reference:
bayesiancoresets/__init__.py, coreset/__init__.py, snnls/__init__.py) so a
reference user can switch with minimal changes, while everything underneath
is jit-compiled static-shape JAX.
"""

from .utils.cache import enable_persistent_cache

# A headline build program takes tens of seconds to compile; cache compiled
# programs across processes (utils/cache.py says where). Opt out with
# BETACORES_NO_COMPILATION_CACHE=1.
enable_persistent_cache()

from . import coresets, inference, models, ops, snnls, utils
from .coresets import (
    BatchPSVICoreset,
    BetaBlackBoxProjector,
    BetaCoreset,
    BlackBoxProjector,
    DiffPrivBatchPSVICoreset,
    HilbertCoreset,
    SparseVICoreset,
    UniformSamplingCoreset,
    select_beta,
    trimmed_mean,
)
from .utils import NumericalPrecisionError, set_tolerance, set_verbosity

__version__ = "0.1.0"

__all__ = [
    "coresets",
    "inference",
    "models",
    "ops",
    "snnls",
    "utils",
    "BatchPSVICoreset",
    "BetaBlackBoxProjector",
    "BetaCoreset",
    "BlackBoxProjector",
    "HilbertCoreset",
    "SparseVICoreset",
    "UniformSamplingCoreset",
    "NumericalPrecisionError",
    "select_beta",
    "set_tolerance",
    "set_verbosity",
    "trimmed_mean",
]
