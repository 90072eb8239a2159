"""clustering_tpu — a density-based clustering framework for MD data on GPUs.

A from-scratch rebuild of the capabilities of moldyn/Clustering (reference
v1.3.2) in JAX: the O(N^2) density/neighbor/screening kernels run as
pruned Pallas (Triton) or blockwise XLA programs on an NVIDIA GPU, sharded
over a device mesh when there are several;
the O(N) / O(S^2) analysis stages (MPP lumping, coring, noise, network,
filter/stats) are exact host-side implementations that preserve the
reference's file formats and CLI semantics.

Layer map (mirrors reference layering, see SURVEY.md):
  cli        -- mode dispatcher (density/network/mpp/coring/noise/filter/stats)
  models/    -- per-mode drivers (reference: src/*_clustering.cpp main()s)
  ops/       -- device compute: populations, free energy, neighbors, screening
  parallel/  -- mesh construction + shard_map'd multi-device variants
  utils/     -- file formats, provenance metadata, logging
"""

__version__ = "0.1.0"

VERSION_STRING = "v" + __version__

# the API surface loads lazily (PEP 562): importing the package for a
# host-side mode (coring/noise/mpp/...) must not pull jax (multi-second
# import) through api -> ops
_API_NAMES = (
    "populations", "free_energies", "nearest_neighbors",
    "screening_series", "fill_landscape", "mpp_lump", "core_trajectory",
    "assign_noise", "waiting_time_distribution", "Neighborhoods",
    "MppResult", "api", "ops", "models", "parallel", "utils")


def __getattr__(name):
    if name in _API_NAMES:
        if name in ("api", "ops", "models", "parallel", "utils"):
            import importlib
            return importlib.import_module("." + name, __name__)
        from . import api
        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_API_NAMES))
