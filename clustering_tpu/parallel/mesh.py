"""Device-mesh construction helpers.

The framework scales over a 1-D mesh on the frame axis: the O(N^2) pair
interactions are split over the devices (row ranges on the plain XLA path,
balanced active-tile shares on the Pallas path), the replacement for the
reference's multi-GPU row-range decomposition
(src/density_clustering_cuda.cu:139-182) and MPI triangular balance
(src/density_clustering_mpi.cpp:59-77). Collectives (psum-style count
merges, pmin / all_gather label exchange) go to NCCL between GPUs, which
NVLink joins all to all, so the mesh follows the algorithm alone; there is
no rank-0 special-casing -- the program is SPMD throughout.
"""

import numpy as np

import jax

FRAME_AXIS = "frames"


def make_mesh(n_devices=None, devices=None):
    """1-D mesh over the frame axis.

    Args:
      n_devices: use the first n devices (default: all).
      devices: explicit device list (overrides n_devices).
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return jax.sharding.Mesh(np.asarray(devices), (FRAME_AXIS,))


def mesh_size(mesh) -> int:
    return int(np.prod(list(mesh.shape.values())))


def replicated(x, mesh):
    """Place a host array on the mesh fully replicated.

    Uses an explicit NamedSharding so the placement is valid on
    multi-host (DCN) meshes as well -- a plain ``jnp.asarray`` commits to
    the process-local default device, which a multi-process jit rejects.
    """
    spec = jax.sharding.PartitionSpec(*([None] * np.ndim(x)))
    return jax.device_put(x, jax.sharding.NamedSharding(mesh, spec))


def fetch(x):
    """Fully-replicated device array(s) -> host numpy, multi-process
    safe. Accepts a pytree: one ready-barrier for the whole tree, then
    transfers queued back-to-back.

    Every process holds a complete copy of a replicated output, so one
    addressable shard is the whole array (no cross-host gather needed).
    """
    x = jax.block_until_ready(x)

    def _one(a):
        if (jax.process_count() == 1
                or not hasattr(a, "addressable_shards")):
            return np.array(jax.device_get(a))  # writable copy
        return np.array(a.addressable_shards[0].data)

    return jax.tree_util.tree_map(_one, x)
