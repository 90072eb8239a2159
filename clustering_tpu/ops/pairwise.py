"""Blockwise pairwise squared-distance primitives.

The N x N frame-pair interaction is the FLOP core of density clustering
(reference hot loops: src/density_clustering.cpp:155-193 [pops],
:256-286 [NN]; CUDA tiles: src/density_clustering_cuda_kernels.cu:9-130).
The N x N matrix is never materialized in device memory: callers stream
column blocks through register- or cache-sized tiles and reduce on the fly.

There is exactly one distance mode: per-dimension accumulation of
(x_d - y_d)^2 in ascending-d order, matching the reference's scalar loop
semantics (the GPU compilers contract each step to one fma, like the
reference CUDA kernel).  The |x|^2 + |y|^2 - 2 x.y matrix-product identity
was evaluated and rejected (see docs/PARITY.md): its cancellation error
~ulp(|x||y|) is comparable to inter-neighbor distance gaps at production
densities (flipped ~4% of pops / ~12% of NN indices in a 1M-frame trial),
it breaks the exact-pruning error budget, and a float32 matrix product may
run in TF32 on the GPU unless precision=HIGHEST.
"""

import jax.numpy as jnp


def sq_dists_exact(x, y):
    """(B, D), (C, D) -> (B, C) squared euclidean distances.

    Per-dimension accumulation in ascending-d order (fp32), mirroring the
    reference inner loop (src/density_clustering.cpp:172-176).
    """
    d = x.shape[1]
    acc = jnp.zeros((x.shape[0], y.shape[0]), dtype=jnp.float32)
    for k in range(d):
        diff = x[:, k][:, None] - y[:, k][None, :]
        acc = acc + diff * diff
    return acc


# the single supported distance mode (see module docstring)
sq_dists = sq_dists_exact


def cdiv(a, b):
    return -(-a // b)


def pad_rows(arr, block, fill=0):
    """Pad axis 0 of ``arr`` up to a multiple of ``block``."""
    n = arr.shape[0]
    n_pad = cdiv(n, block) * block - n
    if n_pad == 0:
        return arr
    widths = [(0, n_pad)] + [(0, 0)] * (arr.ndim - 1)
    return jnp.pad(arr, widths, constant_values=fill)
