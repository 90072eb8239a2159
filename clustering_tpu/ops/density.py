"""Per-frame neighbor populations and free energies.

Equivalent of the reference's population counting
(CPU: src/density_clustering.cpp:126-195, CUDA: src/density_clustering_cuda.cu:45-182
with kernel src/density_clustering_cuda_kernels.cu:9-56) and free-energy
transform (src/density_clustering.cpp:197-212).

Boundary semantics follow the CUDA backend (the reference's validated path):
a frame j counts toward pop_i iff  d2(i, j) <= r^2, *including* j == i
(self-distance 0), so every population is >= 1. The CPU path's strict
``<`` differs only on exact-boundary ties (see SURVEY.md "hard parts" #2).

Multi-radius counts are computed in one sweep over the pair blocks, like the
CUDA kernel's per-radius loop. The row-block kernel ``counts_rows`` is shared
with the sharded multi-device path (clustering_tpu.parallel.sharded).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .pairwise import sq_dists, pad_rows

DEFAULT_ROW_BLOCK = 1024
DEFAULT_COL_BLOCK = 4096


def counts_rows(rows, col_blocks, radii2, n_valid_cols):
    """Per-radius neighbor counts of ``rows`` against all column blocks.

    Args:
      rows: (R, D) query frames.
      col_blocks: (n_col_blocks, C, D) all frames, blocked and padded.
      radii2: (n_radii,) squared radii.
      n_valid_cols: dynamic count of real (unpadded) columns.
    Returns:
      (n_radii, R) int32 counts.
    """
    n_col_blocks, col_block, _ = col_blocks.shape

    def col_step(carry, inp):
        y, i_col = inp
        d2 = sq_dists(rows, y)
        col_ids = i_col * col_block + jax.lax.broadcasted_iota(
            jnp.int32, (1, col_block), 1)
        valid = col_ids < n_valid_cols
        within = (d2[None, :, :] <= radii2[:, None, None]) & valid[None]
        return carry + jnp.sum(within, axis=2, dtype=jnp.int32), None

    init = jnp.zeros((radii2.shape[0], rows.shape[0]), dtype=jnp.int32)
    counts, _ = jax.lax.scan(
        col_step, init,
        (col_blocks, jnp.arange(n_col_blocks, dtype=jnp.int32)))
    return counts


def counts_row_range(coords_rows, coords_cols, radii2, n_valid_cols,
                     row_block, col_block):
    """Counts for a contiguous row range (R_total, D) against all columns
    (N_pad, D), streamed in (row_block x col_block) tiles."""
    n_rows = coords_rows.shape[0]
    n_row_blocks = n_rows // row_block
    col_blocks = coords_cols.reshape(-1, col_block, coords_cols.shape[1])

    def row_fn(i_row):
        x = jax.lax.dynamic_slice_in_dim(coords_rows, i_row * row_block,
                                         row_block, axis=0)
        return counts_rows(x, col_blocks, radii2, n_valid_cols)

    all_counts = jax.lax.map(row_fn, jnp.arange(n_row_blocks,
                                                dtype=jnp.int32))
    return jnp.transpose(all_counts, (1, 0, 2)).reshape(radii2.shape[0],
                                                        n_rows)


@functools.partial(jax.jit, static_argnames=("row_block", "col_block"))
def _populations_padded(coords_padded, radii2, n_valid,
                        row_block=DEFAULT_ROW_BLOCK,
                        col_block=DEFAULT_COL_BLOCK):
    return counts_row_range(coords_padded, coords_padded, radii2, n_valid,
                            row_block, col_block)


def populations(coords, radii,
                row_block=DEFAULT_ROW_BLOCK, col_block=DEFAULT_COL_BLOCK,
                backend="auto", prune=True):
    """Neighbor populations for each radius.

    Args:
      coords: (N, D) float32 array (numpy or jax).
      radii: sequence of radii.
      backend: 'pallas' (Triton tile kernel + bbox pruning), 'xla'
        (blockwise jnp), or 'auto' (ops.pallas_kernels.resolve_backend).
    Returns:
      dict radius -> (N,) int64 numpy array of populations (self included).
    """
    from .pallas_kernels import resolve_backend
    backend = resolve_backend(backend)
    if backend == "pallas":
        from .engine import DensityEngine
        eng = DensityEngine(coords, row_block=row_block,
                            col_block=col_block, backend="pallas")
        return eng.populations(radii, prune=prune)
    coords = jnp.asarray(coords, dtype=jnp.float32)
    n = coords.shape[0]
    block = int(np.lcm(row_block, col_block))
    padded = pad_rows(coords, block)
    radii = list(radii)
    radii2 = jnp.asarray([r * r for r in radii], dtype=jnp.float32)
    counts = _populations_padded(padded, radii2, jnp.int32(n),
                                 row_block=row_block, col_block=col_block)
    counts = np.asarray(jax.device_get(counts))[:, :n].astype(np.int64)
    return {r: counts[i] for i, r in enumerate(radii)}


def free_energies(pops) -> np.ndarray:
    """fe_i = -ln(pop_i / max_pop)  (reference: src/density_clustering.cpp:197-212).

    Computed in fp32 like the reference (float division, float log).
    """
    pops = np.asarray(pops)
    max_pop = np.float32(pops.max())
    ratio = pops.astype(np.float32) / max_pop
    return (-np.log(ratio.astype(np.float32))).astype(np.float32)
