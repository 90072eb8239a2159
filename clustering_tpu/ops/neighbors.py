"""Joint nearest-neighbor + nearest-higher-density-neighbor search.

Equivalent of the reference NN search
(CPU: src/density_clustering.cpp:230-288, CUDA kernel:
src/density_clustering_cuda_kernels.cu:58-130). One blockwise sweep produces
both neighbor lists:

  nh[i]   = argmin_{j} d2(i, j)   over  {j : d2(i, j) > 0}
  nhhd[i] = argmin_{j} d2(i, j)   over  {j : d2(i, j) > 0 and fe[j] < fe[i]}

Ties break toward the smallest j (both reference backends scan j ascending
with a strict '<' update). Zero-distance pairs (exact duplicate frames) are
excluded, following the CUDA backend's ``dist2 != 0`` guard; when a frame has
no admissible neighbor, (index, dist) = (0, 0.0), matching the CUDA
backend's zero-initialized output buffers (src/density_clustering_cuda.cu:209-215).

The row-block kernel ``nn_rows`` is shared with the sharded multi-device path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .pairwise import sq_dists, pad_rows

DEFAULT_ROW_BLOCK = 1024
DEFAULT_COL_BLOCK = 4096

# numpy scalar: a jnp constant here would initialize the XLA
# backend at import time, breaking jax.distributed.initialize()
_INF = np.float32(np.inf)


def nn_rows(rows, fe_rows, col_blocks, fe_col_blocks, n_valid_cols):
    """Running (dist, index) minima of ``rows`` against all column blocks.

    Returns (nh_d, nh_j, hd_d, hd_j), each (R,). Distances are +inf when no
    admissible neighbor exists (callers map that to (0, 0.0)).
    """
    n_col_blocks, col_block, _ = col_blocks.shape
    row_block = rows.shape[0]

    def col_step(carry, inp):
        nh_d, nh_j, hd_d, hd_j = carry
        y, fe_y, i_col = inp
        d2 = sq_dists(rows, y)
        col_ids = i_col * col_block + jax.lax.broadcasted_iota(
            jnp.int32, (row_block, col_block), 1)
        valid = (col_ids < n_valid_cols) & (d2 > 0.0)
        d2_nh = jnp.where(valid, d2, _INF)
        bj = jnp.argmin(d2_nh, axis=1)
        bd = jnp.take_along_axis(d2_nh, bj[:, None], axis=1)[:, 0]
        bj_glob = bj.astype(jnp.int32) + i_col * col_block
        upd = bd < nh_d
        nh_d = jnp.where(upd, bd, nh_d)
        nh_j = jnp.where(upd, bj_glob, nh_j)
        d2_hd = jnp.where(fe_y[None, :] < fe_rows[:, None], d2_nh, _INF)
        hj = jnp.argmin(d2_hd, axis=1)
        hd = jnp.take_along_axis(d2_hd, hj[:, None], axis=1)[:, 0]
        hj_glob = hj.astype(jnp.int32) + i_col * col_block
        updh = hd < hd_d
        hd_d = jnp.where(updh, hd, hd_d)
        hd_j = jnp.where(updh, hj_glob, hd_j)
        return (nh_d, nh_j, hd_d, hd_j), None

    init = (jnp.full((row_block,), _INF),
            jnp.zeros((row_block,), dtype=jnp.int32),
            jnp.full((row_block,), _INF),
            jnp.zeros((row_block,), dtype=jnp.int32))
    carry, _ = jax.lax.scan(
        col_step, init,
        (col_blocks, fe_col_blocks,
         jnp.arange(n_col_blocks, dtype=jnp.int32)))
    return carry


def nn_row_range(coords_rows, fe_rows, coords_cols, fe_cols, n_valid_cols,
                 row_block, col_block):
    """NN search for a contiguous row range against all columns."""
    n_rows = coords_rows.shape[0]
    n_row_blocks = n_rows // row_block
    col_blocks = coords_cols.reshape(-1, col_block, coords_cols.shape[1])
    fe_blocks = fe_cols.reshape(-1, col_block)

    def row_fn(i_row):
        x = jax.lax.dynamic_slice_in_dim(coords_rows, i_row * row_block,
                                         row_block, axis=0)
        fe_x = jax.lax.dynamic_slice_in_dim(fe_rows, i_row * row_block,
                                            row_block, axis=0)
        return nn_rows(x, fe_x, col_blocks, fe_blocks, n_valid_cols)

    nh_d, nh_j, hd_d, hd_j = jax.lax.map(
        row_fn, jnp.arange(n_row_blocks, dtype=jnp.int32))
    return (nh_d.reshape(-1), nh_j.reshape(-1),
            hd_d.reshape(-1), hd_j.reshape(-1))


@functools.partial(jax.jit, static_argnames=("row_block", "col_block"))
def _nn_padded(coords_padded, fe_padded, n_valid,
               row_block=DEFAULT_ROW_BLOCK, col_block=DEFAULT_COL_BLOCK):
    return nn_row_range(coords_padded, fe_padded, coords_padded, fe_padded,
                        n_valid, row_block, col_block)


def nearest_neighbors(coords, free_energy,
                      row_block=DEFAULT_ROW_BLOCK,
                      col_block=DEFAULT_COL_BLOCK,
                      backend="auto", prune=True):
    """Returns (nh_idx, nh_d2, nhhd_idx, nhhd_d2) as numpy arrays of len N."""
    from .pallas_kernels import resolve_backend
    backend = resolve_backend(backend)
    if backend == "pallas":
        from .engine import DensityEngine
        eng = DensityEngine(coords, row_block=row_block,
                            col_block=col_block, backend="pallas")
        return eng.nearest_neighbors(free_energy, prune=prune)
    coords = jnp.asarray(coords, dtype=jnp.float32)
    fe = jnp.asarray(free_energy, dtype=jnp.float32)
    n = coords.shape[0]
    block = int(np.lcm(row_block, col_block))
    padded = pad_rows(coords, block)
    # padded rows get fe = +inf so they never qualify as lower-fe neighbors
    fe_padded = pad_rows(fe, block, fill=np.inf)
    nh_d, nh_j, hd_d, hd_j = _nn_padded(padded, fe_padded, jnp.int32(n),
                                        row_block=row_block,
                                        col_block=col_block)
    nh_d = np.array(jax.device_get(nh_d))[:n]
    nh_j = np.array(jax.device_get(nh_j))[:n].astype(np.int64)
    hd_d = np.array(jax.device_get(hd_d))[:n]
    hd_j = np.array(jax.device_get(hd_j))[:n].astype(np.int64)
    # frames without admissible neighbor -> (0, 0.0) like the CUDA backend
    no_nh = ~np.isfinite(nh_d)
    nh_d[no_nh] = 0.0
    nh_j[no_nh] = 0
    no_hd = ~np.isfinite(hd_d)
    hd_d[no_hd] = 0.0
    hd_j[no_hd] = 0
    return nh_j, nh_d.astype(np.float32), hd_j, hd_d.astype(np.float32)


def compute_sigma2(nh_dist) -> float:
    """Mean squared NN distance (reference: src/density_clustering.cpp:334-343,
    double accumulation)."""
    return float(np.mean(np.asarray(nh_dist, dtype=np.float64)))
