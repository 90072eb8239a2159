"""Multi-device (mesh-sharded) density ops via shard_map.

Frame-axis SPMD decomposition of the O(N^2) kernels (see
clustering_tpu.parallel.mesh): the (small, N x D) coordinate matrix is
replicated so column blocks stream from local device memory, and results
merge with XLA collectives (NCCL between GPUs):

  * plain XLA path: every device owns a contiguous row range; populations
    and nearest neighbors all-gather the row-sharded outputs (the
    equivalent of the reference's host-side partial-result merges,
    src/density_clustering_cuda.cu:171-181, 311-327); the screening
    fixpoint keeps the label vector replicated, each sweep updates the
    local row range and an ``all_gather`` exchanges the slices before the
    replicated scatter-min union + pointer jumping (the parallel analog of
    the reference's host merge, src/density_clustering_cuda.cu:501-572).
  * Pallas path: the pruned active-tile list is dealt round-robin over the
    devices (balanced to one tile), each device sweeps its share with the
    same Triton kernel, and partials merge with ``psum`` (counts) or a
    lexicographic / label ``pmin``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..ops import density as dops
from ..ops import neighbors as nops
from ..ops import screening as sops
from .mesh import FRAME_AXIS, fetch, mesh_size, replicated

DEFAULT_ROW_BLOCK = 1024
DEFAULT_COL_BLOCK = 4096


def _pad_block(n, n_dev, row_block, col_block):
    """Padded N: divisible by (n_dev * row_block) and col_block."""
    return int(np.lcm(n_dev * row_block, col_block))


@functools.partial(jax.jit,
                   static_argnames=("mesh", "row_block", "col_block"))
def _pops_sharded(coords_padded, radii2, n_valid, mesh,
                  row_block=DEFAULT_ROW_BLOCK, col_block=DEFAULT_COL_BLOCK):
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(FRAME_AXIS, None), P(None, None), P(None), P()),
        out_specs=P(None, None), check_vma=False)
    def run(rows_shard, coords_all, radii2, n_valid):
        part = dops.counts_row_range(rows_shard, coords_all, radii2,
                                     n_valid, row_block, col_block)
        # replicate so hosts of a multi-process (DCN) mesh can read the
        # result without a cross-host gather
        return jax.lax.all_gather(part, FRAME_AXIS, axis=1, tiled=True)

    return run(coords_padded, coords_padded, radii2, n_valid)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "row_block", "col_block"))
def _pops_sharded_sparse(coords_t_padded, radii2, n_valid, ti_dev, tj_dev,
                         rmask_dev, mesh, row_block=DEFAULT_ROW_BLOCK,
                         col_block=DEFAULT_COL_BLOCK):
    """Mesh-sharded Pallas pops over balanced per-device (n_dev, L) tile
    lists (GLOBAL row/col indices; any device may count any tile).

    Each device produces a full-length partial count vector and the exact
    total is one int32 ``psum`` -- the load-balanced analog of the
    reference's host-side partial sum (density_clustering_cuda.cu:171-181).
    ``rmask_dev`` carries the per-tile radius bitmask (bit r set = count
    radius r in this tile; 0 = pad, skip the tile body)."""
    from ..ops import pallas_kernels as pk

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None, None), P(None), P(),
                  P(FRAME_AXIS, None), P(FRAME_AXIS, None),
                  P(FRAME_AXIS, None)),
        out_specs=P(None, None), check_vma=False)
    def run(ct, radii2, n_valid, ti_l, tj_l, rm_l):
        part = pk.pops_sweep(ct, ct, radii2, n_valid, ti_l[0], tj_l[0],
                             rm_l[0], row_block=row_block,
                             col_block=col_block)
        return jax.lax.psum(part, FRAME_AXIS)

    return run(coords_t_padded, radii2, n_valid, ti_dev, tj_dev, rmask_dev)


def populations(coords, radii, mesh,
                row_block=DEFAULT_ROW_BLOCK, col_block=DEFAULT_COL_BLOCK,
                backend="xla", prune=True):
    """Mesh-sharded multi-radius populations; same semantics as
    clustering_tpu.ops.populations.

    backend='pallas' runs the pruned sparse-tile kernel per device (GPU
    meshes; interpreted on CPU meshes); 'xla' the blockwise jnp kernel.
    """
    coords = np.asarray(coords, dtype=np.float32)
    n = coords.shape[0]
    n_dev = mesh_size(mesh)
    block = _pad_block(n, n_dev, row_block, col_block)
    radii = list(radii)
    radii2 = jnp.asarray([np.float32(r) * np.float32(r) for r in radii],
                         dtype=jnp.float32)
    if backend == "pallas":
        from ..ops import pruning
        order = pruning.morton_order(coords)
        n_pad = -(-n // block) * block
        padded = np.zeros((n_pad, coords.shape[1]), dtype=np.float32)
        padded[:n] = coords[order]
        padded[n:] = np.float32(3e38)
        r_max2 = np.float32(max(radii)) * np.float32(max(radii))
        nrb, ncb = n_pad // row_block, n_pad // col_block
        if prune:
            rmin, rmax = pruning.block_bboxes(padded, row_block)
            cmin, cmax = pruning.block_bboxes(padded, col_block)
            active = pruning.bbox_dist2(rmin, rmax, cmin, cmax) <= r_max2
        else:
            active = np.ones((nrb, ncb), dtype=bool)
        ti, tj = np.nonzero(active)
        ti_dev, tj_dev, _ = pruning.split_tiles_balanced(
            ti, tj, n_dev, pad_mode="noop")
        # pads (tj = -1) carry mask 0 and skip the whole tile body
        rmask_dev = np.where(tj_dev >= 0, np.int32((1 << len(radii)) - 1),
                             np.int32(0))
        counts = _pops_sharded_sparse(
            replicated(padded.T, mesh), radii2, jnp.int32(n),
            replicated(ti_dev, mesh), replicated(tj_dev, mesh),
            replicated(rmask_dev, mesh), mesh,
            row_block=row_block, col_block=col_block)
        counts = fetch(counts)[:, :n]
        unsorted = np.empty_like(counts)
        unsorted[:, order] = counts
        return {r: unsorted[i].astype(np.int64)
                for i, r in enumerate(radii)}
    n_pad = -(-n // block) * block
    padded_np = np.zeros((n_pad, coords.shape[1]), dtype=np.float32)
    padded_np[:n] = coords
    padded = replicated(padded_np, mesh)
    counts = _pops_sharded(padded, radii2, jnp.int32(n), mesh,
                           row_block=row_block, col_block=col_block)
    counts = fetch(counts)[:, :n].astype(np.int64)
    return {r: counts[i] for i, r in enumerate(radii)}


def _pmin_lex(d, j):
    """Exact lexicographic (d, j) minimum across the mesh: pmin on the
    distances, then pmin on the indices that achieve them."""
    d_min = jax.lax.pmin(d, FRAME_AXIS)
    j_cand = jnp.where(d == d_min, j, jnp.int32(2**31 - 1))
    return d_min, jax.lax.pmin(j_cand, FRAME_AXIS)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "row_block", "col_block"))
def _nn_sharded_sparse(coords_t_padded, fe_padded, oid_padded, n_valid,
                       ti_dev, tj_dev, mesh,
                       row_block=DEFAULT_ROW_BLOCK,
                       col_block=DEFAULT_COL_BLOCK):
    """Mesh-sharded Pallas NN over balanced per-device (n_dev, L) tile
    lists (GLOBAL indices). Per-device full-length partials (unvisited
    rows stay +inf/IMAX) merge with an exact lexicographic (d, j) minimum
    -- the load-balanced analog of the reference's overwrite-merge
    (density_clustering_cuda.cu:311-327). The outer jit matters: an
    un-jitted shard_map dispatches its body op by op."""
    from ..ops import pallas_kernels as pk

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None, None), P(None, None), P(None, None), P(),
                  P(FRAME_AXIS, None), P(FRAME_AXIS, None)),
        out_specs=(P(None, None), P(None, None)),
        check_vma=False)
    def run(ct, fe_all, oid_all, n_valid, ti_l, tj_l):
        d_loc, j_loc = pk.nn_sweep(ct, fe_all, ct, fe_all, oid_all, n_valid,
                                   ti_l[0], tj_l[0], row_block=row_block,
                                   col_block=col_block)
        return _pmin_lex(d_loc, j_loc)

    return run(coords_t_padded, fe_padded, oid_padded, n_valid,
               ti_dev, tj_dev)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "row_block", "col_block",
                                    "union_size"))
def _screening_sharded_pallas(coords_t, labels0, n_below, max_dist2,
                              ti_dev, tj_dev, mesh,
                              row_block=DEFAULT_ROW_BLOCK,
                              col_block=DEFAULT_COL_BLOCK,
                              union_size=None):
    """Mesh-sharded sparse-tile screening fixpoint over balanced
    per-device (n_dev, L) upper-triangular tile lists (GLOBAL indices;
    any device may sweep any tile).

    Each sweep: every device sweeps its tiles, one int32 ``pmin`` merges
    the proposals, then the scatter-min union + pointer jumping run
    replicated -- the parallel analog of the reference's host merge
    (src/density_clustering_cuda.cu:501-572). ``union_size`` (static,
    multiple of col_block, >= n_below) bounds the union to the prefix
    that can actually change, exactly as in the single-device fixpoint
    (ops/screening.py::_sparse_fixpoint).
    """
    from ..ops import pallas_kernels as pk
    from ..ops.screening import _dirty_blocks, union_rebase

    n_pad = coords_t.shape[1]
    ncb = n_pad // col_block
    nrb = n_pad // row_block
    if union_size is None:
        union_size = n_pad

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None, None), P(None), P(), P(),
                  P(FRAME_AXIS, None), P(FRAME_AXIS, None)),
        out_specs=P(None), check_vma=False)
    def run(ct, labels0, nb, md2, ti_l, tj_l):
        ti, tj = ti_l[0], tj_l[0]

        def cond(state):
            return state[1]

        def body(state):
            labels_in, _, dirty_col, dirty_row = state
            prop = pk.label_sweep(ct, labels_in, nb, md2, ti, tj,
                                  dirty_col, dirty_row, row_block=row_block,
                                  col_block=col_block)
            prop = jax.lax.pmin(prop, FRAME_AXIS)
            head_in = labels_in[:union_size]
            head_out = union_rebase(head_in,
                                    jnp.minimum(head_in, prop[:union_size]))
            changed = head_out != head_in
            labels_out = (head_out if union_size == n_pad else
                          jnp.concatenate([head_out,
                                           labels_in[union_size:]]))
            # clean blocks can only re-propose known equivalences
            return (labels_out, jnp.any(changed),
                    _dirty_blocks(changed, col_block, ncb),
                    _dirty_blocks(changed, row_block, nrb))

        labels, _, _, _ = jax.lax.while_loop(
            cond, body, (labels0, jnp.bool_(True),
                         jnp.ones((ncb,), dtype=jnp.int32),
                         jnp.ones((nrb,), dtype=jnp.int32)))
        return labels

    return run(coords_t, labels0, n_below, max_dist2, ti_dev, tj_dev)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "row_block", "col_block"))
def _nn_sharded(coords_padded, fe_padded, n_valid, mesh,
                row_block=DEFAULT_ROW_BLOCK, col_block=DEFAULT_COL_BLOCK):
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(FRAME_AXIS, None), P(FRAME_AXIS), P(None, None),
                  P(None), P()),
        out_specs=(P(None), P(None), P(None), P(None)), check_vma=False)
    def run(rows_shard, fe_shard, coords_all, fe_all, n_valid):
        parts = nops.nn_row_range(rows_shard, fe_shard, coords_all, fe_all,
                                  n_valid, row_block, col_block)
        return tuple(jax.lax.all_gather(p, FRAME_AXIS, tiled=True)
                     for p in parts)

    return run(coords_padded, fe_padded, coords_padded, fe_padded, n_valid)


def nearest_neighbors(coords, free_energy, mesh,
                      row_block=DEFAULT_ROW_BLOCK,
                      col_block=DEFAULT_COL_BLOCK,
                      backend="xla", prune=True, band_blocks=4):
    """Mesh-sharded joint NN / NN-higher-density search; same semantics as
    clustering_tpu.ops.nearest_neighbors. backend='pallas' uses the fused
    pruned tile kernel per shard (Morton layout, banded bounding pass)."""
    if backend == "pallas":
        return _nearest_neighbors_pallas_mesh(coords, free_energy, mesh,
                                              row_block, col_block,
                                              prune, band_blocks)
    coords = np.asarray(coords, dtype=np.float32)
    fe = np.asarray(free_energy, dtype=np.float32)
    n = coords.shape[0]
    block = _pad_block(n, mesh_size(mesh), row_block, col_block)
    n_pad = -(-n // block) * block
    padded_np = np.zeros((n_pad, coords.shape[1]), dtype=np.float32)
    padded_np[:n] = coords
    fe_np = np.full(n_pad, np.inf, dtype=np.float32)
    fe_np[:n] = fe
    nh_d, nh_j, hd_d, hd_j = _nn_sharded(replicated(padded_np, mesh),
                                         replicated(fe_np, mesh),
                                         jnp.int32(n),
                                         mesh, row_block=row_block,
                                         col_block=col_block)
    nh_d, nh_j, hd_d, hd_j = fetch((nh_d, nh_j, hd_d, hd_j))
    nh_d = nh_d[:n]
    nh_j = nh_j[:n].astype(np.int64)
    hd_d = hd_d[:n]
    hd_j = hd_j[:n].astype(np.int64)
    no_nh = ~np.isfinite(nh_d)
    nh_d[no_nh] = 0.0
    nh_j[no_nh] = 0
    no_hd = ~np.isfinite(hd_d)
    hd_d[no_hd] = 0.0
    hd_j[no_hd] = 0
    return nh_j, nh_d.astype(np.float32), hd_j, hd_d.astype(np.float32)


def _nearest_neighbors_pallas_mesh(coords, free_energy, mesh, row_block,
                                   col_block, prune, band_blocks):
    from ..ops import pruning

    coords = np.asarray(coords, dtype=np.float32)
    fe = np.asarray(free_energy, dtype=np.float32)
    n = coords.shape[0]
    n_dev = mesh_size(mesh)
    block = _pad_block(n, n_dev, row_block, col_block)
    n_pad = -(-n // block) * block
    order = pruning.morton_order(coords)
    padded = np.zeros((n_pad, coords.shape[1]), dtype=np.float32)
    padded[:n] = coords[order]
    padded[n:] = np.float32(3e38)
    fe_padded = np.full(n_pad, np.inf, dtype=np.float32)
    fe_padded[:n] = fe[order]
    oid = np.full(n_pad, np.iinfo(np.int32).max, dtype=np.int32)
    oid[:n] = order
    ct = replicated(padded.T, mesh)
    fe_dev = replicated(fe_padded.reshape(1, n_pad), mesh)
    oid_dev = replicated(oid.reshape(1, n_pad), mesh)
    nrb, ncb = n_pad // row_block, n_pad // col_block

    def run(active):
        ti, tj = np.nonzero(active)
        ti_dev, tj_dev, _ = pruning.split_tiles_balanced(
            ti, tj, n_dev, pad_mode="repeat")
        return _nn_sharded_sparse(ct, fe_dev, oid_dev, jnp.int32(n),
                                  replicated(ti_dev, mesh),
                                  replicated(tj_dev, mesh), mesh,
                                  row_block=row_block, col_block=col_block)

    if prune and ncb > 2 * band_blocks:
        out1 = run(pruning.band_mask(nrb, ncb, row_block, col_block,
                                     band_blocks * col_block))
        out1_d = fetch(out1[0])
        row_ub = np.maximum(out1_d[0], out1_d[1]).reshape(
            nrb, row_block).max(axis=1)
        rmin, rmax = pruning.block_bboxes(padded, row_block)
        cmin, cmax = pruning.block_bboxes(padded, col_block)
        active = pruning.bbox_dist2(rmin, rmax, cmin, cmax) \
            <= row_ub[:, None]
    else:
        active = np.ones((nrb, ncb), dtype=bool)
    out = run(active)
    out_d, out_j = fetch((out[0], out[1]))
    nh_d, hd_d = out_d[0, :n], out_d[1, :n]
    nh_j = out_j[0, :n].astype(np.int64)
    hd_j = out_j[1, :n].astype(np.int64)
    inv = np.empty_like(order)
    inv[order] = np.arange(n)
    nh_d, nh_j = nh_d[inv], nh_j[inv]
    hd_d, hd_j = hd_d[inv], hd_j[inv]
    no_nh = ~np.isfinite(nh_d)
    nh_d[no_nh] = 0.0
    nh_j[no_nh] = 0
    no_hd = ~np.isfinite(hd_d)
    hd_d[no_hd] = 0.0
    hd_j[no_hd] = 0
    return nh_j, nh_d.astype(np.float32), hd_j, hd_d.astype(np.float32)


@functools.partial(jax.jit,
                   static_argnames=("mesh", "row_block", "col_block"))
def _screening_sharded(coords_sorted, labels0, n_below, max_dist2, mesh,
                       row_block=DEFAULT_ROW_BLOCK,
                       col_block=DEFAULT_COL_BLOCK):
    n_pad = coords_sorted.shape[0]
    n_dev = mesh_size(mesh)
    n_local = n_pad // n_dev

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None, None), P(None), P(), P()),
        out_specs=P(None), check_vma=False)
    def run(coords_all, labels0, n_below, max_dist2):
        offset = jax.lax.axis_index(FRAME_AXIS).astype(jnp.int32) * n_local

        def outer_cond(state):
            _, changed = state
            return changed

        def outer_body(state):
            labels_in, _ = state
            labels_cur = sops.sweep_row_range(
                coords_all, labels_in, offset, n_local, n_below, max_dist2,
                row_block, col_block)
            local = jax.lax.dynamic_slice_in_dim(labels_cur, offset,
                                                 n_local, axis=0)
            full = jax.lax.all_gather(local, FRAME_AXIS, tiled=True)
            labels_out = sops.union_rebase(labels_in, full)
            return (labels_out, jnp.any(labels_out != labels_in))

        labels, _ = jax.lax.while_loop(outer_cond, outer_body,
                                       (labels0, jnp.bool_(True)))
        return labels

    return run(coords_sorted, labels0, n_below, max_dist2)


def screening_labels(coords_sorted, initial_labels, n_below, max_dist2,
                     mesh, row_block=DEFAULT_ROW_BLOCK,
                     col_block=DEFAULT_COL_BLOCK, backend="xla"):
    """Mesh-sharded screening fixpoint; same semantics as
    clustering_tpu.ops.screening_labels. backend='pallas' distributes
    sparse active-tile sweeps over the mesh."""
    coords_sorted = np.asarray(coords_sorted, dtype=np.float32)
    n = coords_sorted.shape[0]
    n_dev = mesh_size(mesh)
    block = _pad_block(n, n_dev, row_block, col_block)
    n_pad = -(-n // block) * block
    labels = np.asarray(initial_labels, dtype=np.int32)
    if n_pad != n:
        labels = np.concatenate(
            [labels, np.arange(n, n_pad, dtype=np.int32)])
    if backend == "pallas":
        from ..ops import pruning
        padded = np.zeros((n_pad, coords_sorted.shape[1]),
                          dtype=np.float32)
        padded[:n] = coords_sorted
        padded[n:] = np.float32(3e38)
        rmin, rmax = pruning.block_bboxes(padded, row_block)
        cmin, cmax = pruning.block_bboxes(padded, col_block)
        d2b = pruning.bbox_dist2(rmin, rmax, cmin, cmax)
        nrb, ncb = d2b.shape
        ri = np.arange(nrb)[:, None]
        cj = np.arange(ncb)[None, :]
        # upper-triangular tiles for the bidirectional sweep: every
        # unordered admissible pair lies in the kept (rowblock(min),
        # colblock(max)) tile
        active = ((d2b < np.float32(max_dist2))
                  & (ri * row_block < n_below) & (cj * col_block < n_below)
                  & ((cj + 1) * col_block > ri * row_block))
        ti, tj = np.nonzero(active)
        # devices with no active tiles redundantly re-sweep tile (0, 0)
        # -- harmless under the idempotent min ('repeat' pad mode)
        ti_dev, tj_dev, _ = pruning.split_tiles_balanced(
            ti, tj, n_dev, pad_mode="repeat")
        out = _screening_sharded_pallas(
            replicated(padded.T, mesh), replicated(labels, mesh),
            jnp.int32(n_below),
            jnp.float32(max_dist2), replicated(ti_dev, mesh),
            replicated(tj_dev, mesh), mesh,
            row_block=row_block, col_block=col_block,
            union_size=n_pad)
        return fetch(out)[:n]
    padded_np = np.zeros((n_pad, coords_sorted.shape[1]), dtype=np.float32)
    padded_np[:n] = coords_sorted
    out = _screening_sharded(replicated(padded_np, mesh),
                             replicated(labels, mesh),
                             jnp.int32(n_below),
                             jnp.float32(max_dist2), mesh,
                             row_block=row_block, col_block=col_block)
    return fetch(out)[:n]
