"""Pallas kernels (Triton route) for the O(N^2) density-clustering sweeps.

GPU re-design of the reference CUDA kernels
(src/density_clustering_cuda_kernels.cu) with the repository's exact
bounding-box tile pruning on top:

  * ``pops_sweep``  -- multi-radius population counts
    (kernel analog: population_count, :9-56)
  * ``nn_sweep``    -- joint NN + NN-higher-density lexicographic minima
    (kernel analog: nearest_neighbor_search, :58-130)
  * ``label_sweep`` -- neighbor-min label proposals for the screening
    connected-components fixpoint (kernel analog: screening, :132-192)

Design (one program per row block, as the reference's one thread per row
frame and one block per row tile):

  * Coordinates are stored transposed, (D, N_pad), so loads along the
    frame axis coalesce. A program owns ``row_block`` row frames, keeps
    their coordinates and running reductions in registers, and walks its
    run of the row-sorted active-tile list (CSR offsets computed on the
    device from ``tile_i``; the program loads its own column-block
    indices). Each active (row_block x col_block) tile is swept in
    register-sized column sub-tiles.
  * Distances are fp32 ``diff * diff + acc`` in ascending dimension
    order, which the compiler contracts to one fma per dimension like the
    reference kernel (:46). There is no matrix product, so TF32 never
    enters (see ops/pairwise.py for why the ||x||^2 + ||y||^2 - 2xy
    identity is rejected).
  * The label sweep is bidirectional: it evaluates each unordered pair
    once over an upper-triangular tile list; the row side reduces in
    registers, the column side goes straight to a full-length output
    with int32 ``atomic_min``, which commutes, so results stay exact and
    deterministic. Population counts sweep the full tile list:
    their column side would need ``atomic_add``, which lost updates in
    this Triton build and saved only 3% when measured at 2^20 frames.
  * Every ``pallas_call`` names the Triton route; on the CPU (tests) the
    same kernels run in the Pallas interpreter, never on the GPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

DEFAULT_ROW_BLOCK = 128
DEFAULT_COL_BLOCK = 4096

# (column sub-tile width, warps per program) of each sweep: every running
# reduction is an elementwise (row_block x sub) register tile, reduced
# over the row once per program. Picked by a sweep over sub in {16, 32,
# 64} x warps in {4, 8} at 2^20 frames on an H100 (wider sub-tiles spill
# registers and ran up to 25x slower).
_POPS_TILING = (16, 4)
_NN_TILING = (16, 8)
_LABEL_TILING = (32, 4)

_IMAX = np.int32(np.iinfo(np.int32).max)
_INF = np.float32(np.inf)


def INTERPRET_MODE():
    """True on the CPU backend, where the kernels run in the Pallas
    interpreter (tests). Resolved at call time: touching the backend at
    import would break jax.distributed.initialize(), which must run
    before any XLA backend call."""
    return jax.default_backend() == "cpu"


# backend that "auto" picks on the GPU: the Triton sweeps beat the plain
# XLA path end to end at 2^20 frames on an H100 (measured per stage by
# chip_smoke.py; numbers in CHANGES.md)
GPU_BACKEND = "pallas"


def resolve_backend(backend="auto"):
    """The one place "auto" is decided: "xla" on the CPU, the measured
    winner on the GPU; any other platform raises. Explicit "pallas" or
    "xla" pass through."""
    if backend != "auto":
        if backend not in ("pallas", "xla"):
            raise ValueError(f"unknown backend {backend!r}")
        return backend
    platform = jax.default_backend()
    if platform == "cpu":
        return "xla"
    if platform == "gpu":
        return GPU_BACKEND
    raise RuntimeError(f"no kernel backend for platform {platform!r}"
                       " (supported: cpu, gpu)")


def _params(num_warps):
    return plgpu.CompilerParams(num_warps=num_warps, num_stages=1)


def _sub_width(col_block, sub):
    sub = min(sub, col_block)
    if col_block % sub or sub & (sub - 1):
        raise ValueError(f"col_block {col_block} must be a multiple of a"
                         f" power-of-two sub-tile ({sub})")
    return sub


def _check_row_block(row_block):
    if row_block & (row_block - 1):
        raise ValueError(f"row_block {row_block} must be a power of two")


def _csr(tile_i, n_row_blocks):
    """(n_row_blocks + 1,) int32 offsets of each row block's run in a
    tile list sorted by ``tile_i`` (entries with tile_i >= n_row_blocks
    are never visited)."""
    return jnp.searchsorted(
        tile_i, jnp.arange(n_row_blocks + 1, dtype=jnp.int32),
        side="left").astype(jnp.int32)


def _flat(a):
    return jnp.asarray(a, dtype=jnp.int32).reshape(-1)


def _dist2(xs, y_ref, c0, sub):
    """(row_block, sub) squared distances of the program's rows (``xs``,
    one (row_block,) vector per dimension) to columns [c0, c0 + sub)."""
    acc = jnp.zeros((xs[0].shape[0], sub), dtype=jnp.float32)
    for k, x in enumerate(xs):
        diff = x[:, None] - y_ref[k, pl.ds(c0, sub)][None, :]
        acc = diff * diff + acc
    return acc


def _not_repeat(tj_ref, t, start):
    """False for a tile that repeats the previous entry of the same row
    block's run (repeat-padded lists): min reductions are idempotent, so
    the repeat is skipped instead of recomputed."""
    prev = tj_ref[jnp.maximum(t - 1, 0)]
    return (t == start) | (prev != tj_ref[t])


# ---------------------------------------------------------------------------
# populations
# ---------------------------------------------------------------------------

def _pops_kernel(nv_ref, off_ref, tj_ref, rm_ref, x_ref, y_ref, r2_ref,
                 out_ref, *, row_block, col_block, sub, n_dim, n_radii):
    i = pl.program_id(0)
    row0 = i * row_block
    xs = [x_ref[k, pl.ds(row0, row_block)] for k in range(n_dim)]
    nv = nv_ref[0]
    r2 = [r2_ref[r] for r in range(n_radii)]

    def tile(t, acc):
        j = tj_ref[t]
        m = rm_ref[t]

        def sweep(acc):
            def step(s, acc):
                c0 = j * col_block + s * sub
                d2 = _dist2(xs, y_ref, c0, sub)
                ok = (c0 + jax.lax.broadcasted_iota(jnp.int32, (1, sub), 1)
                      < nv)
                # elementwise running counts: the row reduction runs once
                # per program, not once per sub-tile
                return tuple(
                    acc[r] + (ok & (d2 <= r2[r])
                              & (((m >> r) & 1) != 0)).astype(jnp.int32)
                    for r in range(n_radii))

            return jax.lax.fori_loop(0, col_block // sub, step, acc)

        # rmask 0 = no-op pad (tj = -1) or no radius admitted
        return jax.lax.cond(m != 0, sweep, lambda a: a, acc)

    acc0 = tuple(jnp.zeros((row_block, sub), jnp.int32)
                 for _ in range(n_radii))
    acc = jax.lax.fori_loop(off_ref[i], off_ref[i + 1], tile, acc0)
    for r in range(n_radii):
        out_ref[r, pl.ds(row0, row_block)] = jnp.sum(acc[r], axis=1)


@functools.partial(jax.jit, static_argnames=("row_block", "col_block"))
def pops_sweep(rows_t, cols_t, radii2, n_valid, tile_i, tile_j, rmask=None,
               row_block=DEFAULT_ROW_BLOCK, col_block=DEFAULT_COL_BLOCK):
    """Multi-radius population counts over a row-sorted active-tile list.

    Args:
      rows_t: (D, R_pad) fp32 transposed row frames.
      cols_t: (D, N_pad) fp32 transposed column frames.
      radii2: (n_radii,) fp32 squared radii.
      n_valid: int32 count of real columns.
      tile_i, tile_j: int32 tile lists of any shape, sorted by tile_i
        once flattened; each active tile exactly once (counts are not
        idempotent). Pads are (any sorted ti, tj = -1) entries.
      rmask: per-tile int32 bitmask (bit r = count radius r in this
        tile; 0 skips the tile). None counts every radius on every entry
        with tj >= 0.
    Returns:
      (n_radii, R_pad) int32 counts of columns with d2 <= r^2, self
      included.
    """
    _check_row_block(row_block)
    sub, warps = _POPS_TILING
    sub = _sub_width(col_block, sub)
    n_dim, r_pad = rows_t.shape
    n_radii = radii2.shape[0]
    nrb = r_pad // row_block
    ti, tj = _flat(tile_i), _flat(tile_j)
    if rmask is None:
        rm = jnp.where(tj >= 0, jnp.int32((1 << n_radii) - 1), 0)
    else:
        rm = jnp.where(tj >= 0, _flat(rmask), 0)
    kernel = functools.partial(
        _pops_kernel, row_block=row_block, col_block=col_block, sub=sub,
        n_dim=n_dim, n_radii=n_radii)
    return pl.pallas_call(
        kernel, grid=(nrb,),
        out_shape=jax.ShapeDtypeStruct((n_radii, r_pad), jnp.int32),
        compiler_params=_params(warps), backend="triton",
        interpret=INTERPRET_MODE(), name="pops_sweep",
    )(jnp.asarray(n_valid, jnp.int32).reshape(1), _csr(ti, nrb),
      jnp.maximum(tj, 0), rm, rows_t, cols_t,
      jnp.asarray(radii2, jnp.float32))


# ---------------------------------------------------------------------------
# nearest neighbors
# ---------------------------------------------------------------------------

def _lex_update(d_old, j_old, d_new, j_new):
    """Running lexicographic (distance, original index) minimum; an
    infinite distance never latches an index (no neighbor stays
    (inf, IMAX) for the callers)."""
    upd = (((d_new < d_old) | ((d_new == d_old) & (j_new < j_old)))
           & (d_new < _INF))
    return jnp.where(upd, d_new, d_old), jnp.where(upd, j_new, j_old)


def _nn_kernel(nv_ref, off_ref, tj_ref, x_ref, fe_x_ref, y_ref, fe_y_ref,
               oid_ref, out_d_ref, out_j_ref,
               *, row_block, col_block, sub, n_dim):
    i = pl.program_id(0)
    start = off_ref[i]
    row0 = i * row_block
    xs = [x_ref[k, pl.ds(row0, row_block)] for k in range(n_dim)]
    fe_x = fe_x_ref[0, pl.ds(row0, row_block)][:, None]
    nv = nv_ref[0]

    def tile(t, carry):
        j = tj_ref[t]

        def sweep(carry):
            def step(s, carry):
                nd, nj, hd, hj = carry
                c0 = j * col_block + s * sub
                d2 = _dist2(xs, y_ref, c0, sub)
                col_ids = c0 + jax.lax.broadcasted_iota(
                    jnp.int32, (1, sub), 1)
                oid = jnp.broadcast_to(oid_ref[0, pl.ds(c0, sub)][None, :],
                                       (row_block, sub))
                # zero-distance pairs (self, exact duplicates) excluded
                # like the reference's dist2 != 0 guard
                d2n = jnp.where((col_ids < nv) & (d2 > 0.0), d2, _INF)
                nd, nj = _lex_update(nd, nj, d2n, oid)
                fe_y = fe_y_ref[0, pl.ds(c0, sub)][None, :]
                hd, hj = _lex_update(hd, hj,
                                     jnp.where(fe_y < fe_x, d2n, _INF), oid)
                return nd, nj, hd, hj

            return jax.lax.fori_loop(0, col_block // sub, step, carry)

        return jax.lax.cond(_not_repeat(tj_ref, t, start), sweep,
                            lambda c: c, carry)

    # elementwise running lexicographic minima over (row, sub-column)
    # slots; the row reduction runs once per program
    inf = jnp.full((row_block, sub), _INF, jnp.float32)
    imax = jnp.full((row_block, sub), _IMAX, jnp.int32)
    nd, nj, hd, hj = jax.lax.fori_loop(start, off_ref[i + 1], tile,
                                       (inf, imax, inf, imax))
    for q, (d, jj) in enumerate(((nd, nj), (hd, hj))):
        best = jnp.min(d, axis=1)
        out_d_ref[q, pl.ds(row0, row_block)] = best
        out_j_ref[q, pl.ds(row0, row_block)] = jnp.min(
            jnp.where(d == best[:, None], jj, _IMAX), axis=1)


@functools.partial(jax.jit, static_argnames=("row_block", "col_block"))
def nn_sweep(rows_t, fe_rows, cols_t, fe_cols, orig_ids, n_valid, tile_i,
             tile_j, row_block=DEFAULT_ROW_BLOCK,
             col_block=DEFAULT_COL_BLOCK):
    """Joint NN / NN-higher-density search of ``rows_t`` against the
    ``cols_t`` frame set over a row-sorted active-tile list (repeats of
    the previous entry are skipped, so lists may be repeat-padded).

    Args:
      rows_t: (D, R_pad) fp32 transposed row frames (any frame order).
      fe_rows: (1, R_pad) fp32 free energies of the row frames.
      cols_t: (D, N_pad) fp32 transposed column frames.
      fe_cols: (1, N_pad) fp32 free energies (+inf on padded columns).
      orig_ids: (1, N_pad) int32 original frame index of each column:
        ties break toward the smallest original index (the reference's
        ascending-j strict '<' scan) and the index outputs report it.
      n_valid: int32 count of real columns.
    Returns:
      (out_d, out_j): (2, R_pad) stacked [nh; hd] squared distances and
      original indices; (+inf, IMAX) where no admissible neighbor lies in
      the listed tiles.
    """
    _check_row_block(row_block)
    sub, warps = _NN_TILING
    sub = _sub_width(col_block, sub)
    n_dim, r_pad = rows_t.shape
    nrb = r_pad // row_block
    ti, tj = _flat(tile_i), _flat(tile_j)
    kernel = functools.partial(_nn_kernel, row_block=row_block,
                               col_block=col_block, sub=sub, n_dim=n_dim)
    return pl.pallas_call(
        kernel, grid=(nrb,),
        out_shape=[jax.ShapeDtypeStruct((2, r_pad), jnp.float32),
                   jax.ShapeDtypeStruct((2, r_pad), jnp.int32)],
        compiler_params=_params(warps), backend="triton",
        interpret=INTERPRET_MODE(), name="nn_sweep",
    )(jnp.asarray(n_valid, jnp.int32).reshape(1), _csr(ti, nrb), tj,
      rows_t, fe_rows, cols_t, fe_cols, orig_ids)


# ---------------------------------------------------------------------------
# screening label sweep
# ---------------------------------------------------------------------------

def _label_kernel(sc_ref, md2_ref, off_ref, tj_ref, dcol_ref, drow_ref,
                  x_ref, y_ref, lab_ref, _col_in_ref, out_ref, col_ref, *,
                  row_block, col_block, sub, n_dim, masked_atomics):
    i = pl.program_id(0)
    start = off_ref[i]
    row0 = i * row_block
    n_below = sc_ref[0]
    md2 = md2_ref[0]
    xs = [x_ref[k, pl.ds(row0, row_block)] for k in range(n_dim)]
    row_ok = (row0 + jax.lax.broadcasted_iota(
        jnp.int32, (row_block, 1), 0)) < n_below
    lab_x = lab_ref[pl.ds(row0, row_block)][:, None]
    row_dirty = drow_ref[i] != 0

    def tile(t, m):
        j = tj_ref[t]

        def sweep(m):
            def step(s, m):
                c0 = j * col_block + s * sub
                d2 = _dist2(xs, y_ref, c0, sub)
                col_ids = c0 + jax.lax.broadcasted_iota(
                    jnp.int32, (1, sub), 1)
                adj = (d2 < md2) & (col_ids < n_below) & row_ok
                lab_y = lab_ref[pl.ds(c0, sub)][None, :]
                m = jnp.minimum(m, jnp.where(adj, lab_y, _IMAX))
                cm = jnp.min(jnp.where(adj, lab_x, _IMAX), axis=0)
                plgpu.atomic_min(
                    col_ref, (pl.ds(c0, sub),), cm,
                    mask=(cm != _IMAX) if masked_atomics else None)
                return m

            return jax.lax.fori_loop(0, col_block // sub, step, m)

        # a tile whose row and column labels did not change since the
        # previous sweep can only re-propose equivalences already folded
        # into the union
        dirty = (dcol_ref[j] != 0) | row_dirty
        return jax.lax.cond(dirty & _not_repeat(tj_ref, t, start), sweep,
                            lambda a: a, m)

    # elementwise running minimum; the row reduction runs once
    m = jax.lax.fori_loop(start, off_ref[i + 1], tile,
                          jnp.full((row_block, sub), _IMAX, jnp.int32))
    out_ref[pl.ds(row0, row_block)] = jnp.min(m, axis=1)


@functools.partial(jax.jit, static_argnames=("row_block", "col_block"))
def label_sweep(coords_t, labels, n_below, max_dist2, tile_i, tile_j,
                dirty_col=None, dirty_row=None,
                row_block=DEFAULT_ROW_BLOCK, col_block=DEFAULT_COL_BLOCK):
    """Bidirectional neighbor-min label proposals over a row-sorted
    active-tile list of the FE-ordered frame matrix (repeat-padded lists
    allowed).

    Frames i, j < n_below are adjacent iff d2(i, j) < max_dist2; each
    frame's proposal is the minimum label over its adjacent frames
    (IMAX where none). Each listed tile proposes both ways -- its column
    labels to its rows and its row labels to its columns -- so an
    upper-triangular list covers every unordered pair once (a list that
    also holds the mirror tiles gives the same proposals). ``dirty_col``
    (ncb,) / ``dirty_row`` (nrb,) gate tiles by whether their column or
    row block's labels changed since the previous sweep; None sweeps
    everything.

    Returns (N_pad,) int32 proposals to fold into the labels with a
    minimum.
    """
    _check_row_block(row_block)
    sub, warps = _LABEL_TILING
    sub = _sub_width(col_block, sub)
    n_dim, n_pad = coords_t.shape
    nrb, ncb = n_pad // row_block, n_pad // col_block
    ti, tj = _flat(tile_i), _flat(tile_j)
    if dirty_col is None:
        dirty_col = jnp.ones((ncb,), jnp.int32)
    if dirty_row is None:
        dirty_row = jnp.ones((nrb,), jnp.int32)
    labels = jnp.asarray(labels, jnp.int32).reshape(-1)
    interpret = INTERPRET_MODE()
    kernel = functools.partial(
        _label_kernel, row_block=row_block, col_block=col_block, sub=sub,
        n_dim=n_dim, masked_atomics=not interpret)
    args = [jnp.asarray(n_below, jnp.int32).reshape(1),
            jnp.asarray(max_dist2, jnp.float32).reshape(1),
            _csr(ti, nrb), tj, jnp.asarray(dirty_col, jnp.int32),
            jnp.asarray(dirty_row, jnp.int32), coords_t, coords_t, labels,
            jnp.full((n_pad,), _IMAX, jnp.int32)]
    rows, cols = pl.pallas_call(
        kernel, grid=(nrb,),
        out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.int32)] * 2,
        input_output_aliases={len(args) - 1: 1},
        compiler_params=_params(warps), backend="triton",
        interpret=interpret, name="label_sweep")(*args)
    return jnp.minimum(rows, cols)
