"""Free-energy screening: density-connected microstate assignment.

Replacement for the reference's screening stage. Semantics follow
the CUDA backend (src/density_clustering_cuda.cu:396-594 with kernel
src/density_clustering_cuda_kernels.cu:132-192), which the reference
validated manually: the frames whose free energy lies below the threshold
(the first ``n_below`` frames in FE-sorted order) are partitioned into the
connected components of the graph

    i ~ j  iff  d2(i, j) < max_dist2 (= 4 * sigma^2)

with previously-assigned cluster labels acting as permanent equivalences
(seeded restarts re-use the previous threshold's clustering,
src/density_clustering.cpp:806-817).

Instead of the reference's host-side fixpoint loop with device label sweeps
and host pointer-chasing merges (CUDA: one host<->device label round-trip per
iteration), the whole fixpoint runs on-device inside one ``lax.while_loop``:

  1. a neighbor-min sweep (the plain XLA path: Gauss-Seidel over row
     blocks so min labels propagate within a sweep; the Pallas path: one
     pruned-tile kernel pass per sweep),
  2. a label-table scatter-min union (the parallel equivalent of the
     reference's ``merge_results`` pointer-chase + dict rebase,
     src/density_clustering_cuda.cu:348-394, 557-571),
  3. pointer-jumping compression of the label table.

Labels are int32 frame pointers in FE-sorted index space with the invariant
label[i] <= i; a component's final label is the smallest sorted-index of its
members, which reproduces the reference's name-assignment order.

``sweep_row_range`` and ``union_rebase`` are shared with the sharded
multi-device path (clustering_tpu.parallel.sharded).
"""

import functools
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from .pairwise import sq_dists
from ..utils.logger import is_verbose, log_warm_failure, logger

DEFAULT_ROW_BLOCK = 128
DEFAULT_COL_BLOCK = 4096

# numpy scalar: a jnp constant here would initialize the XLA
# backend at import time, breaking jax.distributed.initialize()
_IMAX = np.int32(np.iinfo(np.int32).max)


def sweep_row_range(coords_all, labels, row_offset, n_rows_local, n_below,
                    max_dist2, row_block, col_block):
    """Gauss-Seidel neighbor-min sweep over rows
    [row_offset, row_offset + n_rows_local).

    ``coords_all`` is the full padded (N_pad, D) FE-sorted frame matrix and
    ``labels`` the full (N_pad,) label vector; only local rows below
    ``n_below`` are updated. Returns the updated full label vector.
    """
    n_local_blocks = n_rows_local // row_block
    n_active = jnp.clip((n_below - row_offset + row_block - 1) // row_block,
                        0, n_local_blocks)
    n_col_blocks = (n_below + col_block - 1) // col_block

    def row_body(i_row, labels_cur):
        row0 = row_offset + i_row * row_block
        x = jax.lax.dynamic_slice_in_dim(coords_all, row0, row_block, axis=0)
        lab_x = jax.lax.dynamic_slice_in_dim(labels_cur, row0, row_block,
                                             axis=0)
        row_ids = row0 + jax.lax.broadcasted_iota(
            jnp.int32, (row_block, 1), 0)[:, 0]

        def col_body(i_col, m):
            col0 = i_col * col_block
            y = jax.lax.dynamic_slice_in_dim(coords_all, col0, col_block,
                                             axis=0)
            lab_y = jax.lax.dynamic_slice_in_dim(labels_cur, col0, col_block,
                                                 axis=0)
            d2 = sq_dists(x, y)
            col_ids = col0 + jax.lax.broadcasted_iota(
                jnp.int32, (row_block, col_block), 1)
            adj = (d2 < max_dist2) & (col_ids < n_below)
            cand = jnp.where(adj, lab_y[None, :], _IMAX)
            return jnp.minimum(m, jnp.min(cand, axis=1))

        m = jax.lax.fori_loop(0, n_col_blocks, col_body,
                              jnp.full((row_block,), _IMAX, dtype=jnp.int32))
        new_lab = jnp.where(row_ids < n_below,
                            jnp.minimum(lab_x, m), lab_x)
        return jax.lax.dynamic_update_slice_in_dim(labels_cur, new_lab,
                                                   row0, axis=0)

    return jax.lax.fori_loop(0, n_active, row_body, labels)


def pointer_jump(table):
    """Compress label chains until table == table[table].

    One gather per iteration: the convergence test reuses the body's
    doubled table instead of re-gathering in the loop condition."""
    def cond(state):
        return state[1]

    def body(state):
        m, _ = state
        m2 = m[m]
        return (m2, jnp.any(m2 != m))

    out, _ = jax.lax.while_loop(cond, body, (table, jnp.bool_(True)))
    return out


def union_rebase(labels_in, labels_cur):
    """Label-granularity union: all frames sharing a pre-sweep label are
    rebased to the minimum post-sweep label proposed for it (parallel
    equivalent of the reference dict-rebase,
    src/density_clustering_cuda.cu:557-571)."""
    iota = jnp.arange(labels_in.shape[0], dtype=jnp.int32)
    table = iota.at[labels_in].min(labels_cur)
    table = pointer_jump(table)
    return table[labels_in]


@functools.partial(jax.jit, static_argnames=("row_block", "col_block"))
def _screening_fixpoint(coords_sorted, labels0, n_below, max_dist2,
                        row_block=DEFAULT_ROW_BLOCK,
                        col_block=DEFAULT_COL_BLOCK):
    """Run the connected-component fixpoint on one device.

    Args:
      coords_sorted: (N_pad, D) fp32, frames in FE-ascending order (padded).
      labels0: (N_pad,) int32 initial frame-pointer labels, labels0[i] <= i.
      n_below: dynamic int32, number of in-play frames (FE below threshold).
      max_dist2: dynamic fp32 squared linking distance.
    Returns:
      (N_pad,) int32 final labels (component = min member sorted-index).
    """
    n_pad = coords_sorted.shape[0]

    def outer_cond(state):
        return state[1]

    def outer_body(state):
        labels_in, _, it = state
        labels_cur = sweep_row_range(coords_sorted, labels_in, 0, n_pad,
                                     n_below, max_dist2,
                                     row_block, col_block)
        labels_out = union_rebase(labels_in, labels_cur)
        return (labels_out, jnp.any(labels_out != labels_in), it + 1)

    labels, _, iters = jax.lax.while_loop(
        outer_cond, outer_body, (labels0, jnp.bool_(True), jnp.int32(0)))
    return labels, iters


@jax.jit
def _first_occ(tile_i, tile_j):
    """int32 mask over a flat tile list marking the first occurrence of
    each tile (repeat pads carry 0) -- the unit of the swept-tile
    accounting."""
    same = jnp.concatenate(
        [jnp.zeros((1,), jnp.bool_),
         (tile_i[1:] == tile_i[:-1]) & (tile_j[1:] == tile_j[:-1])])
    return (~same).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("row_block", "col_block"))
def _screen_active_device(below, n_below, row_lo, row_block, col_block):
    """Device twin of _tile_list_host's mask algebra: the bbox strict-<
    plane restricted to the FE-threshold prefix, the new-frame cross
    (``row_lo`` > 0) and the upper triangle. ``n_below``/``row_lo`` are
    traced, so one compiled program serves every step of a threshold
    series."""
    nrb, ncb = below.shape
    ri = jnp.arange(nrb, dtype=jnp.int32)[:, None]
    cj = jnp.arange(ncb, dtype=jnp.int32)[None, :]
    active = below & (ri * row_block < n_below) & (cj * col_block < n_below)
    cross = ((ri + 1) * row_block > row_lo) | ((cj + 1) * col_block > row_lo)
    active = active & jnp.where(row_lo > 0, cross, True)
    return active & ((cj + 1) * col_block > ri * row_block)


def _dirty_blocks(changed, block, n_blocks):
    """(n_blocks,) int32 flags of the blocks holding a changed label
    (``changed`` covers the union prefix; blocks past it stay clean)."""
    head = jnp.any(changed.reshape(-1, block), axis=1).astype(jnp.int32)
    if head.shape[0] == n_blocks:
        return head
    return jnp.concatenate(
        [head, jnp.zeros(n_blocks - head.shape[0], jnp.int32)])


@functools.partial(jax.jit,
                   static_argnames=("row_block", "col_block", "union_size"))
def _sparse_fixpoint(coords_t, labels0, n_below, max_dist2, tile_i, tile_j,
                     row_block, col_block, union_size):
    """On-device fixpoint over sparse-tile sweeps: each iteration is one
    label_sweep over the whole flat tile list, then the scatter-min
    union + pointer jumping + convergence test; everything stays on the
    device inside one while_loop.

    ``union_size`` (static, a multiple of col_block, >= n_below) bounds the
    label-table union to the prefix that can actually change: sweeps only
    update rows below n_below and only propose labels < n_below, so the
    tail passes through untouched. The caller quantizes it to keep compile
    variety bounded. The list is upper-triangular and each tile proposes
    both ways (label_sweep), so every unordered pair is evaluated once.

    A tile whose column and row blocks' labels did not change in the
    previous sweep can only re-propose equivalences already in the union,
    so the kernel skips it (exact, not a heuristic).

    Returns (labels, sweep count, total tiles actually swept across all
    sweeps -- the dirty-gated measured compute, not an upper bound)."""
    from .pallas_kernels import label_sweep

    n_pad = coords_t.shape[1]
    ncb = n_pad // col_block
    nrb = n_pad // row_block
    first = _first_occ(tile_i, tile_j)

    def cond(state):
        return state[1]

    def body(state):
        labels_in, _, it, dirty_col, dirty_row, swept = state
        gate = (dirty_col[tile_j] != 0) | (dirty_row[tile_i] != 0)
        # float32 accumulator: accounting only, can pass int32 at big N
        swept = swept + jnp.sum((first * gate).astype(jnp.float32))
        prop = label_sweep(coords_t, labels_in, n_below, max_dist2,
                           tile_i, tile_j, dirty_col, dirty_row,
                           row_block=row_block, col_block=col_block)
        head_in = labels_in[:union_size]
        head_out = union_rebase(head_in,
                                jnp.minimum(head_in, prop[:union_size]))
        changed = head_out != head_in
        labels_out = (head_out if union_size == n_pad else
                      jnp.concatenate([head_out, labels_in[union_size:]]))
        return (labels_out, jnp.any(changed), it + 1,
                _dirty_blocks(changed, col_block, ncb),
                _dirty_blocks(changed, row_block, nrb), swept)

    labels, _, iters, _, _, swept = jax.lax.while_loop(
        cond, body, (labels0, jnp.bool_(True), jnp.int32(0),
                     jnp.ones((ncb,), dtype=jnp.int32),
                     jnp.ones((nrb,), dtype=jnp.int32), jnp.float32(0)))
    return labels, iters, swept


class ScreeningEngine:
    """Re-usable screening runner for a threshold series: pads and uploads
    the FE-sorted coordinates once and caches the (threshold-independent)
    block bounding boxes. Backend 'pallas' runs an on-device fixpoint
    over sparse active-tile sweeps; 'xla' uses the blockwise jnp
    while_loop; 'auto' picks by platform (pallas_kernels.resolve_backend).
    """

    def __init__(self, coords_sorted, row_block=DEFAULT_ROW_BLOCK,
                 col_block=DEFAULT_COL_BLOCK, backend="auto", mesh=None):
        from .pallas_kernels import resolve_backend
        self.backend = resolve_backend(backend)
        self.mesh = mesh
        self.row_block = row_block
        self.col_block = col_block
        coords_sorted = np.asarray(coords_sorted, dtype=np.float32)
        self.n = coords_sorted.shape[0]
        if mesh is not None:
            from ..parallel.mesh import mesh_size
            self._n_dev = mesh_size(mesh)
            block = int(np.lcm(self._n_dev * row_block, col_block))
        else:
            self._n_dev = 1
            block = int(np.lcm(row_block, col_block))
        self.n_pad = -(-self.n // block) * block
        padded = np.zeros((self.n_pad, coords_sorted.shape[1]),
                          dtype=np.float32)
        padded[:self.n] = coords_sorted
        padded[self.n:] = np.float32(3e38)
        self._padded_host = padded
        dev = padded.T if self.backend == "pallas" else padded
        if mesh is not None:
            from ..parallel.mesh import replicated
            self._coords_dev = replicated(dev, mesh)
        else:
            self._coords_dev = jnp.asarray(dev)
        self._bbox_d2_dev = None
        self._bbox_mask = None  # (max_dist2, strict-< tile mask)
        self._below_dev = None  # (max_dist2, device strict-< bool plane)
        # per-step tile lists of a series, keyed (row_lo, n_below,
        # max_dist2, device): the precompile daemon and the real step
        # plan the same lists
        self._tile_cache = {}
        # serializes the plan caches between the main thread and the
        # series' compile-prefetch daemon
        self._plan_lock = threading.Lock()
        self.last_stats = {}  # sweep/tile accounting of the last fixpoint

    # big-N device planning: same gate as the density engine's
    # (CLUSTERING_TPU_DEVICE_PLAN=1/0 forces on/off, auto above
    # DEVICE_PLAN_MIN_FRAMES padded frames). Above the gate the host
    # planner's (nrb, ncb) masks, packed-plane download and np.nonzero
    # over the tile matrix dominate the stage.
    DEVICE_PLAN_MIN_FRAMES = 1 << 22

    # at most this many steps' tile lists stay cached (device lists hold
    # device memory)
    TILE_CACHE_CAP = 4

    def _device_plan_on(self):
        env = os.environ.get("CLUSTERING_TPU_DEVICE_PLAN")
        if env == "0":
            return False
        if env == "1":
            return True
        return self.n_pad >= self.DEVICE_PLAN_MIN_FRAMES

    def _bbox_d2(self):
        if self._bbox_d2_dev is None:
            from . import pruning
            ct = (self._coords_dev if self.backend == "pallas"
                  and self.mesh is None
                  else jnp.asarray(self._padded_host.T))
            self._bbox_d2_dev = pruning.bbox_d2_device(
                ct, row_block=self.row_block, col_block=self.col_block)
        return self._bbox_d2_dev

    def _below_plane_dev(self, max_dist2):
        """Device-resident strict-< bbox activity plane (series-constant:
        one plane serves every threshold step)."""
        from . import pruning
        key = float(max_dist2)
        if self._below_dev is None or self._below_dev[0] != key:
            below = pruning.le_planes_device(
                self._bbox_d2(),
                jnp.asarray([np.float32(max_dist2)], dtype=jnp.float32),
                strict=True)[0]
            self._below_dev = (key, below)
        return self._below_dev[1]

    def _tile_list(self, row_lo, n_below, max_dist2, device=False):
        """Memoized per series step: the precompile daemon and the real
        step ask for the same list."""
        key = (int(row_lo), int(n_below), float(max_dist2), bool(device))
        with self._plan_lock:
            if key not in self._tile_cache:
                build = (self._tile_list_dev if device
                         else self._tile_list_host)
                self._tile_cache[key] = build(row_lo, n_below, max_dist2)
                while len(self._tile_cache) > self.TILE_CACHE_CAP:
                    self._tile_cache.pop(next(iter(self._tile_cache)))
            return self._tile_cache[key]

    def _tile_list_dev(self, row_lo, n_below, max_dist2):
        """Device-planned tile list: the activity mask and the list stay
        ON DEVICE (pruning.tile_list_device); the only planning transfer
        is the scalar tile count. Same tile set and row-major order as
        the host planner."""
        from . import pruning
        active = _screen_active_device(
            self._below_plane_dev(max_dist2), jnp.int32(n_below),
            jnp.int32(row_lo), self.row_block, self.col_block)
        return pruning.tile_list_device(active,
                                        pruning.tile_count_device(active))

    def _tile_list_host(self, row_lo, n_below, max_dist2):
        """Active tiles: bbox distance below the linking distance, at least
        partly below the FE threshold, touching the new-frame cross when
        ``row_lo`` > 0, and intersecting the upper triangle (col range
        reaching past the row range's start): every unordered admissible
        pair (r, c), r < c, lies in the kept tile (rowblock(r),
        colblock(c)), and the bidirectional sweep proposes both ways, so
        the mirrored tiles are redundant -- ~2x fewer distance
        evaluations. Row-major sorted; repeat-padded to a power of two so
        a handful of compiled sizes serve the whole series."""
        from . import pruning
        rb, cb = self.row_block, self.col_block
        key = float(max_dist2)
        if self._bbox_mask is None or self._bbox_mask[0] != key:
            # bbox distances on device, packed-bit download; max_dist2 is
            # series-constant, so one mask serves every threshold step
            below = pruning.active_masks_device(
                self._bbox_d2(), [np.float32(max_dist2)], strict=True)[0]
            self._bbox_mask = (key, below)
        active_lt = self._bbox_mask[1]
        nrb, ncb = active_lt.shape
        ri = np.arange(nrb)[:, None]
        cj = np.arange(ncb)[None, :]
        active = active_lt \
            & (ri * rb < n_below) & (cj * cb < n_below)
        if row_lo > 0:
            active &= ((ri + 1) * rb > row_lo) | ((cj + 1) * cb > row_lo)
        active &= (cj + 1) * cb > ri * rb
        return pruning.tile_list(active, pad_mode="repeat")

    def run_device(self, labels_dev, n_below, max_dist2, row_lo=0):
        """Like :meth:`run` but with device-resident (N_pad,) int32 labels
        in and out -- a threshold series seeds each step directly from the
        previous fixpoint without host round-trips."""
        if self.backend == "pallas":
            t_plan0 = time.perf_counter()
            union_size = self._union_size(n_below)
            dev_plan = self.mesh is None and self._device_plan_on()
            tiles = self._tile_list(row_lo, n_below, max_dist2,
                                    device=dev_plan)
            if tiles is None:
                return labels_dev
            if self.mesh is not None:
                from ..parallel import sharded
                from ..parallel.mesh import replicated
                ti_dev, tj_dev = self._split_tiles_per_device(*tiles)
                return sharded._screening_sharded_pallas(
                    self._coords_dev, labels_dev, jnp.int32(n_below),
                    jnp.float32(max_dist2), replicated(ti_dev, self.mesh),
                    replicated(tj_dev, self.mesh), self.mesh,
                    row_block=self.row_block, col_block=self.col_block,
                    union_size=union_size)
            ti, tj = (jnp.asarray(t) for t in tiles)
            t_plan = time.perf_counter() - t_plan0
            t_disp0 = time.perf_counter()
            out, iters, swept = _sparse_fixpoint(
                self._coords_dev, labels_dev, jnp.int32(n_below),
                jnp.float32(max_dist2), ti, tj,
                row_block=self.row_block, col_block=self.col_block,
                union_size=union_size)
            plan_kind = "device" if dev_plan else "host"
            tiles_per_sweep = int(ti.shape[0])
            # swept_tiles is the dirty-gated count of tiles the kernel
            # actually computed; tiles_per_sweep x sweeps the upper
            # bound. iters/swept stay DEVICE scalars unless verbose:
            # converting here would sync on the fixpoint and stop the
            # host from pipelining the next series step's dispatches
            # behind it; consumers coerce after their timed region.
            if is_verbose():
                iters = int(iters)
                swept = float(swept)
                logger(f"    [screening fixpoint: {iters} sweeps,"
                       f" {tiles_per_sweep} tiles/sweep,"
                       f" {swept:.0f} swept, {plan_kind} plan]")
            self.last_stats = {
                "sweeps": iters,
                "tiles_per_sweep": tiles_per_sweep,
                "swept_tiles": swept,
                "tile_pairs": self.row_block * self.col_block,
                "plan": plan_kind,
                # sub-stage walls: t_plan = tile-list planning, t_dispatch
                # = the fixpoint call's host wall (returns asynchronously);
                # the device-done wait + label download + normalize are
                # measured by the series postlude
                # (ThresholdSeriesScreener._postlude) without breaking the
                # step pipeline
                "t_plan": t_plan,
                "t_dispatch": time.perf_counter() - t_disp0,
            }
            return out
        if self.mesh is not None:
            from ..parallel import sharded
            from ..parallel.mesh import replicated
            return sharded._screening_sharded(
                replicated(self._padded_host, self.mesh), labels_dev,
                jnp.int32(n_below), jnp.float32(max_dist2), self.mesh,
                row_block=self.row_block, col_block=self.col_block)
        out, _ = _screening_fixpoint(
            self._coords_dev, labels_dev, jnp.int32(n_below),
            jnp.float32(max_dist2),
            row_block=self.row_block, col_block=self.col_block)
        return out

    def run(self, initial_labels, n_below, max_dist2, row_lo=0):
        """``row_lo`` > 0 marks a threshold-series continuation: the first
        row_lo FE-sorted frames are known to carry a completed fixpoint at
        the same max_dist2, so sweeps can restrict to edges incident to
        the new frames."""
        labels = np.asarray(initial_labels, dtype=np.int32)
        if self.n_pad != self.n:
            labels = np.concatenate(
                [labels, np.arange(self.n, self.n_pad, dtype=np.int32)])
        out = self.run_device(self._upload(labels), n_below, max_dist2,
                              row_lo=row_lo)
        return self._fetch(out)[:self.n]

    def _union_size(self, n_below):
        """Union prefix: power-of-two col-block count >= n_below keeps the
        scatter/gather arrays small at low thresholds while bounding
        compile variety."""
        nub = 1 << int(np.ceil(np.log2(
            max(-(-n_below // self.col_block), 1))))
        return min(nub * self.col_block, self.n_pad)

    def _upload(self, labels):
        """Host labels -> device, replicated over the mesh when present
        (multi-process safe)."""
        if self.mesh is not None:
            from ..parallel.mesh import replicated
            return replicated(np.asarray(labels), self.mesh)
        return jnp.asarray(labels)

    def _fetch(self, labels_dev):
        if self.mesh is not None:
            from ..parallel.mesh import fetch
            return fetch(labels_dev)
        return np.asarray(jax.device_get(labels_dev))

    def _split_tiles_per_device(self, ti, tj):
        """Balance the global tile list round-robin over devices (the
        mesh sweep merges proposals with a pmin, so any device may sweep
        any tile; min-label sweeps are idempotent, so repeat-padding is
        safe). Keeps GLOBAL row-block indices."""
        from . import pruning
        ti_dev, tj_dev, _ = pruning.split_tiles_balanced(
            ti, tj, self._n_dev, pad_mode="repeat")
        return ti_dev, tj_dev


@jax.jit
def _seed_update(labels, seeds, lo):
    """Write hd-edge seed labels into the device-resident vector at
    dynamic offset ``lo`` (one fused dispatch)."""
    return jax.lax.dynamic_update_slice(labels, seeds, (lo,))


@functools.partial(jax.jit, static_argnames=("fetch_len", "nbytes"))
def _labels_prefix_packed(labels_dev, fetch_len, nbytes):
    """Admitted-prefix label download, narrowed by VALUE range: every
    label in [:fetch_len] is a component min-position (or identity pad)
    < fetch_len, so the int32 vector packs loss-lessly into ``nbytes``
    uint8 byte planes (2 when fetch_len <= 2^16, 3 <= 2^24) -- half /
    three-quarters the postlude's label transfer. Returns (nbytes,
    fetch_len) uint8; the host ORs the planes back."""
    lab = labels_dev[:fetch_len]
    return jnp.stack([(lab >> (8 * b)) & 0xFF
                      for b in range(nbytes)]).astype(jnp.uint8)


class ThresholdSeriesScreener:
    """Screening runner specialized for a known -T threshold series.

    Frames are laid out in (threshold-band, Morton) order: the prefix below
    every series threshold stays contiguous (band k == frames first
    admitted at threshold t_k, bit-exact with the fe <= t comparison), while
    Morton ordering inside each band keeps tile bounding boxes spatially
    tight -- so the bbox pruning that makes the pops kernel fast applies to
    the screening sweeps as well (FE order scatters frames across basins
    and defeats it). Cluster naming still follows the reference exactly:
    components are ranked by their minimal FE-sorted frame rank
    (reference: density_clustering.cpp:437-456 over FE order).
    """

    def __init__(self, coords, free_energy, thresholds,
                 row_block=DEFAULT_ROW_BLOCK, col_block=DEFAULT_COL_BLOCK,
                 backend="auto", mesh=None, hd_neighbors=None):
        from . import pruning
        coords = np.asarray(coords, dtype=np.float32)
        fe = np.asarray(free_energy, dtype=np.float32)
        self.thresholds = [np.float32(t) for t in thresholds]
        if any(a >= b for a, b in zip(self.thresholds,
                                      self.thresholds[1:])):
            # the band layout (searchsorted below) silently miscounts on
            # unsorted or duplicate thresholds
            raise ValueError("thresholds must be strictly ascending, got "
                             f"{[float(t) for t in self.thresholds]}")
        n = len(fe)
        # band k = first series threshold at or above this frame's fe
        band = np.searchsorted(self.thresholds, fe, side="left")
        morton = np.argsort(pruning.morton_order(coords), kind="stable")
        # order: by band, then morton rank (stable)
        self.order = np.lexsort((morton, band))
        self.n_below_per_band = np.cumsum(
            np.bincount(band, minlength=len(self.thresholds) + 1)
        )[:len(self.thresholds)]
        # FE-sorted rank of every frame (for reference-order naming)
        fe_order = np.argsort(fe, kind="stable")
        self.fe_rank = np.empty(n, dtype=np.int64)
        self.fe_rank[fe_order] = np.arange(n)
        # series positions listed in FE-ascending frame order: the prefix
        # filter (< nb) walks any step's admitted frames by FE rank, so
        # per-component min ranks fall out of one unique(return_index)
        self._series_rank = np.empty(n, dtype=np.int64)
        self._series_rank[self.order] = np.arange(n)
        self._fe_asc_pos = self._series_rank[fe_order]
        self.engine = ScreeningEngine(coords[self.order],
                                      row_block=row_block,
                                      col_block=col_block, backend=backend,
                                      mesh=mesh)
        self.n = n
        self._prev_nb = 0
        self._labels_dev = None
        self._last_out = None
        self._last_future = None
        # hd_neighbors = (hd_idx, hd_dist2) per original frame from the NN
        # stage: a frame's nearest-higher-density edge below 4*sigma^2 is a
        # genuine screening-graph edge whose endpoint is always admitted
        # first (strictly lower fe), so newly-admitted frames can seed
        # their labels with it -- components are unchanged, the fixpoint
        # just starts mostly converged (the insight behind the reference
        # CPU path's lump_initial_clusters, density_clustering.cpp:506).
        self._hd_pos = None
        # per-step engine stats dicts of the current series run (the
        # postlude worker fills in t_wait/t_fetch/t_norm as each step
        # drains); bench.py aggregates them into the screening stage's
        # sub-stage breakdown
        self.per_step_stats = []
        if hd_neighbors is not None:
            self.set_hd_neighbors(hd_neighbors)

    def set_hd_neighbors(self, hd_neighbors):
        """Attach the NN stage's nearest-higher-density edges after
        construction. Everything else in ``__init__`` depends only on
        (coords, fe, thresholds), so the CLI builds the screener on a
        worker thread WHILE the NN stage runs on device and attaches
        the hd edges here once they exist."""
        hd_j = np.asarray(hd_neighbors[0], dtype=np.int64)
        hd_d = np.asarray(hd_neighbors[1], dtype=np.float32)
        self._hd_pos = (self._series_rank[hd_j[self.order]]
                        .astype(np.int32))
        self._hd_d = hd_d[self.order]

    def precompile(self, max_dist2):
        """Best-effort warm of every step's fixpoint program.

        Each step's tile-list shape and union size are fully determined by
        (fe, thresholds, max_dist2) -- all known at construction -- so a
        daemon thread can plan every step and compile its fixpoint
        program (jit.lower().compile(): zero device execution, and the
        compiled program serves the later jit call) ahead of the steps.
        The CLI runs this DURING the NN stage with an ESTIMATED max_dist2
        (the band phase's nh bound mean, within ~1% of the real sigma2):
        the programs are keyed on quantized shapes, not the threshold
        value, so a near-miss estimate still hits the same compiled
        programs. Shared plan caches are guarded by the engine's plan
        lock. A failed warm is logged under -v and never raises."""
        try:
            eng = self.engine
            if eng.backend != "pallas" or eng.mesh is not None:
                return
            dev_plan = eng._device_plan_on()
            prev = 0
            for k in range(len(self.thresholds)):
                nb = int(self.n_below_per_band[k])
                row_lo, prev = prev, nb
                if nb <= row_lo:
                    continue
                union = eng._union_size(nb)
                fetch_len = min(union, eng.n_pad)
                nbytes = (2 if fetch_len <= (1 << 16)
                          else 3 if fetch_len <= (1 << 24) else 4)
                ident = jnp.arange(eng.n_pad, dtype=jnp.int32)
                if nbytes < 4:
                    _labels_prefix_packed.lower(ident, fetch_len,
                                                nbytes).compile()
                tiles = eng._tile_list(row_lo, nb, max_dist2,
                                       device=dev_plan)
                if tiles is None:
                    continue
                _sparse_fixpoint.lower(
                    eng._coords_dev, ident, jnp.int32(nb),
                    jnp.float32(max_dist2), jnp.asarray(tiles[0]),
                    jnp.asarray(tiles[1]), row_block=eng.row_block,
                    col_block=eng.col_block, union_size=union).compile()
        except Exception as exc:  # warm miss only delays a compile
            log_warm_failure("screening precompile", exc)

    def _seed_vals(self, lo, hi, max_dist2):
        """Label seeds for newly-admitted positions [lo, hi): the frame's
        nearest-higher-density edge when it lies below the linking
        distance, else identity. None when hd data is unavailable."""
        if self._hd_pos is None or hi <= lo:
            return None
        hdd = self._hd_d[lo:hi]
        ok = (hdd > 0.0) & (hdd < np.float32(max_dist2))
        return np.where(ok, self._hd_pos[lo:hi],
                        np.arange(lo, hi, dtype=np.int32))

    def step(self, prev_clustering, k, max_dist2):
        """Run series threshold index ``k``; returns the normalized
        clustered trajectory in original frame order.

        When ``prev_clustering`` is the array returned by the previous
        ``step`` call, the seed labels are taken directly from the
        device-resident fixpoint (no host round-trip); any other seed goes
        through the generic host path.
        """
        n = self.n
        nb = int(self.n_below_per_band[k])
        continuing = (prev_clustering is not None
                      and prev_clustering is self._last_out
                      and self._labels_dev is not None)
        if continuing:
            labels_dev, prev_last = self._continuation_seed(nb, max_dist2)
        elif prev_clustering is None:
            labels_dev, prev_last = self._cold_seed(nb, max_dist2)
        else:
            # generic host seed path (arbitrary previous clustering):
            # rebuild first-occurrence pointers from the state names.
            # Unlike a series continuation, an arbitrary seed is NOT known
            # to be a completed fixpoint at this max_dist2, so the sweep
            # must cover all tile pairs (row_lo=0) and may not early-out --
            # old-old edges the seed missed can still merge components.
            prev = np.asarray(prev_clustering, dtype=np.int64)
            ps = prev[self.order]
            ps[nb:] = 0
            zeros = np.flatnonzero(ps == 0)
            prev_last = int(zeros[0]) if len(zeros) else n
            labels0 = np.arange(self.engine.n_pad, dtype=np.int64)
            prefix = ps[:nb]
            seeded = prefix != 0
            if seeded.any():
                vals, first_idx = np.unique(prefix[seeded],
                                            return_index=True)
                seeded_pos = np.flatnonzero(seeded)
                first_occ = seeded_pos[first_idx]
                labels0[seeded_pos] = first_occ[
                    np.searchsorted(vals, prefix[seeded])]
            seeds = self._seed_vals(prev_last, nb, max_dist2)
            if seeds is not None:
                # only positions the previous clustering left unassigned
                # (identity labels) take the hd-edge seed
                seg = labels0[prev_last:nb]
                unassigned = seg == np.arange(prev_last, nb)
                seg[unassigned] = seeds[unassigned]
            labels_dev = self.engine._upload(labels0.astype(np.int32))
            prev_last = 0  # full sweep; seed labels are equivalences only
        if prev_last >= nb:
            # nothing new below this threshold: keep the previous result
            # (reference early-out, density_clustering_cuda.cu:459-463;
            # valid only for series continuations / cold starts, where the
            # prefix is a completed fixpoint at this max_dist2)
            out = (np.zeros(n, dtype=np.int64) if prev_clustering is None
                   else np.asarray(prev_clustering, dtype=np.int64).copy())
            self._last_out = out
            return out
        t0 = time.perf_counter()
        self.engine.last_stats = {}
        labels_dev = self.engine.run_device(labels_dev, nb, max_dist2,
                                            row_lo=prev_last)
        prefetch = self._prefetch_labels(labels_dev, nb)
        self._labels_dev = labels_dev
        self._prev_nb = nb
        st = self.engine.last_stats
        st = st if "sweeps" in st else None
        if st is not None:
            st["threshold_index"] = k
            self.per_step_stats.append(st)
        clustering = self._postlude(labels_dev, nb,
                                    time.perf_counter() - t0, st,
                                    prefetch=prefetch)
        self._last_out = clustering
        return clustering

    def _continuation_seed(self, nb, max_dist2):
        """Seed the newly-admitted positions [prev_nb, nb) of the
        device-resident labels with their hd edges (one fused dispatch);
        returns (labels_dev, row_lo)."""
        prev_last = int(self._prev_nb)
        labels_dev = self._labels_dev
        seeds = self._seed_vals(prev_last, nb, max_dist2)
        if seeds is not None:
            # pad to a power of two with identity values (positions
            # beyond nb still hold identity labels) so a handful of
            # compiled update shapes serve the whole series
            lo, length = prev_last, nb - prev_last
            cap = 1 << int(np.ceil(np.log2(max(length, 1))))
            cap = min(cap, self.engine.n_pad - lo)
            if cap > length:
                seeds = np.concatenate(
                    [seeds, np.arange(lo + length, lo + cap,
                                      dtype=np.int32)])
            labels_dev = _seed_update(labels_dev, jnp.asarray(seeds),
                                      jnp.int32(lo))
        return labels_dev, prev_last

    def _cold_seed(self, nb, max_dist2):
        """Identity labels with hd-edge seeds on [0, nb); returns
        (labels_dev, row_lo=0)."""
        labels0 = np.arange(self.engine.n_pad, dtype=np.int32)
        seeds = self._seed_vals(0, nb, max_dist2)
        if seeds is not None:
            labels0[:nb] = seeds
        return self.engine._upload(labels0), 0

    def _prefetch_labels(self, labels_dev, nb):
        """Dispatch the postlude's label download RIGHT BEHIND the step's
        fixpoint on the device queue and start the D2H asynchronously.
        Dispatched from the postlude worker instead, the slice program
        would land AFTER the next steps' sweep dispatches and every
        step's fetch would serialize behind later steps' compute;
        enqueued here it streams while the next threshold sweeps. The
        transfer is
        narrowed by VALUE range (_labels_prefix_packed): labels in
        [:fetch_len] are min-positions < fetch_len, so 2 byte planes
        suffice below 2^16 admitted frames, 3 below 2^24, int32 beyond.
        Returns (packed_dev, nbytes) for _postlude, or None (mesh /
        non-pallas paths keep the in-postlude fetch;
        CLUSTERING_TPU_SCREEN_PREFETCH=0 forces the old path for paired
        A/Bs)."""
        if self.engine.backend != "pallas" or self.engine.mesh is not None:
            return None
        if os.environ.get("CLUSTERING_TPU_SCREEN_PREFETCH") == "0":
            return None
        fetch_len = min(self.engine._union_size(max(nb, 1)),
                        self.engine.n_pad)
        nbytes = (2 if fetch_len <= (1 << 16)
                  else 3 if fetch_len <= (1 << 24) else 4)
        if nbytes == 4:
            packed = labels_dev[:fetch_len]
        else:
            packed = _labels_prefix_packed(labels_dev, fetch_len, nbytes)
        try:
            packed.copy_to_host_async()
        except Exception as exc:  # no async D2H: the postlude fetches
            log_warm_failure("label prefetch", exc)
        return packed, nbytes

    def _postlude(self, labels_dev, nb, t_fix, st=None, prefetch=None):
        """Fetch the fixpoint labels and normalize component names;
        returns the clustered trajectory in original frame order.

        ``st`` is the step's engine stats dict: coercing its lazy device
        ``sweeps`` scalar FIRST is a device-done barrier (a scalar
        readback), splitting the step into kernel
        wait (t_wait) vs label download (t_fetch) vs host normalize
        (t_norm) -- measured on the postlude worker thread, so the
        series pipeline is unaffected (the waits overlap the next
        step's dispatches and can sum past the series wall)."""
        t1 = time.perf_counter()
        if st is not None and "sweeps" in st:
            st["sweeps"] = int(st["sweeps"])
            st["swept_tiles"] = float(st["swept_tiles"])
            st["t_wait"] = time.perf_counter() - t1
            t1 = time.perf_counter()
        # only labels[:nb] are consumed below: download just the admitted
        # prefix (quantized to the union-size ladder so a handful of
        # compiled slice programs serve the whole series) -- the full
        # (N_pad,) fetch cost 64MB per step at 16M frames even for
        # near-empty early thresholds. The series drivers pre-dispatch
        # the narrowed prefix (_prefetch_labels); arbitrary-seed and
        # mesh paths fetch here.
        if prefetch is not None:
            packed, nbytes = prefetch
            got = np.asarray(packed)
            if nbytes == 4:
                final = got
            else:
                final = got[0].astype(np.int32)
                for b in range(1, nbytes):
                    final |= got[b].astype(np.int32) << (8 * b)
        else:
            fetch_len = (self.engine._union_size(max(nb, 1))
                         if self.engine.mesh is None else self.engine.n_pad)
            if fetch_len < self.engine.n_pad:
                final = np.asarray(jax.device_get(labels_dev[:fetch_len]))
            else:
                final = self.engine._fetch(labels_dev)
        t2 = time.perf_counter()
        # normalize names by each component's minimal FE-sorted rank:
        # walk the admitted positions in FE-ascending order (precomputed
        # filter, no per-step sort of ranks); a component's FIRST
        # appearance in that walk is its min rank, so one
        # unique(return_index) replaces the np.minimum.at scatter-min
        # (buffered ufunc.at measured 0.7-4s at 1M frames in-situ)
        comp = final[:nb].astype(np.int64)
        fe_asc = self._fe_asc_pos[self._fe_asc_pos < nb]
        comp_vals, first_at = np.unique(comp[fe_asc], return_index=True)
        names = np.empty(len(comp_vals), dtype=np.int64)
        names[np.argsort(first_at, kind="stable")] = \
            np.arange(1, len(comp_vals) + 1)
        clustering = np.zeros(self.n, dtype=np.int64)
        clustering[self.order[:nb]] = names[np.searchsorted(comp_vals,
                                                            comp)]
        # sub-stage wall clocks (fetch/normalize split the host postlude)
        self.last_step_stats = {"t_fix": t_fix, "t_fetch": t2 - t1,
                                "t_norm": time.perf_counter() - t2}
        if st is not None and "sweeps" in st:
            st["t_fetch"] = t2 - t1
            st["t_norm"] = self.last_step_stats["t_norm"]
        return clustering

    def reset(self):
        """Forget all series state (device labels, pending postludes);
        the next step runs as a cold start. Lets one screener instance
        re-run its series (benchmark repetitions)."""
        self._prev_nb = 0
        self._labels_dev = None
        self._last_out = None
        self._last_future = None
        self.per_step_stats = []

    def step_submit(self, k, max_dist2, pool):
        """Series-order step with a deferred host postlude.

        Runs threshold index ``k``'s device fixpoint synchronously, hands
        the label download + FE-rank name normalization to ``pool``, and
        returns the Future of the normalized clustered trajectory (what
        ``step`` returns). Driving the series through this method
        overlaps every step's host postlude -- a device fetch plus the
        component renaming -- with the NEXT threshold's device
        sweeps: the continuation seed needs only the device-resident
        fixpoint labels, never the previous step's normalized output.

        Only valid when the whole series is driven in ascending order
        through this method from a fresh (or ``reset``) screener;
        ``step`` remains the synchronous / arbitrary-seed API. Results
        are bit-identical to ``step`` (tests/test_pallas_interpret.py
        pins the equality, including empty-band early-outs)."""
        import concurrent.futures
        nb = int(self.n_below_per_band[k])
        cold = self._labels_dev is None
        if cold:
            labels_dev, prev_last = self._cold_seed(nb, max_dist2)
        else:
            labels_dev, prev_last = self._continuation_seed(nb, max_dist2)
        if prev_last >= nb:
            # nothing new below this threshold (reference early-out,
            # density_clustering_cuda.cu:459-463): repeat the previous
            # step's output (zeros on a cold start). Chain on the
            # previous postlude without occupying a pool slot.
            prev_fut = self._last_future
            out = concurrent.futures.Future()
            if cold or prev_fut is None:
                out.set_result(np.zeros(self.n, dtype=np.int64))
            else:
                def _chain(f):
                    try:
                        out.set_result(f.result().copy())
                    except BaseException as exc:  # propagate, don't hang
                        out.set_exception(exc)
                prev_fut.add_done_callback(_chain)
            self._last_future = out
            return out
        t0 = time.perf_counter()
        self.engine.last_stats = {}
        labels_dev = self.engine.run_device(labels_dev, nb, max_dist2,
                                            row_lo=prev_last)
        prefetch = self._prefetch_labels(labels_dev, nb)
        self._labels_dev = labels_dev
        self._prev_nb = nb
        st = self.engine.last_stats
        st = st if "sweeps" in st else None
        if st is not None:
            st["threshold_index"] = k
            self.per_step_stats.append(st)
        fut = pool.submit(self._postlude, labels_dev, nb,
                          time.perf_counter() - t0, st,
                          prefetch=prefetch)
        self._last_future = fut
        return fut


def screening_labels(coords_sorted, initial_labels, n_below, max_dist2,
                     row_block=DEFAULT_ROW_BLOCK,
                     col_block=DEFAULT_COL_BLOCK, backend="auto"):
    """Host wrapper: pad, run the fixpoint, unpad.

    ``coords_sorted`` (N, D) must already be in FE-ascending order and
    ``initial_labels`` (N,) int32 frame pointers with labels[i] <= i.
    """
    engine = ScreeningEngine(coords_sorted, row_block=row_block,
                             col_block=col_block, backend=backend)
    return engine.run(initial_labels, n_below, max_dist2)
