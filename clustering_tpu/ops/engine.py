"""Device-resident driver for the density pipeline's O(N^2) stages.

Uploads the frame matrix once, caches sort orders, padded/transposed device
copies and bbox pruning structures, and runs the Pallas (or XLA) kernels for
populations and NN search against them. This is the engine behind
``clustering density``: the reference re-reads and re-uploads per stage
(src/density_clustering_cuda.cu:65-99, 200-224); here device memory keeps
everything resident across the whole mode run.
"""

import functools
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

from . import density as dops
from . import neighbors as nops
from . import pruning
from ..utils import textio_native
from ..utils.logger import log_warm_failure as _log_warm_failure

DEFAULT_ROW_BLOCK = 128
DEFAULT_COL_BLOCK = 4096


@jax.jit
def _lex_merge(b_d, b_j, o_d, o_j):
    """Elementwise lexicographic (distance, index) minimum of two stacked
    NN results; one fused dispatch (eager ops would each pay a device
    round-trip)."""
    take_b = (b_d < o_d) | ((b_d == o_d) & (b_j < o_j))
    return jnp.where(take_b, b_d, o_d), jnp.where(take_b, b_j, o_j)

@functools.partial(jax.jit, static_argnames=("qs",))
def _ub_tiers(stacked_d, n, qs):
    """Per-frame tier index from the band pass's stacked [nh; hd] bounds:
    tier k collects frames whose ub lies in (tau_{k-1}, tau_k], with taus
    ~the ``qs`` quantiles of the finite ubs; frames above the last tau
    (or with no band neighbor at all) land in the final tier. Returns
    (tier uint8 (N_pad,), taus (len(qs),)).

    taus come from 24 rounds of vectorized histogram bisection, not
    jnp.nanquantile (whose full f32 sort compiles far slower), and ANY
    non-decreasing taus keep the tier pruning exact
    (the layout's block bound taus[max tier] >= every member ub by the
    searchsorted invariant) -- quantile accuracy only balances tiers,
    and 24 halvings land within (hi-lo)*2^-24 of the true cut."""
    ub = jnp.maximum(stacked_d[0, :], stacked_d[1, :])
    real = (jnp.arange(ub.shape[0]) < n) & jnp.isfinite(ub)
    vals = jnp.where(real, ub, jnp.inf)
    m = jnp.sum(real).astype(jnp.float32)
    # degenerate all-inf input: keep taus finite (every frame lands in
    # the final tier whose bound is +inf, exactly like real frames with
    # no band neighbor)
    lo0 = jnp.where(m > 0, jnp.min(vals), jnp.float32(0.0))
    hi0 = jnp.where(m > 0, jnp.max(jnp.where(real, ub, -jnp.inf)),
                    jnp.float32(0.0))
    qarr = jnp.asarray(qs, dtype=jnp.float32)
    target = qarr * jnp.maximum(m - 1.0, 0.0) + 1.0

    def bisect(carry, _):
        los, his = carry
        mid = (los + his) * jnp.float32(0.5)
        cnt = jnp.sum(vals[None, :] <= mid[:, None],
                      axis=1).astype(jnp.float32)
        go_hi = cnt < target
        return (jnp.where(go_hi, mid, los), jnp.where(go_hi, his, mid)), None

    (los, his), _ = jax.lax.scan(
        bisect, (jnp.full((len(qs),), lo0), jnp.full((len(qs),), hi0)),
        None, length=24)
    # the upper end of each bracket: >= the true cut value, so every
    # member ub stays dominated (non-decreasing by bracket ordering)
    taus = his
    tier = jnp.searchsorted(taus, ub, side="left").astype(jnp.uint8)
    return tier, taus


@functools.partial(jax.jit, static_argnames=("row_block", "n_tiers"))
def _tiered_layout(coords_t, fe_w, tier_w, cmin, cmax, taus, row_block,
                   n_tiers):
    """Device-side tiered phase-2 layout: stable-sort rows by (tier,
    spatial position), compute the permuted row-block bboxes and the
    active-tile mask against the cached column bboxes -- no host sort, no
    re-upload of the frame matrix.

    Returns (rows_t (D, N_pad) permuted, fe_rows (N_pad,), perm_rows,
    active (nrb, ncb) bool)."""
    n_dim, n_pad = coords_t.shape
    # stable argsort by tier keeps spatial order inside each tier (no
    # composite key: tier * n_pad + pos overflowed int32 past ~429M
    # frames)
    perm_rows = jnp.argsort(tier_w.astype(jnp.int32),
                            stable=True).astype(jnp.int32)
    rows_t = coords_t[:, perm_rows]
    fe_rows = fe_w[perm_rows]
    tiers_p = tier_w[perm_rows].reshape(-1, row_block)
    rblk = rows_t.reshape(n_dim, -1, row_block)
    rmin = rblk.min(axis=2)  # (D, nrb)
    rmax = rblk.max(axis=2)
    # bbox distance lower bounds with the same downward margin as the
    # host pruning (pruning.bbox_dist2): fp32 rounding must never push a
    # bound past the threshold and prune a tile holding a true minimum
    gap1 = rmin.T[:, None, :] - cmax[None, :, :]
    gap2 = cmin[None, :, :] - rmax.T[:, None, :]
    gap = jnp.maximum(jnp.maximum(gap1, gap2), 0.0)
    margin = jnp.float32(1.0 - (n_dim + 8) * 2.0 ** -23)
    big = jnp.float32(np.finfo(np.float32).max) * margin
    d2b = jnp.minimum(jnp.sum(gap * gap, axis=2), big) * margin
    bounds = jnp.concatenate([taus.astype(jnp.float32),
                              jnp.asarray([np.inf], dtype=jnp.float32)])
    blk_bound = bounds[jnp.minimum(tiers_p.max(axis=1), n_tiers - 1)]
    has_real = tiers_p.min(axis=1) < n_tiers
    active = (d2b <= blk_bound[:, None]) & has_real[:, None]
    return rows_t, fe_rows, perm_rows, active


@functools.partial(jax.jit, static_argnames=("band_order",))
def _nn_acts_device(d2b_a, d2b_b, row_ub_2, band, band_order):
    """Device twin of the NN phase-2 selection inputs: each candidate
    order's activity plane (bbox bound <= its row block's upper bound),
    the band order's minus the band tiles already swept, and each
    plane's tile count -- the host planner's work metric, compared
    exactly as integers. Returns (plane_a, plane_b, counts (2,))."""
    acts = [d2b_a <= row_ub_2[0][:, None], d2b_b <= row_ub_2[1][:, None]]
    acts[band_order] = acts[band_order] & ~band
    return acts[0], acts[1], jnp.stack(
        [jnp.sum(a, dtype=jnp.int32) for a in acts])


_NN_ORDERS = ("dim0", "morton")


@jax.jit
def _unpermute_cols(out_j, perm_rows):
    """Scatter columns back to pre-permutation positions on device."""
    inv = jnp.zeros_like(perm_rows).at[perm_rows].set(
        jnp.arange(perm_rows.shape[0], dtype=perm_rows.dtype))
    return out_j[:, inv]


@functools.partial(jax.jit, static_argnames=("n",))
def _nn_finish_idx(out_j, inv_pos, n):
    """Re-lay the stacked (2, N_pad) neighbor ids to original frame
    positions on device (fused into the result fetch; saves the host-side
    inverse-permutation gathers). Returns (2, n) int32."""
    return out_j[:, inv_pos[:n]]


@functools.partial(jax.jit, static_argnames=("n",))
def _nn_finish_idx_u24(out_j, inv_pos, n):
    """_nn_finish_idx with the (2, n) int32 ids packed to three uint8
    byte planes per row -- ids are always < 2^24 at supported N, so the
    ids-only host-finish download drops from 8 to 6 bytes/frame
    deterministically (no overflow fallback needed).  The absent
    sentinel INT32_MAX is remapped to 0xFFFFFF, which the caller's
    ``n <= 2^24 - 2`` gate keeps >= n_frames -- the native decoder
    treats any id >= n_frames as absent.  Returns (2, 3, n) uint8."""
    j = out_j[:, inv_pos[:n]]
    imax = jnp.int32(np.iinfo(np.int32).max)
    j = jnp.where(j == imax, jnp.int32(0xFFFFFF), j)
    return jnp.stack([j & 0xFF, (j >> 8) & 0xFF, (j >> 16) & 0xFF],
                     axis=1).astype(jnp.uint8)


def _nn_finish_chunks(n):
    """Chunk count for the streamed host finish: the ids download and the
    native distance recompute overlap chunk-by-chunk (fetch k+1 streams
    while k recomputes). Default 1 = off; CLUSTERING_TPU_NN_FINISH_CHUNKS
    opts in (host finish only)."""
    env = os.environ.get("CLUSTERING_TPU_NN_FINISH_CHUNKS")
    if env:
        try:
            k = int(env)
        except ValueError:
            return 1
        # each chunk is a separate program output + D2H fetch + native
        # call; cap so a typo can't compile an n-output program
        return max(min(k, 16, n), 1)
    return 1


@functools.partial(jax.jit, static_argnames=("n", "k_chunks"))
def _nn_finish_idx_chunked(out_j, inv_pos, n, k_chunks):
    """_nn_finish_idx split into ``k_chunks`` frame-range outputs from ONE
    compiled program (separate outputs = separately fetchable buffers; a
    host-side slice of one download could not overlap its transfer)."""
    full = out_j[:, inv_pos[:n]]
    step = -(-n // k_chunks)
    return tuple(full[:, a:min(a + step, n)]
                 for a in range(0, n, step))


def _nn_finish_mode():
    """Pick the NN finish: "device" = fused ids + distances fetch (the
    default: the distances are recomputed on the card with the sweep's
    own arithmetic), "host" = ids-only download + native host distance
    recompute. CLUSTERING_TPU_NN_FINISH=host selects the host finish,
    kept for a measured comparison."""
    if os.environ.get("CLUSTERING_TPU_NN_FINISH") == "host":
        return "host"
    return "device"


@functools.partial(jax.jit, static_argnames=("n",))
def _nn_finish(out_j, inv_pos, coords_t, n):
    """All-device NN finish: re-lay the stacked (2, N_pad) neighbor ids
    to original frame positions and recompute their fp32 squared
    distances with the sweep's own per-dimension ascending
    ``acc + diff * diff`` accumulation (XLA contracts it to fma on the
    GPU like the sweep kernel; tests/ and chip_smoke.py check the printed
    distances against the plain reference to within 1 ulp).

    ``inv_pos`` maps original position -> position in ``out_j``'s layout;
    ``coords_t`` is the (D, N_pad) original-order frame matrix. Returns
    one (4, n) int32 array: rows 0-1 the ids and rows 2-3 the f32 d2
    bitcast to int32, both zeroed where no admissible neighbor exists
    (the reference's no-neighbor convention) -- split host-side with
    ``fused[2:].view(np.float32)``."""
    j = out_j[:, inv_pos[:n]]
    imax = jnp.int32(np.iinfo(np.int32).max)
    absent = j == imax
    j_safe = jnp.where(absent, 0, j)
    acc = jnp.zeros(j.shape, dtype=jnp.float32)
    for k in range(coords_t.shape[0]):
        diff = coords_t[k, :n][None, :] - coords_t[k, j_safe]
        acc = acc + diff * diff
    d = jnp.where(absent, jnp.float32(0.0), acc)
    # one fused (4, n) int32 payload: ids + bitcast distances download in
    # a single transfer; absent frames are zeroed HERE (id 0, d2 0 -- the
    # reference's no-neighbor convention) so the host postlude is a bare
    # astype, not full-array compare+store passes
    return jnp.concatenate(
        [j_safe, jax.lax.bitcast_convert_type(d, jnp.int32)], axis=0)


def _host_pair_d2(coords, idx):
    """fp32 squared distances coords[i] -> coords[idx[i]], accumulated per
    dimension in ascending order with numpy ops (one rounding per multiply
    and per add; the host finish's fallback when the native library is
    missing)."""
    acc = np.zeros(len(idx), dtype=np.float32)
    for k in range(coords.shape[1]):
        diff = coords[:, k] - coords[idx, k]
        acc = acc + diff * diff
    return acc


@jax.jit
def _skip_frac(d2b, thresh2):
    return (d2b > thresh2).mean()


@jax.jit
def _band_nh_mean(stacked_d):
    """Mean of the finite per-frame nh distance bounds of a band-phase
    result -- an estimate of compute_sigma2 over the true NN distances
    (the band bound equals the true nh d2 for every frame whose nearest
    neighbor lies within the sort band, i.e. almost all of them on
    spatially-sorted data; pads and band-less frames carry inf and are
    masked)."""
    v = stacked_d[0]
    ok = jnp.isfinite(v)
    s = jnp.sum(jnp.where(ok, v, jnp.float32(0.0)))
    return s / jnp.maximum(jnp.sum(ok).astype(jnp.float32), 1.0)


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _pad_fe(fe_n, n_pad):
    """(n,) f32 free energies -> (1, N_pad) padded with +inf, on device:
    the prefetch thread's host np.full + copy passes cost ~50ms in-situ
    at 1M frames; here the host only enqueues the (n,) upload."""
    n = fe_n.shape[0]
    return jnp.concatenate(
        [fe_n, jnp.full((n_pad - n,), jnp.inf, jnp.float32)]
    ).reshape(1, n_pad)


@jax.jit
def _gather_fe(fe_2d, perm):
    """Re-lay a padded (1, N_pad) fe vector to another frame order via a
    cached device permutation (position p of the target order -> source
    position; pads map to pads, so inf padding is preserved). Bit-exact
    gather -- replaces the thread's host permutation pass + second
    upload."""
    return fe_2d[0][perm].reshape(1, -1)


@functools.partial(jax.jit, static_argnames=("row_block",))
def _row_ub(stacked_d, perm, row_block):
    """Per-row-block upper bounds from a stacked (2, N_pad) band result:
    per-frame max of the [nh; hd] distances, permuted into the candidate
    order, reduced over each row block. Returns (N_pad // row_block,)."""
    ub = jnp.maximum(stacked_d[0, :], stacked_d[1, :])
    return ub[perm].reshape(-1, row_block).max(axis=1)


@functools.partial(jax.jit, static_argnames=("row_block",))
def _row_ub2(stacked_d, perm_a, perm_b, row_block):
    """Both candidate orders' row-block bounds in one dispatch.
    Returns (2, N_pad // row_block)."""
    return jnp.stack([_row_ub(stacked_d, perm_a, row_block),
                      _row_ub(stacked_d, perm_b, row_block)])


class DensityEngine:
    def __init__(self, coords, row_block=DEFAULT_ROW_BLOCK,
                 col_block=DEFAULT_COL_BLOCK, backend="auto", mesh=None):
        """``mesh``: a 1-D jax.sharding.Mesh to shard the row axis over
        (several devices); None = single device."""
        from .pallas_kernels import resolve_backend
        self.backend = resolve_backend(backend)
        self.mesh = mesh
        self.row_block = row_block
        self.col_block = col_block
        self.coords = np.ascontiguousarray(coords, dtype=np.float32)
        self.n, self.d = self.coords.shape
        block = int(np.lcm(row_block, col_block))
        self.n_pad = -(-self.n // block) * block
        self._orders = {}       # name -> (order, padded_host)
        self._dev = {}          # name -> device array ((D, N_pad) or (N_pad, D))
        self._bboxes = {}       # name -> bbox distance matrix
        # serializes the lazy cache builders below: the precompile warm
        # threads race the main thread to the same layouts, and without
        # this the morton sort and the coords upload could run twice.
        # Double-checked: hits stay lock-free (dict reads of fully built
        # values are safe).
        self._build_lock = threading.RLock()
        # memoized device-plan products (see _pops_plan_products):
        # shared between the precompile warm thread and the stage
        self._pops_plan_lock = threading.Lock()
        self._pops_plan_cache = {}
        # per-stage compute accounting (computed = post-pruning tiles
        # actually swept; effective = the N^2 the algorithm replaces) --
        # populated by populations()/nearest_neighbors(), consumed by
        # bench.py and the verbose logs
        self.last_stats = {}
        # per-device real tile counts of the last mesh NN dispatch
        # (balance evidence)
        self._last_mesh_tiles = None
        # stash of an NN band phase dispatched during populations()
        # (consumed at most once by the next nearest_neighbors call)
        self._band_prefetch = None

    def _padded(self, name):
        if name not in self._orders:
            with self._build_lock:
                if name in self._orders:
                    return self._orders[name]
                if name == "orig":
                    order = None
                    sorted_coords = self.coords
                elif name == "dim0":
                    order = np.argsort(self.coords[:, 0], kind="stable")
                    sorted_coords = self.coords[order]
                elif name == "morton":
                    # one native pass for order + permuted padded layout
                    # (bit-identical to the numpy path, which makes ~60
                    # passes over the keys plus a fancy-index permute)
                    native = textio_native.morton_order_pad(
                        self.coords, n_pad=self.n_pad)
                    if native is not None:
                        self._orders[name] = native
                        return self._orders[name]
                    order = pruning.morton_order(self.coords)
                    sorted_coords = self.coords[order]
                else:
                    raise ValueError(name)
                padded = np.zeros((self.n_pad, self.d), dtype=np.float32)
                padded[:self.n] = sorted_coords
                padded[self.n:] = np.float32(3e38)
                self._orders[name] = (order, padded)
        return self._orders[name]

    def _put(self, x):
        """Host array -> device; replicated over the mesh when one is
        set (so jitted programs never re-broadcast a single-device
        upload per dispatch, and multi-process jit accepts it)."""
        if self.mesh is not None:
            from ..parallel.mesh import replicated
            return replicated(np.ascontiguousarray(x), self.mesh)
        return jnp.asarray(x)

    def _device(self, name):
        if name not in self._dev:
            with self._build_lock:
                if name not in self._dev:
                    _, padded = self._padded(name)
                    # uploaded ONCE per engine (16MB at 1M x 4); the
                    # stateless mesh path re-uploaded per call
                    self._dev[name] = self._put(
                        padded.T if self.backend == "pallas" else padded)
        return self._dev[name]

    def _get(self, x):
        """Device -> host numpy (accepts a pytree; one fused fetch);
        multi-process-safe when a mesh is set (a replicated global array
        is not fully addressable on DCN meshes, so jax.device_get would
        reject it)."""
        if self.mesh is not None:
            from ..parallel.mesh import fetch
            return fetch(x)
        return jax.tree_util.tree_map(np.asarray, jax.device_get(x))

    def _oid_dev(self, name):
        """Device (1, N_pad) int32 original-id vector for ``name``'s
        layout (pads carry IMAX), cached per engine: it is fe-independent,
        so one upload per layout serves every nearest_neighbors call."""
        key = ("oid", name)
        if key not in self._dev:
            with self._build_lock:
                if key not in self._dev:
                    order, _ = self._padded(name)
                    oid = np.full(self.n_pad, np.iinfo(np.int32).max,
                                  dtype=np.int32)
                    oid[:self.n] = (np.arange(self.n, dtype=np.int32)
                                    if order is None else order)
                    self._dev[key] = self._put(oid.reshape(1, self.n_pad))
        return self._dev[key]

    def _d2b_dev(self, name):
        """Device-resident (nrb, ncb) bbox distance matrix for ``name``'s
        layout: the host bbox_dist2 is the cold-start wall at production
        N (~11s per order at 4M frames, minutes at 16M on this host);
        one device dispatch computes it in milliseconds and threshold
        compares download 1/32nd-packed bit planes."""
        key = ("d2b", name)
        if key not in self._dev:
            with self._build_lock:
                if key not in self._dev:
                    if self.backend == "pallas":
                        ct = self._device(name)  # (D, N_pad)
                    else:
                        ct = jnp.asarray(self._padded(name)[1].T)
                    self._dev[key] = pruning.bbox_d2_device(
                        ct, row_block=self.row_block,
                        col_block=self.col_block)
        return self._dev[key]

    def _col_bboxes(self, name):
        """Column-block (mins, maxs) for ``name``'s padded layout."""
        key = ("colbb", name)
        if key not in self._bboxes:
            with self._build_lock:
                if key not in self._bboxes:
                    _, padded = self._padded(name)
                    self._bboxes[key] = pruning.block_bboxes(
                        padded, self.col_block)
        return self._bboxes[key]

    def _ub_perm(self, src_name, dst_name):
        """Device int32 permutation mapping positions of ``dst_name`` order
        to positions of ``src_name`` order (padding maps to itself), cached
        -- lets per-frame reductions be re-laid-out on device without
        downloading them."""
        key = ("ubperm", src_name, dst_name)
        if key not in self._dev:
            with self._build_lock:
                if key in self._dev:
                    return self._dev[key]
                src_order, _ = self._padded(src_name)
                dst_order, _ = self._padded(dst_name)
                perm = np.arange(self.n_pad, dtype=np.int32)
                rank_src = np.empty(self.n, dtype=np.int32)
                if src_order is None:
                    rank_src[:] = np.arange(self.n, dtype=np.int32)
                else:
                    rank_src[src_order] = np.arange(self.n,
                                                    dtype=np.int32)
                perm[:self.n] = (rank_src if dst_order is None
                                 else rank_src[dst_order])
                self._dev[key] = self._put(perm)
        return self._dev[key]

    def _log_stats(self, stage, st):
        """Verbose compute accounting: computed (post-pruning) tiles vs the
        full N^2 the stage replaces -- the bench's MFU numbers, surfaced in
        the CLI's -v logs."""
        from ..utils.logger import is_verbose, logger
        if not is_verbose():
            return
        computed = st["computed_tiles"] * float(st["tile_pairs"])
        frac = computed / st["effective_pairs"] if st["effective_pairs"] else 0.0
        mode = ("" if "mode" not in st else
                f", {st['mode']} phase 2" if stage == "nn" else
                f", {st['mode']}")
        if st.get("per_device_tiles") is not None:
            mode += f", per-device tiles {list(st['per_device_tiles'])}"
        # tiles cover the padded grid, so the fraction can exceed 100% on
        # toy inputs smaller than one tile row
        logger(f"    [{stage}: {st['computed_tiles']} tiles computed ="
               f" {frac:.1%} of N^2 incl. padding{mode}]")

    def precompile_nn(self, band_blocks=4):
        """Best-effort background warm of the NN path's compiled programs.

        Called from a daemon thread while populations() compiles and
        runs, so the NN stage's compiles overlap the pops stage. Every
        call uses freshly built arrays with exactly the avals the real
        NN call produces (shape-exact dummy calls populate the same jit
        cache); the band sweep runs over a degenerate list that repeats
        tile (0, 0), whose repeats the kernel skips, so device time is
        negligible. Data-dependent shapes (the phase-2 list length) are
        not warmed; a miss compiles lazily. A failed warm is logged under
        -v and never raises."""
        if self.backend != "pallas" or self.mesh is not None:
            return
        try:
            from . import pallas_kernels as pk
            n, n_pad, d = self.n, self.n_pad, self.d
            rb, cb = self.row_block, self.col_block
            nrb, ncb = n_pad // rb, n_pad // cb
            coords0 = jnp.zeros((d, n_pad), jnp.float32)
            fe2d = jnp.zeros((1, n_pad), jnp.float32)
            oid2d = jnp.zeros((1, n_pad), jnp.int32)
            perm0 = jnp.zeros((n_pad,), jnp.int32)
            dev_plan = self._nn_device_plan_on()
            if ncb > 2 * band_blocks:
                # the band tile list is fe-independent: exact shape
                if dev_plan:
                    band = pruning.band_mask_device(nrb, ncb, rb, cb,
                                                    band_blocks * cb)
                    tiles = pruning.tile_list_device(
                        band, pruning.tile_count_device(band))
                else:
                    tiles = pruning.tile_list(pruning.band_mask(
                        nrb, ncb, rb, cb, band_blocks * cb))
                z = jnp.zeros_like(tiles[0])
                pk.nn_sweep(coords0, fe2d, coords0, fe2d, oid2d,
                            np.int32(n), z, z, row_block=rb, col_block=cb)
            # bound reduction + activity planes
            _row_ub2(jnp.zeros((2, n_pad), jnp.float32), perm0, perm0,
                     row_block=rb)
            z2 = jnp.zeros((nrb, ncb), jnp.float32)
            ub0 = jnp.zeros((2, nrb), jnp.float32)
            if dev_plan:
                for idx in range(len(_NN_ORDERS)):
                    _nn_acts_device(z2, z2, ub0,
                                    jnp.zeros((nrb, ncb), jnp.bool_),
                                    band_order=idx)
            else:
                pruning._pack_le_rows2(z2, z2, ub0)
                pruning.pack_mask_words(jnp.zeros((nrb, ncb), jnp.bool_))
            # tiered plan programs
            n_tiers = len(self.TIER_QS_DEFAULT) + 1
            _ub_tiers(jnp.zeros((2, n_pad), jnp.float32), jnp.int32(n),
                      qs=tuple(self.TIER_QS_DEFAULT))
            zc = jnp.zeros((ncb, d), jnp.float32)
            _tiered_layout(coords0, jnp.zeros((n_pad,), jnp.float32),
                           jnp.zeros((n_pad,), jnp.int32), zc, zc,
                           jnp.zeros((len(self.TIER_QS_DEFAULT),),
                                     jnp.float32),
                           row_block=rb, n_tiers=n_tiers)
            ids0 = jnp.zeros((2, n_pad), jnp.int32)
            _unpermute_cols(ids0, perm0)
            # warm the finish the real call will select
            if _nn_finish_mode() == "host":
                k_chunks = _nn_finish_chunks(n)
                if k_chunks > 1 and textio_native.available():
                    _nn_finish_idx_chunked(ids0, perm0, n, k_chunks)
                elif (n <= (1 << 24) - 2
                      and textio_native.has_nn_finish_u24()):
                    _nn_finish_idx_u24(ids0, perm0, n)
                else:
                    _nn_finish_idx(ids0, perm0, n)
            else:
                _nn_finish(ids0, perm0, coords0, n)
        except Exception as exc:  # best-effort: a miss only delays compiles
            _log_warm_failure("precompile_nn", exc)

    def precompile_pops(self, radii, prune=True):
        """Best-effort background warm of the populations path.

        Runs the REAL plan (best-sort readbacks, activity planes, tile
        list + radius masks -- the same device programs the main-thread
        populations() call uses, shared through the jit cache and the
        engine's layout caches) and then compiles the sweep at the exact
        list shape with an all-zero radius mask, so every tile is skipped
        and the warm costs no device time. A failed warm is logged under
        -v and never raises."""
        if self.backend != "pallas" or self.mesh is not None or not prune:
            return
        try:
            from . import pallas_kernels as pk
            radii = list(radii)
            self._warm_pops_download(len(radii))
            radii2 = jnp.asarray(
                [np.float32(r) * np.float32(r) for r in radii],
                dtype=jnp.float32)
            r_max2 = np.float32(max(radii)) * np.float32(max(radii))
            name = self._best_sort(r_max2)
            if self._device_plan_on():
                ti, tj, _, _ = self._pops_plan_products(name, radii, r_max2,
                                                        0)
            else:
                planes = pruning.active_masks_device(
                    self._d2b_dev(name),
                    [r_max2] + [np.float32(r) * np.float32(r)
                                for r in radii])
                tiles = pruning.tile_list(planes[0], pad_mode="noop")
                if tiles is None:
                    return
                ti, tj = tiles
            coords0 = jnp.zeros((self.d, self.n_pad), jnp.float32)
            pk.pops_sweep(coords0, coords0, radii2, np.int32(self.n),
                          ti, tj, np.zeros(np.shape(ti), np.int32),
                          row_block=self.row_block, col_block=self.col_block)
        except Exception as exc:  # best-effort: a miss only delays compiles
            _log_warm_failure("precompile_pops", exc)

    def _best_sort(self, thresh2):
        """Pick the ordering (dim0 vs morton) with the higher measured tile
        skip fraction at this radius (device compare, scalar readback),
        cached per radius: the warm thread and the main stage ask for the
        same threshold, and each miss costs two device readbacks."""
        key = ("bestsort", float(thresh2))
        if key not in self._orders:
            with self._build_lock:
                if key in self._orders:
                    return self._orders[key]
                best, best_frac = None, -1.0
                # per-order walls for the device-plan breakdown: pad =
                # the host sort order + padded layout, d2b = the bbox
                # matrix dispatch (+ coords upload on a cache miss),
                # frac = the scalar readback that forces it all
                prof = {}
                for name in ("dim0", "morton"):
                    t_p = time.perf_counter()
                    self._padded(name)
                    prof[f"{name}_pad"] = time.perf_counter() - t_p
                    t_p = time.perf_counter()
                    d2b = self._d2b_dev(name)
                    prof[f"{name}_d2b_dispatch"] = time.perf_counter() - t_p
                    t_p = time.perf_counter()
                    frac = float(self._get(_skip_frac(
                        d2b, jnp.float32(thresh2))))
                    prof[f"{name}_frac_fetch"] = time.perf_counter() - t_p
                    if frac > best_frac:
                        best, best_frac = name, frac
                self._best_sort_prof = {k: round(v, 3)
                                        for k, v in prof.items()}
                self._orders[key] = best
        return self._orders[key]

    # -- ops ---------------------------------------------------------------

    def populations(self, radii, prune=True, nn_band_radius=None):
        """``nn_band_radius``: when set to one of ``radii``, the NN band
        phase is prefetched from that radius's counts as soon as the
        pops sweep lands (fe computed host-side bit-equal to
        ops.free_energies), overlapping the counts download and the
        pops->nn inter-stage work; the next nearest_neighbors call
        consumes it only if its fe matches bit-for-bit."""
        if self.mesh is not None and self.backend != "pallas":
            # dense row-ownership XLA program (CPU meshes, smoke runs)
            from ..parallel import sharded
            return sharded.populations(self.coords, list(radii), self.mesh,
                                       row_block=self.row_block,
                                       col_block=self.col_block,
                                       backend=self.backend, prune=prune)
        t0 = time.perf_counter()
        radii = list(radii)
        radii2 = jnp.asarray([np.float32(r) * np.float32(r) for r in radii],
                             dtype=jnp.float32)
        if self.backend != "pallas":
            counts = dops._populations_padded(
                self._device("orig"), radii2, jnp.int32(self.n),
                row_block=self.row_block, col_block=self.col_block)
            return self._pops_finish(np.asarray(jax.device_get(counts)),
                                     None, radii)
        from . import pallas_kernels as pk
        self._warm_pops_download(len(radii))
        r_max2 = np.float32(max(radii)) * np.float32(max(radii))
        if prune and self._device_plan_on():
            # masks and tile lists stay on device; under a mesh the list
            # is dealt round-robin over the devices there
            return self._populations_device_plan(radii, radii2, r_max2,
                                                 nn_band_radius, t0)
        planes = None
        if prune:
            name = self._best_sort(r_max2)
            # one device dispatch + packed-bit download per threshold:
            # the active mask at r_max and the per-radius planes the
            # rmask gathers from (the host bbox matrix never materializes)
            planes = pruning.active_masks_device(
                self._d2b_dev(name),
                [r_max2] + [np.float32(r) * np.float32(r) for r in radii])
            active = planes[0]
        else:
            name = "orig"
            active = np.ones((self.n_pad // self.row_block,
                              self.n_pad // self.col_block), dtype=bool)
        order, _ = self._padded(name)
        if self.mesh is not None:
            return self._pops_dispatch_mesh(name, order, radii, radii2,
                                            active, planes, prune, t0)
        tiles = pruning.tile_list(active, pad_mode="noop")
        rmask = self._pops_rmask(tiles[0], tiles[1], planes, len(radii),
                                 prune)
        stats = {
            "computed_tiles": int((tiles[1] >= 0).sum()),
            "tile_pairs": self.row_block * self.col_block,
            "effective_pairs": float(self.n) * self.n,
        }
        self.last_stats["populations"] = stats
        self._log_stats("pops", stats)
        stats["t_plan"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        acc = pk.pops_sweep(self._device(name), self._device(name), radii2,
                            np.int32(self.n), tiles[0], tiles[1], rmask,
                            row_block=self.row_block,
                            col_block=self.col_block)
        band = None
        if nn_band_radius in radii and self._band_prefetch_ok():
            band = (radii.index(nn_band_radius), name)
        counts_host = self._pops_download(acc, stats, t0, band=band)
        stats["t_sweep"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = self._pops_finish(counts_host, order, radii)
        stats["t_host"] = time.perf_counter() - t0
        return out

    def _pops_plan_products(self, name, radii, r_max2, n_dev):
        """Memoized device-plan products for populations: the active
        mask at r_max, its tile list (dealt over ``n_dev`` devices when
        nonzero) and the per-tile radius masks, all on device; the only
        transfer is the scalar tile count. Shared between precompile_pops'
        warm thread and the stage, so the two never hold duplicate plan
        state. Returns (ti, tj, rmask, prof)."""
        key = (name, tuple(float(r) for r in radii), float(r_max2),
               int(n_dev))
        with self._pops_plan_lock:
            hit = self._pops_plan_cache.get(key)
            if hit is not None:
                ti, tj, rm, prof = hit
                return ti, tj, rm, dict(prof, plan_cache_hit=True)
            prof = {}
            t_seg = time.perf_counter()
            thresh2s = jnp.asarray(
                [r_max2] + [np.float32(r) * np.float32(r) for r in radii],
                dtype=jnp.float32)
            planes_dev = pruning.le_planes_device(self._d2b_dev(name),
                                                  thresh2s)
            count = pruning.tile_count_device(planes_dev[0])
            prof["t_count"] = time.perf_counter() - t_seg
            t_seg = time.perf_counter()
            if count == 0:
                ti = tj = rm = None
            else:
                if n_dev:
                    ti, tj, per_dev = pruning.tile_list_device_split(
                        planes_dev[0], count, n_dev, pad_mode="noop")
                    prof["per_device_tiles"] = per_dev.tolist()
                else:
                    ti, tj = pruning.tile_list_device(
                        planes_dev[0], count, pad_mode="noop")
                rm = pruning.rmask_gather_device(planes_dev[1:], ti, tj)
            prof["t_tile_list"] = time.perf_counter() - t_seg
            prof["tiles"] = count
            self._pops_plan_cache = {key: (ti, tj, rm, prof)}
            return ti, tj, rm, dict(prof)

    def _populations_device_plan(self, radii, radii2, r_max2,
                                 nn_band_radius, t0):
        """Device-planned populations (big N): threshold planes, the
        active mask, the tile list and the per-tile radius masks all stay
        ON DEVICE (pruning.tile_list_device / rmask_gather_device); the
        only planning transfer is the scalar tile count."""
        from . import pallas_kernels as pk
        plan_parts = {}
        t_seg = time.perf_counter()
        name = self._best_sort(r_max2)
        plan_parts["t_best_sort"] = time.perf_counter() - t_seg
        if getattr(self, "_best_sort_prof", None):
            plan_parts["plan_best_sort_parts"] = self._best_sort_prof
        order, _ = self._padded(name)
        n_dev = 0
        if self.mesh is not None:
            from ..parallel.mesh import mesh_size
            n_dev = mesh_size(self.mesh)
        ti, tj, rm, prof = self._pops_plan_products(name, radii, r_max2,
                                                    n_dev)
        n_tiles = prof.pop("tiles", 0)
        per_dev = prof.pop("per_device_tiles", None)
        plan_parts.update(prof)
        stats = {
            "computed_tiles": n_tiles,
            "tile_pairs": self.row_block * self.col_block,
            "effective_pairs": float(self.n) * self.n,
            "plan": "device",
        }
        if n_dev:
            stats["mesh_devices"] = n_dev
            stats["per_device_tiles"] = per_dev
        self.last_stats["populations"] = stats
        self._log_stats("pops", stats)
        stats["t_plan"] = time.perf_counter() - t0
        stats["plan_parts"] = plan_parts
        t0 = time.perf_counter()
        coords = self._device(name)
        if ti is None:
            # every tile pruned (cannot happen with real frames: diagonal
            # tiles always hold self pairs); keep the contract anyway
            acc = jnp.zeros((len(radii), self.n_pad), jnp.int32)
        elif n_dev:
            from ..parallel import sharded
            acc = sharded._pops_sharded_sparse(
                coords, radii2, jnp.int32(self.n), ti, tj, rm, self.mesh,
                row_block=self.row_block, col_block=self.col_block)
        else:
            acc = pk.pops_sweep(coords, coords, radii2, np.int32(self.n),
                                ti, tj, rm, row_block=self.row_block,
                                col_block=self.col_block)
        band = None
        if nn_band_radius in radii and self._band_prefetch_ok():
            band = (radii.index(nn_band_radius), name)
        counts_host = self._pops_download(acc, stats, t0, band=band)
        stats["t_sweep"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = self._pops_finish(counts_host, order, radii)
        stats["t_host"] = time.perf_counter() - t0
        return out

    # counts whose per-radius maximum fits uint16 download at half the
    # bytes (12MB -> 6MB at 1M x 3 radii); tests lower this to force the
    # int32 path on small inputs. Kept for a measured comparison.
    POPS_COUNTS_NARROW_MAX = np.iinfo(np.uint16).max

    def _warm_pops_download(self, n_radii):
        """Warm the counts-download narrowing programs (per-radius max +
        uint16 copy) on a daemon thread: two tiny compiles that would
        otherwise land serially after the first cold pops sweep (same
        rationale as precompile_nn). One-shot per (engine, R)."""
        if self.mesh is not None:
            return
        warmed = getattr(self, "_pops_dl_warmed", None)
        if warmed is None:
            warmed = self._pops_dl_warmed = set()
        if n_radii in warmed:
            return
        warmed.add(n_radii)

        def _warm():
            try:
                acc0 = jnp.zeros((n_radii, self.n_pad), jnp.int32)
                jnp.max(acc0, axis=1)
                acc0.astype(jnp.uint16)
            except Exception as exc:  # best-effort warm
                _log_warm_failure("pops download warm", exc)

        import threading
        threading.Thread(target=_warm, daemon=True).start()

    def _pops_download(self, acc, stats, t0, band=None):
        """Fetch the (R, N_pad) int32 count accumulator, narrowed to
        uint16 when every radius's maximum fits: the per-radius maxima
        ride a tiny scalar fetch that doubles as the device-done barrier
        (kernel vs download split), and the u16 copy is dispatched
        before the barrier so the narrow path costs no extra device
        round-trip after the decision.

        ``band`` = (radius_index, layout_name) requests the NN band
        prefetch: that radius's counts row, re-laid-out to the band
        (Morton) order -- gathered from the u16 cast when it exists
        (2 bytes/frame; exact whenever THIS radius's maximum fits, which
        the maxima readback verifies) -- rides the SAME barrier fetch.
        The counts D2H is then requested asynchronously BEFORE the band
        phase dispatches (so the download streams while the band kernel
        runs instead of queueing behind it), and the fe + dispatch half
        runs on a daemon thread off this stage's wall."""
        maxima = jnp.max(acc, axis=1)
        # the u16 copy is speculative; once a call on this engine chose
        # int32 (overflow), later calls skip the wasted (R, N_pad) cast
        # and dispatch it lazily only if their maxima do fit
        acc_u16 = (None if getattr(self, "_pops_counts_wide", False)
                   else acc.astype(jnp.uint16))
        band_row = None
        if band is not None:
            ridx, name = band
            src = acc if acc_u16 is None else acc_u16
            band_row = src[ridx][self._ub_perm(name, "morton")]
        if band_row is None:
            mx = self._get(maxima)
        else:
            mx, row_host = self._get((maxima, band_row))
        if (os.environ.get("CLUSTERING_TPU_PROFILE_SUBSTAGES")
                and "t_kernel" not in stats):
            stats["t_kernel"] = time.perf_counter() - t0
        narrow = int(mx.max()) <= self.POPS_COUNTS_NARROW_MAX
        self._pops_counts_wide = not narrow
        if narrow:
            if acc_u16 is None:
                acc_u16 = acc.astype(jnp.uint16)
            buf = acc_u16
            stats["counts_dtype"] = "uint16"
        else:
            buf = acc
            stats["counts_dtype"] = "int32"
        if band_row is None:
            return self._get(buf)
        # enqueue the counts D2H first (the buffer exists -- its cast
        # ran before the barrier -- so this DMA is not blocked by the
        # band programs the thread is about to dispatch), then start
        # the fe + band-dispatch thread, then complete the download
        buf.copy_to_host_async()
        if (acc_u16 is not None
                and int(mx[band[0]]) > self.POPS_COUNTS_NARROW_MAX):
            # the u16 row truncated THIS radius (dense big-N counts):
            # refetch the exact int32 row instead of dropping the
            # prefetch -- one extra (N_pad,) D2H is far cheaper than
            # running the whole band phase inside the NN stage
            ridx, name = band
            row_host = self._get(
                acc[ridx][self._ub_perm(name, "morton")])
            stats["band_row_refetched"] = True
        if row_host is None:
            return np.asarray(buf)
        # default: dispatch the band phase immediately, overlapping the
        # counts download. CLUSTERING_TPU_BAND_GATE=1 instead gates the
        # prefetch thread's host work (fe compute, layout upload,
        # band-program tracing) behind the download, for hosts where
        # the thread contends with the transfer handling.
        gate = None
        if os.environ.get("CLUSTERING_TPU_BAND_GATE", "0") == "1":
            gate = threading.Event()
        self._band_prefetch_start(row_host, stats, gate=gate)
        try:
            return np.asarray(buf)
        finally:
            if gate is not None:
                gate.set()

    def _pops_finish(self, counts_padded, order, radii):
        """Host postlude of a populations run: scatter-unsort the padded
        (R, N_pad) int32 download to original frame positions and widen
        to int64 -- one native pass when the library loads (the numpy
        scatter + per-radius astype cost 0.3-5s at 1M frames x 3 radii
        on this VM's in-situ numpy), numpy fallback otherwise."""
        res = textio_native.pops_finish(counts_padded, self.n, order)
        if res is not None:
            return {r: res[i] for i, r in enumerate(radii)}
        counts = counts_padded[:, :self.n]
        if order is not None:
            unsorted = np.empty_like(counts)
            unsorted[:, order] = counts
            counts = unsorted
        return {r: counts[i].astype(np.int64) for i, r in enumerate(radii)}

    @staticmethod
    def _pops_rmask(ti, tj, planes, n_radii, prune):
        """Per-tile radius bitmask: a tile whose bbox distance exceeds
        r^2 skips that radius's compare+count in the kernel (bit r
        unset); pads (tj = -1) carry mask 0 and skip the whole tile
        body. Works on tile-index arrays of any shape (chunked lists or
        per-device splits)."""
        if prune:
            rmask = np.zeros(ti.shape, dtype=np.int32)
            pad = tj < 0
            tj_safe = np.maximum(tj, 0)
            for r_idx in range(n_radii):
                rmask |= (planes[1 + r_idx][ti, tj_safe]
                          .astype(np.int32) << r_idx)
            rmask[pad] = 0
        else:
            rmask = np.where(tj >= 0, np.int32((1 << n_radii) - 1),
                             np.int32(0))
        return rmask

    def _pops_dispatch_mesh(self, name, order, radii, radii2, active,
                            planes, prune, t0):
        """Dispatch the planned populations tile list over the mesh: the
        list is round-robin balanced over devices
        (pruning.split_tiles_balanced, within one tile per device) and
        each device sweeps its share with the same kernel under
        shard_map; one int32 psum merges the partials -- the
        load-balanced analog of the reference's host-side multi-GPU sum
        (src/density_clustering_cuda.cu:171-181)."""
        from ..parallel import sharded
        from ..parallel.mesh import mesh_size, replicated
        ti, tj = np.nonzero(active)
        n_dev = mesh_size(self.mesh)
        stats = {
            "computed_tiles": int(len(ti)),
            "tile_pairs": self.row_block * self.col_block,
            "effective_pairs": float(self.n) * self.n,
            "mesh_devices": n_dev,
        }
        stats["t_plan"] = time.perf_counter() - t0
        t_sweep0 = time.perf_counter()
        ti_d, tj_d, per_dev = pruning.split_tiles_balanced(
            ti, tj, n_dev, pad_mode="noop")
        rmask_d = self._pops_rmask(ti_d, tj_d, planes, len(radii), prune)
        stats["per_device_tiles"] = per_dev.tolist()
        acc = sharded._pops_sharded_sparse(
            self._device(name), radii2, jnp.int32(self.n),
            replicated(ti_d, self.mesh), replicated(tj_d, self.mesh),
            replicated(rmask_d, self.mesh), self.mesh,
            row_block=self.row_block, col_block=self.col_block)
        counts_host = self._pops_download(acc, stats, t_sweep0)
        stats["t_sweep"] = time.perf_counter() - t_sweep0
        self.last_stats["populations"] = stats
        self._log_stats("pops", stats)
        t_host0 = time.perf_counter()
        out = self._pops_finish(counts_host, order, radii)
        stats["t_host"] = time.perf_counter() - t_host0
        return out

    def _nn_sweep(self, order_name, fe_dev, oid_dev, active, n_tiles=None):
        """Run the NN kernel over the active tiles of ``order_name``'s
        layout: ``active`` is a host mask, or (device planning, with
        ``n_tiles`` its tile count) a device mask listed on the device.
        Under a mesh the SAME tile list is round-robin balanced over the
        devices and swept under shard_map (parallel/sharded.py); partial
        results merge with the two-step lexicographic pmin, so the return
        contract ((2, N_pad) d, (2, N_pad) j) is identical."""
        from . import pallas_kernels as pk
        coords = self._device(order_name)
        if self.mesh is not None:
            return self._nn_dispatch_mesh(coords, fe_dev, oid_dev, active)
        tiles = (pruning.tile_list(active) if n_tiles is None
                 else pruning.tile_list_device(active, n_tiles))
        return pk.nn_sweep(coords, fe_dev, coords, fe_dev, oid_dev,
                           np.int32(self.n), tiles[0], tiles[1],
                           row_block=self.row_block,
                           col_block=self.col_block)

    # big-N device planning: above this padded frame count the host
    # planners' (nrb, ncb) boolean masks and np.nonzero passes grow with
    # N^2 / tile, so the populations and NN masks stay ON DEVICE and
    # tile lists compact there (pruning.tile_list_device); only scalar
    # tile counts cross to the host. CLUSTERING_TPU_DEVICE_PLAN=1/0
    # forces it on/off (tests pin bit-equality against the host planner).
    DEVICE_PLAN_MIN_FRAMES = 1 << 22

    def _device_plan_on(self):
        env = os.environ.get("CLUSTERING_TPU_DEVICE_PLAN")
        if env == "0":
            return False
        if env == "1":
            return True
        return self.n_pad >= self.DEVICE_PLAN_MIN_FRAMES

    def _nn_device_plan_on(self):
        """The NN stage plans on the device on one device (a mesh deals
        a host list over its devices)."""
        return self.mesh is None and self._device_plan_on()

    def _band_prefetch_ok(self):
        """The NN band prefetch dispatches device programs from a daemon
        thread; under a mesh those are COLLECTIVE programs, and
        multi-controller (DCN) runs need a deterministic cross-process
        dispatch order -- a thread racing the main thread's collectives
        can interleave differently per process and deadlock. Prefetch is
        therefore on for any single-process topology (one device, or a
        whole single-host mesh) and off across processes."""
        if os.environ.get("CLUSTERING_TPU_NN_PREFETCH") == "0":
            return False
        return self.mesh is None or jax.process_count() == 1

    def _nn_band_dispatch(self, order_name, band_blocks, layout):
        """Dispatch every device program of the NN band phase with NO
        host sync: the banded sweep over sort-neighbor tiles (phase-1
        upper bounds), the per-row-block bound reduction and the
        activity planes for both candidate orders -- packed for the
        download (host planning), or kept on the device with their tile
        counts (device planning; the only sync is the band's tile
        count). Returns the handles the selection half consumes; shared
        by nearest_neighbors' inline path and the populations band
        prefetch (which overlaps all of this with the counts download
        and inter-stage host work)."""
        n_pad = self.n_pad
        rb, cb = self.row_block, self.col_block
        nrb, ncb = n_pad // rb, n_pad // cb
        _, _, fe_dev, oid_dev = layout(order_name)
        dev_plan = self._nn_device_plan_on()
        # phase 1: banded pass over sort-neighbors -> per-frame upper
        # bounds (order-independent values)
        if dev_plan:
            band_active = pruning.band_mask_device(nrb, ncb, rb, cb,
                                                   band_blocks * cb)
            band_tiles = pruning.tile_count_device(band_active)
            out1 = self._nn_sweep(order_name, fe_dev, oid_dev, band_active,
                                  n_tiles=band_tiles)
        else:
            band_active = pruning.band_mask(nrb, ncb, rb, cb,
                                            band_blocks * cb)
            band_tiles = int(band_active.sum())
            out1 = self._nn_sweep(order_name, fe_dev, oid_dev, band_active)
        # keep the per-frame bounds on device; per candidate order,
        # permute + reduce there
        row_ubs_dev = _row_ub2(
            out1[0], self._ub_perm(order_name, "dim0"),
            self._ub_perm(order_name, "morton"), row_block=rb)
        d2b = [self._d2b_dev(nm) for nm in _NN_ORDERS]
        if dev_plan:
            acts = _nn_acts_device(d2b[0], d2b[1], row_ubs_dev, band_active,
                                   band_order=_NN_ORDERS.index(order_name))
        else:
            # both orders' packed planes in one dispatch and one fetch
            acts = pruning._pack_le_rows2(d2b[0], d2b[1], row_ubs_dev)
        return {"order_name": order_name, "band_blocks": band_blocks,
                "band_active": band_active, "band_tiles": band_tiles,
                "out1": out1, "acts": acts, "dev_plan": dev_plan}

    def _prefetch_nn_band(self, fe_sorted, band_blocks=4):
        """Dispatch the NN band phase ahead of nearest_neighbors from a
        host free-energy vector already in the band order's frame layout
        (``fe_sorted``: fp32 (n,), MORTON order). All device programs
        are enqueued asynchronously; nearest_neighbors consumes the
        stash only after verifying its fe is bit-equal (fe values gate
        the hd-neighbor comparisons, so approximate matches are not
        admissible)."""
        order_name = "morton"
        n_pad = self.n_pad
        if (self.backend != "pallas"
                or n_pad // self.col_block <= 2 * band_blocks
                or not self._band_prefetch_ok()):
            return
        layouts = {}
        # one (n,) upload; the inf padding and the dim0 re-layout run on
        # device (_pad_fe / _gather_fe are pure data movement, so the
        # stash's fe stays bit-equal to the consumer's host-built
        # layouts) and keep the thread's host work small.
        fe_band_dev = _pad_fe(self._put(fe_sorted), n_pad)

        def layout(name):
            if name not in layouts:
                order, padded = self._padded(name)
                fe_dev = (fe_band_dev if name == order_name else
                          _gather_fe(fe_band_dev,
                                     self._ub_perm(order_name, name)))
                layouts[name] = (order, padded, fe_dev,
                                 self._oid_dev(name))
            return layouts[name]

        pf = self._nn_band_dispatch(order_name, band_blocks, layout)
        pf["fe_sorted"] = fe_sorted
        pf["layouts"] = layouts
        self._band_prefetch = pf

    def _band_prefetch_start(self, row_host, stats, gate=None):
        """Second half: compute free energies on host EXACTLY as
        ops.free_energies does (same int -> fp32 casts, same np.log, so
        the result is bit-equal to free_energies(pops)[morton_order])
        and dispatch the whole band phase -- on a daemon thread, so the
        host fe + layout uploads + dispatches never sit on the pops
        wall. nearest_neighbors joins the thread before consuming the
        stash. ``gate`` (an Event) defers the thread's work until the
        caller's counts download has landed; the wait is bounded so an
        aborted download can never hang the consumer's join."""
        n = self.n

        def work():
            try:
                if gate is not None:
                    gate.wait(timeout=600.0)
                counts = row_host[:n]
                # mirror ops.free_energies bit-for-bit (density.py):
                # fp32 max, fp32 division, fp32 log -- int32 counts cast
                # to the same fp32 values as the int64 pops the caller
                # will pass through it
                max_pop = np.float32(counts.max())
                ratio = counts.astype(np.float32) / max_pop
                fe_sorted = (-np.log(ratio.astype(np.float32))
                             ).astype(np.float32)
                self._prefetch_nn_band(fe_sorted)
            except Exception as exc:  # a miss only loses overlap
                _log_warm_failure("nn band prefetch", exc)
                self._band_prefetch = None

        import threading
        th = threading.Thread(target=work, daemon=True)
        th.start()
        self._band_prefetch_thread = th
        stats["nn_band_prefetch"] = True

    def band_sigma2_estimate(self, timeout=60.0):
        """Estimate of ``compute_sigma2`` (mean squared NN distance) from
        the prefetched NN band phase's per-frame nh upper bounds, WITHOUT
        consuming the prefetch stash. Available between populations(...,
        nn_band_radius=r) and the nearest_neighbors call; returns None
        when no stash exists. The estimate is exact for every frame whose
        true nearest neighbor lies inside the sort band (almost all, on
        spatially-sorted data), so it lands within ~1% of the real
        sigma2 -- close enough that screening tile counts quantize to
        the same compiled shapes (the caller uses it to warm the
        screening fixpoint compiles during the NN stage)."""
        th = getattr(self, "_band_prefetch_thread", None)
        if th is not None:
            th.join(timeout)
        pf = self._band_prefetch
        if pf is None:
            return None
        try:
            val = float(self._get(_band_nh_mean(pf["out1"][0])))
        except Exception as exc:  # the estimate only steers a warm
            _log_warm_failure("band sigma2 estimate", exc)
            return None
        return val if np.isfinite(val) and val > 0.0 else None

    def _nn_dispatch_mesh(self, coords_dev, fe_dev, oid_dev, active):
        """Balanced shard_map dispatch of an NN tile sweep over a
        mesh-replicated (D, N_pad) layout: the tile list is round-robin
        balanced over devices and partial results merge with the
        two-step lexicographic pmin. Returns ((2, N_pad) d,
        (2, N_pad) j) like the single-device sweep."""
        from ..parallel import sharded
        from ..parallel.mesh import mesh_size, replicated
        ti, tj = np.nonzero(active)
        n_dev = mesh_size(self.mesh)
        ti_d, tj_d, per_dev = pruning.split_tiles_balanced(
            ti, tj, n_dev, pad_mode="repeat")
        self._last_mesh_tiles = per_dev
        return sharded._nn_sharded_sparse(
            coords_dev, fe_dev, oid_dev, jnp.int32(self.n),
            replicated(ti_d, self.mesh), replicated(tj_d, self.mesh),
            self.mesh, row_block=self.row_block, col_block=self.col_block)

    def _nn_tiered_plan(self, winner, band_name, band_out, fe, layout,
                        tier_qs):
        """Plan the tier-ordered phase 2: rows re-sorted by (ub-quantile
        tier, ``winner`` spatial position) so each row block is
        tier-homogeneous and carries its tier's quantile as the bound --
        one cross sweep, one download, ~3.5x fewer swept pairs than
        per-row-block max-ub bounds on metastable data. Exact: every
        frame's bound dominates its true ub, so all tiles that can hold
        its minima stay active.

        Returns (n_active_tiles, run) where run() executes the sweep and
        returns (2, N_pad) int32 neighbor ids in winner-position space --
        so the caller can compare the tile count against the
        block-bounded plan before paying for the sweep.
        """
        from . import pallas_kernels as pk
        n, n_pad = self.n, self.n_pad
        rb = self.row_block
        n_tiers = len(tier_qs) + 1
        tier_dev, taus_dev = _ub_tiers(band_out[0], jnp.int32(n),
                                       qs=tuple(tier_qs))
        _, _, fe_dev_w, oid_dev_w = layout(winner)
        # tier per winner position (device gather through the cached
        # permutation; pads take the extra last tier)
        tier_w = jnp.where(
            jnp.arange(n_pad) < n,
            tier_dev[self._ub_perm(band_name, winner)].astype(jnp.int32),
            jnp.int32(n_tiers))
        cmin, cmax = self._col_bboxes(winner)
        rows_t, fe_rows, perm_rows, active_dev = _tiered_layout(
            self._device(winner), fe_dev_w[0], tier_w,
            jnp.asarray(cmin), jnp.asarray(cmax), taus_dev,
            row_block=rb, n_tiers=n_tiers)
        # the only host round-trip of the plan: the tile count (device
        # planning) or the packed active mask
        if self._nn_device_plan_on():
            active = None
            n_active = pruning.tile_count_device(active_dev)
        else:
            active = pruning.unpack_planes(
                jax.device_get(pruning.pack_mask_words(active_dev)),
                n_pad // self.col_block)
            n_active = int(active.sum())

        def run():
            tiles = (pruning.tile_list(active) if active is not None
                     else pruning.tile_list_device(active_dev, n_active))
            if tiles is None:
                return None
            outk = pk.nn_sweep(
                rows_t, fe_rows.reshape(1, n_pad),
                self._device(winner), fe_dev_w, oid_dev_w, np.int32(n),
                tiles[0], tiles[1], row_block=rb, col_block=self.col_block)
            # device (2, N_pad) ids back at winner positions
            return _unpermute_cols(outk[1], perm_rows)

        return n_active, run

    # auto mode runs the tiered phase 2 when the tiles it prunes off the
    # block-bounded plan are worth more than the tiered path's fixed
    # overhead (one extra device sort/gather program, a mask readback and
    # the plan dispatches); not yet measured on the GPU
    TIERED_MIN_SAVED_PAIRS = 6.0e10
    TIERED_MIN_FRAMES = 1 << 19
    TIER_QS_DEFAULT = (0.5, 0.9, 0.99)

    def nearest_neighbors(self, free_energy, prune=True, band_blocks=4,
                          order_name="morton", tier_qs="auto"):
        """Joint NN / NN-higher-density search with two-phase exact
        pruning in Morton (spatially local) frame order:

          1. a banded pass over neighboring sort positions gives every
             frame an upper bound on both neighbor distances;
          2. the full pass skips tiles whose bbox distance exceeds the
             bound -- tiles holding the true minima always survive.

        ``tier_qs`` (e.g. (0.5, 0.9, 0.99)) switches phase 2 to
        ub-quantile-tiered sweeps: frames are partitioned by their bound,
        each tier compacted in spatial order and swept under its own
        quantile bound, so boundary frames with distant higher-density
        neighbors stop widening whole row blocks (per-block max-ub
        inflates swept pairs ~3.5x on metastable trajectories). Exact
        either way. "auto" (default) plans the tiered variant and takes
        it only when its tile count saves more than the tiered path's
        fixed overhead (TIERED_MIN_SAVED_PAIRS, TIERED_MIN_FRAMES; single
        device only); None forces the single per-row-block-bounded pass.

        The kernel breaks distance ties by smallest *original* index, so
        results are identical to the reference's original-order scan.
        """
        fe = np.asarray(free_energy, dtype=np.float32)
        if self.mesh is not None and self.backend != "pallas":
            # dense row-ownership XLA program (CPU meshes, smoke runs);
            # the pallas backend keeps the full two-phase pruned path and
            # dispatches its tile sweeps through shard_map (_nn_sweep)
            from ..parallel import sharded
            return sharded.nearest_neighbors(self.coords, fe, self.mesh,
                                             row_block=self.row_block,
                                             col_block=self.col_block,
                                             backend=self.backend,
                                             prune=prune,
                                             band_blocks=band_blocks)
        if self.backend != "pallas":
            return nops.nearest_neighbors(self.coords, fe,
                                          row_block=self.row_block,
                                          col_block=self.col_block,
                                          backend="xla")
        n, n_pad = self.n, self.n_pad

        layouts = {}

        def layout(name):
            if name not in layouts:
                order, padded = self._padded(name)
                fe_padded = np.full(n_pad, np.inf, dtype=np.float32)
                fe_padded[:n] = fe if order is None else fe[order]
                layouts[name] = (order, padded,
                                 self._put(fe_padded.reshape(1, n_pad)),
                                 self._oid_dev(name))
            return layouts[name]

        nrb, ncb = n_pad // self.row_block, n_pad // self.col_block
        # a band prefetch dispatched during populations() is consumed at
        # most once, and only when its inputs provably match this call
        # (bit-equal fe in the band order, same band config) -- otherwise
        # the normal dispatch below runs and the stale stash is dropped.
        # The fe + dispatch half runs on a daemon thread (off the pops
        # wall); join it before reading the stash.
        th = getattr(self, "_band_prefetch_thread", None)
        if th is not None:
            th.join()
            self._band_prefetch_thread = None
        pf, self._band_prefetch = self._band_prefetch, None
        if pf is not None:
            band_order, _ = self._padded(pf["order_name"])
            if not (prune and ncb > 2 * band_blocks
                    and pf["order_name"] == order_name
                    and pf["band_blocks"] == band_blocks
                    and np.array_equal(pf["fe_sorted"],
                                       fe if band_order is None
                                       else fe[band_order])):
                pf = None
        if pf is not None:
            layouts.update(pf["layouts"])
        order, padded, fe_dev, oid_dev = layout(order_name)
        band_name, band_out = None, None
        out_idx_dev = None
        stats = {"effective_pairs": float(n) * n,
                 "tile_pairs": self.row_block * self.col_block,
                 "band_tiles": 0, "phase2_tiles": 0, "mode": "dense",
                 "plan": "device" if self._nn_device_plan_on() else "host"}
        # sub-stage wall clocks (each segment ends at a host sync, so the
        # deltas are real): band = banded pass + activity readback, plan
        # = phase-2 planning incl. tiered-mask readback, sweep = phase-2
        # kernel + result download, host = the remaining postlude
        t0 = time.perf_counter()
        active = None
        if prune and ncb > 2 * band_blocks:
            if pf is not None:
                # the band phase (banded sweep, row-ub reduction,
                # activity planes) was dispatched during populations()
                # and overlapped the counts download + inter-stage host
                # work; only the selection fetch below remains here
                bd = pf
                stats["band_prefetched"] = True
            else:
                bd = self._nn_band_dispatch(order_name, band_blocks, layout)
                stats["t_band_dispatch"] = time.perf_counter() - t0
            band_active = bd["band_active"]
            out1 = bd["out1"]
            stats["band_tiles"] = bd["band_tiles"]
            tile_pairs = self.row_block * self.col_block
            # the band's minima are exact within its tiles and the merge
            # is an idempotent lexicographic min: the band order's plane
            # skips re-sweeping them and the band result folds in after.
            # Pick the order with less remaining work (first on a tie).
            if bd["dev_plan"]:
                counts = self._get(bd["acts"][2])
                idx = int(np.argmin(counts))
                active, block_tiles = bd["acts"][idx], int(counts[idx])
            else:
                acts = pruning.unpack_planes(self._get(bd["acts"]), ncb)
                acts[_NN_ORDERS.index(order_name)] &= ~band_active
                counts = acts.sum(axis=(1, 2))
                idx = int(np.argmin(counts))
                active, block_tiles = acts[idx], int(counts[idx])
            band_name, band_out = order_name, out1
            stats["t_band"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            order_name = _NN_ORDERS[idx]
            stats["order"] = order_name
            order, padded, fe_dev, oid_dev = layout(order_name)
            plan = None
            # planning the tiered layout itself costs dispatches + a mask
            # readback, so only plan when even a typical-best (~3.5x on
            # metastable data) reduction of the block-bound work could
            # clear the profitability threshold. The tiered cross sweep
            # is single-device: a mesh keeps the block-bound phase 2.
            plan_worthwhile = (
                block_tiles * float(tile_pairs) * (1.0 - 1.0 / 3.5)
                > self.TIERED_MIN_SAVED_PAIRS)
            if (tier_qs == "auto" and n >= self.TIERED_MIN_FRAMES
                    and plan_worthwhile and self.mesh is None):
                est, run_tiered = self._nn_tiered_plan(
                    order_name, band_name, band_out, fe, layout,
                    self.TIER_QS_DEFAULT)
                if ((block_tiles - est) * float(tile_pairs)
                        > self.TIERED_MIN_SAVED_PAIRS):
                    plan = (est, run_tiered)
            elif tier_qs not in (None, "auto") and self.mesh is None:
                plan = self._nn_tiered_plan(order_name, band_name,
                                            band_out, fe, layout, tier_qs)
            stats["t_plan"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if plan is not None:
                stats["phase2_tiles"], run_tiered = plan
                stats["mode"] = "tiered"
                out_idx_dev = run_tiered()
            else:
                stats["phase2_tiles"] = block_tiles
                stats["mode"] = "block-bound"
        else:
            active = np.ones((nrb, ncb), dtype=bool)
            stats["phase2_tiles"] = int(active.sum())
        if stats["mode"] != "tiered":
            merge_band = band_out is not None and order_name == band_name
            n_dev_tiles = (stats["phase2_tiles"]
                           if isinstance(active, jax.Array) else None)
            out = (self._nn_sweep(order_name, fe_dev, oid_dev, active,
                                  n_tiles=n_dev_tiles)
                   if stats["phase2_tiles"] else None)
            if merge_band and out is not None:
                # lexicographic merge on device: one download vs three
                out = _lex_merge(band_out[0], band_out[1], out[0], out[1])
            elif merge_band:
                out = band_out
            if out is not None:
                out_idx_dev = out[1]
        imax = np.iinfo(np.int32).max
        dd = None
        streamed = None
        jj_u24 = None
        if out_idx_dev is None:
            jj = np.zeros((2, n), dtype=np.int32)
            dd = np.zeros((2, n), dtype=np.float32)
        elif _nn_finish_mode() == "host":
            # ids-only download; distances recomputed on host
            k_chunks = _nn_finish_chunks(n)
            if (k_chunks > 1 and self.mesh is None
                    and textio_native.available()):
                # streamed finish: every chunk's D2H copy is enqueued
                # up-front, then chunk k's native distance recompute runs
                # while chunk k+1 is still in flight
                chunks = _nn_finish_idx_chunked(
                    out_idx_dev, self._ub_perm(order_name, "orig"), n,
                    k_chunks)
                for c in chunks:
                    c.copy_to_host_async()
                if os.environ.get("CLUSTERING_TPU_PROFILE_SUBSTAGES"):
                    _ = int(np.asarray(chunks[0][:1, :1])[0, 0])
                    stats["t_kernel"] = time.perf_counter() - t0
                parts, hosts, base = [], [], 0
                for c in chunks:
                    h = np.asarray(c)  # blocks until THIS chunk lands
                    hosts.append(h)
                    parts.append(textio_native.nn_finish(
                        self.coords, h, frame0=base))
                    base += h.shape[1]
                if all(p is not None for p in parts):
                    streamed = tuple(
                        np.concatenate([p[i] for p in parts])
                        for i in range(4))
                    jj = None
                else:  # stale .so without nn_finish_host: numpy path
                    jj = np.concatenate(hosts, axis=1)
            else:
                # u24 byte-plane packing: ids are < 2^24 at supported N,
                # so the download drops 8 -> 6 bytes/frame with no
                # overflow fallback (the sentinel remap needs
                # n <= 2^24 - 2 so 0xFFFFFF stays >= n)
                u24 = (n <= (1 << 24) - 2
                       and textio_native.has_nn_finish_u24())
                if u24:
                    idx_dev = _nn_finish_idx_u24(
                        out_idx_dev, self._ub_perm(order_name, "orig"), n)
                    barrier = idx_dev[:1, :1, :1]
                    stats["ids_format"] = "u24"
                else:
                    idx_dev = _nn_finish_idx(
                        out_idx_dev, self._ub_perm(order_name, "orig"), n)
                    barrier = idx_dev[:1, :1]
                    stats["ids_format"] = "i32"
                if os.environ.get("CLUSTERING_TPU_PROFILE_SUBSTAGES"):
                    # scalar readback = device-done barrier: kernel time
                    # vs ids download
                    _ = int(np.asarray(self._get(barrier)).ravel()[0])
                    stats["t_kernel"] = time.perf_counter() - t0
                got = self._get(idx_dev)
                if u24:
                    jj_u24, jj = got, None
                else:
                    jj = got
        else:
            # all-device finish (default): ids + distances in one fused
            # fetch (see _nn_finish)
            fused_dev = _nn_finish(
                out_idx_dev, self._ub_perm(order_name, "orig"),
                self._device("orig"), n)
            if os.environ.get("CLUSTERING_TPU_PROFILE_SUBSTAGES"):
                # scalar readback = device-done barrier: splits the sweep
                # segment into kernel time vs result download
                _ = int(self._get(fused_dev[:1, :1])[0, 0])
                stats["t_kernel"] = time.perf_counter() - t0
            fused = self._get(fused_dev)
            jj = fused[:2]
            dd = fused[2:].view(np.float32)
        stats["t_sweep"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if streamed is not None:
            # streamed finish: recompute already overlapped the download
            # (counted under t_sweep); only the chunk concatenation is left
            nh_j, hd_j, nh_d, hd_d = streamed
        elif dd is None:
            # host recompute path: ids still carry IMAX for absent frames
            # (u24 packing: decoded ids >= n mean absent)
            native = None
            if jj_u24 is not None:
                native = textio_native.nn_finish_u24(self.coords, jj_u24)
                if native is None:  # stale .so raced away: numpy decode
                    jj = (jj_u24[:, 0].astype(np.int32)
                          | (jj_u24[:, 1].astype(np.int32) << 8)
                          | (jj_u24[:, 2].astype(np.int32) << 16))
                    jj[jj >= len(self.coords)] = imax
            else:
                native = textio_native.nn_finish(self.coords, jj)
            if native is not None:
                nh_j, hd_j, nh_d, hd_d = native
            else:
                nh_j = jj[0].astype(np.int64)
                hd_j = jj[1].astype(np.int64)
                no_nh = nh_j == imax
                nh_j[no_nh] = 0
                no_hd = hd_j == imax
                hd_j[no_hd] = 0
                nh_d = _host_pair_d2(self.coords, nh_j)
                hd_d = _host_pair_d2(self.coords, hd_j)
                nh_d[no_nh] = 0.0
                hd_d[no_hd] = 0.0
        else:
            # device finish already zeroed absent ids and distances
            nh_j = jj[0].astype(np.int64)
            hd_j = jj[1].astype(np.int64)
            nh_d = np.asarray(dd[0])
            hd_d = np.asarray(dd[1])
        stats["t_host"] = time.perf_counter() - t0
        stats["computed_tiles"] = stats["band_tiles"] + stats["phase2_tiles"]
        if self.mesh is not None and self._last_mesh_tiles is not None:
            # the phase-2 dispatch's balance (band sweeps are balanced
            # the same way)
            stats["per_device_tiles"] = self._last_mesh_tiles.tolist()
        self.last_stats["nn"] = stats
        self._log_stats("nn", stats)
        return nh_j, nh_d, hd_j, hd_d
