"""Block-level spatial pruning for the O(N^2) pair kernels.

Generalization of the reference's box-grid neighbor search
(src/density_clustering.cpp:41-105, applied there only to the CPU pops path)
and of the 1-D sort-pruning helpers it sketches but never uses
(src/tools.hxx:120-204): the frame matrix is processed in
(row_block x col_block) tiles, each tile pair gets a lower bound on its
pairwise distances from per-block coordinate bounding boxes, and tiles that
cannot contain any pair within the interaction radius never enter the
active-tile lists the sweep kernels walk.

Pruning is *exact*: a tile is skipped only when its bounding-box distance
strictly exceeds the threshold, so every admissible pair is still visited.

Orders used by the callers:
  * populations: frames sorted by the first coordinate (highest-variance PC)
    -- counts are permutation-invariant, so sorting is free and makes the
    skip structure banded.
  * NN search: original frame order (MD trajectories are temporally
    correlated, hence spatially local) so the reference's smallest-index
    tie-breaking is preserved; a first banded pass produces per-row-block
    distance upper bounds that prune the full pass.
  * screening: FE-sorted order (fixed by the algorithm); the skip matrix is
    reusable across all thresholds since sigma is threshold-independent.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

WORD_BITS = 32


def morton_order(coords):
    """Frame order along a Morton (Z-order) space-filling curve.

    Groups spatially-close frames into the same tile so per-block bounding
    boxes stay tight in every dimension (dim-0 sorting only bounds one).
    Used where results are permutation-invariant (population counts).

    One native pass when the library is available (bit-identical keys +
    stable sort, equality pinned in tests): the numpy bit-interleave
    loop below makes ~60 passes over the key array and cost 30-50s at
    16M frames on the single-core target VM.
    """
    from ..utils import textio_native
    native = textio_native.morton_order_pad(coords)
    if native is not None:
        return native
    c = np.asarray(coords, dtype=np.float64)
    n, d = c.shape
    bits = max(1, 62 // d)
    lo = c.min(axis=0)
    span = c.max(axis=0) - lo
    span[span == 0] = 1.0
    q = ((c - lo) / span * ((1 << bits) - 1)).astype(np.uint64)
    key = np.zeros(n, dtype=np.uint64)
    for b in range(bits):
        for k in range(d):
            key |= ((q[:, k] >> np.uint64(b)) & np.uint64(1)) \
                << np.uint64(b * d + k)
    return np.argsort(key, kind="stable")


def block_bboxes(coords, block):
    """Per-block per-dimension (mins, maxs); coords (N_pad, D) with N_pad a
    multiple of block."""
    c = np.asarray(coords)
    n, d = c.shape
    blocks = c.reshape(n // block, block, d)
    return blocks.min(axis=1), blocks.max(axis=1)


_BBOX_ROW_CHUNK = 16384


def bbox_dist2(row_mins, row_maxs, col_mins, col_maxs):
    """(n_row_blocks, n_col_blocks) lower bounds on the squared distance
    between any row-block frame and any col-block frame.

    Accumulated per dimension and in row chunks so peak memory stays at
    one (chunk, n_col_blocks) float64 matrix (a full 3-D broadcast is
    gigabytes at millions of frames). The float32 result is rounded
    *downward* so it remains a true lower bound -- round-to-nearest could
    push a bound one ulp past a radius threshold and prune a tile that
    holds an admissible boundary pair."""
    nrb, ncb = row_mins.shape[0], col_mins.shape[0]
    n_dim = row_mins.shape[1]
    # contiguous per-dimension vectors: broadcasting over strided column
    # slices of the (n, D) inputs defeats SIMD (measured 3x slower)
    rmin_d = [np.ascontiguousarray(row_mins[:, k], dtype=np.float32)
              for k in range(n_dim)]
    rmax_d = [np.ascontiguousarray(row_maxs[:, k], dtype=np.float32)
              for k in range(n_dim)]
    cmin_d = [np.ascontiguousarray(col_mins[:, k], dtype=np.float32)
              for k in range(n_dim)]
    cmax_d = [np.ascontiguousarray(col_maxs[:, k], dtype=np.float32)
              for k in range(n_dim)]
    # fp32 throughout (the float64 version moves 2x the memory; this is
    # host-side and bandwidth-bound at millions of frames); the final
    # downward scale dominates every accumulated fp32 rounding, keeping
    # the result a true lower bound: 2 + n_dim ops of <= 2^-24 relative
    # error each, margin (n_dim + 8) * 2^-23
    margin = np.float32(1.0 - (n_dim + 8) * 2.0 ** -23)
    big = np.float32(np.finfo(np.float32).max) * margin
    out = np.empty((nrb, ncb), dtype=np.float32)
    with np.errstate(over="ignore"):
        for lo in range(0, nrb, _BBOX_ROW_CHUNK):
            hi = min(lo + _BBOX_ROW_CHUNK, nrb)
            acc = np.zeros((hi - lo, ncb), dtype=np.float32)
            gap = np.empty((hi - lo, ncb), dtype=np.float32)
            g2 = np.empty((hi - lo, ncb), dtype=np.float32)
            for k in range(n_dim):
                np.subtract(rmin_d[k][lo:hi, None], cmax_d[k][None, :],
                            out=gap)
                np.subtract(cmin_d[k][None, :], rmax_d[k][lo:hi, None],
                            out=g2)
                np.maximum(gap, g2, out=gap)
                np.maximum(gap, np.float32(0.0), out=gap)
                np.multiply(gap, gap, out=gap)
                acc += gap
            # padded blocks at 3e38 overflow to +inf: exactly "far"
            np.minimum(acc, big, out=acc)
            acc *= margin
            out[lo:hi] = acc
    return out


@functools.partial(jax.jit, static_argnames=("row_block", "col_block"))
def bbox_d2_device(coords_t, row_block, col_block):
    """Device-side bbox_dist2 from the (D, N_pad) transposed frame
    matrix: same per-dimension gap accumulation and downward fp32 margin
    as the host version (any valid lower bound preserves exactness; the
    margin absorbs accumulation rounding either way). The host version
    costs ~11s per order at 4M frames and minutes at 16M on this VM's
    single core; one device dispatch does it in milliseconds, and the
    (nrb, ncb) f32 matrix stays in HBM for threshold compares."""
    n_dim, n_pad = coords_t.shape
    rblk = coords_t.reshape(n_dim, -1, row_block)
    rmin, rmax = rblk.min(axis=2), rblk.max(axis=2)   # (D, nrb)
    cblk = coords_t.reshape(n_dim, -1, col_block)
    cmin, cmax = cblk.min(axis=2), cblk.max(axis=2)   # (D, ncb)
    margin = jnp.float32(1.0 - (n_dim + 8) * 2.0 ** -23)
    big = jnp.float32(np.finfo(np.float32).max) * margin
    nrb = n_pad // row_block
    ncb = n_pad // col_block
    acc = jnp.zeros((nrb, ncb), dtype=jnp.float32)
    for k in range(n_dim):
        gap = jnp.maximum(rmin[k][:, None] - cmax[k][None, :],
                          cmin[k][None, :] - rmax[k][:, None])
        gap = jnp.maximum(gap, 0.0)
        acc = acc + gap * gap
    return jnp.minimum(acc, big) * margin


@functools.partial(jax.jit, static_argnames=("strict",))
def _pack_le_planes(d2b, thresh2s, strict=False):
    """(T, nrb, ceil(ncb/32)) uint32 bit planes of d2b <= thresh2s[t]
    (or strict <) -- bit c of word w = column w*32+c, little-endian.
    The strict flag exists because nextafter-based strictness breaks on
    denormal thresholds (XLA flushes them to zero)."""
    nrb, ncb = d2b.shape
    nw = -(-ncb // 32)
    if strict:
        bits = d2b[None, :, :] < thresh2s[:, None, None]
    else:
        bits = d2b[None, :, :] <= thresh2s[:, None, None]
    if nw * 32 != ncb:
        bits = jnp.pad(bits, ((0, 0), (0, 0), (0, nw * 32 - ncb)))
    w = bits.reshape(bits.shape[0], nrb, nw, 32).astype(jnp.uint32)
    return (w << jnp.arange(32, dtype=jnp.uint32)).sum(
        axis=-1, dtype=jnp.uint32)


@jax.jit
def _pack_le_rows(d2b, row_ub):
    """Packed bit plane of d2b <= row_ub[:, None] (per-row thresholds)."""
    nrb, ncb = d2b.shape
    nw = -(-ncb // 32)
    bits = d2b <= row_ub[:, None]
    if nw * 32 != ncb:
        bits = jnp.pad(bits, ((0, 0), (0, nw * 32 - ncb)))
    w = bits.reshape(nrb, nw, 32).astype(jnp.uint32)
    return (w << jnp.arange(32, dtype=jnp.uint32)).sum(
        axis=-1, dtype=jnp.uint32)


def unpack_planes(words, ncb):
    """Host-side inverse of _pack_le_planes/_pack_le_rows: (..., W)
    uint32 words -> (..., ncb) bool."""
    w = np.ascontiguousarray(np.asarray(words))
    bits = np.unpackbits(w.view(np.uint8), axis=-1, bitorder="little")
    return bits[..., :ncb].astype(bool)


def active_masks_device(d2b_dev, thresh2s, strict=False):
    """Threshold the device-resident bbox matrix and download packed
    bits (1/32nd of the bool matrix -- 67MB instead of 2.1GB at 16M
    frames). Returns a (T, nrb, ncb) bool numpy array of d2b <= t (or
    strict < with ``strict``)."""
    ncb = d2b_dev.shape[1]
    words = _pack_le_planes(d2b_dev, jnp.asarray(thresh2s,
                                                 dtype=jnp.float32),
                            strict=strict)
    return unpack_planes(jax.device_get(words), ncb)


@jax.jit
def pack_mask_words(mask):
    """(nrb, ncb) bool -> (nrb, ceil(ncb/32)) uint32 little-endian bit
    words (the device half of unpack_planes): lets device-computed
    active-tile masks download at 1/32nd the bool volume."""
    nrb, ncb = mask.shape
    nw = -(-ncb // 32)
    if nw * 32 != ncb:
        mask = jnp.pad(mask, ((0, 0), (0, nw * 32 - ncb)))
    w = mask.reshape(nrb, nw, 32).astype(jnp.uint32)
    return (w << jnp.arange(32, dtype=jnp.uint32)).sum(
        axis=-1, dtype=jnp.uint32)


@jax.jit
def _pack_le_rows2(d2b_a, d2b_b, row_ub_2):
    """Both candidate orders' per-row-threshold planes in ONE dispatch and
    transfer (one device->host round-trip instead of two)."""
    return jnp.stack([_pack_le_rows(d2b_a, row_ub_2[0]),
                      _pack_le_rows(d2b_b, row_ub_2[1])])


def list_bucket(n):
    """Padded length of a tile list: the next power of two >= n, floor
    1024 -- a handful of compiled kernel shapes serve every list, at most
    2x padding (pads cost one skipped loop step each)."""
    return 1 << int(np.ceil(np.log2(max(n, 1024))))


def tile_list(active, pad_mode="repeat"):
    """Row-major active-tile index lists (ti, tj) as flat int32 arrays of
    length ``list_bucket(n)``, sorted by ti (the sweep kernels find each
    row block's run by binary search).

    pad_mode 'repeat' duplicates the last tile (valid only for idempotent
    reductions; the kernels skip the repeats); 'noop' pads with (last ti,
    -1) entries that the counting kernel treats as no-ops. Returns None
    when nothing is active.
    """
    ti_all, tj_all = np.nonzero(active)
    n = len(ti_all)
    if n == 0:
        return None
    size = list_bucket(n)
    ti = np.full(size, ti_all[-1], dtype=np.int32)
    tj = np.full(size, tj_all[-1] if pad_mode == "repeat" else -1,
                 dtype=np.int32)
    ti[:n] = ti_all
    tj[:n] = tj_all
    return ti, tj


def split_tiles_balanced(ti, tj, n_dev, pad_mode="repeat"):
    """Round-robin a global active-tile list over devices (balanced to
    within one tile per device, unlike row-ownership splits that inherit
    the spatial skew of the pruning), padded to a common (n_dev, L)
    shape.

    Valid whenever any device may compute any tile -- i.e. when partial
    results merge with a cross-device reduction (psum for counts, min for
    NN/labels) rather than by row ownership. Keeps ``ti`` GLOBAL row-block
    indices; each device's subsequence of the row-major input stays
    sorted by ti. Devices dealt no tile get (0, 0) repeats (or (0, -1)
    no-ops). Returns (ti_dev, tj_dev, counts) with counts the per-device
    real (unpadded) tile counts.
    """
    ti = np.asarray(ti, dtype=np.int32).reshape(-1)
    tj = np.asarray(tj, dtype=np.int32).reshape(-1)
    per_dev = [(ti[d::n_dev], tj[d::n_dev]) for d in range(n_dev)]
    counts = np.asarray([len(a) for a, _ in per_dev], dtype=np.int64)
    size = list_bucket(int(counts.max()) if len(ti) else 0)
    ti_dev = np.zeros((n_dev, size), dtype=np.int32)
    tj_dev = np.full((n_dev, size), 0 if pad_mode == "repeat" else -1,
                     dtype=np.int32)
    for d, (a, b) in enumerate(per_dev):
        if not len(a):
            continue
        ti_dev[d] = a[-1]
        ti_dev[d, :len(a)] = a
        tj_dev[d] = b[-1] if pad_mode == "repeat" else -1
        tj_dev[d, :len(b)] = b
    return ti_dev, tj_dev, counts


def band_mask(n_row_blocks, n_col_blocks, row_block, col_block, half_width):
    """Keep-matrix for a diagonal band of +-half_width frames (used for
    the NN bounding pass)."""
    row_centers = (np.arange(n_row_blocks) + 0.5) * row_block
    col_lo = (np.arange(n_col_blocks)) * col_block
    col_hi = col_lo + col_block
    return ((col_hi[None, :] >= row_centers[:, None] - half_width)
            & (col_lo[None, :] <= row_centers[:, None] + half_width))


# ---------------------------------------------------------------------------
# device-side planning (big N)
#
# Host planning materializes (nrb, ncb) boolean matrices, downloads packed
# activity planes and runs np.nonzero over them, all O(N^2 / tile) host
# work. These helpers keep every mask ON DEVICE and hand the sweeps
# device-resident tile lists; the only host traffic is the scalar tile
# count (list shapes must be static). The emitted tile sets and their
# row-major order are identical to the host planners', so results are
# bit-equal.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("strict",))
def le_planes_device(d2b_dev, thresh2s, strict=False):
    """(T, nrb, ncb) bool device planes of d2b <= thresh2s[t] (strict <):
    active_masks_device without the pack + download."""
    t = jnp.asarray(thresh2s, dtype=jnp.float32)[:, None, None]
    return d2b_dev[None] < t if strict else d2b_dev[None] <= t


@functools.partial(jax.jit, static_argnames=("total", "pad_mode"))
def _tile_list_dev_call(active, n_tiles_dev, total, pad_mode):
    ti, tj = jnp.nonzero(active, size=total, fill_value=0)
    ar = jnp.arange(total, dtype=jnp.int32)
    valid = ar < n_tiles_dev
    last = jnp.maximum(n_tiles_dev - 1, 0)
    ti = jnp.where(valid, ti, jnp.take(ti, last)).astype(jnp.int32)
    tj = jnp.asarray(tj, jnp.int32)
    if pad_mode == "repeat":
        tj = jnp.where(valid, tj, jnp.take(tj, last))
    else:
        tj = jnp.where(valid, tj, -1)
    return ti, tj


@functools.partial(jax.jit, static_argnames=("n_row_blocks", "n_col_blocks",
                                             "row_block", "col_block",
                                             "half_width"))
def band_mask_device(n_row_blocks, n_col_blocks, row_block, col_block,
                     half_width):
    """Device twin of band_mask: the host float comparison rewritten in
    exact integer arithmetic (doubled), so the tile set matches the host
    planner's at any N (float32 iotas would round past 2^24)."""
    rc2 = (2 * jnp.arange(n_row_blocks, dtype=jnp.int32) + 1) * row_block
    lo2 = 2 * jnp.arange(n_col_blocks, dtype=jnp.int32) * col_block
    hi2 = lo2 + 2 * col_block
    hw2 = 2 * half_width
    return ((hi2[None, :] >= rc2[:, None] - hw2)
            & (lo2[None, :] <= rc2[:, None] + hw2))


def tile_count_device(active_dev):
    """Host int number of active tiles of a device mask (the one scalar
    fetch device planning needs before shaping a tile list)."""
    return int(jax.device_get(jnp.sum(active_dev, dtype=jnp.int32)))


def tile_list_device(active_dev, n_tiles, pad_mode="repeat"):
    """Device twin of tile_list: same row-major order and padded length,
    tiles stay on device. ``n_tiles`` is the host count
    (tile_count_device). Returns None when empty."""
    if n_tiles == 0:
        return None
    return _tile_list_dev_call(active_dev, jnp.int32(n_tiles),
                               list_bucket(n_tiles), pad_mode)


def tile_list_device_split(active_dev, n_tiles, n_dev, pad_mode="repeat"):
    """Device twin of split_tiles_balanced: the row-major tile list is
    round-robin dealt over ``n_dev`` devices ON DEVICE (element k ->
    device k % n_dev, the same assignment as the host splitter) and
    padded to a common (n_dev, L) shape -- the host never materializes
    the O(tiles) list. Repeat pads copy each device's last real tile
    (devices dealt zero real tiles repeat the list's last tile), noop
    pads carry tj = -1. Returns (ti_dev, tj_dev, counts) with counts the
    per-device real tile counts, or None when empty."""
    if n_tiles == 0:
        return None
    longest = -(-n_tiles // n_dev)
    size = list_bucket(longest)
    ti, tj = _tile_list_dev_call(active_dev, jnp.int32(n_tiles),
                                 n_dev * size, pad_mode)
    # flat element k lands at reshape row k // n_dev, column k % n_dev:
    # transposing gives device d the strided subsequence k = d (mod
    # n_dev) in original (row-major) order
    ti_dev = ti.reshape(size, n_dev).T
    tj_dev = tj.reshape(size, n_dev).T
    counts = np.asarray([-(-(n_tiles - d) // n_dev) if d < n_tiles else 0
                         for d in range(n_dev)], dtype=np.int64)
    return ti_dev, tj_dev, counts


@jax.jit
def rmask_gather_device(planes, ti, tj):
    """Per-tile radius bitmask gathered from (R, nrb, ncb) device planes
    (device twin of DensityEngine._pops_rmask): bit r set iff the tile
    is admissible at radius r; pad entries (tj < 0) carry mask 0."""
    tj_safe = jnp.maximum(tj, 0)
    bits = planes[:, ti, tj_safe].astype(jnp.int32)
    weights = (1 << jnp.arange(planes.shape[0], dtype=jnp.int32))
    rmask = jnp.tensordot(weights, bits, axes=1)
    return jnp.where(tj >= 0, rmask, 0).astype(jnp.int32)
