"""File formats, provenance metadata and helpers.

Host-side equivalent of the reference toolkit (reference: src/tools.{hpp,hxx,cpp}).
All artifact files are whitespace-separated ASCII with ``#``-prefixed comment
headers and ``#@ key = value`` provenance metadata lines; the on-disk byte
layout of data lines matches the reference so pipelines are drop-in
compatible (reference: tools.cpp:229-277 for metadata, tools.hxx:207-272 for
column IO).
"""

import os
import sys
import time
import warnings

import numpy as np

# metadata keys carried between pipeline stages, all modes register these
# up-front with value 0.0 == "unset" (reference: clustering.cpp:484-493)
COMMENT_KEYS = (
    "clustering_radius",
    "lumping_radius",
    "screening_from",
    "screening_to",
    "screening_step",
    "minimal_population",
    "cmin",
    "single_coring_time",
    "limits",
)


def default_comments_map() -> dict:
    return {k: 0.0 for k in COMMENT_KEYS}


def fmt_float(x) -> str:
    """Format a float the way C++ default ostream formatting does.

    Six significant digits, trailing zeros stripped, scientific notation for
    large/small magnitudes -- i.e. printf ``%g``.
    """
    return "%g" % float(x)


def fmt_scientific(x) -> str:
    """printf ``%e`` style used for free-energy columns (std::scientific)."""
    return "%e" % float(x)


def stringprintf(fmt: str, *args) -> str:
    """C-style sprintf (reference: tools.cpp:80-94)."""
    return fmt % args


# ----------------------------------------------------------------------------
# single-column / map readers & writers
# ----------------------------------------------------------------------------

# simple-numeric charset: content made only of these bytes parses the same
# under C strtod/strtoll and Python float()/int() (no hex floats, no
# underscores, no inf/nan spellings), making the vectorized fast path exact
_SIMPLE_NUMERIC = b"0123456789.+-eE \t\r\n"
_WS_BYTES = (0x20, 0x09, 0x0D)


def _strip_leading_comments(raw: bytes):
    """Byte offset of the first line that is not a ``#`` comment."""
    pos, n = 0, len(raw)
    while pos < n:
        p = pos
        while p < n and raw[p] in _WS_BYTES:
            p += 1
        if p < n and raw[p] == 0x23:  # '#'
            nl = raw.find(b"\n", p)
            pos = n if nl < 0 else nl + 1
        elif p < n and raw[p] == 0x0A:  # blank line
            pos = p + 1
        else:
            break
    return pos


def _count_tokens(body: bytes) -> int:
    a = np.frombuffer(body, dtype=np.uint8)
    ws = (a == 0x20) | (a == 0x0A) | (a == 0x09) | (a == 0x0D)
    nonws = ~ws
    if not len(a):
        return 0
    return int(nonws[0]) + int(np.count_nonzero(nonws[1:] & ws[:-1]))


def _parse_tokens_fast(raw: bytes, np_dtype):
    """Fast parse of all whitespace-separated numeric tokens.

    Returns None (caller falls back to the exact line-skip loop) unless the
    content after the leading comment block is plain numeric text and every
    token parses in full -- so a malformed token can never be silently
    misread. The native multithreaded parser (utils/textio_native.py) is
    correctly rounded, hence bit-identical to Python's float(); the numpy
    path is the same C strtod underneath.
    """
    from . import textio_native
    body = raw[_strip_leading_comments(raw):]
    if not body or body.translate(None, _SIMPLE_NUMERIC):
        return None
    if textio_native.available():
        return textio_native.parse_tokens(body, np_dtype)
    n_tokens = _count_tokens(body)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        try:
            vals = np.fromstring(body, dtype=np_dtype, sep=" ")
        except (ValueError, DeprecationWarning):
            return None
    if vals.size != n_tokens:
        return None
    # np.fromstring truncates a malformed *final* token whose prefix parses
    # (e.g. '3.5' as int64 -> 3) without changing the token count; re-parse
    # the tail token exactly so that case falls back to the strict loop.
    if n_tokens:
        tail = body.rstrip()
        last = tail[max(tail.rfind(b" "), tail.rfind(b"\n"),
                        tail.rfind(b"\t"), tail.rfind(b"\r")) + 1:]
        try:
            exact = (int(last) if np_dtype == np.int64 else float(last))
            if vals[-1] != np_dtype(exact):
                return None
        except (ValueError, OverflowError):
            # unparseable or int64-overflowing tail: strict loop decides
            return None
    return vals


def read_single_column(path, dtype=float):
    """Read one value per whitespace-token; on a parse failure skip the rest
    of that line (comment lines start with ``#``).

    ``.npy`` paths load the binary cache directly (fast restart path for
    large artifacts; the ASCII files remain the canonical format).
    Reference: tools.hxx:228-253 (``read_single_column``); the vectorized
    fast path replaces the reference's two-pass ``_mm_malloc`` reader
    (tools.hxx:39-111) and falls back to an exact per-token loop on any
    irregular content.
    """
    if path.endswith(".npy"):
        arr = np.load(path)
        return arr.astype(np.int64 if dtype is int else np.float64)
    with open(path, "rb") as fh:
        raw = fh.read()
    if dtype in (int, float):
        vals = _parse_tokens_fast(
            raw, np.int64 if dtype is int else np.float64)
        if vals is not None and vals.size:
            return vals
    out = []
    for line in raw.decode("utf-8", errors="replace").splitlines():
        for tok in line.split():
            try:
                out.append(dtype(tok))
            except ValueError:
                break  # skip rest of line
    if not out:
        print(f"error: opened empty file '{path}'", file=sys.stderr)
        sys.exit(1)
    return np.asarray(out)


def read_clustered_trajectory(path) -> np.ndarray:
    return np.asarray(read_single_column(path, dtype=int), dtype=np.int64)


def read_free_energies(path) -> np.ndarray:
    return np.asarray(read_single_column(path, dtype=float), dtype=np.float32)


def read_concat_limits(path) -> list:
    """Read chunk lengths, return cumulative frame limits
    (reference: tools.cpp:133-142)."""
    lens = read_single_column(path, dtype=int)
    return list(np.cumsum(lens))


def check_concat_limits(concat_limits, n_frames):
    """Warn on ill-defined limits (reference: tools.cpp:189-205)."""
    from .logger import logger
    if concat_limits[-1] < n_frames:
        logger(f"warning: last {n_frames - concat_limits[-1]}"
               " frames are ignored. check concat-limits/nframes")
    if concat_limits[0] == 0:
        logger("warning: first trajectory is of zero length. check\n"
               "         help for correct usage of --concat-limits")
    if concat_limits[-1] > n_frames:
        logger("warning: limits are larger than the file length.\n"
               "         Check your limits!")


def resolve_concat_limits(args_limits_file, args_nframes, n_frames):
    """Common --concat-limits / --concat-nframes handling shared by the
    mpp/coring/noise/stats drivers (reference: e.g. coring.cpp:81-95)."""
    if args_limits_file:
        limits = read_concat_limits(args_limits_file)
    elif args_nframes:
        step = int(args_nframes)
        limits = list(range(step, n_frames + 1, step))
    else:
        limits = [n_frames]
    check_concat_limits(limits, n_frames)
    return limits


def write_single_column(path, data, header_comment="", scientific=False):
    """Reference: tools.hxx:256-272. ``.npy`` paths store the binary cache
    plus a ``<path>.meta`` sidecar holding the header/metadata lines."""
    if path.endswith(".npy"):
        np.save(path, np.asarray(data))
        if header_comment:
            with open(path + ".meta", "w") as fh:
                fh.write(header_comment)
        return
    from . import textio_native
    arr = np.asarray(data)
    native = textio_native.available() and len(arr)
    with open(path, "wb") as fh:
        fh.write(header_comment.encode())
        if scientific:
            body = (textio_native.format_e(arr) if native else
                    ("\n".join(fmt_scientific(v) for v in arr.tolist())
                     + "\n" if len(arr) else "").encode())
        elif np.issubdtype(arr.dtype, np.integer):
            # fast path for the large state-trajectory files
            body = (textio_native.format_i64(arr) if native else
                    ("\n".join(map(str, arr.tolist()))
                     + "\n" if len(arr) else "").encode())
        else:
            body = ("\n".join(_fmt_any(v) for v in data)
                    + "\n" if len(arr) else "").encode()
        fh.write(body)


def _fmt_any(v):
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return fmt_float(v)


def write_map(path, mapping, header_comment="", val_then_key=False):
    """Two-column key/value file, keys ascending (reference: tools.hxx:207-226)."""
    keys = sorted(mapping)
    if len(keys) > 4096:
        # bulk fast path: native "%lld %g" formatting (a 1M-line WTD file
        # costs seconds through the per-value Python loop below); C
        # snprintf("%g") and Python "%g" are byte-identical. Gated to
        # homogeneous int-key/float-value maps -- int VALUES format as
        # str(int), not %g, and must take the scalar path.
        from . import textio_native
        vals = [mapping[k] for k in keys]
        if (textio_native.available()
                and set(map(type, keys)) <= {int, np.int64, np.intp}
                and set(map(type, vals)) <= {float, np.float64}):
            try:
                ks = np.asarray(keys, dtype=np.int64)
                vs = np.asarray(vals, dtype=np.float64)
                body = textio_native.format_kv_ig(ks, vs,
                                                  swap=val_then_key)
                with open(path, "wb") as fh:
                    fh.write(header_comment.encode())
                    fh.write(body)
                return
            except (TypeError, ValueError, OverflowError):
                pass
    with open(path, "w") as fh:
        fh.write(header_comment)
        for k in keys:
            v = mapping[k]
            a, b = (v, k) if val_then_key else (k, v)
            fh.write(f"{_fmt_any(a)} {_fmt_any(b)}\n")


# ----------------------------------------------------------------------------
# coordinates
# ----------------------------------------------------------------------------

def read_coords(path, usecols=None, dtype=np.float32) -> np.ndarray:
    """Read an (N, D) whitespace-separated ASCII coordinates file.

    Reference: tools.hxx:39-111 (two-pass aligned reader); here a single
    numpy pass suffices. Returns a C-contiguous float32 array.
    """
    if path.endswith(".npy"):
        arr = np.load(path).astype(dtype)
        arr = arr.reshape(len(arr), -1)
    else:
        arr = _read_table_fast(path)
        if arr is None:
            arr = np.loadtxt(path, dtype=dtype, ndmin=2, comments="#")
    if usecols is not None:
        arr = arr[:, list(usecols)]
    return np.ascontiguousarray(arr, dtype=dtype)


def _read_table_fast(path):
    """Vectorized (N, D) numeric-table read; None -> caller falls back to
    np.loadtxt (ragged rows, mid-file comments, exotic tokens)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    body = raw[_strip_leading_comments(raw):]
    if not body:
        return None
    vals = _parse_tokens_fast(raw, np.float64)
    if vals is None or vals.size == 0:
        return None
    # per-line token counts must all agree (np.loadtxt raises on ragged
    # rows; the fast path must not silently reshape them)
    from . import textio_native
    n_cols = textio_native.line_cols(body)
    if n_cols is None:
        # numpy fallback: mask token starts, bucket them per line
        a = np.frombuffer(body, dtype=np.uint8)
        ws = (a == 0x20) | (a == 0x09) | (a == 0x0D)
        nl = a == 0x0A
        starts = ~(ws | nl)
        starts[1:] &= ws[:-1] | nl[:-1]
        line_id = np.cumsum(nl) - nl  # line index of every byte
        per_line = np.bincount(line_id[starts])
        per_line = per_line[per_line > 0]  # blank lines don't count
        if not len(per_line) or (per_line != per_line[0]).any():
            return None
        n_cols = int(per_line[0])
    if n_cols <= 0 or vals.size % n_cols:
        return None
    return vals.reshape(-1, n_cols)


# ----------------------------------------------------------------------------
# neighborhood files
# ----------------------------------------------------------------------------

def write_neighborhood(path, nh_idx, nh_dist, nhhd_idx, nhhd_dist,
                       header_comment=""):
    """4-column nearest-neighbor file (reference: tools.cpp:144-174)."""
    header_comment = header_comment + (
        "#\n# column definitions:\n"
        "#        nn = nearest neighbor\n"
        "#     nn_hd = nearest neighbor with higher density\n"
        "#     id(i) = id/line number of i\n"
        "#   dsqr(i) = squared euclidean distance to i\n#\n"
        "# id(nn)  dsqr(nn) id(nn_hd) dsqr(nn_hd)\n")
    from . import textio_native
    with open(path, "wb") as fh:
        fh.write(header_comment.encode())
        if textio_native.available():
            fh.write(textio_native.format_nn(nh_idx, nh_dist,
                                             nhhd_idx, nhhd_dist))
        else:
            for a, b, c, d in zip(nh_idx, nh_dist, nhhd_idx, nhhd_dist):
                fh.write(f"{int(a)} {fmt_float(b)} {int(c)} "
                         f"{fmt_float(d)}\n".encode())


def read_neighborhood(path):
    """Returns (nh_idx, nh_dist, nhhd_idx, nhhd_dist) arrays
    (reference: tools.cpp:101-131)."""
    data = _read_table_fast(path)
    if data is None:
        data = np.loadtxt(path, comments="#", ndmin=2)
    if data.shape[1] < 4:
        print(f"error: malformed neighborhood file '{path}'",
              file=sys.stderr)
        sys.exit(1)
    return (data[:, 0].astype(np.int64), data[:, 1].astype(np.float32),
            data[:, 2].astype(np.int64), data[:, 3].astype(np.float32))


# ----------------------------------------------------------------------------
# provenance metadata ("#@ key = value" comment lines)
# ----------------------------------------------------------------------------

def read_comments(path, comments_map: dict) -> None:
    """Scan ``#@ key = value`` lines; update registered keys in-place; warn
    when a previously-set value disagrees (reference: tools.cpp:229-265).

    For ``.npy`` caches the metadata lives in the ``<path>.meta`` sidecar.
    """
    from .logger import logger
    if path.endswith(".npy"):
        path = path + ".meta"
        if not os.path.exists(path):
            return
    with open(path, "rb") as fh:
        raw = fh.read()
    # only "#@" lines matter: a bytes-level prefilter beats splitting
    # every line of a megaframe data file
    if b"#@" not in raw:
        return
    import re
    matches = re.finditer(rb"^[^\S\n]*#@[^\n]*", raw, re.M)
    if True:
        for m in matches:
            line = m.group().decode(errors="replace")
            toks = line.split()
            if len(toks) >= 2 and toks[0] == "#@":
                key = toks[1]
                if key not in comments_map:
                    continue
                val = None
                for tok in toks[2:]:
                    try:
                        val = float(tok)
                        break
                    except ValueError:
                        continue
                if val is None:
                    val = -1.0  # line ended before a number
                old = comments_map[key]
                if old != 0 and abs(old - val) > 0.001:
                    logger(f"warning: the values of {key}"
                           " are not in agreement\n"
                           f"        {fmt_float(val)} vs. {fmt_float(old)}")
                comments_map[key] = val


def append_comments_map(header_comment: str, comments_map: dict) -> str:
    """Append ``#@`` lines for all non-zero keys (reference: tools.cpp:267-277)."""
    header_comment += ("#\n# The following comments are reused for identifying"
                       "\n# user-based mistakes and should not be modified.\n")
    for key in sorted(comments_map):
        if comments_map[key] != 0.0:
            header_comment += "#@   %s = %.5f\n" % (key, comments_map[key])
    return header_comment


def make_header(mode: str, argv=None) -> str:
    """Provenance header for output files (reference: clustering.cpp:466-482)."""
    from .. import VERSION_STRING
    argv = sys.argv if argv is None else argv
    stamp = time.asctime(time.localtime())
    cmd = " ".join(argv)
    return (f"# clustering-tpu {VERSION_STRING} - {mode}\n"
            "#\n"
            f"# Created {stamp}\n"
            "# by following command:\n#\n"
            f"# {cmd} \n"
            "#\n"
            "# JAX rebuild of moldyn/clustering;"
            " results are format-compatible with\n"
            "# clustering v1.3.2,"
            " see https://github.com/moldyn/clustering\n")


# ----------------------------------------------------------------------------
# artifact writers that stamp headers + metadata
# ----------------------------------------------------------------------------

def write_pops(path, pops, header_comment, comments_map):
    """Reference: tools.cpp:50-56."""
    hc = append_comments_map(header_comment, comments_map)
    hc += "#\n# point density of each frame\n"
    write_single_column(path, np.asarray(pops, dtype=np.int64), hc,
                        scientific=False)


def write_fes(path, fes, header_comment, comments_map):
    """Reference: tools.cpp:42-48."""
    hc = append_comments_map(header_comment, comments_map)
    hc += "#\n# free energy of each frame\n"
    write_single_column(path, np.asarray(fes, dtype=np.float64), hc,
                        scientific=True)


def write_clustered_trajectory(path, traj, header_comment, comments_map):
    """Reference: tools.cpp:63-69."""
    hc = append_comments_map(header_comment, comments_map)
    hc += "#\n# state/cluster id frames are assigned to\n"
    write_single_column(path, np.asarray(traj, dtype=np.int64), hc,
                        scientific=False)


def microstate_populations(traj) -> dict:
    """state -> count (reference: tools.cpp:176-187)."""
    t = np.asarray(traj)
    if len(t) and np.issubdtype(t.dtype, np.integer) \
            and t.min() >= 0 and t.max() < (1 << 24):
        cnt = np.bincount(t)
        vals = np.flatnonzero(cnt)
        return {int(v): int(cnt[v]) for v in vals}
    vals, counts = np.unique(t, return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}
