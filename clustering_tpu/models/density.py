"""Density-clustering mode driver.

Mirrors the reference driver ``Clustering::Density::main``
(src/density_clustering.cpp:559-825) and its screening stage
(CUDA semantics, src/density_clustering_cuda.cu:396-594): same flags, same
artifact files, same restart/reuse behavior -- with the O(N^2) compute
running on the GPU via :mod:`clustering_tpu.ops`.
"""

import os
import sys

import numpy as np

from ..utils import io
from ..utils.logger import log_warm_failure, logger, stage_timer
from .. import ops


def _die(msg):
    print(msg, file=sys.stderr)
    sys.exit(1)


def has_2_digits(val) -> bool:
    """float-precision two-decimal check (reference: density_clustering.cpp:500-504)."""
    f = np.float32(val)
    truncated = np.float32(int(np.float32(f * np.float32(100.0))) / 100.0)
    return bool(truncated == f)


def sorted_fe_order(free_energy) -> np.ndarray:
    """FE-ascending frame order; stable on ties
    (reference: density_clustering.cpp:214-228)."""
    return np.argsort(np.asarray(free_energy), kind="stable")


def assign_low_density_frames(clustering, nhhd_idx, free_energy):
    """Assign unclustered frames to their nearest higher-density neighbor's
    cluster, processing in FE-ascending order
    (reference: density_clustering.cpp:345-360).

    Implemented as pointer-jumping along the higher-density-neighbor chain
    (acyclic: fe strictly decreases along it), which reproduces the
    sequential scan's result in O(log N) gather rounds.
    """
    c = np.asarray(clustering, dtype=np.int64).copy()
    nhhd = np.asarray(nhhd_idx, dtype=np.int64)
    n = len(c)
    ptr = np.where(c > 0, np.arange(n, dtype=np.int64), nhhd)
    while True:
        nxt = ptr[ptr]
        if np.array_equal(nxt, ptr):
            break
        ptr = nxt
    resolved = c[ptr]
    return np.where(c > 0, c, resolved)


def sorted_cluster_names(clustering):
    """Rename states by decreasing population: most populated -> 1
    (reference: density_clustering.cpp:458-493). Population ties break
    toward the smaller original id getting the larger new name (the
    reference leaves tie order unspecified)."""
    c = np.asarray(clustering, dtype=np.int64)
    vals, inverse, counts = np.unique(c, return_inverse=True,
                                      return_counts=True)
    order = np.argsort(counts, kind="stable")  # ascending population
    k = len(vals)
    new_name = np.empty(k, dtype=np.int64)
    new_name[order] = k - np.arange(k)
    return new_name[inverse]


def normalized_cluster_names(n_below, clustering, order):
    """Rename cluster labels to 1..K by ascending raw label over the
    below-threshold frames; 0 stays 0
    (reference: density_clustering.cpp:437-456)."""
    c = np.asarray(clustering, dtype=np.int64)
    prefix_names = np.unique(c[order[:n_below]])
    prefix_names = prefix_names[prefix_names != 0]
    lookup = np.zeros(int(c.max()) + 1 if len(c) else 1, dtype=np.int64)
    for new, old in enumerate(prefix_names, start=1):
        lookup[old] = new
    return lookup[c]


def screening_step(free_energy, nh_dist, threshold, coords, prev_clustering,
                   order=None, coords_sorted=None, engine=None,
                   incremental=False):
    """One screening threshold: returns the normalized clustered trajectory.

    Reference: CUDA screening driver src/density_clustering_cuda.cu:396-594.

    ``order`` / ``coords_sorted`` may be passed to re-use the FE sort across
    thresholds of a screening series. ``incremental=True`` asserts that
    ``prev_clustering`` is the previous threshold's fixpoint at the same
    linking distance (true inside a -T series), enabling new-edges-only
    sweeps.
    """
    fe = np.asarray(free_energy, dtype=np.float32)
    n = len(fe)
    if order is None:
        order = sorted_fe_order(fe)
    if coords_sorted is None:
        coords_sorted = np.asarray(coords, dtype=np.float32)[order]
    # number of frames with fe <= threshold (std::upper_bound semantics,
    # reference: density_clustering.cpp:402-410)
    fe_sorted = fe[order]
    n_below = int(np.searchsorted(fe_sorted, np.float32(threshold),
                                  side="right"))
    sigma2 = ops.neighbors.compute_sigma2(nh_dist)
    max_dist2 = np.float32(4.0 * sigma2)
    logger("    %6s %9i" % ("%.2f" % threshold, n_below))
    prev = (np.zeros(n, dtype=np.int64) if prev_clustering is None
            else np.asarray(prev_clustering, dtype=np.int64))
    prev_sorted = prev[order]
    prev_sorted[n_below:] = 0
    # first not-yet-clustered frame in FE order
    # (reference: density_clustering_cuda.cu:446-451)
    zeros = np.flatnonzero(prev_sorted == 0)
    prev_last = int(zeros[0]) if len(zeros) else n
    if prev_last >= n_below:
        # nothing new below this threshold -> keep previous clustering
        # (reference: density_clustering_cuda.cu:459-463)
        return prev.copy()
    # initial labels as frame pointers in sorted space: seeded frames point
    # to the first occurrence of their seed label, new frames to themselves
    # (reference rebase: density_clustering_cuda.cu:330-346, 493-499)
    labels0 = np.arange(n, dtype=np.int64)
    prefix = prev_sorted[:n_below]
    seeded = prefix != 0
    if seeded.any():
        vals, first_idx = np.unique(prefix[seeded], return_index=True)
        seeded_pos = np.flatnonzero(seeded)
        first_occ = seeded_pos[first_idx]  # first sorted-index per seed value
        labels0[seeded_pos] = first_occ[
            np.searchsorted(vals, prefix[seeded])]
    if engine is None:
        engine = ops.screening.ScreeningEngine(coords_sorted)
    row_lo = prev_last if incremental else 0
    final = engine.run(labels0.astype(np.int32), n_below, max_dist2,
                       row_lo=row_lo)
    clustering = np.zeros(n, dtype=np.int64)
    clustering[order[:n_below]] = final[:n_below].astype(np.int64) + 1
    return normalized_cluster_names(n_below, clustering, order)


def _parse_threshold_series(params, free_energy):
    """-T FROM STEP TO -> the threshold list, with the reference's fp32
    loop arithmetic (density_clustering.cpp:801-817). Raises ValueError
    on the reference's usage errors (caller decides when to die)."""
    if len(params) > 3:
        raise ValueError("error: option -T expects at most three floating"
                         " point arguments: FROM STEP TO.")
    t_from = np.float32(0.1)
    t_step = np.float32(0.1)
    t_to = np.float32(np.max(free_energy))
    if len(params) >= 1 and params[0] >= 0.0:
        t_from = np.float32(params[0])
    if len(params) >= 2:
        t_step = np.float32(params[1])
    if len(params) == 3:
        t_to = np.float32(params[2])
    if not (has_2_digits(t_from) and has_2_digits(t_step)):
        raise ValueError("error: -T can handle at maximum two digits.")
    t_to_low = np.float32(t_to - t_step / np.float32(10.0) + t_step)
    t_to_high = np.float32(t_to + t_step / np.float32(10.0) + t_step)
    thresholds = []
    t = t_from
    while (t < t_to_low) and not (t_to_high < t):
        thresholds.append(np.float32(t))
        t = np.float32(t + t_step)
    return t_from, t_step, t_to, thresholds


def _check_backends(engine, coords, kind, got, radii=None, fe=None):
    """--check mode: recompute on the XLA backend and report disagreement
    (tolerating the documented 1-ulp fma boundary ties)."""
    n = len(coords)
    if kind == "pops":
        other = ops.populations(coords, radii, backend="xla")
        bad = sum(int((got[r] != other[r]).sum()) for r in radii)
        total = n * len(radii)
    else:
        other = ops.nearest_neighbors(coords, fe, backend="xla")
        bad = int((got[0] != other[0]).sum() + (got[2] != other[2]).sum())
        total = 2 * n
    frac = bad / max(total, 1)
    logger(f"    [check] {kind}: {bad}/{total} entries differ between"
           " backends")
    if frac > 0.01:
        _die(f"error: --check failed for {kind}:"
             f" {frac:.2%} of entries disagree between backends")


def main(args, header_comment, comments_map):
    """density mode (reference: src/density_clustering.cpp:559-825)."""
    coords = io.read_coords(args.file)
    n_rows = coords.shape[0]
    # shard the frame axis over all available devices automatically
    import jax
    from .. import parallel
    mesh = parallel.make_mesh() if len(jax.devices()) > 1 else None
    engine = ops.engine.DensityEngine(coords, mesh=mesh)
    check = getattr(args, "check", False)
    free_energy = None
    series_fut = None  # screener built during the NN stage (see below)

    # deferred file writes: the pops / free-energy / neighborhood outputs
    # are written on a worker thread so the next compute stage (NN,
    # screening) starts immediately -- at 1M frames these ASCII writes
    # are 0.2-1s each and sit on the serial chain otherwise (the
    # reference's writes are serial, density_clustering.cpp:700-757).
    # comments_map is snapshotted at submit time (it gains e.g.
    # lumping_radius later), so the bytes match the serial-order output.
    # All writes are joined before the final log; a failure still fails
    # the run, just at the join instead of mid-pipeline.
    from concurrent.futures import ThreadPoolExecutor
    write_pool = ThreadPoolExecutor(max_workers=2)
    deferred_writes = []

    def _defer_write(fn, path, data):
        snap = dict(comments_map)
        deferred_writes.append(
            write_pool.submit(fn, path, data, header_comment, snap))

    # overlap the stages' XLA compiles with each other and with device
    # work (the reference AOT binary pays no compile at all) -- daemon
    # threads warm the jit cache with shape-exact calls that skip every
    # tile, and never raise (a failed warm is logged under -v). CPU runs
    # skip it: interpreted Pallas warms cost real compute, not compiles.
    def _precompile_on():
        if (engine.backend != "pallas"
                or os.environ.get("CLUSTERING_TPU_PRECOMPILE") == "0"):
            return False
        from ..ops.pallas_kernels import INTERPRET_MODE
        return not INTERPRET_MODE()

    will_run_nn = (not args.nearest_neighbors_input
                   and not args.radii
                   and (args.nearest_neighbors or args.output
                        or args.radius is None)
                   and not args.input)
    will_run_pops = (not args.free_energy_input and not args.input
                     and (args.free_energy or args.population
                          or args.output))
    if _precompile_on():
        import threading
        if will_run_pops:
            pops_radii = (list(args.radii) if args.radii
                          else [float(args.radius)]
                          if args.radius is not None else [1.0])
            threading.Thread(target=engine.precompile_pops,
                             args=(pops_radii,), daemon=True).start()
        if will_run_nn:
            threading.Thread(target=engine.precompile_nn,
                             daemon=True).start()

    def _log_substages(stage_key):
        """Verbose sub-stage walls (t_plan/t_kernel/t_sweep/t_host...)
        for cold-start forensics; the engine records
        them whenever CLUSTERING_TPU_PROFILE_SUBSTAGES is set."""
        if not os.environ.get("CLUSTERING_TPU_PROFILE_SUBSTAGES"):
            return
        st = engine.last_stats.get(stage_key, {})
        parts = ", ".join(f"{k}={v:.3f}" for k, v in st.items()
                          if isinstance(v, float) and k.startswith("t_"))
        if parts:
            logger(f"      [{stage_key} substages: {parts}]")

    if args.input and (args.free_energy or args.nearest_neighbors):
        _die("error: for input (-i) -D/-B should be used.")

    logger("~~~ free energy and population")
    if args.free_energy_input:
        logger("    re-using free energy: " + args.free_energy_input)
        if args.radii or args.radius is not None:
            logger("warning: radius (-r/-R) is ignored")
        if args.free_energy or args.population:
            logger("warning: -p/-d flags are ignored")
        free_energy = io.read_free_energies(args.free_energy_input)
        io.read_comments(args.free_energy_input, comments_map)
    elif args.free_energy or args.population or args.output:
        if args.radii:
            logger("    calculating free energy and population")
            if args.output:
                _die("error: clustering cannot be done with several radii"
                     " (-R is set).")
            if not (args.population or args.free_energy):
                _die("error: no output defined for populations or free"
                     " energies.\n       why did you define -R ?")
            radii = list(args.radii)
            logger("    using radii: " + ", ".join(str(r) for r in radii))
            with stage_timer("populations"):
                pops_map = engine.populations(radii)
            _log_substages("populations")
            if check:
                _check_backends(engine, coords, "pops", pops_map,
                                radii=radii)
            logger("    storing results")
            for radius in sorted(pops_map):
                pops = pops_map[radius]
                if args.population:
                    _defer_write(
                        io.write_pops,
                        io.stringprintf(args.population + "_%f", radius),
                        pops)
                if args.free_energy:
                    _defer_write(
                        io.write_fes,
                        io.stringprintf(args.free_energy + "_%f", radius),
                        ops.free_energies(pops))
        else:
            if args.radius is None:
                # no radius: compute the lumping radius from NN statistics
                # (reference: density_clustering.cpp:646-673)
                logger("    computing lumping radius")
                pops = engine.populations([1.0], nn_band_radius=1.0)[1.0]
                fe_tmp = ops.free_energies(pops)
                _, nh_dist, _, _ = engine.nearest_neighbors(fe_tmp)
                sigma2 = ops.neighbors.compute_sigma2(nh_dist)
                radius_lump = float(np.sqrt(np.float32(4.0 * sigma2)))
                logger("        d_lump=" + io.fmt_float(radius_lump))
                comments_map["lumping_radius"] = radius_lump
                radius = radius_lump
            else:
                radius = float(args.radius)
            logger("    calculating free energy and population")
            logger("    using radius: " + io.fmt_float(radius))
            comments_map["clustering_radius"] = radius
            with stage_timer("populations"):
                # free_energy below comes from these counts; when NN
                # follows, the band phase prefetches off the same device
                # accumulator and overlaps the counts download
                pops = engine.populations(
                    [radius],
                    nn_band_radius=radius if will_run_nn else None)[radius]
            _log_substages("populations")
            if check:
                _check_backends(engine, coords, "pops",
                                {radius: pops}, radii=[radius])
            if args.population:
                logger("    storing population in: " + args.population)
                _defer_write(io.write_pops, args.population, pops)
            free_energy = ops.free_energies(pops)
            if args.free_energy:
                logger("    storing free energy in: " + args.free_energy)
                _defer_write(io.write_fes, args.free_energy, free_energy)

    # nearest neighbors
    nh = None
    logger("\n~~~ nearest neighbors")
    if args.nearest_neighbors_input:
        logger("    re-using nearest neighbor: "
               + args.nearest_neighbors_input)
        nh = io.read_neighborhood(args.nearest_neighbors_input)
        io.read_comments(args.nearest_neighbors_input, comments_map)
    elif args.nearest_neighbors or args.output:
        if args.radii:
            _die("error: nearest neighbor calculation cannot be done with\n"
                 "       several radii (-R is set).")
        if free_energy is None:
            # the reference reads from an empty vector here (UB); fail
            # cleanly instead
            _die("error: nearest-neighbor search requires free energies"
                 " (-d/-p/-o or -D).")
        logger("    calculating nearest neighbors")
        # the screening layout (band/Morton ordering, engine upload of
        # the reordered coords) depends only on (coords, fe,
        # thresholds) -- build the screener on a worker thread while
        # the NN stage runs on device (~0.3-0.5s of host work at 1M
        # frames otherwise serialized); the hd edges attach after NN.
        # comments_map is deliberately NOT touched here: the screening_*
        # keys enter it at the original (reference) point below, after
        # the pops/fe/neighborhood headers were snapshotted.
        if (args.output and args.threshold_screening is not None
                and not args.input):
            try:
                _, _, _, thresholds_early = _parse_threshold_series(
                    list(args.threshold_screening), free_energy)
                series_fut = write_pool.submit(
                    ops.screening.ThresholdSeriesScreener,
                    coords, free_energy, thresholds_early, mesh=mesh)
            except ValueError:
                pass  # the original parse site reports the usage error
        if (series_fut is not None and _precompile_on()
                and os.environ.get(
                    "CLUSTERING_TPU_EARLY_SCREEN_WARM", "1") != "0"):
            # warm the screening fixpoint compiles DURING the NN stage:
            # sigma2 is estimated from the prefetched band phase's nh
            # bounds (~1% of the real value -- close enough that the
            # step programs quantize to the same compiled shapes) and
            # the warm is compile-only (jit.lower().compile(): zero
            # device execution, so NN's own device work is untouched).
            # The post-NN precompile below still runs and re-warms any
            # shape the estimate missed.
            import threading

            def _early_screen_warm(fut=series_fut):
                try:
                    est = engine.band_sigma2_estimate()
                    if est is None:
                        return
                    fut.result().precompile(np.float32(4.0 * est))
                except Exception as exc:  # a miss only delays a compile
                    log_warm_failure("early screening warm", exc)
            threading.Thread(target=_early_screen_warm,
                             daemon=True).start()
        with stage_timer("nearest neighbors"):
            nh = engine.nearest_neighbors(free_energy)
        _log_substages("nn")
        if check:
            _check_backends(engine, coords, "nn", nh, fe=free_energy)
        if comments_map["lumping_radius"] == 0.0:
            sigma2 = ops.neighbors.compute_sigma2(nh[1])
            radius_lump = float(np.sqrt(np.float32(4.0 * sigma2)))
            logger("    lumping radius: " + io.fmt_float(radius_lump))
            comments_map["lumping_radius"] = radius_lump
        if args.nearest_neighbors:
            logger("    storing nearest neighbors in: "
                   + args.nearest_neighbors)
            deferred_writes.append(write_pool.submit(
                io.write_neighborhood, args.nearest_neighbors,
                nh[0], nh[1], nh[2], nh[3],
                io.append_comments_map(header_comment, comments_map)))

    # clustering
    if args.output:
        if args.radii:
            _die("error: output needs to depend on single radius\n"
                 "       but several radii (-R) are set.")
        if args.input:
            logger("~~~ generating microstates")
            if args.threshold_screening:
                logger("warning: screening (-T) is ignored")
            logger("    reading initial states: " + args.input)
            clustering = io.read_clustered_trajectory(args.input)
            io.read_comments(args.input, comments_map)
            logger("    assigning low density states to initial states")
            clustering = assign_low_density_frames(clustering, nh[2],
                                                   free_energy)
            logger("    sorting and renaming states by decreasing"
                   " population")
            clustering = sorted_cluster_names(clustering)
            logger("    storing states in: " + args.output)
            io.write_clustered_trajectory(args.output, clustering,
                                          header_comment, comments_map)
        elif args.threshold_screening is not None:
            logger("\n~~~ free energy screening")
            try:
                t_from, t_step, t_to, thresholds = _parse_threshold_series(
                    list(args.threshold_screening), free_energy)
            except ValueError as exc:
                _die(str(exc))
            comments_map["screening_to"] = float(t_to)
            comments_map["screening_from"] = float(t_from)
            comments_map["screening_step"] = float(t_step)
            logger("\n        fe    frames")
            sigma2 = ops.neighbors.compute_sigma2(nh[1])
            max_dist2 = np.float32(4.0 * sigma2)
            if series_fut is not None:
                series = series_fut.result()
                series.set_hd_neighbors((nh[2], nh[3]))
            else:
                series = ops.screening.ThresholdSeriesScreener(
                    coords, free_energy, thresholds, mesh=mesh,
                    hd_neighbors=(nh[2], nh[3]))
            # compile the per-step fixpoint programs concurrently ahead
            # of their steps (shapes are deterministic given fe +
            # thresholds + max_dist2; see ThresholdSeriesScreener
            # .precompile)
            if _precompile_on():
                import threading
                threading.Thread(target=series.precompile,
                                 args=(max_dist2,), daemon=True).start()
            # overlap each step's host postlude (label fetch + name
            # normalization, step_submit) and its file write with the
            # next threshold's device sweeps (the reference pipelines
            # reads/writes similarly in the network builder,
            # network_builder.cpp:438-464)
            from concurrent.futures import ThreadPoolExecutor
            with stage_timer("screening"), \
                    ThreadPoolExecutor(max_workers=2) as post_pool, \
                    ThreadPoolExecutor(max_workers=2) as io_pool:
                pending = []
                for k, tk in enumerate(thresholds):
                    logger("    %6s %9i"
                           % ("%.2f" % tk,
                              int(series.n_below_per_band[k])))
                    fut = series.step_submit(k, max_dist2, post_pool)
                    path = io.stringprintf(args.output + ".%0.2f",
                                           float(tk))
                    pending.append(io_pool.submit(
                        lambda f=fut, p=path:
                        io.write_clustered_trajectory(
                            p, f.result(), header_comment, comments_map)))
                for fut in pending:
                    fut.result()
        else:
            _die("error: one of -T/-i is needed to generate output.")
    for fut in deferred_writes:
        fut.result()
    write_pool.shutdown()
    logger("~~~ freeing memory")
