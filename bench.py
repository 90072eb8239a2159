"""Benchmark harness: density-clustering throughput on an NVIDIA GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Headline metric: effective frame-pair interactions per second across the
density pipeline's O(N^2) passes (multi-radius populations + joint NN
search + screening sweeps) -- the same work the reference parallelizes
with CUDA (src/density_clustering_cuda_kernels.cu). "Effective" charges
the full N^2 the algorithm replaces; bbox pruning means far fewer pairs
are actually computed, so the JSON also carries true compute accounting:

  computed_gpairs_per_s -- post-pruning tiles actually swept, per second
  kernel_roofline_frac  -- computed-pair rate vs this device's measured
                           dense-kernel ceiling (pruning disabled, all
                           tiles computed, KERNEL TIME ONLY,
                           evaluated-pair convention for every stage):
                           how far the pruned pipeline runs from the
                           dense kernels' own speed of light on this
                           hardware. The label sweep evaluates each
                           unordered pair once for both sides over an
                           upper-triangular list, so its evaluated-rate
                           fraction tops out below 1.0 by design.
  stage breakdown       -- per-stage seconds, effective and computed
                           rates, sub-stage walls (plan/kernel/sweep/
                           host) and, for pops and NN, the sweep
                           kernel's own roofline position with transfer
                           time excluded

Baseline: the reference publishes no numbers (BASELINE.md), so we compare
against an optimistic roofline estimate of its CUDA backend on the
architecture it targets (-arch=compute_30, Kepler K20-class, 3.5 TFLOP/s
fp32): ~12 flops/pair at 40% efficiency => ~1.2e11 pairs/s.
"""

import json
import os
import sys
import time

import numpy as np

BASELINE_PAIRS_PER_SEC = 1.2e11

N = int(os.environ.get("BENCH_N", 1 << 20))
D = int(os.environ.get("BENCH_D", 4))
RADII = [0.10, 0.15, 0.20]
ROW_BLOCK = int(os.environ.get("BENCH_ROW_BLOCK", 128))
COL_BLOCK = int(os.environ.get("BENCH_COL_BLOCK", 4096))
REPS = int(os.environ.get("BENCH_REPS", 4))
CAL_N = int(os.environ.get("BENCH_CAL_N", 1 << 18))


def synthetic_fel(n, d, seed=0):
    """HP35-like trajectory: a metastable Markov walk between anisotropic
    gaussian basins. Frames are temporally correlated like real MD data
    (jumps between basins are rare), which is what makes the NN search's
    temporal-window pruning representative."""
    rng = np.random.default_rng(seed)
    centers = np.asarray([
        [0.0, 0.0, 0.0, 0.0],
        [1.1, 0.4, -0.2, 0.1],
        [-0.8, 1.0, 0.3, -0.2],
        [0.5, -0.9, 0.1, 0.3],
    ])[:, :d]
    n_basins = len(centers)
    scales = np.linspace(0.25, 0.08, d)
    # basin occupancy as a sticky Markov chain (p_stay ~ 0.9995)
    stay = 0.9995
    jumps = rng.random(n) > stay
    basin = np.cumsum(jumps)  # index into a random basin sequence
    basin_seq = rng.integers(0, n_basins, size=int(basin[-1]) + 1)
    which = basin_seq[basin]
    return (centers[which]
            + rng.normal(size=(n, d)) * scales).astype(np.float32)


def _best_of(fn, reps, max_reps=None):
    """Best-of-N with adaptive extension: keep timing (up to
    ``max_reps``) while the latest rep is still improving the best by
    >10%."""
    fn()  # warm (compile + upload)
    max_reps = max_reps or 2 * reps
    best = float("inf")
    out = None
    done = 0
    while done < reps or (done < max_reps and improving):
        t0 = time.perf_counter()
        rep_out = fn()
        dt = time.perf_counter() - t0
        improving = dt < best * 0.9
        if dt < best:
            # keep the BEST rep's output so per-rep side stats (engine
            # sub-stage clocks snapshotted by the caller's fn) describe
            # the rep whose wall clock is reported
            best, out = dt, rep_out
        done += 1
    return best, out


def calibrate_dense_rate(ops):
    """This device's dense-kernel ceiling: the same pops/NN/screening
    kernels with pruning disabled (every tile computed), in computed
    pairs/s -- kernel time only (device-done barrier), so the ceiling is
    the kernel's own speed of light, not kernel + result download. The
    pruned pipeline's computed-pair rate over this is the fraction of
    that speed of light the production path sustains."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    coords = synthetic_fel(CAL_N, D, seed=1)
    eng = ops.engine.DensityEngine(coords, row_block=ROW_BLOCK,
                                   col_block=COL_BLOCK)
    # one convention for every stage: the ceiling is the dense kernel's
    # EVALUATED-pair rate over the full tile grid (each ordered pair
    # computed once); in production the label sweep evaluates each
    # unordered pair once for both sides, so it tops out below 1.0 of
    # this ceiling by design
    pairs = float(eng.n_pad) * eng.n_pad

    # kernel-only ceilings when the substage barrier is on: the dense
    # run's wall otherwise includes its own result download + host
    # finish, understating the kernel's true rate
    def _pops_cal():
        out = eng.populations(RADII, prune=False)
        return out, eng.last_stats.get("populations", {}).get("t_kernel")

    t_pops, (pops_cal, tk) = _best_of(_pops_cal, 2)
    t_pops = tk or t_pops
    fe = ops.free_energies(pops_cal[RADII[0]])

    def _nn_cal():
        out = eng.nearest_neighbors(fe, prune=False)
        return out, eng.last_stats.get("nn", {}).get("t_kernel")

    t_nn, (_, tk) = _best_of(_nn_cal, 2)
    t_nn = tk or t_nn
    # screening sweep ceiling: one label sweep over the full tile grid
    # (the kernel the fixpoint dispatches, every tile computed)
    from clustering_tpu.ops import pallas_kernels as pk
    from clustering_tpu.ops import pruning
    n_pad = eng.n_pad
    active = np.ones((n_pad // ROW_BLOCK, n_pad // COL_BLOCK), dtype=bool)
    ti, tj = (jnp.asarray(t) for t in pruning.tile_list(active))
    coords_t = jnp.asarray(eng._padded("orig")[1].T)
    labels = jnp.arange(n_pad, dtype=jnp.int32)

    def one_sweep():
        out = pk.label_sweep(coords_t, labels, jnp.int32(eng.n),
                             jnp.float32(1e-6), ti, tj,
                             row_block=ROW_BLOCK, col_block=COL_BLOCK)
        return float(np.asarray(jax.device_get(out[:1]))[0])

    t_scr, _ = _best_of(one_sweep, 2)
    return pairs / t_pops, pairs / t_nn, pairs / t_scr


def correctness_guard(ops):
    """Per-stage answer check at every size in BENCH_GUARD_NS (default
    2^16 and 2^18): the same pipeline on the same device, Pallas engine
    vs the independent XLA fallback -- see _guard_at. Aborts the
    benchmark on any mismatch. Returns the ``checks`` dict for the
    bench JSON (per-size sub-dicts under "by_n")."""
    sizes = [int(s) for s in os.environ.get(
        "BENCH_GUARD_NS", f"{1 << 16},{1 << 18}").split(",") if s]
    by_n = {}
    for i, n in enumerate(sizes):
        by_n[str(n)] = _guard_at(ops, n, seed=7 + i)
    checks = {"by_n": by_n, "ok": all(c["ok"] for c in by_n.values())}
    if not checks["ok"]:
        print(f"# CORRECTNESS GUARD FAILED: {checks}", file=sys.stderr)
        print(json.dumps({"metric": "correctness-guard-failed",
                          "value": 0.0, "unit": "Gpairs/s",
                          "vs_baseline": 0.0, "checks": checks}))
        sys.exit(1)
    print("# correctness guard: pops/nn/screening match the XLA"
          f" fallback at N={sizes}", file=sys.stderr)
    return checks


def _guard_at(ops, n, seed):
    """One guard size: pops counts, NN indices and screening labels from
    the Pallas engine vs the independent XLA fallback
    (ops/{density,neighbors,screening}.py) -- a silently-miscompiled
    kernel change must abort the benchmark instead of publishing a fast
    wrong number. Index/label comparisons are exact; pops tolerates only
    the +-1 radius-boundary tie class (see inline comment)."""
    coords = synthetic_fel(n, D, seed=seed)
    eng = ops.engine.DensityEngine(coords, row_block=ROW_BLOCK,
                                   col_block=COL_BLOCK)
    pops_p = eng.populations(RADII, nn_band_radius=RADII[0])
    pops_x = ops.populations(coords, RADII, backend="xla")
    # pops tolerates the documented fp32 radius-boundary tie class ONLY
    # (docs/PARITY.md "Floating-point notes"): the Pallas kernel and
    # the XLA fallback are different programs whose d2 may differ by 1
    # ulp exactly at d == r, flipping a count by +-1 per tied pair on a
    # tiny fraction of frames (|diff| > 1 aborts). A miscompiled kernel
    # moves counts further or on a macroscopic fraction, which also
    # aborts.
    diffs = np.concatenate([
        (np.asarray(pops_p[r], np.int64)
         - np.asarray(pops_x[r], np.int64)) for r in RADII])
    pops_bad = int((diffs != 0).sum())
    pops_ok = (int(np.abs(diffs).max(initial=0)) <= 1
               and pops_bad <= max(1, int(1e-3 * diffs.size)))
    fe = ops.free_energies(pops_p[RADII[0]])
    nn_p = eng.nearest_neighbors(fe)
    # the band prefetch must have HIT when the pallas engine ran (its
    # host fe is bit-equal to ops.free_energies by construction; a
    # silent formula divergence would quietly disable the overlap
    # everywhere); CPU smoke runs use the XLA backend, which never
    # prefetches
    pf_hit = (bool(eng.last_stats.get("nn", {}).get("band_prefetched"))
              or eng.backend != "pallas")
    nn_x = ops.nearest_neighbors(coords, fe, backend="xla")
    nn_bad = int((np.asarray(nn_p[0]) != np.asarray(nn_x[0])).sum()
                 + (np.asarray(nn_p[2]) != np.asarray(nn_x[2])).sum())
    md2 = np.float32(4.0 * ops.neighbors.compute_sigma2(nn_p[1]))
    order = np.argsort(fe, kind="stable")
    cs = coords[order]
    labels0 = np.arange(n, dtype=np.int32)
    n_below = int(0.8 * n)
    lab_p = ops.screening.ScreeningEngine(
        cs, row_block=ROW_BLOCK, col_block=COL_BLOCK,
        backend="pallas").run(labels0, n_below, md2)
    lab_x = ops.screening.ScreeningEngine(
        cs, row_block=ROW_BLOCK, col_block=COL_BLOCK,
        backend="xla").run(labels0, n_below, md2)
    scr_bad = int((lab_p != lab_x).sum())
    return {"n": n, "pops_mismatch": pops_bad,
            "pops_boundary_ties_ok": pops_ok, "nn_mismatch": nn_bad,
            "screening_mismatch": scr_bad,
            "nn_band_prefetch_hit": pf_hit,
            "ok": (pops_ok and nn_bad == 0 and scr_bad == 0
                   and pf_hit)}


def main():
    import jax

    from clustering_tpu import ops

    # split the NN sweep segment into kernel vs result download (a
    # scalar-readback barrier per rep)
    os.environ.setdefault("CLUSTERING_TPU_PROFILE_SUBSTAGES", "1")

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        # a measurement path never falls back to the CPU
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    print(f"# bench device: {dev} ({dev.device_kind})", file=sys.stderr)

    checks = correctness_guard(ops)

    dense_pops_rate, dense_nn_rate, dense_scr_rate = \
        calibrate_dense_rate(ops)
    print(f"# dense kernel ceiling ({CAL_N} frames, all tiles):"
          f" pops {dense_pops_rate:.3e} pairs/s,"
          f" nn {dense_nn_rate:.3e} pairs/s,"
          f" screening {dense_scr_rate:.3e} pairs/s", file=sys.stderr)

    coords = synthetic_fel(N, D)
    engine = ops.engine.DensityEngine(coords, row_block=ROW_BLOCK,
                                      col_block=COL_BLOCK)

    stages = {}
    total_eff_pairs = 0.0
    total_time = 0.0
    total_computed = 0.0

    # --- populations + NN as one pipelined sequence ---
    # production always runs pops -> fe -> NN back to back, and the NN
    # band phase prefetches off the pops counts (overlapping the counts
    # download + inter-stage host work), so the two stages are timed as
    # consecutive segments of the SAME rep: each stage's reported wall
    # is its best across reps of the real pipeline, not of an isolated
    # loop the production path never runs.
    # XLA-fallback backends don't record tile stats (CPU smoke runs);
    # charge the full grid so the accounting stays defined
    n_tiles_full = (engine.n_pad // ROW_BLOCK) * (engine.n_pad // COL_BLOCK)
    full = {"computed_tiles": n_tiles_full,
            "tile_pairs": ROW_BLOCK * COL_BLOCK, "mode": "dense"}

    def _pipe_rep():
        t0 = time.perf_counter()
        pops_o = engine.populations(RADII, nn_band_radius=RADII[0])
        tp = time.perf_counter() - t0
        pops_s = dict(engine.last_stats.get("populations", full))
        fe_k = ops.free_energies(pops_o[RADII[0]])
        t1 = time.perf_counter()
        nn_o = engine.nearest_neighbors(fe_k)
        tn = time.perf_counter() - t1
        nn_s = dict(engine.last_stats.get("nn", full))
        return tp, pops_o, pops_s, fe_k, tn, nn_o, nn_s

    def _run_pipeline(reps, max_reps=None):
        max_reps = max_reps or 2 * reps
        best = [float("inf"), None, None, None,
                float("inf"), None, None]
        done, improving = 0, True
        while done < reps or (done < max_reps and improving):
            tp, pops_o, pops_s, fe_k, tn, nn_o, nn_s = _pipe_rep()
            improving = tp < best[0] * 0.9 or tn < best[4] * 0.9
            if tp < best[0]:
                best[0], best[1], best[2] = tp, pops_o, pops_s
            if tn < best[4]:
                best[3], best[4], best[5], best[6] = fe_k, tn, nn_o, nn_s
            done += 1
        return best

    _pipe_rep()  # warm (compile + upload)
    t_pops, pops, st, fe, t_nn, nn, nn_st = _run_pipeline(REPS)
    computed = float(st["computed_tiles"]) * st["tile_pairs"]
    stages["pops"] = {
        "seconds": round(t_pops, 3),
        "effective_gpairs_per_s": round(N * float(N) / t_pops / 1e9, 1),
        "computed_gpairs_per_s": round(computed / t_pops / 1e9, 1),
        "roofline_frac": round(computed / t_pops / dense_pops_rate, 3),
        **{k: round(st[k], 3) for k in
           ("t_plan", "t_kernel", "t_sweep", "t_host") if k in st},
    }
    if st.get("t_kernel"):
        # device-side roofline: sweep kernel alone, counts download and
        # host finish excluded
        stages["pops"]["sweep_kernel_gpairs_per_s"] = round(
            computed / st["t_kernel"] / 1e9, 1)
        stages["pops"]["sweep_kernel_roofline_frac"] = round(
            computed / st["t_kernel"] / dense_pops_rate, 3)
    total_eff_pairs += float(N) * N
    total_computed += computed
    total_time += t_pops
    print(f"# pops: {t_pops:.3f}s  effective {N * float(N) / t_pops:.3e}"
          f"  computed {computed / t_pops:.3e} pairs/s"
          f"  ({stages['pops']['roofline_frac']:.0%} of dense ceiling)",
          file=sys.stderr)

    # --- nearest neighbors (timed inside the pipeline reps above) ---
    st = nn_st
    computed = float(st["computed_tiles"]) * st["tile_pairs"]
    stages["nn"] = {
        "seconds": round(t_nn, 3),
        "mode": st["mode"],
        "band_prefetched": bool(st.get("band_prefetched")),
        "effective_gpairs_per_s": round(N * float(N) / t_nn / 1e9, 1),
        "computed_gpairs_per_s": round(computed / t_nn / 1e9, 1),
        "roofline_frac": round(computed / t_nn / dense_nn_rate, 3),
        # sub-stage wall clocks from the engine (band pass, phase-2
        # planning, phase-2 sweep + download, host unpermute)
        **{k: round(st[k], 3) for k in
           ("t_band", "t_plan", "t_kernel", "t_sweep", "t_host")
           if k in st},
    }
    if st.get("t_kernel"):
        # the phase-2 sweep kernel alone, with transfer time excluded:
        # the device-side roofline position
        p2_pairs = float(st["phase2_tiles"]) * st["tile_pairs"]
        stages["nn"]["sweep_kernel_gpairs_per_s"] = round(
            p2_pairs / st["t_kernel"] / 1e9, 1)
        stages["nn"]["sweep_kernel_roofline_frac"] = round(
            p2_pairs / st["t_kernel"] / dense_nn_rate, 3)
    total_eff_pairs += float(N) * N
    total_computed += computed
    total_time += t_nn
    print(f"# nn:   {t_nn:.3f}s  effective {N * float(N) / t_nn:.3e}"
          f"  computed {computed / t_nn:.3e} pairs/s"
          f"  ({stages['nn']['roofline_frac']:.0%} of dense ceiling,"
          f" {st['mode']} phase 2)", file=sys.stderr)

    # --- screening series (seeded threshold scan) ---
    thresholds = [np.float32(t) for t in (0.5, 1.0, 1.5, 2.0)]
    max_dist2 = np.float32(4.0 * ops.neighbors.compute_sigma2(nn[1]))
    series = ops.screening.ThresholdSeriesScreener(
        coords, fe, thresholds, row_block=ROW_BLOCK, col_block=COL_BLOCK,
        hd_neighbors=(nn[2], nn[3]))

    def run_series():
        from concurrent.futures import ThreadPoolExecutor
        series.reset()  # each rep re-runs the series cold
        with ThreadPoolExecutor(max_workers=2) as pool:
            # postludes (label fetch + renaming) overlap the next step's
            # device sweeps; the with-exit joins them all. step_submit
            # accumulates each step's stats dict in per_step_stats (the
            # postlude worker adds t_wait/t_fetch/t_norm as it drains).
            futs = [series.step_submit(k, max_dist2, pool)
                    for k in range(len(thresholds))]
            clustering = futs[-1].result()
        # measured: dirty-gated tiles the kernel actually swept
        # (upper-bound fallback without the counter). sweeps/swept are
        # coerced by the postludes after their timed fetch, so the loop
        # above never syncs mid-flight.
        computed = 0.0
        for st in series.per_step_stats:
            swept = st.get("swept_tiles")
            tiles = (float(swept) if swept is not None
                     else float(st["sweeps"]) * st["tiles_per_sweep"])
            computed += tiles * st["tile_pairs"]
        return clustering, computed, list(series.per_step_stats)

    t_scr, (clustering, scr_computed, scr_steps) = _best_of(
        lambda: run_series(), REPS)
    scr_eff = float(sum(float(series.n_below_per_band[k]) ** 2
                        for k in range(len(thresholds))))
    stages["screening"] = {
        "seconds": round(t_scr, 3),
        "effective_gpairs_per_s": round(scr_eff / t_scr / 1e9, 1),
        "computed_gpairs_per_s": round(scr_computed / t_scr / 1e9, 1),
        "roofline_frac": round(scr_computed / t_scr / dense_scr_rate, 3),
        # summed per-step sub-stage walls (pipelined: postlude waits
        # overlap the next step's dispatches, so the sum of components
        # can exceed the series wall). t_plan = host tile-list planning,
        # t_sweep = postlude device-done wait + label download, t_host =
        # name normalization, t_dispatch = the fixpoint calls' host wall.
        # No kernel-only time: the postlude waits do not bound the
        # fixpoint's device time (that needs a profiler trace).
        "t_plan": round(sum(st.get("t_plan", 0.0) for st in scr_steps), 3),
        "t_sweep": round(sum(st.get("t_wait", 0.0) + st.get("t_fetch", 0.0)
                             for st in scr_steps), 3),
        "t_host": round(sum(st.get("t_norm", 0.0) for st in scr_steps), 3),
        "t_dispatch": round(sum(st.get("t_dispatch", 0.0)
                                for st in scr_steps), 3),
        "per_step": [
            {k2: (round(v, 4) if isinstance(v, float) else v)
             for k2, v in st.items() if k2 != "tile_pairs"}
            for st in scr_steps],
    }
    total_eff_pairs += scr_eff
    total_computed += scr_computed
    total_time += t_scr
    n_states = len(np.unique(clustering[clustering > 0]))
    print(f"# screening x{len(thresholds)}: {t_scr:.3f}s"
          f"  computed {scr_computed / t_scr:.3e} pairs/s"
          f"  ({stages['screening']['roofline_frac']:.0%} of dense"
          f" ceiling, {n_states} states at t={thresholds[-1]})",
          file=sys.stderr)

    # --- small-N row (the 100k-frame class a first-time user hits) ---
    # warm per-stage walls at N_SMALL: the big-N rates above amortize
    # fixed dispatch/transfer costs that dominate small runs, so the
    # small row is reported separately. Cold-start (compile) walls are
    # process-level (see the compile ledger), not measured here.
    small = {}
    n_small = int(os.environ.get("BENCH_SMALL_N", 1 << 17))
    if n_small:
        coords_s = synthetic_fel(n_small, D, seed=1)
        eng_s = ops.engine.DensityEngine(coords_s, row_block=ROW_BLOCK,
                                         col_block=COL_BLOCK)

        def _small_rep():
            t0 = time.perf_counter()
            pops_o = eng_s.populations([RADII[0]], nn_band_radius=RADII[0])
            tp = time.perf_counter() - t0
            fe_s = ops.free_energies(pops_o[RADII[0]])
            t1 = time.perf_counter()
            nn_s = eng_s.nearest_neighbors(fe_s)
            tn = time.perf_counter() - t1
            return tp, tn, fe_s, nn_s

        _small_rep()  # warm
        best_tp, best_tn = float("inf"), float("inf")
        for _ in range(max(REPS // 2, 2)):
            tp, tn, fe_s, nn_s = _small_rep()
            best_tp, best_tn = min(best_tp, tp), min(best_tn, tn)
        thr_s = [np.float32(t) for t in (0.8, 1.6)]
        md2_s = np.float32(4.0 * ops.neighbors.compute_sigma2(nn_s[1]))
        ser_s = ops.screening.ThresholdSeriesScreener(
            coords_s, fe_s, thr_s, row_block=ROW_BLOCK,
            col_block=COL_BLOCK, hd_neighbors=(nn_s[2], nn_s[3]))

        def _small_series():
            ser_s.reset()
            c = None
            for k in range(len(thr_s)):
                c = ser_s.step(c, k, md2_s)
            return c

        t_scr_s, _ = _best_of(_small_series, max(REPS // 2, 2))
        small = {
            "n": n_small,
            "pops_seconds": round(best_tp, 3),
            "nn_seconds": round(best_tn, 3),
            "screening_seconds": round(t_scr_s, 3),
            "wall_seconds": round(best_tp + best_tn + t_scr_s, 3),
        }
        print(f"# small-N ({n_small}): pops {best_tp:.3f}s"
              f"  nn {best_tn:.3f}s  screening x{len(thr_s)}"
              f" {t_scr_s:.3f}s", file=sys.stderr)

    value = total_eff_pairs / total_time
    print(json.dumps({
        "metric": f"density pipeline pair-interactions/s (N={N}, D={D},"
                  f" {len(RADII)} radii + NN + {len(thresholds)}-step"
                  " screening, 1 device)",
        "value": round(value / 1e9, 3),
        "unit": "Gpairs/s",
        "vs_baseline": round(value / BASELINE_PAIRS_PER_SEC, 3),
        # measured computed-pair accounting across all three stages
        # (screening's counter is dirty-gated, not an upper bound):
        # fraction of the pairs the dense kernels could have computed in
        # the same wall time
        "computed_gpairs_per_s": round(
            total_computed / (t_pops + t_nn + t_scr) / 1e9, 3),
        "kernel_roofline_frac": round(
            total_computed / (t_pops * dense_pops_rate
                              + t_nn * dense_nn_rate
                              + t_scr * dense_scr_rate), 3),
        "wall_seconds": round(total_time, 3),
        # ceilings are KERNEL-ONLY (device-done barrier on the dense
        # calibration runs) and EVALUATED-pair rates over the full tile
        # grid for every stage
        "checks": checks,
        "small_n": small,
        "ceilings_gpairs_per_s": {
            "kind": "kernel-only-evaluated",
            "pops": round(dense_pops_rate / 1e9, 1),
            "nn": round(dense_nn_rate / 1e9, 1),
            "screening": round(dense_scr_rate / 1e9, 1),
        },
        "stages": stages,
    }))


if __name__ == "__main__":
    main()
