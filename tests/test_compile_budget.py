"""Shape-budget regression guard for the density pipeline.

Every distinct compiled program costs compile time on a cold start, so
the cold CLI wall grows with (program count) x (compile latency): the
power-of-two bucketing in the engine/screener exists to keep the count
fixed. This test runs the full pallas-backend pipeline
(multi-radius pops, NN with band+pruned phase 2, a 4-step seeded
threshold series) and pins the number of clustering_tpu-owned programs
XLA compiles -- a regression here silently re-inflates the cold wall
that the reference's AOT binary (clustering.cpp) never pays.
"""

import collections
import logging

import numpy as np
import pytest

import jax

from clustering_tpu import ops

# programs defined by clustering_tpu (underscore helpers + public jits);
# jax-internal wrappers (convert_element_type, reshape, ...) are counted
# separately and not pinned (they vary with jax version and cost ~no
# compile time).
# 22 -> 23 (round 5): _labels_prefix_packed (one per union-ladder rung;
# 3 rungs here) REPLACES the postlude's anonymous labels_dev[:len] slice
# programs one-for-one -- those compiled as jax-internal jit(slice) and
# were never counted, so the named pack adds counted programs without
# adding cold compiles.
_BUDGET = 23


def _run_pipeline(n=1 << 13, row_block=64, col_block=512):
    from bench import synthetic_fel

    coords = synthetic_fel(n, 4)
    radii = [0.10, 0.15, 0.20]
    eng = ops.engine.DensityEngine(coords, row_block=row_block,
                                   col_block=col_block, backend="pallas")
    pops = eng.populations(radii)
    fe = ops.free_energies(pops[radii[0]])
    nn = eng.nearest_neighbors(fe)
    md2 = np.float32(4.0 * ops.neighbors.compute_sigma2(nn[1]))
    series = ops.screening.ThresholdSeriesScreener(
        coords, fe, [0.5, 1.0, 1.5, 2.0], row_block=row_block,
        col_block=col_block, backend="pallas",
        hd_neighbors=(nn[2], nn[3]))
    clustering = None
    for k in range(4):
        clustering = series.step(clustering, k, md2)
    return clustering


def test_pipeline_compile_budget():
    tally = collections.Counter()

    class Tap(logging.Handler):
        def emit(self, rec):
            msg = rec.getMessage()
            if msg.startswith("Compiling "):
                name = msg.split("Compiling ", 1)[1].split(" with ", 1)[0]
                tally[name] += 1

    tap = Tap()
    log = logging.getLogger("jax._src.interpreters.pxla")
    log.addHandler(tap)
    jax.config.update("jax_log_compiles", True)
    try:
        _run_pipeline()
    finally:
        jax.config.update("jax_log_compiles", False)
        log.removeHandler(tap)

    if not tally:
        pytest.skip("jax compile logging produced no events"
                    " (logger layout changed); budget not checkable")
    ours = {name: cnt for name, cnt in tally.items()
            if name.startswith("jit(_") or "sparse" in name
            or "bbox" in name or "pops" in name}
    n_ours = sum(ours.values())
    detail = ", ".join(f"{k}x{v}" for k, v in sorted(ours.items()))
    assert n_ours <= _BUDGET, (
        f"pipeline now compiles {n_ours} clustering_tpu programs"
        f" (budget {_BUDGET}): {detail} -- every extra distinct shape"
        " adds ~3-5s of remote-compiler latency to every cold CLI run;"
        " widen a bucket instead of minting a new shape, or raise the"
        " budget deliberately")


@pytest.mark.parametrize("finish", ["device", "host"])
def test_precompile_nn_covers_nn_programs(finish, monkeypatch):
    """engine.precompile_nn (the CLI's background compile-overlap hook)
    must warm every clustering_tpu program the real NN call needs --
    shape-exact dummy calls populate the same jit cache, so a follow-up
    nearest_neighbors() may compile only jax-internal wrappers
    (reshape/convert), never a framework kernel. Both finish modes are
    pinned: production N with the native lib selects "host", whose
    ids-only finish program must be warmed too."""
    from bench import synthetic_fel

    monkeypatch.setenv("CLUSTERING_TPU_NN_FINISH", finish)

    tally = collections.Counter()

    class Tap(logging.Handler):
        def emit(self, rec):
            msg = rec.getMessage()
            if msg.startswith("Compiling "):
                name = msg.split("Compiling ", 1)[1].split(" with ", 1)[0]
                tally[name] += 1

    n = 1 << 13
    coords = synthetic_fel(n, 4)
    eng = ops.engine.DensityEngine(coords, row_block=64, col_block=512,
                                   backend="pallas")
    pops = eng.populations([0.10])
    fe = ops.free_energies(pops[0.10])

    tap = Tap()
    log = logging.getLogger("jax._src.interpreters.pxla")
    log.addHandler(tap)
    jax.config.update("jax_log_compiles", True)
    try:
        eng.precompile_nn()
        warmed = sum(tally.values())
        tally.clear()
        eng.nearest_neighbors(fe)
    finally:
        jax.config.update("jax_log_compiles", False)
        log.removeHandler(tap)

    if not warmed:
        pytest.skip("jax compile logging produced no events"
                    " (logger layout changed); coverage not checkable")
    missed = {name: cnt for name, cnt in tally.items()
              if name.startswith("jit(_") or "sparse" in name
              or "bbox" in name}
    assert not missed, (
        f"nearest_neighbors compiled framework programs the precompile"
        f" missed: {sorted(missed)} -- update precompile_nn's dummy-call"
        " list so the CLI's compile overlap keeps covering the NN path")


def test_precompile_nn_covers_tiered_programs(monkeypatch):
    """The tiered phase-2 plan programs (_ub_tiers, _tiered_layout) must
    be covered by precompile_nn: their shapes are N-deterministic, and
    at 1M frames a miss puts a multi-second compile inside the NN
    stage."""
    from bench import synthetic_fel

    tally = collections.Counter()

    class Tap(logging.Handler):
        def emit(self, rec):
            msg = rec.getMessage()
            if msg.startswith("Compiling "):
                name = msg.split("Compiling ", 1)[1].split(" with ", 1)[0]
                tally[name] += 1

    n = 1 << 13
    coords = synthetic_fel(n, 4)
    eng = ops.engine.DensityEngine(coords, row_block=128, col_block=1024,
                                   backend="pallas")
    monkeypatch.setattr(type(eng), "TIERED_MIN_FRAMES", 64)
    monkeypatch.setattr(type(eng), "TIERED_MIN_SAVED_PAIRS", -1.0)
    pops = eng.populations([0.10])
    fe = ops.free_energies(pops[0.10])

    tap = Tap()
    log = logging.getLogger("jax._src.interpreters.pxla")
    log.addHandler(tap)
    jax.config.update("jax_log_compiles", True)
    try:
        eng.precompile_nn()
        warmed = sum(tally.values())
        tally.clear()
        eng.nearest_neighbors(fe)
    finally:
        jax.config.update("jax_log_compiles", False)
        log.removeHandler(tap)

    if not warmed:
        pytest.skip("jax compile logging produced no events"
                    " (logger layout changed); coverage not checkable")
    # the phase-2 sweep's list length is data-dependent; this test pins
    # the tier-PLAN programs, whose shapes are N-deterministic
    missed = {name: cnt for name, cnt in tally.items()
              if any(k in name for k in ("_ub_tiers", "_tiered_layout"))}
    assert not missed, (
        f"the tiered NN plan compiled programs the precompile"
        f" missed: {sorted(missed)}")


def test_precompile_pops_covers_pops_programs():
    """engine.precompile_pops (the CLI's populations compile-overlap
    hook) must warm every clustering_tpu program the real populations
    call needs -- it replays the real plan and compiles the sweep at
    the exact chunk shapes, so a follow-up populations() may compile
    only jax-internal wrappers, never a framework kernel."""
    from bench import synthetic_fel

    tally = collections.Counter()

    class Tap(logging.Handler):
        def emit(self, rec):
            msg = rec.getMessage()
            if msg.startswith("Compiling "):
                name = msg.split("Compiling ", 1)[1].split(" with ", 1)[0]
                tally[name] += 1

    n = 1 << 13
    coords = synthetic_fel(n, 4)
    eng = ops.engine.DensityEngine(coords, row_block=32, col_block=256,
                                   backend="pallas")

    tap = Tap()
    log = logging.getLogger("jax._src.interpreters.pxla")
    log.addHandler(tap)
    jax.config.update("jax_log_compiles", True)
    try:
        eng.precompile_pops([0.10])
        warmed = sum(tally.values())
        tally.clear()
        pops = eng.populations([0.10])
    finally:
        jax.config.update("jax_log_compiles", False)
        log.removeHandler(tap)

    if not warmed:
        pytest.skip("jax compile logging produced no events"
                    " (logger layout changed); coverage not checkable")
    missed = {name: cnt for name, cnt in tally.items()
              if name.startswith("jit(_") or "sparse" in name
              or "bbox" in name or "pops" in name}
    assert not missed, (
        f"populations compiled framework programs the precompile missed:"
        f" {sorted(missed)} -- keep precompile_pops's plan identical to"
        " populations()'s")
    # and the warm must not have corrupted anything: real counts
    other = ops.engine.DensityEngine(coords, row_block=32, col_block=256,
                                     backend="pallas").populations([0.10])
    np.testing.assert_array_equal(pops[0.10], other[0.10])


def test_precompile_pops_covers_device_plan_sweep(monkeypatch):
    """With device planning on (big N), precompile_pops must build the
    real device plan and compile the sweep at its exact list shape (an
    all-zero radius mask skips every tile, so the warm costs no device
    time): the follow-up populations() compiles no framework program
    and its counts are unchanged."""
    from bench import synthetic_fel

    monkeypatch.setenv("CLUSTERING_TPU_DEVICE_PLAN", "1")
    tally = collections.Counter()

    class Tap(logging.Handler):
        def emit(self, rec):
            msg = rec.getMessage()
            if msg.startswith("Compiling "):
                name = msg.split("Compiling ", 1)[1].split(" with ", 1)[0]
                tally[name] += 1

    n = 1 << 13
    coords = synthetic_fel(n, 4)
    eng = ops.engine.DensityEngine(coords, row_block=32, col_block=128,
                                   backend="pallas")

    tap = Tap()
    log = logging.getLogger("jax._src.interpreters.pxla")
    log.addHandler(tap)
    jax.config.update("jax_log_compiles", True)
    try:
        eng.precompile_pops([0.10])
        warmed = {k: v for k, v in tally.items() if "pops_sweep" in k}
        tally.clear()
        pops = eng.populations([0.10])
    finally:
        jax.config.update("jax_log_compiles", False)
        log.removeHandler(tap)

    st = eng.last_stats["populations"]
    assert st.get("plan") == "device"
    if not tally and not warmed:
        pytest.skip("jax compile logging produced no events"
                    " (logger layout changed); coverage not checkable")
    assert sum(warmed.values()) == 1, warmed
    missed = {name: cnt for name, cnt in tally.items()
              if name.startswith("jit(_") or "sweep" in name
              or "bbox" in name or "pops" in name}
    assert not missed, sorted(missed)
    monkeypatch.setenv("CLUSTERING_TPU_DEVICE_PLAN", "0")
    other = ops.engine.DensityEngine(
        coords, row_block=32, col_block=128,
        backend="pallas").populations([0.10])
    np.testing.assert_array_equal(pops[0.10], other[0.10])


def test_series_precompile_covers_fixpoint_programs():
    """ThresholdSeriesScreener.precompile must warm each step's fixpoint
    program exactly (shapes are deterministic given fe + thresholds +
    max_dist2): running the steps afterwards may not compile another
    _sparse_fixpoint program."""
    from bench import synthetic_fel

    tally = collections.Counter()

    class Tap(logging.Handler):
        def emit(self, rec):
            msg = rec.getMessage()
            if msg.startswith("Compiling "):
                name = msg.split("Compiling ", 1)[1].split(" with ", 1)[0]
                tally[name] += 1

    n = 1 << 13
    coords = synthetic_fel(n, 4)
    eng = ops.engine.DensityEngine(coords, row_block=64, col_block=512,
                                   backend="pallas")
    pops = eng.populations([0.10])
    fe = ops.free_energies(pops[0.10])
    nn = eng.nearest_neighbors(fe)
    md2 = np.float32(4.0 * ops.neighbors.compute_sigma2(nn[1]))
    series = ops.screening.ThresholdSeriesScreener(
        coords, fe, [0.5, 1.0, 1.5, 2.0], row_block=64, col_block=512,
        backend="pallas", hd_neighbors=(nn[2], nn[3]))

    tap = Tap()
    log = logging.getLogger("jax._src.interpreters.pxla")
    log.addHandler(tap)
    jax.config.update("jax_log_compiles", True)
    try:
        series.precompile(md2)
        warmed = sum(tally.values())
        tally.clear()
        c = None
        for k in range(4):
            c = series.step(c, k, md2)
    finally:
        jax.config.update("jax_log_compiles", False)
        log.removeHandler(tap)

    if not warmed:
        pytest.skip("jax compile logging produced no events"
                    " (logger layout changed); coverage not checkable")
    missed = {name: cnt for name, cnt in tally.items()
              if "_sparse_fixpoint" in name}
    assert not missed, (
        f"series steps compiled fixpoint programs the precompile missed:"
        f" {sorted(missed)} -- keep precompile's planning identical to"
        " run_device's")
