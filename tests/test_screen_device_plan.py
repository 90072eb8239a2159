"""Device-planned screening (CLUSTERING_TPU_DEVICE_PLAN=1) must be
bit-equal to the host planner, with and without hd-edge seeds. Big-N
planning swaps the implementation, never the plan (the same
invariant tests/test_device_plan.py pins for the density engine).

Reference: the screening driver runs at any N with ~zero launch cost
(src/density_clustering_cuda.cu:396-594); here the device planner keeps
the O(tiles) work off the host at 16M frames.
"""

import numpy as np
import pytest

from clustering_tpu import ops

RB, CB = 8, 16


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(41)
    a = rng.normal((0.0, 0.0, 0.0), 0.15, size=(300, 3))
    b = rng.normal((1.5, 1.0, -0.5), 0.2, size=(260, 3))
    c = rng.normal((-1.0, 1.2, 0.8), 0.25, size=(200, 3))
    return np.concatenate([a, b, c]).astype(np.float32)


@pytest.fixture(scope="module")
def fe(blobs):
    pops = ops.populations(blobs, [0.4], backend="xla",
                           row_block=RB, col_block=CB)[0.4]
    return ops.free_energies(pops)


THRESHOLDS = (0.5, 1.0, 1.5, 2.5)
MD2 = np.float32(0.08)


def _run_series(blobs, fe, monkeypatch, plan, hd=None):
    monkeypatch.setenv("CLUSTERING_TPU_DEVICE_PLAN", plan)
    series = ops.screening.ThresholdSeriesScreener(
        blobs, fe, [np.float32(t) for t in THRESHOLDS],
        row_block=RB, col_block=CB, backend="pallas",
        hd_neighbors=hd)
    outs, prev = [], None
    for k in range(len(THRESHOLDS)):
        prev = series.step(prev, k, MD2)
        outs.append(prev)
    return outs, series


def test_series_device_plan_bit_equal(blobs, fe, monkeypatch):
    got, s_dev = _run_series(blobs, fe, monkeypatch, "1")
    want, s_host = _run_series(blobs, fe, monkeypatch, "0")
    plans_d = [st.get("plan") for st in s_dev.per_step_stats]
    plans_h = [st.get("plan") for st in s_host.per_step_stats]
    assert plans_d and all(p == "device" for p in plans_d)
    assert all(p == "host" for p in plans_h)
    # same plans: identical per-step swept-tile accounting
    for st_d, st_h in zip(s_dev.per_step_stats, s_host.per_step_stats):
        assert float(st_d["swept_tiles"]) == float(st_h["swept_tiles"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seeded", [False, True])
def test_series_device_plan_matches_xla(blobs, fe, monkeypatch, seeded):
    """Both planners, cold or seeded from the hd edges, land on the XLA
    oracle's clustering at every threshold."""
    hd = None
    if seeded:
        nn = ops.nearest_neighbors(blobs, fe, backend="xla",
                                   row_block=RB, col_block=CB)
        hd = (np.asarray(nn[2]), np.asarray(nn[3]))
    got, s_dev = _run_series(blobs, fe, monkeypatch, "1", hd=hd)
    want, _ = _run_series(blobs, fe, monkeypatch, "0", hd=hd)
    assert all(st["plan"] == "device" for st in s_dev.per_step_stats)
    xla = ops.screening.ThresholdSeriesScreener(
        blobs, fe, [np.float32(t) for t in THRESHOLDS],
        row_block=RB, col_block=CB, backend="xla")
    prev = None
    for k in range(len(THRESHOLDS)):
        prev = xla.step(prev, k, MD2)
        np.testing.assert_array_equal(got[k], prev)
        np.testing.assert_array_equal(want[k], prev)


def test_series_device_plan_hd_seeds(blobs, fe, monkeypatch):
    """hd-edge seeded incremental steps under the device planner."""
    nn = ops.nearest_neighbors(blobs, fe, backend="xla",
                               row_block=RB, col_block=CB)
    hd = (np.asarray(nn[2]), np.asarray(nn[3]))
    got, _ = _run_series(blobs, fe, monkeypatch, "1", hd=hd)
    want, _ = _run_series(blobs, fe, monkeypatch, "0", hd=hd)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_engine_run_device_plan_bit_equal(blobs, fe, monkeypatch):
    """Single-shot ScreeningEngine.run under the device planner vs the
    XLA oracle (full sweep, no series machinery)."""
    from clustering_tpu.models import density as dm
    cs = blobs[dm.sorted_fe_order(fe)]
    labels0 = np.arange(len(blobs), dtype=np.int32)
    want = ops.screening_labels(cs, labels0, 400, 0.2,
                                row_block=RB, col_block=CB, backend="xla")
    monkeypatch.setenv("CLUSTERING_TPU_DEVICE_PLAN", "1")
    eng = ops.screening.ScreeningEngine(cs, row_block=RB, col_block=CB,
                                        backend="pallas")
    got = eng.run(labels0, 400, np.float32(0.2))
    assert eng.last_stats["plan"] == "device"
    np.testing.assert_array_equal(want, got)


def test_precompile_device_plan(blobs, fe, monkeypatch):
    """precompile under the device planner must warm without error,
    share its tile lists with the real steps (the engine's tile cache),
    and leave the results bit-equal."""
    monkeypatch.setenv("CLUSTERING_TPU_DEVICE_PLAN", "1")
    series = ops.screening.ThresholdSeriesScreener(
        blobs, fe, [np.float32(t) for t in THRESHOLDS],
        row_block=RB, col_block=CB, backend="pallas")
    series.precompile(MD2)
    assert series.engine._tile_cache  # plans landed in the shared cache
    prev = None
    for k in range(len(THRESHOLDS)):
        prev = series.step(prev, k, MD2)
    want, _ = _run_series(blobs, fe, monkeypatch, "0")
    np.testing.assert_array_equal(prev, want[-1])


@pytest.mark.parametrize("plan", ["0", "1"])
def test_precompile_compile_only(blobs, fe, monkeypatch, plan):
    """The compile-only precompile (also the during-NN early warm, run
    with an ESTIMATED max_dist2) must never execute or perturb anything:
    results
    stay bit-equal to the host-planned reference run, even when the
    estimate misses the real threshold slightly."""
    monkeypatch.setenv("CLUSTERING_TPU_DEVICE_PLAN", plan)
    series = ops.screening.ThresholdSeriesScreener(
        blobs, fe, [np.float32(t) for t in THRESHOLDS],
        row_block=RB, col_block=CB, backend="pallas")
    series.precompile(np.float32(MD2 * 1.07))
    series.precompile(MD2)
    prev = None
    for k in range(len(THRESHOLDS)):
        prev = series.step(prev, k, MD2)
    want, _ = _run_series(blobs, fe, monkeypatch, "0")
    np.testing.assert_array_equal(prev, want[-1])