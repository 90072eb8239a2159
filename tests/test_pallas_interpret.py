"""Pallas kernels in interpreter mode (CPU) must agree with the XLA path
and the brute-force oracles on tiny fixtures -- the same Triton kernels run
compiled on the GPU (chip_smoke.py checks them there at real widths)."""

import numpy as np
import pytest

from clustering_tpu import ops
from clustering_tpu.models import density as density_model


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(21)
    a = rng.normal((0.0, 0.0), 0.15, size=(40, 2))
    b = rng.normal((2.0, 1.0), 0.2, size=(30, 2))
    return np.concatenate([a, b]).astype(np.float32)


def test_pallas_populations(blobs):
    radii = [0.3, 0.6]
    want = ops.populations(blobs, radii, backend="xla",
                           row_block=8, col_block=16)
    got = ops.populations(blobs, radii, backend="pallas",
                          row_block=8, col_block=16)
    for r in radii:
        np.testing.assert_array_equal(want[r], got[r])


def test_pallas_populations_unpruned(blobs):
    radii = [0.4]
    want = ops.populations(blobs, radii, backend="xla",
                           row_block=8, col_block=16)
    got = ops.populations(blobs, radii, backend="pallas", prune=False,
                          row_block=8, col_block=16)
    np.testing.assert_array_equal(want[0.4], got[0.4])


def test_pallas_nearest_neighbors(blobs):
    pops = ops.populations(blobs, [0.4], backend="xla",
                           row_block=8, col_block=16)[0.4]
    fe = ops.free_energies(pops)
    want = ops.nearest_neighbors(blobs, fe, backend="xla",
                                 row_block=8, col_block=16)
    got = ops.nearest_neighbors(blobs, fe, backend="pallas",
                                row_block=8, col_block=16)
    # indices must match exactly; distances may differ by fma rounding
    # (the Pallas kernel fuses mul+add like the reference CUDA kernel)
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[2], got[2])
    np.testing.assert_allclose(want[1], got[1], rtol=1e-6)
    np.testing.assert_allclose(want[3], got[3], rtol=1e-6)


def test_pallas_screening(blobs):
    pops = ops.populations(blobs, [0.4], backend="xla",
                           row_block=8, col_block=16)[0.4]
    fe = ops.free_energies(pops)
    order = density_model.sorted_fe_order(fe)
    cs = blobs[order]
    labels0 = np.arange(len(blobs), dtype=np.int32)
    want = ops.screening_labels(cs, labels0, 50, 0.1, backend="xla",
                                row_block=8, col_block=16)
    got = ops.screening_labels(cs, labels0, 50, 0.1, backend="pallas",
                               row_block=8, col_block=16)
    np.testing.assert_array_equal(want, got)


def test_pallas_incremental_screening(blobs):
    """A threshold series with incremental (new-edges-only) sweeps must
    produce the same partitions as full sweeps."""
    from clustering_tpu.models.density import screening_step
    pops = ops.populations(blobs, [0.4], backend="xla",
                           row_block=8, col_block=16)[0.4]
    fe = ops.free_energies(pops)
    order = density_model.sorted_fe_order(fe)
    cs = blobs[order]
    eng_p = ops.screening.ScreeningEngine(cs, row_block=8, col_block=16,
                                          backend="pallas")
    eng_x = ops.screening.ScreeningEngine(cs, row_block=8, col_block=16,
                                          backend="xla")
    prev_p = prev_x = None
    for t in (0.5, 1.0, 1.5, 2.5):
        prev_p = screening_step(fe, np.full(len(blobs), 0.02, np.float32),
                                t, blobs, prev_p, order=order,
                                coords_sorted=cs, engine=eng_p,
                                incremental=prev_p is not None)
        prev_x = screening_step(fe, np.full(len(blobs), 0.02, np.float32),
                                t, blobs, prev_x, order=order,
                                coords_sorted=cs, engine=eng_x)
        np.testing.assert_array_equal(prev_p, prev_x)


def test_threshold_series_screener_matches_fe_order_path(blobs):
    """The (band, morton)-ordered series screener must reproduce the
    FE-ordered screening exactly, names included."""
    from clustering_tpu.models.density import screening_step
    pops = ops.populations(blobs, [0.4], backend="xla",
                           row_block=8, col_block=16)[0.4]
    fe = ops.free_energies(pops)
    nh_dist = np.full(len(blobs), 0.02, np.float32)
    thresholds = [np.float32(t) for t in (0.5, 1.0, 1.5, 2.5)]
    md2 = np.float32(4.0 * ops.neighbors.compute_sigma2(nh_dist))
    for backend in ("pallas", "xla"):
        series = ops.screening.ThresholdSeriesScreener(
            blobs, fe, thresholds, row_block=8, col_block=16,
            backend=backend)
        order = density_model.sorted_fe_order(fe)
        cs = blobs[order]
        eng = ops.screening.ScreeningEngine(cs, row_block=8, col_block=16,
                                            backend="xla")
        prev_s = prev_r = None
        for k, t in enumerate(thresholds):
            prev_s = series.step(prev_s, k, md2)
            prev_r = screening_step(fe, nh_dist, float(t), blobs, prev_r,
                                    order=order, coords_sorted=cs,
                                    engine=eng)
            np.testing.assert_array_equal(prev_s, prev_r)


def test_series_screener_generic_seed_path(blobs):
    """Passing a copy of the previous clustering (identity check fails)
    must produce the same results as the device-resident continuation."""
    pops = ops.populations(blobs, [0.4], backend="xla",
                           row_block=8, col_block=16)[0.4]
    fe = ops.free_energies(pops)
    thresholds = [np.float32(t) for t in (0.5, 1.0, 2.0)]
    md2 = np.float32(0.08)
    s1 = ops.screening.ThresholdSeriesScreener(
        blobs, fe, thresholds, row_block=8, col_block=16)
    s2 = ops.screening.ThresholdSeriesScreener(
        blobs, fe, thresholds, row_block=8, col_block=16)
    a = b = None
    for k in range(len(thresholds)):
        a = s1.step(a, k, md2)
        b = s2.step(b.copy() if b is not None else None, k, md2)
        np.testing.assert_array_equal(a, b)


def test_bidir_screening_matches_symmetric(blobs):
    """The upper-triangular bidirectional fixpoint must produce the same
    labels as the symmetric XLA fixpoint (every ordered pair swept), for
    both full runs and the incremental (row_lo) series path."""
    from clustering_tpu.models import density as dm
    from clustering_tpu.ops.screening import (ScreeningEngine,
                                              ThresholdSeriesScreener)
    pops = ops.populations(blobs, [0.4], backend="xla",
                           row_block=8, col_block=16)[0.4]
    fe = ops.free_energies(pops)
    cs = blobs[dm.sorted_fe_order(fe)]
    labels0 = np.arange(len(blobs), dtype=np.int32)
    for nb, t in ((150, 0.08), (300, 0.2), (len(blobs), 0.5)):
        want = ops.screening_labels(cs, labels0, nb, t,
                                    row_block=8, col_block=16)
        eng = ScreeningEngine(cs, row_block=8, col_block=16,
                              backend="pallas")
        got = eng.run(labels0, nb, np.float32(t))
        assert eng.last_stats["tiles_per_sweep"] > 0
        np.testing.assert_array_equal(want, got)
    # series continuation: incremental row_lo tile lists vs the XLA
    # series
    thresholds = [np.float32(t) for t in (0.5, 1.0, 2.0)]
    md2 = np.float32(0.08)
    s_b = ThresholdSeriesScreener(blobs, fe, thresholds,
                                  row_block=8, col_block=16,
                                  backend="pallas")
    s_x = ThresholdSeriesScreener(blobs, fe, thresholds,
                                  row_block=8, col_block=16,
                                  backend="xla")
    a = b = None
    for k in range(len(thresholds)):
        a = s_b.step(a, k, md2)
        b = s_x.step(b, k, md2)
        np.testing.assert_array_equal(a, b, err_msg=f"threshold {k}")


def _bigger_blobs(n=600, seed=5):
    rng = np.random.default_rng(seed)
    a = rng.normal((0.0, 0.0, 0.0), 0.15, size=(n // 2, 3))
    b = rng.normal((1.5, 1.0, -0.5), 0.2, size=(n - n // 2, 3))
    return np.concatenate([a, b]).astype(np.float32)


def test_engine_nn_band_subtract_path():
    """Enough column blocks that the two-phase band pass runs and (when the
    band's Morton order wins the work comparison) band-covered tiles are
    subtracted from phase 2 and merged back (engine.nearest_neighbors)."""
    coords = _bigger_blobs()
    eng = ops.engine.DensityEngine(coords, row_block=8, col_block=16,
                                   backend="pallas")
    pops = eng.populations([0.4])
    fe = ops.free_energies(pops[0.4])
    want = ops.nearest_neighbors(coords, fe, backend="xla",
                                 row_block=8, col_block=16)
    for bb in (1, 2):
        got = eng.nearest_neighbors(fe, band_blocks=bb)
        np.testing.assert_array_equal(want[0], got[0])
        np.testing.assert_array_equal(want[2], got[2])
        np.testing.assert_allclose(want[1], got[1], rtol=1e-6)
        np.testing.assert_allclose(want[3], got[3], rtol=1e-6)


def test_engine_nn_band_covers_everything():
    """A single dense clump: every admissible tile sits inside the band, so
    phase 2 can be empty after band subtraction (the not-active branch)."""
    rng = np.random.default_rng(9)
    coords = rng.normal(0.0, 0.05, size=(96, 2)).astype(np.float32)
    eng = ops.engine.DensityEngine(coords, row_block=8, col_block=16,
                                   backend="pallas")
    pops = eng.populations([0.3])
    fe = ops.free_energies(pops[0.3])
    want = ops.nearest_neighbors(coords, fe, backend="xla",
                                 row_block=8, col_block=16)
    got = eng.nearest_neighbors(fe, band_blocks=1)
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[2], got[2])


def test_series_screener_union_prefix_quantization():
    """Threshold bands crossing power-of-two col-block-count boundaries
    exercise distinct static union_size values in the sparse fixpoint."""
    coords = _bigger_blobs(n=500, seed=13)
    pops = ops.populations(coords, [0.4], backend="xla",
                           row_block=8, col_block=16)[0.4]
    fe = ops.free_energies(pops)
    nn = ops.nearest_neighbors(coords, fe, backend="xla",
                               row_block=8, col_block=16)
    sigma2 = ops.neighbors.compute_sigma2(nn[1])
    max_dist2 = np.float32(4.0 * sigma2)
    qs = np.quantile(fe[np.isfinite(fe)], [0.1, 0.35, 0.7, 1.0])
    thresholds = [np.float32(t) for t in qs]
    ref = ops.screening.ThresholdSeriesScreener(
        coords, fe, thresholds, row_block=8, col_block=16, backend="xla")
    got = ops.screening.ThresholdSeriesScreener(
        coords, fe, thresholds, row_block=8, col_block=16, backend="pallas")
    c_r = c_g = None
    for k in range(len(thresholds)):
        c_r = ref.step(c_r, k, max_dist2)
        c_g = got.step(c_g, k, max_dist2)
        np.testing.assert_array_equal(c_r, c_g)


def test_engine_nn_no_neighbor_sentinels():
    """Frames with no admissible neighbor must report (0, 0.0), not an
    index latched at infinite distance (kernel inf-row guard): the global
    FE minimum has no higher-density neighbor, and in an all-identical
    trajectory every pair is excluded as zero-distance."""
    rng = np.random.default_rng(3)
    coords = rng.normal(0.0, 0.3, size=(62, 2)).astype(np.float32)
    pops = ops.populations(coords, [0.5], backend="xla",
                           row_block=8, col_block=16)[0.5]
    fe = ops.free_energies(pops)
    want = ops.nearest_neighbors(coords, fe, backend="xla",
                                 row_block=8, col_block=16)
    got = ops.nearest_neighbors(coords, fe, backend="pallas",
                                row_block=8, col_block=16)
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[2], got[2])
    # distances may differ by fma-contraction ulps across backends
    np.testing.assert_allclose(want[1], got[1], rtol=1e-6)
    np.testing.assert_allclose(want[3], got[3], rtol=1e-6)
    fe_min = int(np.argmin(fe))
    assert got[2][fe_min] == 0 and got[3][fe_min] == 0.0

    # all frames identical: every pair excluded (d2 == 0), fe all equal
    same = np.zeros((16, 2), dtype=np.float32)
    fe_same = np.zeros(16, dtype=np.float32)
    got = ops.nearest_neighbors(same, fe_same, backend="pallas",
                                row_block=8, col_block=16)
    for arr in got:
        np.testing.assert_array_equal(np.asarray(arr),
                                      np.zeros(16, dtype=np.asarray(arr).dtype))


def test_nn_finish_mode_gate(monkeypatch):
    """Finish mode: the fused device finish by default at every n (the
    card recomputes distances with the sweep's own arithmetic); the
    ids-only host recompute only when CLUSTERING_TPU_NN_FINISH=host."""
    from clustering_tpu.ops.engine import _nn_finish_mode
    monkeypatch.delenv("CLUSTERING_TPU_NN_FINISH", raising=False)
    assert _nn_finish_mode() == "device"
    monkeypatch.setenv("CLUSTERING_TPU_NN_FINISH", "device")
    assert _nn_finish_mode() == "device"
    monkeypatch.setenv("CLUSTERING_TPU_NN_FINISH", "host")
    assert _nn_finish_mode() == "host"


def test_engine_nn_finish_host_matches_device(monkeypatch):
    """The host finish (ids-only download + distance recompute — native
    single pass when the library loads, numpy fallback otherwise) must
    agree with the fused device finish: ids/partitions exactly;
    distances to fma-contraction ulps (XLA contracts the device
    finish's mul+add to fma while the host recompute rounds twice --
    the documented nn-distance note in docs/PARITY.md)."""
    coords = _bigger_blobs(n=500, seed=11)
    eng = ops.engine.DensityEngine(coords, row_block=8, col_block=16,
                                   backend="pallas")
    fe = ops.free_energies(eng.populations([0.4])[0.4])
    monkeypatch.setenv("CLUSTERING_TPU_NN_FINISH", "device")
    want = eng.nearest_neighbors(fe)
    monkeypatch.setenv("CLUSTERING_TPU_NN_FINISH", "host")
    got = eng.nearest_neighbors(fe)
    np.testing.assert_array_equal(np.asarray(want[0]), np.asarray(got[0]))
    np.testing.assert_array_equal(np.asarray(want[2]), np.asarray(got[2]))
    np.testing.assert_allclose(want[1], got[1], rtol=1e-6)
    np.testing.assert_allclose(want[3], got[3], rtol=1e-6)


def test_engine_nn_finish_u24_matches_i32(monkeypatch):
    """The u24 byte-plane ids download (6 bytes/frame) must produce
    results identical to the int32 ids download, and the engine must
    select it exactly when the native decoder is present."""
    from clustering_tpu.utils import textio_native
    if not textio_native.has_nn_finish_u24():
        pytest.skip("native u24 finish unavailable")
    coords = _bigger_blobs(n=500, seed=11)
    eng = ops.engine.DensityEngine(coords, row_block=8, col_block=16,
                                   backend="pallas")
    fe = ops.free_energies(eng.populations([0.4])[0.4])
    monkeypatch.setenv("CLUSTERING_TPU_NN_FINISH", "host")
    want = eng.nearest_neighbors(fe)
    assert eng.last_stats["nn"]["ids_format"] == "u24"
    monkeypatch.setattr(textio_native, "has_nn_finish_u24", lambda: False)
    got = eng.nearest_neighbors(fe)
    assert eng.last_stats["nn"]["ids_format"] == "i32"
    for i in range(4):
        np.testing.assert_array_equal(np.asarray(want[i]),
                                      np.asarray(got[i]))


def test_native_nn_finish_u24_matches_i32_decoder():
    """Fuzz the native u24 decoder against the int32 native finish,
    including absent sentinels (INT32_MAX -> 0xFFFFFF remap)."""
    from clustering_tpu.utils import textio_native
    if not textio_native.has_nn_finish_u24():
        pytest.skip("native u24 finish unavailable")
    rng = np.random.default_rng(41)
    n, d = 733, 3
    coords = rng.normal(size=(n, d)).astype(np.float32)
    jj = rng.integers(0, n, size=(2, n)).astype(np.int32)
    imax = np.iinfo(np.int32).max
    jj[rng.random((2, n)) < 0.07] = imax
    want = textio_native.nn_finish(coords, jj)
    j24 = np.where(jj == imax, 0xFFFFFF, jj)
    packed = np.stack([j24 & 0xFF, (j24 >> 8) & 0xFF,
                       (j24 >> 16) & 0xFF], axis=1).astype(np.uint8)
    got = textio_native.nn_finish_u24(coords, packed)
    assert want is not None and got is not None
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_engine_nn_finish_streamed_matches_plain(monkeypatch):
    """The streamed host finish (chunked ids download overlapped with the
    per-chunk native distance recompute) must be bit-identical to the
    single-fetch host finish: the recompute is per-element, so chunking
    cannot change any value. Uneven final chunk exercised (500 % 3)."""
    from clustering_tpu.utils import textio_native
    if not textio_native.available():
        import pytest
        pytest.skip("native textio unavailable")
    coords = _bigger_blobs(n=500, seed=11)
    eng = ops.engine.DensityEngine(coords, row_block=8, col_block=16,
                                   backend="pallas")
    fe = ops.free_energies(eng.populations([0.4])[0.4])
    monkeypatch.setenv("CLUSTERING_TPU_NN_FINISH", "host")
    monkeypatch.setenv("CLUSTERING_TPU_NN_FINISH_CHUNKS", "1")
    want = eng.nearest_neighbors(fe)
    monkeypatch.setenv("CLUSTERING_TPU_NN_FINISH_CHUNKS", "3")
    got = eng.nearest_neighbors(fe)
    for i in range(4):
        np.testing.assert_array_equal(np.asarray(want[i]),
                                      np.asarray(got[i]))


def test_native_nn_finish_matches_numpy_fallback():
    """Fuzz-pin the native nn_finish postlude against the engine's numpy
    fallback semantics, including the INT32_MAX no-neighbor sentinel."""
    from clustering_tpu.utils import textio_native
    if not textio_native.available():
        import pytest
        pytest.skip("native textio unavailable")
    rng = np.random.default_rng(7)
    imax = np.iinfo(np.int32).max
    for n, d in ((1, 1), (63, 3), (1000, 4), (257, 9)):
        coords = (rng.normal(size=(n, d)) * 8).astype(np.float32)
        jj = rng.integers(0, n, size=(2, n)).astype(np.int32)
        jj[:, rng.random(n) < 0.1] = imax
        res = textio_native.nn_finish(coords, jj)
        if res is None:
            import pytest
            pytest.skip("stale native library without nn_finish_host")
        for row, (j_got, d_got) in enumerate(zip(res[:2], res[2:])):
            j = jj[row].astype(np.int64)
            absent = j == imax
            j[absent] = 0
            acc = np.zeros(n, dtype=np.float32)
            for k in range(d):
                diff = coords[:, k] - coords[j, k]
                acc = acc + diff * diff
            acc[absent] = 0.0
            np.testing.assert_array_equal(j_got, j)
            np.testing.assert_array_equal(d_got.view(np.uint32),
                                          acc.view(np.uint32))


def test_native_pops_finish_matches_numpy_fallback():
    """Fuzz-pin the native pops postlude (strided scatter-unsort +
    int64 widen) against the engine's numpy fallback semantics."""
    from clustering_tpu.utils import textio_native
    if not textio_native.available():
        import pytest
        pytest.skip("native textio unavailable")
    rng = np.random.default_rng(13)
    for r, n, pad in ((1, 1, 0), (3, 777, 247), (2, 4096, 0)):
        cp = rng.integers(0, 1 << 20, size=(r, n + pad)).astype(np.int32)
        order = np.argsort(rng.random(n))
        got = textio_native.pops_finish(cp, n, order)
        if got is None:
            import pytest
            pytest.skip("stale native library without pops_finish_host")
        want = np.empty((r, n), dtype=np.int64)
        want[:, order] = cp[:, :n]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            textio_native.pops_finish(cp, n, None),
            cp[:, :n].astype(np.int64))


def test_pops_counts_narrow_download(blobs):
    """The uint16-narrowed counts download must trigger by default when
    every per-radius maximum fits, be bit-equal to the XLA oracle, and
    fall back to the int32 fetch when the cap is exceeded."""
    radii = [0.3, 0.6]
    want = ops.populations(blobs, radii, backend="xla",
                           row_block=8, col_block=16)
    eng = ops.engine.DensityEngine(blobs, row_block=8, col_block=16,
                                   backend="pallas")
    got = eng.populations(radii)
    assert eng.last_stats["populations"]["counts_dtype"] == "uint16"
    for r in radii:
        np.testing.assert_array_equal(want[r], got[r])
        assert got[r].dtype == np.int64
    # force the wide fallback (instance override so the class default
    # stays untouched) and require identical results
    eng2 = ops.engine.DensityEngine(blobs, row_block=8, col_block=16,
                                    backend="pallas")
    eng2.POPS_COUNTS_NARROW_MAX = -1
    got2 = eng2.populations(radii)
    assert eng2.last_stats["populations"]["counts_dtype"] == "int32"
    for r in radii:
        np.testing.assert_array_equal(want[r], got2[r])


def test_native_pops_finish_u16_matches_numpy():
    """The narrow (uint16) native pops postlude must match the widened
    numpy semantics, strided and unstrided."""
    from clustering_tpu.utils import textio_native
    if not textio_native.available():
        pytest.skip("native textio unavailable")
    rng = np.random.default_rng(29)
    for r, n, pad in ((1, 1, 0), (3, 777, 247), (2, 4096, 0)):
        cp = rng.integers(0, 1 << 16, size=(r, n + pad)).astype(np.uint16)
        order = np.argsort(rng.random(n))
        got = textio_native.pops_finish(cp, n, order)
        if got is None:
            pytest.skip("stale native library without pops_finish_host")
        want = np.empty((r, n), dtype=np.int64)
        want[:, order] = cp[:, :n]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            textio_native.pops_finish(cp, n, None),
            cp[:, :n].astype(np.int64))


def test_engine_nn_tiered_phase2():
    """ub-quantile-tiered phase 2 (tier_qs) must agree exactly with the
    per-row-block-bounded pass and the XLA oracle."""
    coords = _bigger_blobs(n=700, seed=17)
    eng = ops.engine.DensityEngine(coords, row_block=8, col_block=16,
                                   backend="pallas")
    pops = eng.populations([0.4])
    fe = ops.free_energies(pops[0.4])
    want = ops.nearest_neighbors(coords, fe, backend="xla",
                                 row_block=8, col_block=16)
    for qs in ((0.5, 0.9, 0.99), (0.9,), (0.5, 0.99)):
        got = eng.nearest_neighbors(fe, band_blocks=1, tier_qs=qs)
        np.testing.assert_array_equal(want[0], got[0])
        np.testing.assert_array_equal(want[2], got[2])
        np.testing.assert_allclose(want[1], got[1], rtol=1e-6)
        np.testing.assert_allclose(want[3], got[3], rtol=1e-6)


def test_engine_nn_auto_tier_decision(monkeypatch):
    """tier_qs='auto' plans the tiered layout only when a typical-best
    reduction could clear the profitability threshold, and falls back to
    the block-bounded pass when the plan saves too little -- both
    branches must stay exact vs the XLA oracle."""
    coords = _bigger_blobs(n=700, seed=17)
    eng = ops.engine.DensityEngine(coords, row_block=8, col_block=16,
                                   backend="pallas")
    pops = eng.populations([0.4])
    fe = ops.free_energies(pops[0.4])
    want = ops.nearest_neighbors(coords, fe, backend="xla",
                                 row_block=8, col_block=16)
    # default thresholds: toy n never reaches TIERED_MIN_FRAMES -> the
    # plan is never attempted
    got = eng.nearest_neighbors(fe, band_blocks=1, tier_qs="auto")
    assert eng.last_stats["nn"]["mode"] == "block-bound"
    np.testing.assert_array_equal(want[0], got[0])
    # force the auto path to plan (any positive saving accepted)
    monkeypatch.setattr(type(eng), "TIERED_MIN_FRAMES", 1)
    monkeypatch.setattr(type(eng), "TIERED_MIN_SAVED_PAIRS", -1.0)
    got = eng.nearest_neighbors(fe, band_blocks=1, tier_qs="auto")
    assert eng.last_stats["nn"]["mode"] == "tiered"
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[2], got[2])
    np.testing.assert_allclose(want[1], got[1], rtol=1e-6)
    np.testing.assert_allclose(want[3], got[3], rtol=1e-6)
    # planning gate: an impossible saving requirement skips the plan
    # entirely (no tiered attempt, still exact)
    monkeypatch.setattr(type(eng), "TIERED_MIN_SAVED_PAIRS", 1e30)
    got = eng.nearest_neighbors(fe, band_blocks=1, tier_qs="auto")
    assert eng.last_stats["nn"]["mode"] == "block-bound"
    np.testing.assert_array_equal(want[0], got[0])


def test_series_screener_hd_seeding_matches_unseeded():
    """Seeding newly-admitted frames with their nearest-higher-density
    edge (when below 4 sigma^2) must not change any partition or name."""
    coords = _bigger_blobs(n=500, seed=23)
    pops = ops.populations(coords, [0.4], backend="xla",
                           row_block=8, col_block=16)[0.4]
    fe = ops.free_energies(pops)
    nn = ops.nearest_neighbors(coords, fe, backend="xla",
                               row_block=8, col_block=16)
    md2 = np.float32(4.0 * ops.neighbors.compute_sigma2(nn[1]))
    qs = np.quantile(fe[np.isfinite(fe)], [0.2, 0.6, 1.0])
    thresholds = [np.float32(t) for t in qs]
    for backend in ("pallas", "xla"):
        plain = ops.screening.ThresholdSeriesScreener(
            coords, fe, thresholds, row_block=8, col_block=16,
            backend=backend)
        seeded = ops.screening.ThresholdSeriesScreener(
            coords, fe, thresholds, row_block=8, col_block=16,
            backend=backend, hd_neighbors=(nn[2], nn[3]))
        a = b = None
        per_step = []
        for k in range(len(thresholds)):
            a = plain.step(a, k, md2)
            b = seeded.step(b, k, md2)
            np.testing.assert_array_equal(a, b)
            per_step.append(a)
        # the generic (copied-seed) path with hd seeding as well
        seeded2 = ops.screening.ThresholdSeriesScreener(
            coords, fe, thresholds, row_block=8, col_block=16,
            backend=backend, hd_neighbors=(nn[2], nn[3]))
        c = None
        for k in range(len(thresholds)):
            c = seeded2.step(c.copy() if c is not None else None, k, md2)
            np.testing.assert_array_equal(per_step[k], c)


def test_series_step_submit_matches_step():
    """step_submit (deferred fetch+normalize postlude, overlapping the
    next step's device sweeps) must be bit-identical to the synchronous
    step across the series, including a cold empty band, an empty
    mid-series band (early-out repeats the previous output), and a
    re-run after reset()."""
    from concurrent.futures import ThreadPoolExecutor
    coords = _bigger_blobs(n=500, seed=29)
    pops = ops.populations(coords, [0.4], backend="xla",
                           row_block=8, col_block=16)[0.4]
    fe = ops.free_energies(pops)
    nn = ops.nearest_neighbors(coords, fe, backend="xla",
                               row_block=8, col_block=16)
    md2 = np.float32(4.0 * ops.neighbors.compute_sigma2(nn[1]))
    finite = fe[np.isfinite(fe)]
    q = np.quantile(finite, [0.4, 1.0])
    thresholds = [np.float32(finite.min() - 1.0),  # cold empty band
                  np.float32(q[0]),
                  np.float32(q[0]) + np.float32(1e-6),  # empty band
                  np.float32(q[1])]
    for backend in ("pallas", "xla"):
        sync = ops.screening.ThresholdSeriesScreener(
            coords, fe, thresholds, row_block=8, col_block=16,
            backend=backend, hd_neighbors=(nn[2], nn[3]))
        asyn = ops.screening.ThresholdSeriesScreener(
            coords, fe, thresholds, row_block=8, col_block=16,
            backend=backend, hd_neighbors=(nn[2], nn[3]))
        assert (asyn.n_below_per_band[2] == asyn.n_below_per_band[1]
                and asyn.n_below_per_band[0] == 0), "bands not empty"
        want = []
        a = None
        for k in range(len(thresholds)):
            a = sync.step(a, k, md2)
            want.append(a)
        with ThreadPoolExecutor(max_workers=2) as pool:
            futs = [asyn.step_submit(k, md2, pool)
                    for k in range(len(thresholds))]
            for k, f in enumerate(futs):
                np.testing.assert_array_equal(want[k], f.result())
            # reset() forgets all series state: a second driving of the
            # same screener must reproduce the series from cold
            asyn.reset()
            futs = [asyn.step_submit(k, md2, pool)
                    for k in range(len(thresholds))]
            for k, f in enumerate(futs):
                np.testing.assert_array_equal(want[k], f.result())


def test_high_dimension_parity():
    """D=32 collective variables (well past the typical 2-16) through
    the full engine pipeline vs the XLA oracle: the per-dimension
    ascending fp32 accumulation must stay exact at any D (the rejected
    MXU distance path would have silently engaged near this D)."""
    rng = np.random.default_rng(64)
    coords = np.concatenate([
        rng.normal(0.0, 0.2, size=(300, 32)),
        rng.normal(1.0, 0.25, size=(250, 32)),
    ]).astype(np.float32)
    radii = [2.0, 3.0]
    want = ops.populations(coords, radii, backend="xla",
                           row_block=8, col_block=16)
    eng = ops.engine.DensityEngine(coords, row_block=8, col_block=16,
                                   backend="pallas")
    got = eng.populations(radii)
    for r in radii:
        np.testing.assert_array_equal(want[r], got[r])
    fe = ops.free_energies(want[radii[0]])
    want_nn = ops.nearest_neighbors(coords, fe, backend="xla",
                                    row_block=8, col_block=16)
    got_nn = eng.nearest_neighbors(fe)
    np.testing.assert_array_equal(want_nn[0], got_nn[0])
    np.testing.assert_array_equal(want_nn[2], got_nn[2])
    np.testing.assert_allclose(want_nn[1], got_nn[1], rtol=1e-6)
    np.testing.assert_allclose(want_nn[3], got_nn[3], rtol=1e-6)


def test_series_label_prefetch_gate_bit_equal(monkeypatch):
    """The pre-dispatched value-narrowed label download
    (_prefetch_labels + _labels_prefix_packed) must be bit-identical to
    the in-postlude int32 fetch (CLUSTERING_TPU_SCREEN_PREFETCH=0), for
    both the sync step and the submit pipeline -- pins the byte-plane
    decode against the plain path."""
    from concurrent.futures import ThreadPoolExecutor
    coords = _bigger_blobs(n=500, seed=31)
    pops = ops.populations(coords, [0.4], backend="xla",
                           row_block=8, col_block=16)[0.4]
    fe = ops.free_energies(pops)
    nn = ops.nearest_neighbors(coords, fe, backend="xla",
                               row_block=8, col_block=16)
    md2 = np.float32(4.0 * ops.neighbors.compute_sigma2(nn[1]))
    finite = fe[np.isfinite(fe)]
    thresholds = [np.float32(t) for t in
                  np.quantile(finite, [0.3, 0.7, 1.0])]

    def run(prefetch_env):
        monkeypatch.setenv("CLUSTERING_TPU_SCREEN_PREFETCH", prefetch_env)
        ser = ops.screening.ThresholdSeriesScreener(
            coords, fe, thresholds, row_block=8, col_block=16,
            backend="pallas", hd_neighbors=(nn[2], nn[3]))
        outs, a = [], None
        for k in range(len(thresholds)):
            a = ser.step(a, k, md2)
            outs.append(a)
        ser.reset()
        with ThreadPoolExecutor(max_workers=2) as pool:
            futs = [ser.step_submit(k, md2, pool)
                    for k in range(len(thresholds))]
            outs += [f.result() for f in futs]
        return outs

    on, off = run("1"), run("0")
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# kernel-level checks: each Triton sweep against a brute-force oracle over
# exactly the pairs its tile list covers
# ---------------------------------------------------------------------------

_RB, _CB = 8, 32
_IMAX = np.iinfo(np.int32).max


def _kernel_fixture(n=200, n_pad=256, d=3, seed=41, dup=False):
    rng = np.random.default_rng(seed)
    x = np.full((n_pad, d), 3e38, dtype=np.float32)
    x[:n] = np.concatenate([rng.normal(0.0, 0.3, size=(n // 2, d)),
                            rng.normal(1.0, 0.3, size=(n - n // 2, d))])
    if dup:
        x[10:14] = x[3]  # exact duplicates: d2 == 0 pairs
    import oracles
    with np.errstate(over="ignore", invalid="ignore"):
        d2 = oracles.sq_dist_matrix(x)
    return x, d2


def _tiles(case, nrb, ncb, upper=False):
    """(ti, tj, covered) for a named tile-list shape; ``covered`` is the
    tile mask the list holds (pads excluded)."""
    ri, cj = np.meshgrid(np.arange(nrb), np.arange(ncb), indexing="ij")
    mask = np.ones((nrb, ncb), bool)
    if case == "single_tile":
        mask = (ri == 3) & (cj == 1)
    elif case == "empty_rows":
        mask = (ri % 3) != 1  # every third row block has no tile
    elif case == "sparse":
        mask = ((ri * 7 + cj * 3) % 4) != 0
    if upper:
        mask &= (cj + 1) * _CB > ri * _RB
    ti, tj = np.nonzero(mask)
    ti, tj = ti.astype(np.int32), tj.astype(np.int32)
    return ti, tj, mask


def _pair_mask(mask):
    return np.repeat(np.repeat(mask, _RB, axis=0), _CB, axis=1)


@pytest.mark.parametrize("case", ["full", "sparse", "single_tile",
                                  "empty_rows", "ragged", "noop_pads",
                                  "duplicates"])
def test_pops_sweep_kernel(case):
    from clustering_tpu.ops import pallas_kernels as pk
    x, d2 = _kernel_fixture(dup=case == "duplicates")
    n_pad = x.shape[0]
    n_valid = 137 if case == "ragged" else 200
    ti, tj, mask = _tiles("full" if case in ("ragged", "noop_pads",
                                             "duplicates") else case,
                          n_pad // _RB, n_pad // _CB)
    if case == "noop_pads":
        ti = np.concatenate([ti, np.full(9, ti[-1], np.int32)])
        tj = np.concatenate([tj, np.full(9, -1, np.int32)])
    radii2 = np.asarray([0.01, 0.09, 0.36], np.float32)
    # rmask: radius 0 disabled on odd tiles (their counts must skip it)
    rm = np.where(tj >= 0, 7, 0).astype(np.int32)
    rm[1::2] &= ~1
    got = np.asarray(pk.pops_sweep(x.T, x.T, radii2, n_valid, ti, tj, rm,
                                   row_block=_RB, col_block=_CB))
    cover = _pair_mask(mask) & (np.arange(n_pad)[None, :] < n_valid)
    tile_has_r0 = np.zeros(mask.shape, bool)
    real = tj >= 0
    tile_has_r0[ti[real], tj[real]] = (rm[real] & 1) != 0
    for r, t in enumerate(radii2):
        cov = cover & (_pair_mask(tile_has_r0) if r == 0 else True)
        want = ((d2 <= t) & cov).sum(axis=1)
        np.testing.assert_array_equal(got[r], want, err_msg=f"r={r}")


def _nn_oracle(d2, fe, oid, cover, n_valid):
    n_pad = d2.shape[0]
    valid = cover & (np.arange(n_pad)[None, :] < n_valid) & (d2 > 0)
    out_d = np.full((2, n_pad), np.inf, np.float32)
    out_j = np.full((2, n_pad), _IMAX, np.int64)
    for q, extra in enumerate((True, fe[None, :] < fe[:, None])):
        dm = np.where(valid & extra, d2, np.inf)
        best = dm.min(axis=1)
        out_d[q] = best
        cand = np.where(dm == best[:, None], oid[None, :], _IMAX)
        out_j[q] = np.where(np.isfinite(best), cand.min(axis=1), _IMAX)
    return out_d, out_j


@pytest.mark.parametrize("case", ["full", "sparse", "single_tile",
                                  "empty_rows", "ragged", "repeat_pads",
                                  "duplicates"])
def test_nn_sweep_kernel(case):
    from clustering_tpu.ops import pallas_kernels as pk
    x, d2 = _kernel_fixture(dup=case == "duplicates", seed=43)
    n_pad = x.shape[0]
    n_valid = 150 if case == "ragged" else 200
    rng = np.random.default_rng(3)
    fe = np.full(n_pad, np.inf, np.float32)
    fe[:200] = rng.random(200).astype(np.float32)
    # a permutation as "original ids": ties must break on these
    oid = np.full(n_pad, _IMAX, np.int32)
    oid[:200] = rng.permutation(200).astype(np.int32)
    ti, tj, mask = _tiles(case if case in ("sparse", "single_tile",
                                           "empty_rows") else "full",
                          n_pad // _RB, n_pad // _CB)
    if case == "repeat_pads":
        ti = np.concatenate([ti, np.full(9, ti[-1], np.int32)])
        tj = np.concatenate([tj, np.full(9, tj[-1], np.int32)])
    got_d, got_j = pk.nn_sweep(x.T, fe[None], x.T, fe[None], oid[None],
                               n_valid, ti, tj, row_block=_RB,
                               col_block=_CB)
    want_d, want_j = _nn_oracle(d2, fe, oid, _pair_mask(mask), n_valid)
    np.testing.assert_array_equal(np.asarray(got_j)[:, :200],
                                  want_j[:, :200])
    # the interpreter contracts to fma like the card: 1-ulp class
    np.testing.assert_allclose(np.asarray(got_d)[:, :200],
                               want_d[:, :200], rtol=2e-7)


@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("case", ["full", "prefix", "repeat_pads",
                                  "empty_rows", "dirty_gate"])
def test_label_sweep_kernel(case, upper):
    """Each listed tile proposes both ways: an upper-triangular list
    covers every pair once, a full list (tiles and their mirrors) twice,
    with the same proposals."""
    from clustering_tpu.ops import pallas_kernels as pk
    x, d2 = _kernel_fixture(seed=47)
    n_pad = x.shape[0]
    nrb, ncb = n_pad // _RB, n_pad // _CB
    n_below = 120 if case == "prefix" else 200
    md2 = np.float32(0.05)
    rng = np.random.default_rng(5)
    labels = np.arange(n_pad, dtype=np.int32)
    labels[:200] = np.minimum(labels[:200],
                              rng.integers(0, 200, 200).astype(np.int32))
    ti, tj, mask = _tiles("empty_rows" if case == "empty_rows" else "full",
                          nrb, ncb, upper=upper)
    if case == "repeat_pads":
        ti = np.concatenate([ti, np.full(9, ti[-1], np.int32)])
        tj = np.concatenate([tj, np.full(9, tj[-1], np.int32)])
    dirty_col = np.ones(ncb, np.int32)
    dirty_row = np.ones(nrb, np.int32)
    if case == "dirty_gate":
        dirty_col[[1, 4]] = 0
        dirty_row[::2] = 0
    got = np.asarray(pk.label_sweep(x.T, labels, n_below, md2, ti, tj,
                                    dirty_col, dirty_row, row_block=_RB,
                                    col_block=_CB))
    ri = np.arange(nrb)[:, None]
    cj = np.arange(ncb)[None, :]
    swept = mask & ~((dirty_col[cj] == 0) & (dirty_row[ri] == 0))
    cover = _pair_mask(swept)
    cover = cover | cover.T
    ids = np.arange(n_pad)
    adj = ((d2 < md2) & cover & (ids[None, :] < n_below)
           & (ids[:, None] < n_below))
    want = np.where(adj, labels[None, :], _IMAX).min(axis=1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("platform,want", [("cpu", "xla"),
                                           ("gpu", "pallas"),
                                           ("rocm", None)])
def test_auto_backend_per_platform(platform, want, monkeypatch):
    """"auto" is decided in one place: the CPU runs the plain XLA path,
    the GPU the measured winner, any other platform raises."""
    from clustering_tpu.ops import pallas_kernels as pk
    monkeypatch.setattr(pk.jax, "default_backend", lambda: platform)
    if want is None:
        with pytest.raises(RuntimeError, match="no kernel backend"):
            pk.resolve_backend("auto")
    else:
        assert pk.resolve_backend("auto") == want
    assert pk.resolve_backend("xla") == "xla"
    assert pk.resolve_backend("pallas") == "pallas"
    with pytest.raises(ValueError):
        pk.resolve_backend("mosaic")


@pytest.mark.parametrize("kw,msg", [(dict(row_block=12), "power of two"),
                                    (dict(col_block=24), "multiple")])
def test_sweep_rejects_bad_blocks(kw, msg):
    """Triton blocks are powers of two: a row block that is not, or a
    column block that no power-of-two sub-tile divides, is refused
    before any kernel is traced."""
    from clustering_tpu.ops import pallas_kernels as pk
    x = np.zeros((2, 96), np.float32)
    z = np.zeros(1, np.int32)
    with pytest.raises(ValueError, match=msg):
        pk.pops_sweep(x, x, np.ones(1, np.float32), 96, z, z,
                      **{"row_block": 8, "col_block": 32, **kw})


def test_csr_offsets_of_sorted_lists():
    """Each row block's run in a sorted list, including empty runs and
    pad entries past the last row block."""
    from clustering_tpu.ops import pallas_kernels as pk
    ti = np.asarray([0, 0, 2, 2, 2, 5, 9, 9], np.int32)
    got = np.asarray(pk._csr(ti, 6))
    np.testing.assert_array_equal(got, [0, 2, 2, 5, 5, 5, 6])


@pytest.mark.gpu
def test_sweeps_compiled_on_gpu(gpu):
    """The compiled Triton sweeps agree with the interpreter's results
    (on the card; chip_smoke.py runs the same comparison at real
    widths)."""
    from clustering_tpu.ops import pallas_kernels as pk
    x, d2 = _kernel_fixture()
    ti, tj, _ = _tiles("full", x.shape[0] // _RB, x.shape[0] // _CB)
    radii2 = np.asarray([0.09], np.float32)
    got = np.asarray(pk.pops_sweep(x.T, x.T, radii2, 200, ti, tj,
                                   row_block=_RB, col_block=_CB))
    want = ((d2 <= radii2[0]) & (np.arange(x.shape[0]) < 200)).sum(axis=1)
    np.testing.assert_array_equal(got[0], want)
