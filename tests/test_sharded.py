"""Multi-chip sharding tests on a virtual 8-device CPU mesh: the sharded
ops must agree exactly with the single-chip ops."""

import jax
import numpy as np
import pytest

from clustering_tpu import ops, parallel
from clustering_tpu.models import density as density_model


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    return parallel.make_mesh()


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(99)
    a = rng.normal((0.0, 0.0, 0.0), 0.2, size=(130, 3))
    b = rng.normal((2.0, 0.5, -1.0), 0.25, size=(100, 3))
    return np.concatenate([a, b]).astype(np.float32)


def test_sharded_populations(mesh8, blobs):
    radii = [0.3, 0.7]
    single = ops.populations(blobs, radii, row_block=32, col_block=64)
    sharded = parallel.sharded.populations(blobs, radii, mesh8,
                                           row_block=32, col_block=64)
    for r in radii:
        np.testing.assert_array_equal(single[r], sharded[r])


def test_sharded_nearest_neighbors(mesh8, blobs):
    pops = ops.populations(blobs, [0.4], row_block=32, col_block=64)[0.4]
    fe = ops.free_energies(pops)
    single = ops.nearest_neighbors(blobs, fe, row_block=32, col_block=64)
    sharded = parallel.sharded.nearest_neighbors(blobs, fe, mesh8,
                                                 row_block=32, col_block=64)
    for i in range(4):
        np.testing.assert_array_equal(single[i], sharded[i])


def test_sharded_screening(mesh8, blobs):
    pops = ops.populations(blobs, [0.4], row_block=32, col_block=64)[0.4]
    fe = ops.free_energies(pops)
    order = density_model.sorted_fe_order(fe)
    coords_sorted = blobs[order]
    labels0 = np.arange(len(blobs), dtype=np.int32)
    for n_below, t in ((150, 0.08), (230, 0.2)):
        single = ops.screening_labels(coords_sorted, labels0, n_below, t,
                                      row_block=32, col_block=64)
        sharded = parallel.sharded.screening_labels(
            coords_sorted, labels0, n_below, t, mesh8,
            row_block=32, col_block=64)
        np.testing.assert_array_equal(single, sharded)


def test_sharded_screening_seeded(mesh8, blobs):
    pops = ops.populations(blobs, [0.4], row_block=32, col_block=64)[0.4]
    fe = ops.free_energies(pops)
    order = density_model.sorted_fe_order(fe)
    coords_sorted = blobs[order]
    labels0 = np.arange(len(blobs), dtype=np.int32)
    first = ops.screening_labels(coords_sorted, labels0, 120, 0.1,
                                 row_block=32, col_block=64)
    seeded = first.copy().astype(np.int32)
    single = ops.screening_labels(coords_sorted, seeded, 200, 0.1,
                                  row_block=32, col_block=64)
    sharded = parallel.sharded.screening_labels(
        coords_sorted, seeded, 200, 0.1, mesh8, row_block=32, col_block=64)
    np.testing.assert_array_equal(single, sharded)


def test_sharded_pallas_populations(mesh8, blobs):
    """The shard_map'd Pallas tile kernel (interpret mode on the CPU mesh)
    must agree with the sharded XLA path."""
    radii = [0.3, 0.7]
    want = parallel.sharded.populations(blobs, radii, mesh8,
                                        row_block=8, col_block=16)
    got = parallel.sharded.populations(blobs, radii, mesh8,
                                       row_block=8, col_block=16,
                                       backend="pallas")
    for r in radii:
        np.testing.assert_array_equal(want[r], got[r])


def test_sharded_pallas_nearest_neighbors(mesh8, blobs):
    pops = ops.populations(blobs, [0.4], row_block=32, col_block=64)[0.4]
    fe = ops.free_energies(pops)
    want = parallel.sharded.nearest_neighbors(blobs, fe, mesh8,
                                              row_block=8, col_block=16)
    got = parallel.sharded.nearest_neighbors(blobs, fe, mesh8,
                                             row_block=8, col_block=16,
                                             backend="pallas")
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[2], got[2])
    np.testing.assert_allclose(want[1], got[1], rtol=1e-6)
    np.testing.assert_allclose(want[3], got[3], rtol=1e-6)


def test_sharded_pallas_screening(mesh8, blobs):
    pops = ops.populations(blobs, [0.4], row_block=32, col_block=64)[0.4]
    fe = ops.free_energies(pops)
    order = density_model.sorted_fe_order(fe)
    cs = blobs[order]
    labels0 = np.arange(len(blobs), dtype=np.int32)
    for nb, t in ((150, 0.08), (230, 0.2)):
        want = parallel.sharded.screening_labels(
            cs, labels0, nb, t, mesh8, row_block=8, col_block=16)
        got = parallel.sharded.screening_labels(
            cs, labels0, nb, t, mesh8, row_block=8, col_block=16,
            backend="pallas")
        np.testing.assert_array_equal(want, got)


def _series_inputs(blobs):
    pops = ops.populations(blobs, [0.4], row_block=32, col_block=64)[0.4]
    fe = ops.free_energies(pops)
    nn = ops.nearest_neighbors(blobs, fe, row_block=32, col_block=64)
    from clustering_tpu.ops import neighbors as nbr
    max_dist2 = np.float32(4.0 * nbr.compute_sigma2(nn[1]))
    return fe, nn, max_dist2


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_threshold_series_mesh_matches_single_chip(mesh8, blobs, backend):
    """The production multi-chip series path (ThresholdSeriesScreener +
    mesh + pallas, incremental row_lo tile lists) must reproduce the
    single-device series exactly."""
    from clustering_tpu.ops.screening import ThresholdSeriesScreener
    fe, nn, max_dist2 = _series_inputs(blobs)
    thresholds = [np.float32(t) for t in (0.1, 0.3, 0.6)]
    single = ThresholdSeriesScreener(blobs, fe, thresholds,
                                     row_block=8, col_block=16,
                                     backend="xla")
    meshed = ThresholdSeriesScreener(blobs, fe, thresholds,
                                     row_block=8, col_block=16,
                                     backend=backend, mesh=mesh8,
                                     hd_neighbors=(nn[2], nn[3]))
    c_s = c_m = None
    for k in range(len(thresholds)):
        c_s = single.step(c_s, k, max_dist2)
        c_m = meshed.step(c_m, k, max_dist2)
        np.testing.assert_array_equal(c_s, c_m, err_msg=f"threshold {k}")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_threshold_series_mesh_step_submit(mesh8, blobs, backend):
    """step_submit (deferred postlude on a worker thread; what
    api.screening_series drives) must be bit-identical to the sync step
    under a mesh — the worker's mesh fetch runs concurrently with the
    next step's shard_map dispatches."""
    from concurrent.futures import ThreadPoolExecutor
    from clustering_tpu.ops.screening import ThresholdSeriesScreener
    fe, nn, max_dist2 = _series_inputs(blobs)
    thresholds = [np.float32(t) for t in (0.1, 0.3, 0.6)]
    sync = ThresholdSeriesScreener(blobs, fe, thresholds,
                                   row_block=8, col_block=16,
                                   backend=backend, mesh=mesh8,
                                   hd_neighbors=(nn[2], nn[3]))
    asyn = ThresholdSeriesScreener(blobs, fe, thresholds,
                                   row_block=8, col_block=16,
                                   backend=backend, mesh=mesh8,
                                   hd_neighbors=(nn[2], nn[3]))
    want = []
    c = None
    for k in range(len(thresholds)):
        c = sync.step(c, k, max_dist2)
        want.append(c)
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = [asyn.step_submit(k, max_dist2, pool)
                for k in range(len(thresholds))]
        for k, f in enumerate(futs):
            np.testing.assert_array_equal(want[k], f.result(),
                                          err_msg=f"threshold {k}")


@pytest.mark.parametrize("prune", [True, False])
def test_engine_mesh_populations(mesh8, blobs, prune):
    """DensityEngine(mesh=...) must reuse the single-device planning
    (bbox planes, per-tile radius bitmask) and dispatch the SAME tile
    list over the mesh -- results exactly equal to the single-device
    engine, every computed tile dealt to exactly one device."""
    radii = [0.3, 0.7]
    single = ops.engine.DensityEngine(blobs, row_block=8, col_block=16,
                                      backend="pallas")
    meshed = ops.engine.DensityEngine(blobs, row_block=8, col_block=16,
                                      backend="pallas", mesh=mesh8)
    want = single.populations(radii, prune=prune)
    got = meshed.populations(radii, prune=prune)
    for r in radii:
        np.testing.assert_array_equal(want[r], got[r])
    st = meshed.last_stats["populations"]
    assert st["mesh_devices"] == 8
    assert sum(st["per_device_tiles"]) == st["computed_tiles"]
    assert max(st["per_device_tiles"]) - min(st["per_device_tiles"]) <= 1


def test_engine_mesh_nearest_neighbors(mesh8, blobs):
    """The engine's full two-phase pruned NN path under a mesh: band +
    phase-2 tile sweeps dispatched through shard_map, lexicographic pmin
    merges — indices exactly equal to the single-chip engine."""
    pops = ops.populations(blobs, [0.4], row_block=32, col_block=64)[0.4]
    fe = ops.free_energies(pops)
    single = ops.engine.DensityEngine(blobs, row_block=8, col_block=16,
                                      backend="pallas")
    meshed = ops.engine.DensityEngine(blobs, row_block=8, col_block=16,
                                      backend="pallas", mesh=mesh8)
    want = single.nearest_neighbors(fe)
    got = meshed.nearest_neighbors(fe)
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[2], got[2])
    np.testing.assert_allclose(want[1], got[1], rtol=1e-6)
    np.testing.assert_allclose(want[3], got[3], rtol=1e-6)
    # the mesh path must have balanced its tiles over all 8 chips
    assert meshed._last_mesh_tiles is not None
    assert len(meshed._last_mesh_tiles) == 8


def test_engine_mesh_nn_tiered(mesh8, blobs):
    """Tiered phase 2 requested under a mesh: the tiered cross sweep is
    single-device, so the mesh keeps the block-bound phase 2 -- and both
    land on exactly the single-device tiered result."""
    pops = ops.populations(blobs, [0.4], row_block=32, col_block=64)[0.4]
    fe = ops.free_energies(pops)
    qs = (0.5, 0.9)
    single = ops.engine.DensityEngine(blobs, row_block=8, col_block=16,
                                      backend="pallas")
    meshed = ops.engine.DensityEngine(blobs, row_block=8, col_block=16,
                                      backend="pallas", mesh=mesh8)
    want = single.nearest_neighbors(fe, tier_qs=qs)
    got = meshed.nearest_neighbors(fe, tier_qs=qs)
    assert single.last_stats["nn"]["mode"] == "tiered"
    assert meshed.last_stats["nn"]["mode"] == "block-bound"
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[2], got[2])
    np.testing.assert_allclose(want[1], got[1], rtol=1e-6)
    np.testing.assert_allclose(want[3], got[3], rtol=1e-6)
    # and the tiered mesh result equals the block-bound mesh result
    plain = ops.engine.DensityEngine(blobs, row_block=8, col_block=16,
                                     backend="pallas",
                                     mesh=mesh8).nearest_neighbors(fe)
    for i in range(4):
        np.testing.assert_array_equal(got[i], plain[i])


def test_balanced_tile_split_on_skewed_data(mesh8):
    """Spatially-skewed data concentrates active tiles in few row blocks;
    the balanced splitter must still hand every device an equal
    share."""
    from clustering_tpu.ops import pruning
    rng = np.random.default_rng(5)
    # 90% of frames in one tight cluster -> most tiles in one corner
    dense = rng.normal((0.0, 0.0), 0.02, size=(360, 2))
    sparse = rng.uniform(-50.0, 50.0, size=(40, 2))
    coords = np.concatenate([dense, sparse]).astype(np.float32)
    single = ops.populations(coords, [0.1], row_block=8, col_block=16)[0.1]
    sharded = parallel.sharded.populations(coords, [0.1], mesh8,
                                           row_block=8, col_block=16,
                                           backend="pallas")
    np.testing.assert_array_equal(single, sharded[0.1])
    # balance metric: per-device real tile counts within one tile
    order = pruning.morton_order(coords)
    n_pad = 8 * 16 * -(-len(coords) // (8 * 16))
    padded = np.full((n_pad, 2), 3e38, dtype=np.float32)
    padded[:len(coords)] = coords[order]
    rmin, rmax = pruning.block_bboxes(padded, 8)
    cmin, cmax = pruning.block_bboxes(padded, 16)
    active = pruning.bbox_dist2(rmin, rmax, cmin, cmax) <= np.float32(0.01)
    ti, tj = np.nonzero(active)
    _, _, counts = pruning.split_tiles_balanced(ti, tj, 8)
    assert counts.max() - counts.min() <= 1
    # the row-ownership split this replaces was badly skewed here
    nrb = n_pad // 8
    row_counts = np.bincount(ti // (nrb // 8), minlength=8)
    assert row_counts.max() > 2 * max(int(row_counts.min()), 1)


# -- production-scale mesh parity ---------------------------------------------
#
# 20k frames with production-shaped tile grids: long padded tile lists,
# per-device balanced padding and the incremental series path all engage
# together at this size, unlike the few-hundred-frame fixtures above.


@pytest.fixture(scope="module")
def big_blobs():
    rng = np.random.default_rng(20000)
    # skewed metastable landscape: two dense basins + diffuse background
    a = rng.normal((0.0, 0.0, 0.0), 0.15, size=(9000, 3))
    b = rng.normal((1.5, 0.8, -0.5), 0.2, size=(8000, 3))
    c = rng.uniform(-3.0, 3.0, size=(3000, 3))
    return np.concatenate([a, b, c]).astype(np.float32)


@pytest.fixture(scope="module")
def big_fe(big_blobs):
    pops = ops.populations(big_blobs, [0.2], row_block=64,
                           col_block=1024)[0.2]
    return ops.free_energies(pops)


def test_sharded_populations_production_scale(mesh8, big_blobs):
    """Long tile lists through the mesh: (32, 64) blocks give a 640x320
    tile grid whose active list runs to tens of thousands of entries
    per device."""
    radii = [0.2, 0.35]
    single = ops.populations(big_blobs, radii, row_block=32, col_block=64)
    sharded = parallel.sharded.populations(big_blobs, radii, mesh8,
                                           row_block=32, col_block=64)
    for r in radii:
        diff = np.flatnonzero(single[r] != sharded[r])
        # XLA:CPU contracts mul+add to fma differently across program
        # shapes (docs/PARITY.md), so at this density a handful of pairs
        # sitting exactly on the radius boundary may flip by 1 ulp
        # between the single-chip and sharded programs. Require any
        # divergence to be exactly that class: off-by-one counts on a
        # tiny fraction of frames, each with a pair within 2 ulp of r^2.
        assert len(diff) <= 4, f"r={r}: {len(diff)} frames differ"
        r2 = np.float32(r) * np.float32(r)
        for i in diff:
            assert abs(int(single[r][i]) - int(sharded[r][i])) == 1
            d2 = np.zeros(len(big_blobs), dtype=np.float32)
            for k in range(big_blobs.shape[1]):
                dk = big_blobs[:, k] - big_blobs[i, k]
                d2 = d2 + dk * dk
            gap = np.abs(d2 - r2)
            assert gap.min() <= 2 * np.abs(np.spacing(r2)), (
                f"frame {i} diverges with no boundary-tied pair")


def test_sharded_nn_production_scale(mesh8, big_blobs, big_fe):
    single = ops.nearest_neighbors(big_blobs, big_fe, row_block=64,
                                   col_block=1024)
    sharded = parallel.sharded.nearest_neighbors(
        big_blobs, big_fe, mesh8, row_block=64, col_block=1024)
    for i in range(4):
        np.testing.assert_array_equal(single[i], sharded[i])


def test_series_mesh_production_scale(mesh8, big_blobs, big_fe):
    """Full incremental threshold series at 20k frames, mesh vs single
    chip, including the hd-edge seeding path."""
    from clustering_tpu.ops import neighbors as nbr
    from clustering_tpu.ops.screening import ThresholdSeriesScreener
    nn = ops.nearest_neighbors(big_blobs, big_fe, row_block=64,
                               col_block=1024)
    max_dist2 = np.float32(4.0 * nbr.compute_sigma2(nn[1]))
    thresholds = [np.float32(t) for t in (1.0, 2.0, 3.0)]
    single = ThresholdSeriesScreener(big_blobs, big_fe, thresholds,
                                     row_block=64, col_block=1024,
                                     backend="xla",
                                     hd_neighbors=(nn[2], nn[3]))
    meshed = ThresholdSeriesScreener(big_blobs, big_fe, thresholds,
                                     row_block=64, col_block=1024,
                                     backend="xla", mesh=mesh8,
                                     hd_neighbors=(nn[2], nn[3]))
    c_s = c_m = None
    for k in range(len(thresholds)):
        c_s = single.step(c_s, k, max_dist2)
        c_m = meshed.step(c_m, k, max_dist2)
        np.testing.assert_array_equal(c_s, c_m, err_msg=f"threshold {k}")


def test_engine_mesh_device_plan_bit_equal(mesh8, blobs, monkeypatch):
    """With device planning FORCED under the mesh
    (CLUSTERING_TPU_DEVICE_PLAN=1), the pops mask and tile list stay on
    device and are round-robin dealt over the devices there
    (pruning.tile_list_device_split) -- pops counts and NN indices must
    equal the single-device engine bit-for-bit. The reference's
    multi-GPU driver runs the full algorithm per device the same way
    (src/density_clustering_cuda.cu:139-182)."""
    eng_cls = ops.engine.DensityEngine
    radii = [0.3, 0.7]
    single = eng_cls(blobs, row_block=8, col_block=16, backend="pallas")
    want_p = single.populations(radii)
    fe = ops.free_energies(want_p[0.3])
    want_nn = single.nearest_neighbors(fe)

    monkeypatch.setenv("CLUSTERING_TPU_DEVICE_PLAN", "1")
    meshed = eng_cls(blobs, row_block=8, col_block=16,
                     backend="pallas", mesh=mesh8)
    got_p = meshed.populations(radii)
    for r in radii:
        np.testing.assert_array_equal(want_p[r], got_p[r])
    st = meshed.last_stats["populations"]
    assert st["plan"] == "device", st
    assert st["mesh_devices"] == 8

    got_nn = meshed.nearest_neighbors(fe, band_blocks=1)
    np.testing.assert_array_equal(want_nn[0], got_nn[0])
    np.testing.assert_array_equal(want_nn[2], got_nn[2])
    np.testing.assert_allclose(want_nn[1], got_nn[1], rtol=1e-6)
    np.testing.assert_allclose(want_nn[3], got_nn[3], rtol=1e-6)
