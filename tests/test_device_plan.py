"""Device-side planning (pruning.*_device) must emit exactly the host
planners' tile sets, in the same row-major order, with the same padded
length -- big-N planning swaps the implementation, never the plan.
Guards the exact-pruning invariant (reference box-grid semantics,
src/density_clustering.cpp:41-105) under the device planners.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from clustering_tpu.ops import pruning

RB, CB = 8, 16


def _rand_mask(nrb, ncb, p, seed):
    rng = np.random.default_rng(seed)
    return rng.random((nrb, ncb)) < p


@pytest.mark.parametrize("p,pad_mode", [(0.03, "repeat"), (0.03, "noop"),
                                        (0.6, "repeat"), (1.0, "noop")])
def test_tile_list_device_matches_host(p, pad_mode):
    nrb, ncb = 48, 24
    m = _rand_mask(nrb, ncb, p, 11)
    m[0, 0] = True  # never empty
    want = pruning.tile_list(m, pad_mode=pad_mode)
    n = int(m.sum())
    assert pruning.tile_count_device(jnp.asarray(m)) == n
    got = pruning.tile_list_device(jnp.asarray(m), n, pad_mode=pad_mode)
    assert want[0].shape == (pruning.list_bucket(n),)
    np.testing.assert_array_equal(want[0], np.asarray(got[0]))
    np.testing.assert_array_equal(want[1], np.asarray(got[1]))


def test_tile_list_device_empty():
    m = np.zeros((16, 8), dtype=bool)
    assert pruning.tile_count_device(jnp.asarray(m)) == 0
    assert pruning.tile_list_device(jnp.asarray(m), 0) is None
    assert pruning.tile_list(m) is None


@pytest.mark.parametrize("n,want", [(0, 1024), (1, 1024), (1024, 1024),
                                    (1025, 2048), (70000, 131072)])
def test_list_bucket_pads_to_power_of_two(n, want):
    """Tile lists pad to the next power of two (floor 1024): a handful of
    compiled kernel shapes serve every list, at most 2x padding."""
    assert pruning.list_bucket(n) == want


def test_tile_list_pads_keep_rows_sorted():
    """Repeat and no-op pads keep the flat list sorted by row block (the
    kernels find each row block's run by binary search)."""
    m = _rand_mask(40, 20, 0.2, 29)
    for mode in ("repeat", "noop"):
        ti, tj = pruning.tile_list(m, pad_mode=mode)
        assert (np.diff(ti) >= 0).all()
        n = int(m.sum())
        assert (tj[n:] == (tj[n - 1] if mode == "repeat" else -1)).all()


@pytest.mark.parametrize("row_lo,n_below",
                         [(0, 380), (0, 512), (120, 380), (120, 512)])
def test_screen_active_device_matches_host(row_lo, n_below):
    """The screening device planner's mask algebra (prefix, new-frame
    cross, upper triangle) equals the host planner's on the same plane."""
    from clustering_tpu.ops.screening import _screen_active_device
    nrb, ncb = 64, 32
    below = _rand_mask(nrb, ncb, 0.4, 37)
    ri = np.arange(nrb)[:, None]
    cj = np.arange(ncb)[None, :]
    want = below & (ri * RB < n_below) & (cj * CB < n_below)
    if row_lo > 0:
        want &= ((ri + 1) * RB > row_lo) | ((cj + 1) * CB > row_lo)
    want &= (cj + 1) * CB > ri * RB
    got = np.asarray(_screen_active_device(
        jnp.asarray(below), jnp.int32(n_below), jnp.int32(row_lo), RB, CB))
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("nrb,ncb,rb,cb,half",
                         [(64, 8, 8, 64, 128), (64, 8, 8, 64, 0),
                          (40, 5, 16, 128, 256), (1024, 32, 128, 4096,
                                                  16384)])
def test_band_mask_device_matches_host(nrb, ncb, rb, cb, half):
    """The NN band (phase-1) mask built on the device in integer
    arithmetic equals the host planner's float mask."""
    want = pruning.band_mask(nrb, ncb, rb, cb, half)
    got = np.asarray(pruning.band_mask_device(nrb, ncb, rb, cb, half))
    np.testing.assert_array_equal(want, got)


def test_rmask_gather_device_matches_host():
    from clustering_tpu.ops.engine import DensityEngine
    nrb, ncb, n_r = 32, 16, 3
    rng = np.random.default_rng(17)
    planes = [None] + [rng.random((nrb, ncb)) < 0.5 for _ in range(n_r)]
    ti = rng.integers(0, nrb, size=(4, 32)).astype(np.int32)
    tj = rng.integers(0, ncb, size=(4, 32)).astype(np.int32)
    tj[0, :5] = -1  # pads
    want = DensityEngine._pops_rmask(ti, tj, planes, n_r, True)
    got = np.asarray(pruning.rmask_gather_device(
        jnp.asarray(np.stack(planes[1:])), jnp.asarray(ti),
        jnp.asarray(tj)))
    np.testing.assert_array_equal(want, got)


def test_le_planes_device_matches_active_masks():
    rng = np.random.default_rng(23)
    d2b = rng.random((32, 16)).astype(np.float32)
    ts = [0.1, 0.5, 0.9]
    want = pruning.active_masks_device(jnp.asarray(d2b), ts)
    got = np.asarray(pruning.le_planes_device(
        jnp.asarray(d2b), jnp.asarray(ts, dtype=jnp.float32)))
    np.testing.assert_array_equal(want, got)


# ---------------------------------------------------------------------------
# engine integration: CLUSTERING_TPU_DEVICE_PLAN=1 must be bit-equal to
# the host planner on every path (plain and tiered)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(31)
    a = rng.normal((0.0, 0.0, 0.0), 0.15, size=(260, 3))
    b = rng.normal((1.5, 1.0, -0.5), 0.2, size=(240, 3))
    return np.concatenate([a, b]).astype(np.float32)


def _run_pipeline(blobs, monkeypatch, plan, **eng_kw):
    from clustering_tpu import ops
    monkeypatch.setenv("CLUSTERING_TPU_DEVICE_PLAN", plan)
    eng = ops.engine.DensityEngine(blobs, row_block=RB, col_block=CB,
                                   backend="pallas", **eng_kw)
    for k, v in eng_kw.pop("attrs", {}).items():
        setattr(eng, k, v)
    pops = eng.populations([0.3, 0.45], nn_band_radius=0.3)
    th = getattr(eng, "_band_prefetch_thread", None)
    if th is not None:
        th.join()
    fe = ops.free_energies(pops[0.3])
    nn = eng.nearest_neighbors(fe)
    return pops, nn, dict(eng.last_stats)


def test_engine_device_plan_bit_equal(blobs, monkeypatch):
    p_dev, nn_dev, st_dev = _run_pipeline(blobs, monkeypatch, "1")
    p_host, nn_host, st_host = _run_pipeline(blobs, monkeypatch, "0")
    assert st_dev["populations"].get("plan") == "device"
    assert "plan" not in st_host["populations"]
    assert st_dev["nn"]["plan"] == "device"
    assert st_host["nn"]["plan"] == "host"
    assert st_dev["nn"]["band_prefetched"] is True
    for r in p_dev:
        np.testing.assert_array_equal(p_dev[r], p_host[r])
    for a, b in zip(nn_dev, nn_host):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # identical plans: same tile counts on both sides
    assert (st_dev["populations"]["computed_tiles"]
            == st_host["populations"]["computed_tiles"])
    assert st_dev["nn"]["band_tiles"] == st_host["nn"]["band_tiles"]
    assert st_dev["nn"]["phase2_tiles"] == st_host["nn"]["phase2_tiles"]
    assert st_dev["nn"]["mode"] == st_host["nn"]["mode"]
    assert st_dev["nn"]["order"] == st_host["nn"]["order"]


def test_engine_device_plan_tiered_bit_equal(blobs, monkeypatch):
    from clustering_tpu import ops
    monkeypatch.setattr(ops.engine.DensityEngine, "TIERED_MIN_FRAMES", 64)
    # hugely negative threshold: the tiered plan is accepted even when
    # it saves nothing at this toy size
    monkeypatch.setattr(ops.engine.DensityEngine,
                        "TIERED_MIN_SAVED_PAIRS", -1e18)
    p_dev, nn_dev, st_dev = _run_pipeline(blobs, monkeypatch, "1")
    p_host, nn_host, st_host = _run_pipeline(blobs, monkeypatch, "0")
    assert st_dev["nn"]["mode"] == "tiered" == st_host["nn"]["mode"]
    assert st_dev["nn"]["plan"] == "device"
    assert st_dev["nn"]["phase2_tiles"] == st_host["nn"]["phase2_tiles"]
    for a, b in zip(nn_dev, nn_host):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_engine_device_plan_forced_tiers(blobs, monkeypatch):
    from clustering_tpu import ops
    monkeypatch.setenv("CLUSTERING_TPU_DEVICE_PLAN", "1")
    eng = ops.engine.DensityEngine(blobs, row_block=RB, col_block=CB,
                                   backend="pallas")
    pops = eng.populations([0.3])
    fe = ops.free_energies(pops[0.3])
    nn_dev = eng.nearest_neighbors(fe, tier_qs=(0.5, 0.9))
    monkeypatch.setenv("CLUSTERING_TPU_DEVICE_PLAN", "0")
    eng2 = ops.engine.DensityEngine(blobs, row_block=RB, col_block=CB,
                                    backend="pallas")
    eng2.populations([0.3])
    nn_host = eng2.nearest_neighbors(fe, tier_qs=(0.5, 0.9))
    for a, b in zip(nn_dev, nn_host):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("pad_mode", ["repeat", "noop"])
@pytest.mark.parametrize("n_dev", [3, 8])
def test_tile_list_device_split_matches_host_splitter(pad_mode, n_dev):
    """The device round-robin deal (element k -> device k % n_dev) must
    hand every device exactly the host splitter's real-tile subsequence
    in the same (n_dev, L) shape; pads differ only in VALUE (device
    split repeats the global last tile; pads are no-ops for every
    consumer: noop tj=-1 skipped, repeat idempotent)."""
    nrb, ncb = 48, 24
    m = _rand_mask(nrb, ncb, 0.3, 17)
    m[0, 0] = True
    ti_f, tj_f = np.nonzero(m)
    want = pruning.split_tiles_balanced(ti_f, tj_f, n_dev,
                                        pad_mode=pad_mode)
    got = pruning.tile_list_device_split(jnp.asarray(m), len(ti_f), n_dev,
                                         pad_mode=pad_mode)
    assert got[0].shape == want[0].shape
    np.testing.assert_array_equal(want[2], got[2])
    gi, gj = np.asarray(got[0]), np.asarray(got[1])
    for d in range(n_dev):
        c = int(want[2][d])
        np.testing.assert_array_equal(gi[d].ravel()[:c],
                                      want[0][d].ravel()[:c])
        np.testing.assert_array_equal(gj[d].ravel()[:c],
                                      want[1][d].ravel()[:c])
        if pad_mode == "noop":
            assert (gj[d].ravel()[c:] == -1).all()
        else:
            # repeat pads carry a REAL active tile (idempotent recompute)
            for i, j in zip(gi[d].ravel()[c:], gj[d].ravel()[c:]):
                assert m[i, j]