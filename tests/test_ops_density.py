import numpy as np
import pytest

from clustering_tpu import ops
from clustering_tpu.models import density as density_model
import oracles


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(42)
    a = rng.normal(loc=(0.0, 0.0), scale=0.15, size=(120, 2))
    b = rng.normal(loc=(1.5, 0.3), scale=0.2, size=(90, 2))
    c = rng.normal(loc=(-0.5, 2.0), scale=0.1, size=(47, 2))
    return np.concatenate([a, b, c]).astype(np.float32)


def test_populations_match_bruteforce(blobs):
    radii = [0.2, 0.35, 0.6]
    got = ops.populations(blobs, radii, row_block=64, col_block=128)
    want = oracles.populations(blobs, radii)
    for r in radii:
        np.testing.assert_array_equal(got[r], want[r])


def test_populations_include_self(blobs):
    got = ops.populations(blobs, [1e-6], row_block=64, col_block=128)
    assert (got[1e-6] >= 1).all()


def test_populations_monotone_in_radius(blobs):
    got = ops.populations(blobs, [0.1, 0.5], row_block=64, col_block=128)
    assert (got[0.5] >= got[0.1]).all()


def test_populations_permutation_invariant(blobs):
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(blobs))
    p1 = ops.populations(blobs, [0.4], row_block=64, col_block=128)[0.4]
    p2 = ops.populations(blobs[perm], [0.4],
                         row_block=64, col_block=128)[0.4]
    np.testing.assert_array_equal(p1[perm], p2)


def test_free_energies(blobs):
    pops = np.array([1, 5, 10, 10], dtype=np.int64)
    fe = ops.free_energies(pops)
    assert fe.dtype == np.float32
    np.testing.assert_allclose(
        fe, -np.log(pops / np.float32(10.0)), rtol=1e-6)
    assert fe[2] == 0.0 and fe[3] == 0.0


def test_nearest_neighbors_match_bruteforce(blobs):
    pops = oracles.populations(blobs, [0.3])[0.3]
    fe = ops.free_energies(pops)
    got = ops.nearest_neighbors(blobs, fe, row_block=64, col_block=128)
    want = oracles.nearest_neighbors(blobs, fe)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)


def test_nearest_neighbors_duplicates_excluded():
    coords = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 0.0], [3.0, 0.0]],
                      dtype=np.float32)
    fe = np.array([1.0, 1.0, 0.5, 2.0], dtype=np.float32)
    nh_idx, nh_d, hd_idx, hd_d = ops.nearest_neighbors(
        coords, fe, row_block=8, col_block=8)
    # frames 0/1 are duplicates: their NN must be frame 2, not each other
    assert nh_idx[0] == 2 and nh_idx[1] == 2
    np.testing.assert_allclose(nh_d[:2], [1.0, 1.0])
    # frame 2 has the lowest fe -> no higher-density neighbor -> (0, 0)
    assert hd_idx[2] == 0 and hd_d[2] == 0.0


def test_screening_labels_match_union_find(blobs):
    pops = oracles.populations(blobs, [0.3])[0.3]
    fe = ops.free_energies(pops)
    order = density_model.sorted_fe_order(fe)
    coords_sorted = blobs[order]
    n_below = 180
    max_dist2 = 0.02
    labels0 = np.arange(len(blobs), dtype=np.int32)
    got = ops.screening_labels(coords_sorted, labels0, n_below, max_dist2,
                               row_block=64, col_block=128)
    want = oracles.connected_component_labels(coords_sorted, labels0,
                                              n_below, max_dist2)
    np.testing.assert_array_equal(got[:n_below], want[:n_below])


def test_screening_labels_with_seeds(blobs):
    # seed two spatially-split groups with a common label: they must end up
    # in the same component even without an epsilon-path between them
    coords = np.array([[0.0, 0.0], [0.1, 0.0], [5.0, 0.0], [5.1, 0.0],
                       [9.0, 9.0]], dtype=np.float32)
    labels0 = np.array([0, 0, 2, 0, 4], dtype=np.int32)  # 3 seeded with 0
    got = ops.screening_labels(coords, labels0, 5, 0.05,
                               row_block=8, col_block=8)
    want = oracles.connected_component_labels(coords, labels0, 5, 0.05)
    np.testing.assert_array_equal(got, want)
    assert got[3] == got[0] == 0
    assert got[2] == got[3]  # 2 is eps-connected to 3 -> joins component 0


def test_screening_step_names_and_reuse(blobs):
    pops = oracles.populations(blobs, [0.3])[0.3]
    fe = ops.free_energies(pops)
    _, nh_d, _, _ = oracles.nearest_neighbors(blobs, fe)
    c1 = density_model.screening_step(fe, nh_d, 1.0, blobs, None)
    # names normalized: 0 above threshold, 1..K below
    below = fe <= 1.0
    assert (c1[~below] == 0).all()
    assert (c1[below] > 0).all()
    names = np.unique(c1[below])
    np.testing.assert_array_equal(names, np.arange(1, len(names) + 1))
    # seeded restart at a higher threshold keeps partitions consistent:
    # frames sharing a cluster at t=1.0 still share one at t=2.0
    c2 = density_model.screening_step(fe, nh_d, 2.0, blobs, c1)
    for name in names:
        members = np.flatnonzero(c1 == name)
        assert len(np.unique(c2[members])) == 1


def test_tiny_inputs_padding():
    """N far below one tile: padding paths must still be exact."""
    coords = np.array([[0.0, 0.0], [0.5, 0.0], [10.0, 10.0]],
                      dtype=np.float32)
    for backend in ("xla", "pallas"):
        pops = ops.populations(coords, [1.0], backend=backend,
                               row_block=8, col_block=16)[1.0]
        np.testing.assert_array_equal(pops, [2, 2, 1])
        fe = ops.free_energies(pops)
        nn = ops.nearest_neighbors(coords, fe, backend=backend,
                                   row_block=8, col_block=16)
        np.testing.assert_array_equal(nn[0], [1, 0, 1])


def test_single_frame():
    coords = np.array([[1.0, 2.0]], dtype=np.float32)
    for backend in ("xla", "pallas"):
        pops = ops.populations(coords, [0.5], backend=backend,
                               row_block=8, col_block=16)[0.5]
        np.testing.assert_array_equal(pops, [1])
        nn = ops.nearest_neighbors(coords, ops.free_energies(pops),
                                   backend=backend, row_block=8,
                                   col_block=16)
        # no admissible neighbor -> (0, 0.0)
        assert nn[0][0] == 0 and nn[1][0] == 0.0


def test_higher_dimension_counts():
    rng = np.random.default_rng(5)
    coords = rng.normal(size=(60, 16)).astype(np.float32)
    want = oracles.populations(coords, [2.0])[2.0]
    for backend in ("xla", "pallas"):
        got = ops.populations(coords, [2.0], backend=backend,
                              row_block=8, col_block=16)[2.0]
        np.testing.assert_array_equal(got, want)


def test_wide_dimension_backends_agree():
    """D >= 24 must use the same exact per-dimension distance as D <= 16
    (there is no MXU-identity dispatch; see ops/pairwise.py): both backends
    match the float64 brute-force oracle and each other, pops and NN."""
    from clustering_tpu.ops.pairwise import sq_dists, sq_dists_exact
    assert sq_dists is sq_dists_exact
    rng = np.random.default_rng(17)
    coords = rng.normal(size=(70, 32)).astype(np.float32)
    want = oracles.populations(coords, [5.0])[5.0]
    fe = ops.free_energies(want)
    nn_want = oracles.nearest_neighbors(coords, fe)
    for backend in ("xla", "pallas"):
        got = ops.populations(coords, [5.0], backend=backend,
                              row_block=8, col_block=16)[5.0]
        np.testing.assert_array_equal(got, want)
        nn = ops.nearest_neighbors(coords, fe, backend=backend,
                                   row_block=8, col_block=16)
        np.testing.assert_array_equal(nn[0], nn_want[0])


def test_device_bbox_matches_host():
    """pruning.bbox_d2_device + packed plane downloads must agree with
    the host bbox_dist2 (same margin math) and exact threshold masks."""
    import jax
    import jax.numpy as jnp
    from clustering_tpu.ops import pruning
    rng = np.random.default_rng(3)
    padded = rng.normal(size=(1024, 5)).astype(np.float32) * 3.0
    padded[-64:] = np.float32(3e38)  # pad rows
    rb, cb = 16, 64
    rmin, rmax = pruning.block_bboxes(padded, rb)
    cmin, cmax = pruning.block_bboxes(padded, cb)
    host = pruning.bbox_dist2(rmin, rmax, cmin, cmax)
    dev = np.asarray(jax.device_get(pruning.bbox_d2_device(
        jnp.asarray(padded.T), row_block=rb, col_block=cb)))
    finite = np.isfinite(host)
    np.testing.assert_array_equal(host[finite], dev[finite])
    np.testing.assert_array_equal(np.isfinite(dev), finite)
    # packed <= planes, including a threshold hitting exact values
    ts = [0.25, float(host[finite].min()), 50.0]
    planes = pruning.active_masks_device(jnp.asarray(dev), ts)
    for t, plane in zip(ts, planes):
        np.testing.assert_array_equal(plane, host <= np.float32(t),
                                      err_msg=f"t={t}")
    # per-row thresholds
    ub = rng.uniform(0.0, 30.0, size=host.shape[0]).astype(np.float32)
    words = pruning._pack_le_rows2(jnp.asarray(dev), jnp.asarray(dev),
                                   jnp.asarray(np.stack([ub, ub])))
    masks = pruning.unpack_planes(jax.device_get(words), dev.shape[1])
    for mask in masks:
        np.testing.assert_array_equal(mask, dev <= ub[:, None])
    # strict < (the screening engine's construction), including the
    # t=0 edge where a nextafter-based approach would hit XLA's
    # denormal flush
    for t in (np.float32(host[finite].min()), np.float32(0.25)):
        lt = pruning.active_masks_device(jnp.asarray(dev), [t],
                                         strict=True)[0]
        np.testing.assert_array_equal(lt, host < t, err_msg=f"t={t}")


def test_pack_mask_words_roundtrip():
    """pack_mask_words (device) -> unpack_planes (host) is the identity
    on bool masks, including non-multiple-of-32 column counts (the
    tiered NN plan downloads its active mask through this path)."""
    import jax
    from clustering_tpu.ops import pruning
    rng = np.random.default_rng(7)
    for nrb, ncb in ((8, 32), (16, 64), (5, 7), (3, 33), (1, 1)):
        mask = rng.random((nrb, ncb)) < 0.3
        words = np.asarray(jax.device_get(
            pruning.pack_mask_words(mask)))
        assert words.shape == (nrb, -(-ncb // 32))
        np.testing.assert_array_equal(
            pruning.unpack_planes(words, ncb), mask,
            err_msg=f"shape {(nrb, ncb)}")
