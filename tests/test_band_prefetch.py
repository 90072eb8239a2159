"""NN band prefetch (populations -> nearest_neighbors overlap).

``DensityEngine.populations(..., nn_band_radius=r)`` dispatches the NN
band phase off the device counts accumulator before the counts
download; ``nearest_neighbors`` consumes the stash only when its fe is
bit-equal to the engine's host-recomputed free energies (the same
formula as ops.free_energies, so a hit is guaranteed on the production
pops -> free_energies -> nearest_neighbors path). Results must be
bit-identical to a prefetch-free run in every case; guards the
semantics of the reference's fe-ordered joint NN search
(src/density_clustering.cpp:219-280).
"""

import numpy as np
import pytest

from clustering_tpu import ops

RB, CB = 8, 16


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(5)
    a = rng.normal((0.0, 0.0, 0.0), 0.15, size=(160, 3))
    b = rng.normal((1.5, 1.0, -0.5), 0.2, size=(140, 3))
    return np.concatenate([a, b]).astype(np.float32)


def _join(eng):
    """The fe + dispatch half runs on a daemon thread; join it so the
    stash assertions below don't race (nearest_neighbors itself joins
    before consuming)."""
    th = getattr(eng, "_band_prefetch_thread", None)
    if th is not None:
        th.join()


def _engines(blobs):
    eng_pf = ops.engine.DensityEngine(blobs, row_block=RB, col_block=CB,
                                      backend="pallas")
    eng_plain = ops.engine.DensityEngine(blobs, row_block=RB, col_block=CB,
                                         backend="pallas")
    return eng_pf, eng_plain


def test_prefetch_hit_bit_equal(blobs):
    r = 0.4
    eng_pf, eng_plain = _engines(blobs)
    pops_pf = eng_pf.populations([r], nn_band_radius=r)[r]
    _join(eng_pf)
    assert eng_pf._band_prefetch is not None
    pops_plain = eng_plain.populations([r])[r]
    assert eng_plain._band_prefetch is None
    np.testing.assert_array_equal(pops_pf, pops_plain)
    fe = ops.free_energies(pops_pf)
    nn_pf = eng_pf.nearest_neighbors(fe)
    assert eng_pf.last_stats["nn"].get("band_prefetched") is True
    assert eng_pf._band_prefetch is None  # consumed
    nn_plain = eng_plain.nearest_neighbors(fe)
    assert "band_prefetched" not in eng_plain.last_stats["nn"]
    for a, b in zip(nn_pf, nn_plain):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_prefetch_fe_mismatch_falls_back(blobs):
    r = 0.4
    eng_pf, eng_plain = _engines(blobs)
    pops = eng_pf.populations([r], nn_band_radius=r)[r]
    eng_plain.populations([r])
    # an fe the stash was NOT built from (e.g. loaded from a -D file):
    # the stale stash must be dropped and the fresh dispatch used
    fe_other = ops.free_energies(pops) * np.float32(1.5)
    nn_pf = eng_pf.nearest_neighbors(fe_other)
    assert "band_prefetched" not in eng_pf.last_stats["nn"]
    assert eng_pf._band_prefetch is None  # dropped, not kept stale
    nn_plain = eng_plain.nearest_neighbors(fe_other)
    for a, b in zip(nn_pf, nn_plain):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_prefetch_consumed_once(blobs):
    r = 0.4
    eng_pf, _ = _engines(blobs)
    fe = ops.free_energies(eng_pf.populations([r], nn_band_radius=r)[r])
    eng_pf.nearest_neighbors(fe)
    assert eng_pf.last_stats["nn"].get("band_prefetched") is True
    # second call: no stash left, normal dispatch, same results
    nn2 = eng_pf.nearest_neighbors(fe)
    assert "band_prefetched" not in eng_pf.last_stats["nn"]
    _, eng_plain = _engines(blobs)
    eng_plain.populations([r])
    nn_plain = eng_plain.nearest_neighbors(fe)
    for a, b in zip(nn2, nn_plain):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_prefetch_env_kill_switch(blobs, monkeypatch):
    monkeypatch.setenv("CLUSTERING_TPU_NN_PREFETCH", "0")
    eng_pf, _ = _engines(blobs)
    eng_pf.populations([0.4], nn_band_radius=0.4)
    _join(eng_pf)
    assert eng_pf._band_prefetch is None


def test_prefetch_radius_not_in_list(blobs):
    eng_pf, _ = _engines(blobs)
    eng_pf.populations([0.4], nn_band_radius=0.7)
    _join(eng_pf)
    assert eng_pf._band_prefetch is None


def test_prefetch_survives_u16_truncation(blobs, monkeypatch):
    """When the band radius's counts overflow the speculative uint16
    cast (dense big-N runs), the exact int32 row must be refetched and
    the prefetch still taken -- dropping it would push the whole band
    phase onto the NN stage's wall."""
    r = 0.4
    # force "overflow": every count > 4 truncates the u16 row
    monkeypatch.setattr(ops.engine.DensityEngine,
                        "POPS_COUNTS_NARROW_MAX", 4)
    eng_pf, eng_plain = _engines(blobs)
    pops_pf = eng_pf.populations([r], nn_band_radius=r)[r]
    st = eng_pf.last_stats["populations"]
    assert st["counts_dtype"] == "int32"
    assert st.get("band_row_refetched") is True
    _join(eng_pf)
    assert eng_pf._band_prefetch is not None
    pops_plain = eng_plain.populations([r])[r]
    np.testing.assert_array_equal(pops_pf, pops_plain)
    fe = ops.free_energies(pops_pf)
    nn_pf = eng_pf.nearest_neighbors(fe)
    assert eng_pf.last_stats["nn"].get("band_prefetched") is True
    nn_plain = eng_plain.nearest_neighbors(fe)
    for a, b in zip(nn_pf, nn_plain):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_prefetch_with_tiered_speculation(blobs, monkeypatch):
    """Force the tiered phase-2 constants low so the consuming call plans
    the tiered phase 2 on top of the prefetched band phase -- results
    still bit-equal to the plain run."""
    r = 0.4
    monkeypatch.setattr(ops.engine.DensityEngine, "TIERED_MIN_FRAMES", 64)
    monkeypatch.setattr(ops.engine.DensityEngine,
                        "TIERED_MIN_SAVED_PAIRS", -1e18)
    eng_pf, eng_plain = _engines(blobs)
    fe = ops.free_energies(eng_pf.populations([r], nn_band_radius=r)[r])
    _join(eng_pf)
    assert eng_pf._band_prefetch is not None
    nn_pf = eng_pf.nearest_neighbors(fe)
    assert eng_pf.last_stats["nn"].get("band_prefetched") is True
    assert eng_pf.last_stats["nn"]["mode"] == "tiered"
    eng_plain.populations([r])
    nn_plain = eng_plain.nearest_neighbors(fe)
    for a, b in zip(nn_pf, nn_plain):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_band_sigma2_estimate(blobs):
    """band_sigma2_estimate (the during-NN screening-warm input) must
    approximate compute_sigma2 over the true NN distances WITHOUT
    consuming the prefetch stash; no stash -> None."""
    r = 0.4
    eng_pf, eng_plain = _engines(blobs)
    pops = eng_pf.populations([r], nn_band_radius=r)[r]
    est = eng_pf.band_sigma2_estimate()
    assert est is not None and est > 0.0
    assert eng_pf._band_prefetch is not None  # not consumed
    fe = ops.free_energies(pops)
    nn = eng_pf.nearest_neighbors(fe)
    assert eng_pf.last_stats["nn"].get("band_prefetched") is True
    true = ops.neighbors.compute_sigma2(nn[1])
    # the estimate is an upper-bound-mean heuristic: tight at production
    # N (band-miss frames are rare on spatially-sorted data) but loose on
    # a 760-frame toy whose band covers only
    # 64 Morton positions -- pin the sanity envelope, not the accuracy
    assert 0.3 * true < est < 3.0 * true
    eng_plain.populations([r])  # no nn_band_radius -> no stash
    assert eng_plain.band_sigma2_estimate() is None
