"""The comparison rules chip_smoke.py holds the card's results to
(docs/PARITY.md): population counts may differ from the XLA reference
only by radius-boundary ties, explained per frame."""

import fractions

import numpy as np
import pytest

import chip_smoke as cs


def test_f32_round_matches_numpy():
    """Exact rational rounding agrees with numpy's single rounding of a
    float64 (which a Fraction represents exactly), subnormals included."""
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.random(2000) * 10.0 ** rng.integers(-8, 4,
                                                                    2000),
                           [1e-45, 3e-39, 0.01, 1.0, 2.0 ** -126]])
    for v in vals:
        assert cs.f32_round(fractions.Fraction(float(v))) == np.float32(v)


def test_f32_round_ties_to_even():
    one = fractions.Fraction(1)
    half_ulp = fractions.Fraction(1, 2 ** 24)
    assert cs.f32_round(one + half_ulp) == np.float32(1.0)
    assert cs.f32_round(one + 3 * half_ulp) == np.float32(1.0) + np.spacing(
        np.float32(1.0)) * 2


def test_d2_fma_is_one_rounding_per_step():
    """Where a*a + acc is exact in float64, one fma step equals a single
    float32 rounding of that sum."""
    rng = np.random.default_rng(1)
    for _ in range(200):
        d = rng.uniform(0.5, 1.0, 3).astype(np.float32)
        acc = np.float32(0.0)
        for dk in d:
            acc = np.float32(np.float64(dk) * np.float64(dk)
                             + np.float64(acc))
        assert cs.d2_fma(d) == acc


def _split_pair(r2, seed=2):
    """Two frames whose squared distance the fma and the unfused
    roundings put on opposite sides of r2."""
    rng = np.random.default_rng(seed)
    r = float(np.sqrt(r2))
    for _ in range(20):
        th = rng.uniform(0.0, 2.0 * np.pi, 4000)
        x = rng.uniform(-1.0, 1.0, 2).astype(np.float32)
        ys = (x + np.stack([r * np.cos(th), r * np.sin(th)], 1)
              ).astype(np.float32)
        diff = ys - x
        sep = diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]
        for y in ys[np.abs(sep - r2) <= np.spacing(r2)]:
            ex = cs.explain_count(np.stack([x, y]), 0, r2)
            if ex["fma"] != ex["unfused"]:
                return np.stack([x, y]), ex
    pytest.fail("no split pair found")


@pytest.mark.parametrize("kernel", ["fma", "unfused"])
def test_rounding_split_is_a_tie(kernel):
    """A pair the two roundings put on opposite sides of r^2 is a 1-ulp
    boundary tie, so either program's count passes against the other's."""
    r = 0.1
    r2 = np.float32(r) * np.float32(r)
    coords, ex = _split_pair(r2)
    assert ex["ties"] == 1 and abs(ex["fma"] - ex["unfused"]) == 1
    other = "unfused" if kernel == "fma" else "fma"
    got = np.asarray([ex[kernel], 1])
    want = np.asarray([ex[other], 1])
    assert cs.pops_within_ties(coords, got, want, r, say=lambda s: None) == 1
    # one count more than the ties allow is a fault
    worse = want.copy()
    worse[0] += 1 if ex[other] > ex[kernel] else -1
    with pytest.raises(cs.PhaseError, match="frame 0 .* not explained"):
        cs.pops_within_ties(coords, got, worse, r, say=lambda s: None)


def test_unexplained_difference_fails():
    """A count off by one with no pair near the boundary is a fault."""
    coords = np.asarray([[0.0, 0.0], [0.05, 0.0], [0.5, 0.5]], np.float32)
    got = np.asarray([2, 2, 1])
    want = np.asarray([3, 2, 1])
    with pytest.raises(cs.PhaseError, match="not explained"):
        cs.pops_within_ties(coords, got, want, 0.1, say=lambda s: None)


def test_equal_counts_pass_and_frames_map():
    coords = np.asarray([[0.0, 0.0], [0.05, 0.0], [0.5, 0.5]], np.float32)
    counts = np.asarray([2, 1])
    assert cs.pops_within_ties(coords, counts, counts, 0.1,
                               frames=np.asarray([0, 2]),
                               say=lambda s: None) == 0
