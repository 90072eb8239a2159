import pytest
import numpy as np

from clustering_tpu.models import mpp


def oracle_transition_counts(traj, limits, lag):
    """Literal transcription of reference mpp.cpp:78-111."""
    counts = {}
    limits = list(limits)
    li = 0
    for i in range(len(traj) - lag):
        frm, to = traj[i], traj[i + lag]
        if li < len(limits):
            if i + lag < limits[li]:
                row = counts.setdefault(frm, {})
                row[to] = row.get(to, 0) + 1
            elif i + 1 == limits[li]:
                li += 1
        else:
            row = counts.setdefault(frm, {})
            row[to] = row.get(to, 0) + 1
    return counts


def test_transition_counts_single_chunk():
    traj = [1, 1, 2, 2, 1, 2]
    got = mpp.transition_counts(traj, [6], 1)
    want = oracle_transition_counts(traj, [6], 1)
    assert {i: {j: int(c) for j, c in r.items()} for i, r in got.items()} \
        == want


def test_transition_counts_respects_limits():
    rng = np.random.default_rng(3)
    traj = rng.integers(1, 4, size=50).tolist()
    for limits in ([50], [20, 50], [10, 30, 50], [25]):
        for lag in (1, 2, 5):
            got = mpp.transition_counts(traj, limits, lag)
            want = oracle_transition_counts(traj, limits, lag)
            got_int = {i: {j: int(c) for j, c in r.items()}
                       for i, r in got.items()}
            assert got_int == want, (limits, lag)


def test_row_normalized():
    counts = {1: {1: 3.0, 2: 1.0}, 2: {1: 2.0, 2: 2.0}}
    t = mpp.row_normalized(counts, [1, 2])
    assert abs(t[1][1] - 0.75) < 1e-7
    assert abs(t[1][2] - 0.25) < 1e-7
    assert abs(t[2][1] - 0.5) < 1e-7


def test_future_state_stays_when_stable():
    t = {1: {1: 0.9, 2: 0.1}, 2: {2: 0.8, 1: 0.2}}
    fut = mpp.single_step_future_state(t, [1, 2], 0.5, {1: 0.0, 2: 1.0})
    assert fut == {1: 1, 2: 2}


def test_future_state_moves_when_unstable():
    t = {1: {1: 0.3, 2: 0.7}, 2: {2: 0.9, 1: 0.1}}
    fut = mpp.single_step_future_state(t, [1, 2], 0.5, {1: 0.0, 2: 1.0})
    assert fut == {1: 2, 2: 2}


def test_most_probable_path_cycles():
    fut = {1: 2, 2: 3, 3: 2}
    paths = mpp.most_probable_path(fut, [1, 2, 3])
    assert paths[1] == [1, 2, 3]
    assert paths[2] == [2, 3]


def test_lumped_trajectory():
    traj = [1, 2, 3, 2, 1]
    out = mpp.lumped_trajectory(traj, {1: 1, 2: 1, 3: 3})
    np.testing.assert_array_equal(out, [1, 1, 3, 1, 1])


def _two_state_markov(n=4000, seed=0):
    """Microstates 1,2 metastable pair; 3 a separate metastable state."""
    rng = np.random.default_rng(seed)
    traj = []
    state = 1
    for _ in range(n):
        r = rng.random()
        if state == 1:
            state = 2 if r < 0.3 else 1
        elif state == 2:
            state = 1 if r < 0.4 else (3 if r < 0.42 else 2)
        else:
            state = 2 if r < 0.02 else 3
        traj.append(state)
    return np.asarray(traj)


def test_fixed_metastability_lumps_fast_exchanging_pair():
    traj = _two_state_markov()
    names = sorted(set(traj.tolist()))
    counts = mpp.transition_counts(traj, [len(traj)], 1)
    t = mpp.row_normalized(counts, names)
    fe = np.asarray([0.0, 0.1, 0.5, 0.3], dtype=np.float32)[
        np.minimum(traj, 3)]
    # fe indexed per frame; states 1/2 exchange fast -> lumped at high qmin
    out, lumping, t2 = mpp.fixed_metastability_clustering(traj, t, 0.8, fe)
    final_states = set(out.tolist())
    assert len(final_states) == 2
    assert 3 in final_states
    # states 1 and 2 were merged into one of them
    assert lumping, "expected at least one lump"


def test_weighted_transition_counts_intended_semantics():
    """The fixed (intended) per-chunk sqrt-weighted counts: two chunks with
    different sampling weight."""
    # chunk 1: 1->1 x3, 1->2 x1 ; chunk 2: 1->2 x1
    traj = [1, 1, 1, 1, 2, 1, 2]
    limits = [5, 7]
    w = mpp.weighted_transition_counts(traj, limits, 1)
    # chunk1 row1 counts {1:3, 2:1}, weight sqrt(4)=2
    # chunk2 row1 counts {2:1}, weight sqrt(1)=1
    # weighted row1 = (2*{3,1} + 1*{0,1}) / (2+1) = {2.0, 1.0}
    assert abs(w[1][1] - 2.0) < 1e-6
    assert abs(w[1][2] - 1.0) < 1e-6
    # state 2 only ever appears as the last frame of a chunk: no row
    assert 2 not in w


def test_weighted_counts_reduce_to_plain_for_single_chunk():
    rng = np.random.default_rng(4)
    traj = rng.integers(1, 4, size=40).tolist()
    plain = mpp.transition_counts(traj, [40], 2)
    weighted = mpp.weighted_transition_counts(traj, [40], 2)
    for i, row in plain.items():
        for j, c in row.items():
            assert abs(weighted[i][j] - c) < 1e-6


# ---------------------------------------------------------------------------
# vectorized hot paths vs literal scalar transcriptions (reference order)
# ---------------------------------------------------------------------------

def oracle_future_state(tmat, cluster_names, q_min, min_fe):
    """Literal transcription of reference mpp.cpp:234-286."""
    future = {}
    name_set = set(cluster_names)
    for i in cluster_names:
        if tmat.get(i, {}).get(i, 0.0) >= q_min:
            candidates = [i]
        else:
            candidates, max_p = [], 0.0
            for j in sorted(tmat.get(i, {})):
                if i == j or j not in name_set:
                    continue
                p = tmat[i][j]
                if p > max_p:
                    max_p, candidates = p, [j]
                elif p == max_p and max_p > 0.0:
                    candidates.append(j)
        assert candidates, f"state {i} found no candidates"
        future[i] = (candidates[0] if len(candidates) == 1 else
                     min(candidates, key=lambda s: min_fe[s]))
    return future


def oracle_updated_tmat(tmat, sinks, pops):
    """Literal transcription of reference mpp.cpp:181-232 (double acc)."""
    macrostates = sorted(set(sinks.values()))
    micro_of = {m: set() for m in macrostates}
    for frm, to in sinks.items():
        micro_of[to].add(frm)
    relative_pops = {}
    for m in macrostates:
        pop_total = sum(pops.get(u, 0) for u in micro_of[m])
        for u in micro_of[m]:
            relative_pops[u] = float(
                np.float32(np.float32(pops.get(u, 0))
                           / np.float32(pop_total)))
    updated = {}
    for m1 in macrostates:
        row, row_sum = {}, 0.0
        for m2 in macrostates:
            acc = 0.0
            for u1 in sorted(micro_of[m1]):
                r = tmat.get(u1, {})
                rp = relative_pops[u1]
                for u2 in sorted(micro_of[m2]):
                    acc += rp * r.get(u2, 0.0)
            if acc != 0.0:
                row[m2] = acc
            row_sum += acc
        if row_sum != 0.0:
            for m2 in row:
                row[m2] /= row_sum
        updated[m1] = row
    return updated


def _random_tmat(rng, states, density=0.3, quantized=True):
    tmat = {}
    for i in states:
        row = {}
        for j in states:
            if rng.random() < density:
                # fp32-quantized simple fractions make exact probability
                # ties common -- stresses the tie-breaking rules
                row[j] = (float(np.float32(rng.integers(1, 5) / 8.0))
                          if quantized else float(rng.random()))
        if row:
            tmat[i] = row
    return tmat


def test_future_state_matches_literal_oracle_fuzz():
    rng = np.random.default_rng(0)
    for trial in range(30):
        states = sorted(rng.choice(np.arange(1, 200), size=25,
                                   replace=False).tolist())
        tmat = _random_tmat(rng, states)
        min_fe = {s: float(np.float32(rng.integers(0, 6) / 4.0))
                  for s in states}
        q_min = float(rng.choice([0.125, 0.25, 0.375, 0.5]))
        # guarantee every state has at least one candidate
        for i in states:
            row = tmat.setdefault(i, {})
            if not any(j != i and p > 0 for j, p in row.items()) \
                    and row.get(i, 0.0) < q_min:
                row[(states[0] if i != states[0] else states[1])] = 0.25
        want = oracle_future_state(tmat, states, q_min, min_fe)
        got = mpp.single_step_future_state(tmat, states, q_min, min_fe)
        assert got == want, (trial, q_min)


def test_updated_tmat_matches_literal_oracle_fuzz():
    rng = np.random.default_rng(1)
    for trial in range(20):
        states = sorted(rng.choice(np.arange(1, 100), size=20,
                                   replace=False).tolist())
        tmat = _random_tmat(rng, states, density=0.4, quantized=False)
        sinks = {s: int(rng.choice(states[:7])) for s in states}
        # pops come from the trajectory in production, so every state in
        # sinks has pop >= 1 (pop_total == 0 would NaN-poison the row in
        # the reference as well)
        pops = {s: int(rng.integers(1, 50)) for s in states}
        want = oracle_updated_tmat(tmat, sinks, pops)
        got = mpp.updated_transition_probabilities(tmat, sinks, pops)
        assert set(got) == set(want)
        for m1 in want:
            assert set(got[m1]) == set(want[m1]), (trial, m1)
            for m2, v in want[m1].items():
                # group sums use numpy pairwise summation; agreement is
                # to ~1e-15 relative, far below the documented ~1e-7
                # deviation from the reference's fp32 accumulation
                assert got[m1][m2] == pytest.approx(v, rel=1e-12), \
                    (trial, m1, m2)


def test_mpp_production_scale_fast():
    """10^4 states x 10^6 frames must run in seconds, not hours
    (the reference pays the same complexity in C++,
    mpp.cpp:181-232)."""
    import time
    rng = np.random.default_rng(0)
    n = 1_000_000
    basin = rng.integers(0, 100, n // 100)
    traj = (np.repeat(basin, 100) * 100
            + rng.integers(0, 100, n) + 1).astype(np.int64)
    fe = rng.random(n).astype(np.float32) * 5.0
    t0 = time.perf_counter()
    counts = mpp.transition_counts(traj, [n], 10)
    tmat = mpp.row_normalized(counts, np.unique(traj).tolist())
    out, _, _ = mpp.fixed_metastability_clustering(traj, tmat, 0.5, fe)
    elapsed = time.perf_counter() - t0
    assert len(np.unique(out)) < 10_000
    assert elapsed < 120.0, f"production-scale MPP took {elapsed:.1f}s"
