"""Naive brute-force reference implementations used as test oracles.

These mirror the reference C++ semantics directly (O(N^2) python/numpy,
small fixtures only) so the device ops can be checked against an independent
implementation.
"""

import numpy as np


def sq_dist_matrix(coords):
    """Exact fp32 per-dimension accumulation, ascending d."""
    coords = np.asarray(coords, dtype=np.float32)
    n, d = coords.shape
    acc = np.zeros((n, n), dtype=np.float32)
    for k in range(d):
        diff = coords[:, k][:, None] - coords[:, k][None, :]
        acc = acc + diff * diff
    return acc


def populations(coords, radii):
    """CUDA semantics: d2 <= r^2 including self."""
    d2 = sq_dist_matrix(coords)
    out = {}
    for r in radii:
        out[r] = (d2 <= np.float32(r * r)).sum(axis=1).astype(np.int64)
    return out


def nearest_neighbors(coords, fe):
    """CUDA-semantics NN / NN-higher-density (d2 > 0 required,
    smallest-j tie break, (0, 0.0) if none)."""
    d2 = sq_dist_matrix(coords)
    fe = np.asarray(fe, dtype=np.float32)
    n = len(fe)
    nh_idx = np.zeros(n, dtype=np.int64)
    nh_d = np.zeros(n, dtype=np.float32)
    hd_idx = np.zeros(n, dtype=np.int64)
    hd_d = np.zeros(n, dtype=np.float32)
    for i in range(n):
        best_d, best_j = np.inf, -1
        besth_d, besth_j = np.inf, -1
        for j in range(n):
            dij = d2[i, j]
            if dij <= 0.0:
                continue
            if dij < best_d:
                best_d, best_j = dij, j
            if fe[j] < fe[i] and dij < besth_d:
                besth_d, besth_j = dij, j
        if best_j >= 0:
            nh_idx[i], nh_d[i] = best_j, best_d
        if besth_j >= 0:
            hd_idx[i], hd_d[i] = besth_j, besth_d
    return nh_idx, nh_d, hd_idx, hd_d


def connected_component_labels(coords_sorted, initial_labels, n_below,
                               max_dist2):
    """Union-find over the epsilon-graph restricted to the first n_below
    frames, with equal initial labels acting as permanent equivalences.
    Returns min-member-index labels (the screening fixpoint semantics)."""
    coords_sorted = np.asarray(coords_sorted, dtype=np.float32)
    n = coords_sorted.shape[0]
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    # seed equivalences
    for i in range(n_below):
        if initial_labels[i] != i:
            union(i, int(initial_labels[i]))
    d2 = sq_dist_matrix(coords_sorted)
    for i in range(n_below):
        for j in range(i + 1, n_below):
            if d2[i, j] < max_dist2:
                union(i, j)
    labels = np.arange(n, dtype=np.int64)
    for i in range(n_below):
        labels[i] = find(i)
    return labels
