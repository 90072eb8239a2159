"""Large-scale golden parity on real hardware: the reference's OWN
compiled density core vs this framework's production engine at 100k
frames (8x the CI golden fixtures, which run at up to 12k on CPU).

Compiles /root/reference's density translation units via the same
tests/refstub route as the golden suite (reference code is linked as an
oracle, never copied), generates a metastable 100k-frame trajectory,
and compares:

  * populations   -- exact integer equality (CUDA `d2 <= r^2` semantics;
                     the CPU oracle differs only on exact fp32 boundary
                     ties, counted if any occur),
  * NN / NN-hd    -- indices exact; distances exact on CPU, <=1 ulp on
                     the GPU (the documented fma class, docs/PARITY.md
                     "Floating-point notes"),
  * 3-threshold screening series -- exact label equality through the
                     production ThresholdSeriesScreener.

Writes the JSON named by PAR_OUT. Runtime is oracle-bound (minutes of
single-core reference C++).

Usage: python parity_bigscale.py      # env: PAR_N, PAR_OUT
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

N = int(os.environ.get("PAR_N", 100_000))
D = 4
RADIUS = 0.10
THRESHOLDS = [0.8, 1.6, 2.4]
OUT = os.environ.get("PAR_OUT", "parity_100k.json")
REF_SRC = "/root/reference/src"
STUB = os.path.join(os.path.dirname(__file__), "tests", "refstub")
ORACLE_SRC = os.path.join(os.path.dirname(__file__), "tests",
                          "density_oracle.cpp")


def build_oracle(tmp):
    cxx = shutil.which("g++")
    if cxx is None or not os.path.isdir(REF_SRC):
        raise SystemExit("reference sources or g++ unavailable")
    exe = os.path.join(tmp, "density_oracle")
    subprocess.run(
        [cxx, "-O2", "-fopenmp", "-std=c++11", "-I", STUB, "-I", REF_SRC,
         ORACLE_SRC,
         os.path.join(REF_SRC, "density_clustering.cpp"),
         os.path.join(REF_SRC, "density_clustering_common.cpp"),
         os.path.join(REF_SRC, "tools.cpp"),
         os.path.join(REF_SRC, "logger.cpp"),
         "-o", exe],
        check=True, capture_output=True)
    return exe


def main():
    import jax

    plat = os.environ.get("JAX_PLATFORMS")
    if plat:
        jax.config.update("jax_platforms", plat)

    from bench import synthetic_fel
    from clustering_tpu import ops

    tmp = tempfile.mkdtemp(prefix="parity100k_")
    oracle = build_oracle(tmp)
    coords = synthetic_fel(N, D)
    path = os.path.join(tmp, "coords.dat")
    np.savetxt(path, coords, fmt="%.6f")
    coords = np.loadtxt(path, dtype=np.float32)  # shared quantization

    platform = jax.devices()[0].platform
    result = {"n_frames": N, "d": D, "platform": platform,
              "device": str(jax.devices()[0]), "radius": RADIUS,
              "thresholds": THRESHOLDS, "checks": {}}
    checks = result["checks"]

    eng = ops.engine.DensityEngine(coords, row_block=128, col_block=4096,
                                   backend="pallas")

    # --- populations ---
    t0 = time.perf_counter()
    pops = eng.populations([RADIUS])[RADIUS]
    result["device_pops_seconds"] = round(time.perf_counter() - t0, 3)
    result["device_pops_substages"] = {
        k: round(v, 3) for k, v in
        eng.last_stats.get("populations", {}).items()
        if isinstance(v, float) and k.startswith("t_")}
    t0 = time.perf_counter()
    out = subprocess.run([oracle, "pops", path, str(RADIUS)],
                         check=True, capture_output=True,
                         text=True).stdout.splitlines()
    result["oracle_pops_seconds"] = round(time.perf_counter() - t0, 3)
    ref_pops = np.array([int(x) for x in out if not x.startswith("#")],
                        dtype=np.int64)
    mism = int((pops != ref_pops).sum())
    checks["pops_exact"] = mism == 0
    if mism:
        # the only admissible divergence: the oracle is the reference's
        # CPU backend (strict d2 < r^2, self pre-counted); we implement
        # the CUDA semantics (d2 <= r^2). Verify every mismatching frame
        # has exactly that many pairs sitting EXACTLY on the fp32
        # boundary (host recompute, unfused arithmetic).
        result["pops_mismatches"] = mism
        bad = np.flatnonzero(pops != ref_pops)
        r2 = np.float32(RADIUS) * np.float32(RADIUS)
        tie_class = True
        for i in bad:
            d2 = np.zeros(len(coords), dtype=np.float32)
            for k in range(D):
                dk = coords[:, k] - coords[i, k]
                d2 = d2 + dk * dk
            n_boundary = int((d2 == r2).sum())
            tie_class &= (n_boundary > 0
                          and int(pops[i]) == int(ref_pops[i]) + n_boundary)
        checks["pops_boundary_tie_class"] = bool(tie_class)

    # --- free energies shared through a file (both sides parse fp32) ---
    fe = ops.free_energies(pops)
    fe_path = os.path.join(tmp, "fe.dat")
    np.savetxt(fe_path, fe, fmt="%.9g")
    fe = np.loadtxt(fe_path, dtype=np.float32)

    # --- NN / NN-hd ---
    t0 = time.perf_counter()
    nh_j, nh_d, hd_j, hd_d = eng.nearest_neighbors(fe)
    result["device_nn_seconds"] = round(time.perf_counter() - t0, 3)
    result["device_nn_substages"] = {
        k: round(v, 3) for k, v in eng.last_stats.get("nn", {}).items()
        if isinstance(v, float) and k.startswith("t_")}
    t0 = time.perf_counter()
    out = subprocess.run([oracle, "nn", path, fe_path], check=True,
                         capture_output=True, text=True).stdout
    result["oracle_nn_seconds"] = round(time.perf_counter() - t0, 3)
    ref = np.array([line.split() for line in out.splitlines()],
                   dtype=np.float64)
    checks["nn_idx_exact"] = bool((nh_j == ref[:, 0].astype(np.int64))
                                  .all())
    # the reference CPU backend reports (n_rows+1, FLT_MAX) when no
    # lower-fe neighbor exists; we follow the CUDA convention (0, 0.0)
    has_hd = ref[:, 2].astype(np.int64) != N + 1
    checks["nn_hd_idx_exact"] = bool(
        (hd_j[has_hd] == ref[has_hd, 2].astype(np.int64)).all()
        and (hd_j[~has_hd] == 0).all())
    # distances: exact on CPU; <=1 ulp fma class on the GPU
    rel = np.abs(nh_d - ref[:, 1].astype(np.float32)) \
        / np.maximum(ref[:, 1].astype(np.float32), np.float32(1e-30))
    result["nn_dist_max_rel_diff"] = float(rel.max())
    result["nn_dist_frames_differing"] = int((rel > 0).sum())
    checks["nn_dist_1ulp"] = bool(rel.max() <= 2.4e-7)

    # --- screening series through the production screener ---
    t0 = time.perf_counter()
    out = subprocess.run(
        [oracle, "screen", path, fe_path]
        + [str(t) for t in THRESHOLDS],
        check=True, capture_output=True, text=True).stdout
    result["oracle_screen_seconds"] = round(time.perf_counter() - t0, 3)
    ref_blocks = []
    for line in out.splitlines():
        if line.startswith("# t "):
            ref_blocks.append([])
        else:
            ref_blocks[-1].append(int(line))
    md2 = np.float32(4.0 * ops.neighbors.compute_sigma2(nh_d))
    series = ops.screening.ThresholdSeriesScreener(
        coords, fe, [np.float32(t) for t in THRESHOLDS],
        row_block=128, col_block=4096, backend="pallas",
        hd_neighbors=(hd_j, hd_d))
    clustering = None
    t0 = time.perf_counter()
    ok = True
    for k, ref_block in enumerate(ref_blocks):
        clustering = series.step(clustering, k, md2)
        ok = ok and bool(np.array_equal(clustering,
                                        np.asarray(ref_block)))
    result["device_screen_seconds"] = round(time.perf_counter() - t0, 3)
    checks["screening_labels_exact"] = ok

    required = dict(checks)
    if (not required.get("pops_exact", True)
            and required.get("pops_boundary_tie_class")):
        # CPU-vs-CUDA radius-boundary semantics, verified per-frame above
        # (docs/PARITY.md "Semantics chosen where reference backends
        # disagree")
        required.pop("pops_exact")
    result["ok"] = all(required.values())
    print(json.dumps(result, indent=1))
    with open(OUT, "w") as fh:
        json.dump(result, fh, indent=1)
    if not result["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
