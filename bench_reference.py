"""Measured baseline: the reference's own CPU density code on this host.

Compiles the reference's density core (via tests/refstub, same route as
the golden-parity oracle) with the reference's production optimization
flags (CMakeLists.txt:41-43: -O3 -ffast-math -ftree-vectorize, plus
-march=native standing in for its SSE/AVX options) and times pops / NN /
screening on the same synthetic landscape bench.py uses, at a size the
CPU can finish. Prints one JSON line with per-stage pair rates.

This turns BASELINE.md's roofline *estimate* into a measured number for
the CPU backend; the CUDA backend stays an estimate (no NVIDIA hardware
here). Note this VM exposes a single core, so OpenMP parallelism ~1x;
scale by core count when comparing to multicore deployments.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
REF_SRC = "/root/reference/src"
STUB = os.path.join(REPO, "tests", "refstub")
ORACLE_SRC = os.path.join(REPO, "tests", "density_oracle.cpp")

N = int(os.environ.get("REFBENCH_N", 1 << 16))
D = int(os.environ.get("REFBENCH_D", 4))
RADII = [0.10, 0.15, 0.20]
THRESHOLDS = [0.5, 1.0, 1.5, 2.0]


def build(outdir):
    cxx = shutil.which("g++")
    exe = os.path.join(outdir, "density_oracle_o3")
    subprocess.run(
        [cxx, "-O3", "-ffast-math", "-ftree-vectorize", "-march=native",
         "-fopenmp", "-std=c++11", "-I", STUB, "-I", REF_SRC, ORACLE_SRC,
         os.path.join(REF_SRC, "density_clustering.cpp"),
         os.path.join(REF_SRC, "density_clustering_common.cpp"),
         os.path.join(REF_SRC, "tools.cpp"),
         os.path.join(REF_SRC, "logger.cpp"),
         "-o", exe],
        check=True, capture_output=True)
    return exe


def build_mpp(outdir):
    cxx = shutil.which("g++")
    exe = os.path.join(outdir, "mpp_oracle_o3")
    subprocess.run(
        [cxx, "-O3", "-ffast-math", "-ftree-vectorize", "-march=native",
         "-std=c++11", "-I", STUB, "-I", REF_SRC,
         os.path.join(REPO, "tests", "mpp_oracle.cpp"),
         os.path.join(REF_SRC, "mpp.cpp"),
         os.path.join(REF_SRC, "tools.cpp"),
         os.path.join(REF_SRC, "logger.cpp"),
         "-o", exe],
        check=True, capture_output=True)
    return exe


def bench_mpp(workdir):
    """Reference MPP vs clustering_tpu MPP on an identical synthetic
    production-scale input (1M frames, ~600 microstates, 3-step Q_min
    series) -- the reference pays its O(S^2 * members) re-lumping in
    C++, the rebuild in vectorized sparse numpy."""
    rng = np.random.default_rng(7)
    n, s = 1 << 20, 600
    # metastable microstate trajectory: slow basin hops + in-basin noise
    basins = np.minimum(np.cumsum(rng.random(n) < 5e-4) % 6, 5)
    traj = (basins * (s // 6)
            + rng.integers(0, s // 6, size=n) + 1).astype(np.int64)
    fe = rng.random(s + 1).astype(np.float32) * 5.0
    fe_frames = fe[traj]
    states_path = os.path.join(workdir, "mpp_states.dat")
    fe_path = os.path.join(workdir, "mpp_fe.dat")
    np.savetxt(states_path, traj, fmt="%d")
    np.savetxt(fe_path, fe_frames, fmt="%.6f")
    qmins = ["0.5", "0.7", "0.9"]

    exe = build_mpp(workdir)
    t0 = time.perf_counter()
    subprocess.run([exe, states_path, fe_path, "10"] + qmins,
                   check=True, capture_output=True)
    t_ref = time.perf_counter() - t0

    from clustering_tpu.models import mpp as mpp_model
    t0 = time.perf_counter()
    tr = traj.copy()
    trans = mpp_model.row_normalized(
        mpp_model.transition_counts(tr, [n], 10),
        np.unique(tr).tolist())
    for q in qmins:
        tr, _, trans = mpp_model.fixed_metastability_clustering(
            tr, trans, np.float32(float(q)), fe_frames)
    t_ours = time.perf_counter() - t0
    print(f"# ref mpp:  {t_ref:.2f}s | clustering_tpu mpp: {t_ours:.2f}s"
          f"  ({t_ref / t_ours:.1f}x)", file=sys.stderr)
    return t_ref, t_ours


def build_modes(outdir):
    cxx = shutil.which("g++")
    cc = shutil.which("gcc") or cxx
    xdr = os.path.join(REF_SRC, "coords_file", "xdrfile")
    objs = []
    for c in ("xdrfile.c", "xdrfile_xtc.c"):  # C sources: compile as C
        obj = os.path.join(outdir, c + ".o")
        subprocess.run([cc, "-O3", "-march=native", "-c",
                        os.path.join(xdr, c), "-I", xdr, "-o", obj],
                       check=True, capture_output=True)
        objs.append(obj)
    exe = os.path.join(outdir, "modes_oracle_o3")
    subprocess.run(
        [cxx, "-O3", "-ffast-math", "-ftree-vectorize", "-march=native",
         "-std=c++17", "-fopenmp", "-I", STUB, "-I", REF_SRC,
         os.path.join(REPO, "tests", "modes_oracle.cpp"),
         os.path.join(REF_SRC, "coring.cpp"),
         os.path.join(REF_SRC, "noise.cpp"),
         os.path.join(REF_SRC, "network_builder.cpp"),
         os.path.join(REF_SRC, "state_filter.cpp"),
         os.path.join(REF_SRC, "coords_file", "coords_file.cpp"),
         os.path.join(REF_SRC, "tools.cpp"),
         os.path.join(REF_SRC, "logger.cpp"), *objs,
         "-o", exe],
        check=True, capture_output=True)
    return exe


def bench_host_modes(workdir):
    """Reference coring/noise/network/stats (its own mode entry points,
    -O3 -march=native) vs the ``clustering`` CLI, paired alternating
    best-of-3 subprocess wall clocks on an identical 1M-frame fixture.
    Both sides pay one process spawn; the CLI side includes interpreter
    + numpy startup (the reference binary's AOT equivalent is ~0)."""
    rng = np.random.default_rng(11)
    n, s = 1 << 20, 600
    basins = np.minimum(np.cumsum(rng.random(n) < 5e-4) % 6, 5)
    traj = (basins * (s // 6)
            + rng.integers(0, s // 6, size=n) + 1).astype(np.int64)
    # the #@ provenance lines gate noise's highest-clust-file scan
    # (reference noise.cpp:128-141 rejects candidates outside
    # [screening_to, screening_to + screening_step])
    np.savetxt(os.path.join(workdir, "states.dat"), traj, fmt="%d",
               header=("#@   screening_from = 0.50000\n"
                       "#@   screening_step = 0.50000\n"
                       "#@   screening_to = 2.00000"), comments="")
    with open(os.path.join(workdir, "win.dat"), "w") as fh:
        fh.write("*\n20\n")
    # nested screening series (what density -T emits): per-state fe,
    # clusters merge 4:1 per threshold step, noise frames are 0
    fe_state = (rng.random(s + 1) * 2.0).astype(np.float32)
    thresholds = [0.5, 1.0, 1.5, 2.0]
    fe_frames = fe_state[traj]
    for k, t in enumerate(thresholds):
        lab = np.where(fe_frames <= t, traj // (1 << k) + 1, 0)
        np.savetxt(os.path.join(workdir, f"clust.{t:.2f}"), lab, fmt="%d")

    # filter fixture: (N, 4) float coords in the filter mode's own
    # " %g ..." row format (native formatter; np.savetxt is ~15s at 1M)
    from clustering_tpu.utils import textio_native
    coords4 = rng.normal(0.0, 1.0, (n, 4)).astype(np.float32)
    body = textio_native.format_g_rows(coords4)
    if body is not None:
        with open(os.path.join(workdir, "coords4.dat"), "wb") as fh:
            fh.write(body)
    else:  # native lib unavailable/stale
        np.savetxt(os.path.join(workdir, "coords4.dat"), coords4, fmt="%g")

    exe = build_modes(workdir)
    cli = os.path.join(REPO, "clustering")
    pairs = {
        "coring": (
            [exe, "coring", "states.dat", "win.dat", "ref_cored",
             "ref_wtd", "ref_cores", "0"],
            [cli, "coring", "-s", "states.dat", "-w", "win.dat",
             "-o", "cored", "-d", "wtd", "--cores", "cores.dat"]),
        "noise": (
            [exe, "noise", "states.dat", "ref_denoised", "clust", "10",
             "ref_noise_cores"],
            [cli, "noise", "-s", "states.dat", "-o", "denoised",
             "-b", "clust", "-c", "10"]),
        "network": (
            [exe, "network", "1", "clust", "net", "0.5", "2.0", "0.5"],
            [cli, "network", "-p", "1", "-b", "clust", "-o", "tnet",
             "--min", "0.5", "--max", "2.0", "--step", "0.5"]),
        "stats": (
            [exe, "stats", "states.dat"],
            [cli, "stats", "-s", "states.dat"]),
        "filter": (
            [exe, "filter", "states.dat", "coords4.dat", "ref_sel", "1",
             "3", "4", "5"],
            [cli, "filter", "-s", "states.dat", "-c", "coords4.dat",
             "-o", "sel", "-S", "3", "4", "5"]),
    }
    out = {}
    for name, (ref_cmd, cli_cmd) in pairs.items():
        t_ref = t_cli = float("inf")
        for _ in range(3):  # alternating: single-core VM variance
            t0 = time.perf_counter()
            subprocess.run(ref_cmd, cwd=workdir, check=True,
                           capture_output=True)
            t_ref = min(t_ref, time.perf_counter() - t0)
            t0 = time.perf_counter()
            subprocess.run(cli_cmd, cwd=workdir, check=True,
                           capture_output=True)
            t_cli = min(t_cli, time.perf_counter() - t0)
        out[name] = {"reference": round(t_ref, 3),
                     "clustering_tpu": round(t_cli, 3)}
        print(f"# ref {name}: {t_ref:.2f}s | clustering_tpu {name}:"
              f" {t_cli:.2f}s ({t_ref / t_cli:.1f}x)", file=sys.stderr)
    return out


def main():
    sys.path.insert(0, REPO)
    from bench import synthetic_fel

    workdir = tempfile.mkdtemp(prefix="refbench_")
    exe = build(workdir)
    coords = synthetic_fel(N, D)
    coords_path = os.path.join(workdir, "coords.dat")
    np.savetxt(coords_path, coords, fmt="%.6f")

    def run(args):
        t0 = time.perf_counter()
        out = subprocess.run([exe] + args, check=True, capture_output=True,
                             text=True).stdout
        return time.perf_counter() - t0, out

    # pops (the reference CPU path applies its box-grid pruning here)
    t_pops, out = run(["pops", coords_path] + [str(r) for r in RADII])
    pops = np.array([int(l) for l in out.splitlines()
                     if not l.startswith("#")],
                    dtype=np.int64).reshape(len(RADII), N)
    print(f"# ref pops:   {t_pops:.2f}s "
          f"({N * float(N) / t_pops:.3e} pairs/s)", file=sys.stderr)

    fe = -np.log(np.maximum(pops[0], 1) / float(pops[0].max()))
    fe_path = os.path.join(workdir, "fe.dat")
    np.savetxt(fe_path, fe.astype(np.float32), fmt="%.9g")

    t_nn, _ = run(["nn", coords_path, fe_path])
    print(f"# ref nn:     {t_nn:.2f}s "
          f"({N * float(N) / t_nn:.3e} pairs/s)", file=sys.stderr)

    t_scr, out = run(["screen", coords_path, fe_path]
                     + [str(t) for t in THRESHOLDS])
    # effective pairs: full below-threshold prefix rescans, what the
    # reference actually performs per threshold
    order = np.argsort(fe, kind="stable")
    n_below = [int((fe[order] <= t).sum()) for t in THRESHOLDS]
    scr_pairs = float(sum(nb * float(nb) for nb in n_below))
    print(f"# ref screen: {t_scr:.2f}s x{len(THRESHOLDS)} "
          f"({scr_pairs / t_scr:.3e} pairs/s)", file=sys.stderr)

    t_mpp_ref, t_mpp_ours = bench_mpp(workdir)
    host_modes = bench_host_modes(workdir)

    total_pairs = 2 * N * float(N) + scr_pairs
    total_time = t_pops + t_nn + t_scr
    print(json.dumps({
        "metric": f"reference CPU density pipeline (N={N}, D={D},"
                  " 1 core, -O3 -ffast-math -march=native)",
        "value": round(total_pairs / total_time / 1e9, 3),
        "unit": "Gpairs/s",
        "stages": {
            "pops": round(N * float(N) / t_pops / 1e9, 3),
            "nn": round(N * float(N) / t_nn / 1e9, 3),
            "screening": round(scr_pairs / t_scr / 1e9, 3),
        },
        "seconds": {"pops": round(t_pops, 2), "nn": round(t_nn, 2),
                    "screening": round(t_scr, 2)},
        "mpp_seconds": {"reference": round(t_mpp_ref, 2),
                        "clustering_tpu": round(t_mpp_ours, 2)},
        "host_mode_seconds": host_modes,
    }))


if __name__ == "__main__":
    main()
