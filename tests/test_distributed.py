"""Multi-host (DCN) path: a real two-process jax.distributed CPU cluster
must initialize through the CLI's CLUSTERING_TPU_DISTRIBUTED hook and
produce bit-identical results to a single process.

The reference's multi-node story is the MPI backend
(/root/reference/src/density_clustering_mpi.cpp:392-505, rank
decomposition + gather/Bcast at :155-181, 247-292); here the SAME
shard_map program spans processes -- the mesh simply includes other
hosts' devices and the psum/pmin/all_gather collectives ride DCN.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
import numpy as np

# 4 local CPU devices per process BEFORE jax initializes
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")

# the CLI's distributed hook (CLUSTERING_TPU_DISTRIBUTED=1 + coordinator
# env vars are set by the parent test)
from clustering_tpu import cli
cli._setup_jax_runtime()

assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()
assert len(jax.local_devices()) == 4

from clustering_tpu import ops, parallel
from clustering_tpu.models import density as density_model
from clustering_tpu.ops import neighbors as nbr
from clustering_tpu.ops.screening import ThresholdSeriesScreener

mesh = parallel.make_mesh()  # spans both processes

rng = np.random.default_rng(21)
coords = np.concatenate([
    rng.normal((0.0, 0.0), 0.15, size=(90, 2)),
    rng.normal((1.5, 0.4), 0.2, size=(70, 2)),
]).astype(np.float32)

pops = parallel.sharded.populations(coords, [0.3, 0.6], mesh,
                                    row_block=8, col_block=16)
fe = ops.free_energies(pops[0.6])
nn = parallel.sharded.nearest_neighbors(coords, fe, mesh,
                                        row_block=8, col_block=16)
max_dist2 = np.float32(4.0 * nbr.compute_sigma2(nn[1]))
order = density_model.sorted_fe_order(fe)
labels0 = np.arange(len(coords), dtype=np.int32)
labels = parallel.sharded.screening_labels(
    coords[order], labels0, n_below=120, max_dist2=float(max_dist2),
    mesh=mesh, row_block=8, col_block=16)
series = ThresholdSeriesScreener(coords, fe,
                                 [np.float32(0.4), np.float32(0.9)],
                                 row_block=8, col_block=16,
                                 backend="xla", mesh=mesh)
# drive via step_submit (what the CLI does): the worker-thread postlude
# must stay multi-process safe -- its fetch reads a local replicated
# shard and never launches a collective out of order
from concurrent.futures import ThreadPoolExecutor
with ThreadPoolExecutor(max_workers=2) as pool:
    futs = [series.step_submit(k, max_dist2, pool) for k in range(2)]
    clusterings = [f.result() for f in futs]

np.savez(sys.argv[1], pops3=pops[0.3], pops6=pops[0.6],
         nh=nn[0], nhd=nn[1], hd=nn[2], hdd=nn[3], labels=labels,
         clust0=clusterings[0], clust1=clusterings[1])
print("WORKER_OK", jax.process_index())
"""


_CLI_WORKER = r"""
import contextlib, os, sys

# 4 local CPU devices per process BEFORE jax initializes (the parent
# sets the CLUSTERING_TPU_DISTRIBUTED/COORDINATOR env for the 2-process
# cluster; the single-process reference run gets 8 devices instead so
# the global mesh is identical)
os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count="
    + os.environ.get("CLI_WORKER_LOCAL_DEVICES", "4") + " "
    + os.environ.get("XLA_FLAGS", ""))
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

workdir = sys.argv[1]
os.chdir(workdir)

rng = np.random.default_rng(21)
coords = np.concatenate([
    rng.normal((0.0, 0.0), 0.15, size=(90, 2)),
    rng.normal((1.5, 0.4), 0.2, size=(70, 2)),
]).astype(np.float32)
np.savetxt("coords.dat", coords, fmt="%.6f")

from clustering_tpu import cli

# the density mode is the full device pipeline: pops + fe + nn + the
# -T screening series, through cli.main exactly as a user runs it (the
# distributed init happens inside via _setup_jax_runtime)
rc = cli.main(["density", "-f", "coords.dat", "-r", "0.3",
               "-p", "pop.dat", "-d", "fe.dat", "-b", "nn.dat",
               "-o", "clust", "-T", "0.4", "0.4", "1.2"])
assert rc == 0, "density failed"
import jax
assert jax.process_count() == int(
    os.environ.get("CLI_WORKER_WANT_PROCS", "2")), jax.process_count()
assert jax.device_count() == 8, jax.device_count()

# chain every host mode off the density artifacts (they never import
# jax; under DCN every rank computes the identical files)
states = np.loadtxt("clust.1.20", dtype=np.int64, comments="#")
vals, cnt = np.unique(states[states > 0], return_counts=True)
sel = str(int(vals[np.argmax(cnt)]))
runs = [
    ["network", "-p", "1", "-b", "clust", "-o", "net",
     "--min", "0.4", "--max", "1.2", "--step", "0.4"],
    ["mpp", "-s", "clust.1.20", "-D", "fe.dat", "-l", "2",
     "--qmin-from", "0.2", "--qmin-step", "0.2", "-o", "mpp"],
    ["coring", "-s", "clust.1.20", "-w", "2", "-o", "cored.dat",
     "-d", "cordist"],
    ["noise", "-s", "clust.1.20", "-o", "noise.dat", "-b", "clust",
     "-c", "0.2"],
    ["filter", "-s", "clust.1.20", "-c", "coords.dat", "-o", "filt",
     "-S", sel],
    ["stats", "-s", "clust.1.20"],
]
for argv in runs:
    out = "stats.out" if argv[0] == "stats" else os.devnull
    with open(out, "w") as fh, contextlib.redirect_stdout(fh):
        rc = cli.main(argv)
    assert rc == 0, argv
print("CLI_WORKER_OK", jax.process_index())
"""


def _artifact_lines(path):
    """File lines minus the volatile '# Created <timestamp>' header."""
    with open(path, "rb") as fh:
        return [ln for ln in fh.read().splitlines()
                if not ln.startswith(b"# Created ")]


def test_cli_seven_modes_two_process_dcn(tmp_path):
    """The full seven-mode CLI runs end-to-end under
    a two-process jax.distributed cluster (density's mesh spans both
    hosts; host modes chain off its artifacts) and every artifact file
    is identical to a single-process run.

    Reference: the multi-node entry there is the full mode driver
    (/root/reference/src/density_clustering_mpi.cpp:392-505), not a
    bare ops call -- this is the same property for cli.main.
    """
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "cli_worker.py"
    worker.write_text(_CLI_WORKER)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dirs = [tmp_path / f"rank{pid}" for pid in range(2)]
    procs = []
    for pid, wdir in enumerate(dirs):
        wdir.mkdir()
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env.update({
            "PYTHONPATH": repo_root + os.pathsep + env.get("PYTHONPATH", ""),
            "CLUSTERING_TPU_DISTRIBUTED": "1",
            "CLUSTERING_TPU_COORDINATOR": f"localhost:{port}",
            "CLUSTERING_TPU_NUM_PROCESSES": "2",
            "CLUSTERING_TPU_PROCESS_ID": str(pid),
            "JAX_PLATFORMS": "cpu",
        })
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(wdir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, cwd=repo_root))
    for p in procs:
        try:
            out, err = p.communicate(timeout=480)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            pytest.fail(f"CLI distributed worker timed out\n{out}\n{err}")
        assert p.returncode == 0, f"worker rc={p.returncode}:\n{out}\n{err}"
        assert "CLI_WORKER_OK" in out

    # single-process reference: same worker, no distributed env, 8 local
    # devices (the identical global mesh)
    single = tmp_path / "single"
    single.mkdir()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update({
        "PYTHONPATH": repo_root + os.pathsep + env.get("PYTHONPATH", ""),
        "CLI_WORKER_LOCAL_DEVICES": "8",
        "CLI_WORKER_WANT_PROCS": "1",
        "JAX_PLATFORMS": "cpu",
    })
    env.pop("CLUSTERING_TPU_DISTRIBUTED", None)
    p = subprocess.Popen([sys.executable, str(worker), str(single)],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, cwd=repo_root)
    out, err = p.communicate(timeout=480)
    assert p.returncode == 0, f"single-process rc={p.returncode}:\n{out}\n{err}"

    names = sorted(f.name for f in single.iterdir())
    # every mode must have produced something: density (pop/fe/nn/clust),
    # network, mpp, coring, noise, filter, stats
    for must in ("pop.dat", "fe.dat", "nn.dat", "clust.0.40", "clust.1.20",
                 "net_links.dat", "cored.dat", "noise.dat", "stats.out"):
        assert any(n.startswith(must) for n in names), (must, names)
    assert any(n.startswith("mpp") for n in names), names
    assert any(n.startswith("filt") for n in names), names
    for wdir in dirs:
        got = sorted(f.name for f in wdir.iterdir())
        assert got == names, (got, names)
        for name in names:
            assert _artifact_lines(wdir / name) == _artifact_lines(
                single / name), f"rank file {name} differs"


def test_two_process_dcn_matches_single_process(tmp_path):
    # hang protection is in-test: communicate(timeout=480) kills the
    # workers on expiry (pytest-timeout is not installed in this image)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        repo_root = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))
        env.update({
            "PYTHONPATH": repo_root + os.pathsep
            + env.get("PYTHONPATH", ""),
            "CLUSTERING_TPU_DISTRIBUTED": "1",
            "CLUSTERING_TPU_COORDINATOR": f"localhost:{port}",
            "CLUSTERING_TPU_NUM_PROCESSES": "2",
            "CLUSTERING_TPU_PROCESS_ID": str(pid),
            "JAX_PLATFORMS": "cpu",
        })
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(tmp_path / f"out{pid}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=480)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            pytest.fail(f"distributed worker timed out\n{out}\n{err}")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out}\n{err}"
        assert "WORKER_OK" in out

    # single-process reference on the in-process 8-device mesh
    from clustering_tpu import ops, parallel
    from clustering_tpu.models import density as density_model
    from clustering_tpu.ops import neighbors as nbr
    from clustering_tpu.ops.screening import ThresholdSeriesScreener
    mesh = parallel.make_mesh()
    rng = np.random.default_rng(21)
    coords = np.concatenate([
        rng.normal((0.0, 0.0), 0.15, size=(90, 2)),
        rng.normal((1.5, 0.4), 0.2, size=(70, 2)),
    ]).astype(np.float32)
    pops = parallel.sharded.populations(coords, [0.3, 0.6], mesh,
                                        row_block=8, col_block=16)
    fe = ops.free_energies(pops[0.6])
    nn = parallel.sharded.nearest_neighbors(coords, fe, mesh,
                                            row_block=8, col_block=16)
    max_dist2 = np.float32(4.0 * nbr.compute_sigma2(nn[1]))
    order = density_model.sorted_fe_order(fe)
    labels0 = np.arange(len(coords), dtype=np.int32)
    labels = parallel.sharded.screening_labels(
        coords[order], labels0, n_below=120, max_dist2=float(max_dist2),
        mesh=mesh, row_block=8, col_block=16)
    series = ThresholdSeriesScreener(coords, fe,
                                     [np.float32(0.4), np.float32(0.9)],
                                     row_block=8, col_block=16,
                                     backend="xla", mesh=mesh)
    c = None
    clusterings = []
    for k in range(2):
        c = series.step(c, k, max_dist2)
        clusterings.append(c)
    want = {"pops3": pops[0.3], "pops6": pops[0.6], "nh": nn[0],
            "nhd": nn[1], "hd": nn[2], "hdd": nn[3], "labels": labels,
            "clust0": clusterings[0], "clust1": clusterings[1]}
    for pid in range(2):
        got = np.load(tmp_path / f"out{pid}.npz")
        for key, val in want.items():
            np.testing.assert_array_equal(
                got[key], val, err_msg=f"process {pid}, field {key}")
