"""Smoke run of ``clustering density`` on an NVIDIA GPU.

Drives the density mode's main path once through the CLI at a size users
run -- 2^20 frames, D = 4, the HP35-like metastable walk of bench.py
written as an ASCII coords file, radii 0.10 / 0.15 / 0.20 and a
4-threshold screening series -- then checks every Triton sweep against
the plain XLA path on the same card, runs the device-planner phase at
2^22 frames, chains the host modes on the outputs and prints per-stage
kernel-vs-XLA timings. Every time is printed beside the card's name and
power limit. The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage:
    python chip_smoke.py          # one GPU (pins device 0)
    python chip_smoke.py --four   # density on a 4-GPU mesh at 2^22 frames
                                  # vs the single-GPU engine, and nothing
                                  # else

It exits non-zero without a result line when JAX finds no GPU or when
any phase fails. One process drives every card: a second JAX process on
a card would fail for want of memory.
"""

import argparse
import contextlib
import fractions
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
RADII = [0.10, 0.15, 0.20]
FE_RADIUS = 0.10
T_SERIES = ["0.5", "0.5", "2.0"]  # -T FROM STEP TO: 0.5, 1.0, 1.5, 2.0
THRESHOLDS = [0.5, 1.0, 1.5, 2.0]


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


class Tee(io.TextIOBase):
    """stdout wrapper that keeps a copy of everything printed, so each
    phase can be checked for failed background warms."""

    def __init__(self, stream):
        self.stream = stream
        self.buf = io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()

    def mark(self):
        return self.buf.tell()

    def since(self, pos):
        return self.buf.getvalue()[pos:]


def card_label():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


# -- the population tie rule (docs/PARITY.md) --------------------------------

def f32_round(q):
    """The float32 nearest to the non-negative rational ``q`` (ties to
    even), computed exactly."""
    import numpy as np
    if q == 0:
        return np.float32(0.0)
    e = q.numerator.bit_length() - q.denominator.bit_length()
    if fractions.Fraction(2) ** e > q:
        e -= 1
    e = max(e, -126)  # 2^e <= q < 2^(e+1), or the subnormal range
    m = q * fractions.Fraction(2) ** (23 - e)
    n, rem = divmod(m.numerator, m.denominator)
    if 2 * rem > m.denominator or (2 * rem == m.denominator and n & 1):
        n += 1
    return np.float32(math.ldexp(n, e - 23))


def d2_fma(diff):
    """Squared distance of one pair accumulated as ``acc + diff * diff``
    in ascending dimension order with each step one fused multiply-add
    (a single rounding), evaluated exactly. ``diff``: (D,) float32."""
    acc = fractions.Fraction(0)
    for dk in diff.tolist():
        acc = fractions.Fraction(float(f32_round(
            fractions.Fraction(dk) ** 2 + acc)))
    return float(acc)


def explain_count(coords, frame, r2):
    """Per-rounding view of one frame's count at squared radius ``r2``
    over every frame of ``coords``: the count with a separate multiply
    and add per step (``unfused``), the count with one fma per step
    (``fma``), and the pairs whose squared distance lies within 1 ulp of
    r^2 under either rounding (``ties``)."""
    import numpy as np
    c32 = np.asarray(coords, np.float32)
    diff = c32 - c32[frame]
    sep = np.zeros(len(c32), np.float32)
    for k in range(c32.shape[1]):
        sep = sep + diff[:, k] * diff[:, k]
    ulp = np.spacing(r2)
    # the two roundings of a D-term sum differ by a few ulp of r^2 at
    # most near the boundary: only pairs there are evaluated exactly
    near = np.flatnonzero(np.abs(sep - r2) <= 8 * ulp)
    fma = np.asarray([d2_fma(diff[j]) for j in near], np.float32)
    unfused = int((sep <= r2).sum())
    return {"unfused": unfused,
            "fma": unfused - int((sep[near] <= r2).sum())
            + int((fma <= r2).sum()),
            "ties": int(((np.abs(sep[near] - r2) <= ulp)
                         | (np.abs(fma - r2) <= ulp)).sum())}


def pops_within_ties(coords, got, want, r, frames=None, say=print):
    """Every differing count must be an exact radius-boundary tie: the
    counts may differ by at most the frame's pairs whose squared
    distance lies within 1 ulp of r^2, under either rounding in use (one
    fma per ``acc + diff * diff`` step, or a separate multiply and add).
    ``frames`` maps entries of got/want to rows of ``coords``. Returns
    the number of differing counts; raises PhaseError otherwise."""
    import numpy as np
    got = np.asarray(got, np.int64)
    want = np.asarray(want, np.int64)
    bad = np.flatnonzero(got != want)
    say(f"    r={r}: {len(bad)} of {len(got)} counts differ")
    # a miscompiled kernel moves counts on a macroscopic fraction
    check(len(bad) <= max(len(got) // 100, 50), "too many differing"
          " counts")
    r2 = np.float32(r) * np.float32(r)
    n_ties = 0
    for i in bad:
        f = i if frames is None else frames[i]
        ex = explain_count(coords, f, r2)
        g, w = int(got[i]), int(want[i])
        check(abs(g - w) <= ex["ties"],
              f"r={r}: frame {f} counts {g} (kernel) vs {w} (reference),"
              f" not explained by boundary ties: {ex}")
        n_ties += ex["ties"]
    if len(bad):
        say(f"      each within its 1-ulp boundary ties ({n_ties} tied"
            " pairs over the differing frames)")
    return len(bad)


class Smoke:
    def __init__(self, args, tee):
        self.args = args
        self.tee = tee
        self.card = None
        self.work = os.path.join(REPO, ".smoke_work")
        self.out_dir = os.path.join(REPO, "chiprun_out")
        self.n_cli, self.n_scr, self.n_big = 1 << 20, 1 << 18, 1 << 22

    # -- helpers -----------------------------------------------------------

    def say(self, msg):
        print(msg, flush=True)

    def timed(self, label, seconds):
        self.say(f"[{self.card}] {label}: {seconds:.3f} s")

    @contextlib.contextmanager
    def phase(self, name):
        self.say(f"== phase: {name}")
        pos = self.tee.mark()
        t0 = time.perf_counter()
        yield
        # a background compile warm that failed (logged under -v) fails
        # the phase: on the card it means a program did not build
        failed = [ln for ln in self.tee.since(pos).splitlines()
                  if "warm failed" in ln]
        check(not failed, f"{name}: {failed[:3]}")
        self.timed(f"phase {name} wall", time.perf_counter() - t0)

    def cli(self, argv):
        from clustering_tpu import cli
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(self.tee):
            rc = cli.main(argv)
        dt = time.perf_counter() - t0
        check(rc == 0, f"clustering {' '.join(argv)} exited {rc}")
        return dt

    def path(self, name):
        return os.path.join(self.work, name)

    def write_coords(self, coords, name):
        from clustering_tpu.utils import io as cio, textio_native
        body = textio_native.format_g_rows(coords)
        check(body is not None, "native coords formatter unavailable")
        with open(self.path(name), "wb") as fh:
            fh.write(body)
        # the float32 values the CLI will see (6 significant digits)
        return cio.read_coords(self.path(name))

    # -- comparison rules (docs/PARITY.md) ---------------------------------

    def pops_within_ties(self, coords, got, want, r, what, frames=None):
        self.say(f"    {what}:")
        return pops_within_ties(coords, got, want, r, frames=frames,
                                say=self.say)

    def nn_exact(self, got, want, what):
        """Indices exact; distances within 1 ulp."""
        import numpy as np
        n_idx = int((np.asarray(got[0]) != np.asarray(want[0])).sum()
                    + (np.asarray(got[2]) != np.asarray(want[2])).sum())
        ulps = 0
        for a, b in ((got[1], want[1]), (got[3], want[3])):
            a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
            b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
            ulps = max(ulps, int(np.abs(a - b).max(initial=0)))
        self.say(f"    {what}: {n_idx} NN index mismatches, max distance"
                 f" difference {ulps} ulp")
        check(n_idx == 0, f"{what}: NN indices differ")
        check(ulps <= 1, f"{what}: NN distances differ by {ulps} ulp")

    def printed_nn_within_ulp(self, path, want):
        """The printed NN file against the reference: ids exact, each
        printed distance equal to the reference's printed value or to
        that of a float32 within 1 ulp of it."""
        import numpy as np
        from clustering_tpu.utils import io as cio
        got = cio.read_neighborhood(path)
        n_idx = int((got[0] != np.asarray(want[0])).sum()
                    + (got[2] != np.asarray(want[2])).sum())
        check(n_idx == 0, f"{path}: {n_idx} NN index mismatches")
        with open(path) as fh:
            rows = [ln.split() for ln in fh if not ln.startswith("#")]
        off = 0
        for col, ref in ((1, want[1]), (3, want[3])):
            ref = np.asarray(ref, np.float32)
            printed = [r[col] for r in rows]
            for k in np.flatnonzero(np.asarray(
                    ["%g" % v for v in ref.tolist()]) != np.asarray(printed)):
                near = {"%g" % float(np.nextafter(ref[k], s))
                        for s in (np.float32(-np.inf), np.float32(np.inf))}
                check(printed[k] in near,
                      f"{path}: row {k} distance {printed[k]} vs reference"
                      f" {ref[k]!r}")
                off += 1
        self.say(f"    printed NN file: ids exact, {off} printed distances"
                 " 1 ulp from the reference's, none further")

    # -- phases ------------------------------------------------------------

    def setup(self):
        native = os.path.join(REPO, "clustering_tpu", "native")
        subprocess.run(["make", "-B", "-s", "-C", native], check=True)
        from clustering_tpu.utils import textio_native, xtc_native
        tio, xtc = textio_native.available(), xtc_native.available()
        self.say(f"native libraries loaded: textio={tio} xtc_codec={xtc}")
        check(tio and xtc, "native libraries failed to load")
        import jax
        self.say(f"jax.devices(): {jax.devices()}")
        self.card = card_label()
        self.say(f"card: {self.card}")
        shutil.rmtree(self.work, ignore_errors=True)
        os.makedirs(self.work)
        os.makedirs(self.out_dir, exist_ok=True)

    def cli_phase(self):
        from bench import synthetic_fel
        coords = synthetic_fel(self.n_cli, 4, seed=self.args.seed)
        self.coords = self.write_coords(coords, "coords.dat")
        os.chdir(self.work)
        pos = self.tee.mark()
        t_a = self.cli(["density", "-f", "coords.dat", "-R",
                        *map(str, RADII), "-p", "pop", "-d", "fe", "-v"])
        self.timed(f"cli density -R (3 radii, N={self.n_cli}) cold", t_a)
        t_b = self.cli(["density", "-f", "coords.dat", "-r", str(FE_RADIUS),
                        "-p", "pop", "-d", "fe", "-b", "nn", "-o", "clust",
                        "-T", *T_SERIES, "-v"])
        self.timed(f"cli density -r {FE_RADIUS} -b -o -T (N={self.n_cli})"
                   " cold", t_b)
        log = self.tee.since(pos)
        with open(os.path.join(self.out_dir, "chip_smoke_cli.log"),
                  "w") as fh:
            fh.write(log)
        for stage, secs in re.findall(r"\[(populations|nearest neighbors|"
                                      r"screening): ([0-9.]+)s\]", log):
            self.timed(f"cli stage {stage}", float(secs))
        for ln in log.splitlines():
            if "tiles computed" in ln or "screening fixpoint" in ln:
                self.say("   " + ln.strip())
        for argv in (["network", "-p", "100", "-b", "clust", "-o", "net",
                      "--min", "0.5", "--max", "2.0", "--step", "0.5"],
                     ["mpp", "-s", "clust.2.00", "-D", "fe", "-l", "25"],
                     ["coring", "-s", "clust.2.00", "-w", "10", "-o",
                      "cored"],
                     ["noise", "-s", "clust.2.00", "-o", "noised", "-b",
                      "clust"],
                     ["stats", "-s", "clust.2.00"]):
            self.timed(f"cli {argv[0]} (host mode)", self.cli(argv))
        os.chdir(REPO)

    def reference_phase(self):
        import jax
        import numpy as np
        from clustering_tpu import ops
        from clustering_tpu.utils import io as cio

        def run(fn):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn())
            return out, time.perf_counter() - t0

        x = self.coords
        pops_x, t = run(lambda: ops.populations(x, RADII, backend="xla"))
        self.timed(f"xla populations (N={len(x)}, 3 radii)", t)
        for r in RADII:
            got = cio.read_single_column(self.path("pop_%f" % r), int)
            self.pops_within_ties(x, got, pops_x[r], r, "cli -R pops vs xla")
        pops_k = cio.read_single_column(self.path("pop"), int)
        self.pops_within_ties(x, pops_k, pops_x[FE_RADIUS], FE_RADIUS,
                              "cli -r pops vs xla")
        # the CLI's free energies follow from its own counts
        fe = ops.free_energies(pops_k)
        nn_x, t = run(lambda: ops.nearest_neighbors(x, fe, backend="xla"))
        self.timed(f"xla nearest neighbors (N={len(x)})", t)
        self.printed_nn_within_ulp(self.path("nn"), nn_x)
        self.fe, self.nn_x = fe, nn_x

    def screening_reference_phase(self):
        """Labels against the XLA fixpoint (a serial Gauss-Seidel loop over
        row blocks, the plain reference): first at n_scr frames; then, if
        that took under a minute, the CLI's own n_cli-frame state files
        against the XLA series on the same inputs."""
        import numpy as np
        from bench import synthetic_fel
        from clustering_tpu import ops
        from clustering_tpu.utils import io as cio
        th = [np.float32(t) for t in THRESHOLDS]

        def series(x, fe, nn, backend, label):
            md2 = np.float32(4.0 * ops.neighbors.compute_sigma2(nn[1]))
            kw = {"row_block": 1024} if backend == "xla" else {}
            s = ops.screening.ThresholdSeriesScreener(
                x, fe, th, backend=backend, hd_neighbors=(nn[2], nn[3]),
                **kw)
            t0 = time.perf_counter()
            c, out = None, []
            for k in range(len(th)):
                c = s.step(c, k, md2)
                out.append(c)
            dt = time.perf_counter() - t0
            self.timed(f"{backend} screening series {label} (N={len(x)},"
                       f" {len(th)} thresholds, first run)", dt)
            return out, dt

        def compare(got, want, what):
            for k in range(len(th)):
                n_bad = int((np.asarray(got[k]) != want[k]).sum())
                self.say(f"    {what} threshold {THRESHOLDS[k]}: {n_bad}"
                         " label mismatches vs the XLA fixpoint")
                check(n_bad == 0, "screening labels differ from the"
                      " reference")

        xs = synthetic_fel(self.n_scr, 4, seed=self.args.seed + 1)
        eng = ops.engine.DensityEngine(xs, backend="pallas")
        fe = ops.free_energies(eng.populations([FE_RADIUS])[FE_RADIUS])
        nn = eng.nearest_neighbors(fe)
        got, _ = series(xs, fe, nn, "pallas", "in-process")
        want, t_x = series(xs, fe, nn, "xla", "in-process")
        compare(got, want, f"N={len(xs)}")
        if t_x > 60.0:
            self.say(f"    screening reference size: {self.n_scr} frames"
                     " (the XLA fixpoint is too slow for the CLI's size)")
            return
        # the CLI's state files: same inputs as its own run (its counts,
        # its NN stage), the XLA fixpoint as the reference
        x = self.coords
        fe = ops.free_energies(cio.read_single_column(self.path("pop"), int))
        nn = ops.engine.DensityEngine(x, backend="pallas") \
            .nearest_neighbors(fe)
        want, _ = series(x, fe, nn, "xla", "vs the cli's state files")
        got = [cio.read_clustered_trajectory(self.path("clust.%0.2f" % t))
               for t in THRESHOLDS]
        compare(got, want, f"cli N={len(x)}")
        self.say(f"    screening reference size: {len(x)} frames (cli"
                 f" output) and {self.n_scr} frames")

    def ab_phase(self):
        """Per stage, the Triton path vs the plain XLA path end to end
        through the engine at n_cli (both warm); the Triton screening
        series warm (the XLA series is timed by the screening reference
        phase)."""
        import jax
        import numpy as np
        from clustering_tpu import ops
        x, fe = self.coords, self.fe

        def best(fn, reps=2):
            fn()
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(fn())
                ts.append(time.perf_counter() - t0)
            return min(ts)

        eng_k = ops.engine.DensityEngine(x, backend="pallas")
        eng_x = ops.engine.DensityEngine(x, row_block=1024, backend="xla")
        for name, fn_k, fn_x in (
                ("populations (3 radii)",
                 lambda: eng_k.populations(RADII),
                 lambda: eng_x.populations(RADII)),
                ("nearest neighbors",
                 lambda: eng_k.nearest_neighbors(fe),
                 lambda: eng_x.nearest_neighbors(fe))):
            t_k = best(fn_k)
            t_x = best(fn_x, reps=1)
            self.timed(f"A/B N={len(x)} {name}: triton (engine, warm)", t_k)
            self.timed(f"A/B N={len(x)} {name}: xla (engine, warm)", t_x)
        nn = eng_k.nearest_neighbors(fe)
        md2 = np.float32(4.0 * ops.neighbors.compute_sigma2(nn[1]))
        th = [np.float32(t) for t in THRESHOLDS]
        s = ops.screening.ThresholdSeriesScreener(
            x, fe, th, backend="pallas", hd_neighbors=(nn[2], nn[3]))

        def series():
            s.reset()
            c = None
            for k in range(len(th)):
                c = s.step(c, k, md2)
            return c
        self.timed(f"A/B N={len(x)} screening series ({len(th)}"
                   " thresholds): triton (warm)", best(series))

    def kernel_memory_phase(self):
        import jax
        import jax.numpy as jnp
        from clustering_tpu.ops import pallas_kernels as pk
        n = self.n_cli
        f32 = jax.ShapeDtypeStruct((4, n), jnp.float32)
        row = jax.ShapeDtypeStruct((1, n), jnp.float32)
        ids = jax.ShapeDtypeStruct((1, n), jnp.int32)
        lst = jax.ShapeDtypeStruct((n,), jnp.int32)
        lab = jax.ShapeDtypeStruct((n,), jnp.int32)
        r2 = jax.ShapeDtypeStruct((3,), jnp.float32)
        for name, low in (
                ("pops_sweep", pk.pops_sweep.lower(f32, f32, r2, n, lst, lst,
                                                   lst)),
                ("nn_sweep", pk.nn_sweep.lower(f32, row, f32, row, ids, n,
                                               lst, lst)),
                ("label_sweep", pk.label_sweep.lower(
                    f32, lab, n, 1.0, lst, lst))):
            self.say(f"    {name} at N={n}, D=4, list {n}:"
                     f" {low.compile().memory_analysis()}")

    def big_phase(self):
        """n_big frames, where the device planner turns on: the engine
        against the XLA reference on a row subset at full column width,
        and screening labels from the host vs the device plan."""
        import jax
        import jax.numpy as jnp
        import numpy as np
        from bench import synthetic_fel
        from clustering_tpu import ops
        from clustering_tpu.ops import density as dops
        from clustering_tpu.ops import neighbors as nops

        xb = synthetic_fel(self.n_big, 4, seed=self.args.seed + 2)
        n = len(xb)
        eng = ops.engine.DensityEngine(xb, backend="pallas")
        t0 = time.perf_counter()
        pops = eng.populations(RADII, nn_band_radius=FE_RADIUS)
        self.timed(f"triton populations N={n} (3 radii, cold)",
                   time.perf_counter() - t0)
        check(eng.last_stats["populations"].get("plan") == "device",
              f"device planner did not engage at N={n}")
        fe = ops.free_energies(pops[FE_RADIUS])
        t0 = time.perf_counter()
        nn = eng.nearest_neighbors(fe)
        self.timed(f"triton nearest neighbors N={n} (cold)",
                   time.perf_counter() - t0)
        check(eng.last_stats["nn"].get("plan") == "device",
              f"NN device planner did not engage at N={n}")
        for stage, key, fn in (
                ("populations", "populations",
                 lambda: eng.populations(RADII)),
                ("nearest neighbors", "nn",
                 lambda: eng.nearest_neighbors(fe))):
            t0 = time.perf_counter()
            fn()
            self.timed(f"A/B N={n} {stage}: triton (engine, warm)",
                       time.perf_counter() - t0)
            st = eng.last_stats[key]
            for sub in ("t_band", "t_plan", "t_sweep", "t_host"):
                if sub in st:
                    self.timed(f"    N={n} {stage} {sub}"
                               f" ({st.get('plan', 'host')} plan)", st[sub])
        # XLA reference rows: every 16th frame against all n columns
        rows = np.arange(0, n, 16)
        m = len(rows)
        xj = jnp.asarray(xb)
        radii2 = jnp.asarray([np.float32(r) * np.float32(r) for r in RADII])
        ref_pops = jax.jit(lambda a, b: dops.counts_row_range(
            a, b, radii2, jnp.int32(n), 1024, 4096))
        t0 = time.perf_counter()
        cnt = np.asarray(ref_pops(xj[rows], xj))
        t = time.perf_counter() - t0
        self.timed(f"A/B N={n} populations: xla reference on {m} rows x"
                   f" {n} columns (first run; x{n // m} rows for the full"
                   " stage)", t)
        for i, r in enumerate(RADII):
            self.pops_within_ties(xb, np.asarray(pops[r])[rows], cnt[i],
                                  r, f"N={n} pops vs xla (row subset)",
                                  frames=rows)
        fe_j = jnp.asarray(fe)
        ref_nn = jax.jit(lambda a, fa, b, fb: nops.nn_row_range(
            a, fa, b, fb, jnp.int32(n), 1024, 4096))
        t0 = time.perf_counter()
        nd, nj, hd, hj = (np.asarray(v) for v in ref_nn(
            xj[rows], fe_j[rows], xj, fe_j))
        t = time.perf_counter() - t0
        self.timed(f"A/B N={n} nearest neighbors: xla reference on {m}"
                   f" rows x {n} columns (first run; x{n // m} rows for the"
                   " full stage)", t)
        nd = np.where(np.isfinite(nd), nd, 0).astype(np.float32)
        hd = np.where(np.isfinite(hd), hd, 0).astype(np.float32)
        nj = np.where(nd > 0, nj, 0)
        hj = np.where(hd > 0, hj, 0)
        self.nn_exact([np.asarray(v)[rows] for v in nn], (nj, nd, hj, hd),
                      f"N={n} NN vs xla (row subset)")
        md2 = np.float32(4.0 * ops.neighbors.compute_sigma2(nn[1]))
        th = [np.float32(t) for t in THRESHOLDS]
        outs = {}
        for plan in ("0", "1"):
            os.environ["CLUSTERING_TPU_DEVICE_PLAN"] = plan
            try:
                s = ops.screening.ThresholdSeriesScreener(
                    xb, fe, th, backend="pallas",
                    hd_neighbors=(nn[2], nn[3]))
                t0 = time.perf_counter()
                c, outs[plan] = None, []
                for k in range(len(th)):
                    c = s.step(c, k, md2)
                    outs[plan].append(c)
                kinds = {st.get("plan") for st in s.per_step_stats}
            finally:
                del os.environ["CLUSTERING_TPU_DEVICE_PLAN"]
            self.timed(f"triton screening N={n} {'device' if plan == '1' else 'host'}"
                       f" plan ({len(th)} thresholds, first run)",
                       time.perf_counter() - t0)
            check(kinds == {"device" if plan == "1" else "host"},
                  f"screening plan kinds {kinds}")
        for k in range(len(th)):
            n_bad = int((outs["0"][k] != outs["1"][k]).sum())
            self.say(f"    N={n} threshold {THRESHOLDS[k]}: {n_bad} label"
                     " mismatches host vs device plan")
            check(n_bad == 0, "host and device plans disagree")

    def four_phase(self):
        """density on a 4-device mesh through the CLI at n_big frames,
        compared with the single-device engine in this process."""
        import jax
        import numpy as np
        from bench import synthetic_fel
        from clustering_tpu import ops
        from clustering_tpu.utils import io as cio
        check(len(jax.devices()) == 4,
              f"--four needs 4 devices, JAX sees {len(jax.devices())}")
        coords = self.write_coords(
            synthetic_fel(self.n_big, 4, seed=self.args.seed + 2),
            "coords.dat")
        os.chdir(self.work)
        pos = self.tee.mark()
        t = self.cli(["density", "-f", "coords.dat", "-r", str(FE_RADIUS),
                      "-p", "pop", "-b", "nn", "-o", "clust",
                      "-T", *T_SERIES, "-v"])
        self.timed(f"cli density on a 4-device mesh (N={len(coords)},"
                   " cold)", t)
        log = self.tee.since(pos)
        os.chdir(REPO)
        for stage, secs in re.findall(r"\[(populations|nearest neighbors|"
                                      r"screening): ([0-9.]+)s\]", log):
            self.timed(f"mesh cli stage {stage}", float(secs))
        balance = [ln.strip() for ln in log.splitlines()
                   if "per-device tiles" in ln]
        for ln in balance:
            self.say("    tile balance: " + ln)
        check(balance, "no per-device tile counts logged")
        single = ops.engine.DensityEngine(coords, backend="pallas")
        pops = single.populations([FE_RADIUS])[FE_RADIUS]
        got = cio.read_single_column(self.path("pop"), int)
        self.pops_within_ties(coords, got, pops, FE_RADIUS,
                              "mesh vs single-device pops")
        fe = ops.free_energies(got)
        nn = single.nearest_neighbors(fe)
        self.printed_nn_within_ulp(self.path("nn"), nn)
        md2 = np.float32(4.0 * ops.neighbors.compute_sigma2(nn[1]))
        s = ops.screening.ThresholdSeriesScreener(
            coords, fe, [np.float32(t) for t in THRESHOLDS],
            backend="pallas", hd_neighbors=(nn[2], nn[3]))
        c = None
        for k, t in enumerate(THRESHOLDS):
            c = s.step(c, k, md2)
            mesh_c = cio.read_clustered_trajectory(
                self.path("clust.%0.2f" % t))
            n_bad = int((mesh_c != c).sum())
            self.say(f"    threshold {t}: {n_bad} label mismatches mesh vs"
                     " single device")
            check(n_bad == 0, "mesh labels differ from the single device")

    def run(self):
        import jax
        with self.phase("setup"):
            self.setup()
        if self.args.four:
            with self.phase("four-device density vs one device"):
                self.four_phase()
        else:
            with self.phase("cli"):
                self.cli_phase()
            with self.phase("reference comparison"):
                self.reference_phase()
            with self.phase("screening reference"):
                self.screening_reference_phase()
            with self.phase("triton vs xla"):
                self.ab_phase()
            with self.phase("kernel memory"):
                self.kernel_memory_phase()
            with self.phase("device planner"):
                self.big_phase()
        stats = jax.devices()[0].memory_stats() or {}
        self.say(f"peak device memory (device 0): "
                 f"{stats.get('peak_bytes_in_use')} bytes")
        shutil.rmtree(self.work, ignore_errors=True)
        dev = jax.devices()[0]
        return {"ok": True, "device": {"platform": dev.platform,
                                       "kind": dev.device_kind,
                                       "count": len(jax.devices())}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU mesh phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not args.four:
        # the default phases run on one device (the CLI would otherwise
        # build a mesh over every visible card)
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend"
              f" {jax.default_backend()!r}); nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = Smoke(args, tee).run()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
