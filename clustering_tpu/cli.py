"""CLI dispatcher: ``clustering MODE [options]``.

Mirrors the reference's boost::program_options mode tables
(src/clustering.cpp:67-526): same modes, flag names, defaults and
required/optional semantics.
"""

import argparse
import os
import sys

from . import VERSION_STRING
from .utils import io
from .utils.logger import set_verbose, logger

GENERAL_HELP = f"""
         ~~~ clustering-tpu {VERSION_STRING} ~~~

clustering-tpu: a classification framework for MD data on GPUs
(format- and semantics-compatible rebuild of moldyn/clustering v1.3.2)

modes:
  density: run density clustering
  network: build network from density clustering results
  mpp:     run MPP (Most Probable Path) clustering
           (based on density-results)
  coring:  boundary corrections for clustering results.
  noise:   defining and dynamically reassigning noise.
  filter:  filter phase space (e.g. dihedrals) for given state
  stats:   give statistics of state trajectory

usage:
  clustering MODE --option1 --option2 ...

for a list of available options per mode, run with '-h' option, e.g.
  clustering density -h

this binary is parallelized with JAX/XLA (Pallas/Triton) on NVIDIA GPUs
"""


def _add_common(p):
    p.add_argument("-n", "--nthreads", type=int, default=0,
                   help="number of host threads (caps the native text-IO"
                        " parser and BLAS pools; device compute is"
                        " controlled by the JAX runtime). 0 = auto.")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="verbose mode: print runtime information to STDOUT.")


def _add_concat(p):
    p.add_argument("--concat-nframes", dest="concat_nframes", type=int,
                   help="input (parameter): no. of frames per (equally"
                        " sized) sub-trajectory for concatenated trajectory"
                        " files.")
    p.add_argument("--concat-limits", dest="concat_limits",
                   help="input (file): file with sizes of individual (not"
                        " equally sized) sub-trajectories for concatenated"
                        " trajectory files. e.g.: for a concatenated"
                        " trajectory of three chunks of sizes 100, 50 and"
                        " 300 frames: '100 50 300'")


def build_parser():
    parser = argparse.ArgumentParser(
        prog="clustering", add_help=False,
        description=GENERAL_HELP,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="mode")

    # density
    d = sub.add_parser(
        "density",
        description="perform clustering of MD data based on phase space"
                    " densities.\ndensities are approximated by counting"
                    " neighboring frames inside\na n-dimensional hypersphere"
                    " of specified radius.\ndistances are measured with"
                    " n-dim P2-norm.",
        formatter_class=argparse.RawDescriptionHelpFormatter)
    d.add_argument("-f", "--file", required=True,
                   help="input (required): phase space coordinates (space"
                        " separated ASCII).")
    d.add_argument("-r", "--radius", type=float,
                   help="parameter: hypersphere radius. If not used, the"
                        " lumping radius will be used instead.")
    d.add_argument("-T", "--threshold-screening", dest="threshold_screening",
                   type=float, nargs="*",
                   help="parameters: screening of free energy landscape."
                        " format: FROM STEP TO; e.g.: '-T 0.1 0.1 11.1'."
                        " set -T -1 for default values: FROM=0.1, STEP=0.1,"
                        " TO=MAX_FE. parameters may be given partially."
                        " for threshold-screening, --output denotes the"
                        " basename only; output files will have the current"
                        " threshold limit appended to the given filename.")
    d.add_argument("-o", "--output",
                   help="output (optional): clustering information.")
    d.add_argument("-i", "--input",
                   help="input (optional): initial state definition.")
    d.add_argument("-R", "--radii", type=float, nargs="+",
                   help="parameter: list of radii for population/free energy"
                        " calculations (i.e. compute populations/free"
                        " energies for several radii in one go).")
    d.add_argument("-p", "--population",
                   help="output (optional): population per frame (if -R is"
                        " set: this defines only the basename).")
    d.add_argument("-d", "--free-energy", dest="free_energy",
                   help="output (optional): free energies per frame (if -R"
                        " is set: this defines only the basename).")
    d.add_argument("-D", "--free-energy-input", dest="free_energy_input",
                   help="input (optional): reuse free energy info.")
    d.add_argument("-b", "--nearest-neighbors", dest="nearest_neighbors",
                   help="output (optional): nearest neighbor info.")
    d.add_argument("-B", "--nearest-neighbors-input",
                   dest="nearest_neighbors_input",
                   help="input (optional): reuse nearest neighbor info.")
    d.add_argument("--check", action="store_true",
                   help="validation mode: run every device kernel on both"
                        " the Pallas and XLA backends and report any"
                        " disagreement (the functional-purity analog of the"
                        " reference's sanitizer builds).")
    _add_common(d)

    # mpp
    m = sub.add_parser(
        "mpp",
        description="performs a most probable path (MPP) clustering based"
                    " on the given lag time.")
    m.add_argument("-s", "--states", required=True,
                   help="(required): file with state information (i.e."
                        " clustered trajectory)")
    m.add_argument("-D", "--free-energy-input", dest="free_energy_input",
                   required=True,
                   help="input (required): reuse free energy info.")
    m.add_argument("-l", "--lagtime", type=int, required=True,
                   help="input (required): lagtime in units of frame"
                        " numbers. Note: Lagtime should be greater than the"
                        " coring time/ smallest timescale.")
    m.add_argument("--qmin-from", dest="qmin_from", type=float, default=0.01,
                   help="initial Qmin value (default: 0.01).")
    m.add_argument("--qmin-to", dest="qmin_to", type=float, default=1.0,
                   help="final Qmin value (default: 1.00).")
    m.add_argument("--qmin-step", dest="qmin_step", type=float, default=0.01,
                   help="Qmin stepping (default: 0.01).")
    _add_concat(m)
    m.add_argument("--tprob",
                   help="input (file): initial transition probability"
                        " matrix. -l still needs to be given, but will be"
                        " ignored. Format: three space-separated columns"
                        " 'state_from' 'state_to' 'probability'")
    m.add_argument("-o", "--output", default="mpp",
                   help="output (optional): basename for output files"
                        " (default: 'mpp').")
    _add_common(m)

    # network
    n = sub.add_parser("network",
                       description="create a network from screening data.")
    n.add_argument("-p", "--minpop", type=int, required=True,
                   help="(required): minimum population of node to be"
                        " considered for network.")
    n.add_argument("-b", "--basename", default="clust",
                   help="(optional): basename of input files (default:"
                        " clust).")
    n.add_argument("-o", "--output", default="network",
                   help="(optional): basename of output files (default:"
                        " network).")
    n.add_argument("--min", type=float, default=0.1,
                   help="(optional): minimum free energy (default: 0.10).")
    n.add_argument("--max", type=float, default=0.0,
                   help="(optional): maximum free energy (default: 0; i.e."
                        " max. available).")
    n.add_argument("--step", type=float, default=0.1,
                   help="(optional): free energy stepping (default: 0.10).")
    n.add_argument("--network-html", dest="network_html",
                   action="store_true",
                   help="Generate html visualization of fe tree.")
    n.add_argument("-v", "--verbose", action="store_true",
                   help="verbose mode: print runtime information to STDOUT.")

    # filter
    f = sub.add_parser(
        "filter",
        description="filter phase space (e.g. dihedral angles, cartesian"
                    " coords, etc.) for given state.")
    f.add_argument("-s", "--states", required=True,
                   help="(required): file with state information (i.e."
                        " clustered trajectory).")
    f.add_argument("-c", "--coords", required=True,
                   help="(required): file with coordinates (either plain"
                        " ASCII or GROMACS' xtc).")
    f.add_argument("-o", "--output",
                   help="basename of filtered data output (extended by e.g."
                        " basename.state5 for state 5) keeping file"
                        " extension of input. If not specified, the input"
                        " name will be used.")
    f.add_argument("-S", "--selected-states", dest="selected_states",
                   type=int, nargs="+",
                   help="state ids of selected states. Default all states.")
    f.add_argument("--every-nth", dest="every_nth", type=int, default=1,
                   help="Take only every nth frame. Default all frames.")
    f.add_argument("--nRandom", dest="n_random", type=int,
                   help="Extract n random frames for each state. The output"
                        " is sorted by indices.")
    f.add_argument("-v", "--verbose", action="store_true",
                   help="verbose mode: print runtime information to STDOUT.")

    # stats
    s = sub.add_parser(
        "stats",
        description="list statistics and population of state trajectory.")
    s.add_argument("-s", "--states", required=True,
                   help="(required): file with state information (i.e."
                        " clustered trajectory).")
    _add_concat(s)

    # coring
    c = sub.add_parser(
        "coring",
        description="compute boundary corrections for clustering results.")
    c.add_argument("-s", "--states", required=True,
                   help="(required): file with state information (i.e."
                        " clustered trajectory)")
    c.add_argument("-w", "--windows", required=True,
                   help="(required): either single integer for same window"
                        " for all states or file with window sizes. format"
                        " is space-separated lines of 'STATE_ID"
                        " WINDOW_SIZE'. use * as STATE_ID to match all"
                        " (other) states.")
    c.add_argument("-o", "--output", help="(optional): cored trajectory")
    c.add_argument("-d", "--distribution",
                   help="(optional): write waiting time distributions to"
                        " file.")
    c.add_argument("--cores",
                   help="(optional): write core information to file, i.e."
                        " trajectory with state name if in core region or"
                        " -1 if not in core region")
    _add_concat(c)
    c.add_argument("--iterative", action="store_true",
                   help="increase coring time frame by frame.")
    c.add_argument("-v", "--verbose", action="store_true",
                   help="verbose mode: print runtime information to STDOUT.")

    # noise
    x = sub.add_parser(
        "noise",
        description="defining and dynamically reassigning noise for"
                    " clustering results.")
    x.add_argument("-s", "--states", required=True,
                   help="(required): file with state information (i.e."
                        " clustered trajectory)")
    x.add_argument("-o", "--output", required=True,
                   help="(required): noise-reassigned trajectory")
    x.add_argument("-b", "--basename", default="clust",
                   help="(optional): basename of input files (default:"
                        " clust) used to determine isolated clusters")
    x.add_argument("-c", "--cmin", type=float, default=0.1,
                   help="(optional): population (in percent) threshold below"
                        " which an isolated cluster is assigned as noise."
                        " (default: 0.1).")
    x.add_argument("--cores",
                   help="(optional): write core information to file, i.e."
                        " trajectory with state name if in core region or"
                        " -1 if not in core region")
    _add_concat(x)
    x.add_argument("-v", "--verbose", action="store_true",
                   help="verbose mode: print runtime information to STDOUT.")

    return parser


# compile cache used when JAX_COMPILATION_CACHE_DIR is unset: one fixed
# directory inside the checkout (the path is part of the cache key, so a
# moving directory would never hit); listed in .gitignore
DEFAULT_COMPILE_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def _setup_jax_runtime():
    """Persistent XLA compilation cache (kernel compiles cost seconds;
    repeated CLI invocations reuse them), the optional per-program compile
    ledger and profiler trace, and optional multi-host initialization."""
    import jax
    # JAX reads JAX_COMPILATION_CACHE_DIR itself; only when it is unset
    # does the program name a directory
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    # per-program compile ledger (cold-start accounting; the reference
    # binary is AOT with zero compile cost)
    ledger = os.environ.get("CLUSTERING_TPU_COMPILE_LEDGER")
    if ledger:
        from .utils import compile_ledger
        compile_ledger.install(ledger)
    if os.environ.get("CLUSTERING_TPU_DISTRIBUTED"):
        # multi-host runs; pass the coordinator explicitly:
        #   CLUSTERING_TPU_COORDINATOR=host:port
        #   CLUSTERING_TPU_NUM_PROCESSES=N
        #   CLUSTERING_TPU_PROCESS_ID=i
        # (exercised by tests/test_distributed.py on a two-process CPU
        # cluster)
        kwargs = {}
        coord = os.environ.get("CLUSTERING_TPU_COORDINATOR")
        if coord:
            kwargs = dict(
                coordinator_address=coord,
                num_processes=int(
                    os.environ["CLUSTERING_TPU_NUM_PROCESSES"]),
                process_id=int(os.environ["CLUSTERING_TPU_PROCESS_ID"]))
        jax.distributed.initialize(**kwargs)
    profile_dir = os.environ.get("CLUSTERING_TPU_PROFILE")
    if profile_dir:
        # whole-run device trace (stage_timer scopes appear as
        # TraceAnnotations inside it); view with xprof/tensorboard
        import atexit

        import jax.profiler
        jax.profiler.start_trace(profile_dir)
        atexit.register(jax.profiler.stop_trace)


def _limit_host_threads(n):
    """Honor -n/--nthreads on the host side (reference:
    clustering.cpp:454-459 wires it to omp_set_num_threads): caps the
    native text-IO thread pool and any BLAS pools numpy has open.
    Device (GPU) compute is unaffected — the JAX runtime owns it."""
    os.environ.setdefault("OMP_NUM_THREADS", str(n))
    os.environ.setdefault("OPENBLAS_NUM_THREADS", str(n))
    from .utils import textio_native
    textio_native.set_max_threads(n)
    try:
        import threadpoolctl
        threadpoolctl.threadpool_limits(limits=n)
    except Exception:
        pass  # env vars above still cover pools opened later


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write(GENERAL_HELP)
        return 1
    parser = build_parser()
    args = parser.parse_args(argv)
    if getattr(args, "nthreads", 0) and args.nthreads > 0:
        _limit_host_threads(args.nthreads)
    if args.mode == "density":
        # the only device mode: host-side modes (mpp/coring/noise/
        # network/filter/stats) never import jax, so repeated CLI
        # invocations skip its multi-second import entirely
        _setup_jax_runtime()
    if args.mode is None:
        sys.stderr.write(GENERAL_HELP)
        return 1

    # stats forces verbose (reference: clustering.cpp:434-437)
    verbose = args.mode == "stats" or getattr(args, "verbose", False)
    set_verbose(verbose)
    logger(f"\n         ~~~ clustering-tpu {VERSION_STRING} ~~~\n"
           f"              ~ {args.mode} ~\n")
    if args.mode == "density":
        logger("~~~ using for parallization: GPU (JAX/XLA)")

    header = io.make_header(args.mode, argv=["clustering"] + argv)
    comments_map = io.default_comments_map()

    try:
        if args.mode == "density":
            from .models import density
            density.main(args, header, comments_map)
        elif args.mode == "mpp":
            from .models import mpp
            mpp.main(args, header, comments_map)
        elif args.mode == "network":
            from .models import network
            network.main(args, header, comments_map)
        elif args.mode == "coring":
            from .models import coring
            coring.main(args, header, comments_map)
        elif args.mode == "noise":
            from .models import noise
            noise.main(args, header, comments_map)
        elif args.mode == "filter":
            from .models import state_filter
            state_filter.main(args, header, comments_map, list_mode=False)
        elif args.mode == "stats":
            from .models import state_filter
            state_filter.main(args, header, comments_map, list_mode=True)
    except BrokenPipeError:
        # downstream pipe closed (e.g. `clustering stats ... | head`):
        # exit quietly like a SIGPIPE'd C binary would
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 0
    except (OSError, ValueError) as exc:
        # expected input failures exit with a concise message like the
        # reference binary (clean fail-fast, tools.hxx:233-235 etc.);
        # set CLUSTERING_TPU_DEBUG for the traceback
        if os.environ.get("CLUSTERING_TPU_DEBUG"):
            raise
        print(f"error: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
