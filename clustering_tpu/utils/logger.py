"""Verbose-gated logging.

Equivalent of the reference's ``Clustering::logger`` / global ``verbose`` flag
(reference: src/logger.hpp:40-44, src/logger.cpp:28-38): when verbose mode is
off, log output is swallowed; when on, it goes to stdout.
"""

import sys

_VERBOSE = False


def set_verbose(flag: bool) -> None:
    global _VERBOSE
    _VERBOSE = bool(flag)


def is_verbose() -> bool:
    return _VERBOSE


def logger(*parts, sep="", end="\n", file=None) -> None:
    """Print ``parts`` when verbose mode is active (else swallow)."""
    if _VERBOSE:
        print(*parts, sep=sep, end=end, file=file or sys.stdout)
        (file or sys.stdout).flush()


class stage_timer:
    """Verbose-gated wall-clock scope for pipeline stages; optionally wraps
    a jax.profiler trace annotation when JAX is profiling (the rebuild's
    answer to the reference's commented-out chrono timing points,
    density_clustering_cuda.cu:422, 585-590)."""

    def __init__(self, label):
        self.label = label

    def __enter__(self):
        import time
        self._t0 = time.perf_counter()
        try:
            import jax.profiler
            self._trace = jax.profiler.TraceAnnotation(self.label)
            self._trace.__enter__()
        except Exception:
            self._trace = None
        return self

    def __exit__(self, *exc):
        import time
        if self._trace is not None:
            self._trace.__exit__(*exc)
        logger("    [%s: %.3fs]" % (self.label,
                                    time.perf_counter() - self._t0))
        return False


def log_warm_failure(what, exc) -> None:
    """Report a failed background compile warm under verbose mode. A warm
    that fails only delays a compile, so it never raises; the message
    (prefixed "warm failed") is what chip_smoke.py checks for."""
    logger(f"    [{what}: warm failed: {type(exc).__name__}: {exc}]")
