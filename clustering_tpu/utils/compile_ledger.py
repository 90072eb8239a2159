"""Per-program compile-time ledger (cold-start accounting).

The reference is an AOT binary with zero compile cost
(src/clustering.cpp:67); here every distinct XLA program costs compile
time on a cold start (unless the persistent compile cache holds it), and
the cold-start work
(threaded prefetch, small-N shape buckets) needs per-program evidence to
steer it. ``install(path)`` registers a jax.monitoring listener that
appends one JSON line per compile/trace/lowering event::

    {"t": <unix>, "event": "/jax/core/compile", "fun": "jit__pops", "secs": 3.1}

Enable with ``CLUSTERING_TPU_COMPILE_LEDGER=/path/ledger.jsonl`` (the CLI
wires it in _setup_jax_runtime); ``summarize(path)`` folds the lines into
{fun: {"n": count, "secs": total}} sorted by cost for cold-start
reports.
"""

import json
import os
import threading
import time

_lock = threading.Lock()
# single module-level listener writing to a mutable current-path slot:
# jax.monitoring has no unregister, so one listener per install(path)
# would leave stale listeners appending to old ledger files when a
# library caller re-installs with a new path in the same process
_current_path = [None]
_registered = False


def install(path):
    """Route every compile-ish monitoring event to ``path`` (JSONL).
    Re-installing with a new path redirects the single process-wide
    listener; never raises (best-effort accounting)."""
    global _registered
    with _lock:
        _current_path[0] = path
        if _registered:
            return
        try:
            import jax.monitoring as monitoring
        except Exception:  # pragma: no cover - jax always present
            return

        def _listener(event, duration, **kwargs):
            # events without a fun_name (GC, misc runtime) aren't programs
            fun = kwargs.get("fun_name")
            if fun is None or "compile" not in event:
                return
            line = json.dumps({"t": round(time.time(), 3), "event": event,
                               "fun": str(fun), "secs": round(duration, 4)})
            try:
                with _lock:
                    dst = _current_path[0]
                    if dst is None:
                        return
                    with open(dst, "a") as fh:
                        fh.write(line + "\n")
            except OSError:  # pragma: no cover
                pass

        monitoring.register_event_duration_secs_listener(_listener)
        _registered = True


def append_event(path, name, secs):
    """Append one synthetic event line (e.g. the first-device-op wall,
    which is an execution, not a compile, and so never reaches the
    monitoring listener). Never raises."""
    line = json.dumps({"t": round(time.time(), 3), "event": name,
                       "fun": name, "secs": round(secs, 4)})
    try:
        with _lock, open(path, "a") as fh:
            fh.write(line + "\n")
    except OSError:  # pragma: no cover
        pass


def summarize(path, top=None):
    """Fold a ledger file into {fun: {n, secs}} sorted by total secs."""
    agg = {}
    with open(path) as fh:
        for raw in fh:
            raw = raw.strip()
            if not raw:
                continue
            rec = json.loads(raw)
            ent = agg.setdefault(rec["fun"], {"n": 0, "secs": 0.0})
            ent["n"] += 1
            ent["secs"] = round(ent["secs"] + rec["secs"], 4)
    items = sorted(agg.items(), key=lambda kv: -kv[1]["secs"])
    if top is not None:
        items = items[:top]
    return dict(items)
