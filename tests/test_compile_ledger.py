"""The compile ledger must record per-program compile events and fold
them into a cost summary (cold-start accounting)."""

import json

import jax
import jax.numpy as jnp
import numpy as np

from clustering_tpu.utils import compile_ledger


def test_ledger_records_compiles_and_summarizes(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    compile_ledger.install(path)

    @jax.jit
    def _ledger_probe(x):
        return jnp.sin(x) * 2.0

    _ledger_probe(jnp.arange(8, dtype=jnp.float32)).block_until_ready()

    with open(path) as fh:
        recs = [json.loads(ln) for ln in fh if ln.strip()]
    assert recs, "no compile events recorded"
    assert any("_ledger_probe" in r["fun"] for r in recs)
    for r in recs:
        assert "compile" in r["event"]
        assert r["secs"] >= 0.0

    summary = compile_ledger.summarize(path)
    key = next(k for k in summary if "_ledger_probe" in k)
    assert summary[key]["n"] >= 1
    assert summary[key]["secs"] >= 0.0
    # sorted by total cost descending
    costs = [v["secs"] for v in summary.values()]
    assert costs == sorted(costs, reverse=True)


def test_ledger_install_idempotent(tmp_path):
    path = str(tmp_path / "ledger2.jsonl")
    compile_ledger.install(path)
    compile_ledger.install(path)  # second install must not double-log

    @jax.jit
    def _ledger_probe2(x):
        return x + np.float32(1)

    _ledger_probe2(jnp.zeros((4,), jnp.float32)).block_until_ready()
    with open(path) as fh:
        recs = [json.loads(ln) for ln in fh if ln.strip()]
    funs = [r["fun"] for r in recs if "_ledger_probe2" in r["fun"]]
    # one backend-compile event per unique program, not two
    events = [r["event"] for r in recs if "_ledger_probe2" in r["fun"]]
    assert len(events) == len(set(events)), (funs, events)
