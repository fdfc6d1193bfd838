"""The port's billing gate (``benchmarks/torch/perf_gate.py``) on the CPU.

The reference gate's fixed-seed fixtures run through ``repro_torch`` (the
kernels' plain versions here): every reachable key equals the reference's
own count in ``benchmarks/results/baseline_billing.json`` (the ``*.traces``
keys included), and every key of that file is either reachable or pending
with a queue item named.  ``compare`` fails on a count one above or one
below the baseline and on drift of the key set either way.
"""

import fnmatch
import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BASELINE = json.loads((ROOT / "benchmarks" / "results" / "baseline_billing.json").read_text())[
    "counters"
]


def _load_gate():
    spec = importlib.util.spec_from_file_location(
        "port_perf_gate", ROOT / "benchmarks" / "torch" / "perf_gate.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


gate = _load_gate()


@pytest.fixture(scope="module")
def counters():
    return gate.collect_counters("cpu")


def _reachable():
    return sorted(k for k in BASELINE if gate.pending_reason(k) is None)


def test_every_baseline_key_is_reachable_or_pending(counters):
    """127 keys: 51 reachable (the port produces exactly these) and 76
    pending, every one ``*.sharded*`` (A15), with its queue item."""
    pending = {k: gate.pending_reason(k) for k in BASELINE if gate.pending_reason(k)}
    assert len(BASELINE) == 127
    assert set(counters) == set(_reachable())
    assert set(counters) | set(pending) == set(BASELINE)
    assert not set(counters) & set(pending)
    assert (len(counters), len(pending)) == (51, 76)
    assert all(fnmatch.fnmatchcase(k, "*.sharded*") for k in pending)
    assert all("A15" in r and "queue A item" in r for r in pending.values())


@pytest.mark.parametrize("key", _reachable())
def test_reachable_key_equals_baseline(counters, key):
    assert counters[key] == BASELINE[key]


def test_traces_keys_reachable(counters):
    """Every single-device ``*.traces`` key: one program per shape, three
    for the three bucket shapes (batch and streaming grouped)."""
    traces = {k: v for k, v in counters.items() if k.endswith(".traces")}
    assert traces == {
        "both.device.traces": 1, "both.device.multikernel.traces": 1,
        "both.device.bf16mk.traces": 1, "neg_only.device.traces": 1,
        "neg_only.device.multikernel.traces": 1, "neg_only.device.bf16mk.traces": 1,
        "stream.device.mk.traces": 1, "stream.device.multikernel.traces": 1,
        "stream.device.traces": 1, "ranking.device.traces": 3,
        "ranking.stream.device.traces": 3,
    }


@pytest.mark.parametrize("delta", [1, -1])
def test_compare_fails_one_off_either_way(counters, delta):
    """Equality, not at-or-below: the baseline is the reference's count."""
    assert gate.compare(BASELINE, counters) == []
    for key in ("both.device.scores", "ranking.device.traces", "serve.lazy.models",
                "both.kernel64.scores", "stream.device.latency_sum",
                "ranking.stream.device.steps"):
        bad = dict(counters)
        bad[key] += delta
        failures = gate.compare(BASELINE, bad)
        assert len(failures) == 1 and key in failures[0]
        assert ("ABOVE" if delta > 0 else "BELOW") in failures[0]


def test_compare_fails_on_key_drift(counters):
    missing = {k: v for k, v in counters.items() if k != "both.host.stages"}
    assert any("not produced: both.host.stages" in f for f in gate.compare(BASELINE, missing))
    extra = dict(counters, **{"both.device.fused.scores": 1})
    assert any("not in the baseline" in f for f in gate.compare(BASELINE, extra))
    produced = dict(counters, **{"both.sharded2.scores": BASELINE["both.sharded2.scores"]})
    assert any("pending key produced" in f for f in gate.compare(BASELINE, produced))


def test_main_check_passes_on_cpu(capsys):
    assert gate.main(["--device", "cpu", "--check"]) == 0
    out = capsys.readouterr().out
    assert "51 reachable, 76 pending" in out and "[perf-gate] OK" in out
