"""The port's billing gate (``benchmarks/torch/perf_gate.py``) on the CPU.

The reference gate's fixed-seed fixtures run through ``repro_torch`` (the
kernels' plain versions here): every reachable key equals the reference's
own count in ``benchmarks/results/baseline_billing.json`` (the ``*.traces``
keys included), and every key of that file is either reachable or pending
with a queue item named.  ``compare`` fails on a count one above or one
below the baseline and on drift of the key set either way.
"""

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
    """127 keys: 40 reachable (the port produces exactly these) and 87
    pending (76 sharded, 8 of A6's, 3 of grouped streaming), each with
    its queue item."""
    pending = {k: gate.pending_reason(k) for k in BASELINE if gate.pending_reason(k)}
    assert len(BASELINE) == 127
    assert set(counters) == set(_reachable())
    assert set(counters) | set(pending) == set(BASELINE)
    assert not set(counters) & set(pending)
    assert (len(counters), len(pending)) == (40, 87)
    assert sum("A15" in r for r in pending.values()) == 76
    assert sum("A6" in r for r in pending.values()) == 8
    assert sum("A12" in r for r in pending.values()) == 3
    assert all("queue A item" in r for r in pending.values())


@pytest.mark.parametrize("key", _reachable())
def test_reachable_key_equals_baseline(counters, key):
    assert counters[key] == BASELINE[key]


def test_traces_keys_reachable(counters):
    """Every single-device ``*.traces`` key but the pending streaming
    server's: one program per shape, three for the three bucket shapes."""
    traces = {k: v for k, v in counters.items() if k.endswith(".traces")}
    assert traces == {
        "both.device.traces": 1, "both.device.multikernel.traces": 1,
        "both.device.bf16mk.traces": 1, "neg_only.device.traces": 1,
        "neg_only.device.multikernel.traces": 1, "neg_only.device.bf16mk.traces": 1,
        "stream.device.mk.traces": 1, "stream.device.multikernel.traces": 1,
        "ranking.device.traces": 3,
    }


@pytest.mark.parametrize("delta", [1, -1])
def test_compare_fails_one_off_either_way(counters, delta):
    """Equality, not at-or-below: the baseline is the reference's count."""
    assert gate.compare(BASELINE, counters) == []
    for key in ("both.device.scores", "ranking.device.traces", "serve.lazy.models"):
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
    assert "40 reachable, 87 pending" in out and "[perf-gate] OK" in out
