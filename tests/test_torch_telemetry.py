"""The port's trace export, run manifests and telemetry CLI held to the
reference (``repro.telemetry.trace`` / ``manifest`` / ``__main__``).

Trace events, payloads, validation errors and digests are framework-free
and must be identical.  Manifests differ by design: the port records
torch, CUDA and the card where the reference records JAX, writes to its
own file, and each validator rejects the other's records.
"""

import json

import numpy as np
import pytest

from repro.telemetry import __main__ as ref_cli
from repro.telemetry import manifest as ref_manifest
from repro.telemetry import trace as ref_trace
from repro_torch.telemetry import __main__ as port_cli
from repro_torch.telemetry import manifest as port_manifest
from repro_torch.telemetry import trace as port_trace


def _records(seed: int, n: int = 40) -> list:
    """Lifecycle records of both shapes (Python engine: admit and
    prefill-done; batched engines: first/last only), some incomplete."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        t_arr = float(rng.uniform(0, 10))
        r = {"rid": rid, "cls": f"c{rid % 3}", "t_arr": t_arr}
        if rng.random() < 0.5:
            r["t_admit"] = t_arr + float(rng.exponential(0.5))
            if rng.random() < 0.8:
                r["t_prefill_done"] = r["t_admit"] + 0.1
        if rng.random() < 0.85:
            r["t_first"] = t_arr + float(rng.exponential(1.0))
            r["t_last"] = (r["t_first"] + float(rng.exponential(2.0))
                           if rng.random() < 0.9 else float("nan"))
        if rng.random() < 0.2:
            r["state"] = "abandoned"
        out.append(r)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_events_and_payload_identical(seed):
    recs = _records(seed)
    replans = [1.0, (2.5, {"epoch": 2, "n": 8}), (7.0, {"mixed_target": 3})]
    ev = port_trace.lifecycle_events(recs) + port_trace.replan_events(
        replans)
    want = ref_trace.lifecycle_events(recs) + ref_trace.replan_events(
        replans)
    assert ev == want
    assert (port_trace.trace_payload(ev, source="s")
            == ref_trace.trace_payload(want, source="s"))
    assert port_trace.validate_trace(port_trace.trace_payload(ev)) == []


def test_written_trace_files_have_the_reference_digest(tmp_path):
    ev = port_trace.lifecycle_events(_records(3))
    a = port_trace.write_trace(tmp_path / "port.json", ev, source="x")
    b = ref_trace.write_trace(tmp_path / "ref.json", ev, source="x")
    assert port_manifest.file_digest(a) == ref_manifest.file_digest(b)
    assert port_trace.validate_trace(a) == ref_trace.validate_trace(b) == []


@pytest.mark.parametrize("bad", [
    [],
    {"traceEvents": 3},
    {"traceEvents": [1, {"ph": "Q", "name": "a", "pid": 1, "tid": 0}]},
    {"traceEvents": [{"ph": "X", "name": "decode", "pid": 2, "tid": 0,
                      "ts": 0.0, "dur": -1.0}]},
    {"traceEvents": [{"ph": "i", "pid": 1, "ts": float("inf")}],
     "otherData": {"schema_version": 9}},
    {"traceEvents": [{"ph": "X", "name": "q", "pid": 1, "tid": 0}] * 60},
])
def test_validate_trace_errors_identical(bad):
    assert port_trace.validate_trace(bad) == ref_trace.validate_trace(bad)
    assert port_trace.validate_trace(bad)


@pytest.mark.parametrize("payload", [
    {"a": 1, "b": [1.5, 2, {"c": "x"}]},
    {"rows": [{"R": 9604.370482088512}], "manifest": {"ignored": True}},
    {"z": np.float64(0.1), "y": 3},
])
def test_payload_digest_identical(payload):
    assert (port_manifest.payload_digest(payload)
            == ref_manifest.payload_digest(payload))


def test_port_records_validate_and_reference_records_do_not(tmp_path):
    rec = port_manifest.run_record(kind="sweep", name="t", wall_s=1.5,
                                   extra={"evaluator": "lp"},
                                   artifacts={"a.json": "0" * 64},
                                   device="cpu")
    assert port_manifest.validate_record(rec) == []
    assert rec["device_name"] is None and rec["torch_version"]
    assert "jax_version" not in rec
    # neither schema accepts the other's records
    assert ref_manifest.validate_record(rec)
    ref_rec = ref_manifest.run_record(kind="sweep", name="t")
    errs = port_manifest.validate_record(ref_rec)
    assert any("jax_version" in e for e in errs)
    assert any("torch_version" in e for e in errs)
    with pytest.raises(ValueError):
        port_manifest.append_record(ref_rec, tmp_path / "m.jsonl")
    p = port_manifest.append_record(rec, tmp_path / "m.jsonl")
    port_manifest.append_record(rec, p)
    assert list(port_manifest.read_records(p)) == [rec, rec]
    assert (port_manifest.default_manifest_path(tmp_path)
            != ref_manifest.default_manifest_path(tmp_path))
    with pytest.raises(ValueError, match="kind"):
        port_manifest.run_record(kind="nope", name="t")


@pytest.mark.parametrize("bad", [
    None, {"schema_version": 2}, {"kind": 3},
])
def test_validate_record_rejects_malformed(bad):
    rec = port_manifest.run_record(kind="bench", name="t")
    if isinstance(bad, dict):
        rec.update(bad)
        assert port_manifest.validate_record(rec)
    else:
        assert port_manifest.validate_record(bad)


def test_cli_validate_and_validate_manifest(tmp_path, capsys):
    good = port_trace.write_trace(tmp_path / "t.json",
                                  port_trace.lifecycle_events(_records(4)))
    assert port_cli.main(["validate", str(good)]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "Q"}]}))
    assert port_cli.main(["validate", str(bad)]) == 1
    m = tmp_path / "m.jsonl"
    port_manifest.append_record(
        port_manifest.run_record(kind="bench", name="t"), m)
    assert port_cli.main(["validate-manifest", str(m)]) == 0
    ref_manifest.append_record(ref_manifest.run_record(kind="bench",
                                                       name="t"), m)
    assert port_cli.main(["validate-manifest", str(m)]) == 1
    assert "1/2 records INVALID" in capsys.readouterr().out


def test_cli_report_writes_the_reference_trace(tmp_path):
    """``report`` replays the Python engine on the host: its Chrome trace
    is the reference CLI's, byte for byte."""
    args = ["report", "--scenario", "rate_shift", "--n", "4",
            "--horizon", "8"]
    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    m = tmp_path / "m.jsonl"
    assert port_cli.main(args + ["--out", str(a), "--manifest",
                                 str(m)]) == 0
    assert ref_cli.main(args + ["--out", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()
    (rec,) = port_manifest.read_records(m)
    assert port_manifest.validate_record(rec) == []
    assert rec["artifacts"] == {str(a): port_manifest.file_digest(a)}


def test_derived_metrics_are_the_reference():
    from repro.telemetry import probes as ref_probes
    from repro_torch.telemetry import probes as port_probes

    assert port_probes.DERIVED_METRICS == ref_probes.DERIVED_METRICS
    assert port_probes.CTMC_PROBE_KEYS == ref_probes.CTMC_PROBE_KEYS
