"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files found by name, and the run length that fits the full check."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan)"
                   r"|_dim$|_rank$|experts_per_tok|selected_experts"
                   r"|size$|widening")


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_text(w) for w in cmd)
    for w in cmd[1:]:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _text(c["source"]) and _text(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
            assert k in data["reduced"] and k in data["published"]


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _text(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for p in BENCH["paths"]:
            if (ROOT / p / "traffic" / f"{w['traffic']}.json").exists():
                break
        else:
            pytest.fail(f"no traffic file for {w['traffic']}")
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def _metric_ok(m, kind):
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if kind == "end_to_end" else {"layer", "moves"})
    assert set(m) - {"workloads"} == keys, m["name"]
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


def test_end_to_end_metrics():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16
    for m in e2e:
        _metric_ok(m, "end_to_end")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in e2e)
    for w in BENCH["workloads"]:
        got = [m["name"] for m in e2e
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in got and len(got) >= 2


def test_per_layer_metrics_have_readers_and_move_a_reported_metric():
    pl = BENCH["per_layer"]
    assert 1 <= len(pl) <= 128
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in pl:
        _metric_ok(m, "per_layer")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(m["layer"]) and m["moves"] in e2e
        assert (ROOT / "perfbench" / "layers" / f"{m['name']}.py").exists()
        moved = e2e[m["moves"]]
        for c in m.get("workloads", cells):
            assert c in moved.get("workloads", cells), (m["name"], c)
        if ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["unit"] == "%"
    for c in cells:
        assert any(c in m.get("workloads", cells) for m in pl)


def test_run_seconds_fits_the_full_check():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
