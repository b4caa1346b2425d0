"""BENCHMARK.json against the benchmark's contract, and its files against
BENCHMARK.json: every configuration, cell, traffic mix and metric is a file
found by its name, and a new one is added by adding a file."""
import json
import re
import shutil
from types import SimpleNamespace

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def _reported(cell: str):
    return [m["name"] for m in SPEC["end_to_end"]
            if cell in m.get("workloads", [cell])]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32 and all(
        _line(w) and not w.startswith("/") and ".." not in w
        for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits in its 12 hours
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(c in CELLS for c in m.get("workloads", []))
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    assert len(METRICS) == len(set(METRICS))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    assert {m["name"]: m["bound"] for m in SPEC["end_to_end"]}["setup_s"] \
        <= 0.25
    for cell in CELLS:
        e2e = _reported(cell)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(SPEC, cell, trace=True)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert m["moves"] in _reported(cell), (m["name"], cell)
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_file_loads_by_name(name):
    entry = next(c for c in SPEC["configs"] if c["name"] == name)
    cfg = harness.config(name)
    assert entry["file"] == f"benchmark/configs/{name}.json"
    assert cfg["name"] == name and cfg["source"] == entry["source"]
    harness.check_config(cfg)          # the sizes the program runs


@pytest.mark.parametrize("name", CELLS)
def test_workload_and_traffic_files_load_by_name(name):
    entry = next(w for w in SPEC["workloads"] if w["name"] == name)
    cell, cfg, mx = harness.load_cell(name)
    for k in ("config", "traffic", "chips", "why"):
        assert cell[k] == entry[k]
    assert cfg["name"] == entry["config"]
    assert hasattr(harness.traffic_kind(mx["kind"]), "Traffic")
    assert cell["limits"] and all(isinstance(v, (int, float))
                                  for v in cell["limits"].values())


@pytest.mark.parametrize("name", METRICS)
def test_metric_file_declares_what_the_spec_says(name):
    entry = next(m for m in SPEC["end_to_end"] + SPEC["per_layer"]
                 if m["name"] == name)
    mod = harness.metric(name)
    assert mod.UNIT == entry["unit"] and mod.BETTER == entry["better"]
    if "layer" in entry:
        assert mod.LAYER == entry["layer"] and mod.MOVES == entry["moves"]
    assert callable(mod.read)


def test_a_file_dropped_into_a_copy_is_found_without_an_edit(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    mixture = json.loads((bench / "traffic" /
                          "volumes_bf16_b128.json").read_text())
    mixture["batch"] = 64
    (bench / "traffic" / "volumes_bf16_b64.json").write_text(
        json.dumps(mixture))
    (bench / "workloads" / "gm_base.volumes_bf16_b64.json").write_text(
        json.dumps({"config": "gm_base", "traffic": "volumes_bf16_b64",
                    "chips": 1, "why": "a cell a later change adds",
                    "limits": {"logit_gap": 0.05, "map_mismatch": 0}}))
    (bench / "metrics" / "volumes_per_s.py").write_text(
        'LAYER, UNIT, BETTER, MOVES = "Entry / serving", "volumes/s", '
        '"higher", "slices_per_s"\n\n\ndef read(ctx):\n'
        '    return ctx.record["attempted"] / ctx.record["window_s"]\n')
    cell, cfg, mx = harness.load_cell("gm_base.volumes_bf16_b64", bench)
    assert cfg["name"] == "gm_base" and mx["batch"] == 64
    assert harness.traffic_kind(mx["kind"], bench).Traffic
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({k: cell[k] for k in
                              ("name", "config", "traffic", "chips", "why")})
    for m in spec["end_to_end"]:
        if "slices_per_s" == m["name"] or "volume_ms_p90" == m["name"]:
            m["workloads"].append(cell["name"])
    spec["per_layer"].append({"name": "volumes_per_s", "unit": "volumes/s",
                              "better": "higher", "source": "device_trace",
                              "layer": "Entry / serving",
                              "moves": "slices_per_s",
                              "workloads": [cell["name"]]})
    assert "volumes_per_s" in harness.cell_metrics(spec, cell["name"], True)
    assert "slices_per_s" in harness.cell_metrics(spec, cell["name"], False)
    mod = harness.metric("volumes_per_s", bench)
    ctx = SimpleNamespace(record={"attempted": 10, "window_s": 4.0})
    assert mod.read(ctx) == 2.5
