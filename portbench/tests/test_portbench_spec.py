"""BENCHMARK.json resolves, by name, to the files of each cell, and keeps
to its format: its keys, names, units, limits and bounds."""
import json
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert spec.BENCHMARK.stat().st_size <= 64 * 1024
    assert len(BENCH["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


ENTRY_KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"},
                   {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"},
                  {"workloads"}),
}


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_have_exactly_their_keys(section):
    required, optional = ENTRY_KEYS[section]
    assert 1 <= len(BENCH[section])
    for entry in BENCH[section]:
        assert required <= set(entry) <= required | optional, entry["name"]


def test_text_fields_fit_one_line():
    texts = [c[k] for c in BENCH["configs"] for k in ("why", "source")]
    texts += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for text in texts:
        assert 1 <= len(text) <= 200 and not re.search(r"[\n\t]", text)
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16


def test_names_units_and_lines():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] == 1


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_configs_files_and_reductions():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/configs/")
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"] == []


def test_every_cell_resolves_to_its_files(cell):
    mod = cell.op_module()
    assert hasattr(mod, "Operation")
    assert cell.end_to_end and cell.per_layer
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end + cell.per_layer:
        reader = cell.reader(m)
        assert reader.SOURCE == m["source"], m["name"]
        assert callable(reader.read)


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.resolve("no.such.cell")
