"""Every cell, configuration, traffic mix and metric of BENCHMARK.json is
found and parsed by its name, and a new one is found by adding files."""

import json
import re
from pathlib import Path

import pytest

from perfbench import harness, sizes

ROOT = Path(__file__).resolve().parents[2]
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in DOC["workloads"]]
METRICS = [m["name"] for kind in ("end_to_end", "per_layer")
           for m in DOC[kind]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.find(ROOT, cell)
    assert c.dims.n_layers == c.config["port"]["n_layers"]
    assert c.traffic["n_slots"] >= 1 and c.check["limits"]
    kinds = {m["kind"] for m in c.metrics}
    assert kinds == {"end_to_end", "per_layer"}
    assert "setup_s" in {m["name"] for m in c.metrics}


@pytest.mark.parametrize("metric", METRICS)
def test_metric_readers_load(metric):
    assert callable(harness.reader(ROOT, metric))


def test_names_units_and_paths():
    names = [c["name"] for c in DOC["configs"]] + CELLS + METRICS
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in DOC["workloads"]]:
        assert NAME.match(n), n
    for kind in ("end_to_end", "per_layer"):
        for m in DOC[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in DOC["per_layer"]:
        assert m["moves"] in {e["name"] for e in DOC["end_to_end"]}
    for c in DOC["configs"]:
        assert c["file"].startswith("perfbench/")
        cfg = sizes.load(ROOT / c["file"])
        assert list(c["reduced"]) == list(cfg["published"])
        for key in cfg.get("departures", {}):
            assert key in cfg, key
    assert len(json.dumps(DOC)) < 64 * 1024


def test_a_new_cell_is_found_from_added_files(tiny_root):
    """A later change adds a cell, a traffic mix and a metric by adding
    files and entries; nothing that exists is edited."""
    data = tiny_root / "perfbench"
    (data / "traffic" / "tiny-burst.json").write_text(
        (data / "traffic" / "tiny-chat.json").read_text())
    (data / "cells" / "tiny-burst.json").write_text(
        (data / "cells" / "tiny-chat.json").read_text())
    (data / "metrics" / "steps_seen.py").write_text(
        "def read(run):\n    return float(run.log.steps)\n")
    doc = json.loads((tiny_root / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "tiny-burst", "config": "tiny-moe",
                             "traffic": "tiny-burst", "chips": 1,
                             "why": "added"})
    doc["end_to_end"].append({"name": "steps_seen", "unit": "steps",
                              "better": "higher", "bound": 0.1,
                              "source": "host_clock",
                              "workloads": ["tiny-burst"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = harness.find(tiny_root, "tiny-burst")
    assert "steps_seen" in {m["name"] for m in cell.metrics}
    assert harness.reader(tiny_root, "steps_seen")(
        type("R", (), {"log": type("L", (), {"steps": 3})})) == 3.0
    with pytest.raises(KeyError):
        harness.find(tiny_root, "no-such-cell")
