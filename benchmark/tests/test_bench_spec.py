"""BENCHMARK.json against the contract's shape, and every cell's files
found by name; a new cell and a new metric need only new files."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import cells, trace

SPEC = cells.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and _line(c["source"])
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        names.append(w["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = cells.find(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert callable(cells.reader(m["name"]))
    assert callable(cells.control(cell.control))
    assert cell.traffic["kind"] in ("encode", "decode")
    assert 1 <= cell.quality <= 23


def test_each_config_used_and_its_file_names_it():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        with open(cells.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_missing_cell_names_what_is_there():
    with pytest.raises(KeyError, match="q8.enc.scans"):
        cells.find("no.such.cell")


def test_new_cell_and_metric_are_only_new_files(tmp_path):
    """A checkout with one more traffic file, one more metric reader and
    their entries in BENCHMARK.json: found with no code changed."""
    shutil.copytree(cells.BENCH_DIR / "configs", tmp_path / "benchmark"
                    / "configs")
    shutil.copytree(cells.BENCH_DIR / "traffic", tmp_path / "benchmark"
                    / "traffic")
    (tmp_path / "benchmark" / "metrics").mkdir()
    traffic = json.loads((cells.BENCH_DIR / "traffic" / "enc.scans.json")
                         .read_text())
    traffic["images_per_request"] = 64
    (tmp_path / "benchmark" / "traffic" / "enc.scans.b64.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark" / "metrics" / "images.enc.py").write_text(
        "def read(sl):\n    return sl.images or None\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "q20.enc.scans.b64", "config":
                              "nhw_q20", "traffic": "enc.scans.b64",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "images.enc", "unit": "images",
                              "better": "higher", "source": "program_counter",
                              "layer": "encode front", "moves":
                              "enc_mpix_per_s",
                              "workloads": ["q20.enc.scans.b64"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and m["name"].startswith("enc_"):
            m["workloads"].append("q20.enc.scans.b64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cells.find("q20.enc.scans.b64", root=tmp_path)
    assert cell.quality == 20 and cell.traffic["images_per_request"] == 64
    assert [m["name"] for m in cell.per_layer] == ["images.enc"]
    sl = trace.Slice([], 0.0, 1.0, 64, 1, 20, [])
    assert cells.reader("images.enc", root=tmp_path)(sl) == 64
