"""BENCHMARK.json against the contract's shape, and every part of every
cell found by name."""
import json
import os
import re

import pytest

from fvbench import registry, roofline

BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] <= 0.25


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_found_by_name(w):
    cell = registry.find_cell(w)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(registry.reader(m["name"]))
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert callable(registry.driver(cell.traffic["driver"]))
    assert cell.chips in (1, 4)


def test_configs_files_and_cells():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(registry.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)


def test_stages_name_work_the_roofline_counts():
    st = registry.stages()
    assert {"reduce", "temporal", "expand_score", "expand_contrast", "mov_score"} <= set(st)
    for s in st.values():
        assert s["symbols"] and set(s["work"]) <= set(roofline.WORK)


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_step_names_work_the_roofline_counts(w):
    step = registry.find_cell(w).traffic["step"]
    assert step and set(step) <= set(roofline.WORK)


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path, monkeypatch):
    """A copy of the benchmark gains a cell by new files (a traffic mix as
    ``.py``, a driver, limits) and a new entry of BENCHMARK.json; the
    harness finds each by name."""
    import shutil
    bench = tmp_path / "benchmark"
    shutil.copytree(registry.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    doc = registry.load_benchmark()
    doc["workloads"].append({"name": "kadid-batch-host", "config": "kadid10k_images",
                             "traffic": "kadid_batch_host", "chips": 1, "why": "a test's cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    (bench / "traffic" / "kadid_batch_host.py").write_text(
        'TRAFFIC = {"driver": "replay", "source": "host", "step": ["luminance"]}\n')
    (bench / "drivers" / "replay.py").write_text("def run(cell, *a, **k):\n    return cell.name\n")
    (bench / "limits" / "kadid-batch-host.json").write_text('{"compared": {"jod_gap": {"limit": 1}}}')
    monkeypatch.setattr(registry, "BENCH_DIR", str(bench))
    monkeypatch.setattr(registry, "ROOT", str(tmp_path))
    cell = registry.find_cell("kadid-batch-host")
    assert cell.traffic["source"] == "host" and cell.config["name"] == "kadid10k_images"
    assert registry.driver(cell.traffic["driver"])(cell) == "kadid-batch-host"
    assert registry.find_cell("kadid-batch").traffic["driver"] == "batch"
