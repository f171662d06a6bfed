"""BENCHMARK.json holds to the benchmark's contract, and the harness finds
each configuration, traffic mix, metric reader and judge by its name."""

import json
import os
import re

import pytest

from benchmark import registry

from .conftest import BENCH, ROOT, TRAFFIC

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in [m["name"] for m in b["end_to_end"]]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_every_cell_resolves_by_name():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    used = set()
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        cell = registry.cell(w["name"])
        used.add(w["config"])
        assert cell.config["name"] == w["config"]
        assert cell.mix["route"].startswith("/api/search/")
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert registry.judge(cell.mix["judge"]["name"]).judge
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert c["file"].startswith(b["paths"][0] + "/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert callable(registry.reader(m["name"]))
        for w in m.get("workloads", ()):
            assert w in {x["name"] for x in b["workloads"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in b["end_to_end"]:
        assert callable(registry.reader(m["name"]))


def test_a_cell_reports_the_metrics_listed_for_it():
    reads = registry.cell("tiny-reads", BENCH, TRAFFIC)
    proteins = registry.cell("tiny-proteome", BENCH, TRAFFIC)
    assert "pipeline.host_share" in {m["name"] for m in reads.per_layer}
    assert "pipeline.host_share" not in {
        m["name"] for m in proteins.per_layer}
    assert reads.mix["records"]["kind"] == "reads"
    with pytest.raises(KeyError):
        registry.cell("no-such-cell", BENCH, TRAFFIC)


def test_a_new_metric_file_is_found_without_an_edit(tmp_path, monkeypatch):
    (tmp_path / "new.metric.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    monkeypatch.setattr(registry, "METRICS", str(tmp_path))
    assert registry.reader("new.metric")(None) == 7.0


@pytest.mark.parametrize("folder,find", [
    ("records", registry.records), ("loops", registry.loop),
    ("generators", registry.generator), ("judges", registry.judge)])
def test_a_new_kind_file_is_found_without_an_edit(tmp_path, monkeypatch,
                                                  folder, find):
    import importlib

    package = importlib.import_module(f"benchmark.{folder}")
    (tmp_path / "brand_new.py").write_text("MARK = 11\n")
    monkeypatch.setattr(package, "__path__",
                        list(package.__path__) + [str(tmp_path)])
    try:
        assert find("brand_new").MARK == 11
    finally:
        import sys
        sys.modules.pop(f"benchmark.{folder}.brand_new", None)
    with pytest.raises(ValueError):
        find("../run")
