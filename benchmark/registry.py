"""What `BENCHMARK.json` names, found by name: a cell's configuration
(the file its entry gives) and the database generator it names
(`generators/<name>.py`), its traffic mix (`traffic/<mix>.json`) with the
record kind (`records/<kind>.py`), client loop (`loops/<kind>.py`) and
judge (`judges/<judge>.py`) the mix names, and the metrics it reports
(each a reader `metrics/<metric>.py` with a function `read(ctx)`)."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from typing import Dict, List, NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = os.path.join(ROOT, "BENCHMARK.json")
TRAFFIC = os.path.join(HERE, "traffic")
METRICS = os.path.join(HERE, "metrics")
NAME = re.compile(r"^[A-Za-z0-9_]+$")


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def cell(workload: str, bench_path: str = "", traffic_dir: str = "") -> Cell:
    bench = load_json(bench_path or BENCH)
    root = os.path.dirname(os.path.abspath(bench_path or BENCH))
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in the benchmark")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    config = load_json(os.path.join(root, cfg_entry["file"]))
    config["name"] = cfg_entry["name"]
    mix = load_json(os.path.join(traffic_dir or TRAFFIC,
                                 entry["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(workload, int(entry["chips"]), config, mix, e2e, layer)


def _load(folder: str, name: str):
    path = os.path.join(folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{os.path.basename(folder)}.{name.replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The read(ctx) of a metric's own file."""
    return _load(METRICS, metric).read


def _module(folder: str, name: str):
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return importlib.import_module(f"benchmark.{folder}.{name}")


def judge(name: str):
    return _module("judges", name)


def generator(name: str):
    """A database generator: write(fasta, config)."""
    return _module("generators", name)


def records(kind: str):
    """A record kind: make(rng, db, params) and text(names, seqs)."""
    return _module("records", kind)


def loop(kind: str):
    """A client loop: run(send, requests, deadline)."""
    return _module("loops", kind)
