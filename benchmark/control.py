"""The control of a cell's comparison: the plain reference put in the
program's place and computed in bfloat16 where the configuration states
float32 (the counts' accumulation and the k-match identity), judged
exactly as a run judges the program.  It has to come out not correct.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        --requests <per client>

For each seed it makes the requests the cell's clients would send first
(`--requests` each, as many as a run answers), takes the same judged
records, and prints one JSON line a seed with the numbers compared and
their limits.  It needs the cell's database (made as a run makes it) and
no card: the benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if not __package__:
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import database, registry  # noqa: E402
from benchmark.generate import make_request  # noqa: E402


def readings(cell, db, seed: int, n_requests: int):
    judge = registry.judge(cell.mix["judge"]["name"])
    records = []
    for c in range(int(cell.mix["loop"]["clients"])):
        for i in range(n_requests):
            req = make_request(cell.mix, db, seed, c, i)
            records.append({"ok": True, "sample": [
                {"name": req.names[j], "seq": req.seqs[j], "rows": None}
                for j in req.sample]})
    return judge.judge(db, cell.mix["route"],
                       judge.options(cell.mix.get("fields", {})), records,
                       control=True)


def main(argv=None, *, bench_path: str = "", traffic_dir: str = "",
         cache_root: str = "") -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, default=4)
    args = p.parse_args(argv)
    cell = registry.cell(args.workload, bench_path, traffic_dir)
    db = database.ensure(cell.config, cache_root,
                         log=lambda *a: print(*a, file=sys.stderr))
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = readings(cell, db, seed, args.requests)
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "requests": args.requests, "correct": correct,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
