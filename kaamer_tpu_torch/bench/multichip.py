"""The port's twin of dryrun_multichip (__graft_entry__.py:97-179): the
production sharded serving path on a (dp, shard) device grid.

It builds a small domain-skewed database in BOTH layouts -- a global
artifact and a shard-built one (index_db(n_shards), the only layout past
2^31 postings) -- and serves one query file (positions, annotations, hot
queries) through the full search pipeline on ShardedSearchEngine: grouped
phase-2 scheduler, hot-set dense matmul, run-dedup device position
bitmaps, all_to_all merge.  Both outputs must equal the single-device
SearchEngine's bytes, on the grid's first device.

  python -m kaamer_tpu_torch.bench.multichip [--dp 2] [--shards 4]
                                             [--device cuda]

On the CPU the grid repeats the one device; with --device cuda it cycles
over the cards, repeating them where the grid has more cells.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np

# the JAX dryrun's generator, drawn for 160 proteins (its 80, then 80
# more): at 2 shards every domain set of its 80 splits in halves below the
# hot-set length, and the hot path must run on every grid
N_PROTEINS = 160


def device_grid(dp: int, shards: int, devices) -> list:
    """A [dp][shard] grid filled with `devices` in order, cycling."""
    return [[devices[(i * shards + s) % len(devices)] for s in range(shards)]
            for i in range(dp)]


def dryrun_multichip(grid) -> None:
    """Serve one query file through ShardedSearchEngine on `grid` (a
    [dp][shard] list of devices) over a global and a shard-built
    artifact; raises unless both give SearchEngine's bytes."""
    from ..index.artifact import load_db
    from ..index.build import build_db
    from ..parallel.dist import Mesh, ShardedSearchEngine
    from ..search.engine import SearchEngine
    from ..search.options import PROTEIN, SearchOptions
    from ..search.pipeline import run_search

    mesh = Mesh(grid)
    n_shards = mesh.shape["shard"]
    rng = np.random.default_rng(23)
    aa = list("ACDEFGHIKLMNPQRSTVWY")
    domains = ["".join(rng.choice(aa, size=int(rng.integers(25, 60))))
               for _ in range(6)]
    seqs = []
    for _ in range(N_PROTEINS):
        parts = [d for j, d in enumerate(domains)
                 if rng.random() < 1.0 / (j + 2)]
        parts.append("".join(rng.choice(aa, size=int(rng.integers(20, 60)))))
        rng.shuffle(parts)
        seqs.append("".join(parts))

    with tempfile.TemporaryDirectory() as td:
        fasta = f"{td}/in.fasta"
        with open(fasta, "w") as f:
            for i, s in enumerate(seqs):
                f.write(f">K{i} dryrun {i}\n{s}\n")
        build_db(f"{td}/gdb", fasta, "fasta")
        build_db(f"{td}/sdb", fasta, "fasta", n_shards=n_shards)

        qf = f"{td}/q.fasta"
        with open(qf, "w") as f:
            for i in (0, 9, 33, 61):
                f.write(f">q{i}\n{seqs[i]}\n")
            f.write(">hot\n" + domains[0] + domains[1] + "\n")
            f.write(">mut\n" + seqs[5][:30] + "W" + seqs[5][31:] + "\n")
        opts = SearchOptions(File=qf, SequenceType=PROTEIN, OutFormat="tsv",
                             ExtractPositions=True, Annotations=True,
                             MaxResults=5)

        g = load_db(f"{td}/gdb")
        single = b"".join(run_search(SearchEngine(g, mesh.devices[0][0]),
                                     opts))
        if single.count(b"\n") <= 5:
            raise RuntimeError("dryrun queries produced no rows")

        eng = ShardedSearchEngine(g, mesh)
        if eng.hot_starts is None:
            raise RuntimeError("the hot dense path is not active")
        if b"".join(run_search(eng, opts)) != single:
            raise RuntimeError("sharded engine output diverged from the "
                               "single-device engine")

        s = load_db(f"{td}/sdb")
        if s.index_shards != n_shards:
            raise RuntimeError(f"shard-built artifact has {s.index_shards} "
                               f"shards, the mesh {n_shards}")
        if b"".join(run_search(ShardedSearchEngine(s, mesh), opts)) != single:
            raise RuntimeError("shard-built engine output diverged from the "
                               "single-device engine")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (every card, cycled) or one torch device")
    args = ap.parse_args()
    import torch

    if args.device == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            print("multichip: no CUDA device", file=sys.stderr)
            return 1
    else:
        devices = [torch.device(args.device)]
    grid = device_grid(args.dp, args.shards, devices)
    dryrun_multichip(grid)
    print(f"dryrun_multichip({args.dp}x{args.shards} on "
          f"{sorted({str(d) for row in grid for d in row})}) OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
