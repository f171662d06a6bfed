"""kaamer-db for the torch port (kaamer_tpu/cli.py:kaamer_db_main).

  python -m kaamer_tpu_torch.cli -server -d DB [-p PORT] [-device cuda]
                                  [-shards N]
  python -m kaamer_tpu_torch.cli -make -i proteins.fasta -f fasta -d DB
                                  [-shards N]

-make builds the database with the port's index.build.build_db (the
artifact is byte for byte the JAX package's).
"""

from __future__ import annotations

import argparse
import sys


def _db_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kaamer-db (torch)")
    p.add_argument("-server", action="store_true", help="run the server")
    p.add_argument("-make", dest="make_db", action="store_true",
                   help="make database")
    p.add_argument("-p", type=int, default=8321, help="server port")
    p.add_argument("-device", default="cuda",
                   help="torch device the server runs on (cuda, cuda:1, cpu)")
    p.add_argument("-tmp", default="", help="tmp folder for query import")
    p.add_argument("-shards", type=int, default=0,
                   help="index sharding: with -server, serve from an index "
                        "sharded over N devices; with -make, BUILD a "
                        "per-shard index (required past 2^31 postings) "
                        "(0 = single-device)")
    p.add_argument("-i", default="", help="input file")
    p.add_argument("-f", default="", help="input format (fasta|tsv|embl|gbk|genbank)")
    p.add_argument("-d", default="", help="database path")
    return p


def kaamer_db_main(argv=None) -> int:
    args = _db_parser().parse_args(argv)
    if args.server:
        if not args.d:
            print("No db path !")
            return 1
        from .server.app import serve

        serve(args.d, args.p, args.device, args.tmp, n_shards=args.shards)
        return 0
    if args.make_db:
        if not args.d or not args.i or not args.f:
            print("-make needs -d, -i and -f !")
            return 1
        from .index.build import build_db

        build_db(args.d, args.i, args.f, progress=True,
                 n_shards=args.shards)
        return 0
    _db_parser().print_help()
    return 1


if __name__ == "__main__":
    sys.exit(kaamer_db_main())
