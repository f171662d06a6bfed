"""Command-line interfaces of the torch port (kaamer_tpu/cli.py).

kaamer_db_main: database lifecycle + server (reference cmd/kaamer-db/main.go)
kaamer_main:    search client               (reference cmd/kaamer/main.go)

Flag names, defaults, messages and return codes are the JAX package's,
with two differences: -device (default cuda) picks the torch device the
server runs on, and the download flags (-download and its -uniprot,
-refseq, -ncbi_nt, -kegg, -biocyc) are not ported, since every path of
the downloader fetches from the network.  Run as:

  python -m kaamer_tpu_torch.cli db -server -d DB [-p PORT] [-device cuda]
  python -m kaamer_tpu_torch.cli db -make -i in.fasta -f fasta -d DB
                                    [-offset N -length N -noindex]
  python -m kaamer_tpu_torch.cli db -merge -dbs PARTS -o DB
  python -m kaamer_tpu_torch.cli db {-index|-gc} -d DB
  python -m kaamer_tpu_torch.cli db {-backup|-restore} -d SRC -o DST
  python -m kaamer_tpu_torch.cli search -i q.fasta -t prot [-h URL]
"""

from __future__ import annotations

import argparse
import os
import sys


def _db_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kaamer-db", add_help=True)
    # programs
    p.add_argument("-server", action="store_true", help="run the server")
    p.add_argument("-make", dest="make_db", action="store_true", help="make database")
    p.add_argument("-index", action="store_true", help="index database")
    p.add_argument("-merge", action="store_true", help="merge unindexed databases")
    p.add_argument("-gc", action="store_true", help="garbage-collect database")
    p.add_argument("-backup", action="store_true", help="backup database")
    p.add_argument("-restore", action="store_true", help="restore database")
    # common options
    p.add_argument("-p", type=int, default=8321, help="server port")
    p.add_argument("-t", type=int, default=os.cpu_count(), help="number of threads")
    p.add_argument("-device", default="cuda",
                   help="torch device the server runs on (cuda, cuda:1, cpu)")
    p.add_argument("-tmp", default="/tmp/", help="tmp folder for query import")
    p.add_argument("-shards", type=int, default=0,
                   help="index sharding: with -server, serve from an index "
                        "sharded over N devices; with -make/-index, BUILD a "
                        "per-shard index (required past 2^31 postings) "
                        "(0 = single-device)")
    p.add_argument("-i", default="", help="input file")
    p.add_argument("-f", default="", help="input format (fasta|tsv|embl|gbk|genbank)")
    p.add_argument("-d", default="", help="database path")
    p.add_argument("-offset", type=int, default=0, help="start protein number")
    p.add_argument("-length", type=int, default=None, help="number of proteins to process")
    p.add_argument("-maxsize", action="store_true", help="(accepted for compatibility)")
    p.add_argument("-noindex", action="store_true", help="skip the indexing pass")
    # merge / backup / restore
    p.add_argument("-dbs", default="", help="directory of databases to merge")
    p.add_argument("-o", default="", help="output path")
    # gc
    p.add_argument("-it", type=int, default=100, help="GC iterations")
    p.add_argument("-ratio", type=float, default=0.5, help="GC ratio")
    return p


def kaamer_db_main(argv=None) -> int:
    args = _db_parser().parse_args(argv)

    if args.server:
        if not args.d:
            print("No db path !")
            return 1
        from .server.app import serve

        # -t is accepted and, as in the JAX package, unused by the server
        serve(args.d, args.p, args.device, args.tmp, n_shards=args.shards)
        return 0

    if args.make_db:
        if not args.d:
            print("No output db path !")
            return 1
        if not args.i:
            print("No input file !")
            return 1
        if not args.f:
            print("No input format (-f) !")
            return 1
        from .index.build import build_db

        build_db(args.d, args.i, args.f, offset=args.offset, length=args.length,
                 no_index=args.noindex, progress=True, n_shards=args.shards)
        return 0

    if args.index:
        if not args.d:
            print("No db path !")
            return 1
        from .index.build import index_db

        index_db(args.d, progress=True, n_shards=args.shards)
        return 0

    if args.merge:
        if not args.dbs or not args.o:
            print("Need to have a valid databases path !")
            return 1
        from .index.merge import merge_dbs

        merge_dbs(args.dbs, args.o, progress=True)
        return 0

    if args.gc:
        if not args.d:
            print("No db path !")
            return 1
        from .index.backup import gc_db

        reclaimed = gc_db(args.d, args.it, args.ratio)
        print(f"# GC done ({reclaimed} bytes reclaimed; flat-array artifacts "
              "hold no garbage)")
        return 0

    if args.backup:
        if not args.d:
            print("Need to have a valid databases path !")
            return 1
        if not args.o:
            print("Need to have a valid backup directory path !")
            return 1
        from .index.backup import backup_db

        backup_db(args.d, args.o)
        return 0

    if args.restore:
        if not args.d:
            print("Need to have a valid backup databases path !")
            return 1
        if not args.o:
            print("Need to have a valid restore directory path !")
            return 1
        from .index.backup import restore_db

        restore_db(args.d, args.o)
        return 0

    _db_parser().print_help()
    return 0


# ---------------------------------------------------------------------------
# Search client
# ---------------------------------------------------------------------------

_VALID_QUERY_TYPE = {"prot": 1, "nt": 0, "fastq": 2}
_VALID_GCODE = {1, 2, 3, 4, 5, 6, 9, 10, 11, 12, 13, 14, 15}


def _search_parser() -> argparse.ArgumentParser:
    # -h is the server host (as in the reference CLI), so argparse's built-in
    # help flag must be disabled; use --help instead.
    p = argparse.ArgumentParser(prog="kaamer", add_help=False)
    p.add_argument("--help", action="help", help="show this help")
    p.add_argument("-search", action="store_true", help="search for a query")
    p.add_argument("-h", dest="host", default="http://localhost:8321",
                   help="server host")
    p.add_argument("-t", dest="qtype", default="", help="(prot|nt|fastq) query type")
    p.add_argument("-g", dest="gcode", type=int, default=11, help="genetic code")
    p.add_argument("-i", dest="input", default="", help="input file")
    p.add_argument("-m", dest="max_results", type=int, default=10,
                   help="max number of results")
    p.add_argument("-o", dest="output", default="stdout", help="output file")
    p.add_argument("-fmt", default="tsv", help="(tsv|json) output format")
    p.add_argument("-aln", action="store_true", help="align hits")
    p.add_argument("-ann", action="store_true", help="add annotations")
    p.add_argument("-pos", action="store_true", help="add query hit positions")
    p.add_argument("-mink", type=int, default=10, help="min k-mer matches")
    p.add_argument("-minr", type=float, default=0.05, help="min k-mer match ratio")
    p.add_argument("-mat", default="blosum62", help="substitution matrix")
    p.add_argument("-gop", type=int, default=11, help="gap open penalty")
    p.add_argument("-gex", type=int, default=1, help="gap extend penalty")
    return p


def kaamer_main(argv=None) -> int:
    p = _search_parser()
    args = p.parse_args(argv)

    if not args.search:
        p.print_help()
        return 0

    if not args.input:
        print("No query intput file !")
        return 1
    if args.qtype not in _VALID_QUERY_TYPE:
        print("Invalid query type ! use prot, nt or fastq !")
        return 1
    if args.gcode not in _VALID_GCODE:
        print("Invalid genetic code !")
        return 1
    if args.fmt not in ("tsv", "json"):
        print("Invalid output format ! use tsv or json !")
        return 1
    if not (args.host.startswith("http://") or args.host.startswith("https://")):
        print("Server URL (-h) needs the http(s):// !")
        return 1

    from .ops.matrices import ALL_MATRIX_SCORES

    key = f"{args.mat.lower()}_{args.gop}_{args.gex}"
    if key not in ALL_MATRIX_SCORES:
        print("Invalid Substitution matrix and gap penalty options !")
        return 1

    # a server on this host reads the query file itself (path mode)
    host_domain = args.host.split("/")[2]
    if "localhost" in host_domain or "127.0.0.1" in host_domain:
        input_type = "path"
        input_file = os.path.abspath(args.input)
    else:
        input_type = "file"
        input_file = args.input

    from .server.client import search_request

    out = sys.stdout
    close = False
    if args.output != "stdout":
        out = open(args.output, "w")
        close = True
    try:
        search_request(
            args.host, input_file, _VALID_QUERY_TYPE[args.qtype],
            input_type=input_type, genetic_code=args.gcode, out_format=args.fmt,
            max_results=args.max_results, align=args.aln, annotations=args.ann,
            positions=args.pos, min_kmatch=args.mink, min_kratio=args.minr,
            sub_matrix=args.mat, gap_open=args.gop, gap_extend=args.gex,
            output=out,
        )
    finally:
        if close:
            out.close()
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "db":
        return kaamer_db_main(argv[1:])
    if argv and argv[0] == "search":
        return kaamer_main(["-search"] + argv[1:])
    print("usage: python -m kaamer_tpu_torch.cli {db|search} [options]")
    return 1


if __name__ == "__main__":
    sys.exit(main())
