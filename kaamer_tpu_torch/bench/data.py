"""The skewed benchmark database and its queries (the root bench.py's
build_skewed_db, make_queries and ensure_db, copied unchanged onto the
port's own build_db and load_db): the same seed builds the same artifact,
byte for byte, so H100 runs stay comparable across PRs.  Translated
queries (FASTQ reads, nucleotide contigs) are reverse-translated with
bench.py's codon table.

Databases are domain-skewed synthetics: proteins share power-law-popular
"domains", so k-mer postings lists have the heavy-tailed family structure
real UniProt has -- the regime the reference's KComb store exists for
(kcomb_store.go:42-63).
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from ..index.artifact import load_db
from ..index.build import build_db
from ..search.orf import reverse_complement

N_QUERIES = 16_384
QUERY_LEN = 250  # uniform bucket so every batch hits one compiled shape

# Databases live inside the repo (gitignored .bench_cache/ at its root), or
# under $KAAMER_BENCH_CACHE.
CACHE_ROOT = os.environ.get(
    "KAAMER_BENCH_CACHE",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".bench_cache"))

AA = np.array(list("ACDEFGHIKLMNPQRSTVWY"))


def write_skewed_fasta(fasta: str, n_proteins: int, seed: int = 77) -> None:
    """The FASTA build_skewed_db builds from.  Domain-skewed synthetic:
    each protein concatenates 1-3 library domains (popularity ~
    1/(rank+5): the most popular domain appears in a few percent of all
    proteins) with random linkers.  Consecutive k-mers of a shared domain
    resolve to one postings set whose length scales with the domain's
    popularity -- power-law postings, shared k-mer families, cap growth,
    and host-fallback outliers all get exercised."""
    rng = np.random.default_rng(seed)
    D = max(64, n_proteins // 50)
    dom_seqs = [
        "".join(rng.choice(AA, size=int(rng.integers(30, 90))))
        for _ in range(D)
    ]
    pop = 1.0 / (np.arange(D) + 5.0)
    pop /= pop.sum()

    # vectorized draws; linkers slice a shared random pool
    n_dom = rng.integers(1, 4, size=n_proteins)
    dom_idx = rng.choice(D, size=(n_proteins, 3), p=pop)
    pool = "".join(rng.choice(AA, size=1 << 22))
    link_off = rng.integers(0, (1 << 22) - 128, size=(n_proteins, 4))
    link_len = rng.integers(8, 40, size=(n_proteins, 4))

    with open(fasta, "w") as f:
        for i in range(n_proteins):
            parts = []
            for d in range(int(n_dom[i])):
                o, l = int(link_off[i, d]), int(link_len[i, d])
                parts.append(pool[o : o + l])
                parts.append(dom_seqs[int(dom_idx[i, d])])
            o, l = int(link_off[i, 3]), int(link_len[i, 3])
            parts.append(pool[o : o + l + 20])
            f.write(f">S{i:07d} skewed\n{''.join(parts)}\n")


def build_skewed_db(path: str, n_proteins: int, seed: int = 77,
                    n_shards: int = 0) -> None:
    """The seed's skewed database (write_skewed_fasta) at path.  n_shards
    > 1 builds the same proteins as a sharded index (index_db)."""
    fasta = path + ".fasta"
    write_skewed_fasta(fasta, n_proteins, seed)
    build_db(path, fasta, "fasta", n_shards=n_shards)
    os.remove(fasta)


def make_queries(art, rng, n_queries: int = N_QUERIES) -> list:
    """Queries sampled from DB proteins with point mutations (realistic hit
    profile: high-identity matches plus background)."""
    aa = list("ACDEFGHIKLMNPQRSTVWY")
    n = art.num_proteins
    queries = []
    for _ in range(n_queries):
        row = int(rng.integers(0, n))
        seq = art.sequence(row)
        if len(seq) > QUERY_LEN:
            start = int(rng.integers(0, len(seq) - QUERY_LEN))
            seq = seq[start : start + QUERY_LEN]
        else:
            seq = (seq * (QUERY_LEN // len(seq) + 1))[:QUERY_LEN]
        s = list(seq)
        for _ in range(int(rng.integers(0, 12))):
            p = int(rng.integers(0, len(s)))
            s[p] = aa[int(rng.integers(0, 20))]
        queries.append("".join(s))
    return queries


# one codon per amino acid (table 11) for reverse-translating translated
# queries (bench.py:211-216)
_AA2CODON = {
    "A": "gct", "C": "tgt", "D": "gat", "E": "gaa", "F": "ttt", "G": "ggt",
    "H": "cat", "I": "att", "K": "aaa", "L": "ctt", "M": "atg", "N": "aat",
    "P": "cct", "Q": "caa", "R": "cgt", "S": "tct", "T": "act", "V": "gtt",
    "W": "tgg", "Y": "tat",
}


def reverse_translate(prot: str) -> str:
    return "".join(_AA2CODON.get(a, "gct") for a in prot)


def make_reads_fastq(art, rng, n_reads: int = 8_192,
                     frag_len: int = 50) -> str:
    """FASTQ reads as bench.py:bench_fastq writes them (bench.py:219-234):
    each a frag_len-residue fragment of a random database protein,
    reverse-translated and flanked by taa stops."""
    out = []
    for i in range(n_reads):
        seq = art.sequence(int(rng.integers(0, art.num_proteins)))
        start = int(rng.integers(0, max(len(seq) - frag_len, 1)))
        dna = "taa" + reverse_translate(seq[start:start + frag_len]) + "taa"
        out.append(f"@r{i}\n{dna}\n+\n{'I' * len(dna)}\n")
    return "".join(out)


def make_contigs_fasta(art, rng, n_contigs: int = 64,
                       genes: int = 4) -> str:
    """Contigs of `genes` genes each: atg, a reverse-translated
    make_queries query (QUERY_LEN residues) and a taa stop; genes 2 and 4
    of a contig sit on the minus strand, and genes are separated (and
    flanked) by 30-90 nt of random DNA."""
    prots = make_queries(art, rng, n_contigs * genes)
    out = []
    for c in range(n_contigs):
        parts = []
        for g in range(genes):
            parts.append("".join(rng.choice(list("acgt"),
                                            size=int(rng.integers(30, 91)))))
            gene = "atg" + reverse_translate(prots[c * genes + g]) + "taa"
            parts.append(reverse_complement(gene) if g % 2 else gene)
        parts.append("".join(rng.choice(list("acgt"),
                                        size=int(rng.integers(30, 91)))))
        out.append(f">contig{c} smoke contig\n{''.join(parts)}\n")
    return "".join(out)


def ensure_db(path: str, builder, *args):
    """The database at path, built by builder(path, *args) unless a
    loadable one is there already."""
    if os.path.exists(os.path.join(path, "meta.json")):
        try:
            return load_db(path)
        except ValueError:  # stale cache from an older index format
            shutil.rmtree(path, ignore_errors=True)
    builder(path, *args)
    return load_db(path)
