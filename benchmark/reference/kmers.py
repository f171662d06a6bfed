"""k-mer postings of a protein database, built from its FASTA residues.

Semantics of kaamer's index (makedb inputFASTA.go:245-248, indexdb.go:92-132)
and search (search.go:414-440): every sliding 7-mer of a protein maps to
the set of proteins that contain it; a query's count for a protein is the
number of the query's k-mer positions whose 7-mer the protein contains.
Proteins are numbered by their place in the FASTA, and hits rank by count,
then by that number.

The encoding here is this module's own (base 20 over the twenty standard
residues); the databases the benchmark makes hold no other letter.
"""

from __future__ import annotations

import os

import numpy as np

K = 7
AA = "ACDEFGHIKLMNPQRSTVWY"
_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(AA):
    _LUT[ord(_c)] = _i
_POW = 20 ** np.arange(K - 1, -1, -1, dtype=np.int64)

# residues a chunk of the build encodes at once
_CHUNK_RESIDUES = 1 << 24


def residue_index(ascii_bytes: np.ndarray) -> np.ndarray:
    """Residue numbers 0..19 (int64) of upper-case one-letter residues."""
    idx = _LUT[ascii_bytes]
    if idx.size and int(idx.max()) == 255:
        bad = chr(int(ascii_bytes[np.argmax(idx == 255)]))
        raise ValueError(f"residue {bad!r} is not one of {AA}")
    return idx.astype(np.int64)


def kmer_codes(idx: np.ndarray) -> np.ndarray:
    """Code of every sliding 7-mer of a residue-number array (int64)."""
    n = idx.shape[0] - K + 1
    if n <= 0:
        return np.empty(0, np.int64)
    out = idx[0:n] * _POW[0]
    for j in range(1, K):
        out += idx[j:j + n] * _POW[j]
    return out


def seq_codes(seq: str, n_kmers: int) -> np.ndarray:
    """Codes of a query's first n_kmers 7-mers."""
    raw = np.frombuffer(seq[:n_kmers + K - 1].encode("ascii"), np.uint8)
    return kmer_codes(residue_index(raw))


class Postings:
    """Sorted distinct k-mer codes, where each one's proteins start in
    `rows`, and the proteins (ascending within a code)."""

    FILES = ("codes.npy", "starts.npy", "rows.npy")

    def __init__(self, codes, starts, rows, n_proteins: int):
        self.codes = codes
        self.starts = starts
        self.rows = rows
        self.n_proteins = n_proteins

    @classmethod
    def build(cls, residues: np.ndarray, offsets: np.ndarray) -> "Postings":
        """From the database's concatenated upper-case residues (uint8)
        and each protein's offset into them (int64, n + 1)."""
        n = offsets.shape[0] - 1
        nk = np.maximum(np.diff(offsets) - (K - 1), 0)
        pairs = np.empty(int(nk.sum()), np.uint64)
        done = 0
        a = 0
        while a < n:
            b = int(np.searchsorted(offsets, offsets[a] + _CHUNK_RESIDUES,
                                    side="right"))
            b = min(max(b - 1, a + 1), n)
            base = int(offsets[a])
            codes = kmer_codes(residue_index(residues[base:offsets[b]]))
            cnt = nk[a:b]
            m = int(cnt.sum())
            first = np.repeat(offsets[a:b] - base - (np.cumsum(cnt) - cnt),
                              cnt)
            win = first + np.arange(m)
            rows = np.repeat(np.arange(a, b, dtype=np.uint64), cnt)
            pairs[done:done + m] = (codes[win].astype(np.uint64)
                                    << np.uint64(32)) | rows
            done += m
            a = b
        pairs.sort()
        if pairs.size:
            keep = np.empty(pairs.size, bool)
            keep[0] = True
            np.not_equal(pairs[1:], pairs[:-1], out=keep[1:])
            pairs = pairs[keep]
        codes = (pairs >> np.uint64(32)).astype(np.uint32)
        rows = (pairs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        del pairs
        new = np.empty(codes.size, bool)
        if codes.size:
            new[0] = True
            np.not_equal(codes[1:], codes[:-1], out=new[1:])
        first = np.flatnonzero(new)
        starts = np.append(first, codes.size).astype(np.int64)
        return cls(codes[first], starts, rows, n)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        for name, arr in zip(self.FILES, (self.codes, self.starts, self.rows)):
            np.save(os.path.join(path, name), arr)
        with open(os.path.join(path, "n_proteins.txt"), "w") as f:
            f.write(f"{self.n_proteins}\n")

    @classmethod
    def load(cls, path: str) -> "Postings":
        arrs = [np.load(os.path.join(path, name), mmap_mode="r")
                for name in cls.FILES]
        with open(os.path.join(path, "n_proteins.txt")) as f:
            n = int(f.read())
        return cls(*arrs, n)

    def slices(self, qcodes: np.ndarray):
        """(start, end) into `rows` for each query k-mer (an empty slice
        where no protein has it)."""
        # the needles in the haystack's dtype: searchsorted would otherwise
        # convert the whole haystack on every call
        qcodes = qcodes.astype(self.codes.dtype)
        i = np.searchsorted(self.codes, qcodes)
        found = i < self.codes.shape[0]
        found[found] = self.codes[i[found]] == qcodes[found]
        s = np.zeros(qcodes.shape[0], np.int64)
        e = np.zeros(qcodes.shape[0], np.int64)
        s[found] = self.starts[i[found]]
        e[found] = self.starts[i[found] + 1]
        return s, e

    def ranked_hits(self, qcodes: np.ndarray):
        """Every protein that shares a k-mer position with the query, with
        its count, by count descending, then protein ascending; and the
        query's slices, for membership tests."""
        s, e = self.slices(qcodes)
        parts = [self.rows[a:b] for a, b in zip(s.tolist(), e.tolist())
                 if b > a]
        if not parts:
            return np.empty(0, np.int64), np.empty(0, np.int64), (s, e)
        counts = np.bincount(np.concatenate(parts).astype(np.int64))
        rows = np.flatnonzero(counts)
        c = counts[rows]
        order = np.lexsort((rows, -c))
        return rows[order], c[order], (s, e)

    def contains(self, sl, position: int, rows: np.ndarray) -> np.ndarray:
        """Whether each of `rows` holds the query's k-mer at `position`."""
        seg = self.rows[sl[0][position]:sl[1][position]]
        if seg.shape[0] == 0:
            return np.zeros(rows.shape[0], bool)
        rows = rows.astype(seg.dtype)
        j = np.searchsorted(seg, rows)
        ok = j < seg.shape[0]
        ok[ok] = seg[j[ok]] == rows[ok]
        return ok

    def bitmap(self, sl, n: int, row: int) -> np.ndarray:
        """The positions 0..n-1 of the query whose k-mer `row` holds."""
        r = np.array([row], np.int64)
        return np.array([bool(self.contains(sl, p, r)[0]) for p in range(n)])
