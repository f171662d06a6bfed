"""On-disk database artifact: immutable flat arrays + JSON metadata.

Replaces the reference's three Badger stores (kv_stores.go:25-28) with a
directory of memory-mappable numpy arrays and string blobs:

    <db>/
      meta.json             stats (KStats), settings (KSettings), hash params
      protein_ids.npy       uint32[N]   external ids (reference-style keys)
      protein_lengths.npy   int32[N]
      entry_ids.bin/.off    concatenated utf-8 + uint64[N+1] offsets
      sequences.bin/.off
      features.bin/.off     JSON-encoded feature dict per protein
      pairs.npy             uint64[(kmer<<32)|row], sorted  (unindexed DBs)
      hash_table.npy        uint32[rows, 6] cuckoo [k0,s0,l0,k1,s1,l1]
                            (indexed DBs; see index/hashtable.py)
      set_offsets.npy       uint64[S+1]
      postings.npy          uint32[P]  dense protein rows

"Backup" of such a database is a file copy; "restore" is the reverse
(replacing backupdb.go/restoredb.go's Badger stream machinery).  Unindexed
databases keep the raw sorted (kmer,row) pairs so they can be merged
(mergedb) and indexed later, mirroring the reference's -noindex / -merge /
-index workflow (docs/database.md:78-101).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..records import KSettings, KStats, Protein

# v2: hash_table.npy switched from the two-level uint64 bucket layout to the
# uint32[rows, 6] cuckoo layout with inline (start, len) values
FORMAT_VERSION = 2
HASH_KIND = "cuckoo22"


def _write_blob(path_base: str, blobs: List[bytes]):
    offsets = np.zeros(len(blobs) + 1, dtype=np.uint64)
    sizes = np.fromiter((len(b) for b in blobs), count=len(blobs), dtype=np.uint64)
    np.cumsum(sizes, out=offsets[1:])
    with open(path_base + ".bin", "wb") as f:
        for b in blobs:
            f.write(b)
    np.save(path_base + ".off.npy", offsets)


class _BlobReader:
    def __init__(self, path_base: str, mmap: bool = True):
        self.offsets = np.load(path_base + ".off.npy")
        if mmap:
            self.data = np.memmap(path_base + ".bin", dtype=np.uint8, mode="r") \
                if os.path.getsize(path_base + ".bin") else np.empty(0, np.uint8)
        else:
            with open(path_base + ".bin", "rb") as f:
                self.data = np.frombuffer(f.read(), dtype=np.uint8)

    def __len__(self):
        return len(self.offsets) - 1

    def get(self, i: int) -> bytes:
        lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
        return bytes(self.data[lo:hi])

    def get_str(self, i: int) -> str:
        return self.get(i).decode("utf-8")


@dataclass
class DBArtifact:
    """A loaded (memory-mapped) database."""

    path: str
    stats: KStats
    settings: KSettings
    indexed: bool
    protein_ids: np.ndarray          # uint32[N] external ids
    protein_lengths: np.ndarray      # int32[N]
    _entry_ids: _BlobReader = None
    _sequences: _BlobReader = None
    _features: _BlobReader = None
    # indexed representation
    hash_table: Optional[np.ndarray] = None   # uint32[rows, 6] cuckoo
    hash_log2: int = 0
    set_offsets: Optional[np.ndarray] = None  # uint64[S+1]
    postings: Optional[np.ndarray] = None     # uint32[P]
    # sharded indexed representation (index_db n_shards > 1): per-shard
    # arrays with shard-LOCAL slice starts; the global fields above are None
    index_shards: int = 0
    shard_tables: Optional[List[np.ndarray]] = None
    shard_set_offsets: Optional[List[np.ndarray]] = None
    shard_postings: Optional[List[np.ndarray]] = None
    # unindexed representation
    pairs: Optional[np.ndarray] = None        # uint64[(kmer<<32)|row] sorted
    # external id -> dense row
    _row_of_id: dict = field(default_factory=dict, repr=False)

    @property
    def num_proteins(self) -> int:
        return len(self.protein_ids)

    def protein(self, row: int) -> Protein:
        feats = self._features.get(row)
        return Protein(
            EntryId=self._entry_ids.get_str(row),
            Sequence=self._sequences.get_str(row),
            Length=int(self.protein_lengths[row]),
            Features=json.loads(feats) if feats else {},
        )

    def entry_id(self, row: int) -> str:
        """Entry-id string alone (no feature-JSON decode): the plain-TSV
        serving path needs only this per hit, and protein() costs ~10x."""
        return self._entry_ids.get_str(row)

    def row_for_id(self, external_id: int) -> Optional[int]:
        if not self._row_of_id:
            self._row_of_id = {int(v): i for i, v in enumerate(self.protein_ids)}
        return self._row_of_id.get(int(external_id))

    def sequence(self, row: int) -> str:
        return self._sequences.get_str(row)


def write_meta(
    path: str,
    stats: KStats,
    settings: KSettings,
    indexed: bool,
    hash_log2: int = 0,
    index_shards: int = 0,
) -> None:
    meta = {
        "format_version": FORMAT_VERSION,
        "kmer_size": 7,
        "indexed": indexed,
        "stats": stats.to_json_obj(),
        "settings": settings.to_json_obj(),
        "hash": {
            "kind": HASH_KIND,
            "log2": hash_log2,
        },
    }
    if index_shards:
        # per-shard index files under <db>/shardNN/ with shard-local
        # uint32 slice starts (index/build.py index_db n_shards > 1)
        meta["index_shards"] = index_shards
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


class StreamWriter:
    """Incremental protein-column writer for out-of-core builds.

    The reference bounds build memory by streaming inserts through a
    channel into the LSM tree (kv_store.go:77-127, maxsize mode
    kv_stores.go:40-44); here the artifact's column files are append-only,
    so a build can stream millions of proteins while holding only compact
    id/length/offset arrays (array module, 16 B/protein) in memory.  The
    pair spill/merge lives in index/build.py."""

    def __init__(self, path: str):
        import array

        os.makedirs(path, exist_ok=True)
        self.path = path
        self._ids = array.array("I")
        self._lengths = array.array("i")
        self._files = {}
        self._offsets = {}
        for name in ("entry_ids", "sequences", "features"):
            self._files[name] = open(os.path.join(path, name + ".bin"), "wb")
            self._offsets[name] = array.array("Q", [0])

    def add(self, pid: int, length: int, entry_id: bytes, sequence: bytes,
            features: bytes) -> None:
        self._ids.append(pid)
        self._lengths.append(length)
        for name, blob in (("entry_ids", entry_id), ("sequences", sequence),
                           ("features", features)):
            self._files[name].write(blob)
            off = self._offsets[name]
            off.append(off[-1] + len(blob))

    @property
    def count(self) -> int:
        return len(self._ids)

    def finish(self) -> None:
        np.save(os.path.join(self.path, "protein_ids.npy"),
                np.frombuffer(self._ids, dtype=np.uint32)
                if self._ids else np.empty(0, np.uint32))
        np.save(os.path.join(self.path, "protein_lengths.npy"),
                np.frombuffer(self._lengths, dtype=np.int32)
                if self._lengths else np.empty(0, np.int32))
        for name, f in self._files.items():
            f.close()
            off = self._offsets[name]
            np.save(os.path.join(self.path, name + ".off.npy"),
                    np.frombuffer(off, dtype=np.uint64))


def save_db(
    path: str,
    stats: KStats,
    settings: KSettings,
    protein_ids: np.ndarray,
    protein_lengths: np.ndarray,
    entry_ids: List[bytes],
    sequences: List[bytes],
    features: List[bytes],
    pairs: Optional[np.ndarray] = None,
    hash_table: Optional[np.ndarray] = None,
    hash_log2: int = 0,
    set_offsets: Optional[np.ndarray] = None,
    postings: Optional[np.ndarray] = None,
):
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "protein_ids.npy"), protein_ids.astype(np.uint32))
    np.save(os.path.join(path, "protein_lengths.npy"), protein_lengths.astype(np.int32))
    _write_blob(os.path.join(path, "entry_ids"), entry_ids)
    _write_blob(os.path.join(path, "sequences"), sequences)
    _write_blob(os.path.join(path, "features"), features)

    indexed = hash_table is not None
    if indexed:
        np.save(os.path.join(path, "hash_table.npy"), hash_table)
        np.save(os.path.join(path, "set_offsets.npy"), set_offsets.astype(np.uint64, copy=False))
        np.save(os.path.join(path, "postings.npy"), postings.astype(np.uint32, copy=False))
        pairs_file = os.path.join(path, "pairs.npy")
        if os.path.exists(pairs_file):
            os.remove(pairs_file)
    else:
        np.save(os.path.join(path, "pairs.npy"), pairs.astype(np.uint64, copy=False))

    write_meta(path, stats, settings, indexed, hash_log2)


def load_db(path: str, mmap: bool = True) -> DBArtifact:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    indexed = meta["indexed"]
    mm = "r" if mmap else None

    art = DBArtifact(
        path=path,
        stats=KStats.from_json_obj(meta["stats"]),
        settings=KSettings.from_json_obj(meta["settings"]),
        indexed=indexed,
        protein_ids=np.load(os.path.join(path, "protein_ids.npy"), mmap_mode=mm),
        protein_lengths=np.load(os.path.join(path, "protein_lengths.npy"), mmap_mode=mm),
        _entry_ids=_BlobReader(os.path.join(path, "entry_ids"), mmap),
        _sequences=_BlobReader(os.path.join(path, "sequences"), mmap),
        _features=_BlobReader(os.path.join(path, "features"), mmap),
    )
    if indexed:
        if meta["hash"].get("kind") != HASH_KIND:
            raise ValueError(
                f"{path}: unsupported index format "
                f"{meta['hash'].get('kind', 'two-level-v1')!r}; rebuild the "
                f"database with makedb/indexdb (expected {HASH_KIND!r})")
        art.hash_log2 = meta["hash"]["log2"]
        art.index_shards = int(meta.get("index_shards", 0))
        if art.index_shards:
            art.shard_tables, art.shard_set_offsets, art.shard_postings = \
                [], [], []
            for s in range(art.index_shards):
                d = os.path.join(path, f"shard{s:02d}")
                art.shard_tables.append(
                    np.load(os.path.join(d, "hash_table.npy"), mmap_mode=mm))
                art.shard_set_offsets.append(
                    np.load(os.path.join(d, "set_offsets.npy"), mmap_mode=mm))
                art.shard_postings.append(
                    np.load(os.path.join(d, "postings.npy"), mmap_mode=mm))
        else:
            art.hash_table = np.load(os.path.join(path, "hash_table.npy"), mmap_mode=mm)
            art.set_offsets = np.load(os.path.join(path, "set_offsets.npy"), mmap_mode=mm)
            art.postings = np.load(os.path.join(path, "postings.npy"), mmap_mode=mm)
    else:
        art.pairs = np.load(os.path.join(path, "pairs.npy"), mmap_mode=mm)
    return art
