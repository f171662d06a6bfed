"""Merge unindexed databases (the port's copy of kaamer_tpu/index/merge.py;
reference pkg/mergedb/mergedb.go:42-135).  The merged artifact is byte
for byte the JAX package's.

The reference merges N unindexed Badger stores by streaming every key of each
DB into the first (mergedb.go:76-116) and summing KStats (91-93).  Here the
unindexed representation is already a sorted (kmer<<32|row) pair array per
DB, so a merge is: concatenate protein columns, re-base each DB's dense rows,
merge the pair arrays, and sum the stats.

The merge streams, out of core: the blob columns are copied file to file,
and the pair arrays go through the build's k-way merge
(build._kway_merge_u64), which reads each input's pairs.npy in blocks past
its header and rebases each block as it reads it.  Rebasing adds a
constant to the low 32 bits, so every rebased input stays sorted.  Memory
is bounded by the merge's blocks plus O(proteins) id and offset arrays,
where the JAX package sorts the concatenation of every input in RAM.

As in the reference, external protein ids are taken as-is: split builds are
expected to use -offset/-length so their id ranges do not collide
(docs/database.md:78-101).  Colliding external ids are reported as an error
here rather than silently overwriting records (the reference's behavior under
collision is last-write-wins in the LSM tree).
"""

from __future__ import annotations

import glob
import os
import shutil

import numpy as np

from ..records import KSettings, KStats
from . import artifact
from .build import _kway_merge_u64

# pairs held in memory per input while merging (build._kway_merge_u64)
BLOCK_ELEMS = 1 << 20

BLOBS = ("entry_ids", "sequences", "features")


def merge_dbs(dbs_path: str, out_path: str, progress: bool = False) -> None:
    paths = sorted(p for p in glob.glob(os.path.join(dbs_path, "*"))
                   if os.path.isdir(p))
    if not paths:
        raise ValueError(f"no databases found under {dbs_path}")

    dbs = []
    stats = KStats()
    settings = None
    for p in paths:
        if progress:
            print(f"# Merging database {p} into {out_path}...")
        db = artifact.load_db(p)
        if db.indexed:
            raise ValueError(
                f"{p} is indexed; merge requires unindexed (-noindex) builds"
            )
        if settings is None:
            settings = db.settings
            stats.Features = list(db.stats.Features)
        stats.NumberOfProteins += db.stats.NumberOfProteins
        stats.NumberOfAA += db.stats.NumberOfAA
        stats.NumberOfKmers += db.stats.NumberOfKmers
        dbs.append(db)

    ids = np.concatenate([np.asarray(db.protein_ids) for db in dbs])
    if len(np.unique(ids)) != len(ids):
        raise ValueError(
            "duplicate external protein ids across merged databases; "
            "build the parts with distinct -offset ranges"
        )

    # artifact.save_db's files, written as streams
    os.makedirs(out_path, exist_ok=True)
    np.save(os.path.join(out_path, "protein_ids.npy"), ids.astype(np.uint32))
    np.save(os.path.join(out_path, "protein_lengths.npy"),
            np.concatenate([np.asarray(db.protein_lengths)
                            for db in dbs]).astype(np.int32))
    for name in BLOBS:
        offsets = [np.zeros(1, np.uint64)]
        base = np.uint64(0)
        with open(os.path.join(out_path, name + ".bin"), "wb") as out:
            for p in paths:
                with open(os.path.join(p, name + ".bin"), "rb") as f:
                    shutil.copyfileobj(f, out)
                off = np.load(os.path.join(p, name + ".off.npy"))
                offsets.append(off[1:] + base)
                base += off[-1]
        np.save(os.path.join(out_path, name + ".off.npy"),
                np.concatenate(offsets))

    # each part's pairs, read past its .npy header (the memmap's offset)
    row_bases = np.cumsum([0] + [db.num_proteins for db in dbs[:-1]])
    data_offsets = [int(db.pairs.offset) for db in dbs]
    for db in dbs:
        db.pairs = None  # drop the memmaps; the merge reads the files
    _kway_merge_u64([os.path.join(p, "pairs.npy") for p in paths],
                    os.path.join(out_path, "pairs.npy"), BLOCK_ELEMS,
                    data_offsets=data_offsets,
                    row_bases=[int(b) for b in row_bases])

    settings = settings or KSettings()
    settings.DatabaseIndexed = False
    artifact.write_meta(out_path, stats, settings, indexed=False)
