"""A configuration's database, made once per checkout and cached under
`benchmark/.cache/<config>/`.

The first run of a configuration writes its FASTA from the configuration's
own seed with the generator it names (`generators/<name>.py`), keeps
the residues as arrays for the clients and the reference
(`residues.npy`, `offsets.npy`, `ids.npy`), builds the program's artifact
from the FASTA with the program's `index/build.build_db` (`artifact/`),
and the reference's own postings from the arrays (`postings/`).  The FASTA
is deleted then; `ready.json` marks a complete cache.  Later runs only
open it.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import numpy as np

from . import registry
from .reference.kmers import Postings

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE_ROOT = os.path.join(HERE, ".cache")


def parse_fasta(path: str):
    """(residues uint8, offsets int64[n + 1], ids str[n]) of a FASTA with
    one sequence line a record."""
    data = np.fromfile(path, np.uint8)
    ends = np.flatnonzero(data == ord("\n"))
    begins = np.concatenate([[0], ends[:-1] + 1])
    if begins.shape[0] % 2 or not (data[begins[0::2]] == ord(">")).all() \
            or (data[begins[1::2]] == ord(">")).any():
        raise ValueError(f"{path}: expected one sequence line per record")
    sb, se = begins[1::2], ends[1::2]
    lens = se - sb
    offsets = np.zeros(lens.shape[0] + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    residues = np.concatenate([data[a:b] for a, b in
                               zip(sb.tolist(), se.tolist())])
    heads = [data[a + 1:b].tobytes().decode().split(" ", 1)[0]
             for a, b in zip(begins[0::2].tolist(), ends[0::2].tolist())]
    return residues, offsets, np.array(heads)


class Database:
    """The cached arrays and paths of one configuration's database."""

    def __init__(self, path: str):
        self.path = path
        self.artifact = os.path.join(path, "artifact")
        self.residues = np.load(os.path.join(path, "residues.npy"),
                                mmap_mode="r")
        self.offsets = np.load(os.path.join(path, "offsets.npy"))
        self.lengths = np.diff(self.offsets)
        self.n_proteins = self.lengths.shape[0]
        self._ids = None
        self._postings = None

    def protein(self, row: int) -> np.ndarray:
        return self.residues[self.offsets[row]:self.offsets[row + 1]]

    @property
    def ids(self):
        if self._ids is None:
            self._ids = np.load(os.path.join(self.path, "ids.npy"))
        return self._ids

    @property
    def postings(self) -> Postings:
        if self._postings is None:
            self._postings = Postings.load(os.path.join(self.path,
                                                        "postings"))
        return self._postings


def _fingerprint(config: dict) -> str:
    return hashlib.sha256(json.dumps(config, sort_keys=True).encode()
                          ).hexdigest()


def cache_dir(config: dict, root: str = "") -> str:
    return os.path.join(root or CACHE_ROOT, config["name"])


def is_ready(config: dict, root: str = "") -> bool:
    marker = os.path.join(cache_dir(config, root), "ready.json")
    if not os.path.exists(marker):
        return False
    with open(marker) as f:
        return json.load(f).get("fingerprint") == _fingerprint(config)


def ensure(config: dict, root: str = "", log=print) -> Database:
    """The configuration's database, made first where the cache lacks it."""
    path = cache_dir(config, root)
    if is_ready(config, root):
        return Database(path)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    t0 = time.time()
    fasta = os.path.join(path, "db.fasta")
    registry.generator(config["generator"]).write(fasta, config)
    residues, offsets, ids = parse_fasta(fasta)
    if residues.shape[0] and (np.diff(offsets).min() < 7):
        raise ValueError("a database protein is shorter than a k-mer")
    np.save(os.path.join(path, "residues.npy"), residues)
    np.save(os.path.join(path, "offsets.npy"), offsets)
    np.save(os.path.join(path, "ids.npy"), ids)
    log(f"database: FASTA and arrays of {ids.shape[0]} proteins in "
        f"{time.time() - t0:.1f} s")

    from kaamer_tpu_torch.index.build import build_db  # the program's build
    t1 = time.time()
    build_db(os.path.join(path, "artifact"), fasta, "fasta")
    log(f"database: program artifact built in {time.time() - t1:.1f} s")
    os.remove(fasta)

    t2 = time.time()
    Postings.build(residues, offsets).save(os.path.join(path, "postings"))
    log(f"database: reference postings built in {time.time() - t2:.1f} s")
    sizes = {d: sum(os.path.getsize(os.path.join(dp, f))
                    for dp, _, fs in os.walk(os.path.join(path, d))
                    for f in fs)
             for d in ("artifact", "postings")}
    log(f"database: bytes on disk {sizes}")
    with open(os.path.join(path, "ready.json"), "w") as f:
        json.dump({"fingerprint": _fingerprint(config), "bytes": sizes}, f)
    return Database(path)
