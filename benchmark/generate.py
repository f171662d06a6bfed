"""The one generator of requests: a traffic mix's parameters (a file
`traffic/<mix>.json`) and a seed make every request a client sends.

Request `index` of client `client` under `seed` is the same text on every
run; seeds change which database proteins, mutations and positions a
request draws, never its size.  The records are made by the mix's record
kind, a file `records/<kind>.py` found by name (registry.records).

Each request also names its judged sample: `sample_per_request` records
drawn from the seed, and the longest record of the request.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np

AA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
BASES = np.frombuffer(b"acgt", np.uint8)

# one codon per amino acid (bench/data.py:_AA2CODON, table 11)
AA2CODON = {
    "A": "gct", "C": "tgt", "D": "gat", "E": "gaa", "F": "ttt", "G": "ggt",
    "H": "cat", "I": "att", "K": "aaa", "L": "ctt", "M": "atg", "N": "aat",
    "P": "cct", "Q": "caa", "R": "cgt", "S": "tct", "T": "act", "V": "gtt",
    "W": "tgg", "Y": "tat",
}
CODON_LUT = np.zeros((256, 3), np.uint8)
for _a, _c in AA2CODON.items():
    CODON_LUT[ord(_a)] = np.frombuffer(_c.encode(), np.uint8)

# stream tags under one (seed, client, index)
_RECORDS, _SAMPLE = 0, 1
WARM_INDEX = 1 << 40  # the index of a client's unmeasured request


class Request(NamedTuple):
    text: str            # the uploaded file
    names: List[str]     # record names, in order
    seqs: List[str]      # record sequences, in order
    sample: List[int]    # indices of the judged records


def rng_for(seed: int, client: int, index: int, tag: int):
    return np.random.default_rng([seed & (2**64 - 1), client, index, tag])


def reverse_translate(prot: np.ndarray) -> np.ndarray:
    """Codons (lower-case bytes) of upper-case residue bytes."""
    return CODON_LUT[prot].reshape(-1)


def make_request(mix: Dict, db, seed: int, client: int, index: int) -> Request:
    from benchmark import registry

    p = mix["records"]
    kind = registry.records(p["kind"])
    seqs = kind.make(rng_for(seed, client, index, _RECORDS), db, p)
    names = [f"c{client}.r{index}.q{i}" for i in range(len(seqs))]
    k = min(int(mix["judge"]["sample_per_request"]), len(seqs))
    drawn = rng_for(seed, client, index, _SAMPLE).choice(
        len(seqs), size=k, replace=False)
    longest = max(range(len(seqs)), key=lambda i: len(seqs[i]))
    sample = sorted(set(drawn.tolist()) | {longest})
    return Request(kind.text(names, seqs), names, seqs, sample)
