"""NCBI genetic-code (transl_table) definitions (the port's copy of
kaamer_tpu/search/gcode.py, unchanged).

Standard public data, encoded from the canonical NCBI table strings: for each
table a 64-character amino-acid string and a start/stop annotation string over
the codon order TTT,TTC,TTA,TTG,TCT,... (first base slowest, base order
T,C,A,G).  Tables 1-6 and 9-15, matching the set the reference supports
(reference pkg/search/gcode.go:21-34; its bacterial default table at
gcode.go:36-101 equals NCBI table 11).

The reference quirk of always translating ORFs with the bacterial table
regardless of the user's -g option (dna.go:106) is NOT reproduced: we honor
the requested table, whose default (11) matches the reference's behavior.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np


class AminoAcid(NamedTuple):
    AA: str
    Start: bool
    Stop: bool


_BASES = "tcag"
_CODONS = [a + b + c for a in _BASES for b in _BASES for c in _BASES]

# (amino acids, starts) per NCBI table id.  '*' marks stops in both strings;
# 'M' in the second string marks alternative initiation codons.
_NCBI_TABLES = {
    1: ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "---M------**--*----M---------------M----------------------------"),
    2: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSS**VVVVAAAADDEEGGGG",
        "----------**--------------------MMMM----------**---M------------"),
    # Start sets follow the reference's revision of the NCBI data
    # (gcode.go): e.g. table 3 lists only ATG as initiation codon there.
    3: ("FFLLSSSSYY**CCWWTTTTPPPPHHQQRRRRIIMMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "----------**-----------------------M----------------------------"),
    4: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "--MM------**-------M------------MMMM---------------M------------"),
    5: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSSSVVVVAAAADDEEGGGG",
        "---M------**--------------------MMMM---------------M------------"),
    6: ("FFLLSSSSYYQQCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
        "--------------*--------------------M----------------------------"),
    9: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
        "----------**-----------------------M----------------------------"),
    10: ("FFLLSSSSYY**CCCWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------**-----------------------M----------------------------"),
    11: ("FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "---M------**--*----M------------MMMM---------------M------------"),
    12: ("FFLLSSSSYY**CC*WLLLSPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "-------------------M---------------M----------------------------"),
    13: ("FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIMMTTTTNNKKSSGGVVVVAAAADDEEGGGG",
         "-----------*-----------------------M----------------------------"),
    14: ("FFLLSSSSYYY*CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNNKSSSSVVVVAAAADDEEGGGG",
         "-----------*-----------------------M----------------------------"),
    15: ("FFLLSSSSYY*QCC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
         "----------*---*--------------------M----------------------------"),
}


def _build_table(aas: str, starts: str) -> Dict[str, AminoAcid]:
    table = {}
    for i, codon in enumerate(_CODONS):
        aa = aas[i]
        table[codon] = AminoAcid(AA=aa, Start=starts[i] == "M", Stop=aa == "*")
    return table


GCODES: Dict[int, Dict[str, AminoAcid]] = {
    tid: _build_table(aas, starts) for tid, (aas, starts) in _NCBI_TABLES.items()
}

VALID_GCODES = sorted(GCODES)


# ---------------------------------------------------------------------------
# Vectorized codon translation (used by the ORF scanner): codon index =
# b0*16 + b1*4 + b2 with t=0,c=1,a=2,g=3; index 64 = "unknown base" codon.
# ---------------------------------------------------------------------------

_BASE_CODE = np.full(256, -1, dtype=np.int8)
for _i, _b in enumerate(_BASES):
    _BASE_CODE[ord(_b)] = _i
    _BASE_CODE[ord(_b.upper())] = _i


class TranslationArrays(NamedTuple):
    aa: np.ndarray      # uint8[65] amino-acid byte (0 for "unknown codon")
    start: np.ndarray   # bool[65]
    stop: np.ndarray    # bool[65]


_ARRAYS_CACHE: Dict[int, TranslationArrays] = {}


def translation_arrays(gcode_id: int) -> TranslationArrays:
    if gcode_id not in _ARRAYS_CACHE:
        table = GCODES[gcode_id]
        aa = np.zeros(65, dtype=np.uint8)
        start = np.zeros(65, dtype=bool)
        stop = np.zeros(65, dtype=bool)
        for i, codon in enumerate(_CODONS):
            entry = table[codon]
            aa[i] = ord(entry.AA)
            start[i] = entry.Start
            stop[i] = entry.Stop
        _ARRAYS_CACHE[gcode_id] = TranslationArrays(aa, start, stop)
    return _ARRAYS_CACHE[gcode_id]


def codon_indices(dna: str) -> np.ndarray:
    """Codon index (0..63, or 64 when any base is unknown) for each full codon
    of `dna` read in frame 0."""
    raw = np.frombuffer(dna.encode("latin-1"), dtype=np.uint8)
    n = len(raw) // 3
    codes = _BASE_CODE[raw[: n * 3]].reshape(n, 3).astype(np.int32)
    idx = codes[:, 0] * 16 + codes[:, 1] * 4 + codes[:, 2]
    idx = np.where((codes < 0).any(axis=1), 64, idx)
    return idx
