"""Six-frame ORFs of a read by the bacterial genetic code, and kaamer's
start-codon refinement.

kaamer fixes the translation to NCBI table 11 (the bacterial code; the
reference's dna.go:106 translates with it whatever the -g option says).
The scan follows kaamer's dna.go:65-181:

- frames +1, +2, +3 of the read and -1, -2, -3 of its reverse complement;
- a frame starts inside an ORF; a stop codon ends the ORF (its '*' kept)
  and the next start codon opens one; the frame's end closes the last;
- an ORF is kept at 21 amino acids or more, '*' included;
- 1-based read coordinates: on the plus strand the first base of the
  first codon and the last base of the last codon; on the minus strand
  the start lies above the end;
- every start codon inside an ORF adds its amino-acid offset to the
  ORF's alternative starts;
- ORFs come ordered by their plus-strand end or minus-strand start.

The refinement (dna.go:198-272) moves the ORF's start to the latest
alternative start at or before the first k-mer that its best hits match.
"""

from __future__ import annotations

from typing import List, NamedTuple

K = 7
MIN_LEN_CDS = 21

_BASES = "tcag"
# NCBI transl_table 11: amino acids and initiation codons over the codon
# order TTT, TTC, TTA, TTG, TCT, ... (first base slowest, bases T, C, A, G)
_AAS = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
_STARTS = "---M------**--*----M------------MMMM---------------M------------"
CODE11 = {}
for _i, (_a, _s) in enumerate(zip(_AAS, _STARTS)):
    _codon = _BASES[_i // 16] + _BASES[(_i // 4) % 4] + _BASES[_i % 4]
    CODE11[_codon] = (_a, _s == "M", _a == "*")

# a codon with a base other than a, c, g, t translates to nothing but
# still advances the amino-acid counter (dna.go:104-152)
UNKNOWN = ("", False, False)
_COMPLEMENT = str.maketrans("acgt", "tgca")


class Orf(NamedTuple):
    seq: str
    start: int
    end: int
    plus: bool
    alts: List[int]


def reverse_complement(dna: str) -> str:
    return dna.lower().translate(_COMPLEMENT)[::-1]


def orfs(dna: str) -> List[Orf]:
    dna = dna.lower()
    n = len(dna)
    found: List[Orf] = []
    rc = reverse_complement(dna)
    for frame_pos in range(6):
        plus = frame_pos <= 2
        off = frame_pos % 3
        src = dna if plus else rc
        frame = src[off:off + (len(src) - off) // 3 * 3]
        start = frame_pos + 1 if plus else n - off
        alts: List[int] = []
        aas: List[str] = []
        inside = True
        aa_pos = 0
        last_i = 0
        for ci in range(len(frame) // 3):
            i = ci * 3
            last_i = i
            aa, is_start, is_stop = CODE11.get(frame[i:i + 3], UNKNOWN)
            if is_start:
                if not inside:
                    inside = True
                    aa_pos = 0
                    start = (frame_pos + i + 1 if plus
                             else n - (frame_pos + i) + 3)
                alts.append(aa_pos)
            if inside and aa:
                aas.append(aa)
            if is_stop:
                if inside and len(aas) >= MIN_LEN_CDS:
                    end = (i + 3 + frame_pos if plus
                           else start - len(aas) * 3 + 1)
                    found.append(Orf("".join(aas), start, end, plus, alts))
                start, alts, aas, inside = 0, [], [], False
            aa_pos += 1
        if inside and len(aas) >= MIN_LEN_CDS:
            end = last_i + 3 + frame_pos if plus else start - len(aas) * 3 + 1
            found.append(Orf("".join(aas), start, end, plus, alts))
    found.sort(key=lambda o: o.end if o.plus else o.start)
    return found


def n_kmers(seq: str) -> int:
    """Searchable k-mers of a translated sequence: a trailing '*' is not."""
    return len(seq) - K + 1 - (1 if seq.endswith("*") else 0)


def best_start(alts: List[int], first_match: int) -> int:
    """The latest alternative start at or before the first matched k-mer."""
    best = alts[0]
    for s in alts:
        if s <= first_match:
            best = s
        else:
            break
    return best
