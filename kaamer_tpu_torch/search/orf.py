"""Six-frame ORF extraction and start-codon refinement (the port's copy
of kaamer_tpu/search/orf.py, unchanged: the native batched scanner of the
port's native/ and the Python scan it must equal).

Coordinate and splitting semantics replicate the reference exactly
(pkg/search/dna.go:65-272):

- six frames (+1,+2,+3,-1,-2,-3); reverse strand = reverse complement;
- an ORF begins at the frame start or at a start codon following a stop, and
  ends at a stop codon (the '*' is included in the ORF sequence) or frame end;
- minimum ORF length 21 amino acids (dna.go:26);
- 1-based genomic coordinates: on the plus strand StartPosition is the first
  base of the first codon and EndPosition the last base of the stop codon; on
  the minus strand StartPosition > EndPosition (dna.go:110-133);
- StartsAlternative records the amino-acid offset of every start codon seen
  inside the ORF (the codon-counter quirk included: unknown codons translate
  to nothing but still advance the counter, dna.go:104-152);
- ORFs are ordered by EndPosition (plus) / StartPosition (minus) ascending
  (dna.go:167-178).

SetBestStartCodon (dna.go:198-272) trims a translated query to the latest
alternative start preceding the first k-mer match of its best hits and shifts
positions/bitmaps accordingly.

Translation honors the requested genetic-code table; the reference always
used the bacterial table (dna.go:106 quirk); defaults agree (table 11).
"""

from __future__ import annotations

from typing import List

import numpy as np

from .gcode import codon_indices, translation_arrays

KMER_SIZE = 7
MIN_LEN_CDS = 21  # dna.go:26

_COMPLEMENT = bytes.maketrans(b"atgc", b"tacg")


def reverse_complement(dna: str) -> str:
    """Lower-cased reverse complement (dna.go:55-63; non-acgt bases pass
    through unchanged, as with Go's strings.Replacer)."""
    return dna.lower().encode("latin-1")[::-1].translate(_COMPLEMENT).decode("latin-1")


def get_frame(frame_number: int, dna: str) -> str:
    """Frame sequence truncated to whole codons (dna.go:183-196)."""
    if frame_number < 0:
        dna = reverse_complement(dna)
        frame_number = -frame_number
    start = frame_number - 1
    ln = len(dna) - start
    return dna[start : len(dna) - (ln % 3)]


class Location:
    """Slotted plain class: ~29k Locations are built per 8k-read fastq batch,
    so construction cost is on the serving hot path."""

    __slots__ = ("StartPosition", "EndPosition", "PlusStrand", "StartsAlternative")

    def __init__(self, StartPosition=1, EndPosition=0, PlusStrand=True,
                 StartsAlternative=None):
        self.StartPosition = StartPosition
        self.EndPosition = EndPosition
        self.PlusStrand = PlusStrand
        self.StartsAlternative = [] if StartsAlternative is None else StartsAlternative

    def __eq__(self, other):
        return (self.StartPosition, self.EndPosition, self.PlusStrand,
                self.StartsAlternative) == (
            other.StartPosition, other.EndPosition, other.PlusStrand,
            other.StartsAlternative)

    def __repr__(self):
        return (f"Location({self.StartPosition}, {self.EndPosition}, "
                f"{self.PlusStrand}, {self.StartsAlternative})")


class ORF:
    __slots__ = ("Sequence", "Location")

    def __init__(self, Sequence, Location):
        self.Sequence = Sequence
        self.Location = Location

    def __eq__(self, other):
        return (self.Sequence, self.Location) == (other.Sequence, other.Location)

    def __repr__(self):
        return f"ORF({self.Sequence!r}, {self.Location!r})"


def get_orfs(dna: str, gcode_id: int = 11) -> List[ORF]:
    """All >=21aa ORFs over six frames with reference coordinates.

    Uses the native batched scanner when available; the Python scan below is
    the semantic specification (and fallback)."""
    batch = get_orfs_batch([dna], gcode_id)
    return batch[0] if batch is not None else _get_orfs_py(dna, gcode_id)


def get_orfs_batch(seqs: List[str], gcode_id: int = 11):
    """Native six-frame ORF scan for a batch of sequences; returns a list of
    ORF lists (one per input), or None when the native library is missing.
    Identical output to _get_orfs_py (tests/test_torch_translated.py)."""
    from .. import native

    if not native.available():
        return None
    arrays = translation_arrays(gcode_id)
    buf = "".join(seqs).encode("latin-1")
    dna_buf = np.frombuffer(buf, dtype=np.uint8)
    lens = np.fromiter((len(s) for s in seqs), count=len(seqs), dtype=np.int64)
    dna_off = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum(lens, out=dna_off[1:])
    out = native.get_orfs_raw(dna_buf, dna_off, arrays.aa, arrays.start,
                              arrays.stop)
    if out is None:
        return None
    seq_buf, seq_off, meta, alts_buf, alts_off = out
    result: List[List[ORF]] = [[] for _ in seqs]
    # one bulk conversion each instead of per-ORF numpy scalar reads
    all_seq = seq_buf.tobytes().decode("latin-1")
    seq_off_l = seq_off.tolist()
    alts_l = alts_buf.tolist()
    alts_off_l = alts_off.tolist()
    for k, (r, sp, ep, plus) in enumerate(meta.tolist()):
        result[r].append(ORF(
            Sequence=all_seq[seq_off_l[k]:seq_off_l[k + 1]],
            Location=Location(StartPosition=sp, EndPosition=ep,
                              PlusStrand=bool(plus),
                              StartsAlternative=alts_l[alts_off_l[k]:alts_off_l[k + 1]]),
        ))
    return result


def get_orf_tuples_batch(seqs: List[str], gcode_id: int = 11,
                         min_kmers: int = 0):
    """Lightweight variant of get_orfs_batch for the serving pipelines:
    returns, per input sequence, a list of tuples
    (Sequence, n_kmers, StartPosition, EndPosition, PlusStrand,
    StartsAlternative) WITHOUT constructing ORF/Location objects -- object
    construction measured ~7x the raw native scan cost at fastq rates, and
    most ORFs are discarded by the MinKMatch gate before their objects would
    ever be needed.  n_kmers counts searchable k-mers (a trailing '*' is not
    searchable); ORFs with n_kmers < min_kmers are dropped BEFORE any Python
    string is built for them (the gate is vectorized; ~40% of scanned ORFs
    fail it on short reads).  Falls back to the Python scanner when the
    native library is unavailable."""
    from .. import native

    arrays = translation_arrays(gcode_id)
    buf = "".join(seqs).encode("latin-1")
    dna_buf = np.frombuffer(buf, dtype=np.uint8)
    lens = np.fromiter((len(s) for s in seqs), count=len(seqs), dtype=np.int64)
    dna_off = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum(lens, out=dna_off[1:])
    out = None
    if native.available():
        out = native.get_orfs_raw(dna_buf, dna_off, arrays.aa, arrays.start,
                                  arrays.stop)
    if out is None:
        result = []
        for s in seqs:
            items = []
            for o in _get_orfs_py(s, gcode_id):
                n = len(o.Sequence) - KMER_SIZE + 1
                if o.Sequence.endswith("*"):
                    n -= 1
                if n >= min_kmers:
                    items.append((o.Sequence, n, o.Location.StartPosition,
                                  o.Location.EndPosition,
                                  o.Location.PlusStrand,
                                  o.Location.StartsAlternative))
            result.append(items)
        return result
    seq_buf, seq_off, meta, alts_buf, alts_off = out
    result = [[] for _ in seqs]
    slens = np.diff(seq_off)
    star = np.zeros(slens.shape, dtype=bool)
    nz = slens > 0
    star[nz] = seq_buf[seq_off[1:][nz] - 1] == ord("*")
    nk = slens - (KMER_SIZE - 1) - star
    kept = np.flatnonzero(nk >= min_kmers).tolist()
    if not kept:
        return result
    all_seq = seq_buf.tobytes().decode("latin-1")
    seq_off_l = seq_off.tolist()
    alts_l = alts_buf.tolist()
    alts_off_l = alts_off.tolist()
    # column lists beat per-row meta.tolist() sublists (~35% of this loop)
    r_l = meta[:, 0].tolist()
    sp_l = meta[:, 1].tolist()
    ep_l = meta[:, 2].tolist()
    plus_l = (meta[:, 3] != 0).tolist()
    nk_l = nk.tolist()
    for k in kept:
        result[r_l[k]].append((
            all_seq[seq_off_l[k]:seq_off_l[k + 1]], nk_l[k], sp_l[k],
            ep_l[k], plus_l[k], alts_l[alts_off_l[k]:alts_off_l[k + 1]],
        ))
    return result


def _get_orfs_py(dna: str, gcode_id: int = 11) -> List[ORF]:
    """Pure-Python reference scan (dna.go:65-181)."""
    dna = dna.lower()
    arrays = translation_arrays(gcode_id)
    n = len(dna)
    orfs: List[ORF] = []

    frame_specs = [(0, 1), (1, 2), (2, 3), (3, -1), (4, -2), (5, -3)]
    for frame_pos, frame_no in frame_specs:
        frame_seq = get_frame(frame_no, dna)
        start_off = frame_pos % 3
        plus = frame_pos <= 2
        abs_pos = frame_pos if plus else n - start_off - 1

        codons = codon_indices(frame_seq)
        aas = arrays.aa[codons]
        starts = arrays.start[codons]
        stops = arrays.stop[codons]

        loc = Location(StartPosition=abs_pos + 1, EndPosition=0,
                       PlusStrand=plus, StartsAlternative=[])
        cds_parts: List[int] = []
        inside = True
        current_aa_pos = 0
        current_i = 0

        for ci in range(codons.shape[0]):
            i = ci * 3
            current_i = i
            if starts[ci]:
                if not inside:
                    inside = True
                    current_aa_pos = 0
                    if plus:
                        loc.StartPosition = frame_pos + i + 1
                    else:
                        loc.StartPosition = n - (frame_pos + i) + 3
                    loc.StartsAlternative.append(current_aa_pos)
                else:
                    loc.StartsAlternative.append(current_aa_pos)

            if inside and aas[ci]:
                cds_parts.append(aas[ci])

            if stops[ci]:
                if inside and len(cds_parts) >= MIN_LEN_CDS:
                    if plus:
                        loc.EndPosition = i + 3 + frame_pos
                    else:
                        loc.EndPosition = loc.StartPosition - len(cds_parts) * 3 + 1
                    orfs.append(ORF(Sequence=bytes(cds_parts).decode("latin-1"),
                                    Location=loc))
                loc = Location(StartPosition=0, EndPosition=0,
                               PlusStrand=plus, StartsAlternative=[])
                cds_parts = []
                inside = False

            current_aa_pos += 1

        if inside and len(cds_parts) >= MIN_LEN_CDS:
            if plus:
                loc.EndPosition = current_i + 3 + frame_pos
            else:
                loc.EndPosition = loc.StartPosition - len(cds_parts) * 3 + 1
            orfs.append(ORF(Sequence=bytes(cds_parts).decode("latin-1"), Location=loc))

    orfs.sort(key=lambda o: o.Location.EndPosition if o.Location.PlusStrand
              else o.Location.StartPosition)
    return orfs


def set_best_start_codon(query, hits, position_hits) -> None:
    """Move a translated query's start to the latest alternative start at or
    before its best hits' first matched k-mer (dna.go:198-272).  Mutates
    `query` (a QueryRecord) and the bitmap lists in `position_hits` in place.

    hits: list of (row_or_id, kmatch) sorted by kmatch desc.
    position_hits: dict id -> per-k-mer-position match bitmap (list[bool] or
    numpy bool array; the serving pipelines pass arrays).
    """
    best_hits = []
    best_score = 0
    for hid, kmatch in hits:
        if kmatch >= best_score:
            best_score = kmatch
            best_hits.append(hid)

    alts = query.Location.StartsAlternative
    if len(alts) <= 1:
        # with a single alternative, best_start can only equal first_start
        # (the scan below never moves past alts[0]); skip the bitmap work
        return

    first_start = alts[0]
    best_start = alts[0]

    # Quirk preserved (dna.go:225-237): the `exit` flag is shared across best
    # hits, so after the first hit contributes a position, later hits are only
    # consulted at position 0.  The first-match scan is argmax over the
    # bitmap array (one per ORF with hits: serving hot path).
    first_best_hit_pos = 999999999
    exit_flag = False
    for hid in best_hits:
        bitmap = position_hits.get(hid)
        if bitmap is None or len(bitmap) == 0:
            continue
        if exit_flag:
            if bitmap[0]:
                first_best_hit_pos = 0
        else:
            arr = np.asarray(bitmap, dtype=bool)
            i = int(arr.argmax())
            if arr[i]:
                first_best_hit_pos = min(first_best_hit_pos, i)
                exit_flag = True

    for s in alts:
        if s <= first_best_hit_pos:
            best_start = s
        else:
            break

    if best_start != first_start:
        if query.Location.PlusStrand:
            query.Location.StartPosition += 3 * best_start
        else:
            query.Location.StartPosition -= 3 * best_start
        query.Sequence = query.Sequence[best_start:]
        for key in list(position_hits.keys()):
            position_hits[key] = position_hits[key][best_start:]
        n = len(query.Sequence) - KMER_SIZE + 1
        if query.Sequence.endswith("*"):
            n -= 1
        query.SizeInKmer = n

    query.Location.StartsAlternative = []
