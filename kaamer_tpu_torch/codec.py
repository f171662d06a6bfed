"""The kAAmer 7-mer codec (kaamer_tpu/codec.py): host packers in numpy and
the device side in torch.

Semantics match the reference Go codec exactly (reference
pkg/kvstore/k_store.go:39-145):

- Alphabet: 21 amino acids INCLUDING selenocysteine 'U':
  A C D E F G H I K L M N P Q R S T U V W Y  (k_store.go:41).
- A 7-mer packs into exactly 32 bits as three amino-acid *pairs* at 9 bits
  each plus the last single residue at 5 bits:
      bits 31-23 : pair(aa0, aa1)   code = 22 + idx(aa0)*21 + idx(aa1)
      bits 22-14 : pair(aa2, aa3)
      bits 13-5  : pair(aa4, aa5)
      bits  4-0  : idx(aa6)         codes 0..20
- Quirk preserved: a pair containing a character outside the alphabet encodes
  as 0 (Go zero-value for a missing map key) and an invalid final residue
  encodes as 0 (aliasing 'A').  Both the DB build and the query path use the
  same fallback, exactly like the reference, so lookups stay consistent.

The host packers (pad_codes_batch, pack_codes7, and the native packer) make
the base-22 wire format; the device side unpacks the wire words and encodes
7-mers.  pack_codes3 / unpack_codes3 are the simpler 3-residue wire format
(3 residues a uint16 word, 22^3 = 10648 < 2^16) that the JAX package keeps
beside it.  The host 7-mer encoders are encode_kmers_np / encode_kmers_batch
(kaamer_tpu.codec's encode_kmers / encode_kmers_batch); encode_kmers here
is the device one.

torch has no unsigned 32-bit arithmetic on the CPU (no // or << on uint32),
so device words and k-mer codes are carried in int64 holding the unsigned
value.
"""

from __future__ import annotations

import numpy as np
import torch

KMER_SIZE = 7
AA_ALPHABET = "ACDEFGHIKLMNPQRSTUVWY"  # 21 symbols, k_store.go:41
N_AA = len(AA_ALPHABET)

# byte value -> residue index 0..20, or -1 if not in the alphabet
CHAR_TO_CODE = np.full(256, -1, dtype=np.int32)
for _i, _c in enumerate(AA_ALPHABET):
    CHAR_TO_CODE[ord(_c)] = _i

CHAR_TO_CODE_I8 = CHAR_TO_CODE.astype(np.int8)

PAD3 = 21  # in-band padding residue for the packed wire format
U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# host (numpy)
# ---------------------------------------------------------------------------


def seq_to_codes(seq: str) -> np.ndarray:
    """Residue indices (int32, -1 for unknown chars) for an ASCII sequence."""
    raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    return CHAR_TO_CODE[raw]


def pad_codes_batch(seqs, width: int) -> np.ndarray:
    """Residue-code matrix int8[B, width] for a batch of sequences, padded
    with -1.  One joined buffer + LUT + boolean-mask assignment instead of a
    Python per-string loop; the mask form avoids the index-vector np.repeat
    construction, which dominated host time at large batches (~9us/query)."""
    B = len(seqs)
    out = np.full((B, width), -1, dtype=np.int8)
    if B == 0:
        return out
    clipped = [s[:width] for s in seqs]
    buf = "".join(clipped).encode("latin-1")
    lens = np.fromiter((len(s) for s in clipped), count=B, dtype=np.int64)
    raw = np.frombuffer(buf, dtype=np.uint8)
    if raw.size == 0:
        return out
    codes = CHAR_TO_CODE_I8[raw]
    # row-major boolean mask selects, per row in order, exactly the first
    # lens[b] slots -- matching the concatenation layout of `codes`
    mask = np.arange(width, dtype=np.int64)[None, :] < lens[:, None]
    out[mask] = codes
    return out


def _pair_code(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pair code 22 + a*21 + b, or 0 when either residue is invalid."""
    valid = (a >= 0) & (b >= 0)
    return np.where(valid, 22 + a * N_AA + b, 0).astype(np.uint32)


def _single_code(c: np.ndarray) -> np.ndarray:
    return np.where(c >= 0, c, 0).astype(np.uint32)


def encode_kmers_np(codes: np.ndarray) -> np.ndarray:
    """All sliding-window 7-mer codes of a residue-index array.

    codes: int32[L] (from seq_to_codes). Returns uint32[max(L-6, 0)].
    Vectorized equivalent of the reference's per-window EncodeKmer loop
    (inputFASTA.go:245-248 + k_store.go:91-117).
    """
    L = codes.shape[0]
    n = L - KMER_SIZE + 1
    if n <= 0:
        return np.empty(0, dtype=np.uint32)
    p1 = _pair_code(codes[0:n], codes[1 : n + 1])
    p2 = _pair_code(codes[2 : n + 2], codes[3 : n + 3])
    p3 = _pair_code(codes[4 : n + 4], codes[5 : n + 5])
    last = _single_code(codes[6 : n + 6])
    return (p1 << 23) | (p2 << 14) | (p3 << 5) | last


def encode_kmers_batch(codes: np.ndarray) -> np.ndarray:
    """encode_kmers_np over a batch: int32[B, L+6] -> uint32[B, L]."""
    L = codes.shape[1] - KMER_SIZE + 1
    p1 = _pair_code(codes[:, 0:L], codes[:, 1 : L + 1])
    p2 = _pair_code(codes[:, 2 : L + 2], codes[:, 3 : L + 3])
    p3 = _pair_code(codes[:, 4 : L + 4], codes[:, 5 : L + 5])
    last = _single_code(codes[:, 6 : L + 6])
    return (p1 << 23) | (p2 << 14) | (p3 << 5) | last


def encode_kmer(kmer: str) -> int:
    """Scalar encode of one 7-mer (tests/debug only)."""
    assert len(kmer) == KMER_SIZE
    return int(encode_kmers_np(seq_to_codes(kmer))[0])


def decode_kmer(value: int) -> str:
    """Inverse of encode_kmer for valid codes (k_store.go:120-145)."""
    aa = (value >> 23) & 0x1FF
    bb = (value >> 14) & 0x1FF
    cc = (value >> 5) & 0x1FF
    dd = value & 0x1F

    def pair(code: int) -> str:
        if code < 22:
            return "??"
        code -= 22
        return AA_ALPHABET[code // N_AA] + AA_ALPHABET[code % N_AA]

    return pair(aa) + pair(bb) + pair(cc) + AA_ALPHABET[dd]


def query_num_kmers(seq: str) -> int:
    """SizeInKmer of a query: L-6, minus one if the sequence ends with '*'
    (reference search.go:290-293)."""
    n = len(seq) - KMER_SIZE + 1
    if seq.endswith("*"):
        n -= 1
    return n


def pack_codes3(codes: np.ndarray) -> np.ndarray:
    """int8[B, W] residue codes (-1 = pad) -> uint16[B, ceil(W/3)]."""
    B, W = codes.shape
    W3 = -(-W // 3) * 3
    c = np.full((B, W3), PAD3, dtype=np.uint16)
    c[:, :W] = np.where(codes >= 0, codes, PAD3).astype(np.uint16)
    c = c.reshape(B, W3 // 3, 3)
    return c[:, :, 0] * 484 + c[:, :, 1] * 22 + c[:, :, 2]


def pack_codes7(codes: np.ndarray) -> np.ndarray:
    """int8[B, W] residue codes (-1 = pad) -> uint32[B, ceil(W/7)].

    Base-22 positional packing, most-significant residue first:
    word = sum_i c[i] * 22^(6-i); max value 22^7 - 1 < 2^32, and every
    partial product stays below 2^32, so the whole accumulation runs in
    uint32 (u64 temporaries tripled the host cost of this hot function)."""
    B, W = codes.shape
    W7 = -(-W // 7) * 7
    c = np.full((B, W7), PAD3, dtype=np.uint32)
    np.copyto(c[:, :W], codes, casting="unsafe", where=codes >= 0)
    out = c[:, 0::7] * np.uint32(22**6)
    for i in range(1, 7):
        w = np.uint32(22 ** (6 - i))
        if w == 1:
            out += c[:, i::7]
        else:
            out += c[:, i::7] * w
    return out


# ---------------------------------------------------------------------------
# device (torch)
# ---------------------------------------------------------------------------


def as_u32(words: torch.Tensor) -> torch.Tensor:
    """Widen an int32 tensor holding uint32 bit patterns to int64 values."""
    return words.to(torch.int64) & U32


def unpack_codes7(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of pack_codes7 (unpack_codes7_jnp): int32[B, ceil(W/7)]
    holding uint32 words -> int64[B, width] residue codes, -1 for padding.
    Base-22 digits, most significant first."""
    p = as_u32(packed)
    digits = [p // 22**6]
    for k in range(5, 0, -1):
        digits.append((p // 22**k) % 22)
    digits.append(p % 22)
    c = torch.stack(digits, dim=-1).reshape(p.shape[0], -1)[:, :width]
    return torch.where(c == PAD3, -1, c)


def unpack_codes3(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of pack_codes3 (unpack_codes3_jnp): words in any integer
    dtype (uint16, or int16, int32, int64: every word is below 2^15)
    [B, ceil(W/3)] -> int64[B, width] residue codes, -1 for padding."""
    p = packed.to(torch.int64)
    c = torch.stack([p // 484, (p // 22) % 22, p % 22], dim=-1)
    c = c.reshape(p.shape[0], -1)[:, :width]
    return torch.where(c == PAD3, -1, c)


def encode_kmers(codes: torch.Tensor, n_kmers: int) -> torch.Tensor:
    """encode_kmers_jnp over a batch: codes int64[B, >= n_kmers + 6] ->
    int64[B, n_kmers] 7-mer codes (< 2^32).  A pair holding a code < 0
    encodes as 0 and so does a final residue < 0, as in the reference."""

    def pair(a, b):
        return torch.where((a >= 0) & (b >= 0), 22 + a * N_AA + b, 0)

    n = n_kmers
    p1 = pair(codes[:, 0:n], codes[:, 1:n + 1])
    p2 = pair(codes[:, 2:n + 2], codes[:, 3:n + 3])
    p3 = pair(codes[:, 4:n + 4], codes[:, 5:n + 5])
    last = codes[:, 6:n + 6].clamp(min=0)
    return (p1 << 23) | (p2 << 14) | (p3 << 5) | last
