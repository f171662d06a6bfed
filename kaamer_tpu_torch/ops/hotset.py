"""Hot-set dense counting in torch (kaamer_tpu/ops/hotset.py).

The longest postings sets of a skewed database (the hot sets) are counted
by one matrix product against a precomputed 0/1 membership matrix M[H, P]
instead of being expanded entry by entry:

    counts_hot[g, p] = sum_h W[g, h] * M[h, p]

W[g, h] is the position weight query g puts on hot set h.  Cold sets still
go through the expansion + sort + RLE pipeline (ops/count.py), and the two
contributions merge exactly: merge_hot_cold (the per-lane candidate union)
or merge_hot_cold_tam (the threshold-algorithm merge with its per-query
exactness certificate).  The module docstring of kaamer_tpu.ops.hotset
derives both merges; this port keeps their results bit for bit.

Rows travel as int64 holding the uint32 value with ROW_SENTINEL =
0xFFFFFFFF (ops/count.py); packed sort keys are int64, so the JAX
package's two key layouts (single uint32 key when pack_w_bits > 0, a
two-operand sort otherwise) become one layout with the same order.  Where
the two JAX branches select different candidates (the cold candidate list
C1 of merge_hot_cold_tam), both are kept.

kaamer_tpu.ops.hotset imports jax at module level, so its numpy helpers
(select_hot_sets, build_membership_np) and constants are copied here.
"""

from __future__ import annotations

import numpy as np
import torch

from .count import ROW_SENTINEL, rle_sorted, sort_weighted

_KEY_MAX = torch.iinfo(torch.int64).max

# hotset.py:44-53,116,295 (TPU-derived budgets, unchanged: they move which
# sets are hot and the matrix dtype, never a result)
MIN_HOT_LEN = 24
M_BYTES_BUDGET = 1 << 32
M_F32_BYTES = 64 << 20
CAND_K = 64


def select_hot_sets(set_offsets: np.ndarray, num_proteins: int,
                    h_max: int = 2048, min_len: int = MIN_HOT_LEN):
    """hotset.py:select_hot_sets: the longest postings sets as a pure
    length threshold.  Returns (hot_starts int32[H] sorted slice starts,
    threshold_len, P_pad) or None when no set qualifies.  A tie tier at the
    h_max cut is dropped whole (phase 1 marks every run with
    len >= threshold hot, so a partial tier would go uncounted)."""
    if set_offsets is None or set_offsets.size < 2:
        return None
    P_pad = -(-max(num_proteins, 1) // 128) * 128
    h_max = min(h_max, int(M_BYTES_BUDGET // (P_pad * 2)))
    if h_max < 1:
        return None
    lens = np.diff(set_offsets.astype(np.int64))
    eligible = np.flatnonzero(lens >= min_len)
    if eligible.size == 0:
        return None
    if eligible.size > h_max:
        part = np.argpartition(lens[eligible], eligible.size - h_max)
        hot_ids = eligible[part[eligible.size - h_max:]]
        thresh = int(lens[hot_ids].min())
        if int(np.count_nonzero(lens >= thresh)) > hot_ids.size:
            hot_ids = np.flatnonzero(lens >= thresh + 1)
            if hot_ids.size == 0:
                return None
    else:
        hot_ids = eligible
    hot_starts = set_offsets[hot_ids].astype(np.int64)
    thresh = int(lens[hot_ids].min())
    return np.sort(hot_starts).astype(np.int32), thresh, P_pad


def membership_pairs(postings: np.ndarray, set_offsets: np.ndarray,
                      hot_starts: np.ndarray):
    """(hot set index, protein row) of every hot postings entry."""
    ends = set_offsets.astype(np.int64)
    starts = hot_starts.astype(np.int64)
    stops = ends[np.searchsorted(ends, starts, side="right")]
    lens = stops - starts
    hh = np.repeat(np.arange(starts.size, dtype=np.int64), lens)
    src = np.repeat(starts - np.cumsum(lens) + lens, lens) + np.arange(
        int(lens.sum()), dtype=np.int64)
    return hh, np.asarray(postings)[src].astype(np.int64)


def build_membership_np(postings: np.ndarray, set_offsets: np.ndarray,
                        hot_starts: np.ndarray, P_pad: int) -> np.ndarray:
    """hotset.py:build_membership_np: M float32[H, P_pad] on the host,
    M[h, p] = 1 iff protein row p is in hot set h."""
    M = np.zeros((hot_starts.shape[0], P_pad), dtype=np.float32)
    hh, rr = membership_pairs(postings, set_offsets, hot_starts)
    M[hh, rr] = 1.0
    return M


def build_membership(postings: np.ndarray, set_offsets: np.ndarray,
                     hot_starts: np.ndarray, P_pad: int, device):
    """hotset.py:build_membership: M on `device` by one index_put_ over the
    compact (hot set, row) pairs; float32 while H * P_pad * 4 <=
    M_F32_BYTES, else bfloat16 (0/1 is exact in both)."""
    H = int(hot_starts.shape[0])
    dtype = torch.float32 if H * P_pad * 4 <= M_F32_BYTES else torch.bfloat16
    hh, rr = membership_pairs(postings, set_offsets, hot_starts)
    M = torch.zeros((H, P_pad), dtype=dtype, device=device)
    M.index_put_((torch.from_numpy(hh).to(device),
                  torch.from_numpy(rr).to(device)),
                 torch.ones((), dtype=dtype, device=device))
    return M


def hot_weights(offs: torch.Tensor, whot: torch.Tensor,
                hot_starts: torch.Tensor) -> torch.Tensor:
    """W float32[G, H]: the position weight each query puts on each hot set
    (hotset.py:hot_weights).  whot is nonzero only at hot run-start lanes,
    whose offs is a hot set's start; a searchsorted into the sorted
    hot_starts and an integer scatter-add replace the [G, L, H] one-hot
    einsum.  Sums are integers <= L, exact in float32."""
    H = hot_starts.shape[0]
    pos = torch.searchsorted(hot_starts.to(offs.dtype).contiguous(),
                             offs.contiguous())
    safe = pos.clamp(max=H - 1)
    hit = (pos < H) & (hot_starts.to(offs.dtype)[safe] == offs)
    W = torch.zeros((offs.shape[0], H), dtype=torch.int64, device=offs.device)
    W.scatter_add_(1, safe, torch.where(hit, whot.to(torch.int64), 0))
    return W.to(torch.float32)


def _mm_f32(a: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """a @ M for bf16 operands with float32 accumulation AND float32
    output (jnp.dot(..., preferred_element_type=f32)).  On CUDA one cuBLAS
    call with out_dtype; the CPU build registers that overload for CUDA
    only, so the CPU multiplies float32 column blocks of M."""
    if M.is_cuda:
        return torch.mm(a, M, out_dtype=torch.float32)
    a32 = a.to(torch.float32)
    step = 1 << 16
    return torch.cat([a32 @ M[:, c0:c0 + step].to(torch.float32)
                      for c0 in range(0, M.shape[1], step)], dim=1)


def hot_matmul(W: torch.Tensor, M: torch.Tensor, max_w: int,
               out_dtype=None, out: torch.Tensor = None) -> torch.Tensor:
    """counts_hot[G, P] = W @ M, integer-exact (hotset.py:hot_matmul).

    W float32 integer-valued, every value <= max_w; M 0/1, float32 or
    bfloat16.  A bf16 M is never upcast as a whole.  max_w <= 256: W is
    exact in bf16; the product accumulates in float32, and a caller asking
    for a bf16 result (the engine, whose counts are <= L <= 256) gets
    torch's bf16 matmul, exact because every partial sum is then an
    integer <= 256, cuBLAS's reduced-precision split-K reduction included.
    max_w > 256: W = 256 hi + lo, each half exact in bf16, two products
    with float32 accumulation and output, recombined in float32 (integers
    < 2^24).  A float32 M multiplies in float32, which needs TF32 off on
    CUDA (TF32 rounds W above 2048).  The result is float32 unless
    out_dtype says otherwise.

    out: a [G, P] tensor of the result's dtype to write it into (a
    captured CUDA graph's static input); the product's last operation
    writes there, through torch.mm's or torch.add's out=, with the same
    kernels as without."""
    dtype = torch.float32 if out_dtype is None else out_dtype
    if out is not None and out.dtype != dtype:
        raise ValueError(f"out is {out.dtype}, the result {dtype}")
    if M.dtype == torch.bfloat16:
        if max_w <= 256:
            Wb = W.to(torch.bfloat16)
            if dtype == torch.bfloat16:
                return torch.mm(Wb, M, out=out)
            res = _mm_f32(Wb, M)
        else:
            hi = torch.floor(W * (1.0 / 256.0))
            lo = W - hi * 256.0
            res = torch.add(_mm_f32(lo.to(torch.bfloat16), M),
                            256.0 * _mm_f32(hi.to(torch.bfloat16), M),
                            out=out if dtype == torch.float32 else None)
    else:
        if M.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("hot_matmul needs TF32 off: "
                               "torch.backends.cuda.matmul.allow_tf32 is True")
        res = torch.mm(W.to(M.dtype), M,
                       out=out if dtype == M.dtype else None)
    res = res.to(dtype)
    return res if out is None or res is out else out.copy_(res)


def _first_k_desc(vals: torch.Tensor, k: int):
    """(value desc, index asc) top-k: lax.top_k's order by a stable
    descending sort (torch.topk promises no tie order)."""
    v, i = torch.sort(vals, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def topk_dense(vals: torch.Tensor, k: int, direct_max: int = 4096):
    """Exact top-k over [G, P] with lax.top_k's (value desc, index asc)
    order (hotset.py:topk_dense); hierarchical over 128-wide tiles for
    large P: the top-k tiles by tile max hold every top-k element, and
    gathering them in ascending tile order keeps the index tie-break.
    Returns (values float32[G, k], idx int64[G, k])."""
    G, P = vals.shape
    if P <= direct_max or P % 128 or k > P // 128:
        return _first_k_desc(vals.to(torch.float32), k)
    T = P // 128
    tiles = vals.reshape(G, T, 128)
    _, ti = _first_k_desc(tiles.amax(dim=2).to(torch.float32), k)
    ti = torch.sort(ti, dim=1).values                   # row order
    cand = tiles.gather(1, ti[:, :, None].expand(G, k, 128))
    v, j = _first_k_desc(cand.reshape(G, k * 128).to(torch.float32), k)
    return v, ti.gather(1, j // 128) * 128 + j % 128


def _rank_rows(rows: torch.Tensor, tot: torch.Tensor, k: int):
    """Top-k of (tot desc, row asc) over candidates whose positive-total
    rows are distinct: lax.top_k over the row-sorted union, as one packed
    int64 key.  Returns (counts int32[G, k], rows int64[G, k]); absent
    entries are (0, ROW_SENTINEL)."""
    key = torch.where(tot > 0, (-tot.to(torch.int64) << 32) | rows, _KEY_MAX)
    ks = torch.topk(key, k, dim=1, largest=False).values
    live = ks != _KEY_MAX
    counts = torch.where(live, -(ks >> 32), 0).to(torch.int32)
    return counts, torch.where(live, ks & 0xFFFFFFFF, ROW_SENTINEL)


def _sorted_member(s_sorted: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """bool[G, m]: q[g, i] occurs in the ascending row list s_sorted[g]."""
    pos = torch.searchsorted(s_sorted.contiguous(), q.contiguous())
    pos = pos.clamp(max=s_sorted.shape[1] - 1)
    return s_sorted.gather(1, pos) == q


def merge_hot_cold(counts_hot, s_rows, cold_counts, is_start, k: int,
                   k_hot: int = 0):
    """Exact top-k of hot + cold totals via the candidate union
    (hotset.py:merge_hot_cold).  s_rows int64[G, cap] sorted cold rows
    (ROW_SENTINEL padding), cold_counts int32 RLE counts at run starts,
    is_start bool.  Every row with a cold count is a candidate with its
    exact total (cold + counts_hot at the row); every row without one that
    could rank is among the dense hot top-k_hot.  The JAX function's
    pack_w_bits only picks its sort layout; the result is the same.
    Returns (counts int32[G, k], hit_rows int64[G, k])."""
    P = counts_hot.shape[1]
    safe = s_rows.clamp(max=P - 1)
    hot_at_cold = counts_hot.gather(1, safe).to(torch.int32)
    cold_tot = torch.where(is_start, cold_counts + hot_at_cold, 0)
    hv, hi = topk_dense(counts_hot, k_hot or k)
    # a hot candidate with a cold count is already exact among the cold
    # ones: s_rows is sorted and every real row's first lane is a run start
    hot_tot = torch.where(_sorted_member(s_rows, hi) | (hv <= 0), 0,
                          hv.to(torch.int32))
    rows_u = torch.cat([torch.where(cold_tot > 0, s_rows, ROW_SENTINEL),
                        torch.where(hot_tot > 0, hi, ROW_SENTINEL)], dim=1)
    tot_u = torch.cat([cold_tot, hot_tot], dim=1)
    return _rank_rows(rows_u, tot_u, k)


def merge_hot_cold_tam(counts_hot, rows, w, k: int, pack_w_bits: int = 0,
                       k_cand: int = CAND_K, k_cold: int = 0):
    """Threshold-algorithm merge with a per-query exactness certificate
    (hotset.py:merge_hot_cold_tam, whose docstring derives it).

    counts_hot [G, P] (float32 or bfloat16, integer-valued); rows int64 /
    w int64 [G, cap] the expanded cold multiset before sorting
    (ROW_SENTINEL padding with w = 0, real entries w >= 1).  Candidates:
    H2, the top-k_cand hot rows, injected into the expansion sort with
    weight 0 so the RLE count at their run head is their exact cold count;
    C1, the top-k_cold cold rows by cold count -- over the non-injected
    rows when pack_w_bits > 0, over all rows otherwise, as the JAX
    function's two branches select them.  Returns (counts int32[G, k],
    hit_rows int64[G, k], exact bool[G])."""
    G, P = counts_hot.shape
    cap = rows.shape[1]
    # the JAX keys hold a row in 31 - bits bits (packed; its engine gates
    # on this) or 16 bits (unpacked, where P >= 2^16 would overflow)
    row_bits = 31 - pack_w_bits if pack_w_bits else 16
    if P >= 1 << row_bits:
        raise ValueError(f"merge_hot_cold_tam: P = {P} needs P < 2^{row_bits}")
    k_cold = min(k_cold or k_cand, cap)

    hv, hi = topk_dense(counts_hot, k_cand)
    hv_i = hv.to(torch.int64)
    cand = hi.clamp(max=P - 1)

    # expansion sort with the injected zero-weight candidate entries; the
    # RLE writes both rank keys: hkey over the injected heads (exactly
    # k_cand, distinct rows), ckey over the populated heads -- the
    # non-injected ones when pack_w_bits > 0
    hkey, ckey = rle_sorted(
        sort_weighted(torch.cat([rows, cand], dim=1),
                      torch.cat([w.to(torch.int64), torch.zeros_like(cand)],
                                dim=1)),
        rank_keys=True, skip_inj=bool(pack_w_bits))

    # H2: the injected heads by row asc
    hk = torch.topk(hkey, k_cand, dim=1, largest=False).values
    cand_s = hk >> 32
    cand_cold = hk & 0xFFFFFFFF
    hs = torch.sort(cand, dim=1)
    cand_tot = cand_cold + hv_i.gather(1, hs.indices)

    # C1: top-k_cold cold rows, (count desc, row asc)
    c1 = torch.topk(ckey, k_cold, dim=1, largest=False).values
    csent = c1 == _KEY_MAX
    cc = torch.where(csent, 0, -(c1 >> 32))
    rows_c = torch.where(csent, ROW_SENTINEL, c1 & 0xFFFFFFFF)
    row_c_last = rows_c[:, -1]
    hot_at_c = counts_hot.gather(1, rows_c.clamp(max=P - 1)).to(torch.int64)
    tot_c = torch.where(cc > 0, cc + hot_at_c, 0)

    # drop H2 entries already in C1 (equal totals), then the union top-k
    dup = _sorted_member(torch.sort(rows_c, dim=1).values, cand_s)
    keep_h = (cand_tot > 0) & ~dup
    u_rows = torch.cat([rows_c, torch.where(keep_h, cand_s, ROW_SENTINEL)],
                       dim=1)
    u_tot = torch.cat([tot_c, torch.where(keep_h, cand_tot, 0)], dim=1)
    top_counts, hit_rows = _rank_rows(u_rows, u_tot, k)

    # certificate (hotset.py:488-507)
    tau = top_counts[:, k - 1].to(torch.int64)
    c_bound, h_bound = cc[:, -1], hv_i[:, -1]
    bound = c_bound + h_bound
    R = torch.where(c_bound > 0, row_c_last, hi[:, -1])
    rho = hit_rows[:, k - 1]
    exact = ((tau > bound) | (bound <= 0)
             | ((tau == bound) & (tau > 0) & (rho <= R)))
    return top_counts, hit_rows, exact


def hot_lane_mask(whot: torch.Tensor, run_start: torch.Tensor) -> torch.Tensor:
    """bool[G, L]: lanes of a hot run (hotset.py:hot_lane_mask), the
    run-start mask whot > 0 forward-filled along each run by the running
    max of 2 * run_start + bit (count.py:expand_run_bitmaps)."""
    t = run_start * 2 + (whot > 0).to(run_start.dtype)
    return (torch.cummax(t, dim=1).values & 1).bool()


def hot_position_bitmaps(offs: torch.Tensor, hot_lanes: torch.Tensor,
                         hot_starts: torch.Tensor, MT: torch.Tensor,
                         hits: torch.Tensor) -> torch.Tensor:
    """bool[G, K, L]: which query positions sit in a hot run whose set
    holds each top hit (hotset.py:hot_position_bitmaps, the hot half of
    the position bitmaps).

    offs int64[G, L] slice starts, hot_lanes bool[G, L], hot_starts
    int64[H] strictly increasing, MT bf16[P_pad, H] the transposed
    membership, hits int64[G, K] (ROW_SENTINEL rows are clamped to
    P_pad - 1; the caller masks them).  The JAX function takes an einsum
    of the [G, L, H] one-hot of each lane's hot set with M's columns at
    the hits; a lane matches at most one hot set, so here that set's
    index is found by a binary search and M's entry gathered directly."""
    G, L = offs.shape
    P, H = MT.shape
    K = hits.shape[1]
    mcols = MT[hits.clamp(max=P - 1)]                      # [G, K, H]
    starts = hot_starts.to(offs.dtype)
    h = torch.searchsorted(starts, offs.contiguous()).clamp(max=H - 1)
    in_set = hot_lanes & (starts[h] == offs)
    m = mcols.gather(2, h[:, None, :].expand(G, K, L)) > 0.5
    return m & in_set[:, None, :]
