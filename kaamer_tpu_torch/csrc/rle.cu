// Weighted run-length count of sorted packed keys, for Hopper (sm_90a): one
// kernel, rle_sorted_kernel.
//
// Replaces no Pallas kernel.  The JAX package counts a phase-2 chunk's hits
// with XLA's sort and scans (kaamer_tpu/ops/count.py:sort_rle and the
// injection sort of ops/hotset.py:merge_hot_cold_tam); the port first wrote
// that count as torch operations (ops/count.py:rle_sorted_plain, the plain
// version kept beside this kernel): a cumsum and a reversed cummin over the
// whole [G, n] int64 array of every chunk, with some twenty elementwise
// passes around them.  torch scans a few very long rows with a few blocks,
// and at 1M proteins those two scans took more of the card's time than any
// other operation of the served path.
//
// Input: ks int64[G, n], each row sorted ascending, a real entry's key
// (row << 32) | w (row < 2^31 - 1, w its weight), INT64_MAX past the real
// entries.  In one read of the keys it writes, per entry
//
//   s         int64  the row, or ROW_SENTINEL (0xFFFFFFFF) for INT64_MAX
//   counts    int32  the run's weight sum at its head lane, 0 elsewhere
//   is_start  bool   the head lane of a run of real rows
//   inj       bool   a head whose own weight is 0 (merge_hot_cold_tam's
//                    injected candidates, first in their runs by key order)
//
// or, in the rank-key mode (keys = 1), merge_hot_cold_tam's two rank keys
// from the same registers instead:
//
//   hkey  int64  (s << 32) | count at an inj head, else INT64_MAX
//   ckey  int64  (-count << 32) | s at a head with count > 0 (and not inj
//                when skip_inj), else INT64_MAX
//
// A run ends at the next entry whose row differs or at the end of its row
// of n: runs never cross rows.
//
// Bound: bytes.  8 bytes read and 14 written an entry (16 in the rank-key
// mode), against about 200 for the torch chain.  The design keeps every
// byte to one read and one write:
//
// - One warp walks a contiguous stretch of the flattened G * n array, so
//   the grid follows the array's size, not its rows: G = 16 rows of 2^20
//   entries and G = 2048 rows of 64 fill the SMs alike.  Each lane holds 8
//   consecutive entries a step (four 16-byte loads), a step 256 entries,
//   and the warp walks its steps from right to left.
// - A step's run sums are a segmented suffix sum: a lane adds its entries
//   up to its first head; a reversed segmented scan over the lanes
//   (__shfl_down_sync, five rounds) gives each lane the weight of the run
//   that continues from its right neighbour; the sum that leaves the
//   step's left edge is carried to the next step in a register.
// - The run that crosses the warp's right edge is finished by the same
//   warp before its first step: it reads forward 32 entries at a time
//   until the row changes (a run is at most one entry a query lane plus
//   one injected entry, so one read of 32 is the common case, and a run of
//   the sentinel is never followed).  The warp that holds a run's head
//   writes its count; a non-head lane writes 0, so no warp waits for
//   another.
// - Nothing is allocated here: the wrapper allocates the outputs.  The
//   launch goes on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#define RLE_V 8                // entries a lane a step
#define RLE_STEP (32 * RLE_V)  // entries a warp step
#define RLE_WARPS 8            // warps a block
#define RLE_WARPS_PER_SM 32    // warps the grid aims to keep on an SM
#define RLE_FULL 0xffffffffu
#define RLE_KEY_SENT 0x7fffffffffffffffLL
#define RLE_ROW_SENT 0xffffffffu

__device__ __forceinline__ unsigned rle_row(long long k) {
  return k == RLE_KEY_SENT ? RLE_ROW_SENT : (unsigned)(k >> 32);
}

template <bool kKeys>
__global__ void __launch_bounds__(RLE_WARPS * 32)
rle_sorted_kernel(const long long* __restrict__ ks, long long total, int n,
                  int steps, int skip_inj, long long* __restrict__ out_a,
                  void* __restrict__ out_b, uint8_t* __restrict__ out_start,
                  uint8_t* __restrict__ out_inj) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * RLE_WARPS + (threadIdx.x >> 5);
  const long long begin = warp * steps * RLE_STEP;
  if (begin >= total) return;
  const long long end =
      begin + (long long)steps * RLE_STEP < total
          ? begin + (long long)steps * RLE_STEP : total;

  // the weight of the run of entry end - 1 past the warp's stretch
  unsigned carry = 0;
  if (end < total) {
    const long long k_last = ks[end - 1];
    if (k_last != RLE_KEY_SENT) {
      const long long row_end = ((end - 1) / n + 1) * n;
      for (long long e0 = end; e0 < row_end; e0 += 32) {
        const long long e = e0 + lane;
        bool same = false;
        unsigned w = 0;
        if (e < row_end) {
          const long long k = ks[e];
          same = k != RLE_KEY_SENT && (k >> 32) == (k_last >> 32);
          w = same ? (unsigned)k : 0u;
        }
        carry += __reduce_add_sync(RLE_FULL, w);
        if (__ballot_sync(RLE_FULL, same) != RLE_FULL) break;
      }
    }
  }

  const long long n_steps = (end - begin + RLE_STEP - 1) / RLE_STEP;
  for (long long st = n_steps - 1; st >= 0; --st) {
    const long long base = begin + st * RLE_STEP;
    const long long i0 = base + lane * RLE_V;
    const bool whole = i0 + RLE_V <= total;
    long long k[RLE_V];
    if (whole) {
      const longlong2* p = reinterpret_cast<const longlong2*>(ks + i0);
#pragma unroll
      for (int v = 0; v < RLE_V / 2; ++v) {
        const longlong2 x = p[v];
        k[2 * v] = x.x;
        k[2 * v + 1] = x.y;
      }
    } else {
#pragma unroll
      for (int t = 0; t < RLE_V; ++t)
        k[t] = i0 + t < total ? ks[i0 + t] : RLE_KEY_SENT;
    }
    unsigned s[RLE_V], w[RLE_V];
#pragma unroll
    for (int t = 0; t < RLE_V; ++t) {
      const bool sent = k[t] == RLE_KEY_SENT;
      s[t] = sent ? RLE_ROW_SENT : (unsigned)(k[t] >> 32);
      w[t] = sent ? 0u : (unsigned)k[t];
    }
    unsigned s_prev = __shfl_up_sync(RLE_FULL, s[RLE_V - 1], 1);
    if (lane == 0) s_prev = base > 0 ? rle_row(ks[base - 1]) : RLE_ROW_SENT;

    // head flags: a row start (entry % n == 0) or a change of row value
    unsigned j = (unsigned)i0 % (unsigned)n;
    unsigned head = 0;
#pragma unroll
    for (int t = 0; t < RLE_V; ++t) {
      if (j == 0 || s[t] != (t ? s[t - 1] : s_prev)) head |= 1u << t;
      j = j + 1 == (unsigned)n ? 0u : j + 1;
    }

    // x: the weight from this lane's first entry up to the first head at
    // or right of it (the lanes' reversed segmented scan), plus the carry
    // where no head closes the run inside the step
    const int first = head ? __ffs(head) - 1 : RLE_V;
    unsigned x = 0;
#pragma unroll
    for (int t = 0; t < RLE_V; ++t) x += t < first ? w[t] : 0u;
    bool closed = head != 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned x2 = __shfl_down_sync(RLE_FULL, x, off);
      const bool c2 = __shfl_down_sync(RLE_FULL, (int)closed, off) != 0;
      if (lane + off < 32 && !closed) {
        x += x2;
        closed = c2;
      }
    }
    if (!closed) x += carry;
    unsigned acc = __shfl_down_sync(RLE_FULL, x, 1);
    if (lane == 31) acc = carry;
    carry = __shfl_sync(RLE_FULL, x, 0);

    // run sums at the heads, right to left within the lane
    unsigned c[RLE_V];
    bool start[RLE_V], inj[RLE_V];
#pragma unroll
    for (int t = RLE_V - 1; t >= 0; --t) {
      acc += w[t];
      const bool h = (head >> t) & 1u;
      start[t] = h && s[t] != RLE_ROW_SENT;
      inj[t] = start[t] && w[t] == 0;
      c[t] = start[t] ? acc : 0u;
      if (h) acc = 0;
    }

    if constexpr (kKeys) {
      long long hk[RLE_V], ck[RLE_V];
#pragma unroll
      for (int t = 0; t < RLE_V; ++t) {
        hk[t] = inj[t] ? (long long)(((unsigned long long)s[t] << 32) | c[t])
                       : RLE_KEY_SENT;
        const bool pop = start[t] && c[t] > 0 && !(skip_inj && inj[t]);
        ck[t] = pop ? (long long)(((unsigned long long)(-(long long)c[t])
                                   << 32) | s[t])
                    : RLE_KEY_SENT;
      }
      long long* ckeys = static_cast<long long*>(out_b);
      if (whole) {
        longlong2* ph = reinterpret_cast<longlong2*>(out_a + i0);
        longlong2* pc = reinterpret_cast<longlong2*>(ckeys + i0);
#pragma unroll
        for (int v = 0; v < RLE_V / 2; ++v) {
          ph[v] = make_longlong2(hk[2 * v], hk[2 * v + 1]);
          pc[v] = make_longlong2(ck[2 * v], ck[2 * v + 1]);
        }
      } else {
#pragma unroll
        for (int t = 0; t < RLE_V; ++t)
          if (i0 + t < total) {
            out_a[i0 + t] = hk[t];
            ckeys[i0 + t] = ck[t];
          }
      }
    } else {
      int* counts = static_cast<int*>(out_b);
      if (whole) {
        longlong2* ps = reinterpret_cast<longlong2*>(out_a + i0);
#pragma unroll
        for (int v = 0; v < RLE_V / 2; ++v)
          ps[v] = make_longlong2(s[2 * v], s[2 * v + 1]);
        int4* pc = reinterpret_cast<int4*>(counts + i0);
        pc[0] = make_int4(c[0], c[1], c[2], c[3]);
        pc[1] = make_int4(c[4], c[5], c[6], c[7]);
        uint2 fs = make_uint2(0, 0), fi = make_uint2(0, 0);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          fs.x |= (unsigned)start[t] << (8 * t);
          fs.y |= (unsigned)start[t + 4] << (8 * t);
          fi.x |= (unsigned)inj[t] << (8 * t);
          fi.y |= (unsigned)inj[t + 4] << (8 * t);
        }
        *reinterpret_cast<uint2*>(out_start + i0) = fs;
        *reinterpret_cast<uint2*>(out_inj + i0) = fi;
      } else {
#pragma unroll
        for (int t = 0; t < RLE_V; ++t)
          if (i0 + t < total) {
            out_a[i0 + t] = s[t];
            counts[i0 + t] = (int)c[t];
            out_start[i0 + t] = start[t];
            out_inj[i0 + t] = inj[t];
          }
      }
    }
  }
}

extern "C" {

// The run-length count of ks int64[total / n, n] (module comment).  keys 0
// writes s int64, counts int32, is_start and inj (bool) to a, b, start and
// inj; keys 1 writes hkey and ckey (int64) to a and b, and start and inj
// are unused.  Every pointer 16-byte aligned, total < 2^31.  Returns a
// cudaError_t.
int kt_rle_sorted(const void* ks, long long total, int n, int keys,
                  int skip_inj, void* a, void* b, void* start, void* inj,
                  void* stream) {
  if (total <= 0) return 0;
  if (n <= 0 || total % n != 0 || total >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // as few steps a warp as keep RLE_WARPS_PER_SM warps on every SM
  const long long steps_total = (total + RLE_STEP - 1) / RLE_STEP;
  const long long want = (long long)sms * RLE_WARPS_PER_SM;
  const int steps = (int)((steps_total + want - 1) / want);
  const long long warps = (steps_total + steps - 1) / steps;
  const unsigned blocks = (unsigned)((warps + RLE_WARPS - 1) / RLE_WARPS);
  const cudaStream_t st = (cudaStream_t)stream;
  const long long* k = static_cast<const long long*>(ks);
  long long* out_a = static_cast<long long*>(a);
  uint8_t* s8 = static_cast<uint8_t*>(start);
  uint8_t* i8 = static_cast<uint8_t*>(inj);
  if (keys)
    rle_sorted_kernel<true><<<blocks, RLE_WARPS * 32, 0, st>>>(
        k, total, n, steps, skip_inj, out_a, b, s8, i8);
  else
    rle_sorted_kernel<false><<<blocks, RLE_WARPS * 32, 0, st>>>(
        k, total, n, steps, skip_inj, out_a, b, s8, i8);
  return (int)cudaGetLastError();
}

}  // extern "C"
