// Smith-Waterman local alignment (Gotoh affine gaps) with its traceback, for
// Hopper (sm_90a): one kernel, sw_align_kernel.
//
// Replaces kaamer_tpu/ops/swalign_pallas.py:_kernel (the Pallas anti-diagonal
// wavefront, call at :139) and _build_traceback (:166, its lockstep lax.scan
// traceback).  It maps a batch of pairs to what those two compute together:
//
//   score int32[B]        best local score (0 when no cell is positive)
//   q_ops int16[B, d_pad] the alignment path, forward: query index per
//   r_ops int16[B, d_pad] column (-1 a gap in the query) and reference index
//   n_ops int32[B]        (-1 a gap in the reference); entries past n_ops
//                         are left unwritten
//
// with the Pallas kernel's tie rules, so -aln output is byte for byte the JAX
// package's.  Per cell (i, j), 1 <= i <= qlen, 1 <= j <= rlen:
//
//   eo = H(i, j-1) - open      e = max(eo, E(i, j-1) - extend)
//   fo = H(i-1, j) - open      f = max(fo, F(i-1, j) - extend)
//   h0 = H(i-1, j-1) + mat[q[i-1], r[j-1]]
//   h  = max(h0, e, f, 0)
//   direction nibble: bits 0-1 the H origin (0 if h == 0, else 1 if h == h0,
//   else 2 if h == e, else 3), bit 2 e != eo, bit 3 f != fo
//
// (row 0 and column 0: H = 0, E = F = NEG).  The walk starts at the maximum
// cell with the lowest i, and on that row the first j (what the per-lane best
// of the Pallas kernel, strictly greater on the earliest diagonal, gives),
// and follows the H/E/F state machine of swalign_pallas.py:_traceback.
//
// Design.  One warp per pair, no block barrier after the prologue.  The
// query is striped over the 32 lanes: lane k owns rows kR+1 .. kR+R, R = 4,
// 8, ..., 64 a template parameter (4 * ceil(m_pad / 128), pad_pairs'
// 128-buckets), and keeps H and E of its rows in registers.  The lanes sweep
// the reference skewed: at step s lane k computes column j = s - k + 1, its
// R cells in order down the column.  At the start of a step __shfl_up_sync
// hands lane k the H and F of row kR at column j from lane k-1 (computed the
// step before); the diagonal H(kR, j-1) is the value received one step
// earlier.  rlen + (active lanes - 1) steps in all.  Each cell is two of
// Hopper's DPX instructions on the chains (__viaddmax_s32 for e and f, then
// __vimax3_s32_relu for h), in int32 (NEG = -1e8 does not fit 16-bit
// lanes).  Query rows past qlen score a pad row of the matrix, so low that
// they never reach a valid row's maximum and need no mask.  The start cell
// is the warp's maximum of key = h << 11 | (2047 - (i - 1)): the largest h,
// then the lowest i, and per lane the first column reaching that key.
//
// The directions never leave the chip where they fit: 8 nibbles a 32-bit
// word, stored step-major as [step][word][lane] (each store one conflict-free
// 128-byte row), ceil(R/8) words a lane a step: 36 KB a pair at
// m ~ n ~ 250.  Where the words of the warps a block gets fit in its shared
// memory, they stay there, several pairs (warps) a block; otherwise they go
// to a global scratch buffer the wrapper allocates, so that every pair of
// the batch is resident at once.  After the sweep the same warp walks its own
// nibbles (the first port followed one byte a hop through a 33 MB device
// array, about 0.5 us a hop); lane n % 32 keeps step n of the path, the warp
// writes 32 steps at a time, and it reverses the path in place at the end.
//
// Bound: operations.  About 17 int32 operations a cell of the recurrence,
// sum over pairs of qlen * rlen cells; the inputs and outputs are a few
// hundred KB.  The kernel issues about 25 instructions a cell, and with one
// warp a pair a batch of 256 pairs puts two warps on an SM, one on each of
// two of its four schedulers: a warp issues alone, so the sweep runs at one
// warp's issue rate and not at the card's int32 rate.  The design spends no
// instruction it can avoid in the cell (DPX max-of-add, one key max for the
// start, one shared-memory load for the substitution) and keeps every pair
// of a batch resident.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

#define SW_NEG (-100000000)
#define SW_ALPHA 24
// score of the pad row (query rows past qlen): low enough that no such row
// ever reaches a valid row's score (see the start-cell key below)
#define SW_PAD_SCORE (-(1 << 20))
#define SW_MAT_WORDS ((SW_ALPHA + 1) * SW_ALPHA)
#define SW_FULL 0xffffffffu
#define SW_MAX_WARPS 8
#define SW_MAX_DEVICES 64

// words of direction nibbles one lane stores per step
__host__ __device__ constexpr int sw_words(int R) { return (R + 7) / 8; }
// 32-bit words of direction nibbles one pair needs: rlen + 31 steps at most
__host__ __device__ constexpr int sw_pair_words(int R, int n_pad) {
  return (n_pad + 31) * sw_words(R) * 32;
}
// bytes of one warp's staged reference codes (16-byte multiple)
__host__ __device__ constexpr int sw_r_stride(int n_pad) {
  return (n_pad + 15) & ~15;
}

template <int R, bool kShared>
__global__ void __launch_bounds__(SW_MAX_WARPS * 32)
sw_align_kernel(const uint8_t* __restrict__ qcodes,
                const uint8_t* __restrict__ rcodes,
                const int* __restrict__ qlens, const int* __restrict__ rlens,
                const int* __restrict__ mat, int B, int m_pad, int n_pad,
                int d_pad, int gap_open, int gap_extend,
                uint32_t* __restrict__ dirs_global,
                int* __restrict__ score_out, int16_t* __restrict__ q_ops,
                int16_t* __restrict__ r_ops, int* __restrict__ n_ops) {
  constexpr int NW = sw_words(R);
  constexpr int NQ = (R + 3) / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  // the substitution matrix, plus a pad row for query rows past qlen
  int* s_mat = reinterpret_cast<int*>(smem);
  for (int x = threadIdx.x; x < SW_MAT_WORDS; x += blockDim.x)
    s_mat[x] = x < SW_ALPHA * SW_ALPHA ? mat[x] : SW_PAD_SCORE;
  __syncthreads();

  const int b = blockIdx.x * wpb + warp;
  if (b >= B) return;
  const int r_stride = sw_r_stride(n_pad);
  const int pair_words = sw_pair_words(R, n_pad);
  unsigned char* s_r = smem + SW_MAT_WORDS * 4 + warp * r_stride;
  uint32_t* dirs;
  if constexpr (kShared)
    dirs = reinterpret_cast<uint32_t*>(smem + SW_MAT_WORDS * 4 +
                                       wpb * r_stride) +
           warp * pair_words;
  else
    dirs = dirs_global + (size_t)b * pair_words;
  const int qlen = qlens[b];
  const int rlen = rlens[b];
  const uint8_t* rb = rcodes + (size_t)b * n_pad;
  for (int x = lane; x < rlen; x += 32) s_r[x] = rb[x];

  // the lane's query codes, 4 a word; rows past qlen take the pad row
  const int row0 = lane * R;  // rows row0 + 1 .. row0 + R
  const uint8_t* qb = qcodes + (size_t)b * m_pad;
  uint32_t qp[NQ];
#pragma unroll
  for (int w = 0; w < NQ; ++w) qp[w] = 0;
#pragma unroll
  for (int t = 0; t < R; ++t)
    qp[t >> 2] |= (uint32_t)(row0 + t < qlen ? qb[row0 + t] : SW_ALPHA)
                  << ((t & 3) * 8);
  __syncwarp();

  int H[R], E[R];  // of the lane's rows at the last column done
#pragma unroll
  for (int t = 0; t < R; ++t) {
    H[t] = 0;
    E[t] = SW_NEG;
  }
  int out_h = 0, out_f = SW_NEG;  // H, F of row row0 + R, last column done
  int diag_in = 0;                // H(row0, j - 1) for the coming step
  // start cell: the running maximum of key = h << 11 | (2047 - (i - 1)),
  // so the largest h wins and, among equal h, the lowest i; a later column
  // never replaces an equal key (the first j of that row)
  int bkey = -1, bj = 0;
  const int kc = 2047 - row0;
  const int n_lanes = qlen > 0 ? (qlen + R - 1) / R : 1;
  const int n_steps = rlen + n_lanes - 1;
  const int r_last = rlen > 0 ? rlen - 1 : 0;
  int r_nxt = s_r[min(max(-lane, 0), r_last)];  // code of column 1 - lane
  for (int s = 0; s < n_steps; ++s) {
    const int j = s - lane + 1;
    // this step's reference code; load the next step's now
    const int r_cur = r_nxt;
    r_nxt = s_r[min(max(j, 0), r_last)];
    int up_h = __shfl_up_sync(SW_FULL, out_h, 1);
    int up_f = __shfl_up_sync(SW_FULL, out_f, 1);
    if (lane == 0) {
      up_h = 0;
      up_f = SW_NEG;
    }
    int diag = diag_in;
    diag_in = up_h;
    if (j >= 1 && j <= rlen) {
      const int* mrow = s_mat + r_cur;
      uint32_t word[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) word[w] = 0;
      int kmax = -1;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const int h0 =
            diag + mrow[((qp[t >> 2] >> ((t & 3) * 8)) & 0xff) * SW_ALPHA];
        // the chain down the column is h -> f -> h: one max-of-add and one
        // 3-way max a row (eo and fo feed only the direction bits)
        const int eo = H[t] - gap_open;
        const int e = __viaddmax_s32(H[t], -gap_open, E[t] - gap_extend);
        const int fo = up_h - gap_open;
        const int f = __viaddmax_s32(up_h, -gap_open, up_f - gap_extend);
        const int h = __vimax3_s32_relu(h0, e, f);
        const uint32_t hdir = h == 0 ? 0u : h == h0 ? 1u : h == e ? 2u : 3u;
        word[t >> 3] |= (hdir | ((uint32_t)(e != eo) << 2) |
                         ((uint32_t)(f != fo) << 3))
                        << ((t & 7) * 4);
        kmax = max(kmax, (h << 11) + (kc - t));
        diag = H[t];
        H[t] = h;
        E[t] = e;
        up_h = h;
        up_f = f;
      }
      if (kmax > bkey) {
        bkey = kmax;
        bj = j;
      }
      out_h = up_h;
      out_f = up_f;
#pragma unroll
      for (int w = 0; w < NW; ++w) dirs[(s * NW + w) * 32 + lane] = word[w];
    }
  }

  const int key = __reduce_max_sync(SW_FULL, bkey);
  const int score = key > 0 ? key >> 11 : 0;
  int i = score > 0 ? 2048 - (key & 2047) : 0;
  int j = __shfl_sync(SW_FULL, bj, score > 0 ? (i - 1) / R : 0);
  __syncwarp();  // the lanes' direction stores before the walk reads them

  // the walk, from the end backwards: every lane walks the same cells, and
  // lane n % 32 keeps op n until the warp writes 32 at once
  int16_t* qo = q_ops + (size_t)b * d_pad;
  int16_t* ro = r_ops + (size_t)b * d_pad;
  int n = 0, st = 0;  // st: 0 H, 1 E, 2 F
  int my_q = 0, my_r = 0;
  while (i > 0 && j > 0) {
    const int k = (i - 1) / R;
    const int t = (i - 1) - k * R;
    const uint32_t nib =
        (dirs[((j - 1 + k) * NW + (t >> 3)) * 32 + k] >> ((t & 7) * 4)) & 15u;
    // in H, origin E or F moves to that state on this same cell
    int mode = st;  // 0 diagonal, 1 E (gap in the query), 2 F
    if (st == 0) {
      if ((nib & 3u) == 0) break;
      mode = (int)(nib & 3u) - 1;
    }
    int qv = i - 1, rv = j - 1;
    if (mode == 0) {
      --i;
      --j;
    } else if (mode == 1) {
      qv = -1;
      st = (nib & 4u) ? 1 : 0;
      --j;
    } else {
      rv = -1;
      st = (nib & 8u) ? 2 : 0;
      --i;
    }
    if (lane == (n & 31)) {
      my_q = qv;
      my_r = rv;
    }
    if ((++n & 31) == 0) {
      qo[n - 32 + lane] = (int16_t)my_q;
      ro[n - 32 + lane] = (int16_t)my_r;
    }
  }
  if (lane < (n & 31)) {
    qo[(n & ~31) + lane] = (int16_t)my_q;
    ro[(n & ~31) + lane] = (int16_t)my_r;
  }
  __syncwarp();  // the path before the lanes reverse it
  for (int x = lane; x < n / 2; x += 32) {
    const int16_t tq = qo[x], tr = ro[x];
    qo[x] = qo[n - 1 - x];
    ro[x] = ro[n - 1 - x];
    qo[n - 1 - x] = tq;
    ro[n - 1 - x] = tr;
  }
  if (lane == 0) {
    score_out[b] = score;
    n_ops[b] = n;
  }
}

namespace {

// What a plan needs of its device, read once per device: its SMs and the
// most dynamic shared memory a block may opt in to.
struct SwDevice {
  int sms;
  int smem_optin;
};

cudaError_t sw_device(SwDevice* out) {
  static SwDevice devs[SW_MAX_DEVICES];
  static std::atomic<bool> ready[SW_MAX_DEVICES];
  static std::mutex mu;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= SW_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[dev].load(std::memory_order_relaxed)) {
      SwDevice d;
      err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
      if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(
            &d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      }
      if (err != cudaSuccess) return err;  // the next call tries again
      devs[dev] = d;
      ready[dev].store(true, std::memory_order_release);
    }
  }
  *out = devs[dev];
  return cudaSuccess;
}

// Raises one instantiation's dynamic shared-memory limit to the device's
// opt-in maximum: once per device, not per launch (the kernel has no static
// shared memory).
template <int R, bool kShared>
cudaError_t sw_raise_smem_limit(int smem_optin) {
  static std::atomic<bool> done[SW_MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= SW_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(sw_align_kernel<R, kShared>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_optin);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

template <int R, bool kShared>
int sw_align_launch(const void* qcodes, const void* rcodes, const void* qlens,
                    const void* rlens, const void* mat, int B, int m_pad,
                    int n_pad, int d_pad, int gap_open, int gap_extend,
                    int warps, void* dirs, void* score, void* q_ops,
                    void* r_ops, void* n_ops, cudaStream_t stream) {
  const size_t smem =
      SW_MAT_WORDS * 4 + (size_t)warps * sw_r_stride(n_pad) +
      (kShared ? (size_t)warps * sw_pair_words(R, n_pad) * 4 : 0);
  SwDevice d;
  cudaError_t err = sw_device(&d);
  if (err == cudaSuccess) err = sw_raise_smem_limit<R, kShared>(d.smem_optin);
  if (err != cudaSuccess) return (int)err;
  sw_align_kernel<R, kShared><<<(B + warps - 1) / warps, warps * 32, smem,
                                stream>>>(
      (const uint8_t*)qcodes, (const uint8_t*)rcodes, (const int*)qlens,
      (const int*)rlens, (const int*)mat, B, m_pad, n_pad, d_pad, gap_open,
      gap_extend, (uint32_t*)dirs, (int*)score, (int16_t*)q_ops,
      (int16_t*)r_ops, (int*)n_ops);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of direction words one pair needs for rows_per_lane R (the global
// scratch size per pair when they do not fit in shared memory).
long long kt_sw_align_pair_bytes(int R, int n_pad) {
  return (long long)sw_pair_words(R, n_pad) * 4;
}

// How a batch of B pairs is laid out on the current device: *warps pairs
// (warps) a block, as many as spread the pairs evenly over the SMs, up to
// SW_MAX_WARPS; *use_smem 1 (the direction words in shared memory) where
// a block of that many fits in the shared memory a block may opt in to,
// so that every pair runs at once, else 0 (the global scratch).  Returns
// a cudaError_t.
int kt_sw_align_plan(int R, int B, int n_pad, int* warps, int* use_smem) {
  SwDevice d;
  const cudaError_t err = sw_device(&d);
  if (err != cudaSuccess) return (int)err;
  int want = (B + d.sms - 1) / d.sms;
  want = want < 1 ? 1 : want > SW_MAX_WARPS ? SW_MAX_WARPS : want;
  *warps = want;
  const long long per_warp =
      kt_sw_align_pair_bytes(R, n_pad) + sw_r_stride(n_pad);
  *use_smem = SW_MAT_WORDS * 4 + want * per_warp <= d.smem_optin;
  return 0;
}

int kt_sw_align(const void* qcodes, const void* rcodes, const void* qlens,
                const void* rlens, const void* mat, int B, int m_pad,
                int n_pad, int d_pad, int rows_per_lane, int gap_open,
                int gap_extend, int use_smem, int warps, void* dirs,
                void* score, void* q_ops, void* r_ops, void* n_ops,
                void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define SW_CASE(R)                                                            \
  case R:                                                                     \
    return use_smem                                                           \
               ? sw_align_launch<R, true>(qcodes, rcodes, qlens, rlens, mat, \
                                          B, m_pad, n_pad, d_pad, gap_open,  \
                                          gap_extend, warps, dirs, score,    \
                                          q_ops, r_ops, n_ops, st)           \
               : sw_align_launch<R, false>(qcodes, rcodes, qlens, rlens,     \
                                           mat, B, m_pad, n_pad, d_pad,      \
                                           gap_open, gap_extend, warps,      \
                                           dirs, score, q_ops, r_ops, n_ops, \
                                           st);
  switch (rows_per_lane) {
    SW_CASE(4) SW_CASE(8) SW_CASE(12) SW_CASE(16) SW_CASE(20) SW_CASE(24)
    SW_CASE(28) SW_CASE(32) SW_CASE(36) SW_CASE(40) SW_CASE(44) SW_CASE(48)
    SW_CASE(52) SW_CASE(56) SW_CASE(60) SW_CASE(64)
  }
#undef SW_CASE
  return (int)cudaErrorInvalidValue;
}

const char* kt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
