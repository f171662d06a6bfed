// Smith-Waterman local alignment (Gotoh affine gaps) for Hopper (sm_90a).
//
// Replaces kaamer_tpu/ops/swalign_pallas.py:_kernel (the Pallas anti-diagonal
// wavefront) and _build_traceback (its lockstep lax.scan traceback).  Both
// kernels keep the Pallas kernel's contract byte for byte:
//
//   dirs uint8[B, d_pad, W]  per cell (i, j) at [b, i + j, i]:
//                            bits 0-1 H origin (0 stop, 1 diag, 2 E, 3 F),
//                            bit 2 E continued from E, bit 3 F from F
//   best int32[B, 2, W]      per query lane i: best H on that lane and the
//                            first diagonal reaching it
//
// W = m_pad + 1 and d_pad = ceil8(m_pad + n_pad + 1), as the JAX package
// lays them out.  Only valid cells (1 <= i <= qlen, 1 <= j <= rlen) of dirs
// and lanes 0..qlen of best are written: the traceback reads nothing else.
//
// Design.  One thread block per pair.  The block loads the pair's residue
// codes and the 24x24 substitution matrix into shared memory and reads
// mat[q[i-1], r[j-1]] there, so the TPU version's [B, d_pad, W] skewed
// substitution tensor (one-hot einsum + skew, _build_full) never exists.
// Threads stride over query lanes; diagonals d-1 and d-2 of H and d-1 of E
// and F live in rotating shared-memory rows, one __syncthreads() per
// diagonal.  Per-lane best scores stay in registers until the end.
//
// Bounds on this card: the kernel is latency-bound by its qlen + rlen
// sequential diagonals (one block-wide barrier each) and, for long pairs,
// by the dirs write (about qlen * rlen bytes per pair).  Making it fast
// (a warp per pair for short queries, packed int16 lanes, fewer barriers)
// is later work.
//
// sw_traceback: one thread per pair walks the direction bytes from the
// first lane holding the maximum best (lowest i), with the H/E/F state
// machine of the host walk (swalign_pallas.py:_traceback), and writes the
// alignment path forward as int16 op lists plus its length.  Only these
// small arrays travel back to the host.

#include <cuda_runtime.h>
#include <stdint.h>

#define SW_NEG (-100000000)
#define SW_THREADS 256
// lanes per thread: 256 * 9 = 2304 lanes cover W up to 2304 (m_pad <= 2303)
#define SW_LPT 9
#define SW_ALPHA 24

__global__ void __launch_bounds__(SW_THREADS)
sw_wavefront_kernel(const uint8_t* __restrict__ qcodes,
                    const uint8_t* __restrict__ rcodes,
                    const int* __restrict__ qlens,
                    const int* __restrict__ rlens,
                    const int* __restrict__ mat,
                    int m_pad, int n_pad, int d_pad,
                    int gap_open, int gap_extend,
                    uint8_t* __restrict__ dirs, int* __restrict__ best) {
  const int W = m_pad + 1;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int qlen = qlens[b];
  const int rlen = rlens[b];

  extern __shared__ int smem[];
  int* s_mat = smem;                          // [24 * 24]
  int* hbuf = s_mat + SW_ALPHA * SW_ALPHA;    // 3 rows of W: H on d, d-1, d-2
  int* ebuf = hbuf + 3 * W;                   // 2 rows: E on d, d-1
  int* fbuf = ebuf + 2 * W;                   // 2 rows: F on d, d-1
  uint8_t* s_q = reinterpret_cast<uint8_t*>(fbuf + 2 * W);  // [m_pad]
  uint8_t* s_r = s_q + m_pad;                               // [n_pad]

  for (int x = t; x < SW_ALPHA * SW_ALPHA; x += SW_THREADS) s_mat[x] = mat[x];
  const uint8_t* qb = qcodes + (size_t)b * m_pad;
  const uint8_t* rb = rcodes + (size_t)b * n_pad;
  for (int x = t; x < qlen; x += SW_THREADS) s_q[x] = qb[x];
  for (int x = t; x < rlen; x += SW_THREADS) s_r[x] = rb[x];
  // diagonals 0 and 1 hold no valid cell: H = 0, E = F = NEG
  for (int x = t; x <= qlen; x += SW_THREADS) {
    hbuf[x] = 0;
    hbuf[W + x] = 0;
    hbuf[2 * W + x] = 0;
    ebuf[x] = SW_NEG;
    ebuf[W + x] = SW_NEG;
    fbuf[x] = SW_NEG;
    fbuf[W + x] = SW_NEG;
  }
  __syncthreads();

  int bv[SW_LPT];
  int bd[SW_LPT];
#pragma unroll
  for (int k = 0; k < SW_LPT; ++k) {
    bv[k] = 0;
    bd[k] = 0;
  }

  uint8_t* dirs_b = dirs + (size_t)b * d_pad * W;
  const int d_end = qlen + rlen;  // last diagonal holding a valid cell
  for (int d = 2; d <= d_end; ++d) {
    int* hc = hbuf + (d % 3) * W;
    const int* h1 = hbuf + ((d + 2) % 3) * W;  // diagonal d-1
    const int* h2 = hbuf + ((d + 1) % 3) * W;  // diagonal d-2
    int* ec = ebuf + (d & 1) * W;
    const int* e1 = ebuf + ((d + 1) & 1) * W;
    int* fc = fbuf + (d & 1) * W;
    const int* f1 = fbuf + ((d + 1) & 1) * W;
#pragma unroll
    for (int k = 0; k < SW_LPT; ++k) {
      const int i = t + k * SW_THREADS;
      if (i <= qlen) {
        const int j = d - i;
        int h = 0, e = SW_NEG, f = SW_NEG;
        if (i >= 1 && j >= 1 && j <= rlen) {
          const int eo = h1[i] - gap_open;      // H(i, j-1) - open
          const int fo = h1[i - 1] - gap_open;  // H(i-1, j) - open
          e = max(eo, e1[i] - gap_extend);
          f = max(fo, f1[i - 1] - gap_extend);
          const int h0 = h2[i - 1] + s_mat[s_q[i - 1] * SW_ALPHA + s_r[j - 1]];
          h = max(max(0, h0), max(e, f));
          const int hdir = (h == 0) ? 0 : (h == h0) ? 1 : (h == e) ? 2 : 3;
          dirs_b[(size_t)d * W + i] =
              (uint8_t)(hdir | ((e != eo) << 2) | ((f != fo) << 3));
          if (h > bv[k]) {  // strictly greater: the earliest diagonal wins
            bv[k] = h;
            bd[k] = d;
          }
        }
        hc[i] = h;
        ec[i] = e;
        fc[i] = f;
      }
    }
    __syncthreads();
  }

  int* best_b = best + (size_t)b * 2 * W;
#pragma unroll
  for (int k = 0; k < SW_LPT; ++k) {
    const int i = t + k * SW_THREADS;
    if (i <= qlen) {
      best_b[i] = bv[k];
      best_b[W + i] = bd[k];
    }
  }
}

__global__ void sw_traceback_kernel(const uint8_t* __restrict__ dirs,
                                    const int* __restrict__ best,
                                    const int* __restrict__ qlens,
                                    int B, int d_pad, int W,
                                    int* __restrict__ score_out,
                                    int16_t* __restrict__ q_ops,
                                    int16_t* __restrict__ r_ops,
                                    int* __restrict__ n_ops) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int qlen = qlens[b];
  const int* bv = best + (size_t)b * 2 * W;
  const int* bd = bv + W;
  int score = -1, i = 0;
  for (int x = 0; x <= qlen; ++x) {
    if (bv[x] > score) {  // first maximum: lowest i
      score = bv[x];
      i = x;
    }
  }
  int j = bd[i] - i;
  const uint8_t* db = dirs + (size_t)b * d_pad * W;
  int16_t* qo = q_ops + (size_t)b * d_pad;
  int16_t* ro = r_ops + (size_t)b * d_pad;
  int n = 0;
  int st = 0;  // 0 H, 1 E, 2 F
  if (score > 0) {
    while (i > 0 && j > 0) {
      const int byte = db[(size_t)(i + j) * W + i];
      if (st == 0) {
        const int hdir = byte & 3;
        if (hdir == 0) break;
        if (hdir == 1) {
          qo[n] = (int16_t)(i - 1);
          ro[n] = (int16_t)(j - 1);
          ++n;
          --i;
          --j;
        } else {
          st = (hdir == 2) ? 1 : 2;
        }
      } else if (st == 1) {
        qo[n] = -1;
        ro[n] = (int16_t)(j - 1);
        ++n;
        if (!(byte & 4)) st = 0;
        --j;
      } else {
        qo[n] = (int16_t)(i - 1);
        ro[n] = -1;
        ++n;
        if (!(byte & 8)) st = 0;
        --i;
      }
    }
  }
  // the walk runs from the alignment end backwards: reverse in place
  for (int x = 0; x < n / 2; ++x) {
    const int16_t tq = qo[x], tr = ro[x];
    qo[x] = qo[n - 1 - x];
    ro[x] = ro[n - 1 - x];
    qo[n - 1 - x] = tq;
    ro[n - 1 - x] = tr;
  }
  score_out[b] = score;
  n_ops[b] = n;
}

static size_t sw_wavefront_smem(int m_pad, int n_pad) {
  const int W = m_pad + 1;
  return sizeof(int) * (SW_ALPHA * SW_ALPHA + 7 * W) + (size_t)m_pad +
         (size_t)n_pad;
}

extern "C" {

int kt_sw_wavefront(const void* qcodes, const void* rcodes, const void* qlens,
                    const void* rlens, const void* mat, int B, int m_pad,
                    int n_pad, int d_pad, int gap_open, int gap_extend,
                    void* dirs, void* best, void* stream) {
  const size_t smem = sw_wavefront_smem(m_pad, n_pad);
  cudaError_t err = cudaFuncSetAttribute(
      sw_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    sw_wavefront_kernel<<<B, SW_THREADS, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)qcodes, (const uint8_t*)rcodes, (const int*)qlens,
        (const int*)rlens, (const int*)mat, m_pad, n_pad, d_pad, gap_open,
        gap_extend, (uint8_t*)dirs, (int*)best);
  }
  return (int)cudaGetLastError();
}

int kt_sw_traceback(const void* dirs, const void* best, const void* qlens,
                    int B, int d_pad, int W, void* score, void* q_ops,
                    void* r_ops, void* n_ops, void* stream) {
  if (B > 0) {
    const int threads = 128;
    sw_traceback_kernel<<<(B + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)dirs, (const int*)best, (const int*)qlens, B, d_pad, W,
        (int*)score, (int16_t*)q_ops, (int16_t*)r_ops, (int*)n_ops);
  }
  return (int)cudaGetLastError();
}

const char* kt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
