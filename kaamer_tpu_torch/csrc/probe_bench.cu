// Device microbenchmark kernels of the hash-probe design study, for Hopper
// (sm_90a).
//
// row_dma_probe replaces the Pallas per-row DMA probes of
// scripts/pallas_dma_probe.py (v1_static_row_dma, v2_dyn_row_dma,
// v3_prefetch_dma) and scripts/probe_microbench.py (pallas_dma_bench):
// a ring of `depth` outstanding copies of one table row each, HBM to
// on-chip memory, each waited on its own completion signal before the next
// copy reuses its slot.  On the TPU that is pltpu.make_async_copy into a
// VMEM scratch ring plus one DMA semaphore per slot; here it is one
// cp.async.bulk (the TMA engine's 1-D bulk copy) per row into a
// shared-memory ring, with one mbarrier per slot counting the bytes that
// landed.  One thread issues, waits and reads, as the TPU's scalar core
// does; the copy engine does the transfers.  The kernel is bound by the
// latency of one random row read from device memory divided by the number
// of copies in flight, which is what the probe measures: depth 1 is the
// serial latency, larger depths how far overlap hides it.
//
//   out[0] = wrapping int32 sum of table[idx[j], 0], j < n        (P1-P3)
//          = table[idx[j0], 0], j0 the last multiple of depth < n  (P6,
//            last_slot0: word 0 of the row that landed last in slot 0)
//
// stage_idx (P3, the TPU's scalar prefetch): the block first copies the
// index list into shared memory, so the issuing thread reads indices
// there instead of from device memory.
//
// smem_dyngather replaces the Pallas on-chip gathers
// scripts/pallas_dma_probe.py:v4_vmem_dyngather and
// scripts/probe_microbench.py:pallas_dyngather_bench:
//
//   s = sum_{i < inner} sum_{r, c} x[idx_i[r, c] & (T-1), c],
//   idx_{i+1} = idx_i * 1664525 + 7 + i        (32-bit wrap; s mod 2^32)
//
// The TPU keeps the whole [T, 128] table in VMEM; at T = 8192 that is 4 MB,
// beyond a block's 227 KB of shared memory.  The gather runs along rows
// only (out[r, c] reads column c), so each block stages one column
// x[:, c] (T * 4 bytes, 32 KB at T = 8192) in shared memory and gathers
// from it: 128 blocks for 132 SMs.  Each thread walks its indices through
// the `inner` rounds in registers, in uint32 (signed overflow is undefined
// in C++); the block reduces and adds into one uint32 with atomicAdd.  A
// sum mod 2^32 does not depend on order, so the result is exact and
// repeatable.  Bound: shared-memory random reads, T * 128 * inner of them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// one row, device memory -> shared memory, completion counted in bytes on
// the slot's barrier (sizes and both addresses are multiples of 16)
__device__ __forceinline__ void issue_row(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

}  // namespace

__global__ void row_dma_probe_kernel(const uint32_t* __restrict__ table,
                                     int row_words,
                                     const int* __restrict__ idx, int n,
                                     int depth, int stage_idx,
                                     int last_slot0, int* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);          // [depth]
  const int row_bytes = row_words * 4;
  unsigned char* ring = smem + 128 * ((depth * 8 + 127) / 128);  // [depth]
  int* s_idx = reinterpret_cast<int*>(ring + depth * row_bytes);  // [n]

  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int* ids = idx;
  if (stage_idx) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) s_idx[j] = idx[j];
    ids = s_idx;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  auto issue = [&](int slot, int j) {
    const uint32_t* src = table + (size_t)ids[j] * row_words;
    issue_row(smem_u32(ring + slot * row_bytes), src, row_bytes,
              smem_u32(&bars[slot]));
  };
  for (int j = 0; j < depth && j < n; ++j) issue(j, j);
  uint32_t acc = 0;
  for (int j = 0; j < n; ++j) {
    const int slot = j % depth;
    const uint32_t bar = smem_u32(&bars[slot]);
    // the k-th copy into a slot completes the barrier's phase k; a copy
    // that never lands (a fault) ends the kernel with an error instead of
    // spinning forever
    for (long long spins = 0; !mbar_try_wait(bar, (uint32_t)(j / depth) & 1);
         ++spins) {
      if (spins > (1LL << 30)) __trap();
    }
    acc += *reinterpret_cast<volatile uint32_t*>(ring + slot * row_bytes);
    if (j + depth < n) {
      // order this generic-proxy read before the copy engine rewrites
      // the slot
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(slot, j + depth);
    }
  }
  out[0] = last_slot0 ? (int)*reinterpret_cast<volatile uint32_t*>(ring)
                      : (int)acc;
}

#define DG_THREADS 256

__global__ void __launch_bounds__(DG_THREADS)
smem_dyngather_kernel(const uint32_t* __restrict__ x,
                      const uint32_t* __restrict__ idx, int T, int inner,
                      uint32_t* __restrict__ out) {
  extern __shared__ uint32_t col[];  // x[:, c], T words
  __shared__ uint32_t warp_sums[DG_THREADS / 32];
  const int c = blockIdx.x;
  for (int r = threadIdx.x; r < T; r += DG_THREADS) {
    col[r] = x[(size_t)r * 128 + c];
  }
  __syncthreads();
  const uint32_t mask = (uint32_t)T - 1u;
  uint32_t s = 0;
  for (int r = threadIdx.x; r < T; r += DG_THREADS) {
    uint32_t id = idx[(size_t)r * 128 + c];
    for (int i = 0; i < inner; ++i) {
      s += col[id & mask];
      id = id * 1664525u + 7u + (uint32_t)i;
    }
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t b = 0;
    for (int w = 0; w < DG_THREADS / 32; ++w) b += warp_sums[w];
    atomicAdd(out, b);
  }
}

extern "C" {

// out: int32[1].  Returns a cudaError_t (0 on success).
int kt_row_dma_probe(const void* table, int row_words, const void* idx,
                     int n, int depth, int stage_idx, int last_slot0,
                     void* out, void* stream) {
  const int row_bytes = row_words * 4;
  if (n < 1 || depth < 1 || row_bytes % 16) return (int)cudaErrorInvalidValue;
  size_t smem = 128 * ((depth * 8 + 127) / 128) + (size_t)depth * row_bytes
                + (stage_idx ? (size_t)n * 4 : 0);
  cudaError_t err = cudaFuncSetAttribute(
      row_dma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  row_dma_probe_kernel<<<1, 32, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)table, row_words, (const int*)idx, n, depth, stage_idx,
      last_slot0, (int*)out);
  return (int)cudaGetLastError();
}

// out: uint32[1], zeroed by the caller.  T a power of two.
int kt_smem_dyngather(const void* x, const void* idx, int T, int inner,
                      void* out, void* stream) {
  if (T < 1 || (T & (T - 1))) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)T * 4;
  cudaError_t err = cudaFuncSetAttribute(
      smem_dyngather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  smem_dyngather_kernel<<<128, DG_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)idx, T, inner, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
