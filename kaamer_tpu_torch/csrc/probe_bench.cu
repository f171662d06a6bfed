// Device microbenchmark kernels of the hash-probe design study, for Hopper
// (sm_90a).
//
// row_dma_probe replaces the Pallas per-row DMA probes P1
// scripts/pallas_dma_probe.py:58 (v1_static_row_dma), P2 :99
// (v2_dyn_row_dma), P3 :154 (v3_prefetch_dma) and P6
// scripts/probe_microbench.py:282 (pallas_dma_bench):
//
//   out[0] = wrapping int32 sum of table[idx[j], 0], j < n        (P1-P3)
//          = table[idx[j0], 0], j0 = ((n-1) / depth) * depth      (P6,
//            last_slot0: word 0 of the row the TPU's ring last copied
//            into slot 0)
//
// The TPU kernels issue one row DMA at a time from the scalar core into a
// ring of `depth` VMEM slots.  The first port copied that shape (one thread
// issuing cp.async.bulk into a `depth`-slot ring, one mbarrier per slot) and
// was bound by that thread: about 230 ns from issue to completion per copy,
// 0.93-1.04 ms per 4096 copies at depth 1, 8, 16 and 32 alike, with 131 of
// the 132 SMs idle (NVIDIA H100 80GB HBM3, 700 W power limit).  Hopper gets
// its memory rate from many warps with 16-byte loads in flight on every SM,
// so this kernel spreads the copies over the card:
//
//  - each warp takes a contiguous span of j; the grid is sized from n, the
//    row width and depth: the steps are shared out as if every SM held
//    its most resident warps (64 on the H100), in blocks of up to 32
//    warps, or of as many as leave room in shared memory for two blocks
//    an SM where rings are deep (those blocks then run in more than one
//    wave); a ring has no more stages than its warp has steps; at small
//    n one block per SM of as few warps as n needs;
//  - each lane moves one 16-byte chunk of a row with cp.async.cg (through
//    L2, not L1) into the warp's ring in shared memory, so one warp step
//    moves 32 / (row bytes / 16) rows: 16 rows of 32 B, 8 of 64 B;
//  - `depth` is the number of steps (cp.async groups) a warp keeps in
//    flight: it waits with cp.async.wait_group depth-1 before reading the
//    oldest stage, then refills it.  The first port had `depth` copies in
//    flight on the card; this one has depth x (rows per step) x warps;
//  - the lane that copied word 0 of a row adds it into a uint32; a warp
//    shuffle reduce, the warps' sums in shared memory and one atomicAdd
//    per block give the sum (exact and repeatable: a sum mod 2^32 does not
//    depend on order).  With last_slot0 the one lane that lands row j0
//    writes out[0];
//  - stage_idx (P3, the TPU's scalar prefetch): each warp first loads its
//    own span of idx into shared memory, coalesced, and issues from there.
//
// Bound: at the scripts' n = 4096 (at most a few hundred warps) the launch
// latency plus about one L2 round trip.  The scripts' tables, 2^19 x 32 B =
// 16 MiB and 2^19 x 64 B = 32 MiB, fit in the H100's 50 MB L2, so warm runs
// measure L2, not HBM.  At large n the bound is the card's rate of random
// 16-byte sector reads.  Measured on an NVIDIA H100 80GB HBM3 at 700 W:
// about 2 us of device time at n = 4096 at every depth; at 2^20 copies
// about 0.011 ms for 32 B rows and 0.018 ms for 64 B rows at depth 1.
// Depth beyond 2 gains nothing there: 64 warps of an SM with one step each
// in flight already cover L2's latency, and deeper rings only take shared
// memory, and with it resident warps.
//
// smem_dyngather replaces the Pallas on-chip gathers P4
// scripts/pallas_dma_probe.py:185 (v4_vmem_dyngather) and P5
// scripts/probe_microbench.py:217 (pallas_dyngather_bench):
//
//   s = sum_{i < inner} sum_{r, c} x[idx_i[r, c] & (T-1), c],
//   idx_{i+1} = idx_i * 1664525 + 7 + i        (32-bit wrap; s mod 2^32)
//
// x and idx are [T, 128], T a power of two up to 32768.  The TPU keeps the
// whole table in VMEM; at T = 8192 that is 4 MB, beyond a block's 227 KB of
// shared memory.  The gather runs along rows only (element (r, c) reads
// column c), so block c holds column x[:, c] in shared memory and walks
// every row of column c: 128 blocks, one an SM.  Bound: the int32
// instructions, 3 an element a round (the mask, the sum's add and the
// index update's one multiply-add) at 64 lanes an SM, against one
// shared-memory word an element a round at 32 banks an SM: 0.006018 ms
// against 0.004012 ms at T = 8192, inner = 32 on 132 SMs
// (chip_smoke.py:probe_bound).
//
// Wavefront model.  A warp's shared-memory load takes one wavefront per
// distinct word in its busiest bank (bank = word slot mod 32).  The first
// port stored word a at slot a, and the scripts' indices,
// idx[r, c] = ((r * 128 + c) * 2654435761) mod T, share their low 7 bits
// down a column (128 = 0 mod 32), as does every later round (the update is
// the same bijection mod 2^k for every lane): all 32 lanes of a warp read
// distinct words of one bank, 32 wavefronts a gather.  That model
// (ops/probe_bench.py:dyngather_wavefronts) put the first port at 0.132 ms
// at T = 8192 against 0.147514 ms measured (NVIDIA H100 80GB HBM3, 700 W).
// Uniformly random indices cost 3.52 wavefronts a gather.
//
// The design, part by part:
//  - layout: word a of the column is stored at slot
//    a ^ (((a >> 5) ^ (a >> 10)) & 31): every bit of the index above the
//    bank bits is folded into the bank (an XOR swizzle, as CUTLASS's, fixed
//    for all inputs; it changes only the low 5 bits, keyed by the bits above
//    them, so it is a bijection on [0, T) for every power of two T).  The
//    scripts' inputs model at 1.0 (T = 512, 4096) and 1.97 (T = 8192)
//    wavefronts a gather, random indices stay at 3.52, and consecutive
//    words (the staging stores) keep distinct banks;
//  - lanes: thread t of the block takes rows lo + t, lo + t + 1024, ... of
//    each chunk of rows [lo, lo + 8192), so a warp holds 32 consecutive
//    rows of its column (ops/probe_bench.py:dyngather_warp_rows);
//  - gathers in flight: 1024 threads a block (32 warps an SM) and the
//    round loop unrolled kDgUnroll = 8 deep, with a runtime remainder: the
//    index walk does not depend on the loaded words, so a thread has 8
//    independent loads in flight.  The sum mod 2^32 is exact in any order;
//  - staging: a block read its column at a 512-byte stride, one 32-byte
//    sector a word, 8x the bytes.  Blocks now run in clusters of S
//    adjacent columns.  Block k of a cluster reads a contiguous share of
//    the rows of all S columns (S words a row, contiguous) and stores each
//    word into its column's block through distributed shared memory
//    (cluster.map_shared_rank); a cluster barrier publishes them.  idx is
//    staged the same way, into a buffer of 8192 rows that the gathers read
//    at consecutive words.  S = 8 would read whole sectors, but the H100
//    runs fewer than 16 clusters of 8 (or 32 of 4) at one block an SM, and
//    a second wave of clusters costs more than the sectors it saves: S is
//    2 where the card runs all 64 clusters of 2 at once
//    (cudaOccupancyMaxActiveClusters), else 1.  TMA multicast
//    was not taken: it sends every block of a cluster the same tile, so
//    each block would hold all S columns of a chunk to keep one;
//  - one block an SM: every launch asks for the shared memory of the
//    largest table and chunk, (32768 + 8192) * 4 = 160 KB, more than half
//    an SM's, so two columns never share an SM's pipes.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, device
// time by torch.profiler; the first port's, from an earlier chip_smoke.py
// run on that card, in brackets): T = 8192, inner = 32: 0.0250 ms, 24% of
// the bound (0.1475); on uniformly random indices 0.0262; inner = 1
// 0.0119, so staging and launch are about half; T = 4096 0.0141 (0.0739);
// T = 512 0.0043 (0.0036: there the cluster barriers and 32-warp blocks
// cost more than the gathers save).  That card picks clusters of 2.  The
// rounds after the first take 0.42 us each at T = 8192 where the wavefront
// model gives 0.25 and the bound 0.19: the swizzle's integer instructions,
// not the banks, bound the scripts' inputs; random indices (0.46 us a
// round) are at the model.  More in PERF.md section 6.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <mutex>

namespace {

constexpr int kMaxBlockWarps = 32;    // row_dma_probe: 1024 threads a block
constexpr int kMaxStagedRows = 1024;  // stage_idx: most indices a warp
                                      // stages
// smem_dyngather
constexpr int kDyngatherMaxT = 32768;  // most table rows
constexpr int kDgThreads = 1024;       // a block
constexpr int kDgChunk = 8192;         // rows of idx staged at once
constexpr int kDgUnroll = 8;           // rounds in flight a thread
constexpr int kDgMaxCluster = 2;       // columns a cluster
// every launch: the largest column and one idx chunk (one block an SM)
constexpr size_t kDgSmemBytes = (size_t)(kDyngatherMaxT + kDgChunk) * 4;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, device memory -> shared memory, cached in L2 only
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// cp.async.wait_group takes its count as an immediate, and the ring depth
// is a runtime argument: pick the instruction by binary search on
// pending in [LO, HI)
template <int LO, int HI>
__device__ __forceinline__ void cp_async_wait(int pending) {
  if constexpr (HI - LO == 1) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(LO) : "memory");
  } else {
    constexpr int MID = (LO + HI) / 2;
    if (pending < MID) {
      cp_async_wait<LO, MID>(pending);
    } else {
      cp_async_wait<MID, HI>(pending);
    }
  }
}

}  // namespace

// Warp w of the grid (warp w % W of block w / W, W = blockDim.x / 32)
// copies rows j in
// [w * span * rows_per_step, + span * rows_per_step) ∩ [0, n),
// rows_per_step rows a step, through a ring of `stages` steps in its own
// warp_bytes of shared memory.  j0 < 0: sum mode; else write word 0 of row
// j0.  Two blocks of up to 32 warps fill an SM's 64 warps, so at most 32
// registers a thread.
__global__ void __launch_bounds__(32 * kMaxBlockWarps, 2)
row_dma_probe_kernel(const uint32_t* __restrict__ table, int row_words,
                     const int* __restrict__ idx, int n, int rows_per_step,
                     int span, int stages, int warp_bytes, int stage_idx,
                     int j0, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_all[];
  __shared__ uint32_t warp_sums[kMaxBlockWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* smem = smem_all + warp * warp_bytes;  // this warp's share
  const int chunks = row_words / 4;  // 16-byte chunks of a row
  const int step_chunks = rows_per_step * chunks;
  const int stage_bytes = step_chunks * 16;
  const int span_rows = span * rows_per_step;
  const int j_begin = (int)min(
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * span_rows,
      (long long)n);
  const int rows = min(n - j_begin, span_rows);  // 0 past the end
  const int steps = (rows + rows_per_step - 1) / rows_per_step;

  const int* ids = idx + j_begin;  // row r of the span is table row ids[r]
  if (stage_idx) {
    int* s_idx = reinterpret_cast<int*>(smem + stages * stage_bytes);
    for (int r = lane; r < rows; r += 32) s_idx[r] = ids[r];
    __syncwarp();
    ids = s_idx;
  }

  // A lane's share of a step: row lane_row of the step, chunks lane_chunk,
  // lane_chunk + 32, ... (more than one only for rows above 32 chunks, one
  // row a step, where lane_row is 0); lanes past the step copy nothing.
  // Chunk lane_chunk == 0 holds word 0.  No division in the step loop.
  const int lane_row = lane / chunks;
  const int lane_chunk = lane % chunks;
  const bool copies = lane < step_chunks;
  const uint32_t ring = smem_u32(smem);

  // step s into stage `slot`, one commit group (empty past the span)
  auto issue = [&](int slot, int s) {
    const int r = s * rows_per_step + lane_row;
    if (copies && r < rows) {
      const uint32_t* src = table + (size_t)ids[r] * row_words;
      const uint32_t dst = ring + slot * stage_bytes;
      for (int k = lane, c = lane_chunk; k < step_chunks; k += 32, c += 32) {
        cp_async16(dst + k * 16, src + c * 4);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  for (int s = 0; s < stages; ++s) issue(s, s);
  uint32_t acc = 0;
  for (int s = 0, slot = 0; s < steps; ++s) {
    // stages groups are committed ahead of step s + 1: at most stages - 1
    // pending means step s's copies (those of this lane) have landed
    cp_async_wait<0, 64>(stages - 1);
    const int r = s * rows_per_step + lane_row;
    if (copies && lane_chunk == 0 && r < rows) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          smem + slot * stage_bytes + lane * 16);
      acc += v;
      if (j_begin + r == j0) out[0] = v;
    }
    // a lane reads only chunks it copied itself, so program order puts
    // the read before the refill: no warp barrier
    issue(slot, s + stages);
    slot = slot + 1 == stages ? 0 : slot + 1;
  }
  if (j0 < 0) {  // the same for every thread of the block
    for (int o = 16; o > 0; o >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, o);
    }
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t b = 0;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) b += warp_sums[w];
      atomicAdd(out, b);
    }
  }
}

namespace cg = cooperative_groups;

// Shared-memory slot of word a of a column: the bits above the bank bits
// folded into them (a bijection on [0, T) for every power of two T <= 2^15)
__device__ __forceinline__ uint32_t dg_slot(uint32_t a) {
  return a ^ (((a >> 5) ^ (a >> 10)) & 31u);
}

// The cluster barrier: arrive (release: this thread's earlier accesses,
// its stores into other blocks and its reads of the last idx chunk among
// them, come first; relaxed: nothing to order), then wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// This block's share of a cluster staging step: rows [lo, lo + n) of the
// cluster's S columns c0 .. c0 + S - 1 of src ([*, 128] words) are n * S
// words, read row by row (S contiguous words a row); block `rank` reads
// words [rank * n, (rank + 1) * n) of them and stores word (lo + r, c0 + j)
// at dst[slot(r)] in block j of the cluster (slot: dg_slot with swizzle,
// else r).  blockDim.x is a multiple of S, so a thread's words all go to
// one block.
__device__ __forceinline__ void dg_stage(const uint32_t* __restrict__ src,
                                         uint32_t* dst, int lo, int n,
                                         int c0, int log2s, bool swizzle) {
  cg::cluster_group cluster = cg::this_cluster();
  const int base = (int)cluster.block_rank() * n;
  const int j = (base + (int)threadIdx.x) & ((1 << log2s) - 1);
  uint32_t* remote = cluster.map_shared_rank(dst, j);
  for (int e = threadIdx.x; e < n; e += kDgThreads) {
    const int r = (base + e) >> log2s;  // row of the pass
    const uint32_t v = src[(size_t)(lo + r) * 128 + c0 + j];
    remote[swizzle ? dg_slot((uint32_t)r) : (uint32_t)r] = v;
  }
}

// Block c of the grid walks column c.  Clusters of S = 2^log2s blocks along
// x: a cluster holds columns c0 .. c0 + S - 1, block rank j column c0 + j.
__global__ void __launch_bounds__(kDgThreads, 1)
smem_dyngather_kernel(const uint32_t* __restrict__ x,
                      const uint32_t* __restrict__ idx, int T, int inner,
                      uint32_t* __restrict__ out) {
  extern __shared__ uint32_t dg_smem[];
  uint32_t* col = dg_smem;             // x[:, c], T words, swizzled
  uint32_t* ids = dg_smem + T;         // idx[lo:lo + chunk, c]
  __shared__ uint32_t warp_sums[kDgThreads / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int log2s = __ffs((int)cluster.num_blocks()) - 1;
  const int c0 = blockIdx.x - (int)cluster.block_rank();
  const int chunk = min(T, kDgChunk);
  const uint32_t mask = (uint32_t)T - 1u;
  uint32_t s = 0;
  for (int lo = 0; lo < T; lo += chunk) {
    if (lo == 0) {
      // every block of the cluster runs before any store into its memory
      cluster_arrive_relaxed();
      cluster_wait();
      dg_stage(x, col, 0, T, c0, log2s, true);
    } else {
      cluster_arrive();  // every block has read the last chunk
      cluster_wait();
    }
    dg_stage(idx, ids, lo, chunk, c0, log2s, false);
    cluster_arrive();  // the column and this chunk have landed
    cluster_wait();
    for (int r = threadIdx.x; r < chunk; r += kDgThreads) {
      uint32_t id = ids[r];
      int i = 0;
      for (; i + kDgUnroll <= inner; i += kDgUnroll) {
#pragma unroll
        for (int u = 0; u < kDgUnroll; ++u) {
          s += col[dg_slot(id & mask)];
          id = id * 1664525u + 7u + (uint32_t)(i + u);
        }
      }
      for (; i < inner; ++i) {
        s += col[dg_slot(id & mask)];
        id = id * 1664525u + 7u + (uint32_t)i;
      }
    }
  }
  // no store reaches another block's memory after the last cluster
  // barrier, so a block may exit while the others still gather
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t b = 0;
    for (int w = 0; w < kDgThreads / 32; ++w) b += warp_sums[w];
    atomicAdd(out, b);
  }
}

namespace {

// What a launch needs of its device, read once per device.  The first
// launch on a device also raises both kernels' dynamic shared-memory
// limits to the most any launch asks for: once, not per launch.
struct DeviceLimits {
  int sms;           // SMs
  int warps_per_sm;  // most resident warps of an SM
  size_t probe_smem;  // row_dma_probe: most dynamic shared memory a block,
  size_t probe_smem2;  // and a block's share with two blocks an SM
  int dg_cluster;     // smem_dyngather: blocks a cluster
};

// smem_dyngather's launch: 128 blocks, clusters of `cluster` along x (1: a
// plain launch, whose cluster is its one block)
cudaLaunchConfig_t dg_config(int cluster, cudaStream_t stream,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(128);
  cfg.blockDim = dim3(kDgThreads);
  cfg.dynamicSmemBytes = kDgSmemBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

// kDgMaxCluster blocks a cluster if the device runs all 128 /
// kDgMaxCluster clusters at once (one block an SM), else 1
cudaError_t dg_pick_cluster(int* cluster) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = dg_config(kDgMaxCluster, nullptr, &attr);
  int n = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, (void*)smem_dyngather_kernel, &cfg);
  *cluster = n * kDgMaxCluster >= 128 ? kDgMaxCluster : 1;
  return err;
}

cudaError_t device_limits(int dev, DeviceLimits* lim) {
  static DeviceLimits limits[kMaxDevices];
  static std::atomic<bool> ready[kMaxDevices];
  static std::mutex mu;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev].load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[dev].load(std::memory_order_relaxed)) {
      DeviceLimits d;
      int threads = 0, optin = 0;
      cudaFuncAttributes attr;
      cudaError_t err = cudaDeviceGetAttribute(
          &d.sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(
            &threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
      }
      if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      }
      if (err == cudaSuccess) {
        err = cudaFuncGetAttributes(&attr, row_dma_probe_kernel);
      }
      if (err == cudaSuccess) {
        d.warps_per_sm = threads / 32;
        d.probe_smem = optin - attr.sharedSizeBytes;
        err = cudaFuncSetAttribute(row_dma_probe_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)d.probe_smem);
      }
      if (err == cudaSuccess) {
        err = cudaOccupancyAvailableDynamicSMemPerBlock(
            &d.probe_smem2, row_dma_probe_kernel, 2, 32 * kMaxBlockWarps);
      }
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(smem_dyngather_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kDgSmemBytes);
      }
      if (err == cudaSuccess) err = dg_pick_cluster(&d.dg_cluster);
      if (err != cudaSuccess) return err;  // the next launch tries again
      limits[dev] = d;
      ready[dev].store(true, std::memory_order_release);
    }
  }
  *lim = limits[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// out: uint32[1], zeroed by the caller.  Returns a cudaError_t (0 on
// success); cudaErrorInvalidValue when one warp's ring and indices do not
// fit in a block's shared memory.
int kt_row_dma_probe(const void* table, int row_words, const void* idx,
                     int n, int depth, int stage_idx, int last_slot0,
                     void* out, void* stream) {
  const int row_bytes = row_words * 4;
  if (n < 1 || depth < 1 || depth > 64 || row_bytes < 16 || row_bytes % 16) {
    return (int)cudaErrorInvalidValue;
  }
  int dev;
  DeviceLimits lim;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = device_limits(dev, &lim);
  if (err != cudaSuccess) return (int)err;

  auto cdiv = [](long long a, long long b) { return (a + b - 1) / b; };
  const int chunks = row_bytes / 16;
  const int rows_per_step = chunks <= 32 ? 32 / chunks : 1;
  const long long stage_bytes = (long long)rows_per_step * row_bytes;
  const long long n_steps = cdiv(n, rows_per_step);
  // Share the steps out over every warp the card can hold at once; with
  // stage_idx a warp stages at most kMaxStagedRows indices.  A warp's
  // shared memory is its ring (no more stages than steps) and its indices.
  long long span = cdiv(n_steps, (long long)lim.sms * lim.warps_per_sm);
  if (stage_idx) {
    span = std::min<long long>(span,
                               std::max(1, kMaxStagedRows / rows_per_step));
  }
  const long long stages = std::min<long long>(depth, span);
  const long long warp_bytes =
      cdiv(stages * stage_bytes + (stage_idx ? span * rows_per_step * 4 : 0),
           16) * 16;
  const long long n_warps = cdiv(n_steps, span);
  // Block width: at most 32 warps, no more than it takes to give every SM
  // a block when n is small, and no more than fit in a block's share of
  // shared memory with two blocks an SM (with one where a warp's ring
  // takes more than half).  Where shared memory holds fewer warps than
  // an SM can run, the blocks run in more than one wave.
  const long long fit = lim.probe_smem2 >= (size_t)warp_bytes
                            ? lim.probe_smem2 / warp_bytes
                            : lim.probe_smem / warp_bytes;
  const long long warps = std::min({(long long)kMaxBlockWarps,
                                    cdiv(n_warps, lim.sms), fit});
  if (warps < 1) return (int)cudaErrorInvalidValue;
  row_dma_probe_kernel<<<(unsigned)cdiv(n_warps, warps),
                         (unsigned)(32 * warps), (size_t)(warps * warp_bytes),
                         (cudaStream_t)stream>>>(
      (const uint32_t*)table, row_words, (const int*)idx, n, rows_per_step,
      (int)span, (int)stages, (int)warp_bytes, stage_idx,
      last_slot0 ? ((n - 1) / depth) * depth : -1, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// smem_dyngather at `cluster` blocks a cluster, 1 or 2, or 0 for the
// device's pick.  kt_smem_dyngather launches the pick; this is the seam by
// which the card tests also launch clusters of 1 on a card that picks 2.
int kt_smem_dyngather_clusters(const void* x, const void* idx, int T,
                               int inner, int cluster, void* out,
                               void* stream) {
  if (T < 1 || (T & (T - 1)) || T > kDyngatherMaxT || inner < 0 ||
      cluster < 0 || cluster > kDgMaxCluster) {
    return (int)cudaErrorInvalidValue;
  }
  int dev;
  DeviceLimits lim;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = device_limits(dev, &lim);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = dg_config(
      cluster ? cluster : lim.dg_cluster, (cudaStream_t)stream, &attr);
  return (int)cudaLaunchKernelEx(&cfg, smem_dyngather_kernel,
                                 (const uint32_t*)x, (const uint32_t*)idx, T,
                                 inner, (uint32_t*)out);
}

// out: uint32[1], zeroed by the caller.  T a power of two, at most 32768
// (a column of T words in a block's shared memory).
int kt_smem_dyngather(const void* x, const void* idx, int T, int inner,
                      void* out, void* stream) {
  return kt_smem_dyngather_clusters(x, idx, T, inner, 0, out, stream);
}

}  // extern "C"
