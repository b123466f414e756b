// Serving kernels of the Wenquxing 22A SNN for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/snn_kernels.py:
//   infer_window_batch_encode (_infer_window_enc_kernel): spikes drawn
//       in-kernel from uint8 intensities; here infer_window_enc_kernel
//       (the window regime), or infer_window_enc_draw_kernel then
//       infer_window_enc_sums_kernel (the GEMM regime).
//   infer_window_batch (_infer_window_kernel): pre-packed spikes; here
//       infer_window_pre_kernel (the window regime) or
//       infer_window_pre_sums_kernel (the GEMM regime).
// Both compute spike counts int32[B, n] over a window of T cycles with
// frozen 1-bit weights u32[n, W] and the membrane reset per sample:
//   per cycle: c = popcount(pre & w[i]); v += c; fire iff v >= threshold;
//   a fired neuron resets to 0, else v = max(v - leak, 0).
//
// What bounds them on this card: integer instruction throughput.  The
// weights and the window are read once (a few MB), but every (sample,
// cycle, neuron, word) costs an AND, a population count (a quarter-rate
// instruction) and an add, and the encode kernel adds ~14 integer
// operations per (sample, cycle, input) for the counter hash.
//
// The design: the weights are frozen and a cycle's spikes depend on no
// state, so every synaptic sum c[t][i] = popcount(pre_t & w_i) is
// independent of the membrane.  Only the LIF recurrence v <- lif(v,
// c[t][i]) is serial, a few integer operations per cycle and neuron.  So
// both ops take all the sums of a window first and only then scan the LIF
// over them: no barrier per cycle.  One code path serves both; the source
// of a cycle's spike row is a compile-time choice:
//   - encode: drawn from the counter hash over the sample's intensities,
//     each word once per (sample, cycle).  Cycles at or past t_total[b]
//     change nothing (frozen membrane, no spikes), so the kernel stops
//     there; the host version zero-masks them instead, and the counts are
//     equal for any threshold >= 1, which the wrapper enforces.
//   - pre-packed: read from spikes[b].  Every sample runs all T cycles (a
//     zero-masked tail included): with threshold <= 0 a neuron fires on
//     an empty cycle, so nothing may be skipped.
// Two regimes, picked from the shapes (`plan`):
//   - Window: the sample's weights (n x W words), its sums (T x n) and a
//     share of its window fit a block's shared memory (the paper's 784-40
//     at T = 72 takes 25 KB).  One thread-block cluster per sample, of up
//     to 8 blocks (as many as the card's SMs allow for the batch: 4 at
//     B = 32, so 128 blocks fill 132 SMs where one block a sample would
//     fill 32).  Each block draws, or copies, its share of the sample's
//     cycles, sums them for every neuron (one thread per (cycle, neuron),
//     serial over the W words), and writes the sums into the leader
//     block's shared memory through distributed shared memory; after one
//     cluster barrier the leader's threads run the LIF scan, one thread a
//     neuron.  The pre-packed copy is issued with the weight stage, before
//     the first cluster barrier, so both are in flight together.
//   - GEMM: the weights do not fit (65,536 inputs: W = 2,048).  The sums
//     are a popcount product [T, W] x [W, n] per sample.  The encode op
//     first draws the window into a scratch [B, T, W] that the wrapper
//     allocates (9.4 MB at B 16, T 72, W 2,048: it stays in the 50 MB
//     L2), one thread a word, every (sample, cycle) once; the pre-packed
//     op reads its spikes where they are, with no draw and no scratch.
//     The sums kernel gives each (64-neuron tile, sample) one cluster of
//     G blocks, each block a slice of the W words: word chunks of 72
//     cycles' spike rows and the tile's 64 weight rows stream through a
//     three-stage cp.async ring, each thread holding a 9-cycle x 2-neuron
//     tile of sums in registers (the cycles of a warp read one spike word,
//     a broadcast; each lane reads its two weight rows 16 bytes at a
//     time).  Each block adds its partial sums into the leader's shared
//     memory (atomics through distributed shared memory); after a cluster
//     barrier 64 leader threads scan the LIF over the pass (72 cycles),
//     and further passes carry v and the count.  G is chosen so that the
//     card gets ~8 blocks an SM (3 resident at once): samples of unequal
//     length (t_total) then balance over the SMs, where one block per
//     (tile, sample) left the longest samples' SMs the last to finish.
//     (~4 blocks an SM was 6-10% slower at 65,536 inputs.)
//
// Plain C interface (bound with ctypes): each launcher picks its plan
// from the device, launches on the given stream, does not synchronize,
// and returns cudaGetLastError() (or one of the codes below).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "snn_common.cuh"

namespace cg = cooperative_groups;

namespace {

// The GEMM regime's encode launcher was given no scratch.
constexpr int kNoScratch = -2;

constexpr int kMaxCluster = 8;     // the portable cluster size

// Launches `kernel` on grid `grid` in clusters of `cluster` blocks along x.
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int threads, int cluster,
                           size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = snn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// --- the window regime: one cluster a sample --------------------------------

constexpr int kWinThreads = 512;

// Row stride (words) of the staged weight rows and spike rows: odd, so
// that threads on neighbouring rows read different banks.
__host__ __device__ __forceinline__ int odd_stride(int W) { return W | 1; }

// Shared-memory layout of one block of the window regime (dynamic,
// 16-byte aligned base), as byte offsets; every block of a cluster
// carves the same, and only the leader's c_s is read:
//   w_s   u32[n * ws]      the sample's weight rows (ws = odd_stride(W))
//   c_s   i32[T * n]       the sums of every cycle and neuron
//   pre_s u32[per * ws]    this block's cycles of the window
//   in_s  u8[32 * W]       encode only: the sample's intensities
struct WinLayout {
  size_t c, pre, in, total;
};

__host__ __device__ __forceinline__ WinLayout win_layout(int n, int W, int T,
                                                         int per,
                                                         bool encode) {
  const size_t ws = static_cast<size_t>(odd_stride(W));
  WinLayout l;
  l.c = static_cast<size_t>(n) * ws * 4;
  l.pre = l.c + static_cast<size_t>(T) * n * 4;
  l.in = l.pre + static_cast<size_t>(per) * ws * 4;
  l.total = l.in + (encode ? static_cast<size_t>(W) * 32 : 0);
  return l;
}

// Copy `len` consecutive words from global memory into rows of W words
// at a stride of ws words in shared memory, by a window-regime block:
// word x lands at dst[(x / W) * ws + x % W].  One coalesced word a thread
// (16-byte loads, which need four such divisions a thread, were slower at
// the paper's shapes).
__device__ __forceinline__ void stage_rows(uint32_t* dst, int ws,
                                           const uint32_t* __restrict__ src,
                                           int len, int W) {
  for (int x = threadIdx.x; x < len; x += kWinThreads) {
    const int r = x / W;
    dst[r * ws + x - r * W] = src[x];
  }
}

// Where the encode op's cycles come from (unused by the pre-packed op).
struct Drawn {
  const uint8_t* intensities;
  const int32_t* seeds;
  const int32_t* t_total;
  int n_in;
};

// One sample's counts by its cluster: kDraw draws the cycles from `d`,
// else they are copied from spikes[b] ([B, n_steps, W]).
template <bool kDraw>
__device__ __forceinline__ void window_counts(
    const uint32_t* __restrict__ weights, const Drawn& d,
    const uint32_t* __restrict__ spikes, int32_t* __restrict__ counts, int n,
    int W, int n_steps, int threshold, int leak) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int ws = odd_stride(W);
  const WinLayout lay = win_layout(n, W, n_steps, (n_steps + C - 1) / C,
                                   kDraw);
  uint32_t* w_s = reinterpret_cast<uint32_t*>(smem);
  int32_t* c_s = reinterpret_cast<int32_t*>(smem + lay.c);
  uint32_t* pre_s = reinterpret_cast<uint32_t*>(smem + lay.pre);
  uint8_t* in_s = smem + lay.in;

  stage_rows(w_s, ws, weights, n * W, W);
  if (kDraw)
    snn::stage_intensities(in_s, d.intensities + static_cast<size_t>(b) *
                                                     d.n_in,
                           d.n_in, W);
  // this block's share of the sample's cycles: [t_lo, t_hi)
  const int t_end = kDraw ? min(max(d.t_total[b], 0), n_steps) : n_steps;
  const int per = (t_end + C - 1) / C;
  const int t_lo = min(rank * per, t_end);
  const int t_hi = min(t_lo + per, t_end);
  const uint32_t seed = kDraw ? static_cast<uint32_t>(d.seeds[b]) : 0u;
  if (!kDraw)
    stage_rows(pre_s, ws,
               spikes + (static_cast<size_t>(b) * n_steps + t_lo) * W,
               (t_hi - t_lo) * W, W);
  // staged, and every block of the cluster has started, so the leader's
  // shared memory may be written
  cluster.sync();

  // 1. encode: the block's cycles of the window, every thread whole words
  if (kDraw) {
    for (int x = threadIdx.x; x < (t_hi - t_lo) * W; x += kWinThreads) {
      const int t = x / W;
      const int k = x - t * W;
      pre_s[t * ws + k] =
          snn::draw_word(in_s, seed, static_cast<uint32_t>(t_lo + t), k);
    }
    __syncthreads();
  }

  // 2. their sums, every (cycle, neuron) at once, into the leader's c_s
  int32_t* c_lead = cluster.map_shared_rank(c_s, 0);
  for (int x = threadIdx.x; x < (t_hi - t_lo) * n; x += kWinThreads) {
    const int t = x / n;
    const int i = x - t * n;
    const uint32_t* pre = pre_s + t * ws;
    const uint32_t* row = w_s + i * ws;
    int acc = 0;
#pragma unroll 4
    for (int k = 0; k < W; ++k) acc += __popc(pre[k] & row[k]);
    c_lead[(t_lo + t) * n + i] = acc;
  }
  cluster.sync();   // every sum has landed in the leader

  // 3. the LIF scan, one leader thread a neuron: the only serial part
  if (rank != 0) return;
  for (int i = threadIdx.x; i < n; i += kWinThreads) {
    int32_t v = 0;
    int cnt = 0;
    for (int t = 0; t < t_end; ++t) {
      bool fired;
      v = snn::lif_update(v, c_s[t * n + i], threshold, leak, &fired);
      cnt += fired ? 1 : 0;
    }
    counts[static_cast<size_t>(b) * n + i] = cnt;
  }
}

__global__ void __launch_bounds__(kWinThreads)
infer_window_enc_kernel(const uint32_t* __restrict__ weights,
                        const uint8_t* __restrict__ intensities,
                        const int32_t* __restrict__ seeds,
                        const int32_t* __restrict__ t_total,
                        int32_t* __restrict__ counts, int n, int W,
                        int n_in, int n_steps, int threshold, int leak) {
  window_counts<true>(weights, Drawn{intensities, seeds, t_total, n_in},
                      nullptr, counts, n, W, n_steps, threshold, leak);
}

__global__ void __launch_bounds__(kWinThreads)
infer_window_pre_kernel(const uint32_t* __restrict__ weights,
                        const uint32_t* __restrict__ spikes,
                        int32_t* __restrict__ counts, int n, int W, int T,
                        int threshold, int leak) {
  window_counts<false>(weights, Drawn{}, spikes, counts, n, W, T, threshold,
                       leak);
}

// --- the GEMM regime: (encode) draw, then sums and scan ---------------------

constexpr int kDrawThreads = 256;  // one spike word a thread

// spikes[b, t, k] for every t < t_end of sample b (the rest is not
// written, and never read), each word drawn once.  Grid (W / 256, B).
__global__ void __launch_bounds__(kDrawThreads)
infer_window_enc_draw_kernel(const uint8_t* __restrict__ intensities,
                             const int32_t* __restrict__ seeds,
                             const int32_t* __restrict__ t_total,
                             uint32_t* __restrict__ spikes, int W, int n_in,
                             int n_steps) {
  __shared__ __align__(16) uint8_t in_s[32 * kDrawThreads];
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * kDrawThreads;
  const uint8_t* in_g = intensities + static_cast<size_t>(b) * n_in;
  for (int x = threadIdx.x; x < 32 * kDrawThreads; x += kDrawThreads) {
    const int idx = 32 * k0 + x;
    in_s[x] = idx < n_in ? in_g[idx] : 0;
  }
  __syncthreads();
  const int k = k0 + threadIdx.x;
  const int t_end = min(max(t_total[b], 0), n_steps);
  if (k >= W) return;
  uint32_t px[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    px[q] = reinterpret_cast<const uint32_t*>(in_s)[8 * threadIdx.x + q];
  const uint32_t seed = static_cast<uint32_t>(seeds[b]);
  uint32_t* out = spikes + static_cast<size_t>(b) * n_steps * W + k;
  for (int t = 0; t < t_end; ++t)
    out[static_cast<size_t>(t) * W] =
        snn::draw_word_from(px, seed, static_cast<uint32_t>(t), k);
}

constexpr int kSumThreads = 256;
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kSumRows = 64;                     // neurons a block, 2 a lane
constexpr int kSumRowTile = 9;                   // cycles a warp, a pass
constexpr int kSumCycles = kSumWarps * kSumRowTile;   // cycles a pass: 72
constexpr int kSumChunk = 32;                    // words a stage
constexpr int kSumStages = 3;                    // the cp.async ring
constexpr int kSumBlocksPerSm = 3;
// Weight rows staged row-major at a stride of 36 words: 16-byte aligned,
// and the 8 lanes of a 16-byte access phase hit 32 distinct banks.
constexpr int kSumWStride = kSumChunk + 4;
// Shared memory (dynamic), in words: kSumStages stages of [72][32] spike
// words then [64][36] weight words, then the leader's sums c_s [72][64].
constexpr int kSumPreWords = kSumCycles * kSumChunk;
constexpr int kSumStageWords = kSumPreWords + kSumRows * kSumWStride;
constexpr size_t kSumSmem =
    (static_cast<size_t>(kSumStages) * kSumStageWords +
     kSumCycles * kSumRows) * 4;

__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src,
                                         bool valid, bool vec) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Issue the copies of word chunk [kc, kc + 32) of the pass's tc spike
// rows (s_g: row t at s_g + t W) and of the tile's rows_here weight rows
// (w_g) into one stage; words at or past W are zero-filled.  `vec`: 16
// bytes a copy (W % 4 == 0, 16-byte aligned bases), else 4.
__device__ __forceinline__ void stage_chunk(uint32_t* stage,
                                            const uint32_t* s_g,
                                            const uint32_t* w_g, int kc,
                                            int W, int tc, int rows_here,
                                            bool vec) {
  const int per_row = vec ? kSumChunk / 4 : kSumChunk;   // copies a row
  const int step = vec ? 4 : 1;
  for (int x = threadIdx.x; x < (kSumCycles + kSumRows) * per_row;
       x += kSumThreads) {
    const int r = x / per_row;
    const int k = (x - r * per_row) * step;
    const bool spike = r < kSumCycles;
    const int row = spike ? r : r - kSumCycles;
    if (row >= (spike ? tc : rows_here)) continue;   // never read
    const uint32_t* src = (spike ? s_g : w_g) + static_cast<size_t>(row) * W;
    uint32_t* dst = spike ? stage + row * kSumChunk + k
                          : stage + kSumPreWords + row * kSumWStride + k;
    const bool valid = kc + k < W;
    cp_async(dst, valid ? src + kc + k : src, valid, vec);
  }
}

// counts[b, row0 .. row0 + 63] from spikes[b, :t_end] ([B, n_steps, W]),
// t_end = t_total[b] clipped to [0, n_steps], or n_steps when t_total is
// null.  Grid (G, n / 64, B), clusters of G along x: rank g sums words
// [g slice, (g + 1) slice).  Thread (warp, lane) sums cycles warp + 8 r
// of the pass against neurons lane and lane + 32.
__device__ __forceinline__ void sums_counts(
    const uint32_t* __restrict__ weights, const uint32_t* __restrict__ spikes,
    const int32_t* __restrict__ t_total, int32_t* __restrict__ counts, int n,
    int W, int n_steps, int threshold, int leak, int slice, bool vec) {
  extern __shared__ __align__(16) uint32_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = blockIdx.y * kSumRows;
  const int b = blockIdx.z;
  const int rows_here = min(kSumRows, n - row0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t_end = t_total ? min(max(t_total[b], 0), n_steps) : n_steps;
  const int k_lo = rank * slice;
  const int n_chunks = (max(min(k_lo + slice, W) - k_lo, 0) + kSumChunk - 1) /
                       kSumChunk;
  const uint32_t* s_b = spikes + static_cast<size_t>(b) * n_steps * W;
  const uint32_t* w_g = weights + static_cast<size_t>(row0) * W;
  int32_t* c_s = reinterpret_cast<int32_t*>(sm + kSumStages * kSumStageWords);
  int32_t* c_lead = cluster.map_shared_rank(c_s, 0);
  int32_t v = 0;                 // the scan's neuron threadIdx.x (< 64)
  int cnt = 0;
  for (int t0 = 0; t0 < t_end; t0 += kSumCycles) {
    const int tc = min(kSumCycles, t_end - t0);
    const uint32_t* s_g = s_b + static_cast<size_t>(t0) * W;
    // this warp's cycles of the pass: warp + 8 r < tc
    const int nr = (tc - warp + kSumWarps - 1) / kSumWarps;
    for (int s = 0; s < kSumStages - 1; ++s) {       // the ring's head
      if (s < n_chunks)
        stage_chunk(sm + s * kSumStageWords, s_g, w_g, k_lo + s * kSumChunk,
                    W, tc, rows_here, vec);
      cp_async_commit();
    }
    __syncthreads();           // the leader's last scan has read c_s
    if (rank == 0)
      for (int x = threadIdx.x; x < tc * kSumRows; x += kSumThreads)
        c_s[x] = 0;
    cluster.sync();            // c_s zeroed, every block of the cluster on
    int acc[kSumRowTile][2];
#pragma unroll
    for (int r = 0; r < kSumRowTile; ++r) acc[r][0] = acc[r][1] = 0;
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<kSumStages - 2>();   // chunk c has landed (this thread)
      __syncthreads();   // ... for every thread, and chunk c - 1 is consumed
      const int next = c + kSumStages - 1;
      if (next < n_chunks)
        stage_chunk(sm + (next % kSumStages) * kSumStageWords, s_g, w_g,
                    k_lo + next * kSumChunk, W, tc, rows_here, vec);
      cp_async_commit();
      const uint32_t* pre = sm + (c % kSumStages) * kSumStageWords;
      const uint32_t* wt = pre + kSumPreWords;
#pragma unroll 2
      for (int k = 0; k < kSumChunk; k += 4) {
        const uint4 w0 =
            *reinterpret_cast<const uint4*>(wt + lane * kSumWStride + k);
        const uint4 w1 =
            *reinterpret_cast<const uint4*>(wt + (lane + 32) * kSumWStride + k);
#pragma unroll
        for (int r = 0; r < kSumRowTile; ++r) {
          if (r >= nr) break;
          const uint4 p = *reinterpret_cast<const uint4*>(
              pre + (warp + kSumWarps * r) * kSumChunk + k);
          acc[r][0] += __popc(p.x & w0.x) + __popc(p.y & w0.y) +
                       __popc(p.z & w0.z) + __popc(p.w & w0.w);
          acc[r][1] += __popc(p.x & w1.x) + __popc(p.y & w1.y) +
                       __popc(p.z & w1.z) + __popc(p.w & w1.w);
        }
      }
    }
    // this rank's partial sums into the leader's c_s
#pragma unroll
    for (int r = 0; r < kSumRowTile; ++r) {
      if (r >= nr) break;
      int32_t* c = c_lead + (warp + kSumWarps * r) * kSumRows;
      atomicAdd(c + lane, acc[r][0]);
      atomicAdd(c + lane + 32, acc[r][1]);
    }
    cluster.sync();            // every partial sum has landed
    if (rank == 0 && threadIdx.x < rows_here) {
      for (int t = 0; t < tc; ++t) {
        bool fired;
        v = snn::lif_update(v, c_s[t * kSumRows + threadIdx.x], threshold,
                            leak, &fired);
        cnt += fired ? 1 : 0;
      }
    }
  }
  if (rank == 0 && threadIdx.x < rows_here)
    counts[static_cast<size_t>(b) * n + row0 + threadIdx.x] = cnt;
}

__global__ void __launch_bounds__(kSumThreads, kSumBlocksPerSm)
infer_window_enc_sums_kernel(const uint32_t* __restrict__ weights,
                             const uint32_t* __restrict__ spikes,
                             const int32_t* __restrict__ t_total,
                             int32_t* __restrict__ counts, int n, int W,
                             int n_steps, int threshold, int leak, int slice,
                             int vec) {
  sums_counts(weights, spikes, t_total, counts, n, W, n_steps, threshold,
              leak, slice, vec != 0);
}

__global__ void __launch_bounds__(kSumThreads, kSumBlocksPerSm)
infer_window_pre_sums_kernel(const uint32_t* __restrict__ weights,
                             const uint32_t* __restrict__ spikes,
                             int32_t* __restrict__ counts, int n, int W,
                             int T, int threshold, int leak, int slice,
                             int vec) {
  sums_counts(weights, spikes, nullptr, counts, n, W, T, threshold, leak,
              slice, vec != 0);
}

// --- plans and launchers ------------------------------------------------------

enum Regime { kWindowRegime = 0, kGemmRegime = 1 };

struct Plan {
  int regime;
  int cluster;   // blocks a sample (window), or a (tile, sample) (GEMM)
  size_t smem;   // shared bytes a block
};

// The regime for B samples of an n-neuron, W-word bank over n_steps
// cycles, drawn (encode) or pre-packed: the window regime where its
// layout fits a block, with a cluster of min(8, SMs / B, n_steps) blocks a
// sample; else GEMM, with clusters of G blocks a (tile, sample): the
// least power of two that gives >= 8 blocks an SM, at most 8 and at most
// the W words' 32-word chunks.
cudaError_t plan_for(int B, int n, int W, int n_steps, bool encode,
                     Plan* plan) {
  size_t limit = 0;
  cudaError_t err = snn::block_smem_limit(&limit);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int c = std::min(std::max(sms / std::max(B, 1), 1), kMaxCluster);
  c = std::min(c, std::max(n_steps, 1));
  const size_t smem =
      win_layout(n, W, n_steps, (n_steps + c - 1) / c, encode).total;
  if (smem <= limit) {
    *plan = Plan{kWindowRegime, c, smem};
    return cudaSuccess;
  }
  const long long blocks =
      static_cast<long long>(std::max(B, 1)) * ((n + kSumRows - 1) / kSumRows);
  const int chunks = std::max((W + kSumChunk - 1) / kSumChunk, 1);
  int g = 1;
  while (g < kMaxCluster && g < chunks && blocks * g < 8LL * sms) g *= 2;
  *plan = Plan{kGemmRegime, std::min(g, chunks), kSumSmem};
  return cudaSuccess;
}

// Words a rank of a GEMM cluster of g sums: whole chunks.
int sums_slice(int W, int g) {
  const int chunks = (W + kSumChunk - 1) / kSumChunk;
  return (chunks + g - 1) / g * kSumChunk;
}

}  // namespace

extern "C" {

// The plan for these shapes, drawn (encode != 0) or pre-packed: out[0]
// the regime (0 window, 1 GEMM: the encode launcher then needs a scratch
// of B * n_steps * W words), out[1] the cluster size, out[2] the shared
// bytes a block.  Returns 0 or a cudaError_t.
int snn_infer_plan(int B, int n, int W, int n_steps, int encode, void* out) {
  Plan plan;
  const cudaError_t err = plan_for(B, n, W, n_steps, encode != 0, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* o = static_cast<int*>(out);
  o[0] = plan.regime;
  o[1] = plan.cluster;
  o[2] = static_cast<int>(plan.smem);
  return 0;
}

// counts[B, n] (int32, written) from weights[n, W] (u32 bit patterns),
// intensities[B, n_in] (u8), seeds[B] and t_total[B] (int32).  In the
// GEMM regime `scratch` holds B * n_steps * W u32 words (overwritten);
// the window regime does not read it (it may be null).
int snn_infer_window_batch_encode(const void* weights,
                                  const void* intensities,
                                  const void* seeds, const void* t_total,
                                  void* counts, void* scratch, int B, int n,
                                  int W, int n_in, int n_steps,
                                  int threshold, int leak, void* stream) {
  Plan plan;
  cudaError_t err = plan_for(B, n, W, n_steps, true, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* w = static_cast<const uint32_t*>(weights);
  const auto* x = static_cast<const uint8_t*>(intensities);
  const auto* sd = static_cast<const int32_t*>(seeds);
  const auto* tt = static_cast<const int32_t*>(t_total);
  auto* out = static_cast<int32_t*>(counts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.regime == kWindowRegime)
    return static_cast<int>(launch_cluster(
        infer_window_enc_kernel, dim3(plan.cluster, B), kWinThreads,
        plan.cluster, plan.smem, s, w, x, sd, tt, out, n, W, n_in, n_steps,
        threshold, leak));
  if (scratch == nullptr) return kNoScratch;
  auto* spikes = static_cast<uint32_t*>(scratch);
  infer_window_enc_draw_kernel<<<
      dim3((W + kDrawThreads - 1) / kDrawThreads, B), kDrawThreads, 0, s>>>(
      x, sd, tt, spikes, W, n_in, n_steps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = W % 4 == 0 && aligned16(w) && aligned16(spikes);
  return static_cast<int>(launch_cluster(
      infer_window_enc_sums_kernel,
      dim3(plan.cluster, (n + kSumRows - 1) / kSumRows, B), kSumThreads,
      plan.cluster, plan.smem, s, w, static_cast<const uint32_t*>(spikes), tt,
      out, n, W, n_steps, threshold, leak, sums_slice(W, plan.cluster), vec));
}

// counts[B, n] (int32, written) from weights[n, W] and spikes[B, T, W]
// (u32 bit patterns), every sample over all T cycles; T >= 1.
int snn_infer_window_batch(const void* weights, const void* spikes,
                           void* counts, int B, int n, int W, int T,
                           int threshold, int leak, void* stream) {
  Plan plan;
  const cudaError_t err = plan_for(B, n, W, T, false, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* w = static_cast<const uint32_t*>(weights);
  const auto* sp = static_cast<const uint32_t*>(spikes);
  auto* out = static_cast<int32_t*>(counts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.regime == kWindowRegime)
    return static_cast<int>(launch_cluster(
        infer_window_pre_kernel, dim3(plan.cluster, B), kWinThreads,
        plan.cluster, plan.smem, s, w, sp, out, n, W, T, threshold, leak));
  const int vec = W % 4 == 0 && aligned16(w) && aligned16(sp);
  return static_cast<int>(launch_cluster(
      infer_window_pre_sums_kernel,
      dim3(plan.cluster, (n + kSumRows - 1) / kSumRows, B), kSumThreads,
      plan.cluster, plan.smem, s, w, sp, out, n, W, T, threshold, leak,
      sums_slice(W, plan.cluster), vec));
}

// Human-readable text of a code returned above.
const char* snn_error_string(int err) {
  if (err == kNoScratch)
    return "the encode kernel's GEMM regime needs a scratch window";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
