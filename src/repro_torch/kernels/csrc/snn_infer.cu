// Serving kernels of the Wenquxing 22A SNN for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/snn_kernels.py:
//   infer_window_batch_encode (_infer_window_enc_kernel): spikes drawn
//       in-kernel from uint8 intensities; here infer_window_enc_kernel
//       (the window regime), or infer_window_enc_draw_kernel then
//       infer_window_enc_sums_kernel (the GEMM regime).
//   infer_window_batch (_infer_window_kernel): pre-packed spikes; here
//       infer_window_kernel.
// Both compute spike counts int32[B, n] over a window of T cycles with
// frozen 1-bit weights u32[n, W] and the membrane reset per sample:
//   per cycle: c = popcount(pre & w[i]); v += c; fire iff v >= threshold;
//   a fired neuron resets to 0, else v = max(v - leak, 0).
//
// What bounds them on this card: integer instruction throughput.  The
// weights and intensities are read once (a few MB), but every (sample,
// cycle, neuron, word) costs an AND, a population count (a quarter-rate
// instruction) and an add, and the encode kernel adds ~14 integer
// operations per (sample, cycle, input) for the counter hash.
//
// The encode kernel's design: the weights are frozen and a cycle's spikes
// depend only on (seed, cycle, intensities), so every synaptic sum
// c[t][i] = popcount(pre_t & w_i) is independent of the membrane.  Only
// the LIF recurrence v <- lif(v, c[t][i]) is serial, a few integer
// operations per cycle and neuron.  So the kernel draws the window whole,
// takes all its sums at once, and only then scans the LIF over them: no
// barrier per cycle, and each spike word is drawn once per (sample,
// cycle), never once per neuron tile.  Cycles at or past t_total[b]
// change nothing (frozen membrane, no spikes), so the kernel stops there;
// the host version zero-masks them instead, and the counts are equal for
// any threshold >= 1, which the wrapper enforces.  Two regimes, picked
// from the shapes (`plan_encode`):
//   - Window: the sample's weights (n x W words), its sums (T x n) and a
//     share of its window fit a block's shared memory (the paper's 784-40
//     at T = 72 takes 25 KB).  One thread-block cluster per sample, of up
//     to 8 blocks (as many as the card's SMs allow for the batch: 4 at
//     B = 32, so 128 blocks fill 132 SMs where one block a sample would
//     fill 32).  Each block draws its share of the sample's cycles (every
//     thread whole words), sums them for every neuron (one thread per
//     (cycle, neuron), serial over the W words), and writes the sums into
//     the leader block's shared memory through distributed shared memory;
//     after one cluster barrier the leader's threads run the LIF scan,
//     one thread a neuron.  A cluster rather than a second pass: the sums
//     never leave the SMs, and one launch does it all.
//   - GEMM: the weights do not fit (65,536 inputs: W = 2,048).  The sums
//     are a popcount product [B T, W] x [W, n].  A first launch draws the
//     window into a scratch [B, T, W] that the wrapper allocates (9.4 MB
//     at B 16, T 72, W 2,048: it stays in the 50 MB L2), one thread a
//     word, every (sample, cycle) once.  The second gives each block one
//     sample and 64 neurons: its threads hold a 9-cycle x 2-neuron tile of
//     sums in registers over word chunks staged in shared memory (the
//     cycles of a warp read one spike word, a broadcast; the weights are
//     staged word-major), then write the pass's sums (72 cycles) to shared
//     memory, and 64 threads scan the LIF over them.
//
// infer_window_kernel (pre-packed) keeps its first design: one block per
// (tile of neurons, sample), the tile's weight rows staged once; each
// cycle the block copies the spike row from spikes[b, t] into shared
// memory, then each warp takes neurons: lanes stride the words with
// __popc(pre & w) and reduce with __shfl_xor_sync, lane 0 applies the
// LIF update; a barrier each side of it every cycle.
//
// Plain C interface (bound with ctypes): each launcher picks its tiles
// from the device, launches on the given stream, does not synchronize,
// and returns cudaGetLastError() (or one of the codes below).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "snn_common.cuh"

namespace cg = cooperative_groups;

namespace {

using snn::kThreads;
using snn::kWarps;

// The GEMM regime's launcher was given no scratch.
constexpr int kNoScratch = -2;

// --- infer_window_batch: pre-packed spikes ---------------------------------

// Weight tiles: at most kTileWords words (128 KiB) and kMaxTileRows
// neurons per block, so large layers still give many blocks.
constexpr int kTileWords = 32768;
constexpr int kMaxTileRows = 64;

// Shared-memory layout of one block (dynamic, 16-byte aligned base), as
// byte offsets; the one statement of it, for the kernel and the host:
//   w_s   u32[rows * W]   the tile's weight rows
//   pre_s u32[W]          this cycle's packed spike row
//   v_s   i32[rows]       membrane potentials
//   cnt_s i32[rows]       spike counts
struct Layout {
  size_t pre, v, cnt, total;
};

__host__ __device__ __forceinline__ Layout layout(int rows, int W) {
  Layout l;
  l.pre = static_cast<size_t>(rows) * W * 4;
  l.v = l.pre + static_cast<size_t>(W) * 4;
  l.cnt = l.v + static_cast<size_t>(rows) * 4;
  l.total = l.cnt + static_cast<size_t>(rows) * 4;
  return l;
}

struct Tile {
  uint32_t* w_s;
  uint32_t* pre_s;
  int32_t* v_s;
  int32_t* cnt_s;
};

__device__ __forceinline__ Tile carve(unsigned char* smem, int rows, int W) {
  const Layout l = layout(rows, W);
  Tile s;
  s.w_s = reinterpret_cast<uint32_t*>(smem);
  s.pre_s = reinterpret_cast<uint32_t*>(smem + l.pre);
  s.v_s = reinterpret_cast<int32_t*>(smem + l.v);
  s.cnt_s = reinterpret_cast<int32_t*>(smem + l.cnt);
  return s;
}

// Stage the tile's weight rows (contiguous in global memory) and zero
// the membrane and the counts.
__device__ __forceinline__ void load_tile(const Tile& s,
                                          const uint32_t* __restrict__ w_g,
                                          int rows_here, int W) {
  const int total = rows_here * W;
  for (int i = threadIdx.x; i < total; i += blockDim.x) s.w_s[i] = w_g[i];
  for (int r = threadIdx.x; r < rows_here; r += blockDim.x) {
    s.v_s[r] = 0;
    s.cnt_s[r] = 0;
  }
}

// One cycle of SPU + NU for every neuron of the tile (pre_s is ready).
__device__ __forceinline__ void integrate(const Tile& s, int rows_here,
                                          int W, int threshold, int leak) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rows_here; r += kWarps) {
    const uint32_t* row = s.w_s + static_cast<size_t>(r) * W;
    int acc = 0;
    for (int k = lane; k < W; k += 32) acc += __popc(s.pre_s[k] & row[k]);
    acc = snn::warp_sum(acc);
    if (lane == 0) {
      bool fired;
      s.v_s[r] = snn::lif_update(s.v_s[r], acc, threshold, leak, &fired);
      s.cnt_s[r] += fired ? 1 : 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
infer_window_kernel(const uint32_t* __restrict__ weights,
                    const uint32_t* __restrict__ spikes,
                    int32_t* __restrict__ counts, int n, int W, int T,
                    int threshold, int leak, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  const int rows_here = min(rows, n - row0);
  const Tile s = carve(smem, rows, W);

  load_tile(s, weights + static_cast<size_t>(row0) * W, rows_here, W);
  const uint32_t* s_g = spikes + static_cast<size_t>(b) * T * W;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const uint32_t* row = s_g + static_cast<size_t>(t) * W;
    for (int k = threadIdx.x; k < W; k += blockDim.x) s.pre_s[k] = row[k];
    __syncthreads();
    integrate(s, rows_here, W, threshold, leak);
    __syncthreads();
  }
  int32_t* out = counts + static_cast<size_t>(b) * n + row0;
  for (int r = threadIdx.x; r < rows_here; r += blockDim.x)
    out[r] = s.cnt_s[r];
}

// Neurons per block for an n-neuron, W-word bank, so that the block's
// layout fits `limit` bytes; 0 if not even one row fits.
int tile_rows(int n, int W, size_t limit) {
  int rows = std::min(n, kMaxTileRows);
  rows = std::min(rows, std::max(1, kTileWords / W));
  while (rows > 0 && layout(rows, W).total > limit) --rows;
  return rows;
}

// --- infer_window_batch_encode, window regime: one cluster a sample ---------

constexpr int kWinThreads = 512;
constexpr int kMaxCluster = 8;     // the portable cluster size

// Row stride (words) of the staged weight rows and spike rows: odd, so
// that threads on neighbouring rows read different banks.
__host__ __device__ __forceinline__ int odd_stride(int W) { return W | 1; }

// Shared-memory layout of one block of the window regime (dynamic,
// 16-byte aligned base), as byte offsets; every block of a cluster
// carves the same, and only the leader's c_s is read:
//   w_s   u32[n * ws]      the sample's weight rows (ws = odd_stride(W))
//   c_s   i32[T * n]       the sums of every cycle and neuron
//   pre_s u32[per * ws]    this block's cycles of the window
//   in_s  u8[32 * W]       the sample's intensities (read as u32)
struct WinLayout {
  size_t c, pre, in, total;
};

__host__ __device__ __forceinline__ WinLayout win_layout(int n, int W, int T,
                                                         int per) {
  const size_t ws = static_cast<size_t>(odd_stride(W));
  WinLayout l;
  l.c = static_cast<size_t>(n) * ws * 4;
  l.pre = l.c + static_cast<size_t>(T) * n * 4;
  l.in = l.pre + static_cast<size_t>(per) * ws * 4;
  l.total = l.in + static_cast<size_t>(W) * 32;
  return l;
}

__global__ void __launch_bounds__(kWinThreads)
infer_window_enc_kernel(const uint32_t* __restrict__ weights,
                        const uint8_t* __restrict__ intensities,
                        const int32_t* __restrict__ seeds,
                        const int32_t* __restrict__ t_total,
                        int32_t* __restrict__ counts, int n, int W,
                        int n_in, int n_steps, int threshold, int leak) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int ws = odd_stride(W);
  const WinLayout lay = win_layout(n, W, n_steps, (n_steps + C - 1) / C);
  uint32_t* w_s = reinterpret_cast<uint32_t*>(smem);
  int32_t* c_s = reinterpret_cast<int32_t*>(smem + lay.c);
  uint32_t* pre_s = reinterpret_cast<uint32_t*>(smem + lay.pre);
  uint8_t* in_s = smem + lay.in;

  for (int x = threadIdx.x; x < n * W; x += kWinThreads) {
    const int r = x / W;
    w_s[r * ws + x - r * W] = weights[x];
  }
  snn::stage_intensities(in_s, intensities + static_cast<size_t>(b) * n_in,
                         n_in, W);
  // this block's share of the sample's cycles: [t_lo, t_hi)
  const int t_end = min(max(t_total[b], 0), n_steps);
  const int per = (t_end + C - 1) / C;
  const int t_lo = min(rank * per, t_end);
  const int t_hi = min(t_lo + per, t_end);
  const uint32_t seed = static_cast<uint32_t>(seeds[b]);
  // staged, and every block of the cluster has started, so the leader's
  // shared memory may be written
  cluster.sync();

  // 1. the block's cycles of the window, every thread whole words
  for (int x = threadIdx.x; x < (t_hi - t_lo) * W; x += kWinThreads) {
    const int t = x / W;
    const int k = x - t * W;
    pre_s[t * ws + k] =
        snn::draw_word(in_s, seed, static_cast<uint32_t>(t_lo + t), k);
  }
  __syncthreads();

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

// --- infer_window_batch_encode, GEMM regime: draw, then sums and scan -------

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
constexpr int kSumChunk = 32;                    // words a staged chunk

// counts[b, row0 .. row0 + 63] from spikes[b, :t_end] (drawn above).
// Grid (n / 64, B).  Thread (warp, lane) sums cycles warp + 8 r of the
// pass against neurons lane and lane + 32.
__global__ void __launch_bounds__(kSumThreads)
infer_window_enc_sums_kernel(const uint32_t* __restrict__ weights,
                             const uint32_t* __restrict__ spikes,
                             const int32_t* __restrict__ t_total,
                             int32_t* __restrict__ counts, int n, int W,
                             int n_steps, int threshold, int leak) {
  __shared__ __align__(16) uint32_t pre_s[kSumCycles][kSumChunk];
  __shared__ uint32_t w_s[kSumChunk][kSumRows + 1];   // word-major
  __shared__ int32_t c_s[kSumCycles][kSumRows];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kSumRows;
  const int rows_here = min(kSumRows, n - row0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t_end = min(max(t_total[b], 0), n_steps);
  const uint32_t* s_g = spikes + static_cast<size_t>(b) * n_steps * W;
  const uint32_t* w_g = weights + static_cast<size_t>(row0) * W;
  int32_t v = 0;                 // the scan's neuron threadIdx.x (< 64)
  int cnt = 0;
  for (int t0 = 0; t0 < t_end; t0 += kSumCycles) {
    const int tc = min(kSumCycles, t_end - t0);
    // this warp's cycles of the pass: warp + 8 r < tc
    const int nr = (tc - warp + kSumWarps - 1) / kSumWarps;
    int acc[kSumRowTile][2];
#pragma unroll
    for (int r = 0; r < kSumRowTile; ++r) acc[r][0] = acc[r][1] = 0;
    for (int kc = 0; kc < W; kc += kSumChunk) {
      __syncthreads();   // the previous chunk (and pass) is consumed
      for (int x = threadIdx.x; x < kSumCycles * kSumChunk;
           x += kSumThreads) {
        const int t = x / kSumChunk;
        const int k = x % kSumChunk;
        pre_s[t][k] = t < tc && kc + k < W
                          ? s_g[static_cast<size_t>(t0 + t) * W + kc + k]
                          : 0u;
      }
      for (int x = threadIdx.x; x < kSumRows * kSumChunk; x += kSumThreads) {
        const int r = x / kSumChunk;
        const int k = x % kSumChunk;
        w_s[k][r] = r < rows_here && kc + k < W
                        ? w_g[static_cast<size_t>(r) * W + kc + k]
                        : 0u;
      }
      __syncthreads();
#pragma unroll 2
      for (int k = 0; k < kSumChunk; k += 4) {
        uint32_t wv[2][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wv[0][j] = w_s[k + j][lane];
          wv[1][j] = w_s[k + j][lane + 32];
        }
#pragma unroll
        for (int r = 0; r < kSumRowTile; ++r) {
          if (r >= nr) break;
          const uint4 p =
              *reinterpret_cast<const uint4*>(&pre_s[warp + kSumWarps * r][k]);
#pragma unroll
          for (int s = 0; s < 2; ++s)
            acc[r][s] += __popc(p.x & wv[s][0]) + __popc(p.y & wv[s][1])
                         + __popc(p.z & wv[s][2]) + __popc(p.w & wv[s][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kSumRowTile; ++r) {
      if (r >= nr) break;
      c_s[warp + kSumWarps * r][lane] = acc[r][0];
      c_s[warp + kSumWarps * r][lane + 32] = acc[r][1];
    }
    __syncthreads();
    if (threadIdx.x < rows_here) {
      for (int t = 0; t < tc; ++t) {
        bool fired;
        v = snn::lif_update(v, c_s[t][threadIdx.x], threshold, leak, &fired);
        cnt += fired ? 1 : 0;
      }
    }
  }
  if (threadIdx.x < rows_here)
    counts[static_cast<size_t>(b) * n + row0 + threadIdx.x] = cnt;
}

enum Regime { kWindowRegime = 0, kGemmRegime = 1 };

struct EncPlan {
  int regime;
  int cluster;   // window regime: blocks a sample
  size_t smem;   // window regime: bytes a block
};

// The encode kernel's regime for B samples of an n-neuron, W-word bank
// over n_steps cycles: the window regime where its layout fits a block,
// with a cluster of min(8, SMs / B, n_steps) blocks a sample; else GEMM.
cudaError_t plan_encode(int B, int n, int W, int n_steps, EncPlan* plan) {
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
  const size_t smem = win_layout(n, W, n_steps, (n_steps + c - 1) / c).total;
  *plan = smem <= limit ? EncPlan{kWindowRegime, c, smem}
                        : EncPlan{kGemmRegime, 1, 0};
  return cudaSuccess;
}

// Picks the tile, lets the kernel use its shared memory, launches.
int launch_prepacked(int B, int n, int W, void* stream,
                     const uint32_t* weights, const uint32_t* spikes,
                     int32_t* counts, int T, int threshold, int leak) {
  size_t limit = 0;
  cudaError_t err = snn::block_smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = tile_rows(n, W, limit);
  if (rows == 0) return snn::kRowTooWide;
  const size_t smem = layout(rows, W).total;
  err = snn::allow_smem(infer_window_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + rows - 1) / rows, B);
  infer_window_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      weights, spikes, counts, n, W, T, threshold, leak, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The encode kernel's plan for these shapes: out[0] the regime (0
// window, 1 GEMM: the launcher then needs a scratch of B * n_steps * W
// words), out[1] the window regime's cluster size, out[2] its shared
// bytes a block.  Returns 0 or a cudaError_t.
int snn_infer_encode_plan(int B, int n, int W, int n_steps, void* out) {
  EncPlan plan;
  const cudaError_t err = plan_encode(B, n, W, n_steps, &plan);
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
  EncPlan plan;
  cudaError_t err = plan_encode(B, n, W, n_steps, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* w = static_cast<const uint32_t*>(weights);
  const auto* x = static_cast<const uint8_t*>(intensities);
  const auto* sd = static_cast<const int32_t*>(seeds);
  const auto* tt = static_cast<const int32_t*>(t_total);
  auto* out = static_cast<int32_t*>(counts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan.regime == kWindowRegime) {
    err = snn::allow_smem(infer_window_enc_kernel, plan.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(plan.cluster, B);
    cfg.blockDim = dim3(kWinThreads);
    cfg.dynamicSmemBytes = plan.smem;
    cfg.stream = s;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = plan.cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, infer_window_enc_kernel, w, x, sd, tt, out,
                             n, W, n_in, n_steps, threshold, leak);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr) return kNoScratch;
  auto* spikes = static_cast<uint32_t*>(scratch);
  infer_window_enc_draw_kernel<<<
      dim3((W + kDrawThreads - 1) / kDrawThreads, B), kDrawThreads, 0, s>>>(
      x, sd, tt, spikes, W, n_in, n_steps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  infer_window_enc_sums_kernel<<<
      dim3((n + kSumRows - 1) / kSumRows, B), kSumThreads, 0, s>>>(
      w, spikes, tt, out, n, W, n_steps, threshold, leak);
  return static_cast<int>(cudaGetLastError());
}

// counts[B, n] (int32, written) from weights[n, W] and spikes[B, T, W]
// (u32 bit patterns).
int snn_infer_window_batch(const void* weights, const void* spikes,
                           void* counts, int B, int n, int W, int T,
                           int threshold, int leak, void* stream) {
  return launch_prepacked(B, n, W, stream,
                          static_cast<const uint32_t*>(weights),
                          static_cast<const uint32_t*>(spikes),
                          static_cast<int32_t*>(counts), T, threshold, leak);
}

// Neurons per block the pre-packed launcher chooses on the current device
// (0: a row does not fit), and the block's shared-memory bytes.
int snn_tile_rows(int n, int W) {
  size_t limit = 0;
  if (snn::block_smem_limit(&limit) != cudaSuccess) return 0;
  return tile_rows(n, W, limit);
}

long long snn_smem_bytes(int rows, int W) {
  return static_cast<long long>(layout(rows, W).total);
}

// Human-readable text of a code returned above.
const char* snn_error_string(int err) {
  if (err == snn::kRowTooWide)
    return "one synapse row does not fit a block's shared memory";
  if (err == kNoScratch)
    return "the encode kernel's GEMM regime needs a scratch window";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
