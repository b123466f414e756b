// Serving kernels of the Wenquxing 22A SNN for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/snn_kernels.py:
//   infer_window_enc_kernel  <- infer_window_batch_encode
//                               (_infer_window_enc_kernel): spikes drawn
//                               in-kernel from uint8 intensities.
//   infer_window_kernel      <- infer_window_batch
//                               (_infer_window_kernel): pre-packed spikes.
// Both compute spike counts int32[B, n] over a window of T cycles with
// frozen 1-bit weights u32[n, W] and the membrane reset per sample:
//   per cycle: c = popcount(pre & w[i]); v += c; fire iff v >= threshold;
//   a fired neuron resets to 0, else v = max(v - leak, 0).
//
// What bounds them on this card: integer instruction throughput.  The
// weights and intensities are read once (a few MB), but every (sample,
// cycle, neuron, word) costs an AND, a population count (a quarter-rate
// instruction) and an add, and the encode kernel adds ~14 integer
// operations per (sample, cycle, input) for the counter hash.  At the
// paper's width (n = 40, W = 25, B = 32) only 32 blocks run and each is
// a serial chain of cycles, so there latency, not throughput, sets the
// time.
//
// What the design does about it:
//   - Grid: one block per (tile of neurons, sample).  The tile's weight
//     rows are staged in shared memory once per window, so the T-cycle
//     loop reads them at shared-memory bandwidth, never from HBM.
//   - Each cycle the block builds the packed spike row in shared memory
//     (encode: one thread per word makes its 32 counter-hash draws from
//     the sample's intensities, also staged in shared memory; pre-packed:
//     the row is copied from spikes[b, t]).  Then each warp takes
//     neurons: lanes stride the words with __popc(pre & w) and reduce
//     with __shfl_xor_sync; lane 0 applies the LIF update.
//   - Ragged windows: cycles at or past t_total[b] change nothing
//     (frozen membrane, no spikes), so the encode kernel stops there.
//     The host version zero-masks those cycles instead; the counts are
//     equal for any threshold >= 1, which the wrapper enforces.
//   - Known cost, left for later: every neuron tile redraws its
//     sample's spike row.  At n = 40 there is one tile per sample, so
//     nothing is redrawn; at large n the hashing is repeated per tile.
//
// Plain C interface (bound with ctypes): each launcher picks the neuron
// tile from the device's shared memory, launches on the given stream,
// does not synchronize, and returns cudaGetLastError() (or kRowTooWide).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "snn_common.cuh"

namespace {

using snn::kThreads;
using snn::kWarps;

// Weight tiles: at most kTileWords words (128 KiB) and kMaxTileRows
// neurons per block, so large layers still give many blocks.
constexpr int kTileWords = 32768;
constexpr int kMaxTileRows = 64;

// Shared-memory layout of one block (dynamic, 16-byte aligned base), as
// byte offsets; the one statement of it, for the kernels and the host:
//   w_s   u32[rows * W]   the tile's weight rows
//   pre_s u32[W]          this cycle's packed spike row
//   v_s   i32[rows]       membrane potentials
//   cnt_s i32[rows]       spike counts
//   in_s  u8[32 * W]      (encode only) the sample's intensities
// Every offset is a multiple of 4: the encode draw reads in_s by words.
struct Layout {
  size_t pre, v, cnt, in, total;
};

__host__ __device__ __forceinline__ Layout layout(int rows, int W,
                                                  bool encode) {
  Layout l;
  l.pre = static_cast<size_t>(rows) * W * 4;
  l.v = l.pre + static_cast<size_t>(W) * 4;
  l.cnt = l.v + static_cast<size_t>(rows) * 4;
  l.in = l.cnt + static_cast<size_t>(rows) * 4;
  l.total = l.in + (encode ? static_cast<size_t>(W) * 32 : 0);
  return l;
}

struct Tile {
  uint32_t* w_s;
  uint32_t* pre_s;
  int32_t* v_s;
  int32_t* cnt_s;
  uint8_t* in_s;
};

__device__ __forceinline__ Tile carve(unsigned char* smem, int rows, int W,
                                      bool encode) {
  const Layout l = layout(rows, W, encode);
  Tile s;
  s.w_s = reinterpret_cast<uint32_t*>(smem);
  s.pre_s = reinterpret_cast<uint32_t*>(smem + l.pre);
  s.v_s = reinterpret_cast<int32_t*>(smem + l.v);
  s.cnt_s = reinterpret_cast<int32_t*>(smem + l.cnt);
  s.in_s = smem + l.in;
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

__device__ __forceinline__ void store_counts(const Tile& s,
                                             int32_t* __restrict__ out,
                                             int rows_here) {
  for (int r = threadIdx.x; r < rows_here; r += blockDim.x)
    out[r] = s.cnt_s[r];
}

__global__ void __launch_bounds__(kThreads)
infer_window_enc_kernel(const uint32_t* __restrict__ weights,
                        const uint8_t* __restrict__ intensities,
                        const int32_t* __restrict__ seeds,
                        const int32_t* __restrict__ t_total,
                        int32_t* __restrict__ counts, int n, int W,
                        int n_in, int n_steps, int threshold, int leak,
                        int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  const int rows_here = min(rows, n - row0);
  const Tile s = carve(smem, rows, W, true);

  load_tile(s, weights + static_cast<size_t>(row0) * W, rows_here, W);
  snn::stage_intensities(s.in_s, intensities + static_cast<size_t>(b) * n_in,
                         n_in, W);
  const uint32_t seed = static_cast<uint32_t>(seeds[b]);
  const int t_end = min(max(t_total[b], 0), n_steps);
  __syncthreads();

  for (int t = 0; t < t_end; ++t) {
    for (int k = threadIdx.x; k < W; k += blockDim.x)
      s.pre_s[k] = snn::draw_word(s.in_s, seed, static_cast<uint32_t>(t), k);
    __syncthreads();
    integrate(s, rows_here, W, threshold, leak);
    __syncthreads();
  }
  store_counts(s, counts + static_cast<size_t>(b) * n + row0, rows_here);
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
  const Tile s = carve(smem, rows, W, false);

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
  store_counts(s, counts + static_cast<size_t>(b) * n + row0, rows_here);
}

// Neurons per block for an n-neuron, W-word bank, so that the block's
// layout fits `limit` bytes; 0 if not even one row fits.
int tile_rows(int n, int W, bool encode, size_t limit) {
  int rows = std::min(n, kMaxTileRows);
  rows = std::min(rows, std::max(1, kTileWords / W));
  while (rows > 0 && layout(rows, W, encode).total > limit) --rows;
  return rows;
}

// Picks the tile, lets the kernel use its shared memory, launches.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int B, int n, int W, bool encode, void* stream,
           Args... args) {
  size_t limit = 0;
  cudaError_t err = snn::block_smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = tile_rows(n, W, encode, limit);
  if (rows == 0) return snn::kRowTooWide;
  const size_t smem = layout(rows, W, encode).total;
  err = snn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + rows - 1) / rows, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      args..., rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// counts[B, n] (int32, written) from weights[n, W] (u32 bit patterns),
// intensities[B, n_in] (u8), seeds[B] and t_total[B] (int32).
int snn_infer_window_batch_encode(const void* weights,
                                  const void* intensities,
                                  const void* seeds, const void* t_total,
                                  void* counts, int B, int n, int W,
                                  int n_in, int n_steps, int threshold,
                                  int leak, void* stream) {
  return launch(infer_window_enc_kernel, B, n, W, true, stream,
                static_cast<const uint32_t*>(weights),
                static_cast<const uint8_t*>(intensities),
                static_cast<const int32_t*>(seeds),
                static_cast<const int32_t*>(t_total),
                static_cast<int32_t*>(counts), n, W, n_in, n_steps,
                threshold, leak);
}

// counts[B, n] (int32, written) from weights[n, W] and spikes[B, T, W]
// (u32 bit patterns).
int snn_infer_window_batch(const void* weights, const void* spikes,
                           void* counts, int B, int n, int W, int T,
                           int threshold, int leak, void* stream) {
  return launch(infer_window_kernel, B, n, W, false, stream,
                static_cast<const uint32_t*>(weights),
                static_cast<const uint32_t*>(spikes),
                static_cast<int32_t*>(counts), n, W, T, threshold, leak);
}

// Neurons per block the launchers above choose on the current device
// (0: a row does not fit), and the block's shared-memory bytes.
int snn_tile_rows(int n, int W, int encode) {
  size_t limit = 0;
  if (snn::block_smem_limit(&limit) != cudaSuccess) return 0;
  return tile_rows(n, W, encode != 0, limit);
}

long long snn_smem_bytes(int rows, int W, int encode) {
  return static_cast<long long>(layout(rows, W, encode != 0).total);
}

// Human-readable text of a code returned above.
const char* snn_error_string(int err) {
  if (err == snn::kRowTooWide)
    return "one synapse row does not fit a block's shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
