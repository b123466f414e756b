// Training-window kernels of the Wenquxing 22A SNN for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of src/repro/kernels/snn_kernels.py:
//   train_window_kernel      <- train_window_batch (_train_window_kernel):
//                               B streams x T cycles of SPU + teach -> LIF
//                               -> STDP on fired rows, pre-packed spikes;
//                               also fused_snn_window(train=True) (B = 1).
//   train_window_enc_kernel  <- train_window_batch_encode
//                               (_train_window_enc_kernel): the same with
//                               each cycle's spikes drawn in-kernel from
//                               uint8 intensities; also
//                               fused_snn_window_encode(train=True).
//   window_infer_kernel      <- fused_snn_window(train=False)
//                               (_window_infer_kernel): a read-only window
//                               with a teacher current and a carried v.
//   window_infer_enc_kernel  <- fused_snn_window_encode(train=False)
//                               (_window_infer_enc_kernel).
// Per cycle, for each neuron i of each stream:
//   c = popcount(pre & w[i]) + teach[i]; v += c; fire iff v >= threshold;
//   a fired neuron resets to 0, else v = max(v - leak, 0);
//   if it fired (train kernels): per word, two LFSR steps s1, s2; LTP
//   w |= pre when (s1 & 0x3FF) <= ltp_prob (u32 compare); then with pc
//   the popcount of the LTP'd row, LTD w &= pre when (s2 & 0x3FF) <=
//   clip((pc - w_exp) * gain * 1024 / n_syn, 0, 1023); the lane keeps s2.
//
// What bounds them on this card: the serial chain of cycles.  Each cycle
// depends on the last through v, the weights and the LFSR, and the STDP
// row popcount needs the whole row before LTD can start.  At the paper's
// width (n = 10 per stream, W = 25 words, B <= 4 streams) a launch is 1
// to 4 blocks on 132 SMs, each a chain of T = 72 cycles, so latency, not
// throughput, sets the time.  At large widths (65,536 inputs) integer
// throughput does: popcounts for every (stream, cycle, neuron, word), the
// STDP word updates of every fired row, and ~14 operations per (stream,
// cycle, input) for the encode kernels' counter hash.
//
// What the design does about it:
//   - Grid: one block per (tile of neurons, stream).  The block stages
//     its rows' weights and LFSR lanes in shared memory once, loops over
//     the T cycles inside the block, and writes weights, LFSR and v to
//     new output tensors at the end: state crosses HBM once per window.
//   - Each cycle the block builds the stream's packed spike row in shared
//     memory (drawn with the counter hash, or copied from spikes[b, t]),
//     then synchronizes once.
//   - A warp owns its rows for the whole cycle: SPU popcount and a
//     shuffle reduction, the LIF update, the fired byte, and, only for a
//     fired row, the STDP pass over its words with a second shuffle
//     reduction for the row popcount.  No block barrier is needed inside
//     the cycle; one at its end keeps the next row build from
//     overwriting pre while warps still read it.
//   - The LFSR lanes are staged as full u32 words, so a lane with stray
//     high bits steps exactly as in the plain version.
//   - The read-only kernels are the same template with the STDP compiled
//     out; they write only v and the raster.
//   - Known costs, left for later: the encode kernels redraw each
//     stream's spike row in every neuron tile (nothing is redrawn at the
//     trainer's n = 10); the trainer launches one kernel per presented
//     sample.
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

// Tiles: at most kTileWords weight words and kMaxTileRows neurons per
// block, so large layers still give many blocks.
constexpr int kTileWords = 32768;
constexpr int kMaxTileRows = 64;

// Shared-memory layout of one block (dynamic, 16-byte aligned base), as
// byte offsets; the one statement of it, for the kernels and the host:
//   w_s     u32[rows * W]   the tile's weight rows
//   l_s     u32[rows * W]   (train only) their LFSR lanes
//   pre_s   u32[W]          this cycle's packed spike row
//   v_s     i32[rows]       membrane potentials
//   teach_s i32[rows]       teacher currents
//   in_s    u8[32 * W]      (encode only) the stream's intensities
// Every offset is a multiple of 4: the encode draw reads in_s by words.
struct Layout {
  size_t lfsr, pre, v, teach, in, total;
};

__host__ __device__ __forceinline__ Layout layout(int rows, int W,
                                                  bool encode, bool learn) {
  const size_t words = static_cast<size_t>(rows) * W * 4;
  Layout l;
  l.lfsr = words;
  l.pre = l.lfsr + (learn ? words : 0);
  l.v = l.pre + static_cast<size_t>(W) * 4;
  l.teach = l.v + static_cast<size_t>(rows) * 4;
  l.in = l.teach + static_cast<size_t>(rows) * 4;
  l.total = l.in + (encode ? static_cast<size_t>(W) * 32 : 0);
  return l;
}

// Everything a launch reads and writes; pointers the form does not use
// are null.  State tensors are [B, n, W] words and [B, n] neurons, the
// raster [B, T, n] bytes.
struct Operands {
  const uint32_t* weights;
  const uint32_t* lfsr;         // train
  const uint32_t* spikes;       // pre-packed: [B, T, W]
  const uint8_t* intensities;   // encode: [B, n_in]
  const int32_t* seeds;         // encode: [B]
  const int32_t* v;
  const int32_t* teach;
  const int32_t* ltp_prob;      // train: [B]
  uint32_t* w_out;              // train
  int32_t* v_out;
  uint8_t* fired;
  uint32_t* lfsr_out;           // train
  int n, W, T, n_in, threshold, leak, w_exp, gain, n_syn;
};

template <bool kEncode, bool kLearn>
__device__ __forceinline__ void window(const Operands& o, int rows,
                                       unsigned char* smem) {
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  const int rows_here = min(rows, o.n - row0);
  const int W = o.W;
  const Layout l = layout(rows, W, kEncode, kLearn);
  uint32_t* w_s = reinterpret_cast<uint32_t*>(smem);
  uint32_t* l_s = reinterpret_cast<uint32_t*>(smem + l.lfsr);
  uint32_t* pre_s = reinterpret_cast<uint32_t*>(smem + l.pre);
  int32_t* v_s = reinterpret_cast<int32_t*>(smem + l.v);
  int32_t* teach_s = reinterpret_cast<int32_t*>(smem + l.teach);
  uint8_t* in_s = smem + l.in;

  // Stage the tile: weight rows (and LFSR lanes), v, teach, intensities.
  const size_t nrn0 = static_cast<size_t>(b) * o.n + row0;
  const size_t word0 = nrn0 * W;
  const int words = rows_here * W;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    w_s[i] = o.weights[word0 + i];
    if (kLearn) l_s[i] = o.lfsr[word0 + i];
  }
  for (int r = threadIdx.x; r < rows_here; r += blockDim.x) {
    v_s[r] = o.v[nrn0 + r];
    teach_s[r] = o.teach[nrn0 + r];
  }
  uint32_t seed = 0;
  if (kEncode) {
    snn::stage_intensities(
        in_s, o.intensities + static_cast<size_t>(b) * o.n_in, o.n_in, W);
    seed = static_cast<uint32_t>(o.seeds[b]);
  }
  const uint32_t ltp_prob = kLearn ? static_cast<uint32_t>(o.ltp_prob[b]) : 0;
  const uint32_t* spikes_b =
      kEncode ? nullptr : o.spikes + static_cast<size_t>(b) * o.T * W;
  uint8_t* fired_b = o.fired + static_cast<size_t>(b) * o.T * o.n + row0;
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int t = 0; t < o.T; ++t) {
    for (int k = threadIdx.x; k < W; k += blockDim.x)
      pre_s[k] = kEncode
          ? snn::draw_word(in_s, seed, static_cast<uint32_t>(t), k)
          : spikes_b[static_cast<size_t>(t) * W + k];
    __syncthreads();
    for (int r = warp; r < rows_here; r += kWarps) {
      uint32_t* row = w_s + static_cast<size_t>(r) * W;
      const int32_t v = v_s[r];        // read before the shuffles below
      const int32_t teach = teach_s[r];
      int acc = 0;
      for (int k = lane; k < W; k += 32) acc += __popc(pre_s[k] & row[k]);
      bool fired;
      const int32_t v_next = snn::lif_update(
          v, snn::add32(snn::warp_sum(acc), teach), o.threshold, o.leak,
          &fired);
      if (lane == 0) {
        v_s[r] = v_next;
        fired_b[static_cast<size_t>(t) * o.n + r] = fired;
      }
      if (kLearn && fired) {           // uniform across the warp
        uint32_t* st = l_s + static_cast<size_t>(r) * W;
        snn::stdp_row(row, st, row, st, pre_s, W, lane, ltp_prob, o.w_exp,
                      o.gain, o.n_syn);
      }
    }
    __syncthreads();
  }

  for (int r = threadIdx.x; r < rows_here; r += blockDim.x)
    o.v_out[nrn0 + r] = v_s[r];
  if (kLearn) {
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      o.w_out[word0 + i] = w_s[i];
      o.lfsr_out[word0 + i] = l_s[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
train_window_kernel(Operands o, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  window<false, true>(o, rows, smem);
}

__global__ void __launch_bounds__(kThreads)
train_window_enc_kernel(Operands o, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  window<true, true>(o, rows, smem);
}

__global__ void __launch_bounds__(kThreads)
window_infer_kernel(Operands o, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  window<false, false>(o, rows, smem);
}

__global__ void __launch_bounds__(kThreads)
window_infer_enc_kernel(Operands o, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  window<true, false>(o, rows, smem);
}

// Neurons per block for an n-neuron, W-word bank, so that the block's
// layout fits `limit` bytes; 0 if not even one row fits.
int tile_rows(int n, int W, bool encode, bool learn, size_t limit) {
  int rows = std::min(n, kMaxTileRows);
  rows = std::min(rows, std::max(1, kTileWords / std::max(W, 1)));
  while (rows > 0 && layout(rows, W, encode, learn).total > limit) --rows;
  return rows;
}

// Picks the tile, lets the kernel use its shared memory, launches.
template <typename Kernel>
int launch(Kernel kernel, const Operands& o, int B, bool encode, bool learn,
           void* stream) {
  size_t limit = 0;
  cudaError_t err = snn::block_smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = tile_rows(o.n, o.W, encode, learn, limit);
  if (rows == 0) return snn::kRowTooWide;
  const size_t smem = layout(rows, o.W, encode, learn).total;
  err = snn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((o.n + rows - 1) / rows, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(o,
                                                                       rows);
  return static_cast<int>(cudaGetLastError());
}

Operands operands(const void* weights, const void* v, const void* teach,
                  void* v_out, void* fired, int n, int W, int T,
                  int threshold, int leak) {
  Operands o = {};
  o.weights = static_cast<const uint32_t*>(weights);
  o.v = static_cast<const int32_t*>(v);
  o.teach = static_cast<const int32_t*>(teach);
  o.v_out = static_cast<int32_t*>(v_out);
  o.fired = static_cast<uint8_t*>(fired);
  o.n = n;
  o.W = W;
  o.T = T;
  o.threshold = threshold;
  o.leak = leak;
  return o;
}

void set_learning(Operands* o, const void* lfsr, const void* ltp_prob,
                  void* w_out, void* lfsr_out, int w_exp, int gain,
                  int n_syn) {
  o->lfsr = static_cast<const uint32_t*>(lfsr);
  o->ltp_prob = static_cast<const int32_t*>(ltp_prob);
  o->w_out = static_cast<uint32_t*>(w_out);
  o->lfsr_out = static_cast<uint32_t*>(lfsr_out);
  o->w_exp = w_exp;
  o->gain = gain;
  o->n_syn = n_syn;
}

void set_encode(Operands* o, const void* intensities, const void* seeds,
                int n_in) {
  o->intensities = static_cast<const uint8_t*>(intensities);
  o->seeds = static_cast<const int32_t*>(seeds);
  o->n_in = n_in;
}

}  // namespace

extern "C" {

// B training streams over pre-packed windows.  Reads weights, lfsr
// [B, n, W] (u32), spikes [B, T, W] (u32), v, teach [B, n] and
// ltp_prob [B] (int32); writes w_out, lfsr_out, v_out and fired
// [B, T, n] (bytes).  n_syn >= 1.
int snn_train_window_batch(const void* weights, const void* spikes,
                           const void* v, const void* lfsr,
                           const void* teach, const void* ltp_prob,
                           void* w_out, void* v_out, void* fired,
                           void* lfsr_out, int B, int n, int W, int T,
                           int threshold, int leak, int w_exp, int gain,
                           int n_syn, void* stream) {
  Operands o = operands(weights, v, teach, v_out, fired, n, W, T, threshold,
                        leak);
  o.spikes = static_cast<const uint32_t*>(spikes);
  set_learning(&o, lfsr, ltp_prob, w_out, lfsr_out, w_exp, gain, n_syn);
  return launch(train_window_kernel, o, B, false, true, stream);
}

// B training streams with spikes drawn in-kernel from intensities
// [B, n_in] (u8) and seeds [B] (int32) over n_steps cycles.
int snn_train_window_batch_encode(const void* weights,
                                  const void* intensities,
                                  const void* seeds, const void* v,
                                  const void* lfsr, const void* teach,
                                  const void* ltp_prob, void* w_out,
                                  void* v_out, void* fired, void* lfsr_out,
                                  int B, int n, int W, int n_in, int n_steps,
                                  int threshold, int leak, int w_exp,
                                  int gain, int n_syn, void* stream) {
  Operands o = operands(weights, v, teach, v_out, fired, n, W, n_steps,
                        threshold, leak);
  set_encode(&o, intensities, seeds, n_in);
  set_learning(&o, lfsr, ltp_prob, w_out, lfsr_out, w_exp, gain, n_syn);
  return launch(train_window_enc_kernel, o, B, true, true, stream);
}

// Read-only windows (SU idle) over pre-packed spikes: writes v_out
// [B, n] and fired [B, T, n] only.
int snn_window_infer(const void* weights, const void* spikes, const void* v,
                     const void* teach, void* v_out, void* fired, int B,
                     int n, int W, int T, int threshold, int leak,
                     void* stream) {
  Operands o = operands(weights, v, teach, v_out, fired, n, W, T, threshold,
                        leak);
  o.spikes = static_cast<const uint32_t*>(spikes);
  return launch(window_infer_kernel, o, B, false, false, stream);
}

// Read-only windows with the in-kernel draw.
int snn_window_infer_encode(const void* weights, const void* intensities,
                            const void* seeds, const void* v,
                            const void* teach, void* v_out, void* fired,
                            int B, int n, int W, int n_in, int n_steps,
                            int threshold, int leak, void* stream) {
  Operands o = operands(weights, v, teach, v_out, fired, n, W, n_steps,
                        threshold, leak);
  set_encode(&o, intensities, seeds, n_in);
  return launch(window_infer_enc_kernel, o, B, true, false, stream);
}

// Neurons per block the launchers above choose on the current device
// (0: a row does not fit), and the block's shared-memory bytes.
int snn_train_tile_rows(int n, int W, int encode, int learn) {
  size_t limit = 0;
  if (snn::block_smem_limit(&limit) != cudaSuccess) return 0;
  return tile_rows(n, W, encode != 0, learn != 0, limit);
}

long long snn_train_smem_bytes(int rows, int W, int encode, int learn) {
  return static_cast<long long>(layout(rows, W, encode != 0, learn != 0).total);
}

// Human-readable text of a code returned above.
const char* snn_train_error_string(int err) {
  if (err == snn::kRowTooWide)
    return "one synapse row does not fit a block's shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
