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
//                               uint8 intensities, over a stream of N
//                               samples per launch (the JAX package's
//                               lax.scan of train_stream_batch); N = 1 is
//                               the single window, also
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
// Over a stream, v resets to 0 at each sample's start (the N = 1 window
// starts from the caller's v); weights and LFSR carry from sample to
// sample.
//
// What bounds them on this card: the serial chain of cycles.  Each cycle
// depends on the last through v, the weights and the LFSR, and the STDP
// row popcount needs the whole row before LTD can start.  At the paper's
// width (n = 10 per stream, W = 25 words, B <= 4 streams) a launch is 1
// to 4 blocks on 132 SMs, each a chain of T = 72 cycles per sample, so
// latency, not throughput, sets the time.  At large widths (65,536
// inputs) integer throughput does: popcounts for every (stream, cycle,
// neuron, word), the STDP word updates of every fired row, and ~14
// operations per (stream, cycle, input) for the counter hash.
//
// What the design does about it:
//   - Grid: one block per (tile of neurons, stream).  The block stages
//     its rows' weights and LFSR lanes in shared memory once, runs every
//     sample of the stream inside the block, and writes weights, LFSR and
//     v at the end: state crosses HBM once per stream, not once per
//     sample.  Per-sample spike counts accumulate in registers; only the
//     N = 1 form writes the [B, T, n] raster.
//   - The spike window depends on no state.  Where two fit beside the
//     tile (the paper's width: 72 x 25 words, 7.2 KB each), the rows run
//     on at most 12 warps and the other 4 or more (6 at the trainer's 10
//     rows) draw sample i + 1's whole window into the second buffer
//     while the rows run sample i, each thread drawing whole words (the
//     32 hashes of a word in flight together).  The cycles then need no
//     barrier: a warp owns its rows, runs each through all T cycles with
//     v and the count in registers, and no other warp reads what it
//     writes.  A sample costs the longer of the rows and the draw, plus
//     the one barrier that ends it.  (Drawing a word per warp instead,
//     one hash per lane and a ballot, was slower on the H100 at both
//     widths.)
//   - A row of at most 32 words (784 inputs: 25) lives in registers, one
//     word of weights and LFSR per lane.  While it does not fire, its
//     cycle sums are independent, so the loop is software-pipelined:
//     spike words load three cycles ahead, sums (AND, popcount, redux)
//     two cycles ahead, and only the LIF update is left on the chain.  A
//     fired cycle's STDP arithmetic runs on the registers: the two LFSR
//     steps in closed form (snn::lfsr_step2) and the LTD test without a
//     division (snn::ltd_hit).
//   - Where the window does not fit beside the tile (65,536 inputs), each
//     cycle's row is drawn by all threads into one of two buffers, with
//     one block barrier per cycle.
//   - 16 warps: at the trainer's n = 10 no warp runs two rows in series,
//     and 6 draw.
//     The row sums use redux.sync (snn::warp_add), not five shuffles.
//   - Wider rows stay in shared memory: a warp's SPU popcount, LIF update,
//     fired flag and, only for a fired row, the STDP pass (snn::stdp_row)
//     over its words.  Each word of a row is read and written by one lane
//     only, cycle after cycle.
//   - The LFSR lanes are staged as full u32 words, so a lane with stray
//     high bits steps exactly as in the plain version.
//   - The read-only kernels are the same template with the STDP compiled
//     out; they write only v and the raster.
//   - The shared-memory opt-in is set once per process and device.
//   - Known costs, left for later: at 65,536 inputs every neuron tile
//     redraws the stream's spike row; the pre-packed and read-only forms
//     still take one launch per sample.
//
// Plain C interface (bound with ctypes): each launcher picks the neuron
// tile from the device's shared memory, launches on the given stream,
// does not synchronize, and returns cudaGetLastError() (or kRowTooWide).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>

#include "snn_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Tiles: at most kTileWords weight words and kMaxTileRows neurons per
// block, so large layers still give many blocks.
constexpr int kTileWords = 32768;
constexpr int kMaxTileRows = 64;
constexpr int kMaxDevices = 64;
// Warps kept from the rows to draw the next sample's window.
constexpr int kDrawWarps = 4;

// Shared-memory layout of one block (dynamic, 16-byte aligned base), as
// byte offsets; the one statement of it, for the kernels and the host:
//   w_s     u32[rows * W]      the tile's weight rows
//   l_s     u32[rows * W]      (train only) their LFSR lanes
//   win_s   u32[win_rows * W]  spike rows: two whole windows (2 T: this
//                              sample's and the next), or two cycles'
//                              rows (2)
//   v_s     i32[rows]          membrane potentials
//   c_s     i32[rows]          spike counts of the sample
//   teach_s i32[2 * rows]      teacher currents, this sample's and the next
//   in_s    u8[32 * W]         (encode only) the sample's intensities
// Every offset is a multiple of 4: the draw reads in_s by words.
struct Layout {
  size_t lfsr, win, v, count, teach, in, total;
};

// Spike rows the block holds: see win_s above.
__host__ __device__ __forceinline__ int window_rows(bool resident, int T) {
  return resident ? 2 * T : 2;
}

__host__ __device__ __forceinline__ Layout layout(int rows, int W,
                                                  int win_rows, bool encode,
                                                  bool learn) {
  const size_t words = static_cast<size_t>(rows) * W * 4;
  Layout l;
  l.lfsr = words;
  l.win = l.lfsr + (learn ? words : 0);
  l.v = l.win + static_cast<size_t>(win_rows) * W * 4;
  l.count = l.v + static_cast<size_t>(rows) * 4;
  l.teach = l.count + static_cast<size_t>(rows) * 4;
  l.in = l.teach + static_cast<size_t>(rows) * 8;
  l.total = l.in + (encode ? static_cast<size_t>(W) * 32 : 0);
  return l;
}

// Everything a launch reads and writes; pointers the form does not use
// are null.  State tensors are [B, n, W] words and [B, n] neurons.  The
// per-sample operands (intensities [.., n_in] bytes, seeds, teach
// [.., n]) are read at element offset i * *_sample + b * *_stream for
// sample i of stream b (a stride may be 0: one operand shared by every
// stream); pre-packed spikes are [N, B, T, W].
struct Operands {
  const uint32_t* weights;
  const uint32_t* lfsr;         // train
  const uint32_t* spikes;       // pre-packed
  const uint8_t* intensities;   // encode
  const int32_t* seeds;         // encode
  const int32_t* v;             // each sample's starting v [B, n]; null: 0
  const int32_t* teach;
  const int32_t* ltp_prob;      // train: [B]
  uint32_t* w_out;              // train
  int32_t* v_out;               // the last sample's v'
  uint8_t* fired;               // [N, B, T, n] or null
  int32_t* counts;              // [N, B, n] or null
  uint32_t* lfsr_out;           // train
  long long in_sample, in_stream, seed_sample, seed_stream, teach_sample,
      teach_stream;
  int N, n, W, T, n_in, threshold, leak, w_exp, gain, n_syn;
  int resident;                 // whole windows stay in shared memory
};

// Sample i's per-stream inputs into shared memory, by threads tid,
// tid + nthreads, ...: the tile's teacher currents into teach_s and
// (encode) the intensities into in_s[0, n_in) (the padding up to 32 W
// stays 0, so padding inputs never fire).
template <bool kEncode>
__device__ __forceinline__ void stage_sample(const Operands& o, int i,
                                             int b, int row0, int rows_here,
                                             int32_t* teach_s, uint8_t* in_s,
                                             int tid, int nthreads) {
  const int32_t* tg = o.teach + i * o.teach_sample + b * o.teach_stream +
                      row0;
  for (int r = tid; r < rows_here; r += nthreads) teach_s[r] = tg[r];
  if (!kEncode) return;
  const uint8_t* src = o.intensities + i * o.in_sample + b * o.in_stream;
  for (int j = tid; j < o.n_in; j += nthreads) in_s[j] = src[j];
}

// Spike rows t0 .. t0 + count - 1 of sample i into dst (row-major), by
// threads tid, tid + nthreads, ...: each draws whole words, the 32
// independent hashes of a word in flight together (snn::draw_word), or
// copies them from spikes.
template <bool kEncode>
__device__ __forceinline__ void fill_rows(const Operands& o, int i, int b,
                                          uint32_t* dst, const uint8_t* in_s,
                                          int t0, int count, int tid,
                                          int nthreads) {
  const int W = o.W;
  const int total = count * W;
  if (kEncode) {
    const uint32_t seed = static_cast<uint32_t>(
        o.seeds[i * o.seed_sample + b * o.seed_stream]);
    for (int idx = tid; idx < total; idx += nthreads) {
      const int dt = idx / W;
      dst[idx] = snn::draw_word(in_s, seed, static_cast<uint32_t>(t0 + dt),
                                idx - dt * W);
    }
  } else {
    const uint32_t* src =
        o.spikes + ((static_cast<size_t>(i) * gridDim.y + b) * o.T + t0) * W;
    for (int idx = tid; idx < total; idx += nthreads) dst[idx] = src[idx];
  }
}

// One cycle of one row by its warp: SPU popcount against pre, LIF, and
// the STDP pass on a fired row.  Returns v'; `fired` is the same on
// every lane.
template <bool kLearn>
__device__ __forceinline__ int32_t cycle(const Operands& o, uint32_t* row,
                                         uint32_t* st, const uint32_t* pre,
                                         int lane, int32_t v, int32_t teach,
                                         uint32_t ltp_prob, bool* fired) {
  int acc = 0;
  for (int k = lane; k < o.W; k += 32) acc += __popc(pre[k] & row[k]);
  const int32_t v_next = snn::lif_update(
      v, snn::add32(snn::warp_add(acc), teach), o.threshold, o.leak, fired);
  if (kLearn && *fired)             // uniform across the warp
    snn::stdp_row(row, st, row, st, pre, o.W, lane, ltp_prob, o.w_exp,
                  o.gain, o.n_syn);
  return v_next;
}

// One row through a resident window's T cycles, its words in shared
// memory.  Returns v'; `count` gets the row's spikes; `fired` (or null)
// the raster column, stride n.
template <bool kLearn>
__device__ __forceinline__ int32_t row_in_shared(
    const Operands& o, uint32_t* row, uint32_t* st, const uint32_t* win,
    int lane, int32_t v, int32_t teach, uint32_t ltp_prob, uint8_t* fired,
    int* count) {
  int c = 0;
  for (int t = 0; t < o.T; ++t) {
    bool f;
    v = cycle<kLearn>(o, row, st, win + static_cast<size_t>(t) * o.W, lane,
                      v, teach, ltp_prob, &f);
    c += f;
    if (fired && lane == 0) fired[static_cast<size_t>(t) * o.n] = f;
  }
  *count = c;
  return v;
}

// The same for a row of at most 32 words (the paper's 25): lane k holds
// word k of the weights and LFSR in registers for all T cycles (lanes past
// W hold zeros, which change nothing).  While a row does not fire its
// weights do not change, so the cycle sums do not depend on each other:
// the loop is software-pipelined, each cycle's spike word loaded three
// cycles ahead and its sum (AND, popcount, warp sum) taken two cycles
// ahead, leaving only the LIF update on the chain.  A fired cycle changes
// the row, so after its STDP arithmetic it takes the next two sums again.
// The row's words go back to shared memory at the end.
template <bool kLearn>
__device__ __forceinline__ int32_t row_in_registers(
    const Operands& o, uint32_t* row, uint32_t* st, const uint32_t* win,
    int lane, int32_t v, int32_t teach, uint32_t ltp_prob, uint8_t* fired,
    int* count) {
  const int W = o.W, T = o.T;
  *count = 0;
  if (T == 0) return v;
  const bool mine = lane < W;
  const uint32_t keep = mine ? 0xffffffffu : 0u;
  const int col = mine ? lane : 0;
  // cycle t's spike word, in bounds for any t (masked past W)
  auto spikes = [&](int t) { return win[min(t, T - 1) * W + col] & keep; };
  uint32_t w = row[col] & keep;
  uint32_t lanes = kLearn ? st[col] & keep : 0;
  uint32_t pre = spikes(0), pre1 = spikes(1), pre2 = spikes(2);
  int sum = snn::warp_add(__popc(pre & w));
  int sum1 = snn::warp_add(__popc(pre1 & w));
  int c = 0;
  for (int t = 0; t < T; ++t) {
    const uint32_t pre3 = spikes(t + 3);
    bool f;
    v = snn::lif_update(v, snn::add32(sum, teach), o.threshold, o.leak, &f);
    int sum2 = snn::warp_add(__popc(pre2 & w));
    c += f;
    if (fired && lane == 0) fired[static_cast<size_t>(t) * o.n] = f;
    if (kLearn && f) {              // uniform across the warp
      if (((lanes >> 1) & 0x3FFu) <= ltp_prob) w |= pre;
      const uint32_t x = (lanes >> 2) & 0x3FFu;   // the second step's draw
      lanes = snn::lfsr_step2(lanes);
      const int32_t excess =
          snn::ltd_excess(snn::warp_add(__popc(w)), o.w_exp, o.gain);
      if (snn::ltd_hit(x, excess, o.n_syn)) w &= pre;
      sum1 = snn::warp_add(__popc(pre1 & w));
      sum2 = snn::warp_add(__popc(pre2 & w));
    }
    sum = sum1;
    sum1 = sum2;
    pre = pre1;
    pre1 = pre2;
    pre2 = pre3;
  }
  if (mine) {
    row[lane] = w;
    if (kLearn) st[lane] = lanes;
  }
  *count = c;
  return v;
}

template <bool kEncode, bool kLearn>
__device__ __forceinline__ void window(const Operands& o, int rows,
                                       unsigned char* smem) {
  const int b = blockIdx.y;
  const int B = gridDim.y;
  const int row0 = blockIdx.x * rows;
  const int rows_here = min(rows, o.n - row0);
  const int W = o.W;
  const Layout l = layout(rows, W, window_rows(o.resident, o.T), kEncode,
                          kLearn);
  uint32_t* w_s = reinterpret_cast<uint32_t*>(smem);
  uint32_t* l_s = reinterpret_cast<uint32_t*>(smem + l.lfsr);
  uint32_t* win_s = reinterpret_cast<uint32_t*>(smem + l.win);
  int32_t* v_s = reinterpret_cast<int32_t*>(smem + l.v);
  int32_t* c_s = reinterpret_cast<int32_t*>(smem + l.count);
  int32_t* teach_s = reinterpret_cast<int32_t*>(smem + l.teach);
  uint8_t* in_s = smem + l.in;

  // Stage the tile's weight rows (and LFSR lanes) and sample 0's inputs.
  const size_t nrn0 = static_cast<size_t>(b) * o.n + row0;
  const size_t word0 = nrn0 * W;
  const int words = rows_here * W;
  for (int i = threadIdx.x; i < words; i += kThreads) {
    w_s[i] = o.weights[word0 + i];
    if (kLearn) l_s[i] = o.lfsr[word0 + i];
  }
  if (kEncode)
    for (int j = threadIdx.x + o.n_in; j < 32 * W; j += kThreads) in_s[j] = 0;
  stage_sample<kEncode>(o, 0, b, row0, rows_here, teach_s, in_s,
                        threadIdx.x, kThreads);
  const uint32_t ltp_prob = kLearn ? static_cast<uint32_t>(o.ltp_prob[b]) : 0;
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Resident windows: the rows run on warps [0, row_warps); the others
  // draw sample i + 1's window into the second buffer while the rows run
  // sample i.  Sample 0's window is drawn by every thread first.
  const int row_warps = min(rows, kWarps - kDrawWarps);
  const size_t window_words = static_cast<size_t>(o.T) * W;
  if (o.resident) {
    fill_rows<kEncode>(o, 0, b, win_s, in_s, 0, o.T, threadIdx.x, kThreads);
    __syncthreads();
  }
  for (int i = 0; i < o.N; ++i) {
    const int32_t* teach_i = teach_s + (i & 1) * rows;
    int32_t* teach_next = teach_s + ((i + 1) & 1) * rows;
    const size_t sample_nrn = (static_cast<size_t>(i) * B + b) * o.n + row0;
    uint8_t* fired_i =
        o.fired ? o.fired + (static_cast<size_t>(i) * B + b) * o.T * o.n + row0
                : nullptr;
    if (o.resident) {
      const uint32_t* win = win_s + (i & 1) * window_words;
      if (warp >= row_warps && i + 1 < o.N) {
        const int tid = threadIdx.x - 32 * row_warps;
        const int nthreads = kThreads - 32 * row_warps;
        stage_sample<kEncode>(o, i + 1, b, row0, rows_here, teach_next, in_s,
                              tid, nthreads);
        asm volatile("bar.sync 1, %0;\n" ::"r"(nthreads) : "memory");
        fill_rows<kEncode>(o, i + 1, b, win_s + ((i + 1) & 1) * window_words,
                           in_s, 0, o.T, tid, nthreads);
      }
      for (int r = warp; r < rows_here && warp < row_warps; r += row_warps) {
        uint32_t* row = w_s + static_cast<size_t>(r) * W;
        uint32_t* st = l_s + static_cast<size_t>(r) * W;
        const int32_t v0 = o.v ? o.v[nrn0 + r] : 0;
        uint8_t* fired_r = fired_i ? fired_i + r : nullptr;
        int count;
        const int32_t v =
            W <= 32 ? row_in_registers<kLearn>(o, row, st, win, lane, v0,
                                               teach_i[r], ltp_prob, fired_r,
                                               &count)
                    : row_in_shared<kLearn>(o, row, st, win, lane, v0,
                                            teach_i[r], ltp_prob, fired_r,
                                            &count);
        if (lane == 0) {
          v_s[r] = v;
          if (o.counts) o.counts[sample_nrn + r] = count;
        }
      }
      __syncthreads();              // the sample is done; staging visible
      continue;
    }
    // Per-cycle rows, double-buffered: one barrier per cycle.
    for (int r = threadIdx.x; r < rows_here; r += kThreads) {
      v_s[r] = o.v ? o.v[nrn0 + r] : 0;
      c_s[r] = 0;
    }
    for (int t = 0; t < o.T; ++t) {
      uint32_t* pre = win_s + (t & 1) * W;
      fill_rows<kEncode>(o, i, b, pre, in_s, t, 1, threadIdx.x, kThreads);
      __syncthreads();
      for (int r = warp; r < rows_here; r += kWarps) {
        uint32_t* row = w_s + static_cast<size_t>(r) * W;
        uint32_t* st = l_s + static_cast<size_t>(r) * W;
        const int32_t v = v_s[r];   // every lane reads before lane 0 writes
        bool fired;
        const int32_t v_next = cycle<kLearn>(o, row, st, pre, lane, v,
                                             teach_i[r], ltp_prob, &fired);
        if (lane == 0) {
          v_s[r] = v_next;
          c_s[r] += fired;
          if (fired_i) fired_i[static_cast<size_t>(t) * o.n + r] = fired;
        }
      }
    }
    __syncthreads();                // every row is through the sample
    if (o.counts)
      for (int r = threadIdx.x; r < rows_here; r += kThreads)
        o.counts[sample_nrn + r] = c_s[r];
    if (i + 1 < o.N)
      stage_sample<kEncode>(o, i + 1, b, row0, rows_here, teach_next, in_s,
                            threadIdx.x, kThreads);
    __syncthreads();
  }

  for (int r = threadIdx.x; r < rows_here; r += kThreads)
    o.v_out[nrn0 + r] = v_s[r];
  if (kLearn) {
    for (int i = threadIdx.x; i < words; i += kThreads) {
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

// Neurons per block for an n-neuron, W-word bank whose layout with a
// `win_rows`-row spike window fits `limit` bytes; 0 if not even one row
// fits.
int fit_rows(int n, int W, int win_rows, bool encode, bool learn,
             size_t limit) {
  int rows = std::min(n, kMaxTileRows);
  rows = std::min(rows, std::max(1, kTileWords / std::max(W, 1)));
  while (rows > 0 && layout(rows, W, win_rows, encode, learn).total > limit)
    --rows;
  return rows;
}

struct Tile {
  int rows;
  bool resident;
};

// The tile: two whole windows stay resident when that costs no rows;
// otherwise the two-row, per-cycle window.
Tile tile(int n, int W, int T, bool encode, bool learn, size_t limit) {
  const int rows = fit_rows(n, W, 2, encode, learn, limit);
  return {rows,
          rows > 0 && fit_rows(n, W, 2 * T, encode, learn, limit) == rows};
}

// The device's opt-in shared memory, queried and granted to the kernel
// once per process and device.
struct Prepared {
  std::once_flag once;
  cudaError_t err = cudaSuccess;
  size_t limit = 0;
};

template <auto kKernel>
cudaError_t prepare(size_t* limit) {
  static Prepared done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Prepared& p = done[dev];
  std::call_once(p.once, [&p] {
    p.err = snn::block_smem_limit(&p.limit);
    if (p.err == cudaSuccess) p.err = snn::allow_smem(kKernel, p.limit);
  });
  *limit = p.limit;
  return p.err;
}

// Picks the tile and launches.
template <auto kKernel>
int launch(Operands o, int B, bool encode, bool learn, void* stream) {
  size_t limit = 0;
  cudaError_t err = prepare<kKernel>(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Tile tl = tile(o.n, o.W, o.T, encode, learn, limit);
  if (tl.rows == 0) return snn::kRowTooWide;
  o.resident = tl.resident;
  const size_t smem =
      layout(tl.rows, o.W, window_rows(tl.resident, o.T), encode, learn).total;
  const dim3 grid((o.n + tl.rows - 1) / tl.rows, B);
  kKernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, tl.rows);
  return static_cast<int>(cudaGetLastError());
}

// One window (N = 1) of B streams, per-stream operands packed.
Operands operands(const void* weights, const void* v, const void* teach,
                  void* v_out, void* fired, int n, int W, int T,
                  int threshold, int leak) {
  Operands o = {};
  o.weights = static_cast<const uint32_t*>(weights);
  o.v = static_cast<const int32_t*>(v);
  o.teach = static_cast<const int32_t*>(teach);
  o.v_out = static_cast<int32_t*>(v_out);
  o.fired = static_cast<uint8_t*>(fired);
  o.teach_stream = n;
  o.N = 1;
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
  o->in_stream = n_in;
  o->seed_stream = 1;
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
  return launch<train_window_kernel>(o, B, false, true, stream);
}

// B training streams with spikes drawn in-kernel from intensities
// [B, n_in] (u8) and seeds [B] (int32) over n_steps cycles: the N = 1
// case of snn_train_stream_encode, with the caller's v and the raster.
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
  return launch<train_window_enc_kernel>(o, B, true, true, stream);
}

// B training streams of N samples each, in one launch: sample i of
// stream b draws its spikes from intensities (element offset
// i * in_sample + b * in_stream, n_in contiguous u8) with seed (offset
// i * seed_sample + b * seed_stream) and adds teach (offset
// i * teach_sample + b * teach_stream, n contiguous int32); v starts at
// 0 for every sample.  Reads weights, lfsr [B, n, W] and ltp_prob [B];
// writes w_out, lfsr_out, v_out [B, n] (the last sample's v') and
// counts [N, B, n] (int32).  N >= 1, n_syn >= 1.
int snn_train_stream_encode(const void* weights, const void* intensities,
                            const void* seeds, const void* lfsr,
                            const void* teach, const void* ltp_prob,
                            void* w_out, void* v_out, void* counts,
                            void* lfsr_out, long long in_sample,
                            long long in_stream, long long seed_sample,
                            long long seed_stream, long long teach_sample,
                            long long teach_stream, int N, int B, int n,
                            int W, int n_in, int n_steps, int threshold,
                            int leak, int w_exp, int gain, int n_syn,
                            void* stream) {
  Operands o = operands(weights, nullptr, teach, v_out, nullptr, n, W,
                        n_steps, threshold, leak);
  set_encode(&o, intensities, seeds, n_in);
  set_learning(&o, lfsr, ltp_prob, w_out, lfsr_out, w_exp, gain, n_syn);
  o.counts = static_cast<int32_t*>(counts);
  o.N = N;
  o.in_sample = in_sample;
  o.in_stream = in_stream;
  o.seed_sample = seed_sample;
  o.seed_stream = seed_stream;
  o.teach_sample = teach_sample;
  o.teach_stream = teach_stream;
  return launch<train_window_enc_kernel>(o, B, true, true, stream);
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
  return launch<window_infer_kernel>(o, B, false, false, stream);
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
  return launch<window_infer_enc_kernel>(o, B, true, false, stream);
}

// Neurons per block the launchers above choose on the current device
// (0: a row does not fit), and the block's shared-memory bytes with a
// two-row spike window (a resident window adds T - 2 rows of W words,
// and is chosen only where it costs no rows).
int snn_train_tile_rows(int n, int W, int encode, int learn) {
  size_t limit = 0;
  if (snn::block_smem_limit(&limit) != cudaSuccess) return 0;
  return fit_rows(n, W, 2, encode != 0, learn != 0, limit);
}

long long snn_train_smem_bytes(int rows, int W, int encode, int learn) {
  return static_cast<long long>(
      layout(rows, W, 2, encode != 0, learn != 0).total);
}

// Human-readable text of a code returned above.
const char* snn_train_error_string(int err) {
  if (err == snn::kRowTooWide)
    return "one synapse row does not fit a block's shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
