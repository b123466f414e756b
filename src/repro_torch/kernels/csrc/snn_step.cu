// Per-cycle kernels of the Wenquxing 22A SNN for Hopper (sm_90a): the
// RV-SNN V1.0 instructions, one launch per instruction and cycle.
//
// Replaces four Pallas TPU kernels of src/repro/kernels/snn_kernels.py:
//   spike_process_short_kernel, spike_process_long_kernel
//                         <- spike_process (_spike_process_kernel), SPU,
//                            snn.sp: counts[b, i] = sum_k popc(pre[b, k] &
//                            w[b, i, k]).
//   lif_kernel            <- lif_step (_lif_kernel), NU, snn.nu:
//                            v += count; fire iff v >= threshold; a fired
//                            neuron resets to 0, else v = max(v - leak, 0).
//   stdp_short_kernel,    <- stdp_update (_stdp_kernel), SU, snn.su: on
//   stdp_long_kernel,        each fired row, two LFSR steps s1, s2 per
//   stdp_wide_kernel         word; LTP w |= pre when (s1 & 0x3FF) <=
//                            ltp_prob (u32 compare); with pc the popcount
//                            of the LTP'd row, LTD w &= pre when
//                            (s2 & 0x3FF) <= clip((pc - w_exp) * gain *
//                            1024 / n_syn, 0, 1023); the lane keeps s2.
//                            Unfired rows pass through unchanged.
//   fused_step_kernel     <- fused_snn_step (_fused_kernel), the SNNU,
//                            snn.step: SPU + teach -> NU -> SU (train) in
//                            one pass.
// Every kernel takes an optional leading stream axis B on grid y (the
// port's form of the JAX step path's vmap).  The weight bank (and LFSR)
// may be one per stream or one shared by every stream (`shared`: stream
// stride 0), so B samples run against one bank without B copies of it.
//
// What bounds them on this card: launch latency.  At the paper's width
// (n = 10-40 rows of W = 25 words, B = 1-32 streams) one instruction is a
// few thousand words of work, a few nanoseconds of the card's bandwidth
// or integer rate, so each launch costs what a launch costs.  At large
// widths (65,536 inputs, 1,000 rows) they are bandwidth-bound: the fused
// training step reads the bank and its LFSR lanes and writes both anew,
// 16 bytes per word; the SPU alone reads the bank once, 4 bytes a word.
//
// What the design does about it: one pass, and launches that overlap.
// Every kernel here may launch as a programmatic dependent
// (griddepcontrol) of the stream's previous kernel: its blocks start
// while that one ends, load what no earlier kernel of the chain wrote,
// then wait for the previous grid to finish before they read anything
// else or write at all.  Every thread of every block waits before it
// exits, a thread with no row too, so a grid completes only after the
// grid it depends on: the unfused chain (snn.sp -> snn.nu -> snn.su, one
// launch each, recorded as one CUDA graph) relies on that, as snn.nu
// reads the v written three launches back and snn.sp the bank the last
// snn.su wrote.
//
// The SPU alone (spike_process) holds rows of up to 128 words (the
// paper's 25) in registers, one warp a row, the spikes loaded before the
// wait and the row after it (spike_process_short_kernel).  Longer rows
// (65,536 inputs: 2,048 words) take kSpuRowWarps warps each, two rows a
// block, so 1,000 rows are 500 blocks, all resident at once; each lane
// keeps kSpuVecs 16-byte loads of the row and as many of the spikes in
// flight (4-byte loads where W % 4 != 0 or a base is not 16-byte
// aligned), and the warps' partial counts meet in shared memory
// (spike_process_long_kernel).  The NU alone (lif_step) is one thread a
// neuron and has nothing to load before its wait (v and count are both
// written inside the chain): its time is a launch's (lif_kernel).
//
// The fused step: one warp owns a row (lanes stride its words,
// coalesced): the SPU popcount reduces to every lane, so each lane runs
// the LIF update itself and `fired` is uniform across the warp with no
// broadcast; lane 0 writes v' and the fired byte.  A fired row then runs
// the STDP pass (snn::stdp_row, the window kernels' pass, shared through
// snn_common.cuh), reading the input row and writing the output row; an
// unfired row is copied through.  `train = false` compiles the SU out
// and writes only v' and the raster, so the bank and LFSR are returned
// as they came.  No kernel writes an input.
//
// The SU alone (stdp_update) reads each word of a row's weights and LFSR
// lanes once and writes it once, where snn::stdp_row (which the fused
// step's long rows and the window kernels share) reads a fired row a
// second time for the LTD after the row popcount: 36 bytes a word where
// 16 suffice, the second pass waiting on the first pass's stores.  Rows
// of up to 128 words (the paper's 25) take a warp each and sit in
// registers, every load issued before the work that depends on it
// (stdp_short_kernel).  Longer rows (65,536 inputs: 2,048 words) take a
// block of 256 threads each, 16-byte loads and stores where the row
// allows them: pass 1 reads each word once, applies the LTP, steps its
// LFSR lane (written out at once: s2 is final) and stashes the LTP'd word
// and s2 in shared memory; the row popcount is a block sum; pass 2 applies
// the LTD from the stash and writes the weights (stdp_long_kernel).  An
// unfired row is copied through in pass 1.  Rows wider than a block's
// shared memory holds (8 bytes a word) keep the two-pass form, one warp a
// row (stdp_wide_kernel).  As a dependent it waits before its first load.
//
// The fused step is the step path's one launch per cycle, 72 a window,
// so its launch latency is the cost.  The engine records a window's
// launches as one CUDA graph and launches each step after the first as a
// dependent of the step before: the next step loads this cycle's spikes,
// teacher current and ltp_prob (and with the SU idle the shared bank)
// before its wait, v, the weights and the LFSR after it.  Rows of up to
// 128 words (the paper's 25) hold their words in registers: every load
// of the row issues before the dependent chain, and the STDP pass runs
// on registers.  The window kernels of snn_train.cu are the fused form
// of the same T cycles.
//
// Plain C interface (bound with ctypes): each launcher launches on the
// given stream, does not synchronize, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "snn_common.cuh"

namespace {

using snn::kThreads;
using snn::kWarps;

// Everything a step launch reads and writes; pointers the kernel does
// not use are null.  Banks are [B, n, W] words ([n, W] when shared),
// spikes [B, W], neurons [B, n], the raster [B, n] bytes.
struct Step {
  const uint32_t* weights;
  const uint32_t* pre;
  const uint32_t* lfsr;         // SU
  const int32_t* v;             // NU
  const int32_t* count;         // lif_kernel: the SPU's counts
  const int32_t* teach;         // fused: null means no teacher current
  const int32_t* ltp_prob;      // SU: [B]
  const uint8_t* fired_in;      // SU kernels: the NU's fired mask
  uint32_t* w_out;              // SU
  uint32_t* lfsr_out;           // SU
  int32_t* v_out;               // NU
  uint8_t* fired;               // NU
  int32_t* counts;              // SPU
  int n, W, shared, threshold, leak, w_exp, gain, n_syn;
};

// This warp's row: its neuron index in [B, n] and its bank row's offset.
struct Row {
  size_t nrn, bank;
};

__device__ __forceinline__ bool warp_row(const Step& o, Row* row) {
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= o.n) return false;
  const size_t b = blockIdx.y;
  row->nrn = b * o.n + r;
  row->bank = (o.shared ? 0 : b * o.n) + r;
  return true;
}

// STDP of one row by its warp: stdp_row on a fired row, else a copy.
__device__ __forceinline__ void su_row(const Step& o, const Row& row,
                                       bool fired, int lane) {
  const size_t W = o.W;
  const uint32_t* w = o.weights + row.bank * W;
  const uint32_t* st = o.lfsr + row.bank * W;
  uint32_t* w_out = o.w_out + row.nrn * W;
  uint32_t* st_out = o.lfsr_out + row.nrn * W;
  if (fired) {
    snn::stdp_row(w, st, w_out, st_out, o.pre + blockIdx.y * W, o.W, lane,
                  static_cast<uint32_t>(o.ltp_prob[blockIdx.y]), o.w_exp,
                  o.gain, o.n_syn);
  } else {
    for (int k = lane; k < o.W; k += 32) {
      w_out[k] = w[k];
      st_out[k] = st[k];
    }
  }
}

// Programmatic dependent launch (sm_90): wait until the grid this one
// depends on has finished and its writes are visible (a no-op when the
// launch has no such dependency), and let the next grid start early.
__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Words of a row each lane holds in registers on the short-row paths
// (the fused step, the SPU and the SU): rows of up to 32 * kHeld words.
constexpr int kHeld = 4;

// SPU on rows of W <= 32 * kHeld words: one warp a row, in registers.
__global__ void __launch_bounds__(kThreads) spike_process_short_kernel(Step o) {
  Row row;
  const bool live = warp_row(o, &row);
  const int lane = threadIdx.x % 32;
  const int W = o.W;
  const uint32_t* pre = o.pre + static_cast<size_t>(blockIdx.y) * W;
  uint32_t pre_r[kHeld], w_r[kHeld];
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {   // this cycle's spikes: no kernel
    const int k = lane + 32 * j;      // of the chain writes them
    pre_r[j] = live && k < W ? pre[k] : 0;
  }
  wait_for_previous_grid();           // the bank the last snn.su wrote
  const uint32_t* w = o.weights + (live ? row.bank : 0) * W;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int k = lane + 32 * j;
    w_r[j] = live && k < W ? w[k] : 0;
  }
  allow_next_grid();                  // its own wait keeps it off counts
  if (!live) return;                  // whole warps leave together
  int acc = 0;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) acc += __popc(pre_r[j] & w_r[j]);
  acc = snn::warp_add(acc);
  if (lane == 0) o.counts[row.nrn] = acc;
}

// SPU on longer rows: kSpuRowWarps warps a row, kWarps / kSpuRowWarps
// rows a block; in a round each lane keeps kSpuVecs 16-byte loads of the
// row (or 4 * kSpuVecs 4-byte ones) and as many of the spikes in flight.
constexpr int kSpuRowWarps = 4;
constexpr int kSpuRowThreads = 32 * kSpuRowWarps;
constexpr int kSpuRows = kWarps / kSpuRowWarps;
constexpr int kSpuVecs = 4;
constexpr int kSpuSpan = 4 * kSpuRowThreads * kSpuVecs;   // words a round

// This lane's share of words base .. base + kSpuSpan - 1 of a row of W
// words (0 past its end): with kVec, vectors base / 4 + t + j *
// kSpuRowThreads (W % 4 == 0, 16-byte aligned row); else words base + t
// + m * kSpuRowThreads, four to a slot.  Every load is coalesced and all
// are issued before the first is used.
template <bool kVec>
__device__ __forceinline__ void spu_round(const uint32_t* row, int base,
                                          int t, int W,
                                          uint4 (&x)[kSpuVecs]) {
  constexpr int s = kSpuRowThreads;
#pragma unroll
  for (int j = 0; j < kSpuVecs; ++j) {
    if (kVec) {
      const int q = base / 4 + t + j * s;
      x[j] = q < W / 4 ? reinterpret_cast<const uint4*>(row)[q]
                       : make_uint4(0u, 0u, 0u, 0u);
    } else {
      const int k = base + t + 4 * j * s;
      x[j] = make_uint4(k < W ? row[k] : 0u, k + s < W ? row[k + s] : 0u,
                        k + 2 * s < W ? row[k + 2 * s] : 0u,
                        k + 3 * s < W ? row[k + 3 * s] : 0u);
    }
  }
}

__device__ __forceinline__ int popc_and(const uint4 (&p)[kSpuVecs],
                                        const uint4 (&w)[kSpuVecs]) {
  int acc = 0;
#pragma unroll
  for (int j = 0; j < kSpuVecs; ++j)
    acc += __popc(p[j].x & w[j].x) + __popc(p[j].y & w[j].y) +
           __popc(p[j].z & w[j].z) + __popc(p[j].w & w[j].w);
  return acc;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) spike_process_long_kernel(Step o) {
  __shared__ int part[kWarps];
  const int t = threadIdx.x % kSpuRowThreads;
  const int r = blockIdx.x * kSpuRows + threadIdx.x / kSpuRowThreads;
  const bool live = r < o.n;
  const int W = o.W;
  const size_t b = blockIdx.y;
  const uint32_t* pre = o.pre + b * W;
  const uint32_t* w =
      o.weights + ((o.shared ? 0 : b * o.n) + (live ? r : 0)) * W;
  uint4 p[kSpuVecs], x[kSpuVecs];
  if (live) spu_round<kVec>(pre, 0, t, W, p);   // this cycle's spikes
  wait_for_previous_grid();                     // the bank
  int acc = 0;
  if (live) spu_round<kVec>(w, 0, t, W, x);
  allow_next_grid();
  if (live) {
    acc = popc_and(p, x);
    for (int base = kSpuSpan; base < W; base += kSpuSpan) {
      spu_round<kVec>(pre, base, t, W, p);
      spu_round<kVec>(w, base, t, W, x);
      acc += popc_and(p, x);
    }
  }
  acc = snn::warp_add(acc);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = acc;
  __syncthreads();
  if (!live || t != 0) return;
  const int first = threadIdx.x / 32;           // the row's first warp
  int total = 0;
#pragma unroll
  for (int i = 0; i < kSpuRowWarps; ++i) total += part[first + i];
  o.counts[b * o.n + r] = total;
}

// NU: one thread a neuron, kThreads a block.  (Four neurons a thread
// through 16-byte loads, 4,096 a block, measured slower at every size.)
__global__ void __launch_bounds__(kThreads) lif_kernel(Step o, int total) {
  allow_next_grid();        // nothing to load early: the chain writes
  wait_for_previous_grid(); // both count and v
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  bool fired;
  o.v_out[i] = snn::lif_update(o.v[i], o.count[i], o.threshold, o.leak,
                               &fired);
  o.fired[i] = fired;
}

// snn::stdp_row on the row's words held in registers, kHeld a lane
// (word lane + 32 j in slot j; words past the row are 0 and add nothing
// to the row popcount), by the warp that owns the fired row.
__device__ __forceinline__ void stdp_held(uint32_t (&w_r)[kHeld],
                                          uint32_t (&st_r)[kHeld],
                                          const uint32_t (&pre_r)[kHeld],
                                          uint32_t ltp_prob, const Step& o) {
  int pc = 0;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    if (((st_r[j] >> 1) & 0x3FFu) <= ltp_prob) w_r[j] |= pre_r[j];
    st_r[j] = snn::lfsr_step2(st_r[j]);
    pc += __popc(w_r[j]);
  }
  const int32_t excess = snn::ltd_excess(snn::warp_add(pc), o.w_exp, o.gain);
#pragma unroll
  for (int j = 0; j < kHeld; ++j)
    if (snn::ltd_hit(st_r[j] & 0x3FFu, excess, o.n_syn)) w_r[j] &= pre_r[j];
}

// SU on rows of W <= 32 * kHeld words: one warp a row, in registers.
__global__ void __launch_bounds__(kThreads) stdp_short_kernel(Step o) {
  wait_for_previous_grid();         // the fired mask, the bank and LFSR
  allow_next_grid();
  Row row;
  if (!warp_row(o, &row)) return;   // whole warps leave together
  const int lane = threadIdx.x % 32;
  const int W = o.W;
  const uint32_t* w = o.weights + row.bank * W;
  const uint32_t* st = o.lfsr + row.bank * W;
  const uint32_t* pre = o.pre + static_cast<size_t>(blockIdx.y) * W;
  uint32_t w_r[kHeld], st_r[kHeld], pre_r[kHeld];
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int k = lane + 32 * j;
    w_r[j] = k < W ? w[k] : 0;
    st_r[j] = k < W ? st[k] : 0;
    pre_r[j] = k < W ? pre[k] : 0;
  }
  const bool fired = o.fired_in[row.nrn] != 0;   // the same on every lane
  const uint32_t ltp_prob = static_cast<uint32_t>(o.ltp_prob[blockIdx.y]);
  if (fired) stdp_held(w_r, st_r, pre_r, ltp_prob, o);
  uint32_t* w_out = o.w_out + row.nrn * W;
  uint32_t* st_out = o.lfsr_out + row.nrn * W;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int k = lane + 32 * j;
    if (k < W) {
      w_out[k] = w_r[j];
      st_out[k] = st_r[j];
    }
  }
}

constexpr int kLongThreads = 256;

// Words 4q .. 4q + 3 of a row of W words (0 past its end): one 16-byte
// access where `vec` (W % 4 == 0, 16-byte aligned row), else four.
__device__ __forceinline__ uint4 load4(const uint32_t* row, int q, int W,
                                       bool vec) {
  if (vec) return reinterpret_cast<const uint4*>(row)[q];
  const int k = 4 * q;
  return make_uint4(k < W ? row[k] : 0u, k + 1 < W ? row[k + 1] : 0u,
                    k + 2 < W ? row[k + 2] : 0u, k + 3 < W ? row[k + 3] : 0u);
}

__device__ __forceinline__ void store4(uint32_t* row, int q, uint4 x, int W,
                                       bool vec) {
  if (vec) {
    reinterpret_cast<uint4*>(row)[q] = x;
    return;
  }
  const int k = 4 * q;
  if (k < W) row[k] = x.x;
  if (k + 1 < W) row[k + 1] = x.y;
  if (k + 2 < W) row[k + 2] = x.z;
  if (k + 3 < W) row[k + 3] = x.w;
}

__device__ __forceinline__ uint32_t ltp(uint32_t w, uint32_t s, uint32_t p,
                                        uint32_t ltp_prob) {
  return ((s >> 1) & 0x3FFu) <= ltp_prob ? w | p : w;
}

__device__ __forceinline__ uint32_t ltd(uint32_t w, uint32_t s2, uint32_t p,
                                        uint32_t prob) {
  return (s2 & 0x3FFu) <= prob ? w & p : w;
}

// SU on long rows: one block of kLongThreads a row, grid (n, B).  The
// dynamic shared memory holds the row's stash: (W + 3) / 4 vectors of
// LTP'd words, then as many of LFSR lanes s2.
__global__ void __launch_bounds__(kLongThreads)
stdp_long_kernel(Step o, int vec) {
  extern __shared__ __align__(16) uint4 stash[];
  __shared__ int part[kLongThreads / 32];
  wait_for_previous_grid();
  allow_next_grid();
  const int W = o.W;
  const int nvec = (W + 3) / 4;
  const size_t b = blockIdx.y;
  const size_t nrn = b * o.n + blockIdx.x;
  const size_t bank = (o.shared ? 0 : b * o.n) + blockIdx.x;
  const uint32_t* w = o.weights + bank * W;
  const uint32_t* st = o.lfsr + bank * W;
  const uint32_t* pre = o.pre + b * W;
  uint32_t* w_out = o.w_out + nrn * W;
  uint32_t* st_out = o.lfsr_out + nrn * W;
  const bool fired = o.fired_in[nrn] != 0;       // the same for the block
  const uint32_t ltp_prob = static_cast<uint32_t>(o.ltp_prob[b]);
  int pc = 0;
  for (int q = threadIdx.x; q < nvec; q += kLongThreads) {
    uint4 wv = load4(w, q, W, vec);
    uint4 sv = load4(st, q, W, vec);
    const uint4 pv = load4(pre, q, W, vec);
    if (fired) {
      wv = make_uint4(ltp(wv.x, sv.x, pv.x, ltp_prob),
                      ltp(wv.y, sv.y, pv.y, ltp_prob),
                      ltp(wv.z, sv.z, pv.z, ltp_prob),
                      ltp(wv.w, sv.w, pv.w, ltp_prob));
      sv = make_uint4(snn::lfsr_step2(sv.x), snn::lfsr_step2(sv.y),
                      snn::lfsr_step2(sv.z), snn::lfsr_step2(sv.w));
      pc += __popc(wv.x) + __popc(wv.y) + __popc(wv.z) + __popc(wv.w);
      stash[q] = wv;
      stash[nvec + q] = sv;
    } else {
      store4(w_out, q, wv, W, vec);
    }
    store4(st_out, q, sv, W, vec);
  }
  if (!fired) return;
  pc = snn::warp_add(pc);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = pc;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int i = 0; i < kLongThreads / 32; ++i) total += part[i];
  const uint32_t prob =
      snn::ltd_prob(snn::ltd_excess(total, o.w_exp, o.gain), o.n_syn);
  for (int q = threadIdx.x; q < nvec; q += kLongThreads) {
    const uint4 wv = stash[q];    // this thread's own words: no barrier
    const uint4 sv = stash[nvec + q];
    const uint4 pv = load4(pre, q, W, vec);
    store4(w_out, q,
           make_uint4(ltd(wv.x, sv.x, pv.x, prob), ltd(wv.y, sv.y, pv.y, prob),
                      ltd(wv.z, sv.z, pv.z, prob), ltd(wv.w, sv.w, pv.w, prob)),
           W, vec);
  }
}

// SU on rows too wide for stdp_long_kernel's stash: one warp a row, the
// two-pass snn::stdp_row.
__global__ void __launch_bounds__(kThreads) stdp_wide_kernel(Step o) {
  wait_for_previous_grid();
  allow_next_grid();
  Row row;
  if (!warp_row(o, &row)) return;
  su_row(o, row, o.fired_in[row.nrn] != 0, threadIdx.x % 32);
}

// kShort: the row's words are held in registers (W <= 32 * kHeld).
template <bool kLearn, bool kShort>
__global__ void __launch_bounds__(kThreads) fused_step_kernel(Step o) {
  Row row;
  const bool live = warp_row(o, &row);
  const int lane = threadIdx.x % 32;
  const int W = o.W;
  const uint32_t* pre = o.pre + static_cast<size_t>(blockIdx.y) * W;
  const uint32_t* w = o.weights + (live ? row.bank : 0) * W;
  // What no earlier cycle wrote: this cycle's spikes, teacher current
  // and ltp_prob and, with the SU idle, the read-only bank.
  uint32_t pre_r[kHeld], w_r[kHeld], st_r[kHeld];
  int32_t teach = 0;
  uint32_t ltp_prob = 0;
  if (live) {
    if (kShort) {
#pragma unroll
      for (int j = 0; j < kHeld; ++j) {
        const int k = lane + 32 * j;
        pre_r[j] = k < W ? pre[k] : 0;
        if (!kLearn) w_r[j] = k < W ? w[k] : 0;
      }
    }
    if (o.teach) teach = o.teach[row.nrn];
    if (kLearn) ltp_prob = static_cast<uint32_t>(o.ltp_prob[blockIdx.y]);
  }
  wait_for_previous_grid();         // the previous step's v, bank, LFSR
  allow_next_grid();                // its own wait keeps it off our outputs
  if (!live) return;                // whole warps leave together
  const int32_t v = o.v[row.nrn];
  int acc = 0;
  if (kShort) {
    const uint32_t* st = kLearn ? o.lfsr + row.bank * W : nullptr;
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      const int k = lane + 32 * j;
      if (kLearn) {
        w_r[j] = k < W ? w[k] : 0;
        st_r[j] = k < W ? st[k] : 0;
      }
      acc += __popc(pre_r[j] & w_r[j]);
    }
  } else {
    for (int k = lane; k < W; k += 32) acc += __popc(pre[k] & w[k]);
  }
  bool fired;                       // the same on every lane of the warp
  const int32_t v_next = snn::lif_update(
      v, snn::add32(snn::warp_add(acc), teach), o.threshold, o.leak, &fired);
  if (lane == 0) {
    o.v_out[row.nrn] = v_next;
    o.fired[row.nrn] = fired;
  }
  if (!kLearn) return;
  if (!kShort) {
    su_row(o, row, fired, lane);
    return;
  }
  // snn::stdp_row on the held words; padding words (k >= W) are 0 and
  // add nothing to the row popcount.
  if (fired) {
    int pc = 0;
#pragma unroll
    for (int j = 0; j < kHeld; ++j) {
      if (((st_r[j] >> 1) & 0x3FFu) <= ltp_prob) w_r[j] |= pre_r[j];
      st_r[j] = snn::lfsr_step2(st_r[j]);
      pc += __popc(w_r[j]);
    }
    const int32_t excess = snn::ltd_excess(snn::warp_add(pc), o.w_exp,
                                           o.gain);
#pragma unroll
    for (int j = 0; j < kHeld; ++j)
      if (snn::ltd_hit(st_r[j] & 0x3FFu, excess, o.n_syn))
        w_r[j] &= pre_r[j];
  }
  uint32_t* w_out = o.w_out + row.nrn * W;
  uint32_t* st_out = o.lfsr_out + row.nrn * W;
#pragma unroll
  for (int j = 0; j < kHeld; ++j) {
    const int k = lane + 32 * j;
    if (k < W) {
      w_out[k] = w_r[j];
      st_out[k] = st_r[j];
    }
  }
}

// Launches `kernel` on `stream` with `threads` a block and `smem` bytes
// of dynamic shared memory, as a programmatic dependent of the stream's
// previous kernel when `dependent` is set.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
           bool dependent, void* stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One warp per row: grid (row groups, streams).
template <typename Kernel>
int launch_rows(Kernel kernel, const Step& o, int B, bool dependent,
                void* stream) {
  const dim3 grid((o.n + kWarps - 1) / kWarps, B);
  return launch(kernel, grid, kThreads, 0, dependent, stream, o);
}

// The fused step, one warp per row.
template <bool kLearn>
int launch_step(const Step& o, int B, bool dependent, void* stream) {
  return o.W <= 32 * kHeld
             ? launch_rows(fused_step_kernel<kLearn, true>, o, B, dependent,
                           stream)
             : launch_rows(fused_step_kernel<kLearn, false>, o, B, dependent,
                           stream);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

Step bank(const void* weights, const void* pre, int n, int W, int shared) {
  Step o = {};
  o.weights = static_cast<const uint32_t*>(weights);
  o.pre = static_cast<const uint32_t*>(pre);
  o.n = n;
  o.W = W;
  o.shared = shared;
  return o;
}

void set_su(Step* o, const void* lfsr, const void* ltp_prob, void* w_out,
            void* lfsr_out, int w_exp, int gain, int n_syn) {
  o->lfsr = static_cast<const uint32_t*>(lfsr);
  o->ltp_prob = static_cast<const int32_t*>(ltp_prob);
  o->w_out = static_cast<uint32_t*>(w_out);
  o->lfsr_out = static_cast<uint32_t*>(lfsr_out);
  o->w_exp = w_exp;
  o->gain = gain;
  o->n_syn = n_syn;
}

}  // namespace

extern "C" {

// snn.sp: reads spikes [B, W] and weights [B, n, W] ([n, W] if shared)
// (u32); writes counts [B, n] (int32).
int snn_spike_process(const void* spikes, const void* weights, void* counts,
                      int B, int n, int W, int shared, int dependent,
                      void* stream) {
  Step o = bank(weights, spikes, n, W, shared);
  o.counts = static_cast<int32_t*>(counts);
  const bool dep = dependent != 0;
  if (W <= 32 * kHeld)
    return launch_rows(spike_process_short_kernel, o, B, dep, stream);
  const dim3 grid((n + kSpuRows - 1) / kSpuRows, B);
  return W % 4 == 0 && aligned(weights, 16) && aligned(spikes, 16)
             ? launch(spike_process_long_kernel<true>, grid, kThreads, 0, dep,
                      stream, o)
             : launch(spike_process_long_kernel<false>, grid, kThreads, 0,
                      dep, stream, o);
}

// snn.nu over `total` neurons: reads v and count (int32); writes v_out
// (int32) and fired (bytes).
int snn_lif_step(const void* v, const void* count, void* v_out, void* fired,
                 int total, int threshold, int leak, int dependent,
                 void* stream) {
  Step o = {};
  o.v = static_cast<const int32_t*>(v);
  o.count = static_cast<const int32_t*>(count);
  o.v_out = static_cast<int32_t*>(v_out);
  o.fired = static_cast<uint8_t*>(fired);
  o.threshold = threshold;
  o.leak = leak;
  const dim3 grid(total / kThreads + (total % kThreads != 0));
  return launch(lif_kernel, grid, kThreads, 0, dependent != 0, stream, o,
                total);
}

// snn.su: reads weights and lfsr [B, n, W] ([n, W] if shared) (u32), pre
// [B, W] (u32), fired [B, n] (bytes) and ltp_prob [B] (int32); writes
// w_out and lfsr_out [B, n, W].  n_syn >= 1.
int snn_stdp_update(const void* weights, const void* pre, const void* fired,
                    const void* lfsr, const void* ltp_prob, void* w_out,
                    void* lfsr_out, int B, int n, int W, int shared,
                    int w_exp, int gain, int n_syn, int dependent,
                    void* stream) {
  Step o = bank(weights, pre, n, W, shared);
  o.fired_in = static_cast<const uint8_t*>(fired);
  set_su(&o, lfsr, ltp_prob, w_out, lfsr_out, w_exp, gain, n_syn);
  const bool dep = dependent != 0;
  if (W <= 32 * kHeld)
    return launch_rows(stdp_short_kernel, o, B, dep, stream);
  size_t limit = 0;
  cudaError_t err = snn::block_smem_limit(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t stash = static_cast<size_t>((W + 3) / 4) * 32;
  if (stash + 1024 > limit)
    return launch_rows(stdp_wide_kernel, o, B, dep, stream);
  err = snn::allow_smem(stdp_long_kernel, stash);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = W % 4 == 0 && aligned(weights, 16) && aligned(lfsr, 16) &&
                  aligned(pre, 16) && aligned(w_out, 16) &&
                  aligned(lfsr_out, 16);
  return launch(stdp_long_kernel, dim3(n, B), kLongThreads, stash, dep,
                stream, o, vec);
}

// snn.step: reads weights (and, if train, lfsr) [B, n, W] ([n, W] if
// shared), pre [B, W], v and teach (null: none) [B, n] and, if train,
// ltp_prob [B]; writes v_out [B, n], fired [B, n] and, if train, w_out
// and lfsr_out [B, n, W].  n_syn >= 1.  `dependent`: launch as a
// programmatic dependent of the stream's previous kernel, which must be
// the step that wrote v (and the bank and LFSR), and must not have
// written pre, teach, ltp_prob or a shared bank.
int snn_fused_step(const void* weights, const void* pre, const void* v,
                   const void* lfsr, const void* teach, const void* ltp_prob,
                   void* w_out, void* v_out, void* fired, void* lfsr_out,
                   int B, int n, int W, int shared, int threshold, int leak,
                   int w_exp, int gain, int n_syn, int train, int dependent,
                   void* stream) {
  Step o = bank(weights, pre, n, W, shared);
  o.v = static_cast<const int32_t*>(v);
  o.teach = static_cast<const int32_t*>(teach);
  o.v_out = static_cast<int32_t*>(v_out);
  o.fired = static_cast<uint8_t*>(fired);
  o.threshold = threshold;
  o.leak = leak;
  if (!train) return launch_step<false>(o, B, dependent != 0, stream);
  set_su(&o, lfsr, ltp_prob, w_out, lfsr_out, w_exp, gain, n_syn);
  return launch_step<true>(o, B, dependent != 0, stream);
}

// Human-readable text of a code returned above.
const char* snn_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
