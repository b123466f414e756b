// Device code shared by the SNN kernels (snn_infer.cu, snn_train.cu,
// snn_step.cu): the counter-hash spike draw, the streamlined LIF update,
// the binary stochastic STDP arithmetic and its row update, warp sums,
// and the launch helpers that fit a block's shared memory.
//
// All packed words are u32 bit patterns (the port holds them as int32
// tensors).  Integer arithmetic that the JAX package does in wrapping
// int32 is done here in uint32_t and cast back: signed overflow is
// undefined in C++.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace snn {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Error code of a bank whose synapse row does not fit one block.
constexpr int kRowTooWide = -1;

// Mirror of repro_torch.core.lfsr.counter_hash (wrapping u32).
__device__ __forceinline__ uint32_t counter_hash(uint32_t seed,
                                                 uint32_t cycle,
                                                 uint32_t idx) {
  uint32_t h = seed + cycle * 0x9E3779B9u + idx * 0x85EBCA6Bu;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// Stage one sample's intensities (n_in bytes) into in_s, zero-padded to
// 32 * W bytes: padding inputs never fire.
__device__ __forceinline__ void stage_intensities(
    uint8_t* in_s, const uint8_t* __restrict__ in_g, int n_in, int W) {
  for (int i = threadIdx.x; i < 32 * W; i += blockDim.x)
    in_s[i] = i < n_in ? in_g[i] : 0;
}

// Packed word k of cycle t's spike row: bit i fires iff
// counter_hash(seed, t, 32k + i) & 0xFF < intensity[32k + i].  px holds
// the word's 32 intensities, little-endian: byte j of px[q] is input
// 32k + 4q + j.
__device__ __forceinline__ uint32_t draw_word_from(const uint32_t (&px)[8],
                                                   uint32_t seed, uint32_t t,
                                                   int k) {
  const uint32_t base = 32u * static_cast<uint32_t>(k);
  uint32_t word = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * q + j;
      const uint32_t h = counter_hash(seed, t, base + i);
      const uint32_t in = (px[q] >> (8 * j)) & 0xFFu;
      word |= static_cast<uint32_t>((h & 0xFFu) < in) << i;
    }
  }
  return word;
}

// The same with the intensities staged in shared memory: in_s is 4-byte
// aligned, and word k's are its bytes 32k .. 32k + 31.
__device__ __forceinline__ uint32_t draw_word(const uint8_t* in_s,
                                              uint32_t seed, uint32_t t,
                                              int k) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(in_s) + 8 * k;
  uint32_t px[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) px[q] = words[q];
  return draw_word_from(px, seed, t, k);
}

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// Streamlined LIF: v' = v + input; fire iff v' >= threshold; a fired
// neuron resets to 0, else max(v' - leak, 0).  Returns the new v.
__device__ __forceinline__ int32_t lif_update(int32_t v, int32_t input,
                                              int threshold, int leak,
                                              bool* fired) {
  const int32_t v_int = add32(v, input);
  *fired = v_int >= threshold;
  const int32_t leaked = static_cast<int32_t>(static_cast<uint32_t>(v_int) -
                                              static_cast<uint32_t>(leak));
  return *fired ? 0 : max(leaked, 0);
}

// Sum over the warp; every lane gets the total.
__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The same sum in one instruction (redux.sync, sm_80 and later) instead
// of five dependent shuffles: the training and step kernels' rows sit on
// a serial chain of cycles, where each shuffle's latency counts.
__device__ __forceinline__ int warp_add(int x) {
  return __reduce_add_sync(0xffffffffu, x);
}

// Two steps of the 16-bit Fibonacci LFSR (taps 16, 14, 13, 11) of
// repro_torch.core.lfsr.step, s1 = step(s) and s2 = step(s1), at once:
// s2's bits 0-13 are s's bits 2-15, bit 14 is s1's bit 15 (the first
// feedback, or'd with s's bit 16 as the masked shift leaves it) and bit
// 15 the second feedback, which reads s's bits 1, 3, 4 and 6.  So s1's
// low 10 bits, which LTP tests, are (s >> 1) & 0x3FF, and s2's, which LTD
// tests, (s >> 2) & 0x3FF: neither waits for a feedback.
__device__ __forceinline__ uint32_t lfsr_step2(uint32_t s) {
  const uint32_t fb1 = ((s ^ (s >> 2) ^ (s >> 3) ^ (s >> 5)) | (s >> 16)) & 1u;
  const uint32_t fb2 = ((s >> 1) ^ (s >> 3) ^ (s >> 4) ^ (s >> 6)) & 1u;
  return ((s >> 2) & 0x3FFFu) | (fb1 << 14) | (fb2 << 15);
}

// The homeostatic LTD probability of a row with pc ON synapses is
// clip(e / n_syn, 0, 1023), e = (pc - w_exp) * gain * 1024 wrapping in
// int32 (truncating division).  ltd_excess gives e; ltd_prob the
// probability, for a pass over many words of a row; ltd_hit whether one
// 10-bit draw x is at or under it without the division, for a lane on a
// chain of cycles: for e >= 0, x <= floor(e / n_syn) iff x * n_syn <= e
// (and x <= 1023 always); for e < 0 the probability is 0.  Truncating and
// floor division agree after the clip.  n_syn >= 1, which the wrappers
// require.
__device__ __forceinline__ int32_t ltd_excess(int pc, int w_exp, int gain) {
  const uint32_t d = static_cast<uint32_t>(pc) - static_cast<uint32_t>(w_exp);
  return static_cast<int32_t>(d * static_cast<uint32_t>(gain) * 1024u);
}

__device__ __forceinline__ uint32_t ltd_prob(int32_t excess, int n_syn) {
  return static_cast<uint32_t>(min(max(excess / n_syn, 0), 1023));
}

__device__ __forceinline__ bool ltd_hit(uint32_t x, int32_t excess,
                                        int n_syn) {
  return excess < 0 ? x == 0
                    : static_cast<long long>(x) * n_syn <= excess;
}

// Words of a row a lane loads together in the STDP pass before it stores
// any of them.
constexpr int kStdpBatch = 4;

// Binary stochastic STDP on one fired row, by the warp that owns it
// (lanes stride the W words).  Reads the row's weights w and LFSR lanes
// st; writes w_out and st_out, which may be w and st themselves.  Per
// word: s1, s2 = two LFSR steps; LTP w |= pre when (s1 & 0x3FF) <=
// ltp_prob (u32 compare); the lane keeps s2.  Then, with pc the
// popcount of the whole LTP'd row, LTD w &= pre when (s2 & 0x3FF) is at
// or under the row's LTD probability.  The outputs may alias the inputs,
// so the compiler keeps every load after the stores before it; each lane
// therefore loads kStdpBatch of its words before it stores any (a word
// is only ever touched by its own lane).
__device__ __forceinline__ void stdp_row(const uint32_t* w,
                                         const uint32_t* st,
                                         uint32_t* w_out, uint32_t* st_out,
                                         const uint32_t* pre, int W,
                                         int lane, uint32_t ltp_prob,
                                         int w_exp, int gain, int n_syn) {
  int pc = 0;
  for (int k0 = lane; k0 < W; k0 += 32 * kStdpBatch) {
    uint32_t s[kStdpBatch], word[kStdpBatch], p[kStdpBatch];
#pragma unroll
    for (int u = 0; u < kStdpBatch; ++u) {
      const int k = k0 + 32 * u;
      s[u] = k < W ? st[k] : 0;
      word[u] = k < W ? w[k] : 0;
      p[u] = k < W ? pre[k] : 0;
    }
#pragma unroll
    for (int u = 0; u < kStdpBatch; ++u) {
      const int k = k0 + 32 * u;
      if (((s[u] >> 1) & 0x3FFu) <= ltp_prob) word[u] |= p[u];
      pc += __popc(word[u]);
      if (k < W) {
        w_out[k] = word[u];
        st_out[k] = lfsr_step2(s[u]);
      }
    }
  }
  const uint32_t prob = ltd_prob(ltd_excess(warp_add(pc), w_exp, gain),
                                 n_syn);
  for (int k0 = lane; k0 < W; k0 += 32 * kStdpBatch) {
    uint32_t s[kStdpBatch], word[kStdpBatch], p[kStdpBatch];
#pragma unroll
    for (int u = 0; u < kStdpBatch; ++u) {
      const int k = k0 + 32 * u;
      s[u] = k < W ? st_out[k] : 0;
      word[u] = k < W ? w_out[k] : 0;
      p[u] = k < W ? pre[k] : 0;
    }
#pragma unroll
    for (int u = 0; u < kStdpBatch; ++u) {
      const int k = k0 + 32 * u;
      if (k < W && (s[u] & 0x3FFu) <= prob) w_out[k] = word[u] & p[u];
    }
  }
}

// The shared memory one block may opt into on the current device.
inline cudaError_t block_smem_limit(size_t* limit) {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *limit = static_cast<size_t>(bytes);
  return err;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace snn
