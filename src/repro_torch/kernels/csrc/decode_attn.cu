// Decode attention (one new token's query against a KV cache, GQA, the
// ring buffer's valid count or a sliding window) for sm_90a: flash-decoding
// over the cache as it lies, in place, in bf16 or float32.
//
// Replaces no TPU kernel: the JAX package computes decode attention under
// XLA (src/repro/models/layers/attention.py:134-159, `decode_attention`),
// and so did the port, in plain PyTorch: every step it copied all S
// allocated positions of k and v to float32, ran two float32 products over
// all of them and masked the dead positions afterwards, so a step read the
// bf16 cache, wrote it back at twice the size and read that again, for
// every position up to S whatever the sequence's length.  This kernel
// computes the same function: q [B, Hq, 1, D], k and v [B, Hkv, S, D] ->
// o [B, Hq, 1, D] in q's dtype.  Row b attends to positions [lo, hi):
// hi = min(n_b, S) for its length n_b (a scalar, or an int32 / int64 per
// row on the device), lo = max(0, n_b - window) with a window, else 0; a
// row that this leaves empty attends, as the plain version's softmax over
// scores that are all -1e30 does, uniformly to all S positions.  The KV
// head of query head h is h / (Hq / Hkv).  The precision is the plain
// version's: q is converted to float32 and scaled there (then times
// log2 e, so the exponentials are exp2), each k and v element is converted
// to float32 in registers, the scores, the online softmax and P V are
// float32, and the output is rounded to q's dtype once.
//
// What bounds it: per cache position and KV head, 2 D elements of k and v
// against 4 G D flops (G = Hq / Hkv query heads share them): for mixtral
// (D 128, G 6, bf16) 3 FMAs a byte, under the ~10 that the CUDA cores do
// per byte of HBM bandwidth (67 TFLOP/s over 3.35 TB/s).  So the bound is
// the bytes of the live cache, read once: B Hkv (hi - lo) 2 D
// sizeof(dtype), and the tensor cores are not needed.  The design meets it
// by reading only [lo, hi) of each row, each byte once, with 16-byte
// copies that keep enough of them in flight:
//
// * One block (128 threads) per (sequence, KV head, group of HP query
//   heads, split of the positions).  A team of D / 8 lanes holds 8
//   elements of a row each (16 bytes in bf16); the block's 128 / (D / 8)
//   teams take interleaved positions, so a warp's copies of k and v are
//   whole contiguous rows.  Each lane keeps its HP heads' q (8 elements
//   each), running maxima, sums and accumulators in registers: a k row
//   converted once serves all HP heads.  HP is the largest of 8, 6, 4, 2
//   and 1 that divides G (mixtral's 6: one block reads the cache once).
// * Each lane copies exactly the bytes it will read itself with
//   cp.async.cg (16 bytes a copy; L1 bypassed) into its own slots of a
//   ring of kStages stages in shared memory, so no barrier is needed
//   between stages: kStages - 1 stages are in flight while one is
//   computed.  Positions past the range are copied as zeros (0 source
//   bytes) and masked.
// * A score is the team's sum of its lanes' 8 products (xor shuffles).
//   The softmax rescales the accumulators only when a maximum grows.
// * A block wholly past its row's range exits at once, so the bytes read
//   follow the live lengths, not S.  The teams' states are merged in
//   shared memory at the end; with more than one split a second small
//   kernel merges the splits' (m, l, acc).
// * The split count is chosen from what the caller sees without reading
//   the device (`decode_attn_plan`): B, Hkv, G, the allocated S, and how
//   many blocks the card holds at once: about two waves of blocks, no
//   split shorter than kMinSplit positions.  No host read of the lengths,
//   no sync: a decode step stays capturable as a CUDA graph.
//
// q is read with the caller's strides (any, the last dimension
// contiguous); k and v with the caller's strides too, but 16-byte copies
// need each base 16-byte aligned and every stride a whole 16 bytes (the
// wrapper checks it, as the bf16 flash kernel checks it for TMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 8;            // elements of a row a lane holds
constexpr int kStages = 3;         // cp.async ring depth
constexpr int kStageBytes = 64;    // bytes of k (and as many of v) a lane
                                   // copies a stage: 4 bf16 rows, 2 f32
constexpr int kSmemBytes = kStages * 2 * kStageBytes * kThreads;  // 48 KB
constexpr int kMinSplit = 256;     // positions, the shortest split
constexpr int kSplitAlign = 64;    // a split's length is a multiple
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// error codes beside cudaError_t's (which are positive)
constexpr int kBadArgs = -2;
constexpr int kBadHeadDim = -3;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;          // the splits' acc [B, Hq, n_split, D], then their
                        // (m, l) [B, Hq, n_split, 2]; null with one split
  const void* lens;     // the rows' lengths, or null (len_value for all)
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long len_stride, len_value;
  int len_kind;         // 0: len_value; 1: int32 at lens; 2: int64
  int hq, hkv, s, window, n_split, split_len;
  float scale;
};

// 2^x on the special-function unit (as the flash kernel takes it): its
// relative error (~2^-22) is far inside the tolerances of both dtypes.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The 8 elements a lane holds of a row, from shared memory, as float32.
__device__ __forceinline__ void load_row(const float* src, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load_row(const __nv_bfloat16* src,
                                         float (&x)[kVec]) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {          // bf16 is float32's upper half
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Copies a lane's 8 elements of a row (16 or 32 bytes) to shared memory
// at `dst`, or zeros where !ok (0 source bytes: nothing is read).
template <typename T>
__device__ __forceinline__ void copy_row(uint32_t dst, const T* src,
                                         bool ok) {
#pragma unroll
  for (int c = 0; c < kVec * static_cast<int>(sizeof(T)) / 16; ++c)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(dst + 16 * c),
                    "l"(reinterpret_cast<const char*>(src) + 16 * c),
                    "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ long long row_len(const Params& p, int b) {
  if (p.len_kind == 1)
    return static_cast<const int*>(p.lens)[b * p.len_stride];
  if (p.len_kind == 2)
    return static_cast<const long long*>(p.lens)[b * p.len_stride];
  return p.len_value;
}

// Row b's live positions [*lo, *hi), as the plain version masks them.
// Returns false where that leaves none: then all S positions, with q
// read as zeros (equal scores, the plain version's uniform softmax).
__device__ __forceinline__ bool live_range(const Params& p, int b, int* lo,
                                           int* hi) {
  const long long n = row_len(p, b);
  long long a = p.window > 0 ? n - p.window : 0;
  a = a > 0 ? a : 0;
  const long long e = n < p.s ? n : p.s;
  if (a >= e) {
    *lo = 0;
    *hi = p.s;
    return false;
  }
  *lo = static_cast<int>(a);
  *hi = static_cast<int>(e);
  return true;
}

template <typename T, int D, int HP>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const Params p) {
  constexpr int TX = D / kVec;                  // lanes a row
  constexpr int kTeams = kThreads / TX;
  constexpr int kBytes = kVec * static_cast<int>(sizeof(T));
  constexpr int kRows = kStageBytes / kBytes;   // a team's positions a stage
  constexpr int kTile = kTeams * kRows;         // the block's a stage
  extern __shared__ __align__(16) unsigned char smem[];

  const int groups = p.hq / p.hkv / HP;
  const int kvh = blockIdx.y / groups;
  const int h0 = kvh * (p.hq / p.hkv) + (blockIdx.y % groups) * HP;
  const int b = blockIdx.z;
  int lo, hi;
  const bool live = live_range(p, b, &lo, &hi);
  const int begin = max(lo, static_cast<int>(blockIdx.x) * p.split_len);
  const int end = min(hi, (static_cast<int>(blockIdx.x) + 1) * p.split_len);
  if (begin >= end) return;

  const int team = threadIdx.x / TX;
  const int lane = threadIdx.x % TX;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh
                + lane * kVec;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh
                + lane * kVec;
  const uint32_t ring =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // this lane's slot of row j (k, or v with kv 1) in stage `st`
  const auto slot = [&](int st, int j, int kv) {
    return ((st * kRows + j) * 2 + kv) * kThreads * kBytes
           + static_cast<int>(threadIdx.x) * kBytes;
  };
  const int n_stages = (end - begin + kTile - 1) / kTile;
  const auto issue = [&](int i) {
    const int st = i % kStages;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int pos = begin + i * kTile + j * kTeams + team;
      const bool ok = pos < end;
      const int at = ok ? pos : begin;
      copy_row<T>(ring + slot(st, j, 0), kg + at * p.k_st, ok);
      copy_row<T>(ring + slot(st, j, 1), vg + at * p.v_st, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_stages) issue(i);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }

  // q, scaled in float32 as the plain version scales it, then by log2 e
  float q[HP][kVec];
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + lane * kVec;
#pragma unroll
  for (int h = 0; h < HP; ++h)
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      q[h][i] = live ? to_f32(qg[(h0 + h) * p.q_sh + i]) * p.scale * kLog2e
                     : 0.0f;
  float m[HP], l[HP], acc[HP][kVec];
#pragma unroll
  for (int h = 0; h < HP; ++h) {
    m[h] = kNegInf;
    l[h] = 0.0f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[h][i] = 0.0f;
  }

  for (int i = 0; i < n_stages; ++i) {
    // refill the slots this lane read in stage i - 1 (no other lane reads
    // them), then wait for stage i's copies
    if (i + kStages - 1 < n_stages) issue(i + kStages - 1);
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group %0;" :: "n"(kStages - 1) : "memory");
    const int st = i % kStages;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const bool ok = begin + i * kTile + j * kTeams + team < end;
      float x[kVec];
      load_row(reinterpret_cast<const T*>(smem + slot(st, j, 0)), x);
      float sc[HP];
#pragma unroll
      for (int h = 0; h < HP; ++h) {
        float s = 0.0f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) s = fmaf(q[h][e], x[e], s);
        sc[h] = s;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off /= 2)
#pragma unroll
        for (int h = 0; h < HP; ++h)
          sc[h] += __shfl_xor_sync(0xffffffffu, sc[h], off);
      load_row(reinterpret_cast<const T*>(smem + slot(st, j, 1)), x);
      if (ok) {                                  // uniform in the team
#pragma unroll
        for (int h = 0; h < HP; ++h) {
          if (sc[h] > m[h]) {
            const float alpha = fast_exp2(m[h] - sc[h]);
            l[h] *= alpha;
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[h][e] *= alpha;
            m[h] = sc[h];
          }
          const float pr = fast_exp2(sc[h] - m[h]);
          l[h] += pr;
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[h][e] = fmaf(pr, x[e], acc[h][e]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // merge the teams: acc [team][h][D], (m, l) [team][h], weights [team][h]
  float* red = reinterpret_cast<float*>(smem);
  float* ml = red + kTeams * HP * D;
  float* wt = ml + 2 * kTeams * HP;
  float* tot = wt + kTeams * HP;                 // [h]: (M, L)
#pragma unroll
  for (int h = 0; h < HP; ++h) {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      red[(team * HP + h) * D + lane * kVec + e] = acc[h][e];
    if (lane == 0) {
      ml[2 * (team * HP + h)] = m[h];
      ml[2 * (team * HP + h) + 1] = l[h];
    }
  }
  __syncthreads();
  if (threadIdx.x < HP) {
    const int h = threadIdx.x;
    float mx = kNegInf;
    for (int t = 0; t < kTeams; ++t) mx = fmaxf(mx, ml[2 * (t * HP + h)]);
    float sum = 0.0f;
    for (int t = 0; t < kTeams; ++t) {
      const float w = fast_exp2(ml[2 * (t * HP + h)] - mx);
      wt[t * HP + h] = w;
      sum = fmaf(ml[2 * (t * HP + h) + 1], w, sum);
    }
    tot[2 * h] = mx;
    tot[2 * h + 1] = sum;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < HP * D; x += kThreads) {
    const int h = x / D;
    const int d = x - h * D;
    float a = 0.0f;
    for (int t = 0; t < kTeams; ++t)
      a = fmaf(red[(t * HP + h) * D + d], wt[t * HP + h], a);
    const long long row = static_cast<long long>(b) * p.hq + h0 + h;
    if (p.n_split == 1) {
      store(static_cast<T*>(p.o) + row * D + d, a / tot[2 * h + 1]);
    } else {
      const long long at = row * p.n_split + blockIdx.x;
      p.part[at * D + d] = a;
      if (d == 0) {
        float* pml = p.part + static_cast<long long>(gridDim.z) * p.hq
                                  * p.n_split * D;
        pml[2 * at] = tot[2 * h];
        pml[2 * at + 1] = tot[2 * h + 1];
      }
    }
  }
}

// With more than one split: o[b, h] from the (m, l, acc) of the splits
// that cover row b's range (the others never ran).  One block a (head,
// sequence).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_combine_kernel(const Params p, int d_len, int batch) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  int lo, hi;
  live_range(p, b, &lo, &hi);
  const int z0 = lo / p.split_len;
  const int z1 = (hi - 1) / p.split_len;
  const long long row = static_cast<long long>(b) * p.hq + h;
  const float* acc = p.part + row * p.n_split * d_len;
  const float* ml = p.part + static_cast<long long>(batch) * p.hq
                                 * p.n_split * d_len
                    + 2 * row * p.n_split;
  float mx = kNegInf;
  for (int z = z0; z <= z1; ++z) mx = fmaxf(mx, ml[2 * z]);
  float sum = 0.0f;
  for (int z = z0; z <= z1; ++z)
    sum = fmaf(ml[2 * z + 1], fast_exp2(ml[2 * z] - mx), sum);
  for (int d = threadIdx.x; d < d_len; d += kThreads) {
    float a = 0.0f;
    for (int z = z0; z <= z1; ++z)
      a = fmaf(acc[z * d_len + d], fast_exp2(ml[2 * z] - mx), a);
    store(static_cast<T*>(p.o) + row * d_len + d, a / sum);
  }
}

// The query heads a block takes: the largest of 8, 6, 4, 2, 1 dividing G.
int heads_per_block(int g) {
  for (int hp : {8, 6, 4, 2}) if (g % hp == 0) return hp;
  return 1;
}

template <typename T, int D>
const void* kernel_of(int hp) {
  switch (hp) {
    case 8: return reinterpret_cast<const void*>(decode_attn_kernel<T, D, 8>);
    case 6: return reinterpret_cast<const void*>(decode_attn_kernel<T, D, 6>);
    case 4: return reinterpret_cast<const void*>(decode_attn_kernel<T, D, 4>);
    case 2: return reinterpret_cast<const void*>(decode_attn_kernel<T, D, 2>);
    default:
      return reinterpret_cast<const void*>(decode_attn_kernel<T, D, 1>);
  }
}

template <typename T>
const void* kernel_of(int d, int hp) {
  switch (d) {
    case 32: return kernel_of<T, 32>(hp);
    case 64: return kernel_of<T, 64>(hp);
    case 128: return kernel_of<T, 128>(hp);
    case 256: return kernel_of<T, 256>(hp);
    default: return nullptr;
  }
}

// The main kernel's instantiation for (dtype 0: f32, 1: bf16, head_dim d,
// hp query heads a block) in *fn, with the dynamic shared memory it takes
// allowed.  Returns 0, a cudaError_t, or kBadHeadDim.
int kernel_of(int dtype, int d, int hp, const void** fn) {
  *fn = dtype == 1 ? kernel_of<__nv_bfloat16>(d, hp) : kernel_of<float>(d, hp);
  if (*fn == nullptr) return kBadHeadDim;
  return static_cast<int>(cudaFuncSetAttribute(
      *fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
}

}  // namespace

extern "C" {

// The split of the positions for a call (b, hq, hkv, s, d, dtype 0: f32,
// 1: bf16) on the current card: out[0] splits of out[1] positions each
// (the last may be shorter).  About two waves of blocks where B Hkv G / HP
// blocks are fewer, no split shorter than kMinSplit; one split where the
// blocks fill two waves already.  Returns 0, a cudaError_t, or a negative
// code for arguments the kernel does not take.
int decode_attn_plan(int b, int hq, int hkv, int s, int d, int dtype,
                     void* out) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || s < 1
      || (dtype != 0 && dtype != 1))
    return kBadArgs;
  const int hp = heads_per_block(hq / hkv);
  const void* fn;
  const int err = kernel_of(dtype, d, hp, &fn);
  if (err != 0) return err;
  int resident = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, fn, kThreads, kSmemBytes);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = static_cast<long long>(b) * (hq / hp);
  const long long want = 2LL * sms * (resident > 0 ? resident : 1);
  long long n = (want + blocks - 1) / blocks;
  const long long most = (s + kMinSplit - 1) / kMinSplit;
  n = n < most ? n : most;
  n = n > 1 ? n : 1;
  long long len = (s + n - 1) / n;
  len = (len + kSplitAlign - 1) / kSplitAlign * kSplitAlign;
  int* o = static_cast<int*>(out);
  o[0] = static_cast<int>((s + len - 1) / len);
  o[1] = static_cast<int>(len);
  return 0;
}

// o[B, Hq, 1, D] (contiguous) from q [B, Hq, 1, D] (batch and head
// strides q_sb, q_sh), k and v [B, Hkv, S, D] (batch, head and position
// strides; a 16-byte aligned base and strides of whole 16 bytes), the
// lengths (len_kind 0: len_value for every row; 1: int32, 2: int64 at
// lens with stride len_stride) and window (0: none), as planned by
// decode_attn_plan (n_split, split_len; part holds B Hq n_split (D + 2)
// floats where n_split > 1).  dtype 0: f32, 1: bf16 (q, k, v and o).
// Returns 0, a cudaError_t, or a negative code for arguments the kernel
// does not take.
int decode_attn_forward(const void* q, const void* k, const void* v, void* o,
                        float* part, const void* lens,
                        long long q_sb, long long q_sh,
                        long long k_sb, long long k_sh, long long k_st,
                        long long v_sb, long long v_sh, long long v_st,
                        long long len_stride, long long len_value,
                        int len_kind, int b, int hq, int hkv, int s, int d,
                        int window, int dtype, int n_split, int split_len,
                        float scale, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || s < 1 || window < 0
      || n_split < 1 || split_len < 1
      || static_cast<long long>(n_split) * split_len < s
      || (n_split > 1 && part == nullptr) || len_kind < 0 || len_kind > 2
      || (len_kind != 0 && lens == nullptr))
    return kBadArgs;
  const auto on16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const long long per16 = dtype == 1 ? 8 : 4;
  if (!on16(k) || !on16(v)
      || (k_sb | k_sh | k_st | v_sb | v_sh | v_st) % per16 != 0)
    return kBadArgs;
  if (dtype != 0 && dtype != 1) return kBadArgs;
  const int hp = heads_per_block(hq / hkv);
  const void* fn;
  const int err = kernel_of(dtype, d, hp, &fn);
  if (err != 0) return err;
  Params p{q, k, v, o, part, lens, q_sb, q_sh, k_sb, k_sh, k_st,
           v_sb, v_sh, v_st, len_stride, len_value, len_kind, hq, hkv,
           s, window, n_split, split_len, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* args[] = {&p};
  cudaError_t e = cudaLaunchKernel(fn, dim3(n_split, hq / hp, b),
                                   dim3(kThreads), args, kSmemBytes, st);
  if (e != cudaSuccess || n_split == 1) return static_cast<int>(e);
  if (dtype == 1)
    decode_attn_combine_kernel<__nv_bfloat16>
        <<<dim3(hq, b), kThreads, 0, st>>>(p, d, b);
  else
    decode_attn_combine_kernel<float><<<dim3(hq, b), kThreads, 0, st>>>(
        p, d, b);
  return static_cast<int>(cudaGetLastError());
}

const char* decode_attn_error_string(int code) {
  if (code == kBadArgs) return "arguments the kernel does not take";
  if (code == kBadHeadDim) return "head_dim not one of 32, 64, 128, 256";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
