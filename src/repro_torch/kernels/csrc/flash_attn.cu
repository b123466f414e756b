// Prefill attention (online softmax, causal / sliding-window / GQA) for
// sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, `_flash_kernel`): q [B, Hq, Tq, D], k and v
// [B, Hkv, Tk, D] -> o [B, Hq, Tq, D] in the input dtype (bf16 or f32),
// f32 accumulation.  Queries are the last Tq positions of the Tk-long
// stream; the KV head of query head h is h / (Hq / Hkv).  Scores start at
// -1e30, not -inf, and p is masked again after the exponential, so a row
// whose first KV tiles are fully masked accumulates nothing from them; a
// row that is masked everywhere gives zeros (l == 0 is read as 1).  The
// scale multiplies q in f32 before the product, as the Pallas kernel
// does.
//
// What bounds it: at the LM slice's shapes (gemma3-1b: Hq 4, Hkv 1,
// D 256, T up to 2,048; starcoder2-3b width: Hq 24, Hkv 2, D 128) the
// work is 4 B Hq D flops per unmasked (q, k) pair against q, k, v and o
// read or written once: hundreds of flops per byte, so the card's
// tensor-core rate is the bound.  This first kernel does not reach it:
// it multiplies in f32 on the CUDA cores (no tensor cores, no TMA), which
// keeps one code path exact enough for f32 and bf16 inputs alike.
//
// Design.  The Pallas grid runs its KV axis in order on one core and
// carries m, l and the accumulator in VMEM between grid steps.  Here one
// block of 256 threads owns one (batch, q head, 64-row q tile) and loops
// over the KV tiles itself; nothing carries between blocks.  The q tile
// (scaled, f32), one K tile and one V tile (f32) and the tile of scores
// live in shared memory (up to 139 KB at D 256, hence the opt-in above
// 48 KB).  Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i of the
// tile for both products: its scores at columns tx + 16 j, its output at
// columns VEC tx + 16 VEC g + e, so the row statistics m, l and the
// rescale factor stay in its registers, and a row's maximum and sum are
// shuffles within a half-warp.  KV tiles wholly outside the causal or
// window band of the q tile are skipped (at T 2,048 and 64-row tiles a
// window-512 q tile reads at most 9 of 32 KV tiles); the ragged edge of
// Tq and Tk is masked here, so any lengths are taken.  Rows of q, k and v
// are read with the caller's strides (the last dimension contiguous), so
// the transposed views of a fused qkv projection need no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr int kBlockQ = 64;        // q rows per block
constexpr int kPad = 4;            // floats of padding per staged row
constexpr float kNegInf = -1e30f;

// error codes beside cudaError_t's (which are positive)
constexpr int kBadArgs = -2;
constexpr int kBadHeadDim = -3;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_st;      // element strides of batch, head, row
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  int hq, hkv, tq, tk;
  int causal;
  int window;                      // <= 0: no window
  float scale;
};

template <int D>
struct Tile {
  static constexpr int kBlockK = D >= 256 ? 32 : 64;   // KV rows per tile
  static constexpr int kVec = D >= 64 ? 4 : 2;         // output columns per group
  static constexpr int kGroups = D / (16 * kVec);      // groups per thread
  static constexpr int kRows = kBlockQ / 16;           // rows per thread
  static constexpr int kCols = kBlockK / 16;           // score columns per thread
  static constexpr int kQStride = D + kPad;
  static constexpr int kKStride = D + kPad;
  static constexpr int kSStride = kBlockK + kPad;
  static constexpr int kSmemFloats = kBlockQ * kQStride + kBlockK * kKStride
                                     + kBlockK * D + kBlockQ * kSStride;
  static constexpr int kSmemBytes = kSmemFloats * 4;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Stage rows [r0, r0 + rows) of one head (row stride `st` elements) into
// shared memory as f32 times `mul`, rows past `n` as zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int dst_stride,
                                      const T* src, long long st, int r0,
                                      int rows, int n, float mul) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int row = r0 + r;
    dst[r * dst_stride + c] =
        row < n ? load_f32(src + row * st + c) * mul : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Params p) {
  using L = Tile<D>;
  constexpr int BK = L::kBlockK;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                 // [kBlockQ][kQStride]
  float* ks = qs + kBlockQ * L::kQStride;           // [BK][kKStride]
  float* vs = ks + BK * L::kKStride;                // [BK][D]
  float* ss = vs + BK * D;                          // [kBlockQ][kSStride]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int offset = p.tk - p.tq;   // absolute position of q row 0

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  stage<T, D>(qs, L::kQStride, qg, p.q_st, q0, kBlockQ, p.tq, p.scale);

  // the KV tiles this q tile needs: [k_lo, k_hi)
  const int q_last = min(q0 + kBlockQ, p.tq) - 1 + offset;
  const int q_first = q0 + offset;
  int k_hi = p.causal ? min(p.tk, q_last + 1) : p.tk;
  int k_lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  k_lo = (k_lo / BK) * BK;

  float acc[L::kRows][L::kGroups][L::kVec];
  float m[L::kRows], l[L::kRows];
#pragma unroll
  for (int i = 0; i < L::kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g)
#pragma unroll
      for (int e = 0; e < L::kVec; ++e) acc[i][g][e] = 0.0f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the previous tile's K, V and scores are consumed
    stage<T, D>(ks, L::kKStride, kg, p.k_st, k0, BK, p.tk, 1.0f);
    stage<T, D>(vs, D, vg, p.v_st, k0, BK, p.tk, 1.0f);
    __syncthreads();

    // scores s[i][j] = q[ty + 16 i] . k[tx + 16 j]
    float s[L::kRows][L::kCols];
#pragma unroll
    for (int i = 0; i < L::kRows; ++i)
#pragma unroll
      for (int j = 0; j < L::kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 a[L::kRows], c[L::kCols];
#pragma unroll
      for (int i = 0; i < L::kRows; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            qs + (ty + 16 * i) * L::kQStride + d);
#pragma unroll
      for (int j = 0; j < L::kCols; ++j)
        c[j] = *reinterpret_cast<const float4*>(
            ks + (tx + 16 * j) * L::kKStride + d);
#pragma unroll
      for (int i = 0; i < L::kRows; ++i)
#pragma unroll
        for (int j = 0; j < L::kCols; ++j)
          s[i][j] += a[i].x * c[j].x + a[i].y * c[j].y + a[i].z * c[j].z
                     + a[i].w * c[j].w;
    }

    // mask, online softmax, rescale; p goes to shared memory
#pragma unroll
    for (int i = 0; i < L::kRows; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r + offset;
      bool ok[L::kCols];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < L::kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < p.tk && q0 + r < p.tq;
        if (p.causal) ok[j] = ok[j] && kpos <= qpos;
        if (p.window > 0) ok[j] = ok[j] && kpos > qpos - p.window;
        s[i][j] = ok[j] ? s[i][j] : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < L::kCols; ++j) {
        const float e = ok[j] ? __expf(s[i][j] - m_new) : 0.0f;
        ss[r * L::kSStride + tx + 16 * j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = __expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < L::kGroups; ++g)
#pragma unroll
        for (int e = 0; e < L::kVec; ++e) acc[i][g][e] *= alpha;
    }
    __syncthreads();

    // acc += p v
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pr[L::kRows];
#pragma unroll
      for (int i = 0; i < L::kRows; ++i)
        pr[i] = ss[(ty + 16 * i) * L::kSStride + kk];
#pragma unroll
      for (int g = 0; g < L::kGroups; ++g) {
        const float* vrow = vs + kk * D + L::kVec * tx + 16 * L::kVec * g;
        float vv[L::kVec];
        if constexpr (L::kVec == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vrow);
          vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vrow);
          vv[0] = t.x; vv[1] = t.y;
        }
#pragma unroll
        for (int i = 0; i < L::kRows; ++i)
#pragma unroll
          for (int e = 0; e < L::kVec; ++e) acc[i][g][e] += pr[i] * vv[e];
      }
    }
  }

  // o = acc / l (a row masked everywhere has l == 0 and gives zeros)
  T* og = static_cast<T*>(p.o) + ((long long)b * p.hq + h) * p.tq * D;
#pragma unroll
  for (int i = 0; i < L::kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.tq) continue;
    const float inv = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g)
#pragma unroll
      for (int e = 0; e < L::kVec; ++e)
        store_as(og + (long long)r * D + L::kVec * tx + 16 * L::kVec * g + e,
                 acc[i][g][e] * inv);
  }
}

template <typename T, int D>
int launch(const Params& p, int b, cudaStream_t stream) {
  constexpr int bytes = Tile<D>::kSmemBytes;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.tq + kBlockQ - 1) / kBlockQ, p.hq, b);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int b, int d, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(p, b, stream);
    case 64: return launch<T, 64>(p, b, stream);
    case 128: return launch<T, 128>(p, b, stream);
    case 256: return launch<T, 256>(p, b, stream);
    default: return kBadHeadDim;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block at head_dim d (0: d not supported).
long long flash_attn_smem_bytes(int d) {
  switch (d) {
    case 32: return Tile<32>::kSmemBytes;
    case 64: return Tile<64>::kSmemBytes;
    case 128: return Tile<128>::kSmemBytes;
    case 256: return Tile<256>::kSmemBytes;
    default: return 0;
  }
}

// o[B, Hq, Tq, D] (contiguous) from q, k, v with element strides of
// batch, head and row (the last dimension contiguous).  dtype 0: f32,
// 1: bf16.  Returns 0, a cudaError_t, or a negative code for arguments
// the kernel does not take.
int flash_attn_forward(const void* q, const void* k, const void* v, void* o,
                       long long q_sb, long long q_sh, long long q_st,
                       long long k_sb, long long k_sh, long long k_st,
                       long long v_sb, long long v_sh, long long v_st,
                       int b, int hq, int hkv, int tq, int tk, int d,
                       int causal, int window, int dtype, float scale,
                       void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || tq < 1 || tk < 0)
    return kBadArgs;
  const Params p{q, k, v, o, q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                 v_sb, v_sh, v_st, hq, hkv, tq, tk, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, b, d, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, b, d, s);
  return kBadArgs;
}

const char* flash_attn_error_string(int code) {
  if (code == kBadArgs) return "arguments the kernel does not take";
  if (code == kBadHeadDim) return "head_dim not one of 32, 64, 128, 256";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
