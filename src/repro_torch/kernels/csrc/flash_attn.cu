// Prefill attention (online softmax, causal / sliding-window / GQA) for
// sm_90a: both dtypes on the tensor cores, bf16 with `wgmma`, f32 as
// split TF32 with `mma.sync`.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, `_flash_kernel`): q [B, Hq, Tq, D], k and v
// [B, Hkv, Tk, D] -> o [B, Hq, Tq, D] in the input dtype (bf16 or f32),
// f32 accumulation.  Queries are the last Tq positions of the Tk-long
// stream; the KV head of query head h is h / (Hq / Hkv).  Scores start at
// -1e30, not -inf, and p is masked again after the exponential, so a row
// whose first KV tiles are fully masked accumulates nothing from them; a
// row that is masked everywhere gives zeros (l == 0 is read as 1).  Both
// kernels own one (batch, q head, 64-row q tile) per block and loop over
// the KV tiles themselves (the Pallas grid's sequential KV axis, which
// carries m, l and the accumulator in VMEM); nothing carries between
// blocks.  KV tiles wholly outside the causal or window band of the q
// tile are skipped, and the ragged edge of Tq and Tk is masked here, so
// any lengths are taken.  q, k and v are read with the caller's strides
// (the last dimension contiguous), so the transposed views of a fused qkv
// projection need no copy.
//
// What bounds it: at the LM slice's shapes (gemma3-1b: Hq 4, Hkv 1,
// D 256, T up to 2,048; starcoder2-3b width: Hq 24, Hkv 2, D 128) the
// work is 4 B Hq D flops per unmasked (q, k) pair against q, k, v and o
// read or written once: hundreds of flops per byte, so the tensor cores'
// rate is the bound: 989 TFLOP/s dense in bf16 on an H100 SXM, and in f32
// three TF32 products at 495 (~165 TFLOP/s of f32-accurate work).  One block
// runs on one SM, so a q tile can go no faster than 989 / 132 = 7.5
// TFLOP/s: the last causal q tile of gemma3-1b at T 2,048 (64 rows x
// 2,048 keys x D 256, 134 MFLOP) needs at least 18 us, whatever the rest
// of the card does.
//
// bf16: `flash_wgmma_kernel`.  One consumer warpgroup (128 threads) runs
// both products on the tensor cores with `wgmma`; one producer warp
// brings the q tile once and the K and V tiles (64 rows each) through a
// two-stage ring in shared memory with TMA, each tile released as soon
// as its product is done, so the next tiles' copies overlap this tile's
// work.  The tiles are 64 bf16 columns (128 bytes) wide per TMA box, with
// the 128-byte swizzle that `wgmma` reads (D 32: 64 bytes); a wider head
// is several boxes side by side (Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160
// KB at D 256).  S = Q K^T is m64n64k16 with both operands in shared
// memory, K-major.  The scores stay in registers: each thread holds two
// rows of the accumulator, so a row's maximum and sum are shuffles within
// a quad; they are scaled in f32 (log2 e folded in) and exponentiated on
// the special-function unit (ex2.approx), and only tiles that cross a
// band edge or the end of Tk run the masked softmax.  P, rounded to bf16,
// is the A operand of O += P V straight from the registers (the m64n64
// accumulator's layout is the A fragment of four k16 slices), and V is B
// in shared memory, MN-major (the transpose bit).  O is f32 in registers
// (128 a thread at D 256), one m64n64 accumulator per 64 columns.  TMA
// fills rows past Tq or Tk with zeros, so p = 0 never meets garbage V.
// Longest causal q tiles are launched first.  64-row q tiles give
// gemma3-1b's 4 heads x 32 tiles = 128 blocks for 132 SMs.  On the card
// the copies are not the limit (a build that copies each stage once and
// then re-reads it is no faster): the warpgroup's own chain of products,
// softmax and barrier waits is, about 1.3 us per 64-row KV tile at D 256.
// Overlapping the softmax with the previous tile's P V in the one
// warpgroup was slower at every shape, and a deeper ring no faster.
//
// f32: `flash_fwd_kernel` runs both products on the tensor cores in split
// TF32 (CUTLASS's OpMultiplyAddFastF32): each f32 operand x is split into
// big = tf32(x) and small = tf32(x - big), both rounded as `cvt.rna`
// rounds, and each product is big.big + big.small + small.big (three
// `mma.sync.m16n8k8` TF32 instructions, f32 sums): x's part past small is
// ~2^-22 x and small.small is dropped, so the scores and outputs keep
// about f32's accuracy.  The f32 bound is therefore three TF32 products
// at the tensor cores' 495 TFLOP/s, not the CUDA cores' 67.  `wgmma` is
// not used here: its TF32 form reads shared-memory operands K-major only
// (no transpose bit outside 16-bit types), so V would need a transposed
// copy, and the split halves a second copy of every tile (past 227 KB at
// D 256); with `mma.sync` the fragments come from registers in any
// layout, so the split costs registers and ALU work, not shared memory.
// 128 threads: each of four warps owns 16 rows of the 64-row q tile, so a
// row's maximum and sum are shuffles within a quad and the scores never
// leave registers.  Q (staged once) and a two-stage ring of K and V tiles
// (32 rows; 64 at D 32) sit in shared memory, rows padded so that every
// fragment read is a conflict-free 16-byte read (the sums over d, and the
// output columns, run in a permuted order to make them so); the next
// tile's copy (cp.async, 16 bytes a copy where the caller's bases and
// strides are whole 16 bytes, else 4, never a refusal) overlaps this
// tile's products, one barrier a tile.  P is the A operand of P V
// straight from the S accumulators: within each 8-key slice the keys are
// read in the order the accumulator holds them (see `f32_pv`), so P needs
// no shuffle and no trip through shared memory.  Shared memory: 201 KB at
// D 256 (one block an SM), 105 KB at D 128 (two).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockQ = 64;        // q rows per block
constexpr float kNegInf = -1e30f;

// error codes beside cudaError_t's (which are positive)
constexpr int kBadArgs = -2;
constexpr int kBadHeadDim = -3;
constexpr int kNoEncoder = -4;
constexpr int kBadTensorMap = -5;

// --- shared by both paths: the online softmax in registers -----------------

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit, without exp2f's accurate path: its
// relative error (~2^-22) is far inside the bf16 rounding of p and the
// f32 path's 1e-4.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Both paths hold the scores of one KV tile in the layout of the m16n8 /
// m64nN accumulators: element x of a thread (warp w, lane) is row
// r0 + 8 ((x / 2) % 2), r0 = 16 w + lane / 4, column 8 (x / 4) + c0 + x % 2,
// c0 = 2 (lane % 4).  So a row's maximum and sum are shuffles within a
// quad.
//
// The online softmax of one tile of N scores a thread (KV rows from k0),
// in place: scales them into the log2 domain, masks them if kMask (a tile
// that crosses a band edge or the end of Tk), and turns them into
// p = exp2(s - m) against the rows' new maxima m; alpha gets each row's
// rescale factor and l (this thread's columns only) the rows' sums of p.
template <bool kMask, int N, typename P>
__device__ __forceinline__ void online_softmax(
    float (&sc)[N], float (&m)[2], float (&l)[2], float (&alpha)[2],
    const P& p, int k0, int q_first, int r0, int c0) {
  static_assert(N <= 32, "one mask bit per score");
  uint32_t keep = 0;                             // bit x: sc[x] is unmasked
  if constexpr (kMask) {
#pragma unroll
    for (int x = 0; x < N; ++x) {
      const int kpos = k0 + 8 * (x / 4) + c0 + x % 2;
      const int qpos = q_first + r0 + 8 * ((x / 2) % 2);
      bool ok = kpos < p.tk;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && kpos > qpos - p.window;
      keep |= static_cast<uint32_t>(ok) << x;
    }
  }
  float mt[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int x = 0; x < N; ++x) {
    sc[x] *= p.scale_log2;
    if constexpr (kMask) sc[x] = (keep >> x) & 1u ? sc[x] : kNegInf;
    mt[(x / 2) % 2] = fmaxf(mt[(x / 2) % 2], sc[x]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float m_new = fmaxf(m[r], mt[r]);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int r = (x / 2) % 2;
    sc[x] = fast_exp2(sc[x] - m[r]);
    if constexpr (kMask) sc[x] = (keep >> x) & 1u ? sc[x] : 0.0f;
    l[r] += sc[x];
  }
}

// Does the KV tile [k0, k0 + rows) cross the end of Tk or an edge of the
// q tile's causal or window band (and so need the masked softmax)?
__device__ __forceinline__ bool tile_crosses_band(int k0, int rows, int tk,
                                                  int causal, int window,
                                                  int q_first, int q_last) {
  return k0 + rows > tk || (causal && k0 + rows - 1 > q_first)
         || (window > 0 && k0 <= q_last - window);
}

// --- f32: tensor cores, split TF32 (mma.sync) -------------------------------


constexpr int kF32Threads = 128;   // four warps, 16 q rows each

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;                         // [B, Hq, Tq, D], contiguous
  long long q_sb, q_sh, q_st;      // element strides of batch, head, row
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  int hq, hkv, tq, tk;
  int causal;
  int window;                      // <= 0: no window
  float scale_log2;                // scale * log2(e)
  int vec;                         // f32: bases and strides on 16 bytes
};

// Staged rows are padded so that every 16-byte fragment read of a quarter
// warp falls on eight different bank quads: Q and K rows (read across d)
// D + 16 floats apart, V rows (read across two keys) D + 4.
template <int D>
struct Tile {
  static constexpr int kBlockK = D >= 64 ? 32 : 64;   // KV rows per tile
  static constexpr int kQKStride = D + 16;
  static constexpr int kVStride = D + 4;
  static constexpr int kNb = kBlockK / 8;             // n8 blocks of S
  static constexpr int kOb = D / 8;                   // n8 blocks of O
  static constexpr int kQFloats = kBlockQ * kQKStride;
  static constexpr int kKFloats = kBlockK * kQKStride;
  static constexpr int kStageFloats = kKFloats + kBlockK * kVStride;
  // Q, then two stages of (K, V)
  static constexpr int kSmemBytes = 4 * (kQFloats + 2 * kStageFloats);
};

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as `cvt.rna.tf32.f32` rounds a finite x, in two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small + O(2^-22 x): both halves TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c[16 x 8] += a[16 x 8] b[8 x 8] on the tensor cores, TF32 in, f32 sums.
// Fragments (g = lane / 4, t = lane % 4): a0..a3 are A's (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); b0, b1 are B's (t, g),
// (t + 4, g); c0..c3 are C's (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A B in split TF32: big.small and small.big into `lo`, big.big into
// `hi` (the same accumulator, or two for more independent chains).
__device__ __forceinline__ void mma_split(float* hi, float* lo,
                                          const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4],
                                          const float (&b)[2]) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b[0], bb0, bs0);
  split_tf32(b[1], bb1, bs1);
  mma_tf32(lo, ab, bs0, bs1);
  mma_tf32(lo, as, bb0, bb1);
  mma_tf32(hi, ab, bb0, bb1);
}

// Copies rows [r0, r0 + rows) of one head (row stride `st` elements) to
// shared memory at `dst` (`stride` floats a row) with cp.async, rows at
// or past `n` as zeros (a copy of 0 source bytes): 16 bytes a copy where
// the caller's bases and strides allow it (`vec`), else 4.  Completes at
// the caller's cp.async.wait_group.
template <int D>
__device__ __forceinline__ void stage_async(uint32_t dst, int stride,
                                            const float* src, long long st,
                                            int r0, int rows, int n,
                                            bool vec) {
  if (vec) {
    constexpr int kQuads = D / 4;
    for (int idx = threadIdx.x; idx < rows * kQuads; idx += kF32Threads) {
      const int r = idx / kQuads;
      const int c = 4 * (idx - r * kQuads);
      const bool ok = r0 + r < n;
      const float* g = ok ? src + (r0 + r) * st + c : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                   :: "r"(dst + 4 * (r * stride + c)), "l"(g),
                      "r"(ok ? 16 : 0) : "memory");
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * D; idx += kF32Threads) {
      const int r = idx / D;
      const int c = idx - r * D;
      const bool ok = r0 + r < n;
      const float* g = ok ? src + (r0 + r) * st + c : src;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                   :: "r"(dst + 4 * (r * stride + c)), "l"(g),
                      "r"(ok ? 4 : 0) : "memory");
    }
  }
}

// S = Q K^T for this warp's 16 q rows (r0 = 16 w + g and r0 + 8) against
// the K tile, in split TF32.  The sum over d runs in another order: in
// each group of 16 columns, k8 slice 2j + s reads columns 16j + 4t + 2s
// and + 1 as its fragment columns t and t + 4, the same for Q and K, so
// one 16-byte read of a row gives a thread both slices' fragment values.
// Q's A fragments are split once a slice and reused across the n8 blocks.
// The cross products go to their own accumulators (more independent
// chains for the tensor pipe), added at the end.
template <int D>
__device__ __forceinline__ void f32_scores(float (&s)[4 * Tile<D>::kNb],
                                           const float* qs, const float* ks,
                                           int r0, int g, int t) {
  using L = Tile<D>;
  float lo[4 * L::kNb];
#pragma unroll
  for (int x = 0; x < 4 * L::kNb; ++x) s[x] = lo[x] = 0.0f;
  const float* qa = qs + r0 * L::kQKStride + 4 * t;
  const float* kb = ks + g * L::kQKStride + 4 * t;
#pragma unroll 2
  for (int d0 = 0; d0 < D; d0 += 16) {
    const float4 qr = *reinterpret_cast<const float4*>(qa + d0);
    const float4 qr8 = *reinterpret_cast<const float4*>(
        qa + 8 * L::kQKStride + d0);
    uint32_t ab[2][4], as[2][4];
    split_tf32(qr.x, ab[0][0], as[0][0]);
    split_tf32(qr8.x, ab[0][1], as[0][1]);
    split_tf32(qr.y, ab[0][2], as[0][2]);
    split_tf32(qr8.y, ab[0][3], as[0][3]);
    split_tf32(qr.z, ab[1][0], as[1][0]);
    split_tf32(qr8.z, ab[1][1], as[1][1]);
    split_tf32(qr.w, ab[1][2], as[1][2]);
    split_tf32(qr8.w, ab[1][3], as[1][3]);
#pragma unroll
    for (int nb = 0; nb < L::kNb; ++nb) {
      const float4 kv = *reinterpret_cast<const float4*>(
          kb + 8 * nb * L::kQKStride + d0);
      mma_split(s + 4 * nb, lo + 4 * nb, ab[0], as[0], {kv.x, kv.y});
      mma_split(s + 4 * nb, lo + 4 * nb, ab[1], as[1], {kv.z, kv.w});
    }
  }
#pragma unroll
  for (int x = 0; x < 4 * L::kNb; ++x) s[x] += lo[x];
}

// O += P V for this warp's rows, in split TF32 (P split too).  P needs no
// re-layout: within each k8 slice of keys the A fragment's column c is
// read as key 2 (c % 4) + c / 4, so a thread's A values are its own
// accumulator columns {2t, 2t + 1} (a0..a3 = p0, p2, p1, p3), and V's B
// fragment reads the same keys, rows 2t and 2t + 1 of the slice.  The
// sum over keys is the same in any order.  The output columns are
// permuted too: n8 block ob's column n is output column
// 32 (ob / 4) + 4 n + ob % 4, so one 16-byte read of a V row gives a
// thread its B values for four n8 blocks (the epilogue undoes it).
template <int D>
__device__ __forceinline__ void f32_pv(float (&o)[4 * Tile<D>::kOb],
                                       const float (&pr)[4 * Tile<D>::kNb],
                                       const float* vs, int g, int t) {
  using L = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < L::kNb; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(pr[4 * kk], ab[0], as[0]);
    split_tf32(pr[4 * kk + 2], ab[1], as[1]);
    split_tf32(pr[4 * kk + 1], ab[2], as[2]);
    split_tf32(pr[4 * kk + 3], ab[3], as[3]);
    const float* vb = vs + (8 * kk + 2 * t) * L::kVStride + 4 * g;
#pragma unroll
    for (int m = 0; m < D / 32; ++m) {
      const float4 r0 = *reinterpret_cast<const float4*>(vb + 32 * m);
      const float4 r1 = *reinterpret_cast<const float4*>(
          vb + L::kVStride + 32 * m);
      const float v0[4] = {r0.x, r0.y, r0.z, r0.w};
      const float v1[4] = {r1.x, r1.y, r1.z, r1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* c = o + 4 * (4 * m + j);
        mma_split(c, c, ab, as, {v0[j], v1[j]});
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_kernel(const Params p) {
  using L = Tile<D>;
  constexpr int BK = L::kBlockK;
  extern __shared__ __align__(16) float smem[];
  const float* qs = smem;
  const float* kvs = smem + L::kQFloats;   // [stage][K, V]
  const uint32_t s_q =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t s_kv = s_q + 4 * L::kQFloats;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = 16 * warp + g;          // this thread's rows r0, r0 + 8
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int q_first = q0 + p.tk - p.tq;  // absolute position of row 0
  const int q_last = min(q0 + kBlockQ, p.tq) - 1 + p.tk - p.tq;

  // the KV tiles this q tile needs: [k_lo, k_hi)
  const int k_hi = p.causal ? min(p.tk, q_last + 1) : p.tk;
  int k_lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  k_lo = (k_lo / BK) * BK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb
                    + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb
                    + kvh * p.v_sh;
  if (n_tiles > 0) {
    stage_async<D>(s_q, L::kQKStride,
                   static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh,
                   p.q_st, q0, kBlockQ, p.tq, p.vec);
    stage_async<D>(s_kv, L::kQKStride, kg, p.k_st, k_lo, BK, p.tk, p.vec);
    stage_async<D>(s_kv + 4 * L::kKFloats, L::kVStride, vg, p.v_st, k_lo, BK,
                   p.tk, p.vec);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");

  float o[4 * L::kOb];
#pragma unroll
  for (int x = 0; x < 4 * L::kOb; ++x) o[x] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};                     // this thread's columns only

  for (int i = 0; i < n_tiles; ++i) {
    // tile i has landed for every thread, and every warp is done with
    // tile i - 1, whose stage the copy of tile i + 1 now overwrites
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    if (i + 1 < n_tiles) {
      const uint32_t dst = s_kv + 4 * ((i + 1) % 2) * L::kStageFloats;
      const int k1 = k_lo + (i + 1) * BK;
      stage_async<D>(dst, L::kQKStride, kg, p.k_st, k1, BK, p.tk, p.vec);
      stage_async<D>(dst + 4 * L::kKFloats, L::kVStride, vg, p.v_st, k1, BK,
                     p.tk, p.vec);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");

    const float* ks = kvs + (i % 2) * L::kStageFloats;
    float sc[4 * L::kNb];
    f32_scores<D>(sc, qs, ks, r0, g, t);
    const int k0 = k_lo + i * BK;
    float alpha[2];
    if (tile_crosses_band(k0, BK, p.tk, p.causal, p.window, q_first, q_last))
      online_softmax<true>(sc, m, l, alpha, p, k0, q_first, r0, 2 * t);
    else
      online_softmax<false>(sc, m, l, alpha, p, k0, q_first, r0, 2 * t);
#pragma unroll
    for (int x = 0; x < 4 * L::kOb; ++x) o[x] *= alpha[(x / 2) % 2];
    f32_pv<D>(o, sc, ks + L::kKFloats, g, t);
  }

  // o = O / l (a row masked everywhere has l == 0 and gives zeros); the
  // thread's columns of n8 blocks 4m .. 4m + 3 are output columns
  // 32 m + 8 t .. 32 m + 8 t + 7 (see f32_pv)
  float* og = static_cast<float*>(p.o)
              + ((long long)b * p.hq + h) * p.tq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.0f / (sum == 0.0f ? 1.0f : sum);
    const int row = q0 + r0 + 8 * r;
    if (row >= p.tq) continue;
#pragma unroll
    for (int mm = 0; mm < D / 32; ++mm) {
      float* dst = og + (long long)row * D + 32 * mm + 8 * t;
      const float* c = o + 16 * mm + 2 * r;   // n8 block 4 mm + j: c[4 j]
      *reinterpret_cast<float4*>(dst) =
          make_float4(c[0] * inv, c[4] * inv, c[8] * inv, c[12] * inv);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(c[1] * inv, c[5] * inv, c[9] * inv, c[13] * inv);
    }
  }
}

template <int D>
int launch_f32(const Params& p, int b, cudaStream_t stream) {
  constexpr int bytes = Tile<D>::kSmemBytes;
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.tq + kBlockQ - 1) / kBlockQ, p.hq, b);
  kernel<<<grid, kF32Threads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// --- bf16: tensor cores (wgmma), TMA ---------------------------------------

constexpr int kConsumers = 128;              // one warpgroup
constexpr int kWgThreads = kConsumers + 32;  // and one producer warp
constexpr int kBlockKV = 64;                 // KV rows per tile
constexpr int kStages = 2;                   // K/V ring depth

struct WgParams {
  __nv_bfloat16* o;                // [B, Hq, Tq, D], contiguous
  int hq, hkv, tq, tk;
  int causal;
  int window;                      // <= 0: no window
  float scale_log2;                // scale * log2(e)
};

template <int D>
struct WgTile {
  static constexpr int kChunk = D < 64 ? D : 64;      // columns per TMA box
  static constexpr int kChunks = D / kChunk;
  static constexpr int kRowBytes = 2 * kChunk;        // = the swizzle span
  static constexpr int kChunkBytes = 64 * kRowBytes;  // one box of 64 rows
  static constexpr int kTileBytes = kChunks * kChunkBytes;
  static constexpr int kBarOffset = (1 + 2 * kStages) * kTileBytes;
  // 1,024 bytes of slack align the tiles to the swizzle atom
  static constexpr int kSmemBytes =
      1024 + kBarOffset + 8 * (4 * kStages + 1);
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // 128B, 64B
  static_assert(kBlockQ == 64 && kBlockKV == 64, "64-row tiles");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// Spins until the phase of `parity` has completed; a wait of some 2^26
// polls (seconds; a tile takes microseconds) traps rather than hang the
// card on a copy that never lands.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of the 4-D map (D, T, H, B) at element coordinates (c0..c3)
// into shared memory at `dst`; completion is counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16
         | static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32
         | layout << 62;
}

// K-major operand (Q or K, rows of D): 8-row groups kRowBytes x 8 apart.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  using L = WgTile<D>;
  return smem_desc(addr, 16, 8 * L::kRowBytes, L::kLayout);
}

// MN-major B operand (V read as [kv rows][D], transposed): one
// instruction covers one swizzle atom of columns, so only the stride
// between 8-row groups along K counts; both offsets are set to it.
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  using L = WgTile<D>;
  return smem_desc(addr, 8 * L::kRowBytes, 8 * L::kRowBytes, L::kLayout);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads of an accumulator above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WG_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(d, i) WG_F4(d, i), WG_F4(d, i + 4), WG_F4(d, i + 8), \
                     WG_F4(d, i + 12)

// d[64 x 64] += A[64 x 16] B[16 x 64], both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F16(d, 0), WG_F16(d, 16)
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x N] += A[64 x 16] (registers) B[16 x N] (shared memory, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F16(d, 0), WG_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_F16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_F16
#undef WG_F4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of m64nN (per thread, warp w, lane): element 4 j + e
// is row 16 w + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2.

// Starts S = Q K^T (64 x 64) for the K tile at shared address `ks`.
template <int D>
__device__ __forceinline__ void mma_scores(float (&sc)[32], uint32_t s_q,
                                             uint32_t ks) {
  using L = WgTile<D>;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const uint32_t off = (16 * kd / L::kChunk) * L::kChunkBytes
                         + (16 * kd % L::kChunk) * 2;
    wgmma_ss_n64(sc, kmajor_desc<D>(s_q + off), kmajor_desc<D>(ks + off));
  }
}

// Starts O += P V for the V tile at shared address `vs`, P in registers.
template <int D>
__device__ __forceinline__ void mma_pv(
    float (&o)[WgTile<D>::kChunks][WgTile<D>::kChunk / 2],
    const uint32_t (&pa)[4][4], uint32_t vs) {
  using L = WgTile<D>;
#pragma unroll
  for (int kk = 0; kk < kBlockKV / 16; ++kk)
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
      wgmma_rs(o[c], pa[kk], mnmajor_desc<D>(vs + c * L::kChunkBytes
                                             + 16 * kk * L::kRowBytes));
}

// p in bf16 as the A fragments of four k16 slices: element x goes to
// slice x / 8, register 2 ((x / 4) % 2) + (x / 2) % 2.
__device__ __forceinline__ void pack_p(const float (&sc)[32],
                                       uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int x = 0; x < 32; x += 2)
    pa[x / 8][2 * ((x / 4) % 2) + (x / 2) % 2] = pack_bf16(sc[x], sc[x + 1]);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const WgParams p) {
  using L = WgTile<D>;
  extern __shared__ uint8_t smem_raw[];
  // shared addresses: Q, K stages, V stages, then the barriers
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t s_q = (raw + 1023u) & ~1023u;
  const uint32_t s_k = s_q + L::kTileBytes;
  const uint32_t s_v = s_k + kStages * L::kTileBytes;
  const uint32_t bars = s_q + L::kBarOffset;     // [kStages] each:
  const uint32_t full_k = bars;                  // K tile landed
  const uint32_t full_v = bars + 8 * kStages;    // V tile landed
  const uint32_t empty_k = bars + 16 * kStages;  // K tile consumed
  const uint32_t empty_v = bars + 24 * kStages;  // V tile consumed
  const uint32_t q_full = bars + 32 * kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.hq / p.hkv);
  const int q_first = q0 + p.tk - p.tq;          // absolute position of row 0
  const int q_last = min(q0 + kBlockQ, p.tq) - 1 + p.tk - p.tq;

  // the KV tiles this q tile needs: [k_lo, k_hi)
  const int k_hi = p.causal ? min(p.tk, q_last + 1) : p.tk;
  int k_lo = p.window > 0 ? max(0, q_first - p.window + 1) : 0;
  k_lo = (k_lo / kBlockKV) * kBlockKV;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBlockKV - 1) / kBlockKV
                                  : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumers);
      mbar_init(empty_v + 8 * s, kConsumers);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {               // the producer warp
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      mbar_expect_tx(q_full, L::kTileBytes);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(s_q + c * L::kChunkBytes, &tm_q, q_full, c * L::kChunk, q0,
                 h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t parity = (i / kStages - 1) & 1;
        const int k0 = k_lo + i * kBlockKV;
        if (i >= kStages) mbar_wait(empty_k + 8 * s, parity);
        mbar_expect_tx(full_k + 8 * s, L::kTileBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(s_k + s * L::kTileBytes + c * L::kChunkBytes, &tm_k,
                   full_k + 8 * s, c * L::kChunk, k0, kvh, b);
        if (i >= kStages) mbar_wait(empty_v + 8 * s, parity);
        mbar_expect_tx(full_v + 8 * s, L::kTileBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(s_v + s * L::kTileBytes + c * L::kChunkBytes, &tm_v,
                   full_v + 8 * s, c * L::kChunk, k0, kvh, b);
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's rows r0 and r0 + 8 of the tile
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4;
  const int c0 = 2 * (lane % 4);
  float o[L::kChunks][L::kChunk / 2];
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
    for (int x = 0; x < L::kChunk / 2; ++x) o[c][x] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};                     // this thread's columns only

  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    float sc[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = 0.0f;
    mbar_wait(full_k + 8 * s, parity);
    wgmma_fence();
    mma_scores<D>(sc, s_q, s_k + s * L::kTileBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    mbar_arrive(empty_k + 8 * s);
    const int k0 = k_lo + i * kBlockKV;
    float alpha[2];
    if (tile_crosses_band(k0, kBlockKV, p.tk, p.causal, p.window, q_first,
                          q_last))
      online_softmax<true>(sc, m, l, alpha, p, k0, q_first, r0, c0);
    else
      online_softmax<false>(sc, m, l, alpha, p, k0, q_first, r0, c0);
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
      for (int x = 0; x < L::kChunk / 2; ++x) o[c][x] *= alpha[(x / 2) % 2];
    uint32_t pa[4][4];
    pack_p(sc, pa);
    mbar_wait(full_v + 8 * s, parity);
    wgmma_fence();
    mma_pv<D>(o, pa, s_v + s * L::kTileBytes);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) fence_regs(o[c]);
    mbar_arrive(empty_v + 8 * s);
  }

  // o = O / l (a row masked everywhere has l == 0 and gives zeros)
  __nv_bfloat16* og = p.o + ((long long)b * p.hq + h) * p.tq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.0f / (sum == 0.0f ? 1.0f : sum);
    const int row = q0 + r0 + 8 * r;
    if (row >= p.tq) continue;
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
      for (int j = 0; j < L::kChunk / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            og + (long long)row * D + c * L::kChunk + 8 * j + c0) =
            __floats2bfloat162_rn(o[c][4 * j + 2 * r] * inv,
                                  o[c][4 * j + 2 * r + 1] * inv);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// The 4-D map (D, T, H, B) of one bf16 operand, boxes of 64 rows x one
// swizzle span of columns.  Strides are in elements.
template <int D>
bool encode_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int t,
                int h, int b, long long st, long long sh, long long sb) {
  using L = WgTile<D>;
  const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(2 * st),
                                 static_cast<cuuint64_t>(2 * sh),
                                 static_cast<cuuint64_t>(2 * sb)};
  const cuuint32_t box[4] = {L::kChunk, 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const Params& p, int b, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kNoEncoder;
  // an empty K/V is never read: q stands in for its maps
  const bool kv = p.tk > 0;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_map<D>(enc, &tm_q, p.q, p.tq, p.hq, b, p.q_st, p.q_sh, p.q_sb)
      || !encode_map<D>(enc, &tm_k, kv ? p.k : p.q, kv ? p.tk : p.tq,
                        kv ? p.hkv : p.hq, b, kv ? p.k_st : p.q_st,
                        kv ? p.k_sh : p.q_sh, kv ? p.k_sb : p.q_sb)
      || !encode_map<D>(enc, &tm_v, kv ? p.v : p.q, kv ? p.tk : p.tq,
                        kv ? p.hkv : p.hq, b, kv ? p.v_st : p.q_st,
                        kv ? p.v_sh : p.q_sh, kv ? p.v_sb : p.q_sb))
    return kBadTensorMap;
  const WgParams wp{static_cast<__nv_bfloat16*>(p.o), p.hq, p.hkv, p.tq,
                    p.tk, p.causal, p.window, p.scale_log2};
  constexpr int bytes = WgTile<D>::kSmemBytes;
  auto kernel = flash_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.tq + kBlockQ - 1) / kBlockQ, p.hq, b);
  kernel<<<grid, kWgThreads, bytes, stream>>>(tm_q, tm_k, tm_v, wp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block at head_dim d and dtype (0: f32,
// 1: bf16); 0: not supported.
long long flash_attn_smem_bytes(int d, int dtype) {
  const bool bf16 = dtype == 1;
  switch (d) {
    case 32: return bf16 ? WgTile<32>::kSmemBytes : Tile<32>::kSmemBytes;
    case 64: return bf16 ? WgTile<64>::kSmemBytes : Tile<64>::kSmemBytes;
    case 128: return bf16 ? WgTile<128>::kSmemBytes : Tile<128>::kSmemBytes;
    case 256: return bf16 ? WgTile<256>::kSmemBytes : Tile<256>::kSmemBytes;
    default: return 0;
  }
}

// o[B, Hq, Tq, D] (contiguous) from q, k, v with element strides of
// batch, head and row (the last dimension contiguous; bf16: a 16-byte
// aligned base and strides of whole 16 bytes, as TMA reads them).
// dtype 0: f32 (flash_fwd_kernel), 1: bf16 (flash_wgmma_kernel).
// Returns 0, a cudaError_t, or a negative code for arguments the kernel
// does not take.
int flash_attn_forward(const void* q, const void* k, const void* v, void* o,
                       long long q_sb, long long q_sh, long long q_st,
                       long long k_sb, long long k_sh, long long k_st,
                       long long v_sb, long long v_sh, long long v_st,
                       int b, int hq, int hkv, int tq, int tk, int d,
                       int causal, int window, int dtype, float scale,
                       void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || tq < 1 || tk < 0)
    return kBadArgs;
  // cp.async copies f32 tiles 16 bytes at a time where every base and
  // row, head and batch stride is a whole 16 bytes
  const auto on16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const bool vec = on16(q) && on16(k) && on16(v)
                   && (q_sb | q_sh | q_st | k_sb | k_sh | k_st | v_sb | v_sh
                       | v_st) % 4 == 0;
  const Params p{q, k, v, o, q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                 v_sb, v_sh, v_st, hq, hkv, tq, tk, causal, window,
                 scale * kLog2e, vec ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (d) {
      case 32: return launch_f32<32>(p, b, s);
      case 64: return launch_f32<64>(p, b, s);
      case 128: return launch_f32<128>(p, b, s);
      case 256: return launch_f32<256>(p, b, s);
      default: return kBadHeadDim;
    }
  }
  if (dtype == 1) {
    switch (d) {
      case 32: return launch_bf16<32>(p, b, s);
      case 64: return launch_bf16<64>(p, b, s);
      case 128: return launch_bf16<128>(p, b, s);
      case 256: return launch_bf16<256>(p, b, s);
      default: return kBadHeadDim;
    }
  }
  return kBadArgs;
}

const char* flash_attn_error_string(int code) {
  if (code == kBadArgs) return "arguments the kernel does not take";
  if (code == kBadHeadDim) return "head_dim not one of 32, 64, 128, 256";
  if (code == kNoEncoder)
    return "CUDA offers no cuTensorMapEncodeTiled entry point";
  if (code == kBadTensorMap)
    return "cuTensorMapEncodeTiled refused a q, k or v tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
