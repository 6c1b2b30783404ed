// Fused causal (or full) self-attention, forward and backward, for Hopper
// (built with -gencode arch=compute_90a,code=sm_90a into one library for
// each variant and causal flag: -DATTN_HEAD_DIM=64|128 with v as wide as
// q and k, or -DATTN_HEAD_DIM=192 -DATTN_V_DIM=128 for multi-head latent
// attention (q and k 192 wide, v and the output 128); -DATTN_CAUSAL=0|1).
//
// Replaces no TPU kernel: the reference computes attention with XLA
// (`repro.models.layers.chunked_attention`, jitted).  The port ran the same
// online softmax as a Python loop of PyTorch ops over fp32 score tiles
// (`repro_torch.models.layers.chunked_attention`): at olmo-1b's training
// shape (2 x 2048 x 16 heads x 128) each query chunk materialised a
// (2, 16, 1024, 2048) fp32 tile in device memory and passed over it about
// ten times, in the forward, again in remat's recompute and in autograd's
// backward: about 400 ms of an 850 ms step.  Here the tiles never leave
// the SM.
//
// What bounds it on the card: operations.  A causal forward at that shape
// is 4 * B * H * S^2 * D / 2 = 3.4e10 FLOPs (QK^T and PV over the lower
// triangle) against 8 * B * S * H * D = 3.4e7 bytes read and written.  The
// backward's four products dP, dV, dK and dQ take TF32 operands (below), so
// they are bound by the TF32 rate, 495e12 a second, half the bf16 one: at
// OLMoE's shape (2 x 4,096 x 16 x 128, causal) 2.7e11 FLOPs, 0.56 ms, and
// the recomputed S (bf16) and dP (TF32) of the dQ pass besides.
//
// The arithmetic is the plain version's, operand for operand (the rule:
// no operand is rounded to fewer bits than that graph rounds it):
//   * S = Q K^T from bf16 q, k with fp32 accumulation (the plain version's
//     TF32 product of bf16 values, which TF32 holds exactly), then s *
//     scale in fp32 (the caller's scale, as an fp32 value; 1/sqrt(D) where
//     the plain version is given none); masked scores are -1e30 (its
//     `_MASK`), keys past the sequence are excluded;
//   * the running max, exp, the running sum and the final division stay
//     in fp32 (expf, IEEE division); p is rounded to bf16 (RNE) for the
//     value product, with fp32 accumulation;
//   * the forward keeps, per row, the final max m and sum l, and (when a
//     gradient is wanted) the fp32 output o / max(l, 1e-30) before its
//     cast to bf16;
//   * the backward recomputes p = exp(s * scale - m) tile by tile in fp32
//     and follows autograd's graph of the plain version: g = dO (bf16
//     values), dO' = g / l rounded to TF32 (the operand the plain version's
//     TF32 product rounds), dl = -sum(g * o32) / l, dP = dO' V^T, rounded
//     to bf16 (the backward of p's cast to bf16), dS = (bf16(dP) + dl) * p
//     * scale rounded to TF32, dV += bf16(p)^T dO', dK += dS^T Q, dQ += dS
//     K, each product exact in fp32 and accumulated in fp32; dQ, dK and dV
//     are rounded to bf16 once, at the end.  (The plain version also sends
//     a sum of dS through amax to the row's argmax score; that sum is zero
//     but for rounding, and is left out.)
//
// Design of the forward (FlashAttention-2's scheme on mma.sync):
//   * Tiles of 64 rows, 4 warps a block, 16 rows a warp; rows in shared
//     memory are padded by 16 bytes, so the fragment loads hit 32 distinct
//     banks.  A block owns a query tile of one (batch, head); Q fragments
//     stay in registers, K / V tiles stream through a double buffer of
//     cp.async; the running max, sum and accumulator stay in registers.
//     The score accumulators become the value product's A fragments in
//     registers.
//   * `attn_bounds` writes the smallest and largest position of each
//     64-row tile (positions need not be arange).  A (query tile, key tile)
//     pair is skipped when the key tile's smallest position exceeds the
//     query tile's largest (causal only), and masked element by element
//     (q_pos >= kv_pos) only when the key tile's largest position exceeds
//     the query tile's smallest, or a tile runs past the sequence (rows
//     past it are zero-filled and never stored).  The backward applies the
//     same rule with the same records.
//   * GQA: query head h reads KV head h / G.  Two widths: D (q, k; QK^T,
//     dK, dQ) and DV (v, the output, dO; PV, dP, dV), each product at its
//     own width, none padded.  Heavy blocks first: causal query tiles run
//     from the last.  Offsets are 64-bit.
//
// Design of the backward (Hopper's warpgroup products, fed by TMA):
//   * `attn_bwd_prep` (one warp a row) makes dl and dO', and stores dO' as
//     two bf16 arrays in the scratch the caller gives for it: hi = dO' with
//     its low 16 bits cleared (a bf16 value) and lo = dO' - hi.  A TF32
//     value has 11 significant bits, hi the top 8, so lo has at most 3 and
//     is exact in bf16 (but for subnormal parts).  In the tile kernels dS
//     is split the same way in registers.  So each TF32 product x . b runs
//     as two bf16 products, hi . b + lo . b: each bf16 x bf16 product is
//     exact in fp32, as the TF32 one is, and only the order of the fp32
//     accumulation differs.  The pair costs what one TF32 product costs
//     (bf16 at twice the TF32 rate), and bf16 `wgmma` takes MN-major
//     (transposed) operands from shared memory, which TF32 `wgmma` does
//     not: dV's dO', dK's Q and dQ's K are read as they lie.  bf16(p),
//     and q, k and v, are bf16 already and run once.
//   * Two kernels, each block three warpgroups: a producer (one warp issues
//     TMA loads and copies each row's m, dl and position) and two
//     consumers that run `wgmma` (m64nNk16, bf16, fp32 accumulators) on the
//     tiles that have arrived.  `setmaxnreg` moves registers within the
//     block's own pool (384 threads x 168 at launch): the producer drops to
//     24, each consumer rises to 240.  Tiles come through a ring of two
//     shared-memory stages, each with a full and an empty `mbarrier`; q,
//     k, v and the dO' halves are read as 4-d tensors (width, heads, S, B)
//     in boxes of 64 columns (128 bytes, 128-byte swizzle) by rows, so a
//     tile past the sequence is zero-filled by the copy and a head or batch
//     never bleeds into the next.  Every operand of every product is read
//     from those swizzled tiles or from registers (an accumulator becomes
//     the next product's A fragment): nothing is staged by hand.
//   * `attn_bwd_kv`: a block owns BC = 128 keys of one (batch, KV head), K
//     and V resident, each consumer 64 of them, and walks the G query
//     heads' query steps of BQ rows twice.  The dK walk: S^T = K Q^T and
//     dP^T = V dO'^T (keys as rows, from shared memory); p and dS^T stay in
//     registers, where dS^T is the A fragment of dK += dS^T Q.  The dV
//     walk: S^T again, and bf16(p)^T the A fragment of dV += bf16(p)^T dO'.
//     One walk holding dK and dV together (128 accumulator registers at D
//     = 128, 160 at 192) beside the step's tiles spilled past 240
//     registers; two walks cost one more S^T product (8 bf16 products a
//     step where one walk takes 7) and spill nothing.
//   * `attn_bwd_q`: a block owns BR = 128 queries of one (batch, head),
//     with Q and the dO' halves resident, each consumer 64 of them; it
//     walks the key steps of BK rows, recomputing S and dP, and dQ += dS K
//     accumulates in registers.  Nothing is reduced across blocks: no
//     atomics, and the result does not depend on the schedule.
//   * Tiles by variant, from the compile-time widths: BQ = BK = 64 at D <=
//     128, 32 at D = 192, where dK's 96 accumulator registers beside 64-wide
//     score and dP tiles spilled.  Within a step S and dP are issued
//     together, and p is computed while dP runs.  The blocks of either
//     kernel are issued with the heaviest first where causal (the first
//     key blocks, the last query blocks).
//   * What bounds it: the TF32 products at 495e12 (the bf16 pairs at
//     989e12).  A causal call at OLMoE's shape is 8 bf16 products of
//     B H S^2 D / 2 multiply-adds in `attn_bwd_kv` and 5 in `attn_bwd_q`,
//     0.90 ms at the bf16 peak; the two kernels read about a third of that
//     peak (NVIDIA H100), held back by the products that read both
//     operands from shared memory (128 bytes a cycle at m64n64k16) and by
//     each warpgroup's wait for its own products between the softmax and
//     dS steps.
//
// Plain C interface (ctypes): every entry point returns cudaGetLastError()
// after its launches (or the error that kept it from launching); nothing
// synchronises or allocates.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

#ifndef ATTN_HEAD_DIM
#error "build with -DATTN_HEAD_DIM=64, 128 or 192"
#endif
#ifndef ATTN_V_DIM
#define ATTN_V_DIM ATTN_HEAD_DIM
#endif
#ifndef ATTN_CAUSAL
#error "build with -DATTN_CAUSAL=0 or 1"
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = ATTN_HEAD_DIM;    // q and k
constexpr int DV = ATTN_V_DIM;      // v, the output and its gradient
constexpr bool CAUSAL = ATTN_CAUSAL != 0;
static_assert(((D == 64 || D == 128) && DV == D) || (D == 192 && DV == 128),
              "head dimensions 64 or 128, or 192 with v at 128");
constexpr int TILE = 64;            // rows of a forward tile and of a bound
constexpr int WARPS = 4;            // 16 rows a warp
constexpr int THREADS = 32 * WARPS;
constexpr int LDB = D + 8;          // bf16 q and k row stride in shared memory
constexpr int LDV = DV + 8;         // bf16 v rows
constexpr int PREP_WARPS = 8;
constexpr float MASK = -1e30f;      // the plain version's _MASK
constexpr float MIN_SUM = 1e-30f;   // its clamp of the sum

constexpr int FWD_SMEM = 3 * TILE * LDB * 2 + 2 * TILE * LDV * 2 + 2 * TILE * 4;

// the backward's tile kernels
constexpr int BWD_WG = 2;                        // consumer warpgroups a block
constexpr int BWD_THREADS = 128 * (BWD_WG + 1);  // and a producer warpgroup
// registers a thread at launch (ptxas's count under __launch_bounds__(
// BWD_THREADS, 1)), and after `setmaxnreg`: the roles trade within the
// block's own pool
constexpr int LAUNCH_REGS = (65536 / BWD_THREADS) & ~7;
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
static_assert(BWD_WG * 128 * CONSUMER_REGS + 128 * PRODUCER_REGS <=
                  BWD_THREADS * LAUNCH_REGS,
              "the block's register pool");
constexpr int PD = D / 64, PV = DV / 64;  // 128-byte panels of a q/k, v/dO' row
constexpr int BC = 64 * BWD_WG;           // keys a block of attn_bwd_kv
constexpr int BQ = D > 128 ? 32 : 64;     // queries a step of attn_bwd_kv
constexpr int KV_STAGES = 2;

constexpr int BR = 64 * BWD_WG;           // queries a block of attn_bwd_q
constexpr int BK = D > 128 ? 32 : 64;     // keys a step of attn_bwd_q
constexpr int Q_STAGES = 2;
constexpr int KV_KTILE = PD * BC * 128, KV_VTILE = PV * BC * 128;
constexpr int KV_QSTAGE = PD * BQ * 128, KV_OSTAGE = PV * BQ * 128;
constexpr int KV_STAGE = KV_QSTAGE + 2 * KV_OSTAGE;  // bytes a stage's copies
constexpr int KV_SMEM = 1024 + KV_KTILE + KV_VTILE +
                        KV_STAGES * (KV_STAGE + 3 * BQ * 4) +
                        8 * (2 * KV_STAGES + 1);
constexpr int Q_QTILE = PD * BR * 128, Q_OTILE = PV * BR * 128;
constexpr int Q_KSTAGE = PD * BK * 128, Q_VSTAGE = PV * BK * 128;
constexpr int Q_STAGE = Q_KSTAGE + Q_VSTAGE;
constexpr int Q_SMEM = 1024 + Q_QTILE + 2 * Q_OTILE +
                       Q_STAGES * (Q_STAGE + BK * 4) + 8 * (2 * Q_STAGES + 1);
static_assert(KV_SMEM <= 232448 && Q_SMEM <= 232448,
              "a block's shared memory");
static_assert(BC % BK == 0 && BR % BQ == 0 && TILE % BQ == 0 &&
                  TILE % BK == 0,
              "whole boxes a tile");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// fp32 rounded to TF32 (nearest), as bits
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 64 rows of W bf16 values (row stride `stride` elements) starting at row
// `row0`, into shared memory rows of LD; rows at or past S are zero-filled
template <int W, int LD>
__device__ __forceinline__ void load_bf16(bf16* dst, const bf16* src,
                                          size_t stride, int row0, int S,
                                          int tid) {
  constexpr int CH = W / 8;
  static_assert(TILE * CH % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < TILE * CH / THREADS; ++it) {
    const int x = tid + it * THREADS;
    const int r = x / CH, c = x % CH, row = row0 + r;
    const bool ok = row < S;
    cp16(dst + r * LD + c * 8, src + (ok ? row : 0) * stride + c * 8, ok);
  }
}

// 64 consecutive 4-byte values from `src` (element stride `step`) starting
// at row0; past S zero-filled.  Threads 0..63.
__device__ __forceinline__ void load_rows4(void* dst, const void* src,
                                           int step, int row0, int S,
                                           int tid) {
  if (tid < TILE) {
    const int row = row0 + tid;
    const bool ok = row < S;
    cp4(static_cast<int*>(dst) + tid,
        static_cast<const int*>(src) + (size_t)(ok ? row : 0) * step, ok);
  }
}

struct Args {
  const bf16* q;       // (B, S, H, D)
  const bf16* k;       // (B, S, KV, D)
  const bf16* v;       // (B, S, KV, DV)
  const int* pos;      // (S,)
  const int* bounds;   // (ntiles, 2): smallest and largest position
  bf16* o;             // (B, S, H, DV)
  float* o32;          // (B, S, H, DV), or null
  float2* stats;       // (B, H, S): the row's max and sum
  const bf16* dout;    // (B, S, H, DV)
  bf16* dohi;          // (B, S, H, DV): dO' = tf32(g / l), its high half
  bf16* dolo;          // and the rest
  float* dl;           // (B, H, S)
  bf16* dq;            // as q
  bf16* dk;            // as k
  bf16* dv;            // as v
  int B, S, H, KV;
  float scale;
};

__global__ void attn_bounds(const int* __restrict__ pos, int S, int ntiles,
                            int* __restrict__ bounds) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * WARPS + warp;
  if (tile >= ntiles) return;
  int lo = 0x7fffffff, hi = -0x7fffffff - 1;
  for (int r = lane; r < TILE; r += 32) {
    const int x = tile * TILE + r;
    if (x < S) {
      lo = min(lo, pos[x]);
      hi = max(hi, pos[x]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    bounds[2 * tile] = lo;
    bounds[2 * tile + 1] = hi;
  }
}

__global__ void __launch_bounds__(THREADS) attn_fwd(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TILE * LDB;          // 2 buffers
  bf16* Vs = Ks + 2 * TILE * LDB;      // 2 buffers
  int* kps = reinterpret_cast<int*>(Vs + 2 * TILE * LDV);   // 2 buffers
  int* bnd = kps + 2 * TILE;
  const int S = p.S, ntiles = (S + TILE - 1) / TILE;
  const int i = CAUSAL ? ntiles - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qstride = (size_t)p.H * D, kvstride = (size_t)p.KV * D;
  const size_t vstride = (size_t)p.KV * DV, ostride = (size_t)p.H * DV;
  const bf16* qb = p.q + (size_t)b * S * qstride + (size_t)h * D;
  const bf16* kb = p.k + (size_t)b * S * kvstride + (size_t)kvh * D;
  const bf16* vb = p.v + (size_t)b * S * vstride + (size_t)kvh * DV;

  for (int x = tid; x < 2 * ntiles; x += THREADS) bnd[x] = p.bounds[x];
  load_bf16<D, LDB>(Qs, qb, qstride, i * TILE, S, tid);
  cp_commit();
  __syncthreads();
  const int qmin = bnd[2 * i], qmax = bnd[2 * i + 1];
  auto next = [&](int j) {
    while (CAUSAL && j < ntiles && bnd[2 * j] > qmax) ++j;
    return j;
  };
  auto load_kv = [&](int j, int buf) {
    load_bf16<D, LDB>(Ks + buf * TILE * LDB, kb, kvstride, j * TILE, S, tid);
    load_bf16<DV, LDV>(Vs + buf * TILE * LDV, vb, vstride, j * TILE, S, tid);
    load_rows4(kps + buf * TILE, p.pos, 1, j * TILE, S, tid);
  };
  int j = next(0);
  if (j < ntiles) load_kv(j, 0);
  cp_commit();

  const int r0 = i * TILE + warp * 16 + g, r1 = r0 + 8;
  const int qp0 = r0 < S ? p.pos[r0] : 0, qp1 = r1 < S ? p.pos[r1] : 0;
  cp_wait<1>();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm4(qf[kk], Qs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDB +
                      kk * 16 + 8 * (lane >> 4));

  float o[DV / 8][4];
#pragma unroll
  for (int d = 0; d < DV / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = MASK, m1 = MASK, l0 = 0.f, l1 = 0.f;
  int buf = 0;
  while (j < ntiles) {
    const int jn = next(j + 1);
    if (jn < ntiles) load_kv(jn, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + buf * TILE * LDB;
    const bf16* Vt = Vs + buf * TILE * LDV;
    const int* kp = kps + buf * TILE;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm4(bk, Kt + (np * 16 + (lane & 7) + 8 * (lane >> 4)) * LDB +
                      kk * 16 + 8 * ((lane >> 3) & 1));
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }
    const bool mask = (j + 1) * TILE > S || (CAUSAL && bnd[2 * j + 1] > qmin);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v0 = __fmul_rn(s[n][e], p.scale);
        float v1 = __fmul_rn(s[n][2 + e], p.scale);
        if (mask) {
          const int c = n * 8 + 2 * t + e;
          if (j * TILE + c >= S) {
            v0 = v1 = -INFINITY;
          } else if (CAUSAL) {
            if (qp0 < kp[c]) v0 = MASK;
            if (qp1 < kp[c]) v1 = MASK;
          }
        }
        s[n][e] = v0;
        s[n][2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p00 = expf(s[n][0] - m0), p01 = expf(s[n][1] - m0);
      const float p10 = expf(s[n][2] - m1), p11 = expf(s[n][3] - m1);
      ps0 += p00 + p01;
      ps1 += p10 + p11;
      pa[n / 2][(n & 1) * 2] = pack_bf16(p00, p01);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p10, p11);
    }
    l0 = __fmul_rn(l0, c0) + ps0;
    l1 = __fmul_rn(l1, c1) + ps1;
#pragma unroll
    for (int d = 0; d < DV / 8; ++d) {
      o[d][0] *= c0;
      o[d][1] *= c0;
      o[d][2] *= c1;
      o[d][3] *= c1;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t bv[4];
        ldsm4t(bv, Vt + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDV +
                       dp * 16 + 8 * (lane >> 4));
        mma_bf16(o[2 * dp], pa[kk], bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();
    buf ^= 1;
    j = jn;
  }
  cp_wait<0>();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float d0 = fmaxf(l0, MIN_SUM), d1 = fmaxf(l1, MIN_SUM);
  const size_t row0 = ((size_t)b * S + r0) * ostride + (size_t)h * DV + 2 * t;
  const size_t row1 = row0 + 8 * ostride;
#pragma unroll
  for (int d = 0; d < DV / 8; ++d) {
    const float a0 = o[d][0] / d0, a1 = o[d][1] / d0;
    const float b0 = o[d][2] / d1, b1 = o[d][3] / d1;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(p.o + row0 + d * 8) = pack_bf16(a0, a1);
      if (p.o32) *reinterpret_cast<float2*>(p.o32 + row0 + d * 8) =
          make_float2(a0, a1);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(p.o + row1 + d * 8) = pack_bf16(b0, b1);
      if (p.o32) *reinterpret_cast<float2*>(p.o32 + row1 + d * 8) =
          make_float2(b0, b1);
    }
  }
  if (t == 0) {
    float2* st = p.stats + ((size_t)b * p.H + h) * S;
    if (r0 < S) st[r0] = make_float2(m0, l0);
    if (r1 < S) st[r1] = make_float2(m1, l1);
  }
}

// dO' = tf32(g / l), stored as its two bf16 halves (the value with its low
// 16 bits cleared, and the rest, which is exact in bf16), and dl = -sum(g *
// o32) / l; one warp a (b, s, h) row
__global__ void __launch_bounds__(32 * PREP_WARPS) attn_bwd_prep(const Args p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * PREP_WARPS + warp;
  if (row >= (size_t)p.B * p.S * p.H) return;
  const int h = (int)(row % p.H);
  const size_t bs = row / p.H;
  const int s = (int)(bs % p.S), b = (int)(bs / p.S);
  const size_t at = ((size_t)b * p.H + h) * p.S + s;
  const float l = fmaxf(p.stats[at].y, MIN_SUM);
  constexpr int E = DV / 32;
  const size_t base = row * DV + lane * E;
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float gv = __bfloat162float(p.dout[base + e]);
    acc += gv * p.o32[base + e];
    const uint32_t x = tf32(gv / l), hi = x & 0xffff0000u;
    const float lo = __uint_as_float(x) - __uint_as_float(hi);
    p.dohi[base + e] = __ushort_as_bfloat16((unsigned short)(hi >> 16));
    p.dolo[base + e] =
        __ushort_as_bfloat16((unsigned short)(__float_as_uint(lo) >> 16));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) p.dl[at] = -acc / l;
}

// -- the backward's tile kernels: TMA, mbarriers and wgmma ------------------

struct alignas(64) Maps {
  CUtensorMap q, k, v, hi, lo;  // (B, S, heads, width) bf16, 128-byte swizzle
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the phase of `parity` has completed.  A wait of more than
// about ten seconds can only be a broken pipeline: it traps, so the launch
// fails and the caller raises, instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    if (clock64() - start > (1ll << 34)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of `map` at (c0, c1, c2, c3) into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from reading or reusing a register that an issued
// wgmma still reads or writes: applied after the wait that ends it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// The operands of every product lie in 128-byte-swizzled tiles: rows of
// 128 bytes (64 bf16 columns, a panel), 8-row groups 1,024 bytes apart,
// each tile 1,024-byte aligned, as TMA's 128-byte swizzle writes them.  A
// wgmma descriptor of such a tile (`wgmma_*` below make theirs from a
// shared address): the address over 16, both byte offsets 1,024 (the
// stride of 8-row groups; the leading one is unused by a K-major operand
// and by an MN-major one 64 columns wide), 128-byte swizzle.  A K-major
// operand steps k by 16 (32 bytes) within a panel, then to the next panel;
// an MN-major one steps k by 16 rows (2,048 bytes).
__host__ __device__ constexpr int kstep(int kk, int panel) {
  return (kk >> 2) * panel + (kk & 3) * 32;
}

// d (64 x 32 fp32) = a . b (+ d where acc): a (64 x 16) and b (16 x 32)
// bf16 in shared memory, both K-major, at the shared addresses a + OA and
// b + OB (their descriptors made here, so the compiler keeps no copy of them)
template <int OA, int OB>
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint32_t a,
                                           uint32_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 x, y, h;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "add.u32 x, %16, %19;\nshr.u32 x, x, 4;\nor.b32 x, x, 0x400000;\n"
      "add.u32 y, %17, %20;\nshr.u32 y, y, 4;\nor.b32 y, y, 0x400000;\n"
      "mov.b32 h, 0x40000040;\nmov.b64 da, {x, h};\nmov.b64 db, {y, h};\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      " da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a), "r"(b), "r"(acc), "n"(OA), "n"(OB));
}

// d (64 x 64 fp32) = a . b (+ d where acc): a (64 x 16) and b (16 x 64)
// bf16 in shared memory, both K-major, at the shared addresses a + OA and
// b + OB (their descriptors made here, so the compiler keeps no copy of them)
template <int OA, int OB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint32_t a,
                                           uint32_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 x, y, h;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "add.u32 x, %32, %35;\nshr.u32 x, x, 4;\nor.b32 x, x, 0x400000;\n"
      "add.u32 y, %33, %36;\nshr.u32 y, y, 4;\nor.b32 y, y, 0x400000;\n"
      "mov.b32 h, 0x40000040;\nmov.b64 da, {x, h};\nmov.b64 db, {y, h};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      " da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a), "r"(b), "r"(acc), "n"(OA), "n"(OB));
}

// d (64 x 64 fp32) += a . b: a (64 x 16 bf16) in registers, b (16 x 64
// bf16) in shared memory, MN-major, at the shared address b + OB
template <int OB>
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 y, h;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "add.u32 y, %36, %37;\nshr.u32 y, y, 4;\nor.b32 y, y, 0x400000;\n"
      "mov.b32 h, 0x40000040;\nmov.b64 db, {y, h};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      " {%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "n"(OB), "r"(1));
}

template <int N, int OA, int OB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint32_t a,
                                         uint32_t b, int acc) {
  static_assert(N == 32 || N == 64, "n32 or n64");
  if constexpr (N == 32)
    wgmma_ss32<OA, OB>(d, a, b, acc);
  else
    wgmma_ss64<OA, OB>(d, a, b, acc);
}

// f(std::integral_constant<int, i>) for i = 0 .. N - 1, unrolled: the
// offsets of a product's steps are compile-time constants
template <typename F, int... I>
__device__ __forceinline__ void unroll_(F&& f,
                                        std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void unroll(F&& f) {
  unroll_(f, std::make_integer_sequence<int, N>{});
}

// A TF32 value (as bits) split into two bf16 values whose sum it is: the
// value with its low 16 bits cleared, and the rest (at most 3 significant
// bits, exact in bf16 but for subnormals).  Two such values are packed into
// the hi and lo bf16x2 registers of an A fragment, x0 in the low half.
__device__ __forceinline__ void split2(uint32_t x0, uint32_t x1, uint32_t& hi,
                                       uint32_t& lo) {
  const uint32_t h0 = x0 & 0xffff0000u, h1 = x1 & 0xffff0000u;
  const float l0 = __uint_as_float(x0) - __uint_as_float(h0);
  const float l1 = __uint_as_float(x1) - __uint_as_float(h1);
  hi = __byte_perm(x0, x1, 0x7632);
  lo = __byte_perm(__float_as_uint(l0), __float_as_uint(l1), 0x7632);
}

// dK and dV: a block owns BC keys of one (batch, KV head); each consumer
// warpgroup 64 of them.  The producer warp streams the G query heads' query
// steps (q, dO' halves, and each row's m, dl and position) through the
// ring twice, for the dK walk and the dV walk; skipped steps are skipped by
// both sides alike.
__global__ void __launch_bounds__(BWD_THREADS, 1)
    attn_bwd_kv(const __grid_constant__ Maps maps, const Args p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);
  unsigned char* Vs = Ks + KV_KTILE;
  unsigned char* stages = Vs + KV_VTILE;
  float* rows = reinterpret_cast<float*>(stages + KV_STAGES * KV_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + KV_STAGES * 3 * BQ);
  uint64_t* empty = full + KV_STAGES;
  uint64_t* kvbar = empty + KV_STAGES;

  const int S = p.S, G = p.H / p.KV, ntiles = (S + TILE - 1) / TILE;
  const int nq = (S + BQ - 1) / BQ;
  const int kvh = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * BC;
  const int* bnd = p.bounds;
  int kmin = 0x7fffffff;
  for (int t = j0 / TILE; t < min(j0 / TILE + BWD_WG, ntiles); ++t)
    kmin = min(kmin, __ldg(bnd + 2 * t));
  // every key of the block after every query of step i
  auto skip = [&](int i) {
    return CAUSAL && kmin > __ldg(bnd + 2 * ((i * BQ) / TILE) + 1);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 4 * BWD_WG);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup and warp as warp-uniform values (a broadcast), so the
  // compiler allots each role's registers by its `setmaxnreg`
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31;

  if (wg == BWD_WG) {  // the producer warpgroup; its first warp works
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0) {
      if (lane == 0) {
        mbar_arrive_tx(kvbar, KV_KTILE + KV_VTILE);
        for (int r = 0; r < BC; r += BK) {
          for (int c = 0; c < PD; ++c)
            tma_load(Ks + c * BC * 128 + r * 128, &maps.k, kvbar, c * 64, kvh,
                     j0 + r, b);
          for (int c = 0; c < PV; ++c)
            tma_load(Vs + c * BC * 128 + r * 128, &maps.v, kvbar, c * 64, kvh,
                     j0 + r, b);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int x = 0; x < 2 * G; ++x) {  // the dK walk, then the dV walk
        const int h = kvh * G + x % G;
        const float2* st = p.stats + ((size_t)b * p.H + h) * S;
        const float* dlb = p.dl + ((size_t)b * p.H + h) * S;
        for (int i = 0; i < nq; ++i) {
          if (skip(i)) continue;
          mbar_wait(empty + stage, phase ^ 1);
          float* ms = rows + stage * 3 * BQ;
          for (int r = lane; r < BQ; r += 32) {
            const int row = i * BQ + r;
            const bool ok = row < S;
            ms[r] = ok ? st[row].x : 0.f;
            ms[BQ + r] = ok ? dlb[row] : 0.f;
            reinterpret_cast<int*>(ms)[2 * BQ + r] = ok ? p.pos[row] : 0;
          }
          uint64_t* bar = full + stage;
          if (lane == 0) {
            mbar_arrive_tx(bar, KV_STAGE);
            unsigned char* qs = stages + stage * KV_STAGE;
            unsigned char* hs = qs + KV_QSTAGE;
            unsigned char* ls = hs + KV_OSTAGE;
            for (int c = 0; c < PD; ++c)
              tma_load(qs + c * BQ * 128, &maps.q, bar, c * 64, h, i * BQ, b);
            for (int c = 0; c < PV; ++c) {
              tma_load(hs + c * BQ * 128, &maps.hi, bar, c * 64, h, i * BQ, b);
              tma_load(ls + c * BQ * 128, &maps.lo, bar, c * 64, h, i * BQ, b);
            }
          } else {
            mbar_arrive(bar);
          }
          if (++stage == KV_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // a consumer warpgroup: keys kw0 .. kw0 + 63, 16 rows a warp
    setmaxnreg_inc<CONSUMER_REGS>();
    const int g = lane >> 2, t = lane & 3;
    const int kw0 = j0 + 64 * wg;
    const int k0 = kw0 + warp * 16 + g, k1 = k0 + 8;
    const int kp0 = k0 < S ? p.pos[k0] : 0, kp1 = k1 < S ? p.pos[k1] : 0;
    const bool keys = kw0 < S;
    const int kmin_w = keys ? __ldg(bnd + 2 * (kw0 / TILE)) : 0;
    const int kmax_w = keys ? __ldg(bnd + 2 * (kw0 / TILE) + 1) : 0;
    const uint32_t ka = smem_u32(Ks) + wg * 64 * 128;
    const uint32_t va = smem_u32(Vs) + wg * 64 * 128;
    int stage = 0;
    uint32_t phase = 0;

    // One walk over the G query heads' steps: `work(i, qa, rows)` on each
    // step whose keys and queries meet, for the stage's q tile (at shared
    // address qa, its dO' halves after it) and row records; the work ends
    // its products before the stage is handed back.
    auto walk = [&](auto&& work) {
      for (int gi = 0; gi < G; ++gi) {
        for (int i = 0; i < nq; ++i) {
          if (skip(i)) continue;
          mbar_wait(full + stage, phase);
          if (keys &&
              !(CAUSAL && kmin_w > __ldg(bnd + 2 * ((i * BQ) / TILE) + 1)))
            work(i, smem_u32(stages + stage * KV_STAGE),
                 rows + stage * 3 * BQ);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + stage);
          if (++stage == KV_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    };
    // K Q^T for step i into s (keys as rows), issued as one group
    auto issue_scores = [&](float (&s)[BQ / 2], uint32_t qa) {
      unroll<D / 16>([&](auto k) {
        constexpr int kk = decltype(k)::value;
        wgmma_ss<BQ, kstep(kk, BC * 128), kstep(kk, BQ * 128)>(s, ka, qa, kk);
      });
      wgmma_commit();
    };
    // P^T = exp(s * scale - m_q) in place, zero where masked
    auto softmax = [&](float (&s)[BQ / 2], int i, const float* ms) {
      const int* qps = reinterpret_cast<const int*>(ms + 2 * BQ);
      const bool mask =
          (i + 1) * BQ > S || kw0 + 64 > S ||
          (CAUSAL && kmax_w > __ldg(bnd + 2 * ((i * BQ) / TILE)));
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * t + e;
          const float mq = ms[c];
          bool ok0 = true, ok1 = true;
          if (mask) {
            const bool in = i * BQ + c < S;
            ok0 = in && k0 < S && (!CAUSAL || qps[c] >= kp0);
            ok1 = in && k1 < S && (!CAUSAL || qps[c] >= kp1);
          }
          s[4 * n + e] =
              ok0 ? expf(__fmul_rn(s[4 * n + e], p.scale) - mq) : 0.f;
          s[4 * n + 2 + e] =
              ok1 ? expf(__fmul_rn(s[4 * n + 2 + e], p.scale) - mq) : 0.f;
        }
      }
    };
    mbar_wait(kvbar, 0);
    const size_t kvstride = (size_t)p.KV * D, vstride = (size_t)p.KV * DV;

    {  // the dK walk: dP^T = V dO'^T, dS^T, dK += dS^T Q
      float dk[PD][32];
#pragma unroll
      for (int c = 0; c < PD; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) dk[c][e] = 0.f;
      walk([&](int i, uint32_t qa, const float* ms) {
        const uint32_t ha = qa + KV_QSTAGE, la = ha + KV_OSTAGE;
        const float* dls = ms + BQ;
        float s[BQ / 2], dp[BQ / 2];
        wgmma_fence();
        issue_scores(s, qa);
        unroll<DV / 16>([&](auto k) {
          constexpr int kk = decltype(k)::value;
          wgmma_ss<BQ, kstep(kk, BC * 128), kstep(kk, BQ * 128)>(dp, va,
                                                                 ha, kk);
        });
        unroll<DV / 16>([&](auto k) {
          constexpr int kk = decltype(k)::value;
          wgmma_ss<BQ, kstep(kk, BC * 128), kstep(kk, BQ * 128)>(dp, va,
                                                                 la, 1);
        });
        wgmma_commit();
        wgmma_wait<1>();  // the scores; dP^T runs on
        fence_regs(s);
        softmax(s, i, ms);
        wgmma_wait<0>();
        fence_regs(dp);
        // dS^T = (bf16(dP) + dl) * p * scale in TF32, as its two halves:
        // A fragments (k = query)
        uint32_t dsh[BQ / 16][4], dsl[BQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 8 * kk + 2 * e;
            const float dlq = dls[kk * 16 + (e >> 1) * 8 + 2 * t];
            const float dlq1 = dls[kk * 16 + (e >> 1) * 8 + 2 * t + 1];
            const uint32_t a0 =
                tf32((bf16r(dp[x]) + dlq) * s[x] * p.scale);
            const uint32_t a1 =
                tf32((bf16r(dp[x + 1]) + dlq1) * s[x + 1] * p.scale);
            split2(a0, a1, dsh[kk][e], dsl[kk][e]);
          }
        }
        // dK += dS^T Q (MN-major B: query rows)
        wgmma_fence();
        unroll<BQ / 16>([&](auto k) {
          constexpr int kk = decltype(k)::value;
          unroll<PD>([&](auto n) {
            constexpr int c = decltype(n)::value;
            wgmma_rs64<c * BQ * 128 + kk * 2048>(dk[c], dsh[kk], qa);
            wgmma_rs64<c * BQ * 128 + kk * 2048>(dk[c], dsl[kk], qa);
          });
        });
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dsh);
        fence_regs(dsl);
#pragma unroll
        for (int c = 0; c < PD; ++c) fence_regs(dk[c]);
      });
      const size_t row0 =
          ((size_t)b * S + k0) * kvstride + (size_t)kvh * D + 2 * t;
#pragma unroll
      for (int c = 0; c < PD; ++c)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = c * 64 + n * 8;
          if (k0 < S)
            *reinterpret_cast<uint32_t*>(p.dk + row0 + col) =
                pack_bf16(dk[c][4 * n], dk[c][4 * n + 1]);
          if (k1 < S)
            *reinterpret_cast<uint32_t*>(p.dk + row0 + 8 * kvstride + col) =
                pack_bf16(dk[c][4 * n + 2], dk[c][4 * n + 3]);
        }
    }

    {  // the dV walk: dV += bf16(P)^T dO'
      float dv[PV][32];
#pragma unroll
      for (int c = 0; c < PV; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) dv[c][e] = 0.f;
      walk([&](int i, uint32_t qa, const float* ms) {
        const uint32_t ha = qa + KV_QSTAGE, la = ha + KV_OSTAGE;
        float s[BQ / 2];
        wgmma_fence();
        issue_scores(s, qa);
        wgmma_wait<0>();
        fence_regs(s);
        softmax(s, i, ms);
        uint32_t pb[BQ / 16][4];  // bf16(P^T): A fragments (k = query)
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pb[kk][e] =
                pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        // MN-major B: query rows
        wgmma_fence();
        unroll<BQ / 16>([&](auto k) {
          constexpr int kk = decltype(k)::value;
          unroll<PV>([&](auto n) {
            constexpr int c = decltype(n)::value;
            wgmma_rs64<c * BQ * 128 + kk * 2048>(dv[c], pb[kk], ha);
            wgmma_rs64<c * BQ * 128 + kk * 2048>(dv[c], pb[kk], la);
          });
        });
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pb);
#pragma unroll
        for (int c = 0; c < PV; ++c) fence_regs(dv[c]);
      });
      const size_t row0 =
          ((size_t)b * S + k0) * vstride + (size_t)kvh * DV + 2 * t;
#pragma unroll
      for (int c = 0; c < PV; ++c)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = c * 64 + n * 8;
          if (k0 < S)
            *reinterpret_cast<uint32_t*>(p.dv + row0 + col) =
                pack_bf16(dv[c][4 * n], dv[c][4 * n + 1]);
          if (k1 < S)
            *reinterpret_cast<uint32_t*>(p.dv + row0 + 8 * vstride + col) =
                pack_bf16(dv[c][4 * n + 2], dv[c][4 * n + 3]);
        }
    }
  }
}

// dQ: a block owns BR queries of one (batch, head), kept in shared memory
// with their dO' halves; each consumer warpgroup 64 of them.  The producer
// warp streams the key tiles (k, v and positions) through the ring,
// recomputing S and dP there.
__global__ void __launch_bounds__(BWD_THREADS, 1)
    attn_bwd_q(const __grid_constant__ Maps maps, const Args p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* Hs = Qs + Q_QTILE;
  unsigned char* Ls = Hs + Q_OTILE;
  unsigned char* stages = Ls + Q_OTILE;
  int* kpos = reinterpret_cast<int*>(stages + Q_STAGES * Q_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(kpos + Q_STAGES * BK);
  uint64_t* empty = full + Q_STAGES;
  uint64_t* qbar = empty + Q_STAGES;

  const int S = p.S, ntiles = (S + TILE - 1) / TILE;
  const int nblk = (S + BR - 1) / BR, nk = (S + BK - 1) / BK;
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (CAUSAL ? nblk - 1 - (int)blockIdx.z : (int)blockIdx.z) * BR;
  const int kvh = h / (p.H / p.KV);
  const int* bnd = p.bounds;
  int qmax = -0x7fffffff - 1;
  for (int t = i0 / TILE; t < min(i0 / TILE + BWD_WG, ntiles); ++t)
    qmax = max(qmax, __ldg(bnd + 2 * t + 1));
  // every key of step j after every query of the block
  auto skip = [&](int j) {
    return CAUSAL && __ldg(bnd + 2 * ((j * BK) / TILE)) > qmax;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < Q_STAGES; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 4 * BWD_WG);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup and warp as warp-uniform values (a broadcast), so the
  // compiler allots each role's registers by its `setmaxnreg`
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int warp = __shfl_sync(0xffffffffu, (threadIdx.x >> 5) & 3, 0);
  const int lane = threadIdx.x & 31;

  if (wg == BWD_WG) {  // the producer warpgroup; its first warp works
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == 0) {
      if (lane == 0) {
        mbar_arrive_tx(qbar, Q_QTILE + 2 * Q_OTILE);
        for (int r = 0; r < BR; r += BQ) {
          for (int c = 0; c < PD; ++c)
            tma_load(Qs + c * BR * 128 + r * 128, &maps.q, qbar, c * 64, h,
                     i0 + r, b);
          for (int c = 0; c < PV; ++c) {
            tma_load(Hs + c * BR * 128 + r * 128, &maps.hi, qbar, c * 64, h,
                     i0 + r, b);
            tma_load(Ls + c * BR * 128 + r * 128, &maps.lo, qbar, c * 64, h,
                     i0 + r, b);
          }
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < nk; ++j) {
        if (skip(j)) continue;
        mbar_wait(empty + stage, phase ^ 1);
        for (int r = lane; r < BK; r += 32) {
          const int row = j * BK + r;
          kpos[stage * BK + r] = row < S ? p.pos[row] : 0;
        }
        uint64_t* bar = full + stage;
        if (lane == 0) {
          mbar_arrive_tx(bar, Q_STAGE);
          unsigned char* ks = stages + stage * Q_STAGE;
          unsigned char* vs = ks + Q_KSTAGE;
          for (int c = 0; c < PD; ++c)
            tma_load(ks + c * BK * 128, &maps.k, bar, c * 64, kvh, j * BK, b);
          for (int c = 0; c < PV; ++c)
            tma_load(vs + c * BK * 128, &maps.v, bar, c * 64, kvh, j * BK, b);
        } else {
          mbar_arrive(bar);
        }
        if (++stage == Q_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // a consumer warpgroup: queries qw0 .. qw0 + 63, 16 rows a warp
    setmaxnreg_inc<CONSUMER_REGS>();
    const int g = lane >> 2, t = lane & 3;
    const int qw0 = i0 + 64 * wg;
    const int r0 = qw0 + warp * 16 + g, r1 = r0 + 8;
    const bool queries = qw0 < S;
    const int qmin_w = queries ? __ldg(bnd + 2 * (qw0 / TILE)) : 0;
    const int qmax_w = queries ? __ldg(bnd + 2 * (qw0 / TILE) + 1) : 0;
    const size_t sh = ((size_t)b * p.H + h) * S;
    const int qp0 = r0 < S ? p.pos[r0] : 0, qp1 = r1 < S ? p.pos[r1] : 0;
    const float mr0 = r0 < S ? p.stats[sh + r0].x : 0.f;
    const float mr1 = r1 < S ? p.stats[sh + r1].x : 0.f;
    const float dl0 = r0 < S ? p.dl[sh + r0] : 0.f;
    const float dl1 = r1 < S ? p.dl[sh + r1] : 0.f;
    const uint32_t qa = smem_u32(Qs) + wg * 64 * 128;
    const uint32_t ha = smem_u32(Hs) + wg * 64 * 128;
    const uint32_t la = smem_u32(Ls) + wg * 64 * 128;

    float dq[PD][32];
#pragma unroll
    for (int c = 0; c < PD; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) dq[c][e] = 0.f;
    mbar_wait(qbar, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < nk; ++j) {
      if (skip(j)) continue;
      const int jt = (j * BK) / TILE;
      mbar_wait(full + stage, phase);
      if (queries && !(CAUSAL && __ldg(bnd + 2 * jt) > qmax_w)) {
        const uint32_t ka = smem_u32(stages + stage * Q_STAGE);
        const uint32_t va = ka + Q_KSTAGE;
        const int* kps = kpos + stage * BK;
        // S = Q K^T and dP = dO' V^T (dO' as its two halves)
        float s[BK / 2], dp[BK / 2];
        wgmma_fence();
        unroll<D / 16>([&](auto k) {
          constexpr int kk = decltype(k)::value;
          wgmma_ss<BK, kstep(kk, BR * 128), kstep(kk, BK * 128)>(s, qa, ka,
                                                                 kk);
        });
        wgmma_commit();
        unroll<DV / 16>([&](auto k) {
          constexpr int kk = decltype(k)::value;
          wgmma_ss<BK, kstep(kk, BR * 128), kstep(kk, BK * 128)>(dp, ha, va,
                                                                 kk);
        });
        unroll<DV / 16>([&](auto k) {
          constexpr int kk = decltype(k)::value;
          wgmma_ss<BK, kstep(kk, BR * 128), kstep(kk, BK * 128)>(dp, la, va,
                                                                 1);
        });
        wgmma_commit();
        wgmma_wait<1>();  // the scores; dP runs on
        fence_regs(s);
        // P = exp(s * scale - m), zero where masked
        const bool mask = (j + 1) * BK > S ||
                          (CAUSAL && __ldg(bnd + 2 * jt + 1) > qmin_w);
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n * 8 + 2 * t + e;
            bool ok0 = true, ok1 = true;
            if (mask) {
              const bool in = j * BK + c < S;
              ok0 = in && (!CAUSAL || qp0 >= kps[c]);
              ok1 = in && (!CAUSAL || qp1 >= kps[c]);
            }
            s[4 * n + e] =
                ok0 ? expf(__fmul_rn(s[4 * n + e], p.scale) - mr0) : 0.f;
            s[4 * n + 2 + e] =
                ok1 ? expf(__fmul_rn(s[4 * n + 2 + e], p.scale) - mr1) : 0.f;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);
        // dS = (bf16(dP) + dl) * p * scale in TF32, as its two halves: A
        // fragments (k = key)
        uint32_t dsh[BK / 16][4], dsl[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 8 * kk + 2 * e;
            const float dlr = (e & 1) ? dl1 : dl0;
            const uint32_t a0 = tf32((bf16r(dp[x]) + dlr) * s[x] * p.scale);
            const uint32_t a1 =
                tf32((bf16r(dp[x + 1]) + dlr) * s[x + 1] * p.scale);
            split2(a0, a1, dsh[kk][e], dsl[kk][e]);
          }
        }
        // dQ += dS K (MN-major B: key rows)
        wgmma_fence();
        unroll<BK / 16>([&](auto k) {
          constexpr int kk = decltype(k)::value;
          unroll<PD>([&](auto n) {
            constexpr int c = decltype(n)::value;
            wgmma_rs64<c * BK * 128 + kk * 2048>(dq[c], dsh[kk], ka);
            wgmma_rs64<c * BK * 128 + kk * 2048>(dq[c], dsl[kk], ka);
          });
        });
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dsh);
        fence_regs(dsl);
#pragma unroll
        for (int c = 0; c < PD; ++c) fence_regs(dq[c]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      if (++stage == Q_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    const size_t qstride = (size_t)p.H * D;
    const size_t row0 = ((size_t)b * S + r0) * qstride + (size_t)h * D + 2 * t;
#pragma unroll
    for (int c = 0; c < PD; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = c * 64 + n * 8;
        if (r0 < S)
          *reinterpret_cast<uint32_t*>(p.dq + row0 + col) =
              pack_bf16(dq[c][4 * n], dq[c][4 * n + 1]);
        if (r1 < S)
          *reinterpret_cast<uint32_t*>(p.dq + row0 + 8 * qstride + col) =
              pack_bf16(dq[c][4 * n + 2], dq[c][4 * n + 3]);
      }
  }
}

int set_smem(const void* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

Args make_args(int B, int S, int H, int KV, float scale) {
  Args a = {};
  a.B = B;
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.scale = scale;
  return a;
}

Args backward_args(const void* q, const void* k, const void* v,
                   const int* pos, const int* bounds, const float* o32,
                   const float* stats, const void* dout, float* dout32,
                   float* dl, void* dq, void* dk, void* dv, int B, int S,
                   int H, int KV, float scale) {
  Args a = make_args(B, S, H, KV, scale);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.pos = pos;
  a.bounds = bounds;
  a.o32 = const_cast<float*>(o32);
  a.stats = reinterpret_cast<float2*>(const_cast<float*>(stats));
  a.dout = static_cast<const bf16*>(dout);
  a.dohi = reinterpret_cast<bf16*>(dout32);
  a.dolo = a.dohi + (size_t)B * S * H * DV;
  a.dl = dl;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  return a;
}

// cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &got);
#endif
    if (err == cudaSuccess && got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a (B, S, heads, width) bf16 tensor at `base`, read in boxes of 64 columns
// by `rows` rows of one head and batch, 128-byte swizzled, zero past S; 0,
// or the encoder's CUresult
int make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int B,
              int S, int heads, int width, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)heads * width * 2,
                                 (cuuint64_t)S * heads * width * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

extern "C" {

// codes of attn_backward past the runtime's: a tensor map not made
constexpr int MAP_ERROR = 10000;

// TILE, head dimension, causal flag and threads a forward block, and v's
// width where it is not the head dimension's, for the wrapper to check
// against its own
void attn_geometry(int* out) {
  out[0] = TILE;
  out[1] = D;
  out[2] = CAUSAL ? 1 : 0;
  out[3] = THREADS;
  if (DV != D) out[4] = DV;
}

const char* attn_error_string(int err) {
  if (err >= MAP_ERROR)
    return err == MAP_ERROR ? "cuTensorMapEncodeTiled not found"
                            : "cuTensorMapEncodeTiled refused a tensor map "
                              "(the code less 10000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// o (and o32 unless null), stats and bounds from q, k, v and positions,
// the scores scaled by `scale`
int attn_forward(const void* q, const void* k, const void* v, const int* pos,
                 int* bounds, void* o, float* o32, float* stats, int B, int S,
                 int H, int KV, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = make_args(B, S, H, KV, scale);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.pos = pos;
  a.bounds = bounds;
  a.o = static_cast<bf16*>(o);
  a.o32 = o32;
  a.stats = reinterpret_cast<float2*>(stats);
  const int ntiles = (S + TILE - 1) / TILE;
  const int smem = FWD_SMEM + 8 * ntiles;
  int err = set_smem((const void*)attn_fwd, smem);
  if (err) return err;
  attn_bounds<<<(ntiles + WARPS - 1) / WARPS, THREADS, 0, st>>>(pos, S, ntiles,
                                                              bounds);
  err = (int)cudaGetLastError();
  if (err) return err;
  attn_fwd<<<dim3(ntiles, H, B), THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// dq, dk and dv from the forward's inputs and records and dout, through
// the scratch dout32 (the size of the output in fp32, which holds dO''s two
// bf16 halves) and dl (B * H * S fp32): the prep (the halves, dl), then dK
// and dV, then dQ, on the same stream
int attn_backward(const void* q, const void* k, const void* v, const int* pos,
                  const int* bounds, const float* o32, const float* stats,
                  const void* dout, float* dout32, float* dl, void* dq,
                  void* dk, void* dv, int B, int S, int H, int KV,
                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a = backward_args(q, k, v, pos, bounds, o32, stats, dout, dout32,
                               dl, dq, dk, dv, B, S, H, KV, scale);
  // the runtime first: its first call on a thread (autograd's, here) makes
  // the device's context current, which the encoder needs
  int err = set_smem((const void*)attn_bwd_kv, KV_SMEM);
  if (err) return err;
  err = set_smem((const void*)attn_bwd_q, Q_SMEM);
  if (err) return err;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return MAP_ERROR;
  Maps m;
  err = make_map(encode, &m.q, q, B, S, H, D, BQ);
  if (!err) err = make_map(encode, &m.k, k, B, S, KV, D, BK);
  if (!err) err = make_map(encode, &m.v, v, B, S, KV, DV, BK);
  if (!err) err = make_map(encode, &m.hi, a.dohi, B, S, H, DV, BQ);
  if (!err) err = make_map(encode, &m.lo, a.dolo, B, S, H, DV, BQ);
  if (err) return MAP_ERROR + err;
  const size_t rows = (size_t)B * S * H;
  attn_bwd_prep<<<(unsigned)((rows + PREP_WARPS - 1) / PREP_WARPS),
                  32 * PREP_WARPS, 0, st>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  attn_bwd_kv<<<dim3(KV, B, (S + BC - 1) / BC), BWD_THREADS, KV_SMEM, st>>>(
      m, a);
  err = (int)cudaGetLastError();
  if (err) return err;
  attn_bwd_q<<<dim3(H, B, (S + BR - 1) / BR), BWD_THREADS, Q_SMEM, st>>>(m,
                                                                         a);
  return (int)cudaGetLastError();
}

}  // extern "C"
