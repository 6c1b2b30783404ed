// Fused causal (or full) self-attention, forward and backward, for Hopper
// (built with -gencode arch=compute_90a,code=sm_90a into one library for
// each head dimension and causal flag, -DATTN_HEAD_DIM=64|128
// -DATTN_CAUSAL=0|1).
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
// triangle) against 8 * B * S * H * D = 3.4e7 bytes read and written.
//
// The arithmetic is the plain version's, operand for operand (the rule:
// no operand is rounded to fewer bits than that graph rounds it):
//   * S = Q K^T from bf16 q, k on bf16 mma.sync with fp32 accumulation (the
//     plain version's TF32 product of bf16 values, which TF32 holds
//     exactly), then s * scale in fp32; masked scores are -1e30 (its
//     `_MASK`), keys past the sequence are excluded;
//   * the running max, exp, the running sum and the final division stay
//     in fp32 (expf, IEEE division); p is rounded to bf16 (RNE) for the
//     value product, which runs on bf16 mma.sync with fp32 accumulation;
//   * the forward keeps, per row, the final max m and sum l, and (when a
//     gradient is wanted) the fp32 output o / max(l, 1e-30) before its
//     cast to bf16;
//   * the backward recomputes p = exp(s * scale - m) tile by tile and
//     follows autograd's graph of the plain version: g = dO (bf16 values),
//     dO' = g / l rounded to TF32 (the operand the plain version's TF32
//     product rounds), dl = -sum(g * o32) / l, dP = dO' V^T on TF32
//     mma.sync, rounded to bf16 (the backward of p's cast to bf16), dS =
//     (bf16(dP) + dl) * p * scale rounded to TF32, dV += bf16(p)^T dO',
//     dK += dS^T Q, dQ += dS K, all on TF32 mma.sync (m16n8k8) with fp32
//     accumulation; dQ, dK and dV are rounded to bf16 once, at the end.
//     (The plain version also sends a sum of dS through amax to the row's
//     argmax score; that sum is zero but for rounding, and is left out.)
//
// Design (FlashAttention-2's scheme on mma.sync; a TMA and wgmma pipeline
// is later work):
//   * Tiles of 64 rows, 4 warps a block, 16 rows a warp; rows in shared
//     memory are padded by 16 bytes (bf16) or 16 / 32 bytes (fp32), so the
//     fragment loads below hit 32 distinct banks.
//   * `attn_bounds` writes the smallest and largest position of each
//     64-row tile (positions need not be arange).  A block copies them to
//     shared memory; a (query tile, key tile) pair is skipped when the key
//     tile's smallest position exceeds the query tile's largest (causal
//     only), and masked element by element (q_pos >= kv_pos) only when the
//     key tile's largest position exceeds the query tile's smallest, or a
//     tile runs past the sequence (rows past it are zero-filled and never
//     stored).
//   * GQA: query head h reads KV head h / G.
//   * Forward (`attn_fwd`): a block owns a query tile of one (batch, head);
//     Q fragments stay in registers, K / V tiles stream through a double
//     buffer of cp.async; the running max, sum and accumulator stay in
//     registers.  The score accumulators become the value product's A
//     fragments in registers.
//   * Backward: `attn_bwd_prep` (one warp a row) makes dO' and dl;
//     `attn_bwd_kv` owns a key tile of one (batch, KV head), loops over the
//     G query heads and the query tiles in two halves of 32, and keeps dK
//     and dV in registers (S^T and dP^T are computed with keys as rows, so
//     their accumulators are the A fragments of dV and dK); `attn_bwd_q`
//     owns a query tile and loops over the key tiles, recomputing S and
//     dP, and keeps dQ in registers.  Nothing is reduced across blocks: no
//     atomics, and the result does not depend on the schedule.
//   * TF32 fragments from fp32 accumulators: mma's k index may be permuted
//     as long as A and B agree, so logical k = t and t + 4 of a thread's
//     quad position t are taken as the physical columns 2t and 2t + 1 that
//     an accumulator fragment holds.  A bf16 value is a TF32 value shifted
//     left by 16 bits.
//   * Heavy blocks first: causal query tiles run from the last.
//   * Offsets are 64-bit.
//
// Plain C interface (ctypes): every entry point returns cudaGetLastError()
// after its launches; nothing synchronises or allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef ATTN_HEAD_DIM
#error "build with -DATTN_HEAD_DIM=64 or 128"
#endif
#ifndef ATTN_CAUSAL
#error "build with -DATTN_CAUSAL=0 or 1"
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = ATTN_HEAD_DIM;
constexpr bool CAUSAL = ATTN_CAUSAL != 0;
static_assert(D == 64 || D == 128, "head dimension 64 or 128");
constexpr int TILE = 64;            // rows of a query or key tile
constexpr int WARPS = 4;            // 16 rows a warp
constexpr int THREADS = 32 * WARPS;
constexpr int HALF = 32;            // query columns per step of attn_bwd_kv
constexpr int LDB = D + 8;          // bf16 row stride in shared memory
constexpr int LDA = D + 4;          // fp32 dO' rows in attn_bwd_kv
constexpr int LDQ = D + 8;          // fp32 dO' rows in attn_bwd_q
constexpr int PREP_WARPS = 8;
constexpr float MASK = -1e30f;      // the plain version's _MASK
constexpr float MIN_SUM = 1e-30f;   // its clamp of the sum

constexpr int FWD_SMEM = 5 * TILE * LDB * 2 + 2 * TILE * 4;
constexpr int KV_SMEM = 3 * TILE * LDB * 2 + TILE * LDA * 4 + 4 * TILE * 4;
constexpr int Q_SMEM = 3 * TILE * LDB * 2 + TILE * LDQ * 4 + TILE * 4;

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

__device__ __forceinline__ void mma_tf32(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
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

// a bf16 value as TF32 bits (exact)
__device__ __forceinline__ uint32_t bits(bf16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16;
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

// 64 rows of D bf16 values (row stride `stride` elements) starting at row
// `row0`, into shared memory; rows at or past S are zero-filled
__device__ __forceinline__ void load_bf16(bf16* dst, const bf16* src,
                                          size_t stride, int row0, int S,
                                          int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int it = 0; it < TILE * CH / THREADS; ++it) {
    const int x = tid + it * THREADS;
    const int r = x / CH, c = x % CH, row = row0 + r;
    const bool ok = row < S;
    cp16(dst + r * LDB + c * 8, src + (ok ? row : 0) * stride + c * 8, ok);
  }
}

template <int LD>
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         size_t stride, int row0, int S,
                                         int tid) {
  constexpr int CH = D / 4;
#pragma unroll
  for (int it = 0; it < TILE * CH / THREADS; ++it) {
    const int x = tid + it * THREADS;
    const int r = x / CH, c = x % CH, row = row0 + r;
    const bool ok = row < S;
    cp16(dst + r * LD + c * 4, src + (ok ? row : 0) * stride + c * 4, ok);
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
  const bf16* v;
  const int* pos;      // (S,)
  const int* bounds;   // (ntiles, 2): smallest and largest position
  bf16* o;             // (B, S, H, D)
  float* o32;          // (B, S, H, D), or null
  float2* stats;       // (B, H, S): the row's max and sum
  const bf16* dout;    // (B, S, H, D)
  float* dout32;       // (B, S, H, D): g / l in TF32
  float* dl;           // (B, H, S)
  bf16* dq;
  bf16* dk;
  bf16* dv;
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
  int* kps = reinterpret_cast<int*>(Vs + 2 * TILE * LDB);   // 2 buffers
  int* bnd = kps + 2 * TILE;
  const int S = p.S, ntiles = (S + TILE - 1) / TILE;
  const int i = CAUSAL ? ntiles - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qstride = (size_t)p.H * D, kvstride = (size_t)p.KV * D;
  const bf16* qb = p.q + (size_t)b * S * qstride + (size_t)h * D;
  const bf16* kb = p.k + (size_t)b * S * kvstride + (size_t)kvh * D;
  const bf16* vb = p.v + (size_t)b * S * kvstride + (size_t)kvh * D;

  for (int x = tid; x < 2 * ntiles; x += THREADS) bnd[x] = p.bounds[x];
  load_bf16(Qs, qb, qstride, i * TILE, S, tid);
  cp_commit();
  __syncthreads();
  const int qmin = bnd[2 * i], qmax = bnd[2 * i + 1];
  auto next = [&](int j) {
    while (CAUSAL && j < ntiles && bnd[2 * j] > qmax) ++j;
    return j;
  };
  auto load_kv = [&](int j, int buf) {
    load_bf16(Ks + buf * TILE * LDB, kb, kvstride, j * TILE, S, tid);
    load_bf16(Vs + buf * TILE * LDB, vb, kvstride, j * TILE, S, tid);
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

  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = MASK, m1 = MASK, l0 = 0.f, l1 = 0.f;
  int buf = 0;
  while (j < ntiles) {
    const int jn = next(j + 1);
    if (jn < ntiles) load_kv(jn, buf ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + buf * TILE * LDB;
    const bf16* Vt = Vs + buf * TILE * LDB;
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
    for (int d = 0; d < D / 8; ++d) {
      o[d][0] *= c0;
      o[d][1] *= c0;
      o[d][2] *= c1;
      o[d][3] *= c1;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldsm4t(bv, Vt + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDB +
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
  const size_t row0 = ((size_t)b * S + r0) * qstride + (size_t)h * D + 2 * t;
  const size_t row1 = row0 + 8 * qstride;
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
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

// dO' = tf32(g / l) and dl = -sum(g * o32) / l, one warp a (b, s, h) row
__global__ void __launch_bounds__(32 * PREP_WARPS) attn_bwd_prep(const Args p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * PREP_WARPS + warp;
  if (row >= (size_t)p.B * p.S * p.H) return;
  const int h = (int)(row % p.H);
  const size_t bs = row / p.H;
  const int s = (int)(bs % p.S), b = (int)(bs / p.S);
  const size_t at = ((size_t)b * p.H + h) * p.S + s;
  const float l = fmaxf(p.stats[at].y, MIN_SUM);
  constexpr int E = D / 32;
  const size_t base = row * D + lane * E;
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float gv = __bfloat162float(p.dout[base + e]);
    acc += gv * p.o32[base + e];
    p.dout32[base + e] = __uint_as_float(tf32(gv / l));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) p.dl[at] = -acc / l;
}

__global__ void __launch_bounds__(THREADS) attn_bwd_kv(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TILE * LDB;
  bf16* Qs = Vs + TILE * LDB;
  float* dos = reinterpret_cast<float*>(Qs + TILE * LDB);
  float* ms = dos + TILE * LDA;
  float* dls = ms + TILE;
  int* qps = reinterpret_cast<int*>(dls + TILE);
  int* kps = qps + TILE;
  int* bnd = kps + TILE;
  const int S = p.S, ntiles = (S + TILE - 1) / TILE;
  const int j = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qstride = (size_t)p.H * D, kvstride = (size_t)p.KV * D;

  for (int x = tid; x < 2 * ntiles; x += THREADS) bnd[x] = p.bounds[x];
  load_bf16(Ks, p.k + (size_t)b * S * kvstride + (size_t)kvh * D, kvstride,
            j * TILE, S, tid);
  load_bf16(Vs, p.v + (size_t)b * S * kvstride + (size_t)kvh * D, kvstride,
            j * TILE, S, tid);
  load_rows4(kps, p.pos, 1, j * TILE, S, tid);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  const int kmin = bnd[2 * j], kmax = bnd[2 * j + 1];
  const int k0 = j * TILE + warp * 16 + g, k1 = k0 + 8;
  const int kp0 = kps[warp * 16 + g], kp1 = kps[warp * 16 + g + 8];

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const bf16* qb = p.q + (size_t)b * S * qstride + (size_t)h * D;
    const float* db = p.dout32 + (size_t)b * S * qstride + (size_t)h * D;
    const float2* st = p.stats + ((size_t)b * p.H + h) * S;
    const float* dlb = p.dl + ((size_t)b * p.H + h) * S;
    for (int i = 0; i < ntiles; ++i) {
      if (CAUSAL && kmin > bnd[2 * i + 1]) continue;
      load_bf16(Qs, qb, qstride, i * TILE, S, tid);
      load_f32<LDA>(dos, db, qstride, i * TILE, S, tid);
      load_rows4(ms, st, 2, i * TILE, S, tid);
      load_rows4(dls, dlb, 1, i * TILE, S, tid);
      load_rows4(qps, p.pos, 1, i * TILE, S, tid);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      const bool mask = (i + 1) * TILE > S || (j + 1) * TILE > S ||
                        (CAUSAL && kmax > bnd[2 * i]);
#pragma unroll 1
      for (int half = 0; half < TILE / HALF; ++half) {
        const int qh = half * HALF;
        // S^T = K Q^T: keys as rows
        float s[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4];
          ldsm4(a, Ks + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDB +
                       kk * 16 + 8 * (lane >> 4));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bq[4];
            ldsm4(bq, Qs + (qh + np * 16 + (lane & 7) + 8 * (lane >> 4)) * LDB +
                          kk * 16 + 8 * ((lane >> 3) & 1));
            mma_bf16(s[2 * np], a, bq[0], bq[1]);
            mma_bf16(s[2 * np + 1], a, bq[2], bq[3]);
          }
        }
        // P^T = exp(s * scale - m_q), zero where masked
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = qh + n * 8 + 2 * t + e;
            const float mq = ms[c];
            bool ok0 = true, ok1 = true;
            if (mask) {
              const bool in = i * TILE + c < S;
              ok0 = in && k0 < S && (!CAUSAL || qps[c] >= kp0);
              ok1 = in && k1 < S && (!CAUSAL || qps[c] >= kp1);
            }
            s[n][e] = ok0 ? expf(__fmul_rn(s[n][e], p.scale) - mq) : 0.f;
            s[n][2 + e] =
                ok1 ? expf(__fmul_rn(s[n][2 + e], p.scale) - mq) : 0.f;
          }
        }
        // dP^T = V dO'^T (TF32, k = d in its own order)
        float dp[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
        for (int s8 = 0; s8 < D / 8; ++s8) {
          const bf16* v0 = Vs + (warp * 16 + g) * LDB + s8 * 8 + t;
          const bf16* v1 = v0 + 8 * LDB;
          const uint32_t a0 = bits(v0[0]), a1 = bits(v1[0]);
          const uint32_t a2 = bits(v0[4]), a3 = bits(v1[4]);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const float* dr = dos + (qh + n * 8 + g) * LDA + s8 * 8 + t;
            mma_tf32(dp[n], a0, a1, a2, a3, __float_as_uint(dr[0]),
                     __float_as_uint(dr[4]));
          }
        }
        // dV += bf16(P)^T dO' (k = query: columns 2t, 2t+1 as t, t+4)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint32_t a0 = __float_as_uint(bf16r(s[n][0]));
          const uint32_t a2 = __float_as_uint(bf16r(s[n][1]));
          const uint32_t a1 = __float_as_uint(bf16r(s[n][2]));
          const uint32_t a3 = __float_as_uint(bf16r(s[n][3]));
          const float* d0r = dos + (qh + n * 8 + 2 * t) * LDA + g;
          const float* d1r = d0r + LDA;
#pragma unroll
          for (int d = 0; d < D / 8; ++d)
            mma_tf32(dv[d], a0, a1, a2, a3, __float_as_uint(d0r[d * 8]),
                     __float_as_uint(d1r[d * 8]));
        }
        // dS^T = (bf16(dP) + dl) * p * scale, in TF32
        uint32_t ds[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dlq = dls[qh + n * 8 + 2 * t + e];
            ds[n][e] = tf32((bf16r(dp[n][e]) + dlq) * s[n][e] * p.scale);
            ds[n][2 + e] =
                tf32((bf16r(dp[n][2 + e]) + dlq) * s[n][2 + e] * p.scale);
          }
        }
        // dK += dS^T Q
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const bf16* q0r = Qs + (qh + n * 8 + 2 * t) * LDB + g;
          const bf16* q1r = q0r + LDB;
#pragma unroll
          for (int d = 0; d < D / 8; ++d)
            mma_tf32(dk[d], ds[n][0], ds[n][2], ds[n][1], ds[n][3],
                     bits(q0r[d * 8]), bits(q1r[d * 8]));
        }
      }
      __syncthreads();
    }
  }
  const size_t row0 = ((size_t)b * S + k0) * kvstride + (size_t)kvh * D + 2 * t;
  const size_t row1 = row0 + 8 * kvstride;
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    if (k0 < S) {
      *reinterpret_cast<uint32_t*>(p.dk + row0 + d * 8) =
          pack_bf16(dk[d][0], dk[d][1]);
      *reinterpret_cast<uint32_t*>(p.dv + row0 + d * 8) =
          pack_bf16(dv[d][0], dv[d][1]);
    }
    if (k1 < S) {
      *reinterpret_cast<uint32_t*>(p.dk + row1 + d * 8) =
          pack_bf16(dk[d][2], dk[d][3]);
      *reinterpret_cast<uint32_t*>(p.dv + row1 + d * 8) =
          pack_bf16(dv[d][2], dv[d][3]);
    }
  }
}

__global__ void __launch_bounds__(THREADS) attn_bwd_q(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TILE * LDB;
  bf16* Vs = Ks + TILE * LDB;
  float* dos = reinterpret_cast<float*>(Vs + TILE * LDB);
  int* kps = reinterpret_cast<int*>(dos + TILE * LDQ);
  int* bnd = kps + TILE;
  const int S = p.S, ntiles = (S + TILE - 1) / TILE;
  const int i = CAUSAL ? ntiles - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t qstride = (size_t)p.H * D, kvstride = (size_t)p.KV * D;
  const bf16* kb = p.k + (size_t)b * S * kvstride + (size_t)kvh * D;
  const bf16* vb = p.v + (size_t)b * S * kvstride + (size_t)kvh * D;

  for (int x = tid; x < 2 * ntiles; x += THREADS) bnd[x] = p.bounds[x];
  load_bf16(Qs, p.q + (size_t)b * S * qstride + (size_t)h * D, qstride,
            i * TILE, S, tid);
  load_f32<LDQ>(dos, p.dout32 + (size_t)b * S * qstride + (size_t)h * D,
                qstride, i * TILE, S, tid);
  cp_commit();
  const int r0 = i * TILE + warp * 16 + g, r1 = r0 + 8;
  const size_t sh = ((size_t)b * p.H + h) * S;
  const int qp0 = r0 < S ? p.pos[r0] : 0, qp1 = r1 < S ? p.pos[r1] : 0;
  const float mr0 = r0 < S ? p.stats[sh + r0].x : 0.f;
  const float mr1 = r1 < S ? p.stats[sh + r1].x : 0.f;
  const float dl0 = r0 < S ? p.dl[sh + r0] : 0.f;
  const float dl1 = r1 < S ? p.dl[sh + r1] : 0.f;
  cp_wait<0>();
  __syncthreads();
  const int qmin = bnd[2 * i], qmax = bnd[2 * i + 1];
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldsm4(qf[kk], Qs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDB +
                      kk * 16 + 8 * (lane >> 4));
  const float* do0 = dos + (warp * 16 + g) * LDQ + 2 * t;
  const float* do1 = do0 + 8 * LDQ;

  float dq[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    if (CAUSAL && bnd[2 * j] > qmax) continue;
    load_bf16(Ks, kb, kvstride, j * TILE, S, tid);
    load_bf16(Vs, vb, kvstride, j * TILE, S, tid);
    load_rows4(kps, p.pos, 1, j * TILE, S, tid);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    // S = Q K^T
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm4(bk, Ks + (np * 16 + (lane & 7) + 8 * (lane >> 4)) * LDB +
                      kk * 16 + 8 * ((lane >> 3) & 1));
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }
    // P = exp(s * scale - m), zero where masked
    const bool mask = (j + 1) * TILE > S || (CAUSAL && bnd[2 * j + 1] > qmin);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t + e;
        bool ok0 = true, ok1 = true;
        if (mask) {
          const bool in = j * TILE + c < S;
          ok0 = in && (!CAUSAL || qp0 >= kps[c]);
          ok1 = in && (!CAUSAL || qp1 >= kps[c]);
        }
        s[n][e] = ok0 ? expf(__fmul_rn(s[n][e], p.scale) - mr0) : 0.f;
        s[n][2 + e] =
            ok1 ? expf(__fmul_rn(s[n][2 + e], p.scale) - mr1) : 0.f;
      }
    }
    // dP = dO' V^T (TF32; k = d, columns 2t, 2t+1 as t, t+4)
    float dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int s8 = 0; s8 < D / 8; ++s8) {
      const float2 x0 = *reinterpret_cast<const float2*>(do0 + s8 * 8);
      const float2 x1 = *reinterpret_cast<const float2*>(do1 + s8 * 8);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t vv = *reinterpret_cast<const uint32_t*>(
            Vs + (n * 8 + g) * LDB + s8 * 8 + 2 * t);
        mma_tf32(dp[n], __float_as_uint(x0.x), __float_as_uint(x1.x),
                 __float_as_uint(x0.y), __float_as_uint(x1.y), vv << 16,
                 vv & 0xffff0000u);
      }
    }
    // dS = (bf16(dP) + dl) * p * scale in TF32; dQ += dS K
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint32_t a0 = tf32((bf16r(dp[n][0]) + dl0) * s[n][0] * p.scale);
      const uint32_t a2 = tf32((bf16r(dp[n][1]) + dl0) * s[n][1] * p.scale);
      const uint32_t a1 = tf32((bf16r(dp[n][2]) + dl1) * s[n][2] * p.scale);
      const uint32_t a3 = tf32((bf16r(dp[n][3]) + dl1) * s[n][3] * p.scale);
      const bf16* k0r = Ks + (n * 8 + 2 * t) * LDB + g;
      const bf16* k1r = k0r + LDB;
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
        mma_tf32(dq[d], a0, a1, a2, a3, bits(k0r[d * 8]), bits(k1r[d * 8]));
    }
    __syncthreads();
  }
  const size_t row0 = ((size_t)b * S + r0) * qstride + (size_t)h * D + 2 * t;
  const size_t row1 = row0 + 8 * qstride;
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(p.dq + row0 + d * 8) =
          pack_bf16(dq[d][0], dq[d][1]);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(p.dq + row1 + d * 8) =
          pack_bf16(dq[d][2], dq[d][3]);
  }
}

int set_smem(const void* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

Args make_args(int B, int S, int H, int KV) {
  Args a = {};
  a.B = B;
  a.S = S;
  a.H = H;
  a.KV = KV;
  a.scale = (float)(1.0 / sqrt((double)D));   // the plain version's scale
  return a;
}

Args backward_args(const void* q, const void* k, const void* v,
                   const int* pos, const int* bounds, const float* o32,
                   const float* stats, const void* dout, float* dout32,
                   float* dl, void* dq, void* dk, void* dv, int B, int S,
                   int H, int KV) {
  Args a = make_args(B, S, H, KV);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.pos = pos;
  a.bounds = bounds;
  a.o32 = const_cast<float*>(o32);
  a.stats = reinterpret_cast<float2*>(const_cast<float*>(stats));
  a.dout = static_cast<const bf16*>(dout);
  a.dout32 = dout32;
  a.dl = dl;
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  return a;
}

}  // namespace

extern "C" {

// TILE, head dimension, causal flag and threads a block, for the wrapper
// to check against its own
void attn_geometry(int* out) {
  out[0] = TILE;
  out[1] = D;
  out[2] = CAUSAL ? 1 : 0;
  out[3] = THREADS;
}

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// o (and o32 unless null), stats and bounds from q, k, v and positions
int attn_forward(const void* q, const void* k, const void* v, const int* pos,
                 int* bounds, void* o, float* o32, float* stats, int B, int S,
                 int H, int KV, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a = make_args(B, S, H, KV);
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
// the scratch dout32 (the size of q, fp32) and dl (B * H * S fp32): the
// prep (dout32, dl), then dK and dV, then dQ, on the same stream
int attn_backward(const void* q, const void* k, const void* v, const int* pos,
                  const int* bounds, const float* o32, const float* stats,
                  const void* dout, float* dout32, float* dl, void* dq,
                  void* dk, void* dv, int B, int S, int H, int KV,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a = backward_args(q, k, v, pos, bounds, o32, stats, dout, dout32,
                               dl, dq, dk, dv, B, S, H, KV);
  const int ntiles = (S + TILE - 1) / TILE;
  const int kv_smem = KV_SMEM + 8 * ntiles, q_smem = Q_SMEM + 8 * ntiles;
  int err = set_smem((const void*)attn_bwd_kv, kv_smem);
  if (err) return err;
  err = set_smem((const void*)attn_bwd_q, q_smem);
  if (err) return err;
  const size_t rows = (size_t)B * S * H;
  attn_bwd_prep<<<(unsigned)((rows + PREP_WARPS - 1) / PREP_WARPS),
                  32 * PREP_WARPS, 0, st>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  attn_bwd_kv<<<dim3(ntiles, KV, B), THREADS, kv_smem, st>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  attn_bwd_q<<<dim3(ntiles, H, B), THREADS, q_smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
