// The gathers around a MoE expert share's experts, for Hopper (built with
// -gencode arch=compute_90a,code=sm_90a into one library,
// `kernels.nvcc.NVCC_FLAGS`, no fast math).
//
// Replaces no TPU kernel: the reference's MoE combines capacity buffers
// with XLA (`repro.models.moe`, jitted).  The port's plain versions
// (`repro_torch.models.moe.gather_sum_plain`, `combine_backward_plain`)
// gather every (token, choice) pair's row into a (T, K, d) fp32 tensor,
// mask it and sum it over K; at OLMoE's microbatch (T 8,192, K 8, d 2,048,
// 16 of 64 experts held) that tensor is 537 MB, of which about three
// quarters are masked zeros: a token holds about 2 of its 8 pairs.
//
// What bounds it on the card: bytes.  These kernels read only the held
// pairs' rows and write each output once.
//
// Design:
//   * `gather_sum` (the combine's forward; the dispatch's backward with no
//     scale): one block a token, each thread VEC consecutive elements of
//     the token's row at a time, with 16-byte loads and stores where the
//     pointers are 16-byte aligned and d is a multiple of VEC (element by
//     element, in the same order, otherwise).  The token's pairs are taken
//     in groups of KMAX: the group's held rows are loaded first, then
//     added in k order,
//       y[t] = (((0 + s[t,0] x[row[t,0]]) + s[t,1] x[row[t,1]]) + ...)
//     skipping the pairs that are not held (adding +0.0 to a sum that
//     starts at +0.0 never changes it), each product and add rounded to
//     nearest (`__fmul_rn`, `__fadd_rn`: nothing is contracted into an
//     FMA).  That is the plain version's arithmetic, operation for
//     operation, so the result is bitwise the same.  The output is fp32,
//     or cast to the source's dtype (round to nearest even).
//   * `combine_backward`: blocks [0, T) take one token each: for each held
//     pair k, gg[t,k] = <gy[t], x[row[t,k]]> (fp32 FMAs over the thread's
//     elements, then a warp's shuffles and the warps' sum, in a fixed
//     order; a pair not held gets 0), and the pair's own row of the
//     buffer's gradient, gye[row[t,k]] = cast(gate[t,k] * gy[t]), as the
//     plain version computes it for the row of pair t*K + k.  Blocks past
//     T take ZERO_ROWS rows each and write zeros over the rows r whose pair
//     is not held (valid[pair[r]] false).  So every row is written once,
//     by one block: `row` and `pair` are inverse on the held pairs
//     (row[pair[r]] == r, as `share_plan` makes them), which is what lets
//     the token's block write its pairs' rows.
//   * No atomics and no sum across blocks: the result does not depend on
//     the schedule, so a captured graph's replay is bitwise the eager call.
//   * Rows: a held pair's row past the buffer's R rows is read at R - 1 (the
//     plain version's clamp) and its gradient row is not written; `share_plan`
//     never makes one.  The rows of pairs that are not held (possibly past R)
//     are never read.
//
// Plain C interface (ctypes): each entry point launches one kernel on the
// given stream and returns cudaGetLastError(); nothing synchronises or
// allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;          // consecutive elements a thread takes
constexpr int KMAX = 8;         // a token's pairs loaded before they are summed
constexpr int ZERO_ROWS = 8;    // rows a zero-filling block takes

typedef __nv_bfloat16 bf16;

// VEC elements of S, as loaded: 4 words of bf16 pairs or 8 of fp32
template <typename S>
struct Raw {
  uint32_t w[VEC * sizeof(S) / 4];
};

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits(bf16 x) {
  return uint32_t(__bfloat16_as_ushort(x));
}

// element e (a compile-time index after unrolling) as fp32
template <typename S>
__device__ __forceinline__ float elem(const Raw<S>& r, int e) {
  if constexpr (sizeof(S) == 4) {
    return __uint_as_float(r.w[e]);
  } else {
    const uint32_t w = r.w[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

// VEC elements from p: 16-byte loads when `vec`, else the first n one by
// one and zeros after them
template <typename S>
__device__ __forceinline__ Raw<S> load(const S* p, bool vec, int n) {
  Raw<S> r;
  constexpr int W = VEC * sizeof(S) / 4;
  if (vec) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 a = q[i];
      r.w[4 * i] = a.x;
      r.w[4 * i + 1] = a.y;
      r.w[4 * i + 2] = a.z;
      r.w[4 * i + 3] = a.w;
    }
    return r;
  }
#pragma unroll
  for (int i = 0; i < W; ++i) r.w[i] = 0;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if (e < n) {
      if constexpr (sizeof(S) == 4)
        r.w[e] = bits(p[e]);
      else
        r.w[e >> 1] |= bits(p[e]) << (16 * (e & 1));
    }
  }
  return r;
}

template <typename O> __device__ __forceinline__ O from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// VEC values to p as O: 16-byte stores when `vec`, else the first n
template <typename O>
__device__ __forceinline__ void store(O* p, bool vec, int n,
                                      const float (&x)[VEC]) {
  if (vec) {
    if constexpr (sizeof(O) == 4) {
      float4* d = reinterpret_cast<float4*>(p);
      d[0] = make_float4(x[0], x[1], x[2], x[3]);
      d[1] = make_float4(x[4], x[5], x[6], x[7]);
    } else {
      *reinterpret_cast<uint4*>(p) = make_uint4(
          pack(x[0], x[1]), pack(x[2], x[3]), pack(x[4], x[5]),
          pack(x[6], x[7]));
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    if (e < n) p[e] = from_f<O>(x[e]);
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

struct Plan {
  const long long* row;        // (T, K): each pair's row of the buffer
  const unsigned char* valid;  // (T, K): the pair is held
  long long rows;              // R, the buffer's rows
  int T, K, d;
};

template <typename S, typename O>
__global__ void __launch_bounds__(THREADS)
gather_sum(const S* __restrict__ src, const Plan plan,
           const float* __restrict__ scale, O* __restrict__ out) {
  const long long t = blockIdx.x;
  const int K = plan.K, d = plan.d;
  const long long* row = plan.row + t * K;
  const unsigned char* valid = plan.valid + t * K;
  const bool aligned = aligned16(src) && aligned16(out) && d % VEC == 0;
  for (int c = threadIdx.x * VEC; c < d; c += THREADS * VEC) {
    const int n = d - c < VEC ? d - c : VEC;
    const bool vec = aligned && n == VEC;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += KMAX) {
      bool held[KMAX];
      Raw<S> x[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        held[j] = k0 + j < K && valid[k0 + j];
        if (held[j]) {
          const long long r = min(row[k0 + j], plan.rows - 1);
          x[j] = load(src + r * d + c, vec, n);
        }
      }
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (!held[j]) continue;
        if (scale != nullptr) {
          const float s = scale[t * K + k0 + j];
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[e] = __fadd_rn(acc[e], __fmul_rn(s, elem(x[j], e)));
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[e] = __fadd_rn(acc[e], elem(x[j], e));
        }
      }
    }
    store(out + t * d + c, vec, n, acc);
  }
}

template <typename S>
__device__ __forceinline__ void backward_token(
    const float* __restrict__ gy, const S* __restrict__ src,
    const float* __restrict__ gates, const Plan& plan, S* __restrict__ gye,
    float* __restrict__ gg, long long t) {
  __shared__ float partials[THREADS / 32][KMAX];
  const int K = plan.K, d = plan.d;
  const long long* row = plan.row + t * K;
  const unsigned char* valid = plan.valid + t * K;
  const bool aligned = aligned16(gy) && aligned16(src) && aligned16(gye) &&
                       d % VEC == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k0 = 0; k0 < K; k0 += KMAX) {
    bool held[KMAX], any = false;
    float dot[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      held[j] = k0 + j < K && valid[k0 + j];
      any = any || held[j];
      dot[j] = 0.f;
    }
    for (int c = threadIdx.x * VEC; any && c < d; c += THREADS * VEC) {
      const int n = d - c < VEC ? d - c : VEC;
      const bool vec = aligned && n == VEC;
      const Raw<float> g = load(gy + t * d + c, vec, n);
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (!held[j]) continue;
        const long long r = row[k0 + j];
        const Raw<S> x = load(src + min(r, plan.rows - 1) * d + c, vec, n);
        const float s = gates[t * K + k0 + j];
        float out[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          dot[j] = __fmaf_rn(elem(g, e), elem(x, e), dot[j]);
          out[e] = __fmul_rn(s, elem(g, e));
        }
        if (r < plan.rows) store(gye + r * d + c, vec, n, out);
      }
    }
    // each pair's dot product over the block: a warp's shuffles, then the
    // warps in order
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      float v = dot[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) partials[warp][j] = v;
    }
    __syncthreads();
    if (threadIdx.x < KMAX && k0 + threadIdx.x < K) {
      float s = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) s += partials[w][threadIdx.x];
      gg[t * K + k0 + threadIdx.x] = valid[k0 + threadIdx.x] ? s : 0.f;
    }
    __syncthreads();
  }
}

template <typename S>
__device__ __forceinline__ void zero_rows(const long long* __restrict__ pair,
                                          const Plan& plan,
                                          S* __restrict__ gye, long long b) {
  const int d = plan.d;
  const bool aligned = aligned16(gye) && d % VEC == 0;
  float zero[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) zero[e] = 0.f;
  for (int i = 0; i < ZERO_ROWS; ++i) {
    const long long r = b * ZERO_ROWS + i;
    if (r >= plan.rows) break;
    if (plan.valid[pair[r]]) continue;
    for (int c = threadIdx.x * VEC; c < d; c += THREADS * VEC) {
      const int n = d - c < VEC ? d - c : VEC;
      store(gye + r * d + c, aligned && n == VEC, n, zero);
    }
  }
}

template <typename S>
__global__ void __launch_bounds__(THREADS)
combine_backward(const float* __restrict__ gy, const S* __restrict__ src,
                 const float* __restrict__ gates, const Plan plan,
                 const long long* __restrict__ pair, S* __restrict__ gye,
                 float* __restrict__ gg) {
  if ((long long)blockIdx.x < plan.T)
    backward_token(gy, src, gates, plan, gye, gg, blockIdx.x);
  else
    zero_rows(pair, plan, gye, (long long)blockIdx.x - plan.T);
}

int check_plan(const Plan& p) {
  if (p.T < 1 || p.K < 1 || p.d < 1 || p.rows < 1)
    return int(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// threads a block, elements a thread, pairs loaded together and rows of a
// zero-filling block, for the wrapper to check against its own
void moe_gather_geometry(int* out) {
  out[0] = THREADS;
  out[1] = VEC;
  out[2] = KMAX;
  out[3] = ZERO_ROWS;
}

const char* moe_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (T, d) = sum over k of valid * scale * src[row] (scale null: 1);
// src (rows, d) fp32 or bf16, out fp32 or src's dtype
int moe_gather_sum_launch(const void* src, int src_bf16, long long rows,
                          const long long* row, const unsigned char* valid,
                          const float* scale, int T, int K, int d, void* out,
                          int out_bf16, void* stream) {
  const Plan plan{row, valid, rows, T, K, d};
  if (int err = check_plan(plan)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GATHER(S, O)                                                  \
  gather_sum<S, O><<<T, THREADS, 0, s>>>(static_cast<const S*>(src), \
                                          plan, scale, static_cast<O*>(out))
  if (out_bf16 && !src_bf16) return int(cudaErrorInvalidValue);
  if (src_bf16 && out_bf16)
    GATHER(bf16, bf16);
  else if (src_bf16)
    GATHER(bf16, float);
  else
    GATHER(float, float);
#undef GATHER
  return int(cudaGetLastError());
}

// gg (T, K) fp32 and gye (rows, d) in src's dtype from gy (T, d) fp32
int moe_combine_backward_launch(const float* gy, const void* src,
                                int src_bf16, long long rows,
                                const float* gates, const long long* row,
                                const unsigned char* valid,
                                const long long* pair, int T, int K, int d,
                                void* gye, float* gg, void* stream) {
  const Plan plan{row, valid, rows, T, K, d};
  if (int err = check_plan(plan)) return err;
  const long long blocks = T + (rows + ZERO_ROWS - 1) / ZERO_ROWS;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_bf16)
    combine_backward<bf16><<<unsigned(blocks), THREADS, 0, s>>>(
        gy, static_cast<const bf16*>(src), gates, plan, pair,
        static_cast<bf16*>(gye), gg);
  else
    combine_backward<float><<<unsigned(blocks), THREADS, 0, s>>>(
        gy, static_cast<const float*>(src), gates, plan, pair,
        static_cast<float*>(gye), gg);
  return int(cudaGetLastError());
}

}  // extern "C"
