// AdamW's update over every parameter of a model in two launches, for
// Hopper (built with -gencode arch=compute_90a,code=sm_90a into one
// library, `kernels.nvcc.NVCC_FLAGS`, no fast math).
//
// Replaces no TPU kernel: the reference updates with XLA
// (`repro.train.optimizer`, jitted).  The port's plain version
// (`repro_torch.train.optimizer._plain_update`) is a Python loop over the
// parameters with about a dozen fp32 elementwise kernels each, the global
// norm's per-leaf `x.float() ** 2` temporaries and the train step's
// separate division of the accumulators by the microbatch count: at
// olmo-1b's 1.18 B parameters about 74 ms of a 399 ms step on an H100.
//
// What bounds it on the card: bytes.  A parameter costs 28 B at the train
// configurations' dtypes (bf16 parameter, fp32 gradient and moments): the
// gradient read twice (the norm must be known before the first update),
// the moments read and written, the parameter read and written.  There
// are 0.5 operations a byte.
//
// Design:
//   * Multi-tensor: the parameters are cut into chunks of CHUNK elements;
//     `first_chunk` (the wrapper's `chunk_map`) gives the chunk at which
//     each tensor starts.  The pointers, sizes, dtypes and chunk map are a
//     kernel parameter passed by value (`Tensors`, 11.5 KB of Hopper's
//     32 KB), so a captured CUDA graph replays them with no host copy; a
//     model of more than MAX_TENSORS tensors takes one launch of each kind
//     per MAX_TENSORS.  A grid of a few blocks an SM walks over the chunks
//     (block b takes chunks b, b + grid, ...); a thread takes VEC
//     consecutive elements at a time, with 16-byte loads and stores where
//     the tensor's four pointers are 16-byte aligned (element by element,
//     in the same order, where they are not and at a tensor's ragged end).
//   * `adamw_sumsq` (launch 1): each block sums the squares of its chunks'
//     gradients, each divided by the microbatch count first, into one
//     partial in `partials`.  Squares of fp32 values are exact in fp64 and
//     the sums are fp64: the norm is the correctly rounded fp32 square root
//     of the fp32 rounding of the sum but for ~1e-12 relative, so another
//     exact-in-fp64 reduction (the DTensor route's) gives the same bits.
//     No atomics: the order is fixed and the result does not depend on the
//     schedule, so a graph's replay is bitwise the eager call.
//   * `adamw_update` (launch 2): every block sums the partials in the same
//     fixed order, takes norm = sqrt(fp32(sum)) and clip = min(1,
//     grad_clip / (norm + 1e-9)) (block 0 writes the norm), then updates
//     its chunks in place in the plain version's fp32 arithmetic, operation
//     for operation, each rounded to nearest (`__f*_rn`, so nothing is
//     contracted into an FMA):
//       g = (grad / n_micro) * clip
//       m = b1 * m + (1 - b1) * g;   v = b2 * v + ((1 - b2) * g) * g
//       t = float(step + 1);  bc1 = 1 - powf(b1, t);  bc2 = 1 - powf(b2, t)
//       delta = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p
//       p = cast(p - lr * delta)            (round to nearest even)
//     with grad_clip / x computed as reciprocal(x) * grad_clip, as PyTorch
//     computes a scalar over a tensor, and the division by n_micro an IEEE
//     division (the plain step's `div_` on the card multiplies by the
//     reciprocal of n_micro, which is the same value for n_micro a power of
//     two).  `step` and `lr` are read from device memory.
//   * Dtypes, per tensor: the parameter bf16 or fp32, the moments (m and v
//     alike) fp32 or bf16, the gradient fp32 or bf16 (`kind` bits); each
//     combination is a template instance of the chunk loop.
//
// Plain C interface (ctypes): each entry point launches one kernel on the
// given stream and returns cudaGetLastError(); nothing synchronises or
// allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;               // consecutive elements a thread takes
constexpr int CHUNK = 1 << 16;       // elements a chunk
constexpr int MAX_TENSORS = 256;     // tensors a launch
constexpr int P_BF16 = 1, M_BF16 = 2, G_BF16 = 4;   // `kind` bits

typedef __nv_bfloat16 bf16;

struct Tensors {
  void* p[MAX_TENSORS];
  const void* g[MAX_TENSORS];
  void* m[MAX_TENSORS];
  void* v[MAX_TENSORS];
  long long numel[MAX_TENSORS];
  int first_chunk[MAX_TENSORS + 1];  // the last entry: the chunks in all
  unsigned char kind[MAX_TENSORS];
  int count;
};

struct Hyper {
  float b1, b2, c1, c2;   // c1 = 1 - b1 and c2 = 1 - b2, rounded once
  float eps, wd, grad_clip, n_micro;
};

// the tensor that holds chunk c: the last with first_chunk <= c (a tensor
// of no elements holds no chunk)
__device__ __forceinline__ int tensor_of(const Tensors& t, int c) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (t.first_chunk[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void unpack(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// VEC elements from src as fp32: two 16-byte loads (fp32) or one (bf16)
// when `vec`, else the first n one by one and zeros after them
template <typename T>
__device__ __forceinline__ void load(const T* src, bool vec, int n,
                                     float (&x)[VEC]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      const float4* s = reinterpret_cast<const float4*>(src);
      float4 a = s[0], b = s[1];
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {
      uint4 a = *reinterpret_cast<const uint4*>(src);
      unpack(a.x, x[0], x[1]);
      unpack(a.y, x[2], x[3]);
      unpack(a.z, x[4], x[5]);
      unpack(a.w, x[6], x[7]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) x[k] = k < n ? to_f(src[k]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store(T* dst, bool vec, int n,
                                      const float (&x)[VEC]) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      float4* d = reinterpret_cast<float4*>(dst);
      d[0] = make_float4(x[0], x[1], x[2], x[3]);
      d[1] = make_float4(x[4], x[5], x[6], x[7]);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(
          pack(x[0], x[1]), pack(x[2], x[3]), pack(x[4], x[5]),
          pack(x[6], x[7]));
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (k < n) dst[k] = from_f<T>(x[k]);
}

__device__ __forceinline__ bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

// the sum over the block, in thread 0, in a fixed order
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warps[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += warps[w];
  return s;
}

// the elements [lo, hi) of chunk c's tensor
__device__ __forceinline__ void chunk_range(const Tensors& t, int c, int i,
                                            long long& lo, long long& hi) {
  lo = (long long)(c - t.first_chunk[i]) * CHUNK;
  hi = min(lo + CHUNK, t.numel[i]);
}

template <typename G>
__device__ __forceinline__ void sumsq_chunk(const G* g, long long lo,
                                            long long hi, bool aligned,
                                            float n_micro, double& acc) {
  for (long long e = lo + (long long)threadIdx.x * VEC; e < hi;
       e += (long long)THREADS * VEC) {
    int n = hi - e < VEC ? int(hi - e) : VEC;
    float x[VEC];
    load(g + e, aligned && n == VEC, n, x);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float y = n_micro == 1.f ? x[k] : __fdiv_rn(x[k], n_micro);
      acc += double(y) * double(y);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
adamw_sumsq(const Tensors t, float n_micro, double* partials) {
  double acc = 0.0;
  const int chunks = t.first_chunk[t.count];
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int i = tensor_of(t, c);
    long long lo, hi;
    chunk_range(t, c, i, lo, hi);
    const void* g = t.g[i];
    if (t.kind[i] & G_BF16)
      sumsq_chunk(static_cast<const bf16*>(g), lo, hi, aligned16(g), n_micro,
                  acc);
    else
      sumsq_chunk(static_cast<const float*>(g), lo, hi, aligned16(g),
                  n_micro, acc);
  }
  const double s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

template <typename P, typename M, typename G>
__device__ __forceinline__ void update_chunk(void* pp, const void* gp,
                                             void* mp, void* vp, long long lo,
                                             long long hi, Hyper h,
                                             float clip, float lr, float bc1,
                                             float bc2) {
  P* p = static_cast<P*>(pp);
  const G* g = static_cast<const G*>(gp);
  M* m = static_cast<M*>(mp);
  M* v = static_cast<M*>(vp);
  const bool aligned = aligned16(p) && aligned16(g) && aligned16(m) &&
                       aligned16(v);
  for (long long e = lo + (long long)threadIdx.x * VEC; e < hi;
       e += (long long)THREADS * VEC) {
    const int n = hi - e < VEC ? int(hi - e) : VEC;
    const bool vec = aligned && n == VEC;
    float gx[VEC], mx[VEC], vx[VEC], px[VEC];
    load(g + e, vec, n, gx);
    load(m + e, vec, n, mx);
    load(v + e, vec, n, vx);
    load(p + e, vec, n, px);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float gk = h.n_micro == 1.f ? gx[k] : __fdiv_rn(gx[k], h.n_micro);
      gk = __fmul_rn(gk, clip);
      const float mk = __fadd_rn(__fmul_rn(h.b1, mx[k]),
                                 __fmul_rn(h.c1, gk));
      const float vk = __fadd_rn(__fmul_rn(h.b2, vx[k]),
                                 __fmul_rn(__fmul_rn(h.c2, gk), gk));
      const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vk, bc2)), h.eps);
      const float delta = __fadd_rn(__fdiv_rn(__fdiv_rn(mk, bc1), den),
                                    __fmul_rn(h.wd, px[k]));
      px[k] = __fsub_rn(px[k], __fmul_rn(lr, delta));
      mx[k] = mk;
      vx[k] = vk;
    }
    store(m + e, vec, n, mx);
    store(v + e, vec, n, vx);
    store(p + e, vec, n, px);
  }
}

__global__ void __launch_bounds__(THREADS)
adamw_update(const Tensors t, Hyper h, const double* partials,
             int n_partials, float* norm_out, const int* step,
             const float* lr_ptr) {
  __shared__ float s_clip;
  double part = 0.0;
  for (int i = threadIdx.x; i < n_partials; i += THREADS)
    part += partials[i];
  const double total = block_sum(part);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(__double2float_rn(total));
    const float c =
        __fmul_rn(__frcp_rn(__fadd_rn(norm, 1e-9f)), h.grad_clip);
    s_clip = isnan(c) ? c : fminf(c, 1.f);
    if (norm_out != nullptr && blockIdx.x == 0) *norm_out = norm;
  }
  __syncthreads();
  const float clip = s_clip;
  const float tt = __int2float_rn(*step + 1);
  const float bc1 = __fsub_rn(1.f, powf(h.b1, tt));
  const float bc2 = __fsub_rn(1.f, powf(h.b2, tt));
  const float lr = *lr_ptr;

  const int chunks = t.first_chunk[t.count];
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int i = tensor_of(t, c);
    long long lo, hi;
    chunk_range(t, c, i, lo, hi);
    // the chunk's pointers as values: the kernel parameter is indexed,
    // never passed on by reference
    void* p = t.p[i];
    const void* g = t.g[i];
    void* m = t.m[i];
    void* v = t.v[i];
#define UPDATE(P, M, G) \
  update_chunk<P, M, G>(p, g, m, v, lo, hi, h, clip, lr, bc1, bc2)
    switch (t.kind[i]) {
      case 0:
        UPDATE(float, float, float);
        break;
      case P_BF16:
        UPDATE(bf16, float, float);
        break;
      case M_BF16:
        UPDATE(float, bf16, float);
        break;
      case P_BF16 | M_BF16:
        UPDATE(bf16, bf16, float);
        break;
      case G_BF16:
        UPDATE(float, float, bf16);
        break;
      case P_BF16 | G_BF16:
        UPDATE(bf16, float, bf16);
        break;
      case M_BF16 | G_BF16:
        UPDATE(float, bf16, bf16);
        break;
      default:
        UPDATE(bf16, bf16, bf16);
        break;
    }
#undef UPDATE
  }
}

int fill(Tensors& t, void* const* p, const void* const* g, void* const* m,
         void* const* v, const long long* numel, const int* first_chunk,
         const unsigned char* kind, int count) {
  if (count < 1 || count > MAX_TENSORS) return int(cudaErrorInvalidValue);
  for (int i = 0; i < count; ++i) {
    t.p[i] = p[i];
    t.g[i] = g[i];
    t.m[i] = m[i];
    t.v[i] = v[i];
    t.numel[i] = numel[i];
    t.first_chunk[i] = first_chunk[i];
    t.kind[i] = kind[i];
  }
  t.first_chunk[count] = first_chunk[count];
  t.count = count;
  return 0;
}

}  // namespace

extern "C" {

// threads a block, elements a thread, elements a chunk, tensors a launch
// and the bytes of the tensors' kernel parameter, for the wrapper to check
// against its own
void adamw_geometry(int* out) {
  out[0] = THREADS;
  out[1] = VEC;
  out[2] = CHUNK;
  out[3] = MAX_TENSORS;
  out[4] = int(sizeof(Tensors));
}

const char* adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// launch 1: partials[0, grid) from the gradients of `count` tensors
int adamw_sumsq_launch(void* const* p, const void* const* g, void* const* m,
                       void* const* v, const long long* numel,
                       const int* first_chunk, const unsigned char* kind,
                       int count, float n_micro, double* partials, int grid,
                       void* stream) {
  Tensors t;
  if (int err = fill(t, p, g, m, v, numel, first_chunk, kind, count))
    return err;
  adamw_sumsq<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, n_micro, partials);
  return int(cudaGetLastError());
}

// launch 2: the norm from partials[0, n_partials) (into norm_out unless
// null), then p, m and v of `count` tensors in place
int adamw_update_launch(void* const* p, const void* const* g, void* const* m,
                        void* const* v, const long long* numel,
                        const int* first_chunk, const unsigned char* kind,
                        int count, float b1, float b2, float c1, float c2,
                        float eps, float wd, float grad_clip, float n_micro,
                        const double* partials, int n_partials,
                        float* norm_out, const int* step, const float* lr,
                        int grid, void* stream) {
  Tensors t;
  if (int err = fill(t, p, g, m, v, numel, first_chunk, kind, count))
    return err;
  const Hyper h{b1, b2, c1, c2, eps, wd, grad_clip, n_micro};
  adamw_update<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      t, h, partials, n_partials, norm_out, step, lr);
  return int(cudaGetLastError());
}

}  // extern "C"
