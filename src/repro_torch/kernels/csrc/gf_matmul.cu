// GF(2^8) matrix product C = A . B over the field mod x^8+x^4+x^3+x^2+1
// (0x11D), for Hopper (built with -gencode arch=compute_90a,code=sm_90a).
//
// Replaces the TPU kernel `_gf_matmul_kernel`, launched by
// `gf_matmul_pallas` (src/repro/kernels/gf_matmul.py).  That kernel splits
// both operands into one-bit planes and runs 64 int8 plane products on the
// MXU, carrying a 15-plane int32 sum across sequential K grid steps.
//
// Shapes on the main path are short and very wide: A is a coefficient
// matrix (M <= 960 rows, K between about 2 and 240), B is the payload
// (K rows of 4 MiB), and C is M rows of 4 MiB.  The TPU blocking (128, 128,
// 512) would pad K up to 512 and M up to 128, up to 100-fold more work, so
// it is not carried over.
//
// What bounds it on the card: operations.  The bytes are (MK + KN + MN),
// about 5 GB for the 960 x 240 x 4 MiB distribute product (1.5 ms at
// 3.35 TB/s), while the products number M*K*N, about 1e12 byte products.
// Here each one is a lookup in a 256 x 256 product table held in shared
// memory, so the kernel is bound by shared-memory lookups and integer
// issue, far from the bit-plane tensor-core bound (64 int8 MACs a product).
// A bit-plane wgmma design is later work.
//
// Design:
//   * Each block stages the full product table (64 KiB, mul[a][b]) in
//     dynamic shared memory.  mul[0][x] = mul[x][0] = 0, so a zero operand
//     needs no mask and no log(0) sentinel.
//   * A block owns kTileM rows of A and kTileN = 4096 columns of B and C.
//     Each thread owns 16 neighbouring columns: one 16-byte load of B per
//     K step, one 16-byte store of C per row, neighbouring threads on
//     neighbouring bytes.
//   * K is looped over inside the block (the TPU carried its sum across
//     grid steps; Hopper blocks cannot), with kTileM x kTileK bytes of A
//     staged in shared memory per pass.  The sum is XOR-accumulated in
//     registers, four bytes to a 32-bit word.  No block reduces across
//     another.
//   * Ragged M, K and N are masked in the kernel; nothing is padded.  When
//     N is not a multiple of 16 (or B or C is not 16-byte aligned) the
//     byte-wise variant is launched instead of the 16-byte one.
//   * blockIdx.x walks the row tiles, so the blocks in flight together share
//     one column tile of B, which L2 then serves to all of them.
//   * Offsets are 64-bit: the distribute output is about 4.0e9 bytes.
//
// The launcher allocates nothing, runs on the caller's stream and current
// device (the Python wrapper selects A's device) and returns the launch's
// cudaError_t; the wrapper raises on a nonzero value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytesPerThread = 16;
constexpr int kTileN = kThreads * kBytesPerThread;  // 4096 columns per block
constexpr int kTileM = 8;                           // rows per block
constexpr int kTileK = 256;                         // A columns per pass
constexpr int kTableBytes = 256 * 256;
constexpr int kSmemBytes = kTableBytes + kTileM * kTileK;
constexpr int64_t kMaxGridY = 65535;

template <bool kVec>
__device__ __forceinline__ void load_b(const uint8_t* __restrict__ row,
                                       int64_t n0, int64_t N, uint32_t (&w)[4]) {
  if (kVec) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + n0);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t x = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t n = n0 + 4 * q + j;
        if (n < N) x |= static_cast<uint32_t>(row[n]) << (8 * j);
      }
      w[q] = x;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gf256_matmul_kernel(const uint8_t* __restrict__ A,
                    const uint8_t* __restrict__ B,
                    uint8_t* __restrict__ C,
                    const uint8_t* __restrict__ table,
                    int64_t M, int64_t K, int64_t N) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* mul = smem;                   // mul[a * 256 + b] = a . b
  uint8_t* a_tile = smem + kTableBytes;  // a_tile[r * kTileK + kk]

  const uint4* tsrc = reinterpret_cast<const uint4*>(table);
  uint4* tdst = reinterpret_cast<uint4*>(mul);
  for (int i = threadIdx.x; i < kTableBytes / 16; i += kThreads) tdst[i] = tsrc[i];

  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kTileM;
  const int64_t n_tiles = (N + kTileN - 1) / kTileN;

  for (int64_t tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int64_t n0 = tile * kTileN + static_cast<int64_t>(threadIdx.x) * kBytesPerThread;
    const bool live = n0 < N;
    uint32_t acc[kTileM][4];
#pragma unroll
    for (int r = 0; r < kTileM; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0;
    }

    for (int64_t k0 = 0; k0 < K; k0 += kTileK) {
      const int kc = static_cast<int>(K - k0 < kTileK ? K - k0 : kTileK);
      __syncthreads();  // the previous pass is done with a_tile (and the table is staged)
      for (int i = threadIdx.x; i < kTileM * kTileK; i += kThreads) {
        const int r = i / kTileK;
        const int kk = i - r * kTileK;
        const int64_t m = m0 + r;
        a_tile[i] = (m < M && kk < kc) ? A[m * K + k0 + kk] : 0;
      }
      __syncthreads();
      if (live) {
        for (int kk = 0; kk < kc; ++kk) {
          uint32_t bw[4];
          load_b<kVec>(B + (k0 + kk) * N, n0, N, bw);
#pragma unroll
          for (int r = 0; r < kTileM; ++r) {
            const uint8_t* row = mul + 256 * static_cast<uint32_t>(a_tile[r * kTileK + kk]);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const uint32_t x = bw[q];
              acc[r][q] ^= static_cast<uint32_t>(row[x & 0xff])
                         | (static_cast<uint32_t>(row[(x >> 8) & 0xff]) << 8)
                         | (static_cast<uint32_t>(row[(x >> 16) & 0xff]) << 16)
                         | (static_cast<uint32_t>(row[x >> 24]) << 24);
            }
          }
        }
      }
    }

    if (live) {
#pragma unroll
      for (int r = 0; r < kTileM; ++r) {
        const int64_t m = m0 + r;
        if (m >= M) break;
        uint8_t* out = C + m * N;
        if (kVec) {
          *reinterpret_cast<uint4*>(out + n0) =
              make_uint4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        } else {
#pragma unroll
          for (int j = 0; j < kBytesPerThread; ++j) {
            if (n0 + j < N) out[n0 + j] = static_cast<uint8_t>(acc[r][j / 4] >> (8 * (j % 4)));
          }
        }
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Lets both variants use kSmemBytes of dynamic shared memory (more than the
// default 48 KiB) on the current device.  Called once per device before its
// first launch.
extern "C" int gf256_init() {
  cudaError_t err = cudaFuncSetAttribute(gf256_matmul_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(gf256_matmul_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  return static_cast<int>(err);
}

// Launches on the current device, which must hold A, B, C and the table.
extern "C" int gf256_matmul_launch(const void* A, const void* B, void* C,
                                   const void* table, long long M, long long K,
                                   long long N, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (N % kBytesPerThread == 0) && aligned16(B) && aligned16(C);
  void (*kernel)(const uint8_t*, const uint8_t*, uint8_t*, const uint8_t*,
                 int64_t, int64_t, int64_t) =
      vec ? gf256_matmul_kernel<true> : gf256_matmul_kernel<false>;
  const int64_t m_tiles = (M + kTileM - 1) / kTileM;
  const int64_t n_tiles = (N + kTileN - 1) / kTileN;
  if (m_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(m_tiles),
                  static_cast<unsigned>(n_tiles < kMaxGridY ? n_tiles : kMaxGridY));
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(A), static_cast<const uint8_t*>(B),
      static_cast<uint8_t*>(C), static_cast<const uint8_t*>(table), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gf256_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
