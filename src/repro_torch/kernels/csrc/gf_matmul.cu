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
// (K rows of 4 MiB), and C is M rows of 4 MiB.
//
// What bounds it on the card: operations.  The bytes are (MK + KN + MN),
// about 5 GB for the 960 x 240 x 4 MiB distribute product (1.5 ms at
// 3.35 TB/s); the work is 64 int8 MACs per field product on the tensor
// cores, 6.2e13 MACs there (62.5 ms at 989.5e12 MAC/s).
//
// Design: the bit-matrix form on int8 `wgmma`.  Multiplying by a in GF(2^8)
// is GF(2)-linear, so with
//   T[8m+i, 8k+j] = bit i of (A[m,k] . x^j)        (8M x 8K, 0/1)
//   Bbits[8k+j, n] = bit j of B[k,n]                (8K x N, 0/1)
// bit i of C[m,n] is the parity of (T . Bbits)[8m+i, n].  The counts are at
// most 8K, exact in s32; no plane fold is needed.  The kernel computes the
// transposed product C^T (N x 8M) = Bbits^T . T^T with
// `wgmma.mma_async.m64n64k32.s32.s8.s8`:
//   * wgmma's 64-row M walks payload columns; its N = 64 is a band of 64
//     output bits (8 rows of A); its 32-deep K is 4 payload rows x 8 bits.
//   * T is the K-major B operand.  Each block computes its band of T from
//     A in its prologue (x^j by shift-and-reduce, no table) straight into
//     shared memory, as 8 x 16-byte core matrices, no swizzle: the band
//     stays resident while the block walks its payload tiles, for K up to
//     kChunkRows rows (else it is restaged per tile in chunks).
//   * The payload bits are expanded in registers only, never in memory: the
//     A operand comes from registers, where each 32-bit fragment register
//     holds 4 consecutive depth values = 4 bits (a nibble) of one payload
//     byte, spread by nib * 0x00204081 (bit 0 of each byte is the value;
//     the higher bits only add even amounts to the count).  The depth order
//     of a step is chosen so that a thread's 8 depth values of a wgmma row
//     are the two nibbles of one payload byte: thread t of a quad reads
//     payload row 4s + t only.
//   * A thread loads 8 payload bytes of a row at once: wgmma rows r and
//     r + 8 of sub-tile q (q = 0..3) are payload columns c + q and c + 4 + q
//     for the thread's column c, so one 64-bit load feeds both of its rows
//     in all 4 sub-tiles (4 accumulators of 32 registers), and the 8 output
//     bytes of an A row come out as one 64-bit store.
//   * The payload streams through a ring of kAhead steps in shared memory:
//     each thread cp.asyncs its own 8 bytes of a step kAhead steps ahead,
//     running on across the block's tiles, so no tile starts cold.  The
//     fragment registers of step s+1 are built (all before the fence) while
//     step s's wgmmas run (wait_group 1).
//   * Epilogue: the 8 bits of an output byte sit in one thread quad (2
//     accumulator columns each); two __shfl_xor and ORs assemble the byte.
//   * Two warpgroups per block (512 payload columns a tile), one block per
//     SM.  Grid (splits, bands), started in waves in grid order; the wrapper
//     picks the splits that fill whole waves.  The splits of a band walk
//     interleaved tiles (x, x + splits, ...), so the blocks of a wave read
//     the same stretch of payload at once and L2 serves it after the first
//     read.
//   * Ragged shapes: rows of A past M and depth past K are zero in T, payload
//     rows at or past K and columns at or past N are never read, and only
//     rows < M and columns < N are written.  When N is not a multiple of 8 or
//     B or C is not 8-byte aligned, the byte-wise variant is launched.
//   * Offsets are 64-bit: the distribute output is about 4.0e9 bytes.
//
// The launch geometry (bands, splits, padded K, chunk rows, variant) is
// computed by the Python wrapper (kernels/gf_matmul.py::launch_plan) and
// checked here.  The launcher allocates nothing, runs on the caller's stream
// and current device and returns the launch's cudaError_t; the wrapper
// raises on a nonzero value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBandRows = 8;                       // A rows per band
constexpr int kBandBits = 8 * kBandRows;           // 64 output bits: wgmma N
constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kSub = 4;                            // sub-tiles = bytes of a word
constexpr int kWgCols = 64 * kSub;                 // payload columns per warpgroup
constexpr int kTileCols = kWgCols * kWarpgroups;   // 512 per block and tile
constexpr int kStepRows = 4;                       // payload rows per 32-deep step
constexpr int kUnroll = 4;                         // steps per unrolled loop body
constexpr int kPadRows = kStepRows * kUnroll;      // K is padded to a multiple of 16
constexpr int kAhead = 16;                         // payload steps in flight (a power of 2)
constexpr int kRingBytes = kAhead * kThreads * 8;  // 32 KiB
constexpr int kChunkRows = 384;                    // payload rows of T staged at once
constexpr int kCoreBytes = 128;                    // 8 rows x 16 bytes
constexpr int kDepthStride = kBandRows * kCoreBytes;  // next 16 depth bytes (LBO)
constexpr int kSmemPerRow = 8 * kBandBits;         // T bytes per payload row
constexpr int kMaxSmem = kSmemPerRow * kChunkRows + kRingBytes;  // 229,376 bytes
constexpr int64_t kMaxGrid = 65535;

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Keeps the compiler from moving reads of a wgmma register across a wait.
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Shared-memory matrix descriptor: K-major, no swizzle; LBO = the next 16
// depth bytes, SBO = the next 8 rows of the band.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>(kDepthStride >> 4) << 16)
       | (static_cast<uint64_t>(kCoreBytes >> 4) << 32);
}

// d (64 x 64 s32, registers) += a (64 x 32 s8, registers) . b (32 x 64 s8,
// shared memory, K-major).
__device__ __forceinline__ void wgmma_m64n64k32(uint32_t (&d)[32], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}

// Byte q of x (bits 0..3 only, the rest zero) spread one bit to a byte:
// bit 0 of byte j = bit j.  The higher bits of each byte are left as they
// fall: only the parity of the sum is read, and a byte's higher bits add
// even amounts to it.  The four terms of the product never overlap, so no
// carry reaches a bit 0.
__device__ __forceinline__ uint32_t spread_nibble(uint32_t x, int q) {
  return __byte_perm(x, 0u, 0x4440u | q) * 0x00204081u;
}

// Writes rows [kbeg, kbeg + rows) of the band's T into shared memory.  A
// 32-deep step holds payload rows 4s..4s+3: its first 16 depth bytes are
// their low nibbles (bits 0..3 of row 4s + r at bytes 4r..4r+3), its last 16
// their high nibbles.  The 16-byte core row of band row 8*ml + i and depth
// chunk c lies at c * kDepthStride + ml * kCoreBytes + 16 * i.  Thread
// neighbours take neighbouring i.
__device__ void stage_band(uint8_t* smem, const uint8_t* __restrict__ A,
                           int64_t M, int64_t K, int64_t m0, int64_t kbeg,
                           int rows) {
  for (int idx = threadIdx.x; idx < 64 * rows; idx += kThreads) {
    const int i = idx & 7;
    const int ml = (idx >> 3) & 7;
    const int kk = idx >> 6;
    const int64_t m = m0 + ml;
    const int64_t k = kbeg + kk;
    uint32_t v = (m < M && k < K) ? A[m * K + k] : 0u;
    uint32_t lo = 0, hi = 0;  // byte j of (hi:lo) = bit i of a . x^j
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t bit = (v >> i) & 1u;
      if (j < 4) lo |= bit << (8 * j);
      else hi |= bit << (8 * (j - 4));
      v = ((v << 1) & 0xFFu) ^ ((v & 0x80u) ? 0x1Du : 0u);
    }
    uint8_t* dst = smem + 2 * (kk >> 2) * kDepthStride + ml * kCoreBytes + 16 * i
                 + 4 * (kk & 3);
    *reinterpret_cast<uint32_t*>(dst) = lo;
    *reinterpret_cast<uint32_t*>(dst + kDepthStride) = hi;
  }
}

// Payload row k at the thread's 8 columns col..col+7, byte by byte (row
// points at column col of row k): the low word feeds wgmma row r1, the high
// word row r1 + 8.  The 8-byte variant copies them with cp.async instead.
__device__ __forceinline__ void load_bytes(uint32_t& lo, uint32_t& hi,
                                           const uint8_t* __restrict__ row, bool live,
                                           int64_t col, int64_t N) {
  lo = hi = 0u;
  if (!live) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (col + q < N) lo |= static_cast<uint32_t>(__ldg(row + q)) << (8 * q);
    if (col + 4 + q < N) hi |= static_cast<uint32_t>(__ldg(row + 4 + q)) << (8 * q);
  }
}

template <bool kVec>
__device__ __forceinline__ void store_pair(uint8_t* __restrict__ row, int64_t col,
                                           int64_t N, uint32_t lo, uint32_t hi) {
  if (kVec) {
    if (col < N) *reinterpret_cast<uint2*>(row + col) = make_uint2(lo, hi);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (col + q < N) row[col + q] = static_cast<uint8_t>(lo >> (8 * q));
      if (col + 4 + q < N) row[col + 4 + q] = static_cast<uint8_t>(hi >> (8 * q));
    }
  }
}

// The payload ring: each thread copies the 8 bytes it will consume kAhead
// steps later (payload row k at its 8 columns) into its own slot, with
// cp.async (zero-filled past K or N).  Only the thread that wrote a slot
// reads it, so no barrier is needed: cp.async.wait_group orders it.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Where the thread's payload loads stand: step `step` of tile `tile`, that
// is payload row k, with p at column col of row k; `live` says the tile
// exists and col < N.
struct Cursor {
  int64_t tile, col, k;
  const uint8_t* p;
  int step;
  bool live;
};

__device__ __forceinline__ void cursor_at(Cursor& c, const uint8_t* B, int64_t tile,
                                          int64_t col_in_tile, int64_t krow, int64_t N,
                                          int64_t n_tiles) {
  c.tile = tile;
  c.col = tile * kTileCols + col_in_tile;
  c.k = krow;
  c.p = B + krow * N + c.col;
  c.step = 0;
  c.live = tile < n_tiles && c.col < N;
}

// Fills ring slot `slot` with the cursor's step, then moves the cursor on
// by one step (to the next tile of the block after the last step).
template <bool kVec>
__device__ __forceinline__ void fetch_step(Cursor& c, uint32_t ring, int slot,
                                           const uint8_t* __restrict__ B, int64_t K,
                                           int64_t N, int64_t n_tiles, int steps,
                                           int64_t col_in_tile, int64_t krow) {
  const uint32_t dst = ring + (slot * kThreads + threadIdx.x) * 8;
  const bool live = c.live && c.k < K;
  if (kVec) {
    cp_async8(dst, c.p, live);
  } else {
    uint32_t lo, hi;
    load_bytes(lo, hi, c.p, live, c.col, N);
    asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(dst), "r"(lo), "r"(hi)
                 : "memory");
  }
  cp_async_commit();
  if (++c.step == steps) {
    cursor_at(c, B, c.tile + gridDim.x, col_in_tile, krow, N, n_tiles);
  } else {
    c.k += kStepRows;
    c.p += kStepRows * N;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
gf256_bitmatrix_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
                       uint8_t* __restrict__ C, int64_t M, int64_t K, int64_t N,
                       int k_pad, int k_chunk) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int64_t krow = t;            // payload row within a step
  // wgmma rows r1 = 16 * warp + lane / 4 and r1 + 8 of sub-tile q take
  // payload columns col + q and col + 4 + q
  const int64_t col_in_tile = wg * kWgCols + 64 * warp + 8 * (lane >> 2);
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBandRows;
  const int n_chunks = (k_pad + k_chunk - 1) / k_chunk;
  const int steps = k_pad / kStepRows;  // per tile, a multiple of kUnroll
  const int64_t n_tiles = (N + kTileCols - 1) / kTileCols;
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t ring = sbase + kSmemPerRow * k_chunk;

  Cursor cur;
  cursor_at(cur, B, blockIdx.x, col_in_tile, krow, N, n_tiles);
#pragma unroll 1
  for (int g = 0; g < kAhead; ++g)
    fetch_step<kVec>(cur, ring, g, B, K, N, n_tiles, steps, col_in_tile, krow);
  if (n_chunks == 1) {
    stage_band(smem, A, M, K, m0, 0, k_pad);
    fence_proxy_async();
    __syncthreads();
  }

  uint32_t gstep = 0;  // steps consumed so far; the ring is kAhead ahead
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t col = tile * kTileCols + col_in_tile;
    uint32_t acc[kSub][32];
#pragma unroll
    for (int q = 0; q < kSub; ++q) {
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[q][x] = 0u;
    }

    for (int ch = 0; ch < n_chunks; ++ch) {
      const int64_t kbeg = static_cast<int64_t>(ch) * k_chunk;
      const int rows = static_cast<int>(k_pad - kbeg < k_chunk ? k_pad - kbeg : k_chunk);
      if (n_chunks > 1) {
        __syncthreads();  // every warpgroup is done with the previous chunk
        stage_band(smem, A, M, K, m0, kbeg, rows);
        fence_proxy_async();
        __syncthreads();
      }
      for (int s0 = 0; s0 < rows / kStepRows; s0 += kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int slot = static_cast<int>(gstep & (kAhead - 1u));
          cp_async_wait<kAhead - 1>();
          uint32_t lo, hi;  // payload row k at columns col..col+3 and col+4..col+7
          asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                       : "=r"(lo), "=r"(hi)
                       : "r"(ring + (slot * kThreads + threadIdx.x) * 8)
                       : "memory");
          // registers 0 and 1 take the low nibbles (depth 4t..4t+3 of rows
          // r1 and r1 + 8), registers 2 and 3 the high ones (depth 16+4t..)
          const uint32_t nibs[4] = {lo & 0x0F0F0F0Fu, hi & 0x0F0F0F0Fu,
                                    (lo >> 4) & 0x0F0F0F0Fu, (hi >> 4) & 0x0F0F0F0Fu};
          uint32_t a[kSub][4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
#pragma unroll
            for (int q = 0; q < kSub; ++q) a[q][x] = spread_nibble(nibs[x], q);
          }
#pragma unroll
          for (int q = 0; q < kSub; ++q) {  // built before the fence, not between wgmmas
#pragma unroll
            for (int x = 0; x < 4; ++x) fence_reg(a[q][x]);
          }
          // the slot was read into a[]: refill it with the step kAhead on
          fetch_step<kVec>(cur, ring, slot, B, K, N, n_tiles, steps, col_in_tile, krow);
          ++gstep;
          const uint64_t desc = smem_desc(sbase + (s0 + u) * 2 * kDepthStride);
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < kSub; ++q)
            wgmma_m64n64k32(acc[q], a[q][0], a[q][1], a[q][2], a[q][3], desc);
          wgmma_commit();
          wgmma_wait<1>();
        }
      }
      wgmma_wait<0>();
    }
#pragma unroll
    for (int q = 0; q < kSub; ++q) {
#pragma unroll
      for (int x = 0; x < 32; ++x) fence_reg(acc[q][x]);
    }

    // Accumulator x of sub-tile q: wgmma row r1 + 8 * ((x >> 1) & 1), output
    // bit column 8 * (x >> 2) + 2t + (x & 1), i.e. bit 2t + (x & 1) of
    // A row m0 + (x >> 2).
#pragma unroll
    for (int c = 0; c < kBandRows; ++c) {
      uint32_t o1 = 0, o2 = 0;
#pragma unroll
      for (int q = 0; q < kSub; ++q) {
        o1 |= (((acc[q][4 * c] & 1u) | ((acc[q][4 * c + 1] & 1u) << 1)) << (2 * t)) << (8 * q);
        o2 |= (((acc[q][4 * c + 2] & 1u) | ((acc[q][4 * c + 3] & 1u) << 1)) << (2 * t)) << (8 * q);
      }
      o1 |= __shfl_xor_sync(0xFFFFFFFFu, o1, 1);
      o1 |= __shfl_xor_sync(0xFFFFFFFFu, o1, 2);
      o2 |= __shfl_xor_sync(0xFFFFFFFFu, o2, 1);
      o2 |= __shfl_xor_sync(0xFFFFFFFFu, o2, 2);
      const int64_t m = m0 + c;
      if ((c >> 1) == t && m < M) {
        store_pair<kVec>(C + m * N, col, N, o1, o2);
      }
    }
  }
  cp_async_wait<0>();  // no copy is left in flight into freed shared memory
}

bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

}  // namespace

// Lets both variants use kMaxSmem bytes of dynamic shared memory (more than
// the default 48 KiB) on the current device.  Called once per device before
// its first launch.
extern "C" int gf256_init() {
  cudaError_t err = cudaFuncSetAttribute(gf256_bitmatrix_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(gf256_bitmatrix_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return static_cast<int>(err);
}

// The tile constants the Python launch plan must agree with: {band rows,
// tile columns, K padding, chunk rows, shared bytes per row, ring bytes}.
extern "C" void gf256_geometry(int* out) {
  out[0] = kBandRows;
  out[1] = kTileCols;
  out[2] = kPadRows;
  out[3] = kChunkRows;
  out[4] = kSmemPerRow;
  out[5] = kRingBytes;
}

// Launches the bit-matrix kernel on the current device, which must hold A,
// B and C, with the geometry of kernels/gf_matmul.py::launch_plan.
extern "C" int gf256_matmul_launch(const void* A, const void* B, void* C, long long M,
                                   long long K, long long N, int k_pad, int k_chunk,
                                   long long bands, long long splits, int vec,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || k_pad < K || k_pad < kPadRows || k_pad % kPadRows
      || k_chunk != (k_pad < kChunkRows ? k_pad : kChunkRows)
      || bands != (M + kBandRows - 1) / kBandRows || bands > kMaxGrid || splits < 1
      || splits > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && !(N % 8 == 0 && aligned8(B) && aligned8(C)))
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const uint8_t*, const uint8_t*, uint8_t*, int64_t, int64_t, int64_t,
                 int, int) =
      vec ? gf256_bitmatrix_kernel<true> : gf256_bitmatrix_kernel<false>;
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(bands));
  kernel<<<grid, kThreads, kSmemPerRow * k_chunk + kRingBytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(A), static_cast<const uint8_t*>(B),
      static_cast<uint8_t*>(C), M, K, N, k_pad, k_chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gf256_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
