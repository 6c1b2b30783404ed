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
//     the variant's chunk rows (else it is restaged per tile in chunks).
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
//     rows at or past K are never read, and only rows < M and columns < N
//     are written.
//   * Offsets are 64-bit: the distribute output is about 4.0e9 bytes.
//
// Two variants share all of the above and differ in how they move bytes:
//   * aligned (N % 8 == 0, B and C 8-byte aligned): a thread's 8 payload
//     bytes are one aligned word, cp.async'd into an 8-byte slot, and its 8
//     output bytes of an A row are one aligned 64-bit store.
//   * shifted (any N, any base): a checkpoint's block is ceil(payload / M)
//     bytes, odd at every model, and then a row's 8 bytes at column col
//     start at p = B + k*N + col with r = p & 7 != 0.  TMA cannot take such
//     rows (its row stride must be a multiple of 16 bytes), and padding B
//     and C to whole words would copy tens of GB.  So the thread cp.asyncs
//     the two aligned words at p - r and p - r + 8 into a 16-byte slot (the
//     copy's size clamped at B's end, zero-filling the rest) and funnel-
//     shifts its 8 bytes out by 8r when it reads the slot.  r depends only
//     on the row: it is (B + krow * N) & 7 at even steps of a tile and that
//     xor 4 (N odd) at odd ones, so it is two registers.  Bytes past column
//     N are the next row's; they only feed columns that are never stored.
//     On output, a row of C starts at (C + m*N) & 7, another offset for
//     every row, so each warpgroup stages its 8 rows x 256 columns in
//     shared memory and writes each row as a head of single bytes up to an
//     8-byte boundary, aligned 64-bit words (neighbouring lanes on
//     neighbouring words) and a tail of single bytes; a named barrier per
//     warpgroup orders the staging and the stores.  The 16-byte slots
//     double the ring, so this variant stages fewer rows of T at once.
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
constexpr int kCoreBytes = 128;                    // 8 rows x 16 bytes
constexpr int kDepthStride = kBandRows * kCoreBytes;  // next 16 depth bytes (LBO)
constexpr int kSmemPerRow = 8 * kBandBits;         // T bytes per payload row
constexpr int kSmemLimit = 232448;                 // dynamic shared memory a block may use
constexpr int64_t kMaxGrid = 65535;

// The variants (see the header): payload steps in flight (a power of 2),
// ring bytes a thread and step, payload rows of T staged at once, and the
// output staging.
constexpr int kAligned = 0;
constexpr int kAlignedAhead = 16;
constexpr int kAlignedSlot = 8;
constexpr int kAlignedChunkRows = 384;
constexpr int kShifted = 1;
constexpr int kShiftedAhead = 16;
constexpr int kShiftedSlot = 16;
constexpr int kShiftedChunkRows = 304;
constexpr int kStageBytes = kBandRows * kTileCols;  // 4 KiB: a tile's output rows

template <int kVariant>
struct Variant {
  static constexpr bool kShift = kVariant == kShifted;
  static constexpr int kAhead = kShift ? kShiftedAhead : kAlignedAhead;
  static constexpr int kSlot = kShift ? kShiftedSlot : kAlignedSlot;
  static constexpr int kChunkRows = kShift ? kShiftedChunkRows : kAlignedChunkRows;
  static constexpr int kRingBytes = kAhead * kThreads * kSlot;
  static constexpr int kStage = kShift ? kStageBytes : 0;
  static constexpr int kMaxSmem = kSmemPerRow * kChunkRows + kRingBytes + kStage;
  static_assert((kAhead & (kAhead - 1)) == 0, "the ring's steps are a power of 2");
  static_assert(kChunkRows % kPadRows == 0, "a chunk holds whole unrolled steps");
  static_assert(kMaxSmem <= kSmemLimit, "over the block's shared memory");
};

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

// Bytes r..r+7 (r in 0..7) of the 16 little-endian bytes x0..x3, as the
// low and high words of a uint2.
__device__ __forceinline__ uint2 window8(uint32_t x0, uint32_t x1, uint32_t x2,
                                         uint32_t x3, int r) {
  const bool up = r & 4;
  const uint32_t y0 = up ? x1 : x0, y1 = up ? x2 : x1, y2 = up ? x3 : x2;
  return make_uint2(__funnelshift_r(y0, y1, 8 * r), __funnelshift_r(y1, y2, 8 * r));
}

// The payload ring: each thread copies the bytes it will consume kAhead
// steps later (payload row k at its 8 columns) into its own slot, with
// cp.async (zero-filled past the `bytes` it is given).  Only the thread that
// wrote a slot reads it, so no barrier is needed: cp.async.wait_group orders
// it.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ int clamp8(int64_t bytes) {
  return bytes < 0 ? 0 : bytes > 8 ? 8 : static_cast<int>(bytes);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Where the thread's payload loads stand: step `step` of tile `tile`, that
// is payload row k, with p at column col of row k (the shifted variant: at
// the aligned word that holds it); `live` says the tile exists and col < N.
struct Cursor {
  int64_t tile, col, k;
  const uint8_t* p;
  int step;
  bool live;
};

// The shifted variant's per-thread constants.  Row krow + 4s is read at
// even and odd steps s of a tile, so the thread's 8 bytes sit r_even or
// r_odd bytes into the aligned word it copies, and that word moves on by
// d_even or d_odd bytes a step.  A 16-byte copy from payload row k_near on
// may pass `end`, one past B's last byte, and is clamped there.
struct Shift {
  int r_even, r_odd;
  int64_t d_even, d_odd, k_near;
  const uint8_t* end;
};

__device__ __forceinline__ void cursor_at(Cursor& c, const uint8_t* B, int64_t tile,
                                          int64_t col_in_tile, int64_t krow, int64_t N,
                                          int64_t n_tiles, int back) {
  c.tile = tile;
  c.col = tile * kTileCols + col_in_tile;
  c.k = krow;
  c.p = B + krow * N + c.col - back;
  c.step = 0;
  c.live = tile < n_tiles && c.col < N;
}

// Fills ring slot `slot` with the cursor's step (even or odd in its tile, as
// `odd` says), then moves the cursor on by one step (to the next tile of the
// block after the last step).  The shifted variant copies the two aligned
// words from c.p on, never past B's last byte.
template <int kVariant>
__device__ __forceinline__ void fetch_step(Cursor& c, uint32_t ring, int slot,
                                           const uint8_t* __restrict__ B, int64_t K,
                                           int64_t N, int64_t n_tiles, int steps,
                                           int64_t col_in_tile, int64_t krow,
                                           const Shift& sh, bool odd) {
  using V = Variant<kVariant>;
  const uint32_t dst = ring + (slot * kThreads + threadIdx.x) * V::kSlot;
  const bool live = c.live && c.k < K;
  if constexpr (V::kShift) {
    int n0 = live ? 8 : 0, n1 = n0;
    if (live && c.k >= sh.k_near) {
      const int64_t left = sh.end - c.p;
      n0 = clamp8(left);
      n1 = clamp8(left - 8);
    }
    cp_async8(dst, c.p, n0);
    cp_async8(dst + 8, c.p + 8, n1);
  } else {
    cp_async8(dst, c.p, live ? 8 : 0);
  }
  cp_async_commit();
  if (++c.step == steps) {
    cursor_at(c, B, c.tile + gridDim.x, col_in_tile, krow, N, n_tiles,
              V::kShift ? sh.r_even : 0);
  } else {
    c.k += kStepRows;
    if constexpr (V::kShift) c.p += odd ? sh.d_odd : sh.d_even;
    else c.p += kStepRows * N;
  }
}

// Orders the shared memory of one warpgroup's 128 threads (named barrier
// 1 + wg; barrier 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// The shifted variant's stores.  A warpgroup's staged 8 rows x kWgCols
// columns (row stride kWgCols) go to C at column col0 < N, a multiple of
// 8, so where a row's first 8-byte boundary falls is fixed over the tiles.
// Each row is a head of single bytes up to that boundary, aligned words and
// a tail of single bytes.  A thread stores word `lane` of rows warp and
// warp + 4 and one head or tail byte, b of row tid / 16: `rows` holds those
// three rows' starts in C (null past M) and their head bytes at a whole
// tile.
struct Rows {
  uint8_t* at[3];
  int head[3];
};

__device__ __forceinline__ void rows_at(Rows& rw, uint8_t* C, int64_t M, int64_t N,
                                        int64_t m0, int warp, int tid) {
  const int row[3] = {warp, warp + 4, tid >> 4};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int64_t m = m0 + row[i];
    rw.at[i] = m < M ? C + m * N : nullptr;
    rw.head[i] = static_cast<int>((0u - reinterpret_cast<uintptr_t>(C + m * N)) & 7);
  }
}

__device__ __forceinline__ void store_staged(const Rows& rw, const uint8_t* stage,
                                             int64_t N, int64_t col0, int warp,
                                             int lane, int tid) {
  const int len = static_cast<int>(N - col0 < kWgCols ? N - col0 : kWgCols);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rw.at[i] == nullptr) continue;
    const int h = rw.head[i];
    const int head = h < len ? h : len;
    if (lane < (len - head) >> 3) {
      const uint8_t* s = stage + (warp + 4 * i) * kWgCols + 8 * lane;
      const uint2 x = *reinterpret_cast<const uint2*>(s);
      const uint2 y = h ? *reinterpret_cast<const uint2*>(s + 8) : make_uint2(0u, 0u);
      *reinterpret_cast<uint2*>(rw.at[i] + col0 + head + 8 * lane) =
          window8(x.x, x.y, y.x, y.y, h);
    }
  }
  if (rw.at[2] != nullptr) {
    const int b = tid & 15;
    const int head = rw.head[2] < len ? rw.head[2] : len;
    const int tail = head + 8 * ((len - head) >> 3);
    const int off = b < head ? b : tail + (b - head);
    if (off < len) rw.at[2][col0 + off] = stage[(tid >> 4) * kWgCols + off];
  }
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads, 1)
gf256_bitmatrix_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
                       uint8_t* __restrict__ C, int64_t M, int64_t K, int64_t N,
                       int k_pad, int k_chunk) {
  using V = Variant<kVariant>;
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
  // the shifted variant's output rows, kWgCols columns each per warpgroup
  uint8_t* const stage = smem + kSmemPerRow * k_chunk + V::kRingBytes
                       + wg * (kBandRows * kWgCols);
  // the shifted variant's offsets (rows krow + 4s: 4sN is 4 mod 8 at odd s
  // and odd N) and its stores' rows
  Shift sh{};
  Rows rows_out{};
  if constexpr (V::kShift) {
    sh.r_even = static_cast<int>((reinterpret_cast<uintptr_t>(B) + krow * N) & 7);
    sh.r_odd = sh.r_even ^ static_cast<int>((N & 1) << 2);
    sh.d_even = kStepRows * N + sh.r_even - sh.r_odd;
    sh.d_odd = kStepRows * N + sh.r_odd - sh.r_even;
    sh.k_near = K - (N + 14) / N;  // rows before it end 15 or more bytes before B's end
    sh.end = B + K * N;
    rows_at(rows_out, C, M, N, m0, warp, threadIdx.x & 127);
  }

  Cursor cur;
  cursor_at(cur, B, blockIdx.x, col_in_tile, krow, N, n_tiles, V::kShift ? sh.r_even : 0);
#pragma unroll 1
  for (int g = 0; g < V::kAhead; ++g)
    fetch_step<kVariant>(cur, ring, g, B, K, N, n_tiles, steps, col_in_tile, krow, sh,
                         g & 1);
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
      // a chunk starts at a multiple of kUnroll steps, so step u of an
      // unrolled body is even or odd in the tile as u is
      for (int s0 = 0; s0 < rows / kStepRows; s0 += kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int slot = static_cast<int>(gstep & (V::kAhead - 1u));
          const uint32_t src = ring + (slot * kThreads + threadIdx.x) * V::kSlot;
          cp_async_wait<V::kAhead - 1>();
          uint32_t lo, hi;  // payload row k at columns col..col+3 and col+4..col+7
          if constexpr (V::kShift) {
            uint32_t x0, x1, x2, x3;
            asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                         : "=r"(x0), "=r"(x1), "=r"(x2), "=r"(x3)
                         : "r"(src)
                         : "memory");
            const uint2 w = window8(x0, x1, x2, x3, (u & 1) ? sh.r_odd : sh.r_even);
            lo = w.x;
            hi = w.y;
          } else {
            asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                         : "=r"(lo), "=r"(hi)
                         : "r"(src)
                         : "memory");
          }
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
          fetch_step<kVariant>(cur, ring, slot, B, K, N, n_tiles, steps, col_in_tile, krow,
                               sh, u & 1);
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
    if constexpr (V::kShift) warpgroup_sync(wg);  // the last tile's stores are done
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
      if ((c >> 1) == t) {
        if constexpr (V::kShift) {
          *reinterpret_cast<uint2*>(stage + c * kWgCols + (col_in_tile - wg * kWgCols)) =
              make_uint2(o1, o2);
        } else {
          const int64_t m = m0 + c;
          if (m < M && col < N) *reinterpret_cast<uint2*>(C + m * N + col) = make_uint2(o1, o2);
        }
      }
    }
    if constexpr (V::kShift) {
      warpgroup_sync(wg);
      const int64_t col0 = tile * kTileCols + wg * kWgCols;
      if (col0 < N) store_staged(rows_out, stage, N, col0, warp, lane, threadIdx.x & 127);
    }
  }
  cp_async_wait<0>();  // no copy is left in flight into freed shared memory
}

bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

template <int kVariant>
int set_smem() {
  return static_cast<int>(cudaFuncSetAttribute(gf256_bitmatrix_kernel<kVariant>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Variant<kVariant>::kMaxSmem));
}

}  // namespace

// Lets each variant use its shared memory (more than the default 48 KiB) on
// the current device.  Called once per device before its first launch.
extern "C" int gf256_init() {
  const int err = set_smem<kAligned>();
  return err ? err : set_smem<kShifted>();
}

// The tile constants the Python launch plan must agree with: {band rows,
// tile columns, K padding, shared bytes per row}, then for the aligned and
// the shifted variant in turn {steps in flight, slot bytes, chunk rows,
// staging bytes}.
extern "C" void gf256_geometry(int* out) {
  out[0] = kBandRows;
  out[1] = kTileCols;
  out[2] = kPadRows;
  out[3] = kSmemPerRow;
  out[4] = Variant<kAligned>::kAhead;
  out[5] = Variant<kAligned>::kSlot;
  out[6] = Variant<kAligned>::kChunkRows;
  out[7] = Variant<kAligned>::kStage;
  out[8] = Variant<kShifted>::kAhead;
  out[9] = Variant<kShifted>::kSlot;
  out[10] = Variant<kShifted>::kChunkRows;
  out[11] = Variant<kShifted>::kStage;
}

// Launches the bit-matrix kernel on the current device, which must hold A,
// B and C, with the geometry of kernels/gf_matmul.py::launch_plan.
extern "C" int gf256_matmul_launch(const void* A, const void* B, void* C, long long M,
                                   long long K, long long N, int k_pad, int k_chunk,
                                   long long bands, long long splits, int variant,
                                   void* stream) {
  const bool shifted = variant == kShifted;
  const int chunk_rows = shifted ? Variant<kShifted>::kChunkRows
                                 : Variant<kAligned>::kChunkRows;
  if (M <= 0 || N <= 0 || K < 0 || k_pad < K || k_pad < kPadRows || k_pad % kPadRows
      || k_chunk != (k_pad < chunk_rows ? k_pad : chunk_rows)
      || bands != (M + kBandRows - 1) / kBandRows || bands > kMaxGrid || splits < 1
      || splits > kMaxGrid || (variant != kAligned && !shifted))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!shifted && !(N % 8 == 0 && aligned8(B) && aligned8(C)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(bands));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const uint8_t*>(A);
  const auto* b = static_cast<const uint8_t*>(B);
  auto* c = static_cast<uint8_t*>(C);
  if (shifted) {
    gf256_bitmatrix_kernel<kShifted>
        <<<grid, kThreads,
           kSmemPerRow * k_chunk + Variant<kShifted>::kRingBytes + Variant<kShifted>::kStage,
           s>>>(a, b, c, M, K, N, k_pad, k_chunk);
  } else {
    gf256_bitmatrix_kernel<kAligned>
        <<<grid, kThreads, kSmemPerRow * k_chunk + Variant<kAligned>::kRingBytes, s>>>(
            a, b, c, M, K, N, k_pad, k_chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gf256_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
