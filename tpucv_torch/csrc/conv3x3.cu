// Narrow-channel 3x3 convolution for Hopper (sm_90a): stride 1, SAME zero
// padding, x NHWC (B,S,S,C) bf16, w HWIO (3,3,C,C) bf16, f32 accumulate,
// y NHWC bf16, C in {16, 32, 64}.
//
// Replaces the Pallas probe kernels of
//   scripts/probe_pallas_conv.py:build_packed_conv (.kernel, :81),
//   scripts/probe_pallas_conv_v2.py:make_roll (.kernel, :69) and make (:134),
//   scripts/probe_pallas_conv_parts.py:make (.kernel, :54).
// Same function, not the same blocks: the TPU packs 128/C pixels a 128-lane
// row against a block-structured (9,128,128) weight; here the conv is an
// implicit GEMM straight on NHWC, M = pixels, N = C, K = 9*C, no FLOP waste.
//
// What bounds it on an H100: 4*B*S*S*C bytes (x read once, y written once)
// against 2*B*S*S*9*C*C FLOPs, 4.5*C FLOP a byte. Bytes bound C=16 and C=32
// (72 and 144 FLOP/B); C=64 sits at 288, on the card's ridge (989 TFLOP/s
// over 3.35 TB/s = 295), so there the products must run near the tensor
// cores' rate as well.
//
// Jobs and grid. A job is a tile of output rows by kColTile = 128 output
// columns of one image. A persistent grid (the CTAs that fit on the card at
// once, from the occupancy query) walks the jobs in both modes, so each CTA
// loads the weight once. halo: jobs of tile_rows rows, each reading its row
// above and below, (T+2)/T of the input (the TPU's prev/cur/next fetch).
// rolling: jobs are strips, each input row read once a strip plus the 2
// halo columns of its column tile (the TPU's lag-one rolling scratch).
//
// Shared memory, in the no-swizzle layouts wgmma reads:
//   weight  (tap, ci/8, co, ci%8), written once a CTA from 16-byte loads:
//           an 8 co x 16 B core matrix is 128 contiguous bytes;
//   ring    ring_rows(C) slots, one padded input row each (kColTile + 2
//           pixels, zero columns at the image's edges), 16-byte chunk-planar:
//           chunk c of pixel p at byte (c*kWp + p)*16, so 8 pixels x 16 B
//           are 128 contiguous bytes and a tap's column shift dv is +16*dv;
//   stage   each warp's output staging (below).
// Loads are cp.async.ca with zero-fill, which writes the SAME padding and
// every variant's zeros: one loader rule, no predicates in the products.
// The loader walks the CTA's jobs ahead of the products: item k (the k-th
// input row the CTA needs) lands in slot k % ring_rows(C), one cp.async
// group an item, ring_rows - 4 rows ahead of the step that reads them.
//
// Steps. A step computes 2 output rows from 4 ring rows, after one wait
// (for the rows it reads), one fence.proxy.async and one barrier.
//   C=64  8 warps, a warpgroup a row. Each warpgroup issues, a tap and a
//         k16 step at a time, one wgmma.mma_async m64n128k16 with both
//         operands from shared memory by descriptor, as the transposed
//         product y^T = W^T x^T: A is the tap's weight block (M = the 64
//         output channels; SBO 128 B between 8-channel core matrices, LBO
//         C*16 between chunks), B the ring row from pixel dv (N = the 128
//         pixels; SBO 128 B between 8-pixel core matrices, LBO kWp*16
//         between chunk planes); 36 wgmmas a row, one commit, one wait.
//   C<64  4 warps, 64 pixels of a row each, mma.sync m16n8k16 with
//         ldmatrix fragments from the same layouts. Bytes bound these C,
//         and wgmma measured slower there (PERF.md).
// The epilogue rounds the f32 sums to bf16 once and goes through shared
// memory for 16-byte coalesced stores: at C=64 stmatrix.trans turns the
// transposed accumulators into pixel rows of the warpgroup's stage, at
// C<64 each warp writes its fragments to its own stage (XOR-swizzled
// 16-byte chunks: no bank conflicts on either side).
//
// The TPU probes' timing-only decompositions are compile-time variants:
//   nohalo   taps outside the job's own row tile read zero;
//   noshift  all 9 taps read the centre pixel: y = x . sum(w);
//   gemm1    one tap, the centre: y = x . w[1,1];
//   nomask   no boundary predicates: tap (du,dp) reads flat pixel
//            r + (du-1)*S + (dp-1) of the (B*S*S, C) sequence, zero only
//            outside the whole tensor.
//
// Not done yet (a later PR): TMA loads with mbarriers (the cp.async rate
// follows the warps that issue it: PERF.md), warp specialisation so a
// step's stores and the next step's products overlap, the pixels computed
// past a ragged last column tile (S=300, 320: 128 computed for 44 or 64),
// and halo-mode load balance at small S.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kColTile = 128;          // output columns a job covers
constexpr int kWp = kColTile + 2;      // padded pixels a ring slot holds
// ring slots (one input row each) by C: as deep as leaves 3, 2 and 1 CTAs
// an SM at C = 16, 32, 64
constexpr int kRingC16 = 12;
constexpr int kRingC32 = 8;
constexpr int kRingC64 = 8;
constexpr int kRows = 2;               // output rows a step
constexpr size_t kSmemMax = 232448;    // what one block may use on sm_90

enum Variant { kFull = 0, kNoHalo = 1, kNoShift = 2, kGemm1 = 3, kNoMask = 4 };

__host__ __device__ constexpr size_t weight_bytes(int C) {
  return 9u * C * C * sizeof(bf16);
}
__host__ __device__ constexpr size_t slot_bytes(int C) {
  return size_t(kWp) * C * sizeof(bf16);
}
// warps a CTA: 8 (two warpgroups) at C=64, where one CTA fills an SM and
// the loads want more warps issuing them; 4 (one warpgroup) below, where
// several CTAs share an SM
__host__ __device__ constexpr int warps(int C) { return C == 64 ? 8 : 4; }
__host__ __device__ constexpr int threads(int C) { return 32 * warps(C); }
// The products by wgmma at C=64; by mma.sync below, where bytes bound the
// conv and wgmma measured slower (PERF.md).
__host__ __device__ constexpr bool use_wgmma(int C) { return C == 64; }
// m16 tiles of a row a warp holds with mma.sync: kColTile / (warps a row)
// pixels (with wgmma, the same number of accumulators)
__host__ __device__ constexpr int tiles(int C) {
  return kRows * kColTile / 16 / warps(C);
}
static_assert(!use_wgmma(64) || warps(64) == 4 * kRows, "a warpgroup a row");
__host__ __device__ constexpr int ring_rows(int C) {
  return C == 16 ? kRingC16 : (C == 32 ? kRingC32 : kRingC64);
}
// output staging a warp: its tiles, at most 2 KB (two rounds above that)
__host__ __device__ constexpr int stage_bytes(int C) {
  return tiles(C) * 32 * C < 2048 ? tiles(C) * 32 * C : 2048;
}
__host__ __device__ constexpr size_t smem_bytes(int C) {
  return weight_bytes(C) + ring_rows(C) * slot_bytes(C) +
         warps(C) * stage_bytes(C);
}
__host__ __device__ constexpr int ctas_an_sm(int C) {
  return C == 16 ? 3 : (C == 32 ? 2 : 1);
}
static_assert(smem_bytes(64) <= kSmemMax, "the C=64 plan must fit a block");
static_assert(ring_rows(16) >= kRows + 4 && ring_rows(32) >= kRows + 4 &&
              ring_rows(64) >= kRows + 4,
              "a step's rows and the next ones' loads");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const bf16* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;        // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Wait until at most `pending` of this thread's newest groups are in
// flight (none when pending is out of range). A step allows ring_rows - 6
// (at most 6), a job's first step ring_rows - 7 or - 8.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// A wgmma shared-memory matrix descriptor, no swizzle: start address, LBO
// (bytes between the two K-adjacent 8x16-byte core matrices) and SBO
// (bytes between M- or N-adjacent ones), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32;
}

// D (64 x 128 f32, 64 a thread) += A (64 x 16) B (16 x 128), both read from
// shared memory by descriptor, K-major, no swizzle (scale-d = 1: add).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void stsm_x4_trans(void* p, uint32_t r0,
                                              uint32_t r1, uint32_t r2,
                                              uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
      :: "r"(smem_addr(p)), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Jobs are (image b, row tile, column tile), column tile fastest.
struct Jobs {
  int S, tile_rows, n_tiles, n_ct, count;
  __device__ __forceinline__ void decode(int j, int& b, int& r0, int& r1,
                                         int& c0) const {
    c0 = j % n_ct * kColTile;
    j /= n_ct;
    r0 = j % n_tiles * tile_rows;
    r1 = min(r0 + tile_rows, S);
    b = j / n_tiles;
  }
};

// Start loading input row hh of image b (hh may be -1 or S), columns
// c0-1 .. c0+kColTile, into a ring slot: 16-byte chunk c of padded pixel p
// at byte (c*kWp + p)*16. What the variant reads as zero is zero-filled.
template <int C, int V>
__device__ __forceinline__ void load_row(unsigned char* slot,
                                         const bf16* __restrict__ x, int B,
                                         int S, int b, int hh, int r0, int r1,
                                         int c0) {
  constexpr int kChunks = C / 8;       // 16-byte chunks a pixel
  const long long flat_row = static_cast<long long>(b) * S + hh;
  const long long n_pix = static_cast<long long>(B) * S * S;
  bool row_ok = hh >= 0 && hh < S;
  if (V == kNoHalo) row_ok = row_ok && hh >= r0 && hh < r1;
  for (int i = threadIdx.x; i < kWp * kChunks; i += threads(C)) {
    const int p = i / kChunks, c = i % kChunks;
    const int col = c0 + p - 1;
    const long long q = flat_row * S + col;
    const bool ok = V == kNoMask ? (q >= 0 && q < n_pix)
                                 : (row_ok && col >= 0 && col < S);
    cp_async16(slot + (c * kWp + p) * 16, ok ? x + q * C + c * 8 : x, ok);
  }
}

// Keep the compiler from reading or writing the accumulators across the
// wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// The taps a variant sums: row du (0: r-1, 1: r, 2: r+1) and column
// shift dv; noshift and gemm1 read the centre pixel, gemm1 one tap only.
template <int V>
__device__ __forceinline__ bool tap_used(int du, int dv) {
  return V != kGemm1 || (du == 1 && dv == 1);
}
template <int V>
__device__ __forceinline__ const unsigned char* tap_row(
    int du, const unsigned char* rm, const unsigned char* rc,
    const unsigned char* rp) {
  if (V == kNoShift || V == kGemm1) return rc;
  return du == 0 ? rm : (du == 1 ? rc : rp);
}
template <int V>
__device__ __forceinline__ int tap_shift(int dv) {
  return V == kNoShift || V == kGemm1 ? 1 : dv;
}

// One output row at C=64 with wgmma, issued by the warpgroup, as the
// transposed product y^T = W^T x^T: A is the tap's weight block (M = the 64
// output channels: 8-channel core matrices 128 bytes apart, SBO; chunks
// C*16 apart, LBO), B the ring row from pixel dv (N = the column tile's 128
// pixels: 8-pixel core matrices 128 bytes apart, SBO; chunk planes kWp*16
// apart, LBO). An m64n128k16 reads 6 KB of shared memory for 262k FLOPs,
// where pixels as M (m64n64) read 4 KB for half that. d: warp k's output
// channels 16k..16k+15 of all 128 pixels. Fenced, committed and waited
// for. Every pixel runs, also past a narrower column tile: any branch on
// the path to the wait makes ptxas serialize the wgmmas, which costs more
// (PERF.md).
template <int V>
__device__ __forceinline__ void wgmma_row(float (&d)[64], const bf16* ws,
                                          const unsigned char* rm,
                                          const unsigned char* rc,
                                          const unsigned char* rp) {
  constexpr int C = 64, KS = C / 16, CK = C / 8;
  wgmma_fence();
#pragma unroll
  for (int du = 0; du < 3; ++du) {
#pragma unroll
    for (int dv = 0; dv < 3; ++dv) {
      if (!tap_used<V>(du, dv)) continue;
      const unsigned char* arow = tap_row<V>(du, rm, rc, rp);
      const bf16* wt = ws + (du * 3 + dv) * CK * C * 8;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_n128(d, smem_desc(wt + 2 * ks * C * 8, C * 16, 128),
                   smem_desc(arow + (2 * ks * kWp + tap_shift<V>(dv)) * 16,
                             kWp * 16, 128));
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
}

// Round the warpgroup's row (d: warp k's output channels 16k..16k+15 of
// the 128 pixels, as wgmma_row leaves them) to bf16 and write its n_valid
// pixels to output row yrow through the warpgroup's 8 KB stage, 64 pixels
// a round: stmatrix.trans turns each 8x8 (channel, pixel) block of d into 8
// pixel rows of 16 bytes, chunk c of pixel p at chunk 8p + (c ^ p % 8), so
// neither side conflicts on a bank; whole 128-byte pixels then leave as
// 16-byte stores, 512 contiguous bytes a warp instruction. Named barrier
// 1 + wg syncs the warpgroup's 128 threads.
__device__ __forceinline__ void store_row_t(float (&d)[64],
                                            unsigned char* stage,
                                            bf16* __restrict__ yrow, int wg,
                                            int n_valid) {
  const int tid = threadIdx.x & 127, lane = tid & 31, k = tid >> 5;
  const int m = lane >> 3;
#pragma unroll
  for (int round = 0; round < 2; ++round) {
#pragma unroll
    for (int jj = 0; jj < 8; jj += 2) {
      // two 8-pixel blocks; lanes 8m.. address matrix m's 8 pixel rows
      const int j = round * 8 + jj;
      const int p = (jj + (m >> 1)) * 8 + (lane & 7), c = 2 * k + (m & 1);
      stsm_x4_trans(stage + (8 * p + (c ^ (p & 7))) * 16,
                    pack_bf16(d[4 * j], d[4 * j + 1]),
                    pack_bf16(d[4 * j + 2], d[4 * j + 3]),
                    pack_bf16(d[4 * j + 4], d[4 * j + 5]),
                    pack_bf16(d[4 * j + 6], d[4 * j + 7]));
    }
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
#pragma unroll
    for (int f = tid; f < 64 * 8; f += 128) {
      const int p = f >> 3, c = f & 7, px = round * 64 + p;
      const uint4 v = *reinterpret_cast<const uint4*>(
          stage + (8 * p + (c ^ (p & 7))) * 16);
      if (px < n_valid)
        *reinterpret_cast<uint4*>(yrow + static_cast<size_t>(px) * 64 +
                                  8 * c) = v;
    }
    // the next round (or row) overwrites the stage
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
}

// One output row with mma.sync m16n8k16, issued by each warp for its T
// m16 tiles from pixel m0, all C output channels; fragments by
// ldmatrix from the same layouts. Every tile runs: a branch a tile would
// keep ptxas from moving the fragment loads ahead of the products.
template <int C, int V, int T>
__device__ __forceinline__ void mma_row(float (&acc)[T][C / 8][4],
                                        const bf16* ws,
                                        const unsigned char* rm,
                                        const unsigned char* rc,
                                        const unsigned char* rp, int m0) {
  constexpr int NT = C / 8, KS = C / 16, CK = C / 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int du = 0; du < 3; ++du) {
#pragma unroll
    for (int dv = 0; dv < 3; ++dv) {
      if (!tap_used<V>(du, dv)) continue;
      const unsigned char* arow = tap_row<V>(du, rm, rc, rp);
      const bf16* wt = ws + (du * 3 + dv) * CK * C * 8;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t bfr[NT][2];
        const int mi = lane >> 3;      // lanes 8mi..8mi+7 address matrix mi
#pragma unroll
        for (int j = 0; j < NT / 2; ++j)
          ldsm_x4(bfr[2 * j][0], bfr[2 * j][1], bfr[2 * j + 1][0],
                  bfr[2 * j + 1][1],
                  wt + ((2 * ks + (mi & 1)) * C + (2 * j + (mi >> 1)) * 8 +
                        (lane & 7)) * 8);
#pragma unroll
        for (int i = 0; i < T; ++i) {
          uint32_t a[4];
          ldsm_x4(a[0], a[1], a[2], a[3],
                  arow + ((2 * ks + (lane >> 4)) * kWp + m0 + i * 16 +
                          (lane & 15) + tap_shift<V>(dv)) * 16);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma16816(acc[i][nt], a, bfr[nt][0], bfr[nt][1]);
        }
      }
    }
  }
}

// Round the warp's T m16 tiles of a row (from pixel m0 of the column
// tile) to bf16 and write them to output row yrow (pixel 0 = the
// column tile's first column), its n_valid columns, through the warp's
// stage_bytes(C) of shared memory: fragments go in as 4-byte pieces,
// pixel-major with 16-byte chunk q of pixel p at chunk q ^ (p's 128-byte
// line, mod the chunks a pixel), so neither side conflicts on a bank; they
// leave as 16-byte stores, 256-512 contiguous bytes a warp instruction.
template <int C, int T>
__device__ __forceinline__ void store_row(float (&acc)[T][C / 8][4],
                                          unsigned char* stage,
                                          bf16* __restrict__ yrow, int m0,
                                          int n_valid) {
  constexpr int CK = C / 8;                        // chunks a pixel
  constexpr int kLine = 8 / CK;                    // pixels a 128-byte line
  constexpr int kTiles = stage_bytes(C) / (32 * C);  // m16 tiles a round
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i0 = 0; i0 < T; i0 += kTiles) {
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
#pragma unroll
      for (int nt = 0; nt < CK; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = i * 16 + g + 8 * h;
          float* a = acc[i0 + i][nt] + 2 * h;
          *reinterpret_cast<__nv_bfloat162*>(
              stage + (p * CK + (nt ^ (p / kLine % CK))) * 16 + 4 * t) =
              __floats2bfloat162_rn(a[0], a[1]);
          a[0] = a[1] = 0.0f;
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int f = lane; f < kTiles * 16 * CK; f += 32) {
      const int p = f / CK, q = f % CK;
      const int px = m0 + i0 * 16 + p;
      const uint4 v = *reinterpret_cast<const uint4*>(
          stage + (p * CK + (q ^ (p / kLine % CK))) * 16);
      if (px < n_valid)
        *reinterpret_cast<uint4*>(yrow + static_cast<size_t>(px) * C +
                                  q * 8) = v;
    }
    __syncwarp();                      // the next round overwrites the stage
  }
}

template <int C, int V>
__global__ void __launch_bounds__(threads(C), ctas_an_sm(C))
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               bf16* __restrict__ y, int B, Jobs jobs) {
  constexpr int CK = C / 8;
  constexpr size_t kSlot = slot_bytes(C);
  constexpr int kRing = ring_rows(C);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + weight_bytes(C);
  unsigned char* stage =
      ring + kRing * kSlot + (threadIdx.x >> 5) * stage_bytes(C);
  const int S = jobs.S;

  // HWIO (tap, ci, co) -> shared (tap, ci/8, co, ci%8): 16-byte loads of 8
  // output channels; the first barrier of the row loop orders the stores
  for (int i = threadIdx.x; i < 9 * C * CK; i += threads(C)) {
    const int tap = i / (C * CK), ci = i / CK % C, co = i % CK * 8;
    const uint4 v = reinterpret_cast<const uint4*>(w)[i];
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    bf16* dst = ws + ((tap * CK + ci / 8) * C + co) * 8 + ci % 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[k * 8] = e[k];
  }

  // The loader walks this CTA's jobs ahead of the products: item k is the
  // k-th input row the CTA needs (rows r0-1 .. r1 of each job in turn) and
  // lands in slot k % kRing, one cp.async group an item.
  int l_job = blockIdx.x, l_b = 0, l_hh = 0, l_r0 = 0, l_r1 = 0, l_c0 = 0;
  if (l_job < jobs.count) {
    jobs.decode(l_job, l_b, l_r0, l_r1, l_c0);
    l_hh = l_r0 - 1;
  }
  int issued = 0;
  auto issue = [&]() {
    if (l_job < jobs.count) {
      load_row<C, V>(ring + issued % kRing * kSlot, x, B, S, l_b, l_hh, l_r0,
                     l_r1, l_c0);
      if (++l_hh > l_r1) {
        l_job += gridDim.x;
        if (l_job < jobs.count) {
          jobs.decode(l_job, l_b, l_r0, l_r1, l_c0);
          l_hh = l_r0 - 1;
        }
      }
    }
    cp_async_commit();                 // empty past the last job: counts stay
    ++issued;
  };
  while (issued < kRing - kRows) issue();

  // a step computes rows r, r+1 of a job from items win .. win+3 (rows
  // r-1 .. r+2); warp: row r + j and, with wgmma, output channels 16k..
  // (k = warp % 4) of all its pixels, with mma.sync all channels of tiles(C)
  // m16 tiles from pixel m0
  constexpr int kT = tiles(C), kWarpsARow = warps(C) / kRows;
  const int warp = threadIdx.x >> 5, j = warp / kWarpsARow;
  const int m0 = kColTile / kWarpsARow * (warp % kWarpsARow);
  float acc[kT][C / 8][4] = {};
  int win = 0;
  for (int job = blockIdx.x; job < jobs.count; job += gridDim.x) {
    int b, r0, r1, c0;
    jobs.decode(job, b, r0, r1, c0);
    const int base = win;
    const int n_valid = min(kColTile, S - c0);
    for (int r = r0; r < r1; r += kRows, win += kRows) {
      cp_async_wait_pending(issued - win - kRows - 2);
      fence_proxy_async();             // cp.async's writes, for wgmma
      __syncthreads();                 // landed for all; last step done
      while (issued < win + kRing) issue();
      const unsigned char* rm = ring + (win + j) % kRing * kSlot;
      const unsigned char* rc = ring + (win + j + 1) % kRing * kSlot;
      const unsigned char* rp = ring + (win + j + 2) % kRing * kSlot;
      bf16* yrow = y + ((static_cast<size_t>(b) * S + r + j) * S + c0) * C;
      if constexpr (use_wgmma(C)) {
        // done before the next barrier frees a slot; the row past a job's
        // last (odd count) runs too, unstored: a branch would make ptxas
        // serialize the wgmmas. The stage: the warpgroup's 4 warps' stages,
        // 8 KB in a run.
        float(&d)[64] = reinterpret_cast<float(&)[64]>(acc);
        wgmma_row<V>(d, ws, rm, rc, rp);
        if (r + j < r1)
          store_row_t(d, stage - (warp & 3) * stage_bytes(C), yrow, warp >> 2,
                      n_valid);
        else
          for (float& v : d) v = 0.0f;
      } else if (r + j < r1) {
        mma_row<C, V, kT>(acc, ws, rm, rc, rp, m0);
        store_row<C, kT>(acc, stage, yrow, m0, n_valid);
      }
    }
    win = base + (r1 - r0) + 2;        // the next job's rows start anew
  }
  cp_async_wait<0>();
}

// Let the kernel take its dynamic shared memory and count the CTAs that fit
// on the card at once (SMs times CTAs an SM, the latter in *per_sm_out when
// it is given).
template <int C, int V>
int prepare(int* ctas, int* per_sm_out) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<C, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(C)));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv3x3_kernel<C, V>, threads(C), smem_bytes(C));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *ctas = sms * per_sm;
  if (per_sm_out != nullptr) *per_sm_out = per_sm;
  return 0;
}

template <int C, int V>
int launch(const void* x, const void* w, void* y, int B, int S, int tile_rows,
           cudaStream_t stream) {
  const int n_tiles = (S + tile_rows - 1) / tile_rows;
  const int n_ct = (S + kColTile - 1) / kColTile;
  const long long jobs = static_cast<long long>(B) * n_tiles * n_ct;
  if (jobs > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;
  const int err = prepare<C, V>(&ctas, nullptr);
  if (err != 0) return err;
  const int grid = jobs > ctas ? ctas : static_cast<int>(jobs);
  conv3x3_kernel<C, V><<<grid, threads(C), smem_bytes(C), stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), B,
      Jobs{S, tile_rows, n_tiles, n_ct, static_cast<int>(jobs)});
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int dispatch_variant(int variant, const void* x, const void* w, void* y, int B,
                     int S, int tile_rows, cudaStream_t st) {
  switch (variant) {
    case kFull: return launch<C, kFull>(x, w, y, B, S, tile_rows, st);
    case kNoHalo: return launch<C, kNoHalo>(x, w, y, B, S, tile_rows, st);
    case kNoShift: return launch<C, kNoShift>(x, w, y, B, S, tile_rows, st);
    case kGemm1: return launch<C, kGemm1>(x, w, y, B, S, tile_rows, st);
    case kNoMask: return launch<C, kNoMask>(x, w, y, B, S, tile_rows, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* tpucv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The kernel's plan for C: output columns a job covers, ring slots (input
// rows), dynamic shared memory a CTA takes, warps a CTA and whether the
// products are wgmma (1) or mma.sync (0). Returns nonzero for a C the
// kernel does not take.
int tpucv_conv3x3_plan(int C, int* col_tile, int* rows, int* smem,
                       int* n_warps, int* wgmma) {
  if (C != 16 && C != 32 && C != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  *col_tile = kColTile;
  *rows = ring_rows(C);
  *smem = static_cast<int>(smem_bytes(C));
  *n_warps = warps(C);
  *wgmma = use_wgmma(C);
  return 0;
}

// How many CTAs of the full variant fit on the card at once for this C
// (SMs times CTAs an SM, the latter in *per_sm): the persistent grid.
int tpucv_conv3x3_ctas_on_card(int C, int* out, int* per_sm) {
  switch (C) {
    case 16: return prepare<16, kFull>(out, per_sm);
    case 32: return prepare<32, kFull>(out, per_sm);
    case 64: return prepare<64, kFull>(out, per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x (B,S,S,C), w (3,3,C,C), y (B,S,S,C), all contiguous 16-byte aligned
// bf16 on the device. variant: 0 full, 1 nohalo, 2 noshift, 3 gemm1, 4
// nomask. Jobs are tiles of tile_rows rows by kColTile columns, walked by
// as many CTAs as fit on the card at once. Launches on `stream`, allocates
// nothing, and returns the cudaGetLastError() that follows the launch (0
// on success).
int tpucv_conv3x3(const void* x, const void* w, void* y, int B, int S, int C,
                  int variant, int tile_rows, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (tile_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return dispatch_variant<16>(variant, x, w, y, B, S, tile_rows, st);
    case 32: return dispatch_variant<32>(variant, x, w, y, B, S, tile_rows, st);
    case 64: return dispatch_variant<64>(variant, x, w, y, B, S, tile_rows, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
