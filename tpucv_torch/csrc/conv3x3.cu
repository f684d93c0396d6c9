// Narrow-channel 3x3 convolution for Hopper (sm_90a): stride 1, SAME zero
// padding, x NHWC (B,S,S,C) bf16, w HWIO (3,3,C,C) bf16, f32 accumulate,
// y NHWC bf16, C in {16, 32, 64}.
//
// Replaces the Pallas probe kernels of
//   scripts/probe_pallas_conv.py:build_packed_conv (.kernel, :81),
//   scripts/probe_pallas_conv_v2.py:make_roll (.kernel, :69) and make (:134),
//   scripts/probe_pallas_conv_parts.py:make (.kernel, :54).
// Same function, not the same blocks. The TPU packs 128/C pixels into each
// 128-lane row and multiplies by a block-structured (9,128,128) weight,
// because its matrix unit is 128 wide. Here the conv is an implicit GEMM
// straight on NHWC: M = B*S*S pixels, N = C, K = 9*C, with tensor-core
// mma.sync m16n8k16 (bf16 in, f32 accumulators) and no FLOP waste.
//
// Structure. A CTA (8 warps) owns a job: one image b and a tile of output
// rows [r0, r1). It keeps the whole weight in shared memory, transposed on
// load to (tap, co, ci) so that a B fragment is one 32-bit load, and a ring
// of three padded input rows (S+2 pixels, zero columns at both ends). For
// each output row r it starts the cp.async load of row r+1 into the ring
// slot that row r-2 held, runs the six taps of rows r-1 and r while that
// load is in flight, waits, runs the three taps of row r+1 and stores row
// r. Each warp holds up to three 16-pixel m tiles of the row (all C output
// channels) in registers; a wider row takes more passes. Pixel and weight
// rows are C+8 halves apart in shared memory, so the 8 rows of a fragment
// fall in distinct banks.
//
// The two launch modes of the port are two job shapes for this one kernel:
//   halo     one CTA per tile of `tile_rows` rows; each tile reads its row
//            above and below too, (tile_rows+2)/tile_rows of the input
//            (the TPU's prev/cur/next block fetch, parts `full`, v2
//            `full`/`slab2`);
//   rolling  a persistent grid (as many CTAs as fit on the card at once)
//            walks strips of rows down the images, each input row loaded
//            once a strip (the TPU's lag-one rolling scratch, v2 `roll`,
//            build_packed_conv); strips are as tall as filling every SM
//            once allows.
// The TPU probes' timing-only decompositions are compile-time variants:
//   nohalo   taps outside the CTA's own row tile read zero;
//   noshift  all 9 taps read the centre pixel: y = x . sum(w);
//   gemm1    one tap, the centre: y = x . w[1,1];
//   nomask   no boundary predicates: tap (du,dp) reads flat pixel
//            r + (du-1)*S + (dp-1) of the (B*S*S, C) sequence, zero only
//            outside the whole tensor.
//
// What bounds it on an H100: 4*B*S*S*C bytes (x read once, y written once)
// against 2*B*S*S*9*C*C FLOPs, 4.5*C FLOP a byte: 288 at C=64, on the
// card's ridge (989 TFLOP/s / 3.35 TB/s = 295); bytes bound C=16 and C=32.
// The design reads x once (rolling) or (T+2)/T times (halo), keeps every
// partial sum in registers, and overlaps each row's load with two thirds
// of its products. Not yet done (a later PR): wgmma and TMA, a deeper ring,
// output staged through shared memory for 16-byte stores, and more than
// one row a step where S is small.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMt = 3;                 // m16 tiles a warp holds in a pass
constexpr size_t kSmemMax = 232448;    // what one block may use on sm_90

enum Variant { kFull = 0, kNoHalo = 1, kNoShift = 2, kGemm1 = 3, kNoMask = 4 };

__host__ __device__ __forceinline__ int padded_width(int S) {
  return (S + 15) / 16 * 16 + 2;       // pixels a ring row holds
}

size_t smem_bytes(int S, int C) {
  return static_cast<size_t>(9 * C + 3 * padded_width(S)) * (C + 8) *
         sizeof(bf16);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;        // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start loading input row hh of image b (hh may be -1 or S) into a ring
// slot: padded pixel p holds column p-1; what the variant reads as zero is
// zero-filled.
template <int C, int V>
__device__ __forceinline__ void load_row(bf16* slot, const bf16* __restrict__ x,
                                         int B, int S, int b, int hh, int r0,
                                         int r1) {
  constexpr int kChunks = C / 8;       // 16-byte chunks a pixel
  constexpr int PS = C + 8;
  const int total = padded_width(S) * kChunks;
  const long long flat_row = static_cast<long long>(b) * S + hh;
  const long long n_pix = static_cast<long long>(B) * S * S;
  bool row_ok = hh >= 0 && hh < S;
  if (V == kNoHalo) row_ok = row_ok && hh >= r0 && hh < r1;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int p = i / kChunks, c = i % kChunks;
    const long long q = flat_row * S + p - 1;
    const bool ok = V == kNoMask ? (p <= S + 1 && q >= 0 && q < n_pix)
                                 : (row_ok && p >= 1 && p <= S);
    cp_async16(slot + p * PS + c * 8, ok ? x + q * C + c * 8 : x, ok);
  }
}

// acc += the taps of rows du in [DU_LO, DU_HI] (0: row r-1, 1: r, 2: r+1)
// for this warp's m tiles mt0, mt0+8, mt0+16 of the row.
template <int C, int V, int DU_LO, int DU_HI>
__device__ __forceinline__ void mma_taps(float (&acc)[kMt][C / 8][4],
                                         const bf16* ws, const bf16* rm,
                                         const bf16* rc, const bf16* rp,
                                         int mt0, int nmt) {
  constexpr int PS = C + 8, NT = C / 8, KS = C / 16;
  constexpr bool kCentre = V == kNoShift || V == kGemm1;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int du = DU_LO; du <= DU_HI; ++du) {
#pragma unroll
    for (int dv = 0; dv < 3; ++dv) {
      if (V == kGemm1 && (du != 1 || dv != 1)) continue;
      const bf16* arow = kCentre ? rc : (du == 0 ? rm : (du == 1 ? rc : rp));
      const int shift = kCentre ? 1 : dv;
      const bf16* wt = ws + (du * 3 + dv) * C * PS;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t bfr[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const bf16* bp = wt + (nt * 8 + g) * PS + ks * 16 + 2 * t;
          bfr[nt][0] = lds32(bp);
          bfr[nt][1] = lds32(bp + 8);
        }
#pragma unroll
        for (int i = 0; i < kMt; ++i) {
          const int mt = mt0 + i * kWarps;
          if (mt < nmt) {
            const bf16* ap =
                arow + (mt * 16 + g + shift) * PS + ks * 16 + 2 * t;
            const uint32_t a[4] = {lds32(ap), lds32(ap + 8 * PS),
                                   lds32(ap + 8), lds32(ap + 8 * PS + 8)};
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma16816(acc[i][nt], a, bfr[nt][0], bfr[nt][1]);
          }
        }
      }
    }
  }
}

template <int C>
__device__ __forceinline__ void store_row(float (&acc)[kMt][C / 8][4],
                                          bf16* __restrict__ yrow, int mt0,
                                          int nmt, int S) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kMt; ++i) {
    const int mt = mt0 + i * kWarps;
    if (mt >= nmt) continue;
    const int w = mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt) {
      const int co = nt * 8 + 2 * t;
      __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i][nt][0], acc[i][nt][1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(acc[i][nt][2], acc[i][nt][3]);
      if (w < S)
        *reinterpret_cast<__nv_bfloat162*>(yrow + static_cast<size_t>(w) * C +
                                           co) = lo;
      if (w + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(
            yrow + static_cast<size_t>(w + 8) * C + co) = hi;
      acc[i][nt][0] = acc[i][nt][1] = acc[i][nt][2] = acc[i][nt][3] = 0.0f;
    }
  }
}

template <int C, int V>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               bf16* __restrict__ y, int B, int S, int tile_rows, int n_tiles,
               int jobs) {
  constexpr int PS = C + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = ws + 9 * C * PS;
  const int slot = padded_width(S) * PS;

  // HWIO (tap, ci, co) -> shared (tap, co, ci); the first barrier of the
  // row loop orders these stores before any read
  for (int i = threadIdx.x; i < 9 * C * C; i += kThreads) {
    const int tap = i / (C * C), ci = (i / C) % C, co = i % C;
    ws[(tap * C + co) * PS + ci] = w[i];
  }

  const int nmt = (S + 15) / 16;
  const int warp = threadIdx.x >> 5;
  float acc[kMt][C / 8][4] = {};
  for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
    const int b = job / n_tiles;
    const int r0 = (job % n_tiles) * tile_rows;
    const int r1 = min(r0 + tile_rows, S);
    // row hh lives in ring slot (hh + 3) % 3
    load_row<C, V>(ring + (r0 + 2) % 3 * slot, x, B, S, b, r0 - 1, r0, r1);
    load_row<C, V>(ring + r0 % 3 * slot, x, B, S, b, r0, r0, r1);
    cp_async_commit();
    for (int r = r0; r < r1; ++r) {
      const bf16* rm = ring + (r + 2) % 3 * slot;
      const bf16* rc = ring + r % 3 * slot;
      bf16* rp = ring + (r + 1) % 3 * slot;
      load_row<C, V>(rp, x, B, S, b, r + 1, r0, r1);
      cp_async_commit();
      cp_async_wait<1>();              // rows r-1 and r have landed
      __syncthreads();
      mma_taps<C, V, 0, 1>(acc, ws, rm, rc, rp, warp, nmt);
      cp_async_wait<0>();              // row r+1 has landed
      __syncthreads();
      mma_taps<C, V, 2, 2>(acc, ws, rm, rc, rp, warp, nmt);
      bf16* yrow = y + (static_cast<size_t>(b) * S + r) * S * C;
      store_row<C>(acc, yrow, warp, nmt, S);
      for (int mt0 = warp + kWarps * kMt; mt0 < nmt; mt0 += kWarps * kMt) {
        mma_taps<C, V, 0, 2>(acc, ws, rm, rc, rp, mt0, nmt);
        store_row<C>(acc, yrow, mt0, nmt, S);
      }
      __syncthreads();                 // the next load overwrites row r-1
    }
  }
}

// Let the kernel take its dynamic shared memory; when `ctas` is given,
// also count the CTAs that fit on the card at once (SMs times CTAs an SM).
template <int C, int V>
int prepare(int S, int* ctas) {
  const size_t smem = smem_bytes(S, C);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<C, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess || ctas == nullptr) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv3x3_kernel<C, V>, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *ctas = sms * per_sm;
  return 0;
}

template <int C, int V>
int launch(const void* x, const void* w, void* y, int B, int S, int tile_rows,
           int persistent, cudaStream_t stream) {
  const int n_tiles = (S + tile_rows - 1) / tile_rows;
  const long long jobs = static_cast<long long>(B) * n_tiles;
  if (jobs > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;
  const int err = prepare<C, V>(S, persistent ? &ctas : nullptr);
  if (err != 0) return err;
  const int grid = persistent && jobs > ctas ? ctas : static_cast<int>(jobs);
  conv3x3_kernel<C, V><<<grid, kThreads, smem_bytes(S, C), stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), B, S, tile_rows, n_tiles,
      static_cast<int>(jobs));
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int dispatch_variant(int variant, const void* x, const void* w, void* y, int B,
                     int S, int tile_rows, int persistent, cudaStream_t st) {
  switch (variant) {
    case kFull: return launch<C, kFull>(x, w, y, B, S, tile_rows, persistent, st);
    case kNoHalo: return launch<C, kNoHalo>(x, w, y, B, S, tile_rows, persistent, st);
    case kNoShift: return launch<C, kNoShift>(x, w, y, B, S, tile_rows, persistent, st);
    case kGemm1: return launch<C, kGemm1>(x, w, y, B, S, tile_rows, persistent, st);
    case kNoMask: return launch<C, kNoMask>(x, w, y, B, S, tile_rows, persistent, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* tpucv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// How many CTAs of the full variant fit on the card at once for this S and
// C (SMs times CTAs an SM): the rolling mode's persistent grid.
int tpucv_conv3x3_ctas_on_card(int S, int C, int* out) {
  switch (C) {
    case 16: return prepare<16, kFull>(S, out);
    case 32: return prepare<32, kFull>(S, out);
    case 64: return prepare<64, kFull>(S, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x (B,S,S,C), w (3,3,C,C), y (B,S,S,C), all contiguous bf16 on the device.
// variant: 0 full, 1 nohalo, 2 noshift, 3 gemm1, 4 nomask. Jobs are tiles
// of tile_rows rows; persistent != 0 caps the grid at the CTAs that fit on
// the card (rolling), else one CTA a tile (halo). Launches on `stream`,
// allocates nothing, and returns the cudaGetLastError() that follows the
// launch (0 on success).
int tpucv_conv3x3(const void* x, const void* w, void* y, int B, int S, int C,
                  int variant, int tile_rows, int persistent, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (tile_rows <= 0 || smem_bytes(S, C) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return dispatch_variant<16>(variant, x, w, y, B, S, tile_rows, persistent, st);
    case 32: return dispatch_variant<32>(variant, x, w, y, B, S, tile_rows, persistent, st);
    case 64: return dispatch_variant<64>(variant, x, w, y, B, S, tile_rows, persistent, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
