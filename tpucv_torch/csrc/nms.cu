// Greedy NMS keep mask for Hopper (sm_90a): the overlap mask built by many
// CTAs an image, then walked block by block by one CTA an image.
//
// Replaces tpucv/ops/pallas_nms.py:_nms_kernel (launched by
// pallas_nms_keep, wrapped by pallas_nms). Same function, not the same
// blocks: the TPU kernel builds an (N, N) bf16 overlap matrix in VMEM and
// sweeps a suppression-wave fixpoint as MXU mat-vecs; here the overlap
// matrix is bit-packed and walked in score order, 32 boxes a step, which is
// the sequential greedy itself.
//
// For each image, over score-sorted boxes (xyxy f32, scores f32):
//   area      = max(x2-x1,0) * max(y2-y1,0)
//   iou(i,j)  = inter / (((area_i + area_j) - inter) + 1e-7)   in f32
//   j < i suppresses i when iou > thr (strict) and j is kept;
//   score <= 0 marks a box invalid: it neither keeps nor suppresses;
//   keep      = not suppressed and not invalid.
// The IoU is computed with round-to-nearest intrinsics in exactly that
// association, and the file is built with --fmad=false, so no product is
// contracted into an FMA: a pair near the threshold decides as it does in
// XLA and in the PyTorch plain version.
//
// The mask: words[img][i][w] bit l is set when box j = 32w + l (j > i)
// overlaps box i above thr, for W = ceil(K/32) words a row. An image holds
// 32W rows (K padded to whole blocks of 32) of Wp = W rounded up to 4
// words, so that every row is whole 16-byte chunks; only words at or right
// of the diagonal (w >= i/32) are written or read.
//
// What bounds it on an H100. The inputs are 20 bytes a box (2.6 MB at
// B=128, K=1024), under a microsecond of HBM traffic. The arithmetic is
// K(K-1)/2 IoUs an image, ~14 f32 operations each: ~0.9 GFLOP at B=128,
// K=1024, ~14 us at the 67 TFLOP/s f32 rate. The walk is a chain of
// dependent steps, which latency bounds, not throughput. What the design
// does about each:
// - build (nms_build_kernel): a (B, W) grid, 256 CTAs at B=8, K=1024, so
//   every SM works at the served batch. CTA (img, c) takes rows c, c + W,
//   c + 2W, ... of its image: one row of every 32-row tile, so each CTA gets the
//   same number of pairs. The boxes sit in shared memory; one
//   __ballot_sync makes each word (lanes read neighbouring boxes, no bank
//   conflicts), and a row's words leave in one coalesced store. The mask
//   (1 MiB at B=8, K=1024; 16 MiB at B=128) stays in the 50 MB L2.
// - walk (nms_walk_kernel): one CTA an image. Warp 0 resolves block w
//   (boxes 32w..32w+31) in one register: the block's 32 diagonal words
//   need no removed state, so their loads (8 broadcast 16-byte loads into
//   every lane) stay off the chain; the chain is a test and an OR a box,
//   with no branch. The kept boxes' rows are then ORed into the removed
//   words right of the block, one word a lane: loads that depend neither
//   on each other nor on the chain, in its basic block (no branch, no
//   store until the walk ends), so they overlap it. Warps 1-3 bring the
//   next blocks' rows (and their diagonal words apart) into a
//   shared-memory ring with cp.async while warp 0 walks; one barrier a
//   block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBuildThreads = 256;
constexpr int kWalkThreads = 128;    // warp 0 walks, warps 1-3 load
constexpr int kRingBlocks = 4;       // blocks of 32 mask rows in flight
constexpr int kMaxBoxes = 1024;
constexpr int kMaxWords = kMaxBoxes / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// iou(a, b) > thr for a warp's 32 pairs (every lane calls it). +-0 over a
// positive union is +-0, so a disjoint pair compares 0 with thr, the same
// decision, without dividing: its operands become 1 / 1 (a zero dividend
// would take the correctly rounded division's slow path), and when every
// pair of the warp is disjoint the warp skips the division.
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, float thr) {
  float ix = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  float iy = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  float inter = __fmul_rn(ix, iy);
  float denom = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f);
  const bool zero = inter == 0.0f && denom > 0.0f;
  if (__all_sync(kFull, zero)) return 0.0f > thr;
  const float iou = __fdiv_rn(zero ? 1.0f : inter, zero ? 1.0f : denom);
  return (zero ? 0.0f : iou) > thr;
}

// acc | x when test is not 0, with a predicate, not a branch
__device__ __forceinline__ uint32_t or_if(uint32_t acc, uint32_t test,
                                          uint32_t x) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.ne.u32 p, %1, 0;\n\t"
      "@p or.b32 %0, %0, %2;\n\t}"
      : "+r"(acc) : "r"(test), "r"(x));
  return acc;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__global__ void __launch_bounds__(kBuildThreads)
nms_build_kernel(const float4* __restrict__ boxes,
                 uint32_t* __restrict__ words, int K, float thr) {
  __shared__ float4 s_box[kMaxBoxes];
  __shared__ float s_area[kMaxBoxes];
  const int W = (K + 31) >> 5;
  const int Wp = (W + 3) & ~3;
  const int img = blockIdx.x;
  const float4* gb = boxes + static_cast<size_t>(img) * K;
  // boxes past K are zero: every lane tests a pair, no branch around it
  for (int i = threadIdx.x; i < (W << 5); i += kBuildThreads) {
    const float4 b = i < K ? gb[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s_box[i] = b;
    s_area[i] = box_area(b);
  }
  __syncthreads();

  uint32_t* out = words + static_cast<size_t>(img) * (W << 5) * Wp;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kBuildThreads / 32;
  for (int i = blockIdx.y + warp * W; i < K; i += kWarps * W) {
    const float4 bi = s_box[i];
    const float ai = s_area[i];
    const int w0 = i >> 5;
    uint32_t mine = 0;                 // lane l keeps word w0 + l
    for (int w = w0; w < W; ++w) {
      const int j = (w << 5) + lane;
      const bool hit = overlaps(bi, ai, s_box[j], s_area[j], thr) &
                       (j > i) & (j < K);
      const uint32_t word = __ballot_sync(kFull, hit);
      if (lane == w - w0) mine = word;
    }
    if (lane < W - w0) out[i * Wp + w0 + lane] = mine;
  }
}

__global__ void __launch_bounds__(kWalkThreads)
nms_walk_kernel(const uint32_t* __restrict__ words,
                const float* __restrict__ scores,
                uint8_t* __restrict__ keep, int K) {
  __shared__ __align__(16) uint32_t s_ring[kRingBlocks][32 * kMaxWords];
  __shared__ __align__(16) uint32_t s_diag[kRingBlocks][32];
  const int W = (K + 31) >> 5;
  const int Wp = (W + 3) & ~3;
  const int img = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* gw = words + static_cast<size_t>(img) * (W << 5) * Wp;
  const int row_chunks = Wp >> 2;      // 16-byte chunks a row

  // warps 1-3 copy block w's 32 rows into its ring slot, a row every
  // kMaxWords words (so row b's word l is at a constant offset), and warp 1
  // its diagonal words apart (read down a column of the rows they would
  // hit one bank); every thread commits a group (empty for warp 0 and past
  // the last block), so the count of groups in flight is the same at every
  // wait
  auto issue = [&](int w) {
    if (warp != 0 && w < W) {
      const int slot = w % kRingBlocks;
      const uint32_t* src = gw + w * 32 * Wp;
      for (int c = threadIdx.x - 32; c < 32 * row_chunks;
           c += kWalkThreads - 32) {
        const int b = c / row_chunks;
        cp_async16(s_ring[slot] + b * kMaxWords + 4 * (c - b * row_chunks),
                   src + 4 * c);
      }
      if (warp == 1) cp_async4(&s_diag[slot][lane], src + lane * Wp + w);
    }
    cp_async_commit();
  };
  for (int w = 0; w < kRingBlocks - 1; ++w) issue(w);

  // warp 0, lane l: the valid boxes of block l, from loads issued together
  uint32_t valid_word = 0;
  if (warp == 0) {
    const float* gs = scores + static_cast<size_t>(img) * K;
    float s[kMaxWords];
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      const int i = (w << 5) + lane;
      s[w] = i < K ? gs[i] : 0.0f;
    }
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
      const uint32_t v = __ballot_sync(kFull, s[w] > 0.0f);
      if (lane == w) valid_word = v;
    }
  }

  // warp 0, lane l: the removed and the kept boxes of block l
  uint32_t removed = 0, kept_word = 0;
  for (int w = 0; w < W; ++w) {
    cp_async_wait<kRingBlocks - 2>();  // block w has landed
    __syncthreads();                   // ... for all, and w - 1 is walked
    issue(w + kRingBlocks - 1);        // into the slot block w - 1 left
    if (warp != 0) continue;
    const int slot = w % kRingBlocks;
    const uint32_t* blk = s_ring[slot];
    uint32_t d[32];                    // the diagonal words, to every lane
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(s_diag[slot])[q];
      d[4 * q] = v.x;
      d[4 * q + 1] = v.y;
      d[4 * q + 2] = v.z;
      d[4 * q + 3] = v.w;
    }
    const uint32_t valid = __shfl_sync(kFull, valid_word, w);
    uint32_t r = __shfl_sync(kFull, removed, w);
#pragma unroll
    for (int b = 0; b < 32; ++b)       // box 32w + b: kept unless removed
      if (((valid & ~r) >> b) & 1u) r |= d[b];
    const uint32_t kept = valid & ~r;
    if (lane == w) kept_word = kept;
    // every lane ORs its word of the kept rows, with no branch, so the
    // row loads need no kept bit and overlap the chain; the words of
    // lanes <= w (done) and >= W (none) are never read again
    uint32_t acc[4] = {removed, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 32; ++b)
      acc[b & 3] = or_if(acc[b & 3], kept & (1u << b),
                         blk[b * kMaxWords + lane]);
    removed = (acc[0] | acc[1]) | (acc[2] | acc[3]);
  }
  if (warp != 0) return;
  uint8_t* out = keep + static_cast<size_t>(img) * K;
  for (int w = 0; w < W; ++w) {
    const uint32_t kept = __shfl_sync(kFull, kept_word, w);
    const int i = (w << 5) + lane;
    if (i < K) out[i] = (kept >> lane) & 1u;
  }
}

// The launch geometry for B images of K boxes: W words a row, 32W rows an
// image of Wp words each, the build's (images, row sets) grid, the walk's
// CTAs and the scratch mask's bytes.
struct Plan {
  long long words, rows, row_words, build_x, build_y, walk_ctas, scratch;
};

Plan plan(int B, int K) {
  const long long W = (K + 31) / 32;
  const long long Wp = (W + 3) / 4 * 4;
  return {W, 32 * W, Wp, B, W, B,
          static_cast<long long>(B) * 32 * W * Wp *
              static_cast<long long>(sizeof(uint32_t))};
}

int check_shape(int K) {
  return K > kMaxBoxes ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

int launch_build(const void* boxes, void* words, int B, int K, float thr,
                 cudaStream_t stream) {
  const Plan p = plan(B, K);
  const dim3 grid(static_cast<unsigned>(p.build_x),
                  static_cast<unsigned>(p.build_y));
  nms_build_kernel<<<grid, kBuildThreads, 0, stream>>>(
      static_cast<const float4*>(boxes), static_cast<uint32_t*>(words), K,
      thr);
  return static_cast<int>(cudaGetLastError());
}

int launch_walk(const void* words, const void* scores, void* keep, int B,
                int K, cudaStream_t stream) {
  nms_walk_kernel<<<static_cast<unsigned>(plan(B, K).walk_ctas),
                    kWalkThreads, 0, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(scores),
      static_cast<uint8_t*>(keep), K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* tpucv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All pointers are contiguous device memory: boxes (B, K, 4) f32, scores
// (B, K) f32, words (B, 32W, Wp) uint32 scratch for W = ceil(K/32) and Wp
// = W rounded up to 4, keep (B, K) uint8. Each function launches on
// `stream`, allocates nothing, and returns the cudaGetLastError() that
// follows its launches (0 on success).

// The launches tpucv_nms_keep makes for B images of K boxes, into out:
// {W, rows an image, Wp, build grid x (images), build grid y (row sets),
// walk CTAs, scratch bytes} (ops/cuda_nms.py:nms_plan).
void tpucv_nms_plan(int B, int K, long long* out) {
  const Plan p = plan(B, K);
  const long long v[] = {p.words, p.rows, p.row_words, p.build_x, p.build_y,
                         p.walk_ctas, p.scratch};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}

// The overlap mask alone.
int tpucv_nms_build(const void* boxes, void* words, int B, int K, float thr,
                    void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (int err = check_shape(K)) return err;
  return launch_build(boxes, words, B, K, thr,
                      static_cast<cudaStream_t>(stream));
}

// The walk alone, over a mask that tpucv_nms_build wrote.
int tpucv_nms_walk(const void* words, const void* scores, void* keep, int B,
                   int K, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (int err = check_shape(K)) return err;
  return launch_walk(words, scores, keep, B, K,
                     static_cast<cudaStream_t>(stream));
}

// The keep mask: the build, then the walk, on one stream.
int tpucv_nms_keep(const void* boxes, const void* scores, void* words,
                   void* keep, int B, int K, float thr, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (int err = check_shape(K)) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int err = launch_build(boxes, words, B, K, thr, s)) return err;
  return launch_walk(words, scores, keep, B, K, s);
}

}  // extern "C"
