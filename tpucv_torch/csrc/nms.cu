// Greedy NMS keep mask for Hopper (sm_90a), one CTA per image.
//
// Replaces tpucv/ops/pallas_nms.py:_nms_kernel (launched by
// pallas_nms_keep, wrapped by pallas_nms). Same function, not the same
// blocks: the TPU kernel builds an (N, N) bf16 overlap matrix in VMEM and
// sweeps a suppression-wave fixpoint as MXU mat-vecs; here the overlap
// matrix is bit-packed in shared memory and one warp walks it in score
// order, which is the sequential greedy itself.
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
// What bounds it on an H100. The inputs are 20 bytes a box (2.6 MB at
// B=128, K=1024), under a microsecond of HBM traffic. The arithmetic is
// K(K-1)/2 IoUs an image, ~14 f32 operations each: ~0.9 GFLOP at B=128,
// K=1024, ~14 us at the 67 TFLOP/s f32 rate. The walk is a chain of K
// dependent steps (shuffle, test, OR), which latency bounds, not
// throughput. The design keeps every intermediate on chip: the mask is
// K x ceil(K/32) uint32 in dynamic shared memory (128 KB at K=1024, 32 KB
// at K=512, within the 227 KB a block can use), built by all 16 warps with
// one __ballot_sync per 32 pairs (lanes read neighbouring boxes, so no
// bank conflicts), and only words at or right of the diagonal are built.
// The walk keeps the "removed" bit-vector in registers, one 32-bit word a
// lane. Images run in parallel across SMs; at B=8 most SMs idle, which is
// the next PR's work (several CTAs per image, overlapped walks).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBoxes = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, float thr) {
  float ix = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  float iy = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  float inter = __fmul_rn(ix, iy);
  float denom = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f);
  return __fdiv_rn(inter, denom) > thr;
}

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores,
                uint8_t* __restrict__ keep, int K, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) / 32;
  float4* s_box = reinterpret_cast<float4*>(smem);
  float* s_area = reinterpret_cast<float*>(s_box + K);
  float* s_score = s_area + K;
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(s_score + K);

  const int img = blockIdx.x;
  const float4* gb = boxes + static_cast<size_t>(img) * K;
  const float* gs = scores + static_cast<size_t>(img) * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    float4 b = gb[i];
    s_box[i] = b;
    s_area[i] = box_area(b);
    s_score[i] = gs[i];
  }
  __syncthreads();

  // mask[i][w] bit l: box j = 32w + l (j > i) overlaps box i above thr
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int i = warp; i < K; i += n_warps) {
    const float4 bi = s_box[i];
    const float ai = s_area[i];
    for (int w = i >> 5; w < W; ++w) {
      const int j = (w << 5) + lane;
      bool hit = false;
      if (j > i && j < K) hit = overlaps(bi, ai, s_box[j], s_area[j], thr);
      const uint32_t word = __ballot_sync(kFull, hit);
      if (lane == 0) s_mask[i * W + w] = word;
    }
  }
  __syncthreads();

  // sequential greedy walk by warp 0; lane l owns removed-bits word l
  if (warp != 0) return;
  uint32_t removed = 0;
  uint8_t* out = keep + static_cast<size_t>(img) * K;
  for (int i = 0; i < K; ++i) {
    const int w = i >> 5;
    const uint32_t r = __shfl_sync(kFull, removed, w);
    const bool kept = !((r >> (i & 31)) & 1u) && s_score[i] > 0.0f;
    if (kept && lane >= w && lane < W) removed |= s_mask[i * W + lane];
    if (lane == 0) out[i] = kept ? 1 : 0;
  }
}

}  // namespace

extern "C" {

const char* tpucv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory the kernel needs for K boxes an image.
size_t tpucv_nms_keep_smem_bytes(int K) {
  const size_t W = (K + 31) / 32;
  return static_cast<size_t>(K) * (sizeof(float4) + 2 * sizeof(float)) +
         static_cast<size_t>(K) * W * sizeof(uint32_t);
}

// boxes (B, K, 4) f32, scores (B, K) f32, keep (B, K) uint8, all contiguous
// on the device. Launches on `stream`, allocates nothing, and returns the
// cudaGetLastError() that follows the launch (0 on success).
int tpucv_nms_keep(const void* boxes, const void* scores, void* keep, int B,
                   int K, float thr, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > kMaxBoxes) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = tpucv_nms_keep_smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_keep_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<uint8_t*>(keep), K, thr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
