// Greedy NMS by sequential scan for Hopper (sm_90a): one CTA an image runs
// every round of the scan, with nothing leaving the SM between rounds.
//
// Replaces no Pallas kernel. It is the counterpart of tpucv's XLA scan,
// tpucv/ops/nms.py:30 (a vmapped lax.scan of max_det rounds), which the
// port ran as a Python loop of ~20 eager launches a round
// (ops/cuda_scan.py:nms_scan_reference, its plain version).
//
// For each image, over K candidates in any order (xyxy f32 boxes, f32
// scores):
//   live      = the candidates whose score is > 0;
//   round r   : best = the live candidate of highest score, the lowest
//               index on ties (torch.argmax); idx[r] = best, valid[r] = 1;
//               every live j with crit(best, j) > thr dies, then best dies;
//   crit      = iou = inter / (((area_b + area_j) - inter) + 1e-7)
//               with diou: iou - rho2 / (((cw*cw) + (ch*ch)) + 1e-7),
//               rho2 = (dx*dx) + (dy*dy) between the centres (x1 + x2) / 2,
//               cw, ch the enclosing box's sides;
//   once none is live the slots left are idx 0, valid 0 (what argmax of
//   an all-dead row gives), written without further rounds.
// Every operation is a round-to-nearest intrinsic in that association and
// the file is built with --fmad=false, so no product is contracted into an
// FMA: each decision is the plain version's, bit for bit.
//
// What bounds it on an H100: max_det dependent rounds, each waiting on the
// one before. Not bytes (20 B a candidate, read once: 2.6 MB at B=32,
// K=4096) nor operations (max_det * K IoUs, ~13 M at B=32, K=4096,
// max_det 100, ~15 f32 operations each). What the design does about it:
// - A thread owns C consecutive candidates (scan_plan: C = 1, 2, 4 for
//   K <= 1024, 2048, 4096; at most 1024 threads) and keeps their boxes,
//   areas, centres (DIoU) and live keys in registers for the whole scan;
//   the boxes also in shared memory, where every warp reads the best one.
// - A live key is the score's bits (their order is the order of positive
//   floats), 0 once dead. A round is the thread's own argmax (strict >, so
//   the lowest index wins ties), the warp's by two redux.sync (the largest
//   key, then the least index holding it), the warp's pair into a slot of
//   the round's parity, one __syncthreads, then every warp reduces the
//   slots itself the same way: one barrier a round. A slot of parity p is
//   written again in round r + 2, after every warp has passed round
//   r + 1's barrier and so has read it.
// - A warp divides only where some lane's pair overlaps (a disjoint pair
//   compares 0 with thr); dead candidates divide by 1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBoxes = 4096;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kStaticSmem = 48 * 1024;   // above it, only by opting in
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // no candidate: loses every min

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// (largest key, least index holding it) over the warp; every lane gets it
__device__ __forceinline__ void warp_argmax(unsigned key, unsigned at,
                                            unsigned& best_key,
                                            unsigned& best_at) {
  best_key = __reduce_max_sync(kFull, key);
  best_at = __reduce_min_sync(kFull, key == best_key ? at : kNone);
}

template <int C, bool kDiou>
__global__ void __launch_bounds__(kMaxThreads)
nms_scan_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores,
                int32_t* __restrict__ out_idx, uint8_t* __restrict__ out_valid,
                int K, int max_det, float thr) {
  extern __shared__ float4 s_box[];      // blockDim.x * C boxes
  __shared__ unsigned s_key[2][kMaxWarps];
  __shared__ unsigned s_at[2][kMaxWarps];
  const int img = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int base = threadIdx.x * C;
  const float4* gb = boxes + static_cast<size_t>(img) * K;
  const float* gs = scores + static_cast<size_t>(img) * K;

  // candidates past K are zero boxes, dead from the start
  float4 b[C];
  float area[C], cx[C], cy[C];
  unsigned key[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = base + c;
    b[c] = j < K ? gb[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float s = j < K ? gs[j] : 0.0f;
    key[c] = s > 0.0f ? __float_as_uint(s) : 0u;
    area[c] = box_area(b[c]);
    if (kDiou) {
      cx[c] = __fmul_rn(__fadd_rn(b[c].x, b[c].z), 0.5f);
      cy[c] = __fmul_rn(__fadd_rn(b[c].y, b[c].w), 0.5f);
    }
    s_box[j] = b[c];                     // read after round 0's barrier
  }
  const unsigned first = base < K ? static_cast<unsigned>(base) : kNone;

  int32_t* oi = out_idx + static_cast<size_t>(img) * max_det;
  uint8_t* ov = out_valid + static_cast<size_t>(img) * max_det;
  int r = 0;
  for (; r < max_det; ++r) {
    unsigned k = key[0], at = first;
#pragma unroll
    for (int c = 1; c < C; ++c)
      if (key[c] > k) {
        k = key[c];
        at = static_cast<unsigned>(base + c);
      }
    unsigned wk, wat;
    warp_argmax(k, at, wk, wat);
    const int p = r & 1;
    if (lane == 0) {
      s_key[p][warp] = wk;
      s_at[p][warp] = wat;
    }
    __syncthreads();
    unsigned best_key, best;
    warp_argmax(lane < warps ? s_key[p][lane] : 0u,
                lane < warps ? s_at[p][lane] : kNone, best_key, best);
    if (best_key == 0u) break;           // none live, in every warp alike
    if (threadIdx.x == 0) {
      oi[r] = static_cast<int32_t>(best);
      ov[r] = 1;
    }
    const float4 bb = s_box[best];
    const float ab = box_area(bb);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float ix = fmaxf(
          __fsub_rn(fminf(bb.z, b[c].z), fmaxf(bb.x, b[c].x)), 0.0f);
      const float iy = fmaxf(
          __fsub_rn(fminf(bb.w, b[c].w), fmaxf(bb.y, b[c].y)), 0.0f);
      const float inter = __fmul_rn(ix, iy);
      const float denom =
          __fadd_rn(__fsub_rn(__fadd_rn(ab, area[c]), inter), 1e-7f);
      // 0 / a positive union is 0 (of inter's sign), the same decision
      // without dividing; a dead candidate's decision is not used
      const bool divide =
          key[c] != 0u && !(inter == 0.0f && denom > 0.0f);
      float crit = 0.0f;
      if (__any_sync(kFull, divide)) {
        const float q = __fdiv_rn(divide ? inter : 1.0f,
                                  divide ? denom : 1.0f);
        crit = divide ? q : 0.0f;
      }
      if (kDiou) {
        const float cw =
            __fsub_rn(fmaxf(bb.z, b[c].z), fminf(bb.x, b[c].x));
        const float ch =
            __fsub_rn(fmaxf(bb.w, b[c].w), fminf(bb.y, b[c].y));
        const float dx =
            __fsub_rn(__fmul_rn(__fadd_rn(bb.x, bb.z), 0.5f), cx[c]);
        const float dy =
            __fsub_rn(__fmul_rn(__fadd_rn(bb.y, bb.w), 0.5f), cy[c]);
        const float rho2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        const float diag = __fadd_rn(
            __fadd_rn(__fmul_rn(cw, cw), __fmul_rn(ch, ch)), 1e-7f);
        crit = __fsub_rn(crit, __fdiv_rn(rho2, diag));
      }
      if (crit > thr || base + c == static_cast<int>(best)) key[c] = 0u;
    }
  }
  for (int q = r + threadIdx.x; q < max_det; q += blockDim.x) {
    oi[q] = 0;
    ov[q] = 0;
  }
}

// The launch for B images of K candidates: threads a CTA, candidates a
// thread, CTAs (one an image) and the dynamic shared memory (the boxes).
struct Plan {
  long long threads, per_thread, ctas, smem;
};

Plan plan(int B, int K) {
  long long c = 1;
  while (c * kMaxThreads < K) c *= 2;
  const long long threads = ((K + c - 1) / c + 31) / 32 * 32;
  return {threads, c, B,
          threads * c * static_cast<long long>(sizeof(float4))};
}

template <int C, bool kDiou>
int launch(const void* boxes, const void* scores, void* idx, void* valid,
           const Plan& p, int K, int max_det, float thr,
           cudaStream_t stream) {
  auto kernel = nms_scan_kernel<C, kDiou>;
  if (p.smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(p.ctas), static_cast<unsigned>(p.threads),
           static_cast<size_t>(p.smem), stream>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<int32_t*>(idx), static_cast<uint8_t*>(valid), K, max_det,
      thr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* tpucv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch tpucv_nms_scan makes for B images of K candidates, into out:
// {threads a CTA, candidates a thread, CTAs, dynamic shared memory bytes}
// (ops/cuda_scan.py:scan_plan).
void tpucv_nms_scan_plan(int B, int K, long long* out) {
  const Plan p = plan(B, K);
  out[0] = p.threads;
  out[1] = p.per_thread;
  out[2] = p.ctas;
  out[3] = p.smem;
}

// All pointers are contiguous device memory: boxes (B, K, 4) f32, scores
// (B, K) f32, idx (B, max_det) int32, valid (B, max_det) uint8. Launches
// on `stream`, allocates nothing, and returns the cudaGetLastError() that
// follows the launch (0 on success); 1 <= K <= 4096.
int tpucv_nms_scan(const void* boxes, const void* scores, void* idx,
                   void* valid, int B, int K, int max_det, float thr,
                   int diou, void* stream) {
  if (B <= 0 || max_det <= 0) return 0;
  if (K < 1 || K > kMaxBoxes) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(B, K);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.per_thread * 2 + (diou ? 1 : 0)) {
    case 2: return launch<1, false>(boxes, scores, idx, valid, p, K, max_det,
                                    thr, s);
    case 3: return launch<1, true>(boxes, scores, idx, valid, p, K, max_det,
                                   thr, s);
    case 4: return launch<2, false>(boxes, scores, idx, valid, p, K, max_det,
                                    thr, s);
    case 5: return launch<2, true>(boxes, scores, idx, valid, p, K, max_det,
                                   thr, s);
    case 8: return launch<4, false>(boxes, scores, idx, valid, p, K, max_det,
                                    thr, s);
    default: return launch<4, true>(boxes, scores, idx, valid, p, K, max_det,
                                    thr, s);
  }
}

}  // extern "C"
