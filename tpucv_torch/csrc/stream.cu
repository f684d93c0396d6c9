// Streaming add-one, out = in + 1 over a contiguous bf16 tensor, for
// Hopper (sm_90a).
//
// Replaces scripts/probe_pallas_bw.py:ident_kernel (the Pallas streaming
// probe, pallas_call at :94): one read and one write of every element, so
// the kernel measures the card's own HBM rate. The Pallas block height
// (a VMEM tiling knob) has no counterpart: any (rows, cols) view of the
// same bytes is the same flat launch here.
//
// Arithmetic: each element is widened to f32, 1.0f is added, and the sum is
// rounded to nearest-even bf16 -- what a bf16 add does in XLA and in
// PyTorch, so the result is bit-equal to `x + 1`.
//
// What bounds it on an H100: bytes only, 4 B an element (2 read, 2
// written) over 3.35 TB/s; the 1 add an element is nothing beside it. The
// design keeps enough bytes in flight: a grid-stride loop over 16-byte
// vectors (8 bf16 a thread a step, neighbouring threads on neighbouring
// addresses), with as many CTAs as fill every SM. A tail of fewer than 8
// elements is done one element a thread.

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;

__device__ __forceinline__ uint32_t add_one_pair(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  float2 f = __bfloat1622float2(h);
  __nv_bfloat162 r = __floats2bfloat162_rn(f.x + 1.0f, f.y + 1.0f);
  return *reinterpret_cast<uint32_t*>(&r);
}

__global__ void __launch_bounds__(kThreads)
add_one_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
               size_t n_vec, const __nv_bfloat16* __restrict__ in_tail,
               __nv_bfloat16* __restrict__ out_tail, int n_tail) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    uint4 v = in[i];
    v.x = add_one_pair(v.x);
    v.y = add_one_pair(v.y);
    v.z = add_one_pair(v.z);
    v.w = add_one_pair(v.w);
    out[i] = v;
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < n_tail) {
    const float f = __bfloat162float(in_tail[threadIdx.x]);
    out_tail[threadIdx.x] = __float2bfloat16_rn(f + 1.0f);
  }
}

}  // namespace

extern "C" {

const char* tpucv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x and y: n contiguous bf16 on the device, 16-byte aligned. Launches on
// `stream`, allocates nothing, and returns the cudaGetLastError() that
// follows the launch (0 on success).
int tpucv_add_one(const void* x, void* y, long long n, void* stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_vec = static_cast<size_t>(n) / 8;
  const int n_tail = static_cast<int>(n % 8);
  const size_t want = (n_vec + kThreads - 1) / kThreads;
  const size_t cap = static_cast<size_t>(sms) * kCtasPerSm;
  const int grid = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  add_one_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), n_vec,
      xb + n_vec * 8, yb + n_vec * 8, n_tail);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
