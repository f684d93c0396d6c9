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
// design: one 16-byte vector a thread (neighbouring threads on
// neighbouring addresses), CTAs of 1,024 threads, one CTA a chunk of 1,024
// vectors (no grid-stride loop), and the streaming ld/st.global.cs hints,
// since no byte is read twice. Indices are 32-bit when the tensor allows.
// The tail of fewer than 8 elements is the last CTA's. More vectors a
// thread, 256-thread CTAs, ld.global.nc loads and a persistent grid all
// measured no faster (probes/stream_ablations.py builds each as an edit of
// this file).

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ uint32_t add_one_pair(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  float2 f = __bfloat1622float2(h);
  __nv_bfloat162 r = __floats2bfloat162_rn(f.x + 1.0f, f.y + 1.0f);
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint4 add_one_vec(uint4 v) {
  v.x = add_one_pair(v.x);
  v.y = add_one_pair(v.y);
  v.z = add_one_pair(v.z);
  v.w = add_one_pair(v.w);
  return v;
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
add_one_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
               Index n_vec, const __nv_bfloat16* __restrict__ in_tail,
               __nv_bfloat16* __restrict__ out_tail, int n_tail) {
  const Index i = static_cast<Index>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n_vec) __stcs(out + i, add_one_vec(__ldcs(in + i)));
  if (blockIdx.x == gridDim.x - 1 && static_cast<int>(threadIdx.x) < n_tail) {
    const float f = __bfloat162float(in_tail[threadIdx.x]);
    out_tail[threadIdx.x] = __float2bfloat16_rn(f + 1.0f);
  }
}

// The launch for n elements: {threads a CTA, CTAs, index bits}.
void plan(long long n, long long out[3]) {
  const long long n_vec = n / 8;
  const long long grid = (n_vec + kThreads - 1) / kThreads;
  out[0] = kThreads;
  out[1] = grid < 1 ? 1 : grid;
  // 32-bit while every index the grid forms fits
  out[2] = n_vec + kThreads <= 0xffffffffll ? 32 : 64;
}

template <typename Index>
void launch(const void* x, void* y, size_t n_vec, int n_tail,
            long long grid, cudaStream_t stream) {
  add_one_kernel<Index><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y),
      static_cast<Index>(n_vec),
      static_cast<const __nv_bfloat16*>(x) + n_vec * 8,
      static_cast<__nv_bfloat16*>(y) + n_vec * 8, n_tail);
}

}  // namespace

extern "C" {

const char* tpucv_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch tpucv_add_one makes for n elements, into out:
// {threads a CTA, CTAs, index bits} (ops/stream.py:stream_plan).
void tpucv_add_one_plan(long long n, long long* out) { plan(n, out); }

// x and y: n contiguous bf16 on the device, 16-byte aligned. Launches on
// `stream`, allocates nothing, and returns the cudaGetLastError() that
// follows the launch (0 on success).
int tpucv_add_one(const void* x, void* y, long long n, void* stream) {
  if (n <= 0) return 0;
  long long p[3];
  plan(n, p);
  if (p[1] > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n_vec = static_cast<size_t>(n) / 8;
  const int n_tail = static_cast<int>(n % 8);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p[2] == 32)
    launch<uint32_t>(x, y, n_vec, n_tail, p[1], s);
  else
    launch<uint64_t>(x, y, n_vec, n_tail, p[1], s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
