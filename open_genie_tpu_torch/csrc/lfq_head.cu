// Fused tokenizer head for Hopper (sm_90a): kernel K2 of the PyTorch port.
//
// Replaces open_genie_tpu/ops/pallas/lfq_head.py::_head_kernel (launched by
// lfq_head). It computes the same thing in one pass over the encoder's
// features: the 1x1x1 conv z = x.W + b in f32, the LFQ codes
// where(z > 0, +1, -1) in x's dtype, and the bit-packed int32 code index with
// the first feature as the most significant bit.
//
// What bounds it on this card: per token it reads C input values and writes d
// codes and one index (C = 128, d = 10 on the rollout's tokenizer), at about
// one multiply-add per byte read, so it is bound by memory traffic and, at the
// rollout's 256 tokens per prompt frame, by launch latency.
//
// What the design does about it: W (C x d) and b are staged once per block in
// shared memory as f32 and read as broadcasts; each thread owns one token row,
// so the pre-quantisation features never reach device memory and codes and
// index leave in one pass. Each z is accumulated in f32 over C in order, so
// the sign agrees with an f32 reference except where |z| is at rounding level
// (a TF32 product, as Triton's default dot would use, would flip such signs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStaticSmemLimit = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lfq_head_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ codes,
                int* __restrict__ idx, int n, int c, int d) {
  extern __shared__ float smem[];  // w as (c, d), then b as (d)
  float* w_s = smem;
  float* b_s = smem + c * d;
  for (int i = threadIdx.x; i < c * d + d; i += kThreads) {
    smem[i] = i < c * d ? w[i] : b[i - c * d];
  }
  __syncthreads();

  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const T* x_r = x + static_cast<size_t>(row) * c;
  T* code_r = codes + static_cast<size_t>(row) * d;
  int packed = 0;
  for (int j = 0; j < d; ++j) {
    float z = 0.f;
    for (int i = 0; i < c; ++i) z += to_f32(x_r[i]) * w_s[i * d + j];
    z += b_s[j];
    const bool pos = z > 0.f;
    code_r[j] = from_f32<T>(pos ? 1.f : -1.f);
    packed |= static_cast<int>(pos) << (d - 1 - j);
  }
  idx[row] = packed;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* codes,
                   void* idx, int n, int c, int d, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(c * d + d) * sizeof(float);
  if (smem > kStaticSmemLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        lfq_head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  lfq_head_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(codes),
      static_cast<int*>(idx), n, c, d);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous (n, c) in the dtype given by `dtype` (0 = float32,
// 1 = bfloat16); w: contiguous float32 (c, d); b: float32 (d); codes:
// (n, d) in x's dtype; idx: int32 (n). Requires 1 <= d <= 31.
// Returns the CUDA error of the launch (0 on success).
extern "C" int lfq_head(const void* x, const void* w, const void* b,
                        void* codes, void* idx, int n, int c, int d,
                        int dtype, void* stream) {
  if (n <= 0 || c <= 0 || d <= 0 || d > 31) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, w, b, codes, idx, n, c, d, s);
    case 1: return launch<__nv_bfloat16>(x, w, b, codes, idx, n, c, d, s);
    default: return cudaErrorInvalidValue;
  }
}
