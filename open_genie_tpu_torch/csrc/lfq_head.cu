// Fused tokenizer head for Hopper (sm_90a): kernel K2 of the PyTorch port.
//
// Replaces open_genie_tpu/ops/pallas/lfq_head.py::_head_kernel (launched by
// lfq_head). It computes the same thing in one pass over the encoder's
// features: the 1x1x1 conv z = x.W + b in f32, the LFQ codes
// where(z > 0, +1, -1) in x's dtype, and the bit-packed int32 code index with
// the first feature as the most significant bit.
//
// What bounds it on this card: per token it reads C input values and writes d
// codes and one index, at about one multiply-add per byte read, so the bytes
// bound it: their 2.5 MB at 3.35 TB/s (an H100 SXM at 700 W) is 0.74 us for
// the Genie step's 16,384 tokens of 64 bf16 channels.
// The rollout's call, 256 tokens of 128 channels, is far below one wave of
// the card, so there the time to launch and fill it is the floor.
//
// What the design does about it: the tokens spread over the SMs, a warp per
// token row, or per two rows when C <= 128 and d <= 16 (each half-warp a
// row). The lanes read the row in 16-byte vectors (8 bf16 or 4 f32), so a
// warp's loads are coalesced, and each lane keeps d f32 partial sums in
// registers. A fixed __shfl_xor_sync butterfly adds them across the row's
// lanes (no atomics: two calls are bit-identical); lane j < d then holds
// z_j, adds b_j and writes code j, and one __ballot_sync of the signs,
// bit-reversed and shifted, is the MSB-first index. W (read at any strides,
// in f32 or bf16) and b are staged once per block in shared memory as f32,
// laid out so that the lanes of a warp read 16-byte pieces at consecutive
// addresses (no bank conflict). Blocks have 4 warps and the grid at most 4
// blocks an SM, each warp taking rows in turn: 32 blocks at the rollout's
// 256 tokens, 528 (about 8 rows a warp) at 16,384, where 8 or 16 blocks an
// SM were no faster on an H100 (PERF.md). A C that is not a multiple of the
// vector width, or an x that is not 16-byte aligned, takes the scalar path
// (one element a lane, still coalesced), chosen before the launch.
//
// Sums are f32 on the CUDA cores, never TF32 (a TF32 product flips signs
// near zero); the order differs from a plain matrix product's, so a sign
// agrees with an f32 reference except where |z| is at rounding level.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxBits = 31;  // the index is an int32
constexpr int kStaticSmemLimit = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Elements of T in one 16-byte load.
template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int value = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int value = 8; };

// V consecutive elements from p as f32: one 16-byte load, or one element.
__device__ __forceinline__ void load(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  // bf16 -> f32 is exact: the bf16 bits are the f32's high 16 bits.
  f[0] = __uint_as_float(v.x << 16); f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16); f[3] = __uint_as_float(v.y & 0xffff0000u);
  f[4] = __uint_as_float(v.z << 16); f[5] = __uint_as_float(v.z & 0xffff0000u);
  f[6] = __uint_as_float(v.w << 16); f[7] = __uint_as_float(v.w & 0xffff0000u);
}
template <typename T> __device__ __forceinline__ void load(const T* p, float (&f)[1]) {
  f[0] = to_f32(*p);
}

__device__ __forceinline__ float param(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// T: x's and the codes' dtype. D: the bits (0: any d <= 31, given at run
// time). VEC: 16-byte loads of x (else one element a lane). lanes: 16 (two
// rows a warp) or 32 (one row).
template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(kThreads)
lfq_head_kernel(const T* __restrict__ x, const void* __restrict__ w, long long w_sc,
                long long w_sd, int w_bf16, const void* __restrict__ b, int b_bf16,
                T* __restrict__ codes, int* __restrict__ idx, int n, int c, int d_any,
                int lanes) {
  constexpr int kD = D ? D : kMaxBits;
  constexpr int V = VEC ? VecWidth<T>::value : 1;
  const int d = D ? D : d_any;
  const int nv = c / V;  // vectors (scalar path: channels) per row

  // W as f32 (j, h, v, e): bit j, the h-th 4 elements of vector v, element
  // e; lane v reads its 4 weights of (j, h) as one float4, and the lanes of
  // a warp read consecutive float4s. The scalar path's is (j, channel).
  extern __shared__ __align__(16) float smem[];
  float* b_s = smem + c * d;
  for (int i = threadIdx.x; i < c * d; i += kThreads) {
    const int ch = i / d, j = i - ch * d;
    const float val = param(w, ch * w_sc + j * w_sd, w_bf16);
    const int e = ch % V;
    smem[VEC ? ((j * (V / 4) + e / 4) * nv + ch / V) * 4 + (e & 3) : j * c + ch] = val;
  }
  for (int j = threadIdx.x; j < d; j += kThreads) b_s[j] = param(b, j, b_bf16);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);  // the lane within its row
  const int half = lane / lanes;       // the warp's first or second row
  const int rows = 32 / lanes;
  const long long tasks = (static_cast<long long>(n) + rows - 1) / rows;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long t = blockIdx.x * kWarps + threadIdx.x / 32; t < tasks; t += stride) {
    const long long row = t * rows + half;
    const bool live = row < n;
    float acc[kD];
#pragma unroll
    for (int j = 0; j < kD; ++j) acc[j] = 0.f;
    if (live) {
      const T* xr = x + row * c;
      for (int v = sub; v < nv; v += lanes) {
        float xv[V];
        load(xr + v * V, xv);
#pragma unroll
        for (int j = 0; j < kD; ++j) {
          if (D == 0 && j >= d) break;
          if constexpr (VEC) {
            const float4* w4 = reinterpret_cast<const float4*>(smem) + j * (V / 4) * nv + v;
#pragma unroll
            for (int h = 0; h < V / 4; ++h) {
              const float4 ww = w4[h * nv];
              acc[j] = fmaf(xv[4 * h], ww.x, acc[j]);
              acc[j] = fmaf(xv[4 * h + 1], ww.y, acc[j]);
              acc[j] = fmaf(xv[4 * h + 2], ww.z, acc[j]);
              acc[j] = fmaf(xv[4 * h + 3], ww.w, acc[j]);
            }
          } else {
            acc[j] = fmaf(xv[0], smem[j * c + v], acc[j]);
          }
        }
      }
    }
    // The row's sums over its lanes, in a fixed order; every lane of the
    // row ends with every z.
    for (int off = lanes / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        if (D == 0 && j >= d) break;
        acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
      }
    }
    float z = 0.f;
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      if (sub == j) z = acc[j];
    }
    const bool mine = live && sub < d;
    const bool pos = mine && z + b_s[mine ? sub : 0] > 0.f;
    const unsigned signs = __ballot_sync(0xffffffffu, pos);
    if (mine) codes[row * d + sub] = from_f32<T>(pos ? 1.f : -1.f);
    if (live && sub == 0) {
      const unsigned bits = (signs >> (half * lanes)) & ((1u << d) - 1u);
      idx[row] = static_cast<int>(__brev(bits) >> (32 - d));  // bit j -> d - 1 - j
    }
  }
}

struct Args {
  const void *x, *w, *b;
  long long w_sc, w_sd;
  int w_bf16, b_bf16;
  void *codes, *idx;
  int n, c, d;
};

template <typename T, int D, bool VEC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(a.c * a.d + a.d) * sizeof(float);
  if (smem > kStaticSmemLimit) {
    const cudaError_t err = cudaFuncSetAttribute(
        lfq_head_kernel<T, D, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  const int lanes = a.c <= 128 && a.d <= 16 ? 16 : 32;
  const long long tasks = (static_cast<long long>(a.n) + 32 / lanes - 1) / (32 / lanes);
  const long long want = (tasks + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(
      want < static_cast<long long>(sms) * kBlocksPerSm ? want : sms * kBlocksPerSm);
  lfq_head_kernel<T, D, VEC><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), a.w, a.w_sc, a.w_sd, a.w_bf16, a.b, a.b_bf16,
      static_cast<T*>(a.codes), static_cast<int*>(a.idx), a.n, a.c, a.d, lanes);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_alignment(const Args& a, cudaStream_t stream) {
  const bool vec = a.c % VecWidth<T>::value == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  return vec ? launch<T, D, true>(a, stream) : launch<T, D, false>(a, stream);
}

template <typename T>
cudaError_t by_bits(const Args& a, cudaStream_t stream) {
  switch (a.d) {
    case 10: return by_alignment<T, 10>(a, stream);
    case 18: return by_alignment<T, 18>(a, stream);
    default: return by_alignment<T, 0>(a, stream);
  }
}

}  // namespace

// x: contiguous (n, c) in the dtype given by `dtype` (0 = float32,
// 1 = bfloat16); w: (c, d) at element strides (w_sc, w_sd), float32 or
// bfloat16 by `w_dtype`; b: contiguous (d), by `b_dtype`; codes: contiguous
// (n, d) in x's dtype; idx: int32 (n). Requires 1 <= d <= 31. Returns the
// CUDA error of the launch (0 on success).
extern "C" int lfq_head(const void* x, const void* w, long long w_sc, long long w_sd,
                        int w_dtype, const void* b, int b_dtype, void* codes, void* idx,
                        int n, int c, int d, int dtype, void* stream) {
  if (n <= 0 || c <= 0 || d <= 0 || d > kMaxBits) return cudaErrorInvalidValue;
  if ((w_dtype != 0 && w_dtype != 1) || (b_dtype != 0 && b_dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  const Args a{x, w, b, w_sc, w_sd, w_dtype, b_dtype, codes, idx, n, c, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_bits<float>(a, s);
    case 1: return by_bits<__nv_bfloat16>(a, s);
    default: return cudaErrorInvalidValue;
  }
}
