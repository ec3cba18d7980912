// Flash-attention forward for Hopper (sm_90a): kernel K1 of the PyTorch port.
//
// Replaces open_genie_tpu/ops/pallas/flash_attention.py::_fwd_kernel (launched
// by _flash_forward). It computes the same thing: attention over (B*H, N, D)
// with an online softmax across key tiles, keeping an f32 running max m, an
// f32 running sum l and an f32 accumulator. Masked logits are -1e30 (not -inf)
// and l is clamped to 1e-30, as in the Pallas kernel; the unnormalised
// probabilities are rounded to the value dtype before the P.V product (bf16
// operands, f32 accumulation). It writes o in the input dtype and the per-row
// logsumexp in f32 as (B*H, N).
//
// What bounds it on this card: at the shapes the rollout gives it (N = 256
// spatial tokens with D = 16 or 64; causal temporal calls with N <= 17 and
// B*H up to 2048) one call moves well under a megabyte and does at most
// tens of MFLOP. It is bound by launch latency and by how few blocks it puts
// on the 132 SMs, not by HBM bandwidth or by the tensor cores.
//
// What the design does about it: one launch per attention call and one block
// per (b*h, 64-row query tile), so the many tiny temporal problems become
// one grid. The Pallas grid's sequential k axis, which carried m, l and the
// accumulator in VMEM scratch from step to step, becomes a loop inside the
// block, so no state crosses blocks. Each K/V tile is staged once in shared
// memory (as f32) and read by all 64 query rows; four threads share a query
// row, each owning every fourth feature, so the shared-memory reads are
// broadcast and conflict-free. Causal key tiles past the query tile's last
// row are skipped, and the ragged edge (N not a multiple of the tile, N
// smaller than a tile) is masked inside the kernel: the wrapper never pads.
// The products run on the CUDA cores in f32; wgmma, TMA and pipelining are
// left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockM = 64;        // query rows per block
constexpr int kLanesPerRow = 4;    // threads sharing one query row
constexpr int kThreads = kBlockM * kLanesPerRow;
constexpr float kNegBig = -1e30f;  // the Pallas kernel's masked logit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n, float scale, bool causal) {
  constexpr int kBlockN = D >= 128 ? 32 : 64;  // keeps K/V tiles at 32 KB
  constexpr int kDimsPerLane = D / kLanesPerRow;
  __shared__ float k_s[kBlockN][D];
  __shared__ float v_s[kBlockN][D];

  const int tid = threadIdx.x;
  const int lane = tid % kLanesPerRow;  // owns features lane, lane + 4, ...
  const int q0 = blockIdx.y * kBlockM;
  const int row = q0 + tid / kLanesPerRow;
  const bool row_ok = row < n;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * D;

  float q_r[kDimsPerLane], acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) {
    const int dd = lane + kLanesPerRow * i;
    q_r[i] = row_ok ? to_f32(q[base + static_cast<size_t>(row) * D + dd]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegBig, l = 0.f;

  // Key tiles starting past the tile's last query row are fully masked.
  const int k_end = causal ? min(q0 + kBlockM, n) : n;

  for (int k0 = 0; k0 < k_end; k0 += kBlockN) {
    __syncthreads();  // every row is done with the previous tile
    for (int idx = tid; idx < kBlockN * D; idx += kThreads) {
      const int j = idx / D, dd = idx % D;
      const bool ok = k0 + j < n;
      const size_t off = base + static_cast<size_t>(k0 + j) * D + dd;
      k_s[j][dd] = ok ? to_f32(k[off]) : 0.f;
      v_s[j][dd] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float s[kBlockN];
    float m_cur = kNegBig;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        part += q_r[i] * k_s[j][lane + kLanesPerRow * i];
      }
      // The four lanes of a row are adjacent; the butterfly leaves the
      // same sum in all four.
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int col = k0 + j;
      const bool keep = col < n && (!causal || col <= row);
      s[j] = keep ? part * scale : kNegBig;
      m_cur = fmaxf(m_cur, s[j]);
    }

    const float m_new = fmaxf(m, m_cur);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[i] *= corr;
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      const float p = expf(s[j] - m_new);
      p_sum += p;
      const float p_v = to_f32(from_f32<T>(p));  // p.astype(v.dtype)
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        acc[i] += p_v * v_s[j][lane + kLanesPerRow * i];
      }
    }
    l = corr * l + p_sum;
    m = m_new;
  }

  if (row_ok) {
    const float l_c = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int dd = lane + kLanesPerRow * i;
      o[base + static_cast<size_t>(row) * D + dd] = from_f32<T>(acc[i] / l_c);
    }
    if (lane == 0) lse[static_cast<size_t>(blockIdx.x) * n + row] = m + logf(l_c);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int n, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid(bh, (n + kBlockM - 1) / kBlockM);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      n, scale, causal != 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int n, int d, float scale,
                         int causal, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, n, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, n, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, n, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, n, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous (bh, n, d) in the dtype given by `dtype`
// (0 = float32, 1 = bfloat16); lse: contiguous float32 (bh, n).
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int bh, int n, int d,
                                   int dtype, float scale, int causal,
                                   void* stream) {
  if (bh <= 0 || n <= 0 || (n + kBlockM - 1) / kBlockM > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dim<float>(q, k, v, o, lse, bh, n, d, scale, causal, s);
    case 1: return dispatch_dim<__nv_bfloat16>(q, k, v, o, lse, bh, n, d, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
