// Flash-attention forward on the CUDA cores (sm_90a): kernel K1 of the
// PyTorch port, its f32 variant ("simt"). bf16 inputs take the tensor-core
// variant in flash_attention_mma.cu; f32 inputs stay here because the tensor
// cores would round them (TF32), and the f32 checks need true f32 products.
//
// Replaces open_genie_tpu/ops/pallas/flash_attention.py::_fwd_kernel (launched
// by _flash_forward). It computes the same thing: attention over (B*H, N, D)
// with an online softmax across key tiles, keeping an f32 running max m, an
// f32 running sum l and an f32 accumulator. Masked logits are -1e30 (not -inf)
// and l is clamped to 1e-30, as in the Pallas kernel. It writes o in f32 and
// the per-row logsumexp as (B*H, N).
//
// What bounds it on this card: f32 FMAs on the CUDA cores (67 TFLOP/s), a
// fifteenth of the bf16 tensor-core rate; it serves the f32 parity runs,
// which are small.
//
// What the design does about it: one launch per attention call and one block
// per (b*h, 64-row query tile), so the many tiny temporal problems become
// one grid. The Pallas grid's sequential k axis, which carried m, l and the
// accumulator in VMEM scratch from step to step, becomes a loop inside the
// block, so no state crosses blocks. Each K/V tile is staged once in shared
// memory and read by all 64 query rows; four threads share a query row, each
// owning every fourth feature, so the shared-memory reads are broadcast and
// conflict-free. Causal key tiles past the query tile's last row are
// skipped, and the ragged edge is masked inside the kernel: the wrapper
// never pads.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockM = 64;        // query rows per block
constexpr int kLanesPerRow = 4;    // threads sharing one query row
constexpr int kThreads = kBlockM * kLanesPerRow;
constexpr float kNegBig = -1e30f;  // the Pallas kernel's masked logit

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
    q_r[i] = row_ok ? q[base + static_cast<size_t>(row) * D + dd] : 0.f;
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
      k_s[j][dd] = ok ? k[off] : 0.f;
      v_s[j][dd] = ok ? v[off] : 0.f;
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
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        acc[i] += p * v_s[j][lane + kLanesPerRow * i];
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
      o[base + static_cast<size_t>(row) * D + dd] = acc[i] / l_c;
    }
    if (lane == 0) lse[static_cast<size_t>(blockIdx.x) * n + row] = m + logf(l_c);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int n, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid(bh, (n + kBlockM - 1) / kBlockM);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), n, scale, causal != 0);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous float32 (bh, n, d); lse: contiguous float32 (bh, n).
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int bh, int n, int d,
                                   float scale, int causal, void* stream) {
  if (bh <= 0 || n <= 0 || (n + kBlockM - 1) / kBlockM > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch<16>(q, k, v, o, lse, bh, n, scale, causal, s);
    case 32: return launch<32>(q, k, v, o, lse, bh, n, scale, causal, s);
    case 64: return launch<64>(q, k, v, o, lse, bh, n, scale, causal, s);
    case 128: return launch<128>(q, k, v, o, lse, bh, n, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
