// Flash-attention backward on the CUDA cores (sm_90a): the f32 variants
// ("simt") of kernels K3 and K4 of the PyTorch port. bf16 takes the
// tensor-core variants, K3 in flash_attention_bwd_mma.cu and K4 in
// flash_attention_bwd_dq_mma.cu; f32 stays here because the tensor cores
// would round it (TF32).
//
// K3 (flash_bwd_dkv_kernel) replaces
// open_genie_tpu/ops/pallas/flash_attention.py::_bwd_dkv_kernel and K4
// (flash_bwd_dq_kernel) replaces ::_bwd_dq_kernel (both launched by
// _flash_backward). They compute the same thing, the standard flash-attention
// gradient from the forward's saved (q, k, v, o, lse):
//
//   p_ij  = exp(scale * q_i.k_j - lse_i)   recomputed, masked logits -1e30
//   dv_j  = sum_i p_ij dO_i
//   ds_ij = p_ij (dO_i.v_j - delta_i)
//   dk_j  = scale * sum_i ds_ij q_i
//   dq_i  = scale * sum_j ds_ij k_j
//
// with delta_i = rowsum(dO_i * o_i) computed by the caller, f32 throughout
// (the Pallas kernels' roundings of p and ds to the operand dtype are no-ops
// in f32). Causal means key <= query; ragged N is masked inside the kernels,
// never padded.
//
// What bounds them on this card: the O(N^2) recompute on the CUDA cores at
// 67 TFLOP/s f32; the training paths run in bf16 and do not reach them.
//
// What the design does about it: the Pallas grid's sequential accumulation
// axis becomes a loop inside one block. K3 runs one block per (b*h, 64-key
// tile) and loops over query tiles; K4 one block per (b*h, 64-query tile) and
// loops over key tiles. Every accumulator stays in registers of the block that
// owns its rows, so there are no atomics and both kernels are deterministic.
// As in K1, four threads share a row and each owns every fourth feature: the
// tile staged in shared memory is read by broadcast without bank conflicts,
// and each dot product ends in a two-step butterfly. Causal tiles that cannot
// contribute are skipped.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockRows = 64;     // rows a block owns (keys in K3, queries in K4)
constexpr int kLanesPerRow = 4;    // threads sharing one row
constexpr int kThreads = kBlockRows * kLanesPerRow;

// The four lanes of a row are adjacent; the butterfly leaves the row's sum
// in all four. Every lane of the warp must call it.
__device__ __forceinline__ float row_sum(float part) {
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

// K3: dk, dv for one (b*h, 64-key tile), looping over query tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int n, float scale, bool causal) {
  constexpr int kTileQ = D >= 128 ? 32 : 64;  // keeps the Q/dO tiles at 32 KB
  constexpr int kDimsPerLane = D / kLanesPerRow;
  __shared__ float q_s[kTileQ][D];
  __shared__ float do_s[kTileQ][D];
  __shared__ float lse_s[kTileQ];
  __shared__ float delta_s[kTileQ];

  const int tid = threadIdx.x;
  const int lane = tid % kLanesPerRow;  // owns features lane, lane + 4, ...
  const int k0 = blockIdx.y * kBlockRows;
  const int col = k0 + tid / kLanesPerRow;  // this thread's key
  const bool col_ok = col < n;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * D;
  const size_t row_base = static_cast<size_t>(blockIdx.x) * n;

  float k_r[kDimsPerLane], v_r[kDimsPerLane];
  float dk_acc[kDimsPerLane], dv_acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) {
    const size_t off = base + static_cast<size_t>(col) * D + lane + kLanesPerRow * i;
    k_r[i] = col_ok ? k[off] : 0.f;
    v_r[i] = col_ok ? v[off] : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  // Causal: queries before the tile's first key see none of its keys.
  for (int q0 = causal ? k0 : 0; q0 < n; q0 += kTileQ) {
    __syncthreads();  // every row is done with the previous tile
    for (int idx = tid; idx < kTileQ * D; idx += kThreads) {
      const int i = idx / D, dd = idx % D;
      const bool ok = q0 + i < n;
      const size_t off = base + static_cast<size_t>(q0 + i) * D + dd;
      q_s[i][dd] = ok ? q[off] : 0.f;
      do_s[i][dd] = ok ? dout[off] : 0.f;
    }
    for (int i = tid; i < kTileQ; i += kThreads) {
      const bool ok = q0 + i < n;
      lse_s[i] = ok ? lse[row_base + q0 + i] : 0.f;
      delta_s[i] = ok ? delta[row_base + q0 + i] : 0.f;
    }
    __syncthreads();

    for (int i = 0; i < kTileQ; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < kDimsPerLane; ++j) {
        s += q_s[i][lane + kLanesPerRow * j] * k_r[j];
        dp += do_s[i][lane + kLanesPerRow * j] * v_r[j];
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int row = q0 + i;
      const bool keep = col_ok && row < n && (!causal || col <= row);
      const float p = keep ? expf(s * scale - lse_s[i]) : 0.f;
      const float ds = p * (dp - delta_s[i]);
#pragma unroll
      for (int j = 0; j < kDimsPerLane; ++j) {
        dv_acc[j] += p * do_s[i][lane + kLanesPerRow * j];
        dk_acc[j] += ds * q_s[i][lane + kLanesPerRow * j];
      }
    }
  }

  if (col_ok) {
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const size_t off = base + static_cast<size_t>(col) * D + lane + kLanesPerRow * i;
      dk[off] = scale * dk_acc[i];
      dv[off] = dv_acc[i];
    }
  }
}

// K4: dq for one (b*h, 64-query tile), looping over key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int n,
                    float scale, bool causal) {
  constexpr int kTileK = D >= 128 ? 32 : 64;  // keeps the K/V tiles at 32 KB
  constexpr int kDimsPerLane = D / kLanesPerRow;
  __shared__ float k_s[kTileK][D];
  __shared__ float v_s[kTileK][D];

  const int tid = threadIdx.x;
  const int lane = tid % kLanesPerRow;
  const int q0 = blockIdx.y * kBlockRows;
  const int row = q0 + tid / kLanesPerRow;  // this thread's query
  const bool row_ok = row < n;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * D;
  const size_t row_base = static_cast<size_t>(blockIdx.x) * n;

  float q_r[kDimsPerLane], do_r[kDimsPerLane], dq_acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) {
    const size_t off = base + static_cast<size_t>(row) * D + lane + kLanesPerRow * i;
    q_r[i] = row_ok ? q[off] : 0.f;
    do_r[i] = row_ok ? dout[off] : 0.f;
    dq_acc[i] = 0.f;
  }
  const float lse_r = row_ok ? lse[row_base + row] : 0.f;
  const float delta_r = row_ok ? delta[row_base + row] : 0.f;

  // Causal: key tiles starting past the tile's last query are fully masked.
  const int k_end = causal ? min(q0 + kBlockRows, n) : n;
  for (int k0 = 0; k0 < k_end; k0 += kTileK) {
    __syncthreads();
    for (int idx = tid; idx < kTileK * D; idx += kThreads) {
      const int j = idx / D, dd = idx % D;
      const bool ok = k0 + j < n;
      const size_t off = base + static_cast<size_t>(k0 + j) * D + dd;
      k_s[j][dd] = ok ? k[off] : 0.f;
      v_s[j][dd] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < kTileK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        s += q_r[i] * k_s[j][lane + kLanesPerRow * i];
        dp += do_r[i] * v_s[j][lane + kLanesPerRow * i];
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int col = k0 + j;
      const bool keep = row_ok && col < n && (!causal || col <= row);
      const float p = keep ? expf(s * scale - lse_r) : 0.f;
      const float ds = p * (dp - delta_r);
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        dq_acc[i] += ds * k_s[j][lane + kLanesPerRow * i];
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const size_t off = base + static_cast<size_t>(row) * D + lane + kLanesPerRow * i;
      dq[off] = scale * dq_acc[i];
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int bh, n;
  float scale;
  bool causal;
  cudaStream_t stream;
};

bool valid(const Args& a) {
  return a.bh > 0 && a.n > 0 && (a.n + kBlockRows - 1) / kBlockRows <= 65535;
}

dim3 grid_of(const Args& a) { return dim3(a.bh, (a.n + kBlockRows - 1) / kBlockRows); }

template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  flash_bwd_dkv_kernel<D><<<grid_of(a), kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.n, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  flash_bwd_dq_kernel<D><<<grid_of(a), kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.n, a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dk, dv: contiguous float32 (bh, n, d); lse, delta:
// contiguous float32 (bh, n). Returns the CUDA error of its launch (0 on
// success). bf16 K3 is flash_attention_bwd_dkv_mma.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int n, int d,
                                       float scale, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, bh, n, scale, causal != 0,
               static_cast<cudaStream_t>(stream)};
  if (!valid(a)) return cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch_dkv<16>(a, dk, dv);
    case 32: return launch_dkv<32>(a, dk, dv);
    case 64: return launch_dkv<64>(a, dk, dv);
    case 128: return launch_dkv<128>(a, dk, dv);
    default: return cudaErrorInvalidValue;
  }
}

// q, k, v, dout, dq: contiguous float32 (bh, n, d); lse, delta: contiguous
// float32 (bh, n). Returns the CUDA error of its launch (0 on success). bf16
// K4 is flash_attention_bwd_dq_mma.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int bh, int n, int d,
                                      float scale, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, bh, n, scale, causal != 0,
               static_cast<cudaStream_t>(stream)};
  if (!valid(a)) return cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch_dq<16>(a, dq);
    case 32: return launch_dq<32>(a, dq);
    case 64: return launch_dq<64>(a, dq);
    case 128: return launch_dq<128>(a, dq);
    default: return cudaErrorInvalidValue;
  }
}
