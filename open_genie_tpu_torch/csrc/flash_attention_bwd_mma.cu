// Flash-attention dk/dv backward on Hopper's tensor cores (sm_90a): kernel K3
// of the PyTorch port, its bf16 variant ("mma"). f32 inputs take the
// CUDA-core variant in flash_attention_bwd.cu, which keeps true f32 products.
// K4 (dq) has its own tensor-core kernel in flash_attention_bwd_dq_mma.cu.
//
// Replaces open_genie_tpu/ops/pallas/flash_attention.py::_bwd_dkv_kernel
// (launched by _flash_backward) and computes what it computes, from the
// forward's lse and the caller's delta = rowsum(dO * o) in f32:
//
//   p_ij  = exp(scale * q_i.k_j - lse_i)   recomputed; masked entries 0
//   dv_j  = sum_i bf16(p_ij) dO_i
//   dk_j  = scale * sum_i bf16(p_ij (dO_i.v_j - delta_i)) q_i
//
// with f32 accumulation, dk and dv written in bf16. Causal means key <=
// query; ragged N is masked in the kernel, never padded.
//
// What bounds it on this card: like K1, one exponential per (query, key)
// pair against 8 D tensor-core operations, so at D = 16 and 32 the
// special-function units set the floor and at D = 64 and above the tensor
// cores; short problems are bound by bytes and launch latency.
//
// What the design does about it:
// - Each warp owns 16 keys; their K and V fragments stay in registers for the
//   whole loop (in shared memory at D = 128, where registers would spill).
//   The block walks query tiles of 64 (32 at D = 128 and in one-warp
//   blocks), with Q and dO staged as bf16 in padded rows and double-buffered
//   with cp.async, lse and delta beside them.
// - Every product is mma.sync.m16n8k16 with bf16 operands and f32
//   accumulation, and all are computed transposed, keys as rows, so that no
//   fragment is transposed in registers:
//     S^T  = K Q^T        (Q read with ldmatrix)
//     P^T  = exp2(S^T * scale log2 e - lse log2 e), lse along the columns
//     dV  += P^T dO       (P^T packed to bf16 as the A fragment, dO with
//                          ldmatrix.trans)
//     dP^T = V dO^T
//     dS^T = P^T (dP^T - delta), packed to bf16
//     dK  += dS^T Q       (Q with ldmatrix.trans)
// - dK and dV accumulate in f32 registers of the block that owns the keys:
//   no atomics, so two calls give bit-identical results.
// - Causal: query tiles before the block's first key are never loaded, and a
//   warp skips the 16-query chunks before its own first key; only diagonal
//   and ragged tiles are masked element by element.
// - Blocks of 4 warps (64 keys) when the grid fills the card, fewer for
//   short sequences or small grids (never at D = 128); a one-dimensional
//   grid with the key tiles of one head adjacent, so that Q and dO are
//   shared in L2.

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

// Queries per tile: 64, or 32 at D = 128 and in one-warp blocks (the short
// temporal problems), where 64 would spill registers.
template <int D, int W>
__host__ __device__ constexpr int bwd_block_q() {
  return D >= 128 || W == 1 ? 32 : 64;
}

template <int D, int W>
constexpr int bwd_smem_bytes() {
  return (2 * 16 * W + 4 * bwd_block_q<D, W>()) * (D + kPad) * static_cast<int>(sizeof(bf16)) +
         4 * bwd_block_q<D, W>() * static_cast<int>(sizeof(float));
}

template <int D, int W>
__global__ void __launch_bounds__(32 * W)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int key_tiles,
                         float scale, float scale_log2, bool causal) {
  constexpr int kThreads = 32 * W;
  constexpr int kBlockK = 16 * W;           // keys per block
  constexpr int kBlockQ = bwd_block_q<D, W>();  // queries per tile
  constexpr int S = D + kPad;
  constexpr int kKSteps = D / 16;
  constexpr int kDTiles = D / 8;
  constexpr int kChunks = kBlockQ / 16;     // 16-query chunks of a tile
  constexpr bool kKVInRegs = D <= 64;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [kBlockK][S]
  bf16* v_s = k_s + kBlockK * S;              // [kBlockK][S]
  bf16* qdo_s = v_s + kBlockK * S;            // [stage][Q, dO][kBlockQ][S]
  float* stat_s = reinterpret_cast<float*>(qdo_s + 4 * kBlockQ * S);  // [stage][lse, delta][kBlockQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x / key_tiles;
  const int k0 = (blockIdx.x % key_tiles) * kBlockK;
  const int wk0 = k0 + warp * 16;  // this warp's first key
  const size_t base = static_cast<size_t>(bh) * n * D;
  const bf16* qb = q + base;
  const bf16* dob = dout + base;
  const float* lseb = lse + static_cast<size_t>(bh) * n;
  const float* deltab = delta + static_cast<size_t>(bh) * n;

  // Queries before the block's first key see none of its keys.
  const int q_begin = causal ? (k0 / kBlockQ) * kBlockQ : 0;
  const int n_tiles = (n - q_begin + kBlockQ - 1) / kBlockQ;

  auto load_stage = [&](int stage, int q0) {
    bf16* qs = qdo_s + stage * 2 * kBlockQ * S;
    float* st = stat_s + stage * 2 * kBlockQ;
    load_tile<kBlockQ, D, kThreads>(qs, qb, q0, n, tid);
    load_tile<kBlockQ, D, kThreads>(qs + kBlockQ * S, dob, q0, n, tid);
    load_vec<kBlockQ, kThreads>(st, lseb, q0, n, tid);
    load_vec<kBlockQ, kThreads>(st + kBlockQ, deltab, q0, n, tid);
  };
  load_tile<kBlockK, D, kThreads>(k_s, k + base, k0, n, tid);
  load_tile<kBlockK, D, kThreads>(v_s, v + base, k0, n, tid);
  load_stage(0, q_begin);
  cp_async_commit();

  uint32_t kf[kKVInRegs ? kKSteps : 1][4], vf[kKVInRegs ? kKSteps : 1][4];
  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_begin + t * kBlockQ;
    if (t + 1 < n_tiles) {
      load_stage((t + 1) & 1, q0 + kBlockQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kKVInRegs) {
      if (t == 0) {
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          ldsm_x4(kf[ks], a_row<S>(k_s, warp * 16, ks * 16, lane));
          ldsm_x4(vf[ks], a_row<S>(v_s, warp * 16, ks * 16, lane));
        }
      }
    }
    const bf16* q_s = qdo_s + (t & 1) * 2 * kBlockQ * S;
    const bf16* do_s = q_s + kBlockQ * S;
    const float* lse_s = stat_s + (t & 1) * 2 * kBlockQ;
    const float* delta_s = lse_s + kBlockQ;

    // Which 16-query chunks hold a score this warp keeps.
    bool live[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      live[c] = q0 + 16 * c < n && (!causal || q0 + 16 * c + 15 >= wk0);
    }

    // S^T = K Q^T.
    float p[2 * kChunks][4];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) p[2 * c][i] = p[2 * c + 1][i] = 0.f;
      if (live[c]) {
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          uint32_t a[4], b[4];
          if constexpr (kKVInRegs) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = kf[ks][i];
          } else {
            ldsm_x4(a, a_row<S>(k_s, warp * 16, ks * 16, lane));
          }
          ldsm_x4(b, b_row<S>(q_s, 16 * c, ks * 16, lane));
          mma_bf16(p[2 * c], a, b[0], b[1]);
          mma_bf16(p[2 * c + 1], a, b[2], b[3]);
        }
      }
    }

    // P^T = exp(scale S^T - lse), lse along the columns (queries).
    const bool masked = q0 + kBlockQ > n || (causal && q0 < wk0 + 16);
#pragma unroll
    for (int j = 0; j < 2 * kChunks; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = j * 8 + 2 * t4 + (i & 1);  // query within the tile
        const int key = wk0 + g + (i >> 1) * 8;
        const bool keep = !masked || (q0 + col < n && (!causal || key <= q0 + col));
        p[j][i] = keep ? exp2f(fmaf(p[j][i], scale_log2, -lse_s[col] * kLog2e)) : 0.f;
      }
    }

    // dV += P^T dO, P^T rounded to bf16 (p.astype(do.dtype)).
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (live[c]) {
        uint32_t a[4];
        pack_a(a, p[2 * c], p[2 * c + 1]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(b, bt_row<S>(do_s, 16 * c, dp * 16, lane));
          mma_bf16(dv_acc[2 * dp], a, b[0], b[1]);
          mma_bf16(dv_acc[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }

    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) rounded to bf16, and
    // dK += dS^T Q, one 16-query chunk at a time.
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (live[c]) {
        float dpt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          uint32_t a[4], b[4];
          if constexpr (kKVInRegs) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = vf[ks][i];
          } else {
            ldsm_x4(a, a_row<S>(v_s, warp * 16, ks * 16, lane));
          }
          ldsm_x4(b, b_row<S>(do_s, 16 * c, ks * 16, lane));
          mma_bf16(dpt[0], a, b[0], b[1]);
          mma_bf16(dpt[1], a, b[2], b[3]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = (2 * c + h) * 8 + 2 * t4 + (i & 1);
            dpt[h][i] = p[2 * c + h][i] * (dpt[h][i] - delta_s[col]);
          }
        }
        uint32_t a[4];
        pack_a(a, dpt[0], dpt[1]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(b, bt_row<S>(q_s, 16 * c, dp * 16, lane));
          mma_bf16(dk_acc[2 * dp], a, b[0], b[1]);
          mma_bf16(dk_acc[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = wk0 + g + 8 * r;
    if (key < n) {
      const size_t off = base + static_cast<size_t>(key) * D + 2 * t4;
#pragma unroll
      for (int i = 0; i < kDTiles; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * i) =
            __floats2bfloat162_rn(scale * dk_acc[i][2 * r], scale * dk_acc[i][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * i) =
            __floats2bfloat162_rn(dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dk, *dv;
  int bh, n;
  float scale;
  bool causal;
  cudaStream_t stream;
};

template <int D, int W>
cudaError_t launch(const Args& a) {
  const int key_tiles = (a.n + 16 * W - 1) / (16 * W);
  const long long blocks = static_cast<long long>(a.bh) * key_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int smem = bwd_smem_bytes<D, W>();
  const cudaError_t err = allow_smem(flash_bwd_dkv_mma_kernel<D, W>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_mma_kernel<D, W><<<static_cast<unsigned>(blocks), 32 * W, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.n, key_tiles, a.scale,
      a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_warps(const Args& a) {
  const int w = warps_for<D>(a.bh, a.n);
  if constexpr (D < 128) {
    if (w == 1) return launch<D, 1>(a);
    if (w == 2) return launch<D, 2>(a);
  }
  return launch<D, 4>(a);
}

}  // namespace

// q, k, v, dout, dk, dv: contiguous bf16 (bh, n, d), 16-byte aligned; lse,
// delta: contiguous float32 (bh, n). Returns the CUDA error of the launch
// (0 on success).
extern "C" int flash_attention_bwd_dkv_mma(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int bh,
                                           int n, int d, float scale, int causal,
                                           void* stream) {
  if (bh <= 0 || n <= 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, dk, dv, bh, n, scale, causal != 0,
               static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 16: return dispatch_warps<16>(a);
    case 32: return dispatch_warps<32>(a);
    case 64: return dispatch_warps<64>(a);
    case 128: return dispatch_warps<128>(a);
    default: return cudaErrorInvalidValue;
  }
}
