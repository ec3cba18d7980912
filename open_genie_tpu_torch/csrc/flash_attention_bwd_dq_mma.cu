// Flash-attention dq backward on Hopper's tensor cores (sm_90a): kernel K4
// of the PyTorch port, its bf16 variant ("mma"). f32 inputs take the
// CUDA-core variant in flash_attention_bwd.cu, which keeps true f32 products.
//
// Replaces open_genie_tpu/ops/pallas/flash_attention.py::_bwd_dq_kernel
// (launched by _flash_backward) and computes what it computes, from the
// forward's lse and the caller's delta = rowsum(dO * o) in f32:
//
//   p_ij  = exp(scale * q_i.k_j - lse_i)        recomputed; masked entries 0
//   ds_ij = bf16(p_ij (dO_i.v_j - delta_i))      ds.astype(k.dtype)
//   dq_i  = scale * sum_j ds_ij k_j              f32 accumulation, written in bf16
//
// Causal means key <= query; ragged N is masked in the kernel, never padded.
//
// What bounds it on this card: one exponential per (query, key) pair against
// 6 D tensor-core operations, so at D = 16 and 32 the special-function units
// set the floor and at D = 64 and above the tensor cores; short problems
// (the causal temporal calls, N = 16) are bound by bytes and launch latency.
//
// What the design does about it:
// - K1's loop with three products instead of two. Each warp owns 16 queries;
//   their Q and dO fragments stay in registers for the whole key loop (in
//   shared memory at D = 128, where registers would spill), beside lse (in
//   log2 units) and delta of the lane's two rows.
// - K and V tiles of 64 keys are staged as bf16 in padded rows and
//   double-buffered with cp.async. Per 16-key chunk, so that only 16 score
//   registers are live, every product is mma.sync.m16n8k16 with bf16 operands
//   and f32 accumulation:
//     S   = Q K^T                  (K with ldmatrix, keys as the n index)
//     P   = exp2(S * scale log2 e - lse log2 e)
//     dP  = dO V^T                 (V likewise)
//     dS  = P (dP - delta), packed to bf16 straight into an A fragment
//     dQ += dS K                   (K with ldmatrix.trans, keys as the k index)
//   and dQ is scaled once, when it is written.
// - dQ accumulates in f32 registers of the warp that owns the queries: no
//   atomics, so two calls give bit-identical results.
// - Causal: key tiles past the block's last query are never loaded, a warp
//   skips the 16-key chunks past its own last query, and only diagonal and
//   ragged chunks are masked element by element.
// - Blocks of 1, 2 or 4 warps from the grid (K1's warps_for), on a
//   one-dimensional grid with the query tiles of one head adjacent, so that
//   K and V are shared in L2. Problems of N <= 16 in one-warp blocks take
//   16-key tiles: a 64-key tile there would be three quarters zero-fill, and
//   the smaller tile's shared memory lets twice as many blocks share an SM.

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

template <int D, int W, int BN>
constexpr int dq_smem_bytes() {
  return (2 * 16 * W + 4 * BN) * (D + kPad) * static_cast<int>(sizeof(bf16));
}

// W warps of 16 queries each; key tiles of BN (16 or 64) keys.
template <int D, int W, int BN>
__global__ void __launch_bounds__(32 * W)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int n, int row_tiles, float scale,
                        float scale_log2, bool causal) {
  constexpr int kThreads = 32 * W;
  constexpr int kBlockM = 16 * W;      // queries per block
  constexpr int S = D + kPad;          // row stride of every tile
  constexpr int kKSteps = D / 16;      // k-steps of Q.K^T and dO.V^T
  constexpr int kDTiles = D / 8;       // 8-wide column tiles of dQ
  constexpr int kChunks = BN / 16;     // 16-key chunks of a tile
  constexpr bool kQInRegs = D <= 64;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kBlockM][S]
  bf16* do_s = q_s + kBlockM * S;             // [kBlockM][S]
  bf16* kv_s = do_s + kBlockM * S;            // [stage][K, V][BN][S]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x / row_tiles;
  const int q0 = (blockIdx.x % row_tiles) * kBlockM;
  const int wq0 = q0 + warp * 16;  // this warp's first query
  const size_t base = static_cast<size_t>(bh) * n * D;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  // Keys past the block's last query are fully masked under causal.
  const int k_end = causal ? min(q0 + kBlockM, n) : n;
  const int n_tiles = (k_end + BN - 1) / BN;
  // Keys this warp can see: chunks at or past it hold no unmasked score.
  const int k_lim = causal ? min(n, wq0 + 16) : n;

  load_tile<kBlockM, D, kThreads>(q_s, q + base, q0, n, tid);
  load_tile<kBlockM, D, kThreads>(do_s, dout + base, q0, n, tid);
  load_tile<BN, D, kThreads>(kv_s, kb, 0, n, tid);
  load_tile<BN, D, kThreads>(kv_s + BN * S, vb, 0, n, tid);
  cp_async_commit();

  // Rows g and g + 8 of the warp: lse in log2 units and delta (0 past n,
  // where nothing is written).
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    const size_t off = static_cast<size_t>(bh) * n + row;
    lse_r[r] = row < n ? lse[off] * kLog2e : 0.f;
    delta_r[r] = row < n ? delta[off] : 0.f;
  }

  uint32_t qf[kQInRegs ? kKSteps : 1][4], dof[kQInRegs ? kKSteps : 1][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    if (t + 1 < n_tiles) {
      bf16* next = kv_s + ((t + 1) & 1) * 2 * BN * S;
      load_tile<BN, D, kThreads>(next, kb, k0 + BN, n, tid);
      load_tile<BN, D, kThreads>(next + BN * S, vb, k0 + BN, n, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQInRegs) {
      if (t == 0) {
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          ldsm_x4(qf[ks], a_row<S>(q_s, warp * 16, ks * 16, lane));
          ldsm_x4(dof[ks], a_row<S>(do_s, warp * 16, ks * 16, lane));
        }
      }
    }
    const bf16* k_s = kv_s + (t & 1) * 2 * BN * S;
    const bf16* v_s = k_s + BN * S;

#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int c0 = k0 + 16 * c;  // the chunk's first key
      if (c0 < k_lim) {
        // S = Q K^T and dP = dO V^T, two 8-key column tiles each.
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          uint32_t a[4], b[4];
          if constexpr (kQInRegs) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = qf[ks][i];
          } else {
            ldsm_x4(a, a_row<S>(q_s, warp * 16, ks * 16, lane));
          }
          ldsm_x4(b, b_row<S>(k_s, 16 * c, ks * 16, lane));
          mma_bf16(s[0], a, b[0], b[1]);
          mma_bf16(s[1], a, b[2], b[3]);
          if constexpr (kQInRegs) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = dof[ks][i];
          } else {
            ldsm_x4(a, a_row<S>(do_s, warp * 16, ks * 16, lane));
          }
          ldsm_x4(b, b_row<S>(v_s, 16 * c, ks * 16, lane));
          mma_bf16(dp[0], a, b[0], b[1]);
          mma_bf16(dp[1], a, b[2], b[3]);
        }

        // P and dS = P (dP - delta) on the fragments; only the diagonal
        // and ragged chunks are masked.
        const bool masked = c0 + 16 > n || (causal && c0 + 15 > wq0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = c0 + 8 * h + 2 * t4 + (i & 1);
            const int row = wq0 + g + (i >> 1) * 8;
            const bool keep = !masked || (col < n && (!causal || col <= row));
            const float p = keep ? exp2f(fmaf(s[h][i], scale_log2, -lse_r[i >> 1])) : 0.f;
            s[h][i] = p * (dp[h][i] - delta_r[i >> 1]);
          }
        }

        // dQ += dS K, dS rounded to bf16 in registers.
        uint32_t a[4];
        pack_a(a, s[0], s[1]);
#pragma unroll
        for (int dt = 0; dt < D / 16; ++dt) {
          uint32_t b[4];
          ldsm_x4_trans(b, bt_row<S>(k_s, 16 * c, dt * 16, lane));
          mma_bf16(acc[2 * dt], a, b[0], b[1]);
          mma_bf16(acc[2 * dt + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wq0 + g + 8 * r;
    if (row < n) {
      bf16* dq_row = dq + base + static_cast<size_t>(row) * D + 2 * t4;
#pragma unroll
      for (int i = 0; i < kDTiles; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(dq_row + 8 * i) =
            __floats2bfloat162_rn(scale * acc[i][2 * r], scale * acc[i][2 * r + 1]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void* dq;
  int bh, n;
  float scale;
  bool causal;
  cudaStream_t stream;
};

template <int D, int W, int BN>
cudaError_t launch(const Args& a) {
  const int row_tiles = (a.n + 16 * W - 1) / (16 * W);
  const long long blocks = static_cast<long long>(a.bh) * row_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int smem = dq_smem_bytes<D, W, BN>();
  const cudaError_t err = allow_smem(flash_bwd_dq_mma_kernel<D, W, BN>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma_kernel<D, W, BN><<<static_cast<unsigned>(blocks), 32 * W, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dq), a.n, row_tiles, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

// Warps from the grid; 16-key tiles for N <= 16 in one-warp blocks, where
// they measured 2 to 15% faster than 64-key tiles on an H100, else 64.
template <int D>
cudaError_t dispatch_warps(const Args& a) {
  const int w = warps_for<D>(a.bh, a.n);
  if constexpr (D < 128) {
    if (w == 1) return a.n <= 16 ? launch<D, 1, 16>(a) : launch<D, 1, 64>(a);
    if (w == 2) return launch<D, 2, 64>(a);
  }
  return launch<D, 4, 64>(a);
}

}  // namespace

// q, k, v, dout, dq: contiguous bf16 (bh, n, d), 16-byte aligned; lse,
// delta: contiguous float32 (bh, n). Returns the CUDA error of the launch
// (0 on success).
extern "C" int flash_attention_bwd_dq_mma(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, int bh, int n, int d,
                                          float scale, int causal, void* stream) {
  if (bh <= 0 || n <= 0) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, dq, bh, n, scale, causal != 0,
               static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 16: return dispatch_warps<16>(a);
    case 32: return dispatch_warps<32>(a);
    case 64: return dispatch_warps<64>(a);
    case 128: return dispatch_warps<128>(a);
    default: return cudaErrorInvalidValue;
  }
}
