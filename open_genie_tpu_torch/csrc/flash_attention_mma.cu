// Flash-attention forward on Hopper's tensor cores (sm_90a): kernel K1 of the
// PyTorch port, its bf16 variant ("mma"). f32 inputs take the CUDA-core
// variant in flash_attention.cu, which keeps true f32 products.
//
// Replaces open_genie_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (launched by _flash_forward) and computes what it computes: attention over
// (B*H, N, D) with an online softmax over key tiles, an f32 running max m,
// running sum l and accumulator; masked logits -1e30; l clamped to 1e-30; p
// rounded to bf16 before P.V. It writes o in bf16 and the natural-log
// logsumexp in f32 as (B*H, N), which K3, K4 and the plain twin read.
//
// What bounds it on this card: at D = 16 and 32, the shapes that dominate the
// training steps, one exponential per score costs more than the score's
// 4 D multiply-adds on the tensor cores (about 3.9 T exp/s against 989
// TFLOP/s bf16), so the special-function units set the floor; at D = 64 and
// above the tensor cores do. Short problems (N <= 17, B*H up to 65,536) are
// bound by the bytes they move and by launch latency.
//
// What the design does about it:
// - Each warp owns 16 query rows and keeps its Q fragments in registers for
//   the whole key loop. S = Q.K^T and O += P.V are mma.sync.m16n8k16 with
//   bf16 operands and f32 accumulation; P stays in registers, packed to bf16
//   straight into the A fragment of P.V, and V is read with ldmatrix.trans.
// - The softmax works on the accumulator fragments: a row's max takes two
//   quad shuffles and its sum none until the end (each lane keeps a partial
//   sum, rescaled like the accumulator). Scores become exponents with one FMA
//   (scale * log2 e folded in) and exp2f; m is kept in log2 units and
//   converted when lse is written.
// - K and V tiles of 64 keys are staged in shared memory as bf16, rows padded
//   by 16 bytes so ldmatrix is free of bank conflicts, and double-buffered
//   with 16-byte cp.async: the next tile's copy runs under this tile's math.
// - Causal: key tiles past the block's last row are never loaded, and within
//   a tile a warp skips the 16-key chunks past its own last row; only the
//   diagonal and ragged tiles are masked element by element. Ragged N is
//   masked in the kernel (the copies zero-fill past N), never padded.
// - Blocks of 4 warps (64 rows) when the grid fills the 132 SMs, 2 or 1
//   warps for short sequences or small grids (4 always at D = 128). The grid
//   is one-dimensional, row tiles of one head adjacent, so the blocks in
//   flight share K and V in L2.
// - No atomics: two calls give bit-identical results.

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int kBlockN = 64;  // keys per tile

template <int D, int W>
constexpr int fwd_smem_bytes() {
  return (16 * W + 4 * kBlockN) * (D + kPad) * static_cast<int>(sizeof(bf16));
}

template <int D, int W>
__global__ void __launch_bounds__(32 * W)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int n, int row_tiles, float scale_log2,
                     bool causal) {
  constexpr int kThreads = 32 * W;
  constexpr int kBlockM = 16 * W;
  constexpr int S = D + kPad;        // row stride of every tile
  constexpr int kKSteps = D / 16;    // k-steps of Q.K^T
  constexpr int kDTiles = D / 8;     // 8-wide column tiles of O
  constexpr int kChunks = kBlockN / 16;  // 16-key chunks of a tile

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kBlockM][S]
  bf16* kv_s = q_s + kBlockM * S;             // [stage][K, V][kBlockN][S]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x / row_tiles;
  const int q0 = (blockIdx.x % row_tiles) * kBlockM;
  const int wq0 = q0 + warp * 16;  // this warp's first row
  const size_t base = static_cast<size_t>(bh) * n * D;
  const bf16* qb = q + base;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  // Keys past the block's last row are fully masked under causal.
  const int k_end = causal ? min(q0 + kBlockM, n) : n;
  const int n_tiles = (k_end + kBlockN - 1) / kBlockN;
  // Keys this warp can see: chunks at or past it hold no unmasked score.
  const int k_lim = causal ? min(n, wq0 + 16) : n;

  load_tile<kBlockM, D, kThreads>(q_s, qb, q0, n, tid);
  load_tile<kBlockN, D, kThreads>(kv_s, kb, 0, n, tid);
  load_tile<kBlockN, D, kThreads>(kv_s + kBlockN * S, vb, 0, n, tid);
  cp_async_commit();

  uint32_t qf[kKSteps][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // Rows g and g + 8 of the warp: running max (log2 units) and this lane's
  // share of the running sum.
  float m_r[2] = {kNegBig, kNegBig};
  float l_r[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockN;
    if (t + 1 < n_tiles) {
      bf16* next = kv_s + ((t + 1) & 1) * 2 * kBlockN * S;
      load_tile<kBlockN, D, kThreads>(next, kb, k0 + kBlockN, n, tid);
      load_tile<kBlockN, D, kThreads>(next + kBlockN * S, vb, k0 + kBlockN, n, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) ldsm_x4(qf[ks], a_row<S>(q_s, warp * 16, ks * 16, lane));
    }
    const bf16* k_s = kv_s + (t & 1) * 2 * kBlockN * S;
    const bf16* v_s = k_s + kBlockN * S;

    // S = Q K^T, one pair of 8-key column tiles per 16-key chunk.
    float s[2 * kChunks][4];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[2 * c][i] = s[2 * c + 1][i] = 0.f;
      if (k0 + 16 * c < k_lim) {
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          uint32_t b[4];
          ldsm_x4(b, b_row<S>(k_s, 16 * c, ks * 16, lane));
          mma_bf16(s[2 * c], qf[ks], b[0], b[1]);
          mma_bf16(s[2 * c + 1], qf[ks], b[2], b[3]);
        }
      }
    }

    // Mask the diagonal and ragged tiles (skipped chunks included).
    if (k0 + kBlockN > n || (causal && k0 + kBlockN - 1 > wq0)) {
#pragma unroll
      for (int j = 0; j < 2 * kChunks; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = k0 + j * 8 + 2 * t4 + (i & 1);
          const int row = wq0 + g + (i >> 1) * 8;
          if (col >= n || (causal && col > row)) s[j][i] = kNegBig;
        }
      }
    }

    // Online softmax in log2 units on the fragments.
    float m_new[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 2 * kChunks; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_new[r] = fmaxf(m_r[r], mx * scale_log2);
      corr[r] = exp2f(m_r[r] - m_new[r]);
      m_r[r] = m_new[r];
    }
    float p_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2 * kChunks; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = exp2f(fmaf(s[j][i], scale_log2, -m_new[i >> 1]));
        p_sum[i >> 1] += s[j][i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = corr[r] * l_r[r] + p_sum[r];
#pragma unroll
    for (int i = 0; i < kDTiles; ++i) {
      acc[i][0] *= corr[0];
      acc[i][1] *= corr[0];
      acc[i][2] *= corr[1];
      acc[i][3] *= corr[1];
    }

    // O += P V, P rounded to bf16 in registers.
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (k0 + 16 * c < k_lim) {
        uint32_t a[4];
        pack_a(a, s[2 * c], s[2 * c + 1]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(b, bt_row<S>(v_s, 16 * c, dp * 16, lane));
          mma_bf16(acc[2 * dp], a, b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_c = fmaxf(l, 1e-30f);
    const int row = wq0 + g + 8 * r;
    if (row < n) {
      bf16* o_row = o + base + static_cast<size_t>(row) * D + 2 * t4;
#pragma unroll
      for (int i = 0; i < kDTiles; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * i) =
            __floats2bfloat162_rn(acc[i][2 * r] / l_c, acc[i][2 * r + 1] / l_c);
      }
      if (t4 == 0) lse[static_cast<size_t>(bh) * n + row] = (m_r[r] + log2f(l_c)) * kLn2;
    }
  }
}

template <int D, int W>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int n, float scale, int causal, cudaStream_t stream) {
  const int row_tiles = (n + 16 * W - 1) / (16 * W);
  const long long blocks = static_cast<long long>(bh) * row_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int smem = fwd_smem_bytes<D, W>();
  const cudaError_t err = allow_smem(flash_fwd_mma_kernel<D, W>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_mma_kernel<D, W><<<static_cast<unsigned>(blocks), 32 * W, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), n, row_tiles, scale * kLog2e,
      causal != 0);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_warps(const void* q, const void* k, const void* v, void* o, void* lse,
                           int bh, int n, float scale, int causal, cudaStream_t stream) {
  const int w = warps_for<D>(bh, n);
  if constexpr (D < 128) {
    if (w == 1) return launch<D, 1>(q, k, v, o, lse, bh, n, scale, causal, stream);
    if (w == 2) return launch<D, 2>(q, k, v, o, lse, bh, n, scale, causal, stream);
  }
  return launch<D, 4>(q, k, v, o, lse, bh, n, scale, causal, stream);
}

}  // namespace

// q, k, v, o: contiguous bf16 (bh, n, d), 16-byte aligned; lse: contiguous
// float32 (bh, n). Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd_mma(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int bh, int n, int d, float scale,
                                       int causal, void* stream) {
  if (bh <= 0 || n <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return dispatch_warps<16>(q, k, v, o, lse, bh, n, scale, causal, s);
    case 32: return dispatch_warps<32>(q, k, v, o, lse, bh, n, scale, causal, s);
    case 64: return dispatch_warps<64>(q, k, v, o, lse, bh, n, scale, causal, s);
    case 128: return dispatch_warps<128>(q, k, v, o, lse, bh, n, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}
