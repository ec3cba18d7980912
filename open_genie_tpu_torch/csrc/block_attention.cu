// Grouped-query attention of one block of queries over a cached key/value
// prefix, for Hopper (sm_90a): kernel K9 of the PyTorch port.
//
// Replaces no TPU kernel: the JAX package has no grouped-query attention.
// A refinement or a commit of block diffusion
// (modules/attention.py::BlockCausalAttention) has N query tokens (one
// block) that all see the same keys, the cache's [0, end); inside the block
// attention is bidirectional, so no mask but the end. What it computes, for
// each row b and query head i over key/value head i / (n_head / n_kv_head):
// softmax(q k^T * scale) v over the keys [0, end), with an f32 running max,
// sum and accumulator and the probabilities rounded to bf16 before the
// value product, as flash attention does; o in bf16.
//
// What bounds it on this card: the bytes of the cache. At the cell's shape
// (64 rows, 4 key/value heads of 128, up to 1,280 keys) a layer pass reads
// up to 84 MB of keys and values, 25 us at 3.35 TB/s, against 2 x 32 query
// rows of products a key, which the tensor cores do in a fraction of that.
//
// What the design does about it: one block per (row, key/value head) takes
// the G = n_head / n_kv_head query heads that share that head, G x N query
// rows (16 a warp, zero-padded), so each key and value of the prefix is
// read once from the bf16 cache as it lies: no copy, no cast, no repeat
// over the query heads. The key loop is K1's (flash_attention_mma.cu): K
// and V tiles of 64 keys double-buffered in padded shared memory by 16-byte
// cp.async, S = Q K^T and O += P V as bf16 mma.sync.m16n8k16 with f32
// accumulation, the online softmax on the accumulator fragments in log2
// units; only the last, ragged tile is masked. q may be a view whose heads
// are contiguous (a slice of the fused projection's heads): its rows are
// gathered by their strides as they are copied. No atomics: two calls are
// bit-identical.

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int kBlockN = 64;  // keys per tile

template <int D, int W>
constexpr int smem_bytes() {
  return (16 * W + 4 * kBlockN) * (D + kPad) * static_cast<int>(sizeof(bf16));
}

template <int D, int W>
__global__ void __launch_bounds__(32 * W)
block_attention_kernel(const bf16* __restrict__ q, long long q_sb, long long q_sn,
                       const bf16* __restrict__ k, const bf16* __restrict__ v,
                       bf16* __restrict__ o, int n_tok, int nq, int nk, int t_max, int end,
                       float scale_log2) {
  constexpr int kThreads = 32 * W;
  constexpr int kRows = 16 * W;
  constexpr int S = D + kPad;            // row stride of every tile
  constexpr int kKSteps = D / 16;        // k-steps of Q.K^T
  constexpr int kDTiles = D / 8;         // 8-wide column tiles of O
  constexpr int kChunks = kBlockN / 16;  // 16-key chunks of a tile
  constexpr int kRowChunks = D / 8;      // 16-byte chunks of a row

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [kRows][S]
  bf16* kv_s = q_s + kRows * S;               // [stage][K, V][kBlockN][S]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.x / nk, h = blockIdx.x % nk;
  const int group = nq / nk, rows = group * n_tok;  // query row r: head h G + r / N, token r % N
  const size_t base = (static_cast<size_t>(b) * nk + h) * t_max * D;
  const bf16* kb = k + base;
  const bf16* vb = v + base;

  for (int i = tid; i < kRows * kRowChunks; i += kThreads) {
    const int r = i / kRowChunks, c = i % kRowChunks;
    const bool ok = r < rows;
    const bf16* src = !ok ? q
        : q + b * q_sb + (r % n_tok) * q_sn + static_cast<long long>(h * group + r / n_tok) * D
              + c * 8;
    cp_async16(q_s + r * S + c * 8, src, ok);
  }
  load_tile<kBlockN, D, kThreads>(kv_s, kb, 0, end, tid);
  load_tile<kBlockN, D, kThreads>(kv_s + kBlockN * S, vb, 0, end, tid);
  cp_async_commit();

  const int n_tiles = (end + kBlockN - 1) / kBlockN;
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
      load_tile<kBlockN, D, kThreads>(next, kb, k0 + kBlockN, end, tid);
      load_tile<kBlockN, D, kThreads>(next + kBlockN * S, vb, k0 + kBlockN, end, tid);
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
      if (k0 + 16 * c < end) {
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          uint32_t bk[4];
          ldsm_x4(bk, b_row<S>(k_s, 16 * c, ks * 16, lane));
          mma_bf16(s[2 * c], qf[ks], bk[0], bk[1]);
          mma_bf16(s[2 * c + 1], qf[ks], bk[2], bk[3]);
        }
      }
    }

    // Mask the keys past the end (skipped chunks included).
    if (k0 + kBlockN > end) {
#pragma unroll
      for (int j = 0; j < 2 * kChunks; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (k0 + j * 8 + 2 * t4 + (i & 1) >= end) s[j][i] = kNegBig;
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
      if (k0 + 16 * c < end) {
        uint32_t a[4];
        pack_a(a, s[2 * c], s[2 * c + 1]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, bt_row<S>(v_s, 16 * c, dp * 16, lane));
          mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
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
    const int row = warp * 16 + g + 8 * r;
    if (row < rows) {
      const int tok = row % n_tok, head = h * group + row / n_tok;
      bf16* o_row = o + ((static_cast<size_t>(b) * n_tok + tok) * nq + head) * D + 2 * t4;
#pragma unroll
      for (int i = 0; i < kDTiles; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * i) =
            __floats2bfloat162_rn(acc[i][2 * r] / l_c, acc[i][2 * r + 1] / l_c);
      }
    }
  }
}

template <int D, int W>
cudaError_t launch(const void* q, long long q_sb, long long q_sn, const void* k, const void* v,
                   void* o, int b, int n_tok, int nq, int nk, int t_max, int end, float scale,
                   cudaStream_t stream) {
  const long long blocks = static_cast<long long>(b) * nk;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<D, W>();
  const cudaError_t err = allow_smem_once<block_attention_kernel<D, W>>(smem);
  if (err != cudaSuccess) return err;
  block_attention_kernel<D, W><<<static_cast<unsigned>(blocks), 32 * W, smem, stream>>>(
      static_cast<const bf16*>(q), q_sb, q_sn, static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), n_tok, nq, nk, t_max, end,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_warps(const void* q, long long q_sb, long long q_sn, const void* k,
                           const void* v, void* o, int b, int n_tok, int nq, int nk, int t_max,
                           int end, float scale, cudaStream_t stream) {
  const int rows = nq / nk * n_tok;
  if (rows <= 16) return launch<D, 1>(q, q_sb, q_sn, k, v, o, b, n_tok, nq, nk, t_max, end,
                                      scale, stream);
  if (rows <= 32) return launch<D, 2>(q, q_sb, q_sn, k, v, o, b, n_tok, nq, nk, t_max, end,
                                      scale, stream);
  if (rows <= 64) return launch<D, 4>(q, q_sb, q_sn, k, v, o, b, n_tok, nq, nk, t_max, end,
                                      scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: bf16 (b, n_tok, nq, d) with strides (q_sb, q_sn, d, 1) in elements, 16-byte
// aligned rows; k, v: contiguous bf16 (b, nk, t_max, d); o: contiguous bf16
// (b, n_tok, nq, d). nq a multiple of nk, (nq / nk) * n_tok <= 64, 1 <= end
// <= t_max. Returns the CUDA error of the launch (0 on success).
extern "C" int block_attention(const void* q, long long q_sb, long long q_sn, const void* k,
                               const void* v, void* o, int b, int n_tok, int nq, int nk,
                               int t_max, int end, int d, float scale, void* stream) {
  if (b <= 0 || n_tok <= 0 || nk <= 0 || nq % nk || end <= 0 || end > t_max) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return dispatch_warps<16>(q, q_sb, q_sn, k, v, o, b, n_tok, nq, nk, t_max, end,
                                       scale, s);
    case 32: return dispatch_warps<32>(q, q_sb, q_sn, k, v, o, b, n_tok, nq, nk, t_max, end,
                                       scale, s);
    case 64: return dispatch_warps<64>(q, q_sb, q_sn, k, v, o, b, n_tok, nq, nk, t_max, end,
                                       scale, s);
    case 128: return dispatch_warps<128>(q, q_sb, q_sn, k, v, o, b, n_tok, nq, nk, t_max, end,
                                         scale, s);
    default: return cudaErrorInvalidValue;
  }
}
