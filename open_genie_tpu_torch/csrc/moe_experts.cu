// Grouped expert products for Hopper (sm_90a): kernel K8 of the PyTorch port.
//
// Replaces no TPU kernel: the JAX package has no expert layer. The layer
// (modules/moe.py) sorts its token slots (one slot per token and chosen
// expert) by expert; offsets[e] .. offsets[e + 1] are expert e's run of the
// sorted slots. Two launches then cover every expert at once:
//   moe_gate_up_kernel: h[p] = silu(x[t] W_gate^T) * (x[t] W_up^T) for sorted slot p
//     of token t = order[p] / top_k, from one pass over the expert's fused
//     (2 I, C) weight, stored in bf16 at row p;
//   moe_down_kernel: out[order[p]] = weights[order[p]] * (h[p] W_down^T), in f32 at
//     the slot's own row.
// A token's top_k rows of out are summed by the caller, in slot order: no
// atomics, so two calls are bit-identical.
//
// What bounds it on this card: at a decode pass (64 rows x a block of 4
// tokens at top 8 into 128 experts: about 16 slots an expert) the bytes of
// the experts' weights, each read once: 1.21 GB a layer pass at C = 2048,
// I = 768, 0.36 ms at 3.35 TB/s; the products are 2 x 16 rows a weight row,
// far below what the tensor cores do in that time. A prefill chunk (1,024
// slots an expert) is bound by the tensor cores.
//
// What the design does about it:
// - A block computes one row tile (BM sorted slots of one expert) against
//   one column tile of 128 weight rows: the gate and up rows of the same 64
//   columns for moe_gate_up_kernel (so SiLU and the product happen in registers),
//   128 output columns for moe_down_kernel. BM follows the mean slots an expert
//   (the wrapper's block_m), so at decode one tile holds nearly every
//   expert's slots and each weight is read once.
// - The grid is (column tiles) x (a bound on the row tiles, ceil(S / BM) +
//   E, known from shapes alone, so nothing waits on the host). Warp 0 of a
//   block finds its expert and row tile from the offsets by a warp scan of
//   the experts' tile counts; blocks past the last tile return at once.
//   Row tiles of one expert are adjacent within a column tile, so at a
//   prefill the blocks in flight share that expert's weights in L2.
// - Weights and rows stream through a 4-stage ring of 16-byte cp.async
//   copies into padded shared-memory tiles (64 deep), read by ldmatrix into
//   bf16 mma.sync.m16n8k16 with f32 accumulation; a token row is gathered
//   by its slot's index as it is copied. Rows, columns and depth past the
//   ends are zero-filled by the copies, so any C and I that are multiples of
//   8 work.
// - Each of the 4 warps owns 32 weight rows of the tile (16 gate and 16 up
//   columns, or 32 output columns) for all BM rows.

#include "flash_mma.cuh"

namespace {

using namespace flash_mma;

constexpr int kThreads = 128;           // 4 warps
constexpr int kTileK = 64;              // depth of a stage
constexpr int kTileW = 128;             // weight rows of a stage
constexpr int kStages = 4;
constexpr int kS = kTileK + kPad;       // row stride of every tile (bf16)
constexpr int kChunksK = kTileK / 8;    // 16-byte chunks of a tile row

template <int BM>
constexpr int smem_bytes() {
  return kStages * (BM + kTileW) * kS * static_cast<int>(sizeof(bf16));
}

// Which row tile block `mt` is: the tiles of every expert in order,
// ceil(count / BM) each. Sets tile = {expert, first sorted slot, end of the
// expert's slots}, expert -1 past the last tile. Warp 0 only.
template <int BM>
__device__ void find_tile(const int* __restrict__ offsets, int experts, int mt, int lane,
                          int* tile) {
  const int per = (experts + 31) / 32;
  const int lo = min(experts, lane * per), hi = min(experts, lo + per);
  int mine = 0;
  for (int e = lo; e < hi; ++e) mine += (offsets[e + 1] - offsets[e] + BM - 1) / BM;
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  const int excl = incl - mine;
  const unsigned own = __ballot_sync(0xffffffffu, mt >= excl && mt < incl);
  if (own == 0) {
    if (lane == 0) tile[0] = -1;
  } else if (lane == __ffs(own) - 1) {
    int t = excl;
    for (int e = lo; e < hi; ++e) {
      const int s0 = offsets[e], s1 = offsets[e + 1];
      const int nt = (s1 - s0 + BM - 1) / BM;
      if (mt < t + nt) {
        tile[0] = e;
        tile[1] = s0 + (mt - t) * BM;
        tile[2] = s1;
        break;
      }
      t += nt;
    }
  }
}

// One block's tile. kGateUp (moe_gate_up_kernel): a = x (T, k_dim = C),
// w = (E, 2 n_dim, C), out = h (S, n_dim = I) bf16. Otherwise
// (moe_down_kernel): a = h (S, k_dim = I), w = (E, n_dim = C, I), out (S, C)
// f32 at each slot's row, scaled by wt.
template <int BM, bool kGateUp>
__device__ __forceinline__ void moe_tile(const bf16* __restrict__ a, const bf16* __restrict__ w,
                                         const long long* __restrict__ order,
                                         const int* __restrict__ offsets,
                                         const float* __restrict__ wt, void* __restrict__ out,
                                         int experts, int k_dim, int n_dim, int top_k,
                                         int m_tiles) {
  constexpr int kMT = BM / 16;                         // 16-row tiles of a block
  constexpr int kAIters = BM * kChunksK / kThreads;    // a thread's chunks of the rows
  constexpr int kBIters = kTileW * kChunksK / kThreads;
  constexpr int kTileN = kGateUp ? kTileW / 2 : kTileW;  // output columns of a block
  static_assert(kAIters * kThreads == BM * kChunksK, "row tile copy must split evenly");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);  // [stage][BM][kS]
  bf16* b_s = a_s + kStages * BM * kS;        // [stage][kTileW][kS]
  __shared__ int tile[3];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tile = blockIdx.x / m_tiles;
  if (warp == 0) find_tile<BM>(offsets, experts, blockIdx.x % m_tiles, lane, tile);
  __syncthreads();
  const int e = tile[0];
  if (e < 0) return;
  const int m0 = tile[1], m_end = tile[2];
  const int n0 = n_tile * kTileN;

  // This thread copies column chunk tid % 8 of rows tid / 8 + 16 i.
  const int cc = (tid % kChunksK) * 8, r_base = tid / kChunksK;
  const bf16* a_src[kAIters];
  bool a_ok[kAIters];
#pragma unroll
  for (int i = 0; i < kAIters; ++i) {
    const int p = m0 + r_base + 16 * i;
    a_ok[i] = p < m_end;
    const long long row = !a_ok[i] ? 0 : kGateUp ? order[p] / top_k : p;
    a_src[i] = a + static_cast<size_t>(row) * k_dim + cc;
  }
  const bf16* w_e = w + static_cast<size_t>(e) * (kGateUp ? 2 : 1) * n_dim * k_dim;
  const bf16* b_src[kBIters];
  bool b_ok[kBIters];
#pragma unroll
  for (int i = 0; i < kBIters; ++i) {
    const int j = r_base + 16 * i;  // the tile's weight row
    const int col = n0 + (kGateUp ? j % kTileN : j);
    b_ok[i] = col < n_dim;
    const int row = !b_ok[i] ? 0 : (kGateUp && j >= kTileN) ? n_dim + col : col;
    b_src[i] = w_e + static_cast<size_t>(row) * k_dim + cc;
  }
  auto load_stage = [&](int stage, int k0) {
    bf16* as = a_s + stage * BM * kS;
    bf16* bs = b_s + stage * kTileW * kS;
    const bool k_ok = k0 + cc < k_dim;
#pragma unroll
    for (int i = 0; i < kAIters; ++i) {
      const bool ok = a_ok[i] && k_ok;
      cp_async16(as + (r_base + 16 * i) * kS + cc, ok ? a_src[i] + k0 : a, ok);
    }
#pragma unroll
    for (int i = 0; i < kBIters; ++i) {
      const bool ok = b_ok[i] && k_ok;
      cp_async16(bs + (r_base + 16 * i) * kS + cc, ok ? b_src[i] + k0 : w, ok);
    }
  };

  const int k_tiles = (k_dim + kTileK - 1) / kTileK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s * kTileK);
    cp_async_commit();
  }

  // The warp's two 16-row groups of the weight tile: gate and up rows of
  // the same 16 columns, or 32 adjacent output columns.
  const int r0[2] = {kGateUp ? 16 * warp : 32 * warp,
                     kGateUp ? kTileN + 16 * warp : 32 * warp + 16};
  float acc[kMT][4][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed for all; every warp is done with stage kt - 1
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next * kTileK);
    cp_async_commit();
    const bf16* as = a_s + (kt % kStages) * BM * kS;
    const bf16* bs = b_s + (kt % kStages) * kTileW * kS;
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      uint32_t af[kMT][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m) ldsm_x4(af[m], a_row<kS>(as, 16 * m, 16 * kk, lane));
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        uint32_t b[4];
        ldsm_x4(b, b_row<kS>(bs, r0[grp], 16 * kk, lane));
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          mma_bf16(acc[m][2 * grp], af[m], b[0], b[1]);
          mma_bf16(acc[m][2 * grp + 1], af[m], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int m = 0; m < kMT; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = m0 + 16 * m + g + 8 * half;
      if (p >= m_end) continue;
      if constexpr (kGateUp) {
        bf16* h = static_cast<bf16*>(out) + static_cast<size_t>(p) * n_dim;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = n0 + 16 * warp + 8 * jj + 2 * t4;
          if (col >= n_dim) continue;
          const float g0 = acc[m][jj][2 * half], g1 = acc[m][jj][2 * half + 1];
          const float u0 = acc[m][jj + 2][2 * half], u1 = acc[m][jj + 2][2 * half + 1];
          *reinterpret_cast<__nv_bfloat162*>(h + col) = __floats2bfloat162_rn(
              g0 / (1.f + expf(-g0)) * u0, g1 / (1.f + expf(-g1)) * u1);
        }
      } else {
        const long long slot = order[p];
        const float scale = wt[slot];
        float* o = static_cast<float*>(out) + static_cast<size_t>(slot) * n_dim;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + 32 * warp + 8 * j + 2 * t4;
          if (col >= n_dim) continue;
          *reinterpret_cast<float2*>(o + col) =
              make_float2(acc[m][j][2 * half] * scale, acc[m][j][2 * half + 1] * scale);
        }
      }
    }
  }
}

#define MOE_KERNEL_ARGS                                                                   \
  const bf16 *__restrict__ a, const bf16 *__restrict__ w, const long long *__restrict__ order, \
      const int *__restrict__ offsets, const float *__restrict__ wt, void *__restrict__ out,   \
      int experts, int k_dim, int n_dim, int top_k, int m_tiles

template <int BM>
__global__ void __launch_bounds__(kThreads) moe_gate_up_kernel(MOE_KERNEL_ARGS) {
  moe_tile<BM, true>(a, w, order, offsets, wt, out, experts, k_dim, n_dim, top_k, m_tiles);
}

template <int BM>
__global__ void __launch_bounds__(kThreads) moe_down_kernel(MOE_KERNEL_ARGS) {
  moe_tile<BM, false>(a, w, order, offsets, wt, out, experts, k_dim, n_dim, top_k, m_tiles);
}

template <int BM, bool kGateUp>
cudaError_t launch(const void* a, const void* w, const void* order, const void* offsets,
                   const void* wt, void* out, int slots, int experts, int k_dim, int n_dim,
                   int top_k, cudaStream_t stream) {
  constexpr int kTileN = kGateUp ? kTileW / 2 : kTileW;
  const long long m_tiles = (slots + BM - 1) / BM + experts;
  const long long blocks = m_tiles * ((n_dim + kTileN - 1) / kTileN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr int smem = smem_bytes<BM>();
  constexpr auto kernel = kGateUp ? moe_gate_up_kernel<BM> : moe_down_kernel<BM>;
  const cudaError_t err = allow_smem_once<kernel>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w),
      static_cast<const long long*>(order), static_cast<const int*>(offsets),
      static_cast<const float*>(wt), out, experts, k_dim, n_dim, top_k,
      static_cast<int>(m_tiles));
  return cudaGetLastError();
}

template <int BM>
cudaError_t run(const void* x, const void* w_gate_up, const void* w_down, const void* order,
                const void* offsets, const void* weights, void* h, void* out, int slots,
                int experts, int c, int i, int top_k, cudaStream_t stream) {
  cudaError_t err = launch<BM, true>(x, w_gate_up, order, offsets, nullptr, h, slots, experts,
                                     c, i, top_k, stream);
  if (err != cudaSuccess) return err;
  return launch<BM, false>(h, w_down, order, offsets, weights, out, slots, experts, i, c,
                           top_k, stream);
}

}  // namespace

// x (T, C), w_gate_up (E, 2I, C), w_down (E, C, I), h (S, I): contiguous
// bf16, 16-byte aligned; order (S,) int64, the slots sorted by expert;
// offsets (E + 1,) int32; weights (S,) f32; out (S, C) f32, every row
// written. C and I multiples of 8; block_m 16, 32 or 64. Two launches.
// Returns the CUDA error of the launches (0 on success).
extern "C" int moe_experts(const void* x, const void* w_gate_up, const void* w_down,
                           const void* order, const void* offsets, const void* weights,
                           void* h, void* out, int slots, int experts, int c, int i,
                           int top_k, int block_m, void* stream) {
  if (slots <= 0 || experts <= 0 || c <= 0 || i <= 0 || top_k <= 0 || c % 8 || i % 8) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_m) {
    case 16: return run<16>(x, w_gate_up, w_down, order, offsets, weights, h, out, slots,
                            experts, c, i, top_k, s);
    case 32: return run<32>(x, w_gate_up, w_down, order, offsets, weights, h, out, slots,
                            experts, c, i, top_k, s);
    case 64: return run<64>(x, w_gate_up, w_down, order, offsets, weights, h, out, slots,
                            experts, c, i, top_k, s);
    default: return cudaErrorInvalidValue;
  }
}
