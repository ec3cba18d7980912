// LFQ diversity entropy for Hopper (sm_90a): kernels K5 and K6 of the PyTorch
// port.
//
// K5 replaces open_genie_tpu/ops/pallas/lfq_entropy.py::_fwd_kernel (launched
// by _avg_probs_fwd): q_j = mean_b p_bj over all 2^d sign codewords c_j, with
// p_bj = exp(2 beta <x_b, c_j> - logZ_b). K6 replaces _bwd_kernel (launched by
// _grad_x): dx_bi = 2 beta sum_j p_bj w_j (tanh(2 beta x_bi) - c_ji), which is
// the Pallas kernel's 2 beta (tanh(2 beta x) S - T). Codeword j has feature 0
// as its most significant bit; bit i set means c_ji = +1.
//
// The factorization. With a = 2 beta x, logZ_b is a sum over the bits, so
// p_bj = prod_i sigma(2 a_bi c_ji) exactly. Split the d bits into a high half
// of dh = ceil(d/2) bits (features 0 .. dh-1) and a low half of dl = floor(d/2)
// bits; code j = h 2^dl + l then has p_bj = H_b[h] L_b[l], with H an (n x 2^dh)
// table and L an (n x 2^dl) one. So
//   K5: q = H^T L / n, a (2^dh x n)(n x 2^dl) product;
//   K6: with W = w as a (2^dh x 2^dl) matrix, G = L W^T (n x 2^dh) and
//       F = H W (n x 2^dl); for a high bit i, P_bi = sum over h with bit i set
//       of H_b[h] G_b[h] and N_bi the same over h with bit i clear (the low
//       half likewise with L and F), and dx_bi follows from (P_bi, N_bi).
// Work falls from n 2^d (token, code) pairs of d adds and an exp each to
// 2 n 2^d (K5) or 4 n 2^d (K6) flops in products and n (2^dh + 2^dl)
// exponentials.
//
// Cancellation. With s_bi = +1 iff x_bi > 0, each table entry is the exp of a
// sum of non-positive terms,
//   log H_b[h] = -sum_{i high: bit i of (h xor s_b)} 4 beta |x_bi|
//                - sum_{i high} log1p(exp(-4 beta |x_bi|)),
// the closed-form logZ_b already subtracted term by term (the Pallas kernel
// subtracts two numbers of about 2 beta sum|x|, thousands at beta = 100). K6
// forms tanh(a) - c as s (1 + t) on a mismatch and -s (1 - t) on a match,
// with t = tanh|a| and 1 - t = 2e / (1 + e), e = exp(-2|a|): nothing is
// subtracted there either.
//
// What bounds them on this card: the products, f32 on the CUDA cores (no
// tensor cores: TF32 would move q, and a TF32 dot flips LFQ signs near zero).
// At the tokenizer's (n, d) = (512, 18) each product is 512 x 512 x 512.
//
// What the design does about it. A table pass (one block per token) writes H
// and L to scratch that stays in L2: n (2^dh + 2^dl) entries, where building
// the tile of each product block in the block itself would build n 2^d / 16
// (on an H100 at (512, 18) that K5 took 5.6 times as long). Each product is a
// shared-memory tiled f32 GEMM: 16-deep tiles of the reduction axis staged in
// shared memory (the next tile's loads in flight in registers while the
// current one is used), 4 x 4 outputs per thread read as float4 broadcasts.
// Output tiles are 32 x 32 (64 threads), so a 512 x 512 output makes 256
// blocks for 132 SMs (64 x 64 tiles make 64 and took 1.5 times as long). K6
// runs its two products in one launch and ends with a warp per token that
// sums P and N in a fixed lane order and a fixed xor butterfly, then applies
// the per-bit factors. Ragged n is masked: rows past n are staged as zeros and
// not stored. No atomics: two calls agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMinBits = 13;
constexpr int kMaxBits = 24;
constexpr int kMaxHalf = (kMaxBits + 1) / 2;
constexpr int kTableThreads = 128;
constexpr int kTile = 32;            // product outputs per block side
constexpr int kGemmThreads = (kTile / 4) * (kTile / 4);  // 4 x 4 outputs each
constexpr int kTk = 16;              // reduction entries per staged tile
constexpr int kCombineWarps = 4;     // tokens per block of the last K6 pass

// One block per token b: H_b (2^dh entries) then L_b (2^dl).
__global__ void __launch_bounds__(kTableThreads)
lfq_tables_kernel(const float* __restrict__ x, float* __restrict__ hi, float* __restrict__ lo,
                  int d, float beta) {
  __shared__ float s_abs[kMaxBits];
  __shared__ float s_log[kMaxBits];
  __shared__ unsigned s_bit[kMaxBits];
  __shared__ float s_rest[2];
  __shared__ unsigned s_pos[2];
  const int b = blockIdx.x;
  const int dh = (d + 1) / 2, dl = d / 2;
  if (threadIdx.x < d) {
    const float xi = x[static_cast<size_t>(b) * d + threadIdx.x];
    const float v = 4.f * beta * fabsf(xi);
    s_abs[threadIdx.x] = v;
    s_log[threadIdx.x] = log1pf(expf(-v));
    s_bit[threadIdx.x] = xi > 0.f;
  }
  __syncthreads();
  if (threadIdx.x < 2) {  // each half's rest and sign bits, in feature order
    const int first = threadIdx.x == 0 ? 0 : dh, bits = threadIdx.x == 0 ? dh : dl;
    float rest = 0.f;
    unsigned pos = 0;
    for (int i = 0; i < bits; ++i) {
      rest += s_log[first + i];
      pos |= s_bit[first + i] << (bits - 1 - i);
    }
    s_rest[threadIdx.x] = rest;
    s_pos[threadIdx.x] = pos;
  }
  __syncthreads();
  const int nh = 1 << dh, nl = 1 << dl;
  for (int e = threadIdx.x; e < nh + nl; e += kTableThreads) {
    const int half = e < nh ? 0 : 1;  // uniform over a warp: nh is a multiple of 32
    const unsigned code = half == 0 ? e : e - nh;
    const int bits = half == 0 ? dh : dl;
    const float* v = s_abs + (half == 0 ? 0 : dh);
    const unsigned mism = code ^ s_pos[half];
    float s = 0.f;
    for (int i = 0; i < bits; ++i) s += ((mism >> (bits - 1 - i)) & 1u) ? v[i] : 0.f;
    const float t = expf(-s - s_rest[half]);
    if (half == 0) {
      hi[static_cast<size_t>(b) * nh + code] = t;
    } else {
      lo[static_cast<size_t>(b) * nl + code] = t;
    }
  }
}

// One (kTile x kTile) tile at (m0, n0) of C = alpha A B over K, in f32 FMAs.
// A's (m, k) lies at a[k lda + m] when A_KM, else at a[m lda + k]; B's (k, n)
// at b[k ldb + n] when B_KN, else at b[n ldb + k]. Only the strided axis of
// an operand may be ragged: the contiguous one is a power of two of at least
// 2^6 (d >= 13), a multiple of its tile, so every load is one float4. Rows
// m >= M and reduction entries k >= K are staged as zeros; rows m >= M are
// not stored.
template <bool A_KM, bool B_KN>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ a, int lda,
                                          const float* __restrict__ b, int ldb,
                                          float* __restrict__ c, int ldc, int M, int K,
                                          float alpha, int m0, int n0, float* as, float* bs) {
  constexpr int TM = kTile, TN = kTile, kThreads = kGemmThreads;
  constexpr int kAs = TM + 4, kBs = TN + 4;  // shared row strides, float4-aligned
  constexpr int kAVec = TM * kTk / 4 / kThreads, kBVec = TN * kTk / 4 / kThreads;
  static_assert(kAVec >= 1 && kBVec >= 1, "a tile is at least one float4 a thread");
  const int t = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ra[kAVec], rb[kBVec];

  auto load = [&](int k0) {
#pragma unroll
    for (int v = 0; v < kAVec; ++v) {
      const int e = t + v * kThreads;
      if constexpr (A_KM) {
        const int k = e / (TM / 4), m = (e % (TM / 4)) * 4;
        ra[v] = k0 + k < K
            ? *reinterpret_cast<const float4*>(a + static_cast<size_t>(k0 + k) * lda + m0 + m)
            : zero;
      } else {
        const int m = e / (kTk / 4), k = (e % (kTk / 4)) * 4;
        ra[v] = m0 + m < M
            ? *reinterpret_cast<const float4*>(a + static_cast<size_t>(m0 + m) * lda + k0 + k)
            : zero;
      }
    }
#pragma unroll
    for (int v = 0; v < kBVec; ++v) {
      const int e = t + v * kThreads;
      if constexpr (B_KN) {
        const int k = e / (TN / 4), n = (e % (TN / 4)) * 4;
        rb[v] = k0 + k < K
            ? *reinterpret_cast<const float4*>(b + static_cast<size_t>(k0 + k) * ldb + n0 + n)
            : zero;
      } else {
        const int n = e / (kTk / 4), k = (e % (kTk / 4)) * 4;
        rb[v] = *reinterpret_cast<const float4*>(b + static_cast<size_t>(n0 + n) * ldb + k0 + k);
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int v = 0; v < kAVec; ++v) {
      const int e = t + v * kThreads;
      if constexpr (A_KM) {
        const int k = e / (TM / 4), m = (e % (TM / 4)) * 4;
        *reinterpret_cast<float4*>(as + k * kAs + m) = ra[v];
      } else {
        const int m = e / (kTk / 4), k = (e % (kTk / 4)) * 4;
        as[(k + 0) * kAs + m] = ra[v].x;
        as[(k + 1) * kAs + m] = ra[v].y;
        as[(k + 2) * kAs + m] = ra[v].z;
        as[(k + 3) * kAs + m] = ra[v].w;
      }
    }
#pragma unroll
    for (int v = 0; v < kBVec; ++v) {
      const int e = t + v * kThreads;
      if constexpr (B_KN) {
        const int k = e / (TN / 4), n = (e % (TN / 4)) * 4;
        *reinterpret_cast<float4*>(bs + k * kBs + n) = rb[v];
      } else {
        const int n = e / (kTk / 4), k = (e % (kTk / 4)) * 4;
        bs[(k + 0) * kBs + n] = rb[v].x;
        bs[(k + 1) * kBs + n] = rb[v].y;
        bs[(k + 2) * kBs + n] = rb[v].z;
        bs[(k + 3) * kBs + n] = rb[v].w;
      }
    }
  };

  const int tx = t % (TN / 4), ty = t / (TN / 4);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  const int tiles = (K + kTk - 1) / kTk;
  load(0);
  store();
  __syncthreads();
  for (int tile = 0; tile < tiles; ++tile) {
    const bool more = tile + 1 < tiles;
    if (more) load((tile + 1) * kTk);  // in flight while this tile is used
#pragma unroll
    for (int kk = 0; kk < kTk; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(as + kk * kAs + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(bs + kk * kBs + tx * 4);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
      }
    }
    __syncthreads();  // this tile is consumed
    if (more) {
      store();
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m < M) {
      *reinterpret_cast<float4*>(c + static_cast<size_t>(m) * ldc + n0 + tx * 4) =
          make_float4(alpha * acc[i][0], alpha * acc[i][1], alpha * acc[i][2], alpha * acc[i][3]);
    }
  }
}

// K5's product: q (2^dh x 2^dl, row-major, so q[h 2^dl + l]) = H^T L / n.
__global__ void __launch_bounds__(kGemmThreads)
lfq_avg_probs_gemm(const float* __restrict__ hi, const float* __restrict__ lo,
                   float* __restrict__ q, int n, int dh, int dl) {
  __shared__ __align__(16) float as[kTk * (kTile + 4)];
  __shared__ __align__(16) float bs[kTk * (kTile + 4)];
  const int nh = 1 << dh, nl = 1 << dl;
  gemm_tile<true, true>(hi, nh, lo, nl, q, nl, nh, n, 1.f / static_cast<float>(n),
                        blockIdx.y * kTile, blockIdx.x * kTile, as, bs);
}

// K6's two products, blockIdx.z choosing: G = L W^T (n x 2^dh, over 2^dl)
// and F = H W (n x 2^dl, over 2^dh).
__global__ void __launch_bounds__(kGemmThreads)
lfq_entropy_grad_gemms(const float* __restrict__ hi, const float* __restrict__ lo,
                       const float* __restrict__ w, float* __restrict__ g,
                       float* __restrict__ f, int n, int dh, int dl) {
  __shared__ __align__(16) float as[kTk * (kTile + 4)];
  __shared__ __align__(16) float bs[kTk * (kTile + 4)];
  const int nh = 1 << dh, nl = 1 << dl;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  if (blockIdx.z == 0) {
    if (n0 >= nh) return;
    gemm_tile<false, false>(lo, nl, w, nl, g, nh, n, nl, 1.f, m0, n0, as, bs);
  } else {
    if (n0 >= nl) return;
    gemm_tile<false, true>(hi, nh, w, nl, f, nl, n, nh, 1.f, m0, n0, as, bs);
  }
}

// Adds v to p[i] (bit i of code set) or to m[i] (clear) for the `bits` bits
// of `code`, MSB first.
__device__ __forceinline__ void add_by_bit(float (&p)[kMaxHalf], float (&m)[kMaxHalf],
                                           unsigned code, int bits, float v) {
#pragma unroll
  for (int i = 0; i < kMaxHalf; ++i) {
    if (i < bits) {
      if ((code >> (bits - 1 - i)) & 1u) {
        p[i] += v;
      } else {
        m[i] += v;
      }
    }
  }
}

__device__ __forceinline__ void warp_sum(float (&v)[kMaxHalf]) {
#pragma unroll
  for (int i = 0; i < kMaxHalf; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
}

// A warp per token: P and N per bit from H G (high bits) and L F (low bits),
// then dx_bi = 2 beta sum_j p_bj w_j (tanh(a_bi) - c_ji).
__global__ void __launch_bounds__(kCombineWarps * 32)
lfq_entropy_grad_combine(const float* __restrict__ x, const float* __restrict__ hi,
                         const float* __restrict__ lo, const float* __restrict__ g,
                         const float* __restrict__ f, float* __restrict__ dx, int n, int d,
                         float beta) {
  const int b = blockIdx.x * kCombineWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (b >= n) return;
  const int dh = (d + 1) / 2, dl = d / 2, nh = 1 << dh, nl = 1 << dl;
  float ph[kMaxHalf], mh[kMaxHalf], pl[kMaxHalf], ml[kMaxHalf];
#pragma unroll
  for (int i = 0; i < kMaxHalf; ++i) { ph[i] = 0.f; mh[i] = 0.f; pl[i] = 0.f; ml[i] = 0.f; }
  const size_t rh = static_cast<size_t>(b) * nh, rl = static_cast<size_t>(b) * nl;
  for (int h = lane; h < nh; h += 32) add_by_bit(ph, mh, h, dh, hi[rh + h] * g[rh + h]);
  for (int l = lane; l < nl; l += 32) add_by_bit(pl, ml, l, dl, lo[rl + l] * f[rl + l]);
  warp_sum(ph);
  warp_sum(mh);
  warp_sum(pl);
  warp_sum(ml);
  float p_sum = 0.f, n_sum = 0.f;  // lane i takes bit i's sums
#pragma unroll
  for (int i = 0; i < kMaxHalf; ++i) {
    if (i < dh && lane == i) { p_sum = ph[i]; n_sum = mh[i]; }
    if (i < dl && lane == dh + i) { p_sum = pl[i]; n_sum = ml[i]; }
  }
  if (lane >= d) return;
  const size_t idx = static_cast<size_t>(b) * d + lane;
  const float xi = x[idx];
  const float two_abs = 4.f * beta * fabsf(xi);
  const float e = expf(-two_abs);
  const float t = tanhf(0.5f * two_abs);
  const bool pos = xi > 0.f;
  const float match = pos ? p_sum : n_sum, mismatch = pos ? n_sum : p_sum;
  const float r = (1.f + t) * mismatch - (2.f * e / (1.f + e)) * match;
  dx[idx] = 2.f * beta * (pos ? r : -r);
}

bool bits_ok(int n, int d) { return n > 0 && d >= kMinBits && d <= kMaxBits; }

}  // namespace

// x: contiguous float32 (n, d); tables: float32 scratch of n (2^dh + 2^dl);
// q: float32 (2^d). Takes d from 13 to 24. Returns the CUDA error of the
// launches (0 on success).
extern "C" int lfq_entropy_fwd(const void* x, void* tables, void* q, int n, int d, float beta,
                               void* stream) {
  if (!bits_ok(n, d)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dh = (d + 1) / 2, dl = d / 2;
  float* hi = static_cast<float*>(tables);
  float* lo = hi + (static_cast<size_t>(n) << dh);
  lfq_tables_kernel<<<n, kTableThreads, 0, s>>>(static_cast<const float*>(x), hi, lo, d, beta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((1 << dl) / kTile, (1 << dh) / kTile);
  lfq_avg_probs_gemm<<<grid, kGemmThreads, 0, s>>>(hi, lo, static_cast<float*>(q), n, dh, dl);
  return cudaGetLastError();
}

// x: contiguous float32 (n, d); w: float32 (2^d); scratch: float32 of
// 2 n (2^dh + 2^dl), the tables then G and F; dx: float32 (n, d). Takes d
// from 13 to 24. Returns the CUDA error of the launches (0 on success).
extern "C" int lfq_entropy_bwd(const void* x, const void* w, void* scratch, void* dx, int n,
                               int d, float beta, void* stream) {
  if (!bits_ok(n, d)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dh = (d + 1) / 2, dl = d / 2;
  const size_t nh = static_cast<size_t>(n) << dh, nl = static_cast<size_t>(n) << dl;
  const float* xf = static_cast<const float*>(x);
  float* hi = static_cast<float*>(scratch);
  float* lo = hi + nh;
  float* g = lo + nl;
  float* f = g + nh;
  lfq_tables_kernel<<<n, kTableThreads, 0, s>>>(xf, hi, lo, d, beta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* wf = static_cast<const float*>(w);
  const dim3 grid((1 << dh) / kTile, (n + kTile - 1) / kTile, 2);  // z: G, F; dh >= dl
  lfq_entropy_grad_gemms<<<grid, kGemmThreads, 0, s>>>(hi, lo, wf, g, f, n, dh, dl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lfq_entropy_grad_combine<<<(n + kCombineWarps - 1) / kCombineWarps, kCombineWarps * 32, 0,
                             s>>>(xf, hi, lo, g, f, static_cast<float*>(dx), n, d, beta);
  return cudaGetLastError();
}
