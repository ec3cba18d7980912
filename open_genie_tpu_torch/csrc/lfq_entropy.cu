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
// Cancellation. With a = 2 beta x, s_bi = +1 iff x_bi > 0 and the closed form
// logZ_b = sum_i |a_bi| + log1p(exp(-2|a_bi|)),
//   log p_bj = -sum_{i: bit i of (j xor s_b)} 2|a_bi| - sum_i log1p(exp(-2|a_bi|)),
// a sum of non-positive terms. The Pallas kernel subtracts two numbers of
// about 2 beta sum|x| (thousands at beta = 100) and needs f32 HIGHEST dot
// products to keep the difference; here there is no difference to keep, and
// <x, c> over {-1, +1} codes is signed f32 adds with no tensor cores. K6 sums
// p_bj w_j per bit over the codes with the bit set (P) and clear (N) and forms
// tanh(a) - c as s (1 + t) on a mismatch and -s (1 - t) on a match, with
// t = tanh|a| and 1 - t = 2e / (1 + e), e = exp(-2|a|).
//
// What bounds them on this card: arithmetic on the CUDA cores. Per (token,
// code) pair K5 does d predicated adds and one exp, K6 that plus 2d
// accumulations; at the tokenizer's n = 512 tokens and d = 18 that is 1.3e8
// pairs. Memory traffic is only x (n x d), q or w (2^d) and K6's partials.
//
// What the design does about it. K5: one thread per code, a block of 256
// codes, tokens staged 128 at a time in shared memory and read as broadcasts;
// each thread sums its code's probabilities over the tokens in a fixed order.
// K6: one thread per token and a grid of (token tiles, code splits), so that
// n = 512 still fills the SMs; a warp walks the same code at once, so the
// code's bits are uniform and its weight w_j is a shared-memory broadcast. Each
// split writes its (P, N) partials; a second kernel reduces them over the
// splits in order and applies the per-bit factors. Ragged n is masked in the
// kernels (a thread with no token stages nothing and writes nothing). No
// atomics: two calls agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFwdThreads = 256;  // codes per K5 block
constexpr int kFwdTokens = 128;   // tokens K5 stages per pass
constexpr int kBwdThreads = 128;  // tokens per K6 block
constexpr int kBwdCodes = 256;    // weights K6 stages per pass
constexpr int kReduceThreads = 256;

template <int D>
__device__ __forceinline__ unsigned token_terms(const float* __restrict__ xb, float beta,
                                                float* two_abs, float* rest) {
  unsigned pos = 0;
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float xi = xb[i];
    const float v = 4.f * beta * fabsf(xi);
    two_abs[i] = v;
    r += log1pf(expf(-v));
    pos |= static_cast<unsigned>(xi > 0.f) << (D - 1 - i);
  }
  *rest = r;
  return pos;
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads)
lfq_avg_probs_kernel(const float* __restrict__ x, float* __restrict__ q, int n, float beta) {
  __shared__ float s_abs[kFwdTokens][D];
  __shared__ float s_rest[kFwdTokens];
  __shared__ unsigned s_pos[kFwdTokens];
  const unsigned j = blockIdx.x * kFwdThreads + threadIdx.x;  // the grid is exactly 2^D
  float acc = 0.f;
  for (int t0 = 0; t0 < n; t0 += kFwdTokens) {
    const int count = min(kFwdTokens, n - t0);
    __syncthreads();  // the previous tile is consumed
    if (threadIdx.x < count) {
      float rest;
      s_pos[threadIdx.x] = token_terms<D>(x + static_cast<size_t>(t0 + threadIdx.x) * D,
                                          beta, s_abs[threadIdx.x], &rest);
      s_rest[threadIdx.x] = rest;
    }
    __syncthreads();
    for (int b = 0; b < count; ++b) {
      const unsigned mism = j ^ s_pos[b];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) s += ((mism >> (D - 1 - i)) & 1u) ? s_abs[b][i] : 0.f;
      acc += expf(-s - s_rest[b]);
    }
  }
  q[j] = acc / static_cast<float>(n);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
lfq_entropy_grad_partial(const float* __restrict__ x, const float* __restrict__ w,
                         float* __restrict__ part, int n, float beta, int codes_per_split) {
  __shared__ float s_w[kBwdCodes];
  const int b = blockIdx.x * kBwdThreads + threadIdx.x;
  const bool valid = b < n;
  float two_abs[D], p_sum[D], n_sum[D];
  float rest = 0.f;
  unsigned pos = 0;
#pragma unroll
  for (int i = 0; i < D; ++i) { two_abs[i] = 0.f; p_sum[i] = 0.f; n_sum[i] = 0.f; }
  if (valid) pos = token_terms<D>(x + static_cast<size_t>(b) * D, beta, two_abs, &rest);

  const unsigned start = static_cast<unsigned>(blockIdx.y) * codes_per_split;
  for (unsigned c0 = start; c0 < start + codes_per_split; c0 += kBwdCodes) {
    __syncthreads();  // the previous weights are consumed
    for (int k = threadIdx.x; k < kBwdCodes; k += kBwdThreads) s_w[k] = w[c0 + k];
    __syncthreads();
    if (!valid) continue;
    for (int k = 0; k < kBwdCodes; ++k) {
      const unsigned j = c0 + k;
      const unsigned mism = j ^ pos;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) s += ((mism >> (D - 1 - i)) & 1u) ? two_abs[i] : 0.f;
      const float pw = expf(-s - rest) * s_w[k];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        if ((j >> (D - 1 - i)) & 1u) {
          p_sum[i] += pw;
        } else {
          n_sum[i] += pw;
        }
      }
    }
  }
  if (!valid) return;
  float* out = part + (static_cast<size_t>(blockIdx.y) * n + b) * (2 * D);
#pragma unroll
  for (int i = 0; i < D; ++i) { out[i] = p_sum[i]; out[D + i] = n_sum[i]; }
}

template <int D>
__global__ void __launch_bounds__(kReduceThreads)
lfq_entropy_grad_reduce(const float* __restrict__ x, const float* __restrict__ part,
                        float* __restrict__ dx, int n, float beta, int splits) {
  const int idx = blockIdx.x * kReduceThreads + threadIdx.x;
  if (idx >= n * D) return;
  const int b = idx / D, i = idx % D;
  float p_sum = 0.f, n_sum = 0.f;
  for (int s = 0; s < splits; ++s) {  // in order: deterministic
    const float* src = part + (static_cast<size_t>(s) * n + b) * (2 * D);
    p_sum += src[i];
    n_sum += src[D + i];
  }
  const float xi = x[idx];
  const float two_abs = 4.f * beta * fabsf(xi);
  const float e = expf(-two_abs);
  const float t = tanhf(0.5f * two_abs);
  const bool pos = xi > 0.f;
  const float match = pos ? p_sum : n_sum, mismatch = pos ? n_sum : p_sum;
  const float r = (1.f + t) * mismatch - (2.f * e / (1.f + e)) * match;
  dx[idx] = 2.f * beta * (pos ? r : -r);
}

template <int D>
cudaError_t launch_fwd(const float* x, float* q, int n, float beta, cudaStream_t stream) {
  lfq_avg_probs_kernel<D><<<(1u << D) / kFwdThreads, kFwdThreads, 0, stream>>>(x, q, n, beta);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const float* x, const float* w, float* part, float* dx, int n,
                       float beta, int splits, cudaStream_t stream) {
  const int codes_per_split = (1 << D) / splits;
  if (splits < 1 || splits > 65535 || codes_per_split * splits != (1 << D) ||
      codes_per_split % kBwdCodes != 0) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((n + kBwdThreads - 1) / kBwdThreads, splits);
  lfq_entropy_grad_partial<D><<<grid, kBwdThreads, 0, stream>>>(x, w, part, n, beta,
                                                                 codes_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = (n * D + kReduceThreads - 1) / kReduceThreads;
  lfq_entropy_grad_reduce<D><<<blocks, kReduceThreads, 0, stream>>>(x, part, dx, n, beta,
                                                                    splits);
  return cudaGetLastError();
}

}  // namespace

// The codebooks of the tokenizer configurations: 13 bits (8192 codes, the
// compact model) and 18 (262,144, MAGVIT2).
#define LFQ_ENTROPY_BITS(X) X(13) X(18)

// x: contiguous float32 (n, d); q: float32 (2^d). Requires d of 13 or 18.
// Returns the CUDA error of the launch (0 on success).
extern "C" int lfq_entropy_fwd(const void* x, void* q, int n, int d, float beta,
                               void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* qf = static_cast<float*>(q);
  switch (d) {
#define CASE(B) case B: return launch_fwd<B>(xf, qf, n, beta, s);
    LFQ_ENTROPY_BITS(CASE)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

// x: contiguous float32 (n, d); w: float32 (2^d); part: float32 scratch
// (splits, n, 2d); dx: float32 (n, d). `splits` divides 2^d into runs of a
// multiple of 256 codes. Requires d of 13 or 18. Returns the CUDA error of the
// launches (0 on success).
extern "C" int lfq_entropy_bwd(const void* x, const void* w, void* part, void* dx, int n,
                               int d, float beta, int splits, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(part);
  float* df = static_cast<float*>(dx);
  switch (d) {
#define CASE(B) case B: return launch_bwd<B>(xf, wf, pf, df, n, beta, splits, s);
    LFQ_ENTROPY_BITS(CASE)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}
