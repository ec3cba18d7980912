// MaskGIT sampler for Hopper (sm_90a): kernel K7 of the PyTorch port.
//
// Replaces no TPU kernel. The JAX package's sampler
// (open_genie_tpu/models/dynamics.py::maskgit_commit) is plain jnp, which
// XLA fuses into a few passes; in the port the same chain ran as about 30
// separate elementwise and reduction passes over float32 copies of the
// (B*HW, V) logits a refinement. This pair computes the whole commit after
// the noise draw in one read of the logits and the noise.
//
// What it computes, per row r (player b, position p) and token v:
//   x = logit / temp in f32 (an IEEE division; none at temp 1, where it is
//   exact), g = bf16_rn(-logf(-logf(max(u, FLT_MIN)))) from the uniform
//   draw u, or g as given, pred = argmax_v (x + g) with ties to the lowest
//   v, conf = x[pred] - logsumexp_v(x), -inf where the position is no longer
//   masked; then per player the num_tokens-th largest conf is the
//   threshold, and every masked position with conf >= thr commits pred (an
//   exact tie at the threshold commits both).
//
// What bounds it on this card: the logarithms, then the bytes. At the
// session's 2048 rows of 2^18 bf16 logits and f32 uniforms it reads 1.07 GB
// + 2.15 GB once: 0.96 ms at 3.35 TB/s (an H100 SXM at 700 W). The
// arithmetic per element (two accurate logf and the rounding to bf16, one
// expf, a compare) is about 60 instructions, which the SMs issue in about
// 1.6 ms at that shape, so the kernel spends its issue slots on them and
// nothing else: its loads are 16 bytes (f32) or 8 bytes (bf16) a thread,
// streamed past the caches, and no element is touched twice. (Skipping the
// logarithms of elements that provably cannot win saves about a quarter of
// the pair's time; in the session, whose step waits on the host, it moved
// nothing end to end, so the kernel does not.)
//
// What the design does about it: maskgit_sample_partial_kernel runs one
// 256-thread block per (row, split), S splits of the vocabulary a row (the
// wrapper picks S from the rows and V: one at small V, enough at 2^18 that
// the blocks fill the SMs several times over). Each thread walks its
// elements in increasing order, keeping the best x + g, its index and its
// x, and an online (max, sum of exp) of x; the block reduces them by a
// fixed shuffle tree and writes one partial record. Exact ties keep the
// lower index at every step, so the result is torch.argmax's.
// maskgit_sample_commit_kernel runs one block per player: each thread
// combines the S partials of its positions in split order, writes pred and
// conf, finds the threshold by counting for each position the confidences
// above it and at or above it (no cap on HW), then writes the new mask and
// code. No atomics: two calls are bit-identical.
//
// Numbers: x, g and x + g are computed exactly as the plain twin computes
// them (same libdevice logf, same rounding to bf16), so pred agrees exactly;
// the log-sum-exp sums in another order, so conf agrees to f32 rounding.
// V must be a multiple of 4 and the rows aligned to a 4-element load (the
// wrapper refuses anything else; every configuration's V is a power of 2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;  // elements a thread loads at once
constexpr int kMaxCommitThreads = 1024;

// The running state of a thread, a block or a row: the best x + g, its
// index and x there, and max and sum of exp(x - max) of x.
struct Best {
  float y;
  int idx;
  float x;
  float m;
  float s;
};

__device__ __forceinline__ void merge(Best& a, const Best& b) {
  if (b.y > a.y || (b.y == a.y && b.idx < a.idx)) {
    a.y = b.y;
    a.idx = b.idx;
    a.x = b.x;
  }
  const float m = fmaxf(a.m, b.m);
  a.s = m == -INFINITY ? 0.f : a.s * expf(a.m - m) + b.s * expf(b.m - m);
  a.m = m;
}

__device__ __forceinline__ Best shfl_down(const Best& a, int off) {
  Best b;
  b.y = __shfl_down_sync(0xffffffffu, a.y, off);
  b.idx = __shfl_down_sync(0xffffffffu, a.idx, off);
  b.x = __shfl_down_sync(0xffffffffu, a.x, off);
  b.m = __shfl_down_sync(0xffffffffu, a.m, off);
  b.s = __shfl_down_sync(0xffffffffu, a.s, off);
  return b;
}

// kVec consecutive elements as f32, streamed (read once, evict first).
__device__ __forceinline__ void load(const float* p, float (&f)[kVec]) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[kVec]) {
  const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
  // bf16 -> f32 is exact: the bf16 bits are the f32's high 16 bits.
  f[0] = __uint_as_float(v.x << 16); f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16); f[3] = __uint_as_float(v.y & 0xffff0000u);
}

// The plain twin's Gumbel noise from a uniform clamped to [FLT_MIN, 1):
// -log(-log(u)), rounded to bf16 (the JAX package draws it in bf16).
__device__ __forceinline__ float gumbel(float u) {
  return __bfloat162float(__float2bfloat16_rn(-logf(-logf(u))));
}

// Folds element i (logit l, noise n) into the thread's state.
template <bool UNIFORM, bool DIVIDE>
__device__ __forceinline__ void take(Best& b, int i, float l, float n, float temp) {
  const float x = DIVIDE ? __fdiv_rn(l, temp) : l;
  const float y = x + (UNIFORM ? gumbel(fmaxf(n, FLT_MIN)) : n);
  if (y > b.y) {  // ties keep the earlier, lower index
    b.y = y;
    b.idx = i;
    b.x = x;
  }
  if (x > b.m) {
    b.s = b.s * expf(b.m - x) + 1.f;
    b.m = x;
  } else if (b.m != -INFINITY) {
    b.s += expf(x - b.m);
  }
}

// TL: the logits' type; TN: the noise's (uniforms in f32, or Gumbel values
// in f32 or bf16). UNIFORM: the noise is u. DIVIDE: temp != 1.
template <typename TL, typename TN, bool UNIFORM, bool DIVIDE>
__global__ void __launch_bounds__(kThreads)
maskgit_sample_partial_kernel(const TL* __restrict__ logits, const TN* __restrict__ noise,
                              float temp, int v, int splits, int chunk,
                              float4* __restrict__ part_f, int* __restrict__ part_i) {
  const long long row = blockIdx.x / splits;
  const int begin = (blockIdx.x % splits) * chunk;
  const int end = min(begin + chunk, v);  // a multiple of kVec, as chunk and v are
  const TL* lr = logits + row * v;
  const TN* nr = noise + row * v;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  // A thread with no element keeps y = -inf at an index past every real
  // element of its split: any of them wins over it.
  const int first = begin + static_cast<int>(threadIdx.x) * kVec;
  Best b{-INFINITY, first, -INFINITY, -INFINITY, 0.f};
  for (int i = first; i < end; i += kThreads * kVec) {
    float l[kVec], n[kVec];
    load(lr + i, l);
    load(nr + i, n);
#pragma unroll
    for (int e = 0; e < kVec; ++e) take<UNIFORM, DIVIDE>(b, i + e, l[e], n[e], temp);
  }
  for (int off = 16; off > 0; off >>= 1) merge(b, shfl_down(b, off));
  __shared__ Best warps[kWarps];
  if (lane == 0) warps[warp] = b;
  __syncthreads();
  if (threadIdx.x == 0) {
    Best r = warps[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) merge(r, warps[w]);
    part_f[blockIdx.x] = make_float4(r.y, r.x, r.m, r.s);
    part_i[blockIdx.x] = r.idx;
  }
}

// One block per player: the S partials of each of its hw positions
// combined, pred and conf written, the threshold selected, the commit.
template <typename TC>
__global__ void __launch_bounds__(kMaxCommitThreads)
maskgit_sample_commit_kernel(const float4* __restrict__ part_f, const int* __restrict__ part_i,
                             int splits, int hw, int num_tokens,
                             const bool* __restrict__ mask, const TC* __restrict__ code,
                             bool* __restrict__ mask_out, TC* __restrict__ code_out,
                             long long* __restrict__ pred, float* conf) {
  const long long row0 = static_cast<long long>(blockIdx.x) * hw;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const long long r = row0 + p;
    const float4 f = part_f[r * splits];
    Best a{f.x, part_i[r * splits], f.y, f.z, f.w};
    for (int k = 1; k < splits; ++k) {
      const float4 g = part_f[r * splits + k];
      merge(a, Best{g.x, part_i[r * splits + k], g.y, g.z, g.w});
    }
    pred[r] = a.idx;
    conf[r] = mask[r] ? a.x - (logf(a.s) + a.m) : -INFINITY;
  }
  __syncthreads();  // conf of every position is visible to the block
  // The num_tokens-th largest conf (clamped to 1..hw): the value with at
  // most k above it and more than k at or above it.
  __shared__ float thr;
  const int k = min(max(num_tokens - 1, 0), hw - 1);
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const float c = conf[row0 + p];
    int above = 0, at_or_above = 0;
    for (int q = 0; q < hw; ++q) {
      const float o = conf[row0 + q];
      above += o > c;
      at_or_above += o >= c;
    }
    if (above <= k && k < at_or_above) thr = c;  // every writer writes the same value
  }
  __syncthreads();
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const long long r = row0 + p;
    const bool commit = mask[r] && conf[r] >= thr;
    mask_out[r] = mask[r] && !commit;
    code_out[r] = commit ? static_cast<TC>(pred[r]) : code[r];
  }
}

struct Args {
  const void *logits, *noise, *mask, *code;
  float temp;
  int b, hw, v, splits, num_tokens;
  void *part, *mask_out, *code_out, *pred, *conf;
};

template <typename TL, typename TN, bool UNIFORM, bool DIVIDE>
cudaError_t launch_partial(const Args& a, cudaStream_t stream) {
  const long long rows = static_cast<long long>(a.b) * a.hw;
  const long long blocks = rows * a.splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  int chunk = (a.v + a.splits - 1) / a.splits;
  chunk = (chunk + kVec - 1) / kVec * kVec;
  float4* part_f = static_cast<float4*>(a.part);
  int* part_i = reinterpret_cast<int*>(part_f + blocks);
  maskgit_sample_partial_kernel<TL, TN, UNIFORM, DIVIDE>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const TL*>(a.logits), static_cast<const TN*>(a.noise), a.temp, a.v,
          a.splits, chunk, part_f, part_i);
  return cudaGetLastError();
}

template <typename TL, typename TN, bool UNIFORM>
cudaError_t by_temp(const Args& a, cudaStream_t stream) {
  return a.temp != 1.f ? launch_partial<TL, TN, UNIFORM, true>(a, stream)
                       : launch_partial<TL, TN, UNIFORM, false>(a, stream);
}

template <typename TL>
cudaError_t by_noise(const Args& a, int noise_kind, cudaStream_t stream) {
  switch (noise_kind) {
    case 0: return by_temp<TL, float, true>(a, stream);
    case 1: return by_temp<TL, float, false>(a, stream);
    case 2: return by_temp<TL, __nv_bfloat16, false>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TC>
cudaError_t launch_commit(const Args& a, cudaStream_t stream) {
  const int threads = min(kMaxCommitThreads, (a.hw + 31) / 32 * 32);
  const float4* part_f = static_cast<const float4*>(a.part);
  const long long blocks = static_cast<long long>(a.b) * a.hw * a.splits;
  maskgit_sample_commit_kernel<TC><<<a.b, threads, 0, stream>>>(
      part_f, reinterpret_cast<const int*>(part_f + blocks), a.splits, a.hw, a.num_tokens,
      static_cast<const bool*>(a.mask), static_cast<const TC*>(a.code),
      static_cast<bool*>(a.mask_out), static_cast<TC*>(a.code_out),
      static_cast<long long*>(a.pred), static_cast<float*>(a.conf));
  return cudaGetLastError();
}

}  // namespace

// logits: contiguous (b, hw, v), v a multiple of 4, 16-byte (f32) or
// 8-byte (bf16) aligned, float32 or bfloat16 by `logits_dtype` (0, 1);
// noise: contiguous (b, hw, v), aligned alike, by `noise_kind`: 0 uniforms in float32,
// 1 Gumbel values in float32, 2 in bfloat16; part: scratch of
// b * hw * splits * 5 floats; mask, mask_out: bool (b, hw); code, code_out:
// (b, hw) int32 or int64 by `code_dtype` (0, 1); pred: int64 (b, hw); conf:
// float32 (b, hw). Launches the partial and the commit kernel on `stream`;
// returns the CUDA error of the launches (0 on success).
extern "C" int maskgit_sample(const void* logits, int logits_dtype, const void* noise,
                              int noise_kind, float temp, int b, int hw, int v, int splits,
                              void* part, const void* mask, const void* code, int code_dtype,
                              int num_tokens, void* mask_out, void* code_out, void* pred,
                              void* conf, void* stream) {
  if (b <= 0 || hw <= 0 || v <= 0 || v % kVec || splits <= 0 || !(temp > 0.f)) {
    return cudaErrorInvalidValue;
  }
  const Args a{logits, noise, mask, code, temp, b, hw, v, splits, num_tokens,
               part, mask_out, code_out, pred, conf};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (logits_dtype) {
    case 0: err = by_noise<float>(a, noise_kind, s); break;
    case 1: err = by_noise<__nv_bfloat16>(a, noise_kind, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  switch (code_dtype) {
    case 0: return launch_commit<int>(a, s);
    case 1: return launch_commit<long long>(a, s);
    default: return cudaErrorInvalidValue;
  }
}
