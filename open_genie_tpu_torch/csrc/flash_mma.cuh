// Building blocks shared by the tensor-core kernels (K1 in
// flash_attention_mma.cu, K3 in flash_attention_bwd_mma.cu, K4 in
// flash_attention_bwd_dq_mma.cu, K8 in moe_experts.cu, K9 in
// block_attention.cu): 16-byte cp.async
// copies into padded shared-memory tiles, ldmatrix loads of mma fragments,
// and the bf16 mma.sync.m16n8k16 product with f32 accumulation.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//     a[0] = A[g][2t, 2t+1]        a[1] = A[g+8][2t, 2t+1]
//     a[2] = A[g][2t+8, 2t+9]      a[3] = A[g+8][2t+8, 2t+9]
//   B (16 x 8, "col"): b[0] = B[2t, 2t+1][g], b[1] = B[2t+8, 2t+9][g]
//   C (16 x 8, f32):   c[0], c[1] = C[g][2t, 2t+1]; c[2], c[3] = C[g+8][2t, 2t+1]
// Two C tiles side by side (columns 0-7 and 8-15) are, once packed to bf16,
// exactly the A fragment of a 16 x 16 operand: a probability tile computed by
// one product feeds the next product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace flash_mma {

using bf16 = __nv_bfloat16;

constexpr float kNegBig = -1e30f;  // the Pallas kernels' masked logit
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kPad = 8;  // bf16 per row of padding: ldmatrix rows hit distinct banks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false nothing is read and the 16 bytes
// are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a * b on the tensor cores: bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of the 16 x 16 operand made of C tiles c0 (columns 0-7)
// and c1 (columns 8-15), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Row pointers of the three ldmatrix patterns on a padded tile of row
// stride S (bf16), for this lane:
//   a_row:  the A fragment of rows r0..r0+15, k-columns c0..c0+15;
//   b_row:  the B fragments of two 8-wide n-tiles whose B[k][n] = T[n][k]
//           (rows r0..r0+15 of T are n, columns c0..c0+15 are k):
//           r[0], r[1] for rows r0..r0+7 and r[2], r[3] for rows r0+8..r0+15;
//   bt_row: (with .trans) the B fragments of two 8-wide n-tiles whose
//           B[k][n] = T[k][n] (rows r0..r0+15 of T are k, columns c0..c0+15
//           are n): r[0], r[1] for columns c0..c0+7, r[2], r[3] for c0+8..c0+15.
template <int S>
__device__ __forceinline__ const bf16* a_row(const bf16* t, int r0, int c0, int lane) {
  return t + (r0 + (lane & 15)) * S + c0 + (lane >> 4) * 8;
}
template <int S>
__device__ __forceinline__ const bf16* b_row(const bf16* t, int r0, int c0, int lane) {
  return t + (r0 + (lane >> 4) * 8 + (lane & 7)) * S + c0 + ((lane >> 3) & 1) * 8;
}
template <int S>
__device__ __forceinline__ const bf16* bt_row(const bf16* t, int r0, int c0, int lane) {
  return t + (r0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S + c0 + (lane >> 4) * 8;
}

// Copy rows r0..r0+R-1 of a row-major (n, D) bf16 matrix into a tile of
// row stride D + kPad, zero-filling the rows at or past n. Asynchronous:
// the caller commits and waits.
template <int R, int D, int kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int n, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert((R * kChunks) % kThreads == 0, "tile copy must split evenly");
#pragma unroll
  for (int it = 0; it < R * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * (D + kPad) + c * 8,
               src + static_cast<size_t>(ok ? r0 + r : 0) * D + c * 8, ok);
  }
}

// Copy entries i0..i0+R-1 of an f32 vector of length n, zero past n.
template <int R, int kThreads>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int i0, int n, int tid) {
  for (int i = tid; i < R; i += kThreads) {
    const bool ok = i0 + i < n;
    cp_async4(dst + i, src + (ok ? i0 + i : 0), ok);
  }
}

// SMs of the current device, asked of the driver once per device (a launch
// of a few microseconds should not pay for the query).
inline int sm_count() {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) return 132;
  if (cached[device] == 0) {
    int sms = 132;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cached[device] = sms;
  }
  return cached[device];
}

// Warps per block (16 rows each): 4 when the grid of 64-row tiles fills the
// card, fewer (down to `min_warps`) when the sequence or the grid is short,
// so that more SMs work. At D = 128 the kernels keep 4 warps: fewer would
// spill, since a block's tile loads are unrolled over fewer threads.
template <int D>
int warps_for(int bh, int n) {
  constexpr int min_warps = D >= 128 ? 4 : 1;
  const int sms = sm_count();
  int w = 4;
  while (w > min_warps && (16 * (w / 2) >= n ||
                   static_cast<long long>(bh) * ((n + 16 * w - 1) / (16 * w)) < sms)) {
    w /= 2;
  }
  return w;
}

// Shared memory above the 48 KB default must be asked for per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// `allow_smem` once per kernel and device, so that a later launch asks the
// driver nothing (K8 and K9 run inside CUDA graphs, captured after a first
// eager call). A template argument, so that each kernel keeps its own flags.
template <auto Kernel>
cudaError_t allow_smem_once(int bytes) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < kMaxDevices && done[device]) return cudaSuccess;
  err = allow_smem(Kernel, bytes);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) done[device] = true;
  return err;
}

}  // namespace flash_mma
