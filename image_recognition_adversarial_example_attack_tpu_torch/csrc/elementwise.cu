// Elementwise kernels of the PGD-Linf attack and the quantization defense,
// written for Hopper (sm_90a).  Each replaces one Pallas TPU kernel of
// image_recognition_adversarial_example_attack_tpu/ops/pallas_ops.py:
//
//   pgd_step_kernel       <- pgd_step_pallas      (_pgd_step_kernel)
//   quantize_kernel       <- quantize_pallas      (_quantize_kernel)
//   uniform_noise_kernel  <- uniform_noise_pallas (_make_uniform_kernel)
//
// Bound: all three are memory-bound.  Each touches every element once and
// does a handful of flops per 4-byte element, far below the ~295 flop/byte
// ridge of an H100, so the least time is bytes / 3.35 TB/s (pgd_step: 3
// reads + 1 write, quantize: 1 read + 1 write, noise: 1 write).
//
// Design: one thread per element in a grid-stride loop with a masked tail,
// so any contiguous float32 tensor is taken as it is; the TPU version's
// [rows, 128] pad/unpad (ops/pallas_ops.py:41-51) has no counterpart.  The
// scalars (alpha, eps, levels-1, seed) are kernel arguments, so one build
// serves every eps of a sweep.  No launcher allocates or synchronises: the
// Python wrapper allocates the output and launches on PyTorch's current
// stream, and each launcher returns cudaGetLastError().
//
// Build without --use_fast_math: quantize needs IEEE division and rintf
// (round half to even, as jnp.round and torch.round) to stay bit-exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Enough blocks to fill 132 SMs several times over; the grid-stride loop
// covers the rest.
constexpr long long kMaxBlocks = 132LL * 16;

inline int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks);
}

// x' = clip(clip(x + alpha * sign(g), x0 - eps, x0 + eps), 0, 1), with
// sign(0) = 0 and the min/max order of attacks/pgd.py:26-28.  alpha * sign
// is exact, so an FMA contraction of the add changes no bit.
__global__ void pgd_step_kernel(const float* __restrict__ x,
                                const float* __restrict__ g,
                                const float* __restrict__ x0,
                                float* __restrict__ out, long long n,
                                float alpha, float eps) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float gi = g[i];
    const float s = gi > 0.0f ? 1.0f : (gi < 0.0f ? -1.0f : 0.0f);
    const float base = x0[i];
    float v = x[i] + alpha * s;
    v = fminf(fmaxf(v, base - eps), base + eps);
    out[i] = fminf(fmaxf(v, 0.0f), 1.0f);
  }
}

// round(clip01(x) * scale) / scale with scale = levels - 1; rintf rounds
// half to even and the division is IEEE (no fast math).
__global__ void quantize_kernel(const float* __restrict__ x,
                                float* __restrict__ out, long long n,
                                float scale) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float v = fminf(fmaxf(x[i], 0.0f), 1.0f);
    out[i] = rintf(v * scale) / scale;
  }
}

// Philox-4x32-10 (Salmon et al., SC 2011): ten rounds of the 4x32 bijection
// with the Weyl key schedule.  Counter-based, so every element's bits are a
// pure function of (seed, element index) and blocks need no shared state.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  const uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += kW0;
    k.y += kW1;
  }
  return c;
}

// The 24 high bits fill a float32 mantissa exactly, as in
// ops/pallas_ops.py:158-164: u = (bits >> 8) * 2^-24 in [0, 1), then
// (2u - 1) * eps, which lies in [-eps, eps).
__device__ __forceinline__ float bits_to_uniform(uint32_t bits, float eps) {
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
  return (u * 2.0f - 1.0f) * eps;
}

// One Philox call gives four elements: thread t owns elements 4t .. 4t+3,
// counter = (t, 0), key = seed.
__global__ void uniform_noise_kernel(float* __restrict__ out, long long n,
                                     unsigned long long seed, float eps) {
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < groups; t += stride) {
    const uint4 ctr = make_uint4(static_cast<uint32_t>(t),
                                 static_cast<uint32_t>(t >> 32), 0u, 0u);
    const uint4 r = philox4x32_10(ctr, key);
    const float v0 = bits_to_uniform(r.x, eps), v1 = bits_to_uniform(r.y, eps);
    const float v2 = bits_to_uniform(r.z, eps), v3 = bits_to_uniform(r.w, eps);
    const long long i = 4 * t;
    if (i + 3 < n) {
      // the wrapper allocates `out`, so it is 16-byte aligned
      reinterpret_cast<float4*>(out)[t] = make_float4(v0, v1, v2, v3);
    } else {
      out[i] = v0;
      if (i + 1 < n) out[i + 1] = v1;
      if (i + 2 < n) out[i + 2] = v2;
    }
  }
}

}  // namespace

extern "C" {

int pgd_step_launch(const float* x, const float* g, const float* x0,
                    float* out, long long n, float alpha, float eps,
                    cudaStream_t stream) {
  if (n > 0) {
    pgd_step_kernel<<<grid_for(n), kThreads, 0, stream>>>(x, g, x0, out, n,
                                                           alpha, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

int quantize_launch(const float* x, float* out, long long n, float scale,
                    cudaStream_t stream) {
  if (n > 0) {
    quantize_kernel<<<grid_for(n), kThreads, 0, stream>>>(x, out, n, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

int uniform_noise_launch(float* out, long long n, unsigned long long seed,
                         float eps, cudaStream_t stream) {
  if (n > 0) {
    uniform_noise_kernel<<<grid_for((n + 3) / 4), kThreads, 0, stream>>>(
        out, n, seed, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
