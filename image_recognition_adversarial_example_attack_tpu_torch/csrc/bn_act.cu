// Fused frozen BatchNorm -> (residual add) -> ReLU for bfloat16 NHWC
// activations, forward and input gradient, written for Hopper (sm_90a).
//
// It replaces no Pallas TPU kernel: the JAX package's ResNet gets this chain
// fused by XLA.  In PyTorch each FrozenBatchNorm2d (F.batch_norm on a bf16
// channels_last tensor with float32 running statistics), each ReLU and each
// residual add is a library kernel of its own, and the BatchNorm's backward
// is a generic broadcast kernel; this file does the chain in one pass each
// way.  Three variants (models/resnet.py calls them through
// kernels/bn_act.py):
//
//   bn_relu         y = relu(bn(x))                      stem, conv1/conv2
//   bn_add_relu     y = relu(bn(x) + z)                  a block's identity
//   bn_bn_add_relu  y = relu(bn(x) + bn_z(z))            a projecting block
//
// Arithmetic, as the unfused path does it (so the forward matches it bit
// for bit where nvcc contracts alike, and the backward exactly):
//   invstd = rsqrtf(var + eps)                   (batch_norm_calc_invstd)
//   bn(x)  = bf16(w * (x - mean) * invstd + b)   in float32, in that order
//   y      = relu(bf16(bn(x) + z)), each BatchNorm rounded to bf16 first
//   g'     = (y <= 0) ? 0 : g                    (ReLU's threshold_backward)
//   gx     = bf16(g' * w * invstd)               (BatchNorm's eval backward)
//   gz     = g' (bn_add_relu) or bf16(g' * w_z * invstd_z) (bn_bn_add_relu)
// The backward reads only g and the saved output y (its ReLU mask): the
// input-gradient chain needs no per-channel reduction.  Parameter gradients
// are not computed here.
//
// Bound: bytes.  A few flops per 2-byte element against ~295 flop/byte on
// an H100, so the least time is the bytes moved over 3.35 TB/s: forward
// 4 B an element (read x, write y), 6 with z, backward 6 (read g and y,
// write gx), 8 with gz.
//
// Design: a tensor is rows of C channels (N*H*W rows, channels_last).
// Each thread owns one fixed group of 8 channels (a 16-byte vector) and
// walks rows in a grid-stride loop, two rows at a time so that more loads
// are in flight.  A block is R rows of C/8 threads, so a warp reads
// consecutive 16-byte vectors.  Because a thread's channels never change,
// it computes their float32 factors (mean, invstd, w, b) once, from the
// four vectors, and keeps them in registers: no per-call host work, and
// nothing cached that a later load_state_dict could leave stale.  The
// wrapper checks shapes, dtypes, layout and alignment; a launcher returns
// kRefused for channel counts it does not take, and cudaGetLastError()
// otherwise.  No launcher allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;              // bf16 channels in a 16-byte vector
constexpr int kThreads = 256;        // threads of a block, at most
constexpr int kMaxGroups = kThreads; // C <= 2048: one row fits a block
constexpr long long kMaxBlocks = 132LL * 8;
constexpr int kRefused = -1;

enum Mode { kRelu = 0, kAddRelu = 1, kBnAddRelu = 2 };

// One BatchNorm's float32 factors for a thread's 8 channels.
struct Factors {
  float mean[kVec], invstd[kVec], weight[kVec], bias[kVec];
};

__device__ __forceinline__ void load_factors(Factors& f, int c0, const float* mean,
                                             const float* var, const float* weight,
                                             const float* bias, float eps) {
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    f.invstd[j] = rsqrtf(var[c0 + j] + eps);
    f.weight[j] = weight[c0 + j];
    if (mean != nullptr) {
      f.mean[j] = mean[c0 + j];
      f.bias[j] = bias[c0 + j];
    }
  }
}

// bf16 pairs of a 32-bit word, exactly, as float32
__device__ __forceinline__ float lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// two float32 rounded to bf16 (nearest even), packed low first
__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// F.batch_norm's channels-last transform: w * (x - m) * invstd + b, in this
// order, rounded to bf16 as its output is
__device__ __forceinline__ float bn(const Factors& f, int j, float x) {
  return round_bf16(f.weight[j] * (x - f.mean[j]) * f.invstd[j] + f.bias[j]);
}

__device__ __forceinline__ float relu(float v) { return v <= 0.0f ? 0.0f : v; }

template <int kMode>
__device__ __forceinline__ uint4 forward_vec(const Factors& f, const Factors& fz,
                                             uint4 xv, uint4 zv) {
  const uint32_t xs[4] = {xv.x, xv.y, xv.z, xv.w};
  const uint32_t zs[4] = {zv.x, zv.y, zv.z, zv.w};
  uint32_t out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float a = bn(f, 2 * k, lo(xs[k]));
    float b = bn(f, 2 * k + 1, hi(xs[k]));
    if (kMode == kAddRelu) {
      a = round_bf16(a + lo(zs[k]));
      b = round_bf16(b + hi(zs[k]));
    } else if (kMode == kBnAddRelu) {
      a = round_bf16(a + bn(fz, 2 * k, lo(zs[k])));
      b = round_bf16(b + bn(fz, 2 * k + 1, hi(zs[k])));
    }
    out[k] = pack(relu(a), relu(b));
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// The block's threads: R rows of `groups` threads; thread (r, g) owns
// channels 8g .. 8g+7 and rows blockIdx.x * R + r + k * gridDim.x * R.
template <int kMode>
__device__ __forceinline__ void forward_body(
    const uint4* __restrict__ x, const uint4* __restrict__ z, const float* mean,
    const float* var, const float* weight, const float* bias, const float* z_mean,
    const float* z_var, const float* z_weight, const float* z_bias, uint4* __restrict__ y,
    long long rows, int groups, float eps) {
  const int g = threadIdx.x % groups;
  const int r = threadIdx.x / groups;
  const int rows_per_block = blockDim.x / groups;
  Factors f, fz;
  load_factors(f, g * kVec, mean, var, weight, bias, eps);
  if (kMode == kBnAddRelu) load_factors(fz, g * kVec, z_mean, z_var, z_weight, z_bias, eps);
  const long long stride = static_cast<long long>(gridDim.x) * rows_per_block;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (long long row = static_cast<long long>(blockIdx.x) * rows_per_block + r; row < rows;
       row += 2 * stride) {
    const long long i0 = row * groups + g;
    const long long i1 = i0 + stride * groups;
    const bool second = row + stride < rows;
    const uint4 x0 = x[i0];
    const uint4 x1 = second ? x[i1] : zero;
    uint4 z0 = zero, z1 = zero;
    if (kMode != kRelu) {
      z0 = z[i0];
      if (second) z1 = z[i1];
    }
    y[i0] = forward_vec<kMode>(f, fz, x0, z0);
    if (second) y[i1] = forward_vec<kMode>(f, fz, x1, z1);
  }
}

__global__ void __launch_bounds__(kThreads, 2) bn_relu_kernel(
    const uint4* __restrict__ x, const float* mean, const float* var, const float* weight,
    const float* bias, uint4* __restrict__ y, long long rows, int groups, float eps) {
  forward_body<kRelu>(x, nullptr, mean, var, weight, bias, nullptr, nullptr, nullptr, nullptr,
                      y, rows, groups, eps);
}

__global__ void __launch_bounds__(kThreads, 2) bn_add_relu_kernel(
    const uint4* __restrict__ x, const uint4* __restrict__ z, const float* mean,
    const float* var, const float* weight, const float* bias, uint4* __restrict__ y,
    long long rows, int groups, float eps) {
  forward_body<kAddRelu>(x, z, mean, var, weight, bias, nullptr, nullptr, nullptr, nullptr, y,
                         rows, groups, eps);
}

__global__ void __launch_bounds__(kThreads, 2) bn_bn_add_relu_kernel(
    const uint4* __restrict__ x, const uint4* __restrict__ z, const float* mean,
    const float* var, const float* weight, const float* bias, const float* z_mean,
    const float* z_var, const float* z_weight, const float* z_bias, uint4* __restrict__ y,
    long long rows, int groups, float eps) {
  forward_body<kBnAddRelu>(x, z, mean, var, weight, bias, z_mean, z_var, z_weight, z_bias, y,
                           rows, groups, eps);
}

// g' * w * invstd, rounded to bf16: BatchNorm's eval backward
__device__ __forceinline__ float bn_grad(const Factors& f, int j, float g) {
  return g * f.weight[j] * f.invstd[j];
}

template <int kMode>
__device__ __forceinline__ void backward_vec(const Factors& f, const Factors& fz, uint4 gv,
                                             uint4 yv, uint4& gx, uint4& gz) {
  const uint32_t gs[4] = {gv.x, gv.y, gv.z, gv.w};
  const uint32_t ys[4] = {yv.x, yv.y, yv.z, yv.w};
  uint32_t ox[4], oz[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // ReLU's backward keeps g where y > 0 and writes a bf16 zero elsewhere;
    // y <= 0 is false for NaN, as in threshold_backward
    const uint32_t masked = ((lo(ys[k]) <= 0.0f) ? 0u : (gs[k] & 0x0000ffffu)) |
                            ((hi(ys[k]) <= 0.0f) ? 0u : (gs[k] & 0xffff0000u));
    const float a = lo(masked), b = hi(masked);
    ox[k] = pack(bn_grad(f, 2 * k, a), bn_grad(f, 2 * k + 1, b));
    if (kMode == kAddRelu) {
      oz[k] = masked;
    } else if (kMode == kBnAddRelu) {
      oz[k] = pack(bn_grad(fz, 2 * k, a), bn_grad(fz, 2 * k + 1, b));
    }
  }
  gx = make_uint4(ox[0], ox[1], ox[2], ox[3]);
  if (kMode != kRelu) gz = make_uint4(oz[0], oz[1], oz[2], oz[3]);
}

template <int kMode>
__device__ __forceinline__ void backward_body(
    const uint4* __restrict__ grad, const uint4* __restrict__ y, const float* var,
    const float* weight, const float* z_var, const float* z_weight, uint4* __restrict__ gx,
    uint4* __restrict__ gz, long long rows, int groups, float eps) {
  const int g = threadIdx.x % groups;
  const int r = threadIdx.x / groups;
  const int rows_per_block = blockDim.x / groups;
  Factors f, fz;
  load_factors(f, g * kVec, nullptr, var, weight, nullptr, eps);
  if (kMode == kBnAddRelu) load_factors(fz, g * kVec, nullptr, z_var, z_weight, nullptr, eps);
  const long long stride = static_cast<long long>(gridDim.x) * rows_per_block;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (long long row = static_cast<long long>(blockIdx.x) * rows_per_block + r; row < rows;
       row += 2 * stride) {
    const long long i0 = row * groups + g;
    const long long i1 = i0 + stride * groups;
    const bool second = row + stride < rows;
    const uint4 g0 = grad[i0], y0 = y[i0];
    const uint4 g1 = second ? grad[i1] : zero;
    const uint4 y1 = second ? y[i1] : zero;
    uint4 ox, oz;
    backward_vec<kMode>(f, fz, g0, y0, ox, oz);
    gx[i0] = ox;
    if (kMode != kRelu) gz[i0] = oz;
    if (second) {
      backward_vec<kMode>(f, fz, g1, y1, ox, oz);
      gx[i1] = ox;
      if (kMode != kRelu) gz[i1] = oz;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) bn_relu_backward_kernel(
    const uint4* __restrict__ grad, const uint4* __restrict__ y, const float* var,
    const float* weight, uint4* __restrict__ gx, long long rows, int groups, float eps) {
  backward_body<kRelu>(grad, y, var, weight, nullptr, nullptr, gx, nullptr, rows, groups, eps);
}

__global__ void __launch_bounds__(kThreads, 2) bn_add_relu_backward_kernel(
    const uint4* __restrict__ grad, const uint4* __restrict__ y, const float* var,
    const float* weight, uint4* __restrict__ gx, uint4* __restrict__ gz, long long rows,
    int groups, float eps) {
  backward_body<kAddRelu>(grad, y, var, weight, nullptr, nullptr, gx, gz, rows, groups, eps);
}

__global__ void __launch_bounds__(kThreads, 2) bn_bn_add_relu_backward_kernel(
    const uint4* __restrict__ grad, const uint4* __restrict__ y, const float* var,
    const float* weight, const float* z_var, const float* z_weight, uint4* __restrict__ gx,
    uint4* __restrict__ gz, long long rows, int groups, float eps) {
  backward_body<kBnAddRelu>(grad, y, var, weight, z_var, z_weight, gx, gz, rows, groups, eps);
}

// R rows of C/8 threads: at most kThreads threads, at least one row
inline int block_for(int groups) {
  const int rows_per_block = kThreads / groups;
  return rows_per_block * groups;
}

inline int grid_for(long long rows, int threads, int groups) {
  const long long rows_per_block = threads / groups;
  long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<int>(blocks);
}

inline bool takes(int mode, long long rows, int channels) {
  return mode >= kRelu && mode <= kBnAddRelu && rows >= 0 && channels > 0 &&
         channels % kVec == 0 && channels / kVec <= kMaxGroups;
}

}  // namespace

extern "C" {

// mode 0 bn_relu, 1 bn_add_relu (z added), 2 bn_bn_add_relu (z through its
// own BatchNorm: z_mean .. z_bias); x, z and y: [rows, channels] bf16
int bn_act_forward_launch(int mode, const void* x, const void* z, const float* mean,
                          const float* var, const float* weight, const float* bias,
                          const float* z_mean, const float* z_var, const float* z_weight,
                          const float* z_bias, void* y, long long rows, int channels, float eps,
                          cudaStream_t stream) {
  if (!takes(mode, rows, channels)) return kRefused;
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const int groups = channels / kVec;
  const int threads = block_for(groups);
  const int blocks = grid_for(rows, threads, groups);
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* zv = static_cast<const uint4*>(z);
  uint4* yv = static_cast<uint4*>(y);
  if (mode == kRelu) {
    bn_relu_kernel<<<blocks, threads, 0, stream>>>(xv, mean, var, weight, bias, yv, rows,
                                                   groups, eps);
  } else if (mode == kAddRelu) {
    bn_add_relu_kernel<<<blocks, threads, 0, stream>>>(xv, zv, mean, var, weight, bias, yv,
                                                       rows, groups, eps);
  } else {
    bn_bn_add_relu_kernel<<<blocks, threads, 0, stream>>>(
        xv, zv, mean, var, weight, bias, z_mean, z_var, z_weight, z_bias, yv, rows, groups,
        eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// grad_out and the forward's y in, the gradient of x out (gx) and, for
// modes 1 and 2, the gradient of z (gz); all [rows, channels] bf16
int bn_act_backward_launch(int mode, const void* grad, const void* y, const float* var,
                           const float* weight, const float* z_var, const float* z_weight,
                           void* gx, void* gz, long long rows, int channels, float eps,
                           cudaStream_t stream) {
  if (!takes(mode, rows, channels)) return kRefused;
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const int groups = channels / kVec;
  const int threads = block_for(groups);
  const int blocks = grid_for(rows, threads, groups);
  const uint4* gv = static_cast<const uint4*>(grad);
  const uint4* yv = static_cast<const uint4*>(y);
  uint4* gxv = static_cast<uint4*>(gx);
  uint4* gzv = static_cast<uint4*>(gz);
  if (mode == kRelu) {
    bn_relu_backward_kernel<<<blocks, threads, 0, stream>>>(gv, yv, var, weight, gxv, rows,
                                                            groups, eps);
  } else if (mode == kAddRelu) {
    bn_add_relu_backward_kernel<<<blocks, threads, 0, stream>>>(gv, yv, var, weight, gxv, gzv,
                                                                rows, groups, eps);
  } else {
    bn_bn_add_relu_backward_kernel<<<blocks, threads, 0, stream>>>(
        gv, yv, var, weight, z_var, z_weight, gxv, gzv, rows, groups, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
