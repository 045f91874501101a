// 3x3, stride-1, same-padded convolution of an NHWC batch with 64 input and
// 64 output channels, written for Hopper (sm_90a).  It replaces the Pallas
// TPU kernel benchmarks/pallas_conv_probe.py::pallas_conv3x3 (body
// _conv_kernel), the probe of ResNet-50's stage-1 3x3 conv:
//
//   out[b,y,x,o] = cast( sum_{dy,dx in 0..2} sum_{c<64}
//                        x[b, y+dy-1, x+dx-1, c] * w[dy, dx, c, o] )
//
// with taps outside the image read as zero and the sum kept in float32.  The
// K order is tap-major, then channel (k = (dy*3+dx)*64 + c), the TPU
// kernel's im2col order, so the HWIO weight reshaped to [576, 64] is the
// GEMM's B matrix as it stands.
//
// Bound (H100 SXM, B=128, 56x56): 2*128*56*56*9*64*64 = 29.60 GFLOP, at
// 989 TFLOP/s bf16 0.0299 ms; bytes x 51.38 MB + out 51.38 MB + w 0.07 MB =
// 102.8 MB, at 3.35 TB/s 0.0307 ms.  The shape sits at the ridge (about 288
// flop/byte against the card's 295), so the bound is the bytes' 0.0307 ms,
// with the flops' 0.0299 ms close behind.  float32: the bytes give 0.0614 ms
// and FP32 FMA at 67 TFLOP/s 0.44 ms, so operations bound it.
//
// Design (an implicit GEMM, simple and right first):
// - The TPU wrapper writes a padded copy of x (jnp.pad); here the kernel
//   masks the border itself while it stages a tile, and no padded tensor
//   is ever written.
// - A block owns a tile of 128 flattened output pixels of one image and all
//   64 output channels.  Blocks are persistent: as many as fit on the card,
//   each walking over tiles, so the weight is staged into shared memory
//   once per block, not once per tile.
// - bf16: the weight is held transposed ([64 out][576 k], k contiguous) in
//   shared memory, 74.8 KB with a pad of 8 per row; for each of the nine
//   taps a [128 pixel x 64 channel] A tile is staged with zero fill, and
//   eight warps, 16 pixel rows each, run mma.sync.m16n8k16 bf16 -> f32
//   tensor-core products over its 64 channels.  Both tiles carry a row pad
//   of 8 bf16 so that the fragment loads of a warp hit 32 distinct banks.
//   The epilogue rounds to nearest even (__floats2bfloat162_rn), as
//   Tensor.to(torch.bfloat16) rounds the plain float32 sum.
// - float32: the same tiling with exact FP32 FMA on the CUDA cores (never
//   TF32, since the JAX float32 path is exact float32): the weight as it
//   stands ([576][64], 147 KB) and a [128 x 64] A tile per tap; each thread
//   holds 8 pixels x 4 channels of accumulators.
// - No wgmma, TMA or multi-stage pipeline yet: a tap's tile is staged,
//   the block synchronises, computes, and synchronises again.
//
// The launchers take 16-byte-aligned contiguous tensors (the wrapper checks
// it), allocate nothing, do not synchronise, launch on the caller's stream
// and return cudaGetLastError().  Build without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;              // input and output channels
constexpr int kTaps = 9;
constexpr int kK = kTaps * kC;      // 576, the GEMM's depth
constexpr int kTileP = 128;         // output pixels per tile
constexpr int kThreads = 256;       // eight warps

// bf16 layout of shared memory, in elements
constexpr int kPadB = 8;
constexpr int kWtStride = kK + kPadB;    // 584: transposed weight row
constexpr int kAStrideB = kC + kPadB;    // 72: A tile row
constexpr int kSmemBf16 = (kC * kWtStride + kTileP * kAStrideB) * 2;  // 93,184 B

// float32 layout of shared memory, in elements
constexpr int kAStrideF = kC + 4;        // 68
constexpr int kSmemF32 = (kK * kC + kTileP * kAStrideF) * 4;          // 182,272 B

// Stages the [128 pixel x 64 channel] A tile of one tap: pixel p of the tile
// reads x[b, y+dy-1, x+dx-1, :], or zeros outside the image and past the
// last pixel.  16-byte chunks; consecutive threads read consecutive chunks
// of one pixel's 64 channels.
template <typename T>
__device__ __forceinline__ void stage_tap(const T* __restrict__ xb, T* a_tile,
                                          int a_stride, int p0, int h, int w,
                                          int dy, int dx) {
  constexpr int kPer = 16 / sizeof(T);        // elements per chunk
  constexpr int kChunks = kC / kPer;          // chunks per pixel
  const int hw = h * w;
  for (int i = threadIdx.x; i < kTileP * kChunks; i += kThreads) {
    const int p = i / kChunks, part = i % kChunks;
    const int pix = p0 + p;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (pix < hw) {
      const int sy = pix / w + dy - 1, sx = pix % w + dx - 1;
      if (sy >= 0 && sy < h && sx >= 0 && sx < w) {
        v = *reinterpret_cast<const uint4*>(
            xb + (static_cast<long long>(sy) * w + sx) * kC + part * kPer);
      }
    }
    *reinterpret_cast<uint4*>(a_tile + p * a_stride + part * kPer) = v;
  }
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ wgt,
                    __nv_bfloat16* __restrict__ out, int batch, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][584]
  __nv_bfloat16* a_tile = wt + kC * kWtStride;                 // [128][72]

  // the weight, transposed: wt[n][k] = wgt[k][n]; 16-byte global loads
  for (int i = threadIdx.x; i < kK * kC / 8; i += kThreads) {
    const int k = i / (kC / 8), n0 = (i % (kC / 8)) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(wgt + k * kC + n0);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) wt[(n0 + j) * kWtStride + k] = e[j];
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int hw = h * w;
  const int tiles_per_image = (hw + kTileP - 1) / kTileP;
  const long long tiles = static_cast<long long>(batch) * tiles_per_image;
  const __nv_bfloat16* a_row0 = a_tile + (warp * 16 + g) * kAStrideB + 2 * t;
  const __nv_bfloat16* a_row1 = a_row0 + 8 * kAStrideB;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = static_cast<int>(tile / tiles_per_image);
    const int p0 = static_cast<int>(tile % tiles_per_image) * kTileP;
    const __nv_bfloat16* xb = x + static_cast<long long>(b) * hw * kC;

    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] = 0.0f;

    for (int tap = 0; tap < kTaps; ++tap) {
      __syncthreads();  // the previous tap's (or tile's) readers are done
      stage_tap(xb, a_tile, kAStrideB, p0, h, w, tap / 3, tap % 3);
      __syncthreads();
#pragma unroll
      for (int kc = 0; kc < kC; kc += 16) {
        const uint32_t a0 = lds32(a_row0 + kc), a1 = lds32(a_row1 + kc);
        const uint32_t a2 = lds32(a_row0 + kc + 8), a3 = lds32(a_row1 + kc + 8);
        const __nv_bfloat16* bp = wt + g * kWtStride + tap * kC + kc + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const __nv_bfloat16* bn = bp + nt * 8 * kWtStride;
          mma_bf16_16816(acc[nt], a0, a1, a2, a3, lds32(bn), lds32(bn + 8));
        }
      }
    }

    // epilogue: rows g and g+8 of the warp's 16, columns nt*8 + 2t, +1
    const int r0 = p0 + warp * 16 + g, r1 = r0 + 8;
    __nv_bfloat16* ob = out + static_cast<long long>(b) * hw * kC + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (r0 < hw) {
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(r0) * kC + nt * 8) =
            __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
      }
      if (r1 < hw) {
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(r1) * kC + nt * 8) =
            __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wgt,
                   float* __restrict__ out, int batch, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [576][64], as it stands
  float* a_tile = ws + kK * kC;                // [128][68]

  for (int i = threadIdx.x; i < kK * kC / 4; i += kThreads) {
    reinterpret_cast<float4*>(ws)[i] = reinterpret_cast<const float4*>(wgt)[i];
  }

  // thread -> 8 pixel rows (rg + 16 i) x 4 output channels (4 cg .. 4 cg + 3)
  const int cg = threadIdx.x % 16, rg = threadIdx.x / 16;
  const int hw = h * w;
  const int tiles_per_image = (hw + kTileP - 1) / kTileP;
  const long long tiles = static_cast<long long>(batch) * tiles_per_image;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = static_cast<int>(tile / tiles_per_image);
    const int p0 = static_cast<int>(tile % tiles_per_image) * kTileP;
    const float* xb = x + static_cast<long long>(b) * hw * kC;

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int tap = 0; tap < kTaps; ++tap) {
      __syncthreads();
      stage_tap(xb, a_tile, kAStrideF, p0, h, w, tap / 3, tap % 3);
      __syncthreads();
      const float* wk = ws + tap * kC * kC + 4 * cg;
#pragma unroll 4
      for (int k = 0; k < kC; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(wk + k * kC);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = a_tile[(rg + 16 * i) * kAStrideF + k];
          acc[i][0] = fmaf(a, wv.x, acc[i][0]);
          acc[i][1] = fmaf(a, wv.y, acc[i][1]);
          acc[i][2] = fmaf(a, wv.z, acc[i][2]);
          acc[i][3] = fmaf(a, wv.w, acc[i][3]);
        }
      }
    }

    float* ob = out + static_cast<long long>(b) * hw * kC + 4 * cg;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = p0 + rg + 16 * i;
      if (r < hw) {
        *reinterpret_cast<float4*>(ob + static_cast<long long>(r) * kC) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
}

// Persistent grid: as many blocks as fit on the card at once, capped by the
// number of tiles.  Sets the dynamic shared memory limit (above 48 KB) first;
// a refused attribute or launch shows in the returned error.
template <typename T>
int launch(void (*kernel)(const T*, const T*, T*, int, int, int), int smem_bytes,
           const void* x, const void* w, void* out, int batch, int h, int width,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem_bytes)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long tiles = static_cast<long long>(batch) *
                          ((static_cast<long long>(h) * width + kTileP - 1) / kTileP);
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > tiles) blocks = tiles;
  if (blocks > 0) {
    kernel<<<static_cast<int>(blocks), kThreads, smem_bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
        batch, h, width);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int conv3x3_bf16_launch(const void* x, const void* w, void* out, int batch,
                        int h, int width, cudaStream_t stream) {
  return launch(conv3x3_bf16_kernel, kSmemBf16, x, w, out, batch, h, width, stream);
}

int conv3x3_f32_launch(const void* x, const void* w, void* out, int batch,
                       int h, int width, cudaStream_t stream) {
  return launch(conv3x3_f32_kernel, kSmemF32, x, w, out, batch, h, width, stream);
}

}  // extern "C"
