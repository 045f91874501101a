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
// Design: one input halo per tile, loaded once by TMA, shared by all nine taps.
// - A tile is a band of R whole output rows of one image, in padded-width
//   coordinates: output position q = yy*(W+2) + xx, yy < R, xx < W+2, up to
//   M = 256 positions.  Those with xx >= W or yy >= R are junk: computed and
//   never stored (at 56x56, R = 4: 232 of 256 positions are real).
// - The band's halo is input rows y0-1 .. y0+R, columns -1 .. W: (R+2)*(W+2)
//   rows of 64 channels, one 4-D TMA box over x as [C, W, H, B] starting at
//   (0, -1, y0-1, b).  TMA fills what lies outside the image with zeros, so
//   the border needs no masks and no padded copy of x is ever written (the
//   TPU wrapper writes one with jnp.pad).  Tap (dy, dx) of position q reads
//   halo row q + dy*(W+2) + dx: every tap's operand is the same buffer at a
//   constant row shift.  The buffer has rows up to the last one a junk
//   position reaches; rows past the box are never loaded, and only junk
//   positions read them.  Each input row is read from device memory about
//   once; the two halo rows a band shares with the next mostly hit L2.
// - Persistent blocks, one per SM (the grid from the occupancy query): one
//   thread of a producer warpgroup keeps the next bands' TMA loads in flight
//   on mbarriers (full/empty per ring stage) while two consumer warpgroups
//   compute.  The tile plan (R, the buffer's rows) comes from
//   kernels/conv3x3.py::tile_plan; the launcher owns the shared-memory
//   layout (Plan below) and refuses a plan whose buffers do not fit.
// - bf16, bound by bytes and flops alike: D[64 o x 256 p] = W^T * X^T, the
//   product transposed so that N is the band's 256 positions and one
//   wgmma.m64n256k16 (bf16 -> f32) does a k16 step of the whole band.  A is
//   the weight, loaded once per block into shared memory as nine K-major
//   [64 o][64 k] tiles in the 128-byte swizzle (73.7 KB); B is the halo as
//   TMA wrote it, 128-byte swizzled (64 bf16 channels are one 128-byte row),
//   read through a descriptor that starts at the tap's row shift.  Nothing
//   goes through registers on the way to the tensor cores, and a band's 36
//   wgmma are one commit group.  The two warpgroups take the block's bands
//   in turn (ping-pong), so that one's epilogue overlaps the other's
//   products; setmaxnreg moves the producer warpgroup's registers to their
//   128 accumulators.  The epilogue rounds to nearest even
//   (__floats2bfloat162_rn, as Tensor.to(torch.bfloat16) rounds the plain
//   float32 sum), transposes through stmatrix.trans into the band's own
//   halo stage, whose input is spent, and writes whole 128-byte rows of
//   real positions.  Three stages: 73.7 + 3 x 47 KB at 56x56.
// - float32, bound by FMA: exact FP32 FMA on the CUDA cores (never TF32; the
//   JAX float32 path is exact float32).  The whole weight (147 KB) and two
//   halo stages (2 x 94 KB) do not fit in 227 KB.  The weight is streamed
//   per tap (16 KB, from L2) through a ring of two stages by bulk copies:
//   a tap's FMAs (8 k cycles an SM) hide its copy, and the halo is read
//   once, where splitting the output channels over two blocks would read it
//   twice.  The halo arrives as two 32-channel TMA boxes, each 128-byte
//   swizzled, so that the four rows a warp reads at once hit four bank
//   groups.  Each of 256 threads holds 8 positions x 8 output channels (64
//   sums): per 4 channels one float4 of A per position and two float4 of W
//   per channel, 16 loads for 256 FMAs.  Each sum runs in k order, taps
//   outer and channels inner, one fmaf each from 0, as the plain version's
//   product does.
//
// The launchers take 16-byte-aligned contiguous tensors (the wrapper checks
// it), allocate nothing, do not synchronise, launch on the caller's stream
// and return a cudaError_t, or kPlanRefused (-1), before any launch, for a
// plan they do not take.  cuTensorMapEncodeTiled comes from the driver through the runtime,
// so the library needs no -lcuda.  A barrier wait that lasts more than 20 s
// traps, so that a wrong byte count fails the launch instead of hanging the
// card.  Build without --use_fast_math.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                 // input and output channels
constexpr int kTaps = 9;
constexpr int kConsumers = 256;        // two warpgroups
// and a producer warpgroup, of which one thread issues the loads; in bf16
// its four warps give their registers to the consumers (setmaxnreg)
constexpr int kThreads = kConsumers + 128;
constexpr int kSmemLimit = 232448;     // per block, sm_90
constexpr int kAlign = 1024;           // the 128-byte swizzle's period

constexpr int kBand = 256;             // positions per band (M), both types

// bf16: weight as nine 8 KB swizzled K-major tiles; a ring of three halo
// stages, each the band's output tile once its products are done
constexpr int kStagesB = 3;
constexpr int kWTileBytes = kC * kC * 2;              // 8192
constexpr int kWBytesB = kTaps * kWTileBytes;         // 73,728

// float32: two halo stages of two 32-channel halves; the weight per tap
constexpr int kStagesF = 2;
constexpr int kWStagesF = 2;
constexpr int kWTapBytesF = kC * kC * 4;              // 16,384

constexpr int kBarrierBytes = 128;

// what a launcher returns for a plan it does not take; no cudaError_t is < 0
constexpr int kPlanRefused = -1;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the barrier's phase differs from `parity`; traps after 20 s.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = globaltimer();
    if (start == 0) {
      start = now;
    } else if (now - start > 20000000000ull) {
      __trap();
    }
  }
}

// One 4-D TMA box of the tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A contiguous bulk copy (bytes a multiple of 16) into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Which band a tile is: image b, first output row y0.
struct Band {
  int b, y0;
};

__device__ __forceinline__ Band band_of(long long tile, int tiles_per_image, int rows) {
  Band t;
  t.b = static_cast<int>(tile / tiles_per_image);
  t.y0 = static_cast<int>(tile % tiles_per_image) * rows;
  return t;
}

// ---------------------------------------------------------------- bf16 ----

// A K-major wgmma operand in the 128-byte swizzle: rows of 128 bytes (64
// bf16 of k), 8-row groups 1024 bytes apart, base offset 0.  The swizzle is
// applied to the absolute shared address, as TMA wrote it into a
// 1024-aligned buffer, so a start at any row (a tap's halo row shift), or 32
// bytes on (the next k16 step), needs no correction; on the card a base
// offset of (start >> 7) & 7 gives wrong products for every shifted tap.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[64 o x 256 p] += A[64 o x 16 k] * B[16 k x 256 p], both from shared memory
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// Four 8x8 b16 matrices, each stored transposed: lane 8m + r gives the
// address of row r of matrix m, which receives column r of the fragment.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 lds_u4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// Synchronises the 128 threads of one warpgroup (barrier 0 is __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// consumers: the two warpgroups take the block's bands in turn (ping-pong),
// so that one's epilogue overlaps the other's products.  A band is
// D[64 o x 256 p] = W^T * X^T: the weight tiles are A, the halo rows at the
// tap's shift are B, both K-major in the 128-byte swizzle.  The block's
// n-th band is in stage n % 3.
__device__ __forceinline__ void consume_bf16(const unsigned char* wt,
                                             const unsigned char* halo, uint32_t full0,
                                             uint32_t empty0, uint32_t stage_bytes,
                                             __nv_bfloat16* __restrict__ out,
                                             long long tiles, int tiles_per_image,
                                             int rows, int h, int w) {
  const int wp = w + 2;
  const uint32_t halo0 = smem_u32(halo), wt0 = smem_u32(wt);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int mi = lane >> 3, mr = lane & 7;
  for (int n = wg;; n += 2) {
    const long long tile = blockIdx.x + static_cast<long long>(n) * gridDim.x;
    if (tile >= tiles) break;
    const Band t = band_of(tile, tiles_per_image, rows);
    const int s = n % kStagesB;
    const uint32_t hb = halo0 + s * stage_bytes;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    mbar_wait(full0 + 8 * s, (n / kStagesB) & 1);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const uint32_t brow = hb + static_cast<uint32_t>((tap / 3) * wp + tap % 3) * 128u;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_m64n256k16(acc, sw128_desc(wt0 + tap * kWTileBytes + ks * 32),
                         sw128_desc(brow + ks * 32));
      }
    }
    wgmma_commit();
    wgmma_wait_all();

    // D's rows o = 16 warp + g (+8) and columns p = 8j + 2tq (+1), as bf16
    // pairs, go through stmatrix.trans into the stage, now free: row p of
    // the output tile gets the 8 channels 16 warp + 8 half .. + 7 as one
    // swizzled 16-byte chunk
    warpgroup_sync(wg);  // every warp's products have read the halo
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int p = 8 * (j + (mi >> 1)) + mr, chunk = 2 * warp + (mi & 1);
      stmatrix_x4_trans(hb + p * 128 + ((chunk ^ (p & 7)) << 4),
                        pack_bf16(acc[4 * j], acc[4 * j + 1]),
                        pack_bf16(acc[4 * j + 2], acc[4 * j + 3]),
                        pack_bf16(acc[4 * j + 4], acc[4 * j + 5]),
                        pack_bf16(acc[4 * j + 6], acc[4 * j + 7]));
    }
    warpgroup_sync(wg);
    // 16-byte stores of the real positions; a warp writes four whole rows
#pragma unroll 4
    for (int it = 0; it < kBand * 8 / 128; ++it) {
      const int idx = it * 128 + tid, p = idx >> 3, c = idx & 7;
      const int yy = p / wp, xx = p - yy * wp;
      if (xx < w && yy < rows && t.y0 + yy < h) {
        *reinterpret_cast<uint4*>(
            out + ((static_cast<long long>(t.b) * h + t.y0 + yy) * w + xx) * kC + c * 8) =
            lds_u4(hb + p * 128 + ((c ^ (p & 7)) << 4));
      }
    }
    // the stage goes back to TMA (the async proxy) after generic accesses
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(empty0 + 8 * s);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __nv_bfloat16* __restrict__ wgt,
                    __nv_bfloat16* __restrict__ out, int batch, int h, int w,
                    int rows, int buf_rows) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~uintptr_t(kAlign - 1));
  // 9 x [64 o][64 k] weight tiles; the halo ring; the barriers
  unsigned char* wt = smem;
  unsigned char* halo = smem + kWBytesB;
  const uint32_t stage_bytes = static_cast<uint32_t>(buf_rows) * 128u;
  uint64_t* bars = reinterpret_cast<uint64_t*>(halo + kStagesB * stage_bytes);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStagesB);

  const int wp = w + 2;
  const int tiles_per_image = (h + rows - 1) / rows;
  const long long tiles = static_cast<long long>(batch) * tiles_per_image;
  const uint32_t halo_bytes = static_cast<uint32_t>((rows + 2) * wp) * 128u;
  const uint32_t halo0 = smem_u32(halo);

  if (threadIdx.x == kConsumers) {
    // the producer's barriers, and the first bands' loads, which need no
    // free stage, go out before the weight is staged
    for (int s = 0; s < kStagesB; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 2);  // the warpgroup of its band
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    long long tile = blockIdx.x;
    for (int s = 0; s < kStagesB && tile < tiles; ++s, tile += gridDim.x) {
      const Band t = band_of(tile, tiles_per_image, rows);
      mbar_expect_tx(full0 + 8 * s, halo_bytes);
      tma_load_4d(halo0 + s * stage_bytes, &xmap, full0 + 8 * s, 0, -1, t.y0 - 1, t.b);
    }
  }

  // the weight, transposed into K-major swizzled tiles: tile t, row o,
  // 16-byte chunk cc ^ (o % 8) holds channels 8 cc .. 8 cc + 7.  Thread u
  // builds chunk (t, cc, o) = (u / 512, u / 64 % 8, u % 64) from eight
  // 2-byte loads; a warp's loads are 64 contiguous bytes per channel.
  constexpr int kPer = kTaps * kC * kC / 8 / kThreads;
  static_assert(kPer * kThreads == kTaps * kC * kC / 8, "whole chunks per thread");
  {
    const unsigned short* w16 = reinterpret_cast<const unsigned short*>(wgt);
    uint4 v[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int u = threadIdx.x + r * kThreads, o = u % kC, k0 = (u / kC) * 8;
      uint32_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __ldg(w16 + (k0 + j) * kC + o);
      v[r] = make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,
                        e[6] | e[7] << 16);
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int u = threadIdx.x + r * kThreads, o = u % kC, t = u / 512, cc = u / kC % 8;
      *reinterpret_cast<uint4*>(wt + t * kWTileBytes + o * 128 + ((cc ^ (o & 7)) << 4)) = v[r];
    }
  }
  // the generic-proxy stores of the weight, seen by wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread keeps the ring's TMA loads in flight; the block's
    // n-th band goes to stage n % 3, and warpgroup n % 2 computes it.  Its
    // warpgroup gives up registers for the consumers' 128 accumulators each:
    // 128 x (168 - 40) = 2 x 128 x (232 - 168)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      int n = 0;
      for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
        if (n >= kStagesB) {  // the first kStagesB went out above
          const int s = n % kStagesB;
          const Band t = band_of(tile, tiles_per_image, rows);
          mbar_wait(empty0 + 8 * s, ((n / kStagesB) & 1) ^ 1);
          mbar_expect_tx(full0 + 8 * s, halo_bytes);
          tma_load_4d(halo0 + s * stage_bytes, &xmap, full0 + 8 * s, 0, -1, t.y0 - 1, t.b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume_bf16(wt, halo, full0, empty0, stage_bytes, out, tiles, tiles_per_image, rows,
                 h, w);
  }
}

// ------------------------------------------------------------- float32 ----

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_f32_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ wgt,
                   float* __restrict__ out, int batch, int h, int w, int rows,
                   int buf_rows) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~uintptr_t(kAlign - 1));
  // [stage][half][buf_rows][32 floats, swizzled]; then the weight ring
  const uint32_t half_bytes = static_cast<uint32_t>(buf_rows) * 128u;
  unsigned char* wring = smem + kStagesF * 2 * half_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(wring + kWStagesF * kWTapBytesF);
  const uint32_t hfull0 = smem_u32(bars), hempty0 = smem_u32(bars + kStagesF);
  const uint32_t wfull0 = smem_u32(bars + 2 * kStagesF);
  const uint32_t wempty0 = smem_u32(bars + 2 * kStagesF + kWStagesF);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesF; ++s) {
      mbar_init(hfull0 + 8 * s, 1);
      mbar_init(hempty0 + 8 * s, kConsumers);
    }
    for (int s = 0; s < kWStagesF; ++s) {
      mbar_init(wfull0 + 8 * s, 1);
      mbar_init(wempty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wp = w + 2;
  const int tiles_per_image = (h + rows - 1) / rows;
  const long long tiles = static_cast<long long>(batch) * tiles_per_image;
  const uint32_t halo_bytes = static_cast<uint32_t>((rows + 2) * wp) * 128u * 2u;
  const uint32_t halo0 = smem_u32(smem), wring0 = smem_u32(wring);

  if (threadIdx.x >= kConsumers) {
    // producer: the halo of each band (two 32-channel boxes) and the nine
    // taps' weights; the next band's halo goes out once this band's first
    // two taps are queued
    if (threadIdx.x == kConsumers) {
      int hs = 0, ws = 0;
      uint32_t hphase = 0, wphase = 0;
      auto load_halo = [&](long long tile) {
        const Band t = band_of(tile, tiles_per_image, rows);
        mbar_wait(hempty0 + 8 * hs, hphase ^ 1);
        mbar_expect_tx(hfull0 + 8 * hs, halo_bytes);
        const uint32_t dst = halo0 + hs * 2 * half_bytes;
        tma_load_4d(dst, &xmap, hfull0 + 8 * hs, 0, -1, t.y0 - 1, t.b);
        tma_load_4d(dst + half_bytes, &xmap, hfull0 + 8 * hs, 32, -1, t.y0 - 1, t.b);
        if (++hs == kStagesF) { hs = 0; hphase ^= 1; }
      };
      if (blockIdx.x < tiles) load_halo(blockIdx.x);
      for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int tap = 0; tap < kTaps; ++tap) {
          mbar_wait(wempty0 + 8 * ws, wphase ^ 1);
          mbar_expect_tx(wfull0 + 8 * ws, kWTapBytesF);
          bulk_load(wring0 + ws * kWTapBytesF, wgt + tap * kC * kC, kWTapBytesF,
                    wfull0 + 8 * ws);
          if (++ws == kWStagesF) { ws = 0; wphase ^= 1; }
          if (tap == 1 && tile + gridDim.x < tiles) load_halo(tile + gridDim.x);
        }
      }
    }
    return;
  }

  // consumers: thread -> positions pg + 32 i (i < 8), output channels
  // 4 cg + j and 32 + 4 cg + j (j < 4); the four rows a warp reads at once
  // are consecutive, so the swizzle puts them in four bank groups
  const int lane = threadIdx.x % 32, cg = lane & 7;
  const int pg = (threadIdx.x / 32) * 4 + (lane >> 3);
  int hs = 0, ws = 0;
  uint32_t hphase = 0, wphase = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Band t = band_of(tile, tiles_per_image, rows);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    mbar_wait(hfull0 + 8 * hs, hphase);
    const uint32_t hb = halo0 + hs * 2 * half_bytes;
    for (int tap = 0; tap < kTaps; ++tap) {
      const int off = (tap / 3) * wp + tap % 3;
      // row hr's chunk c sits at hb + 128 hr + ((c ^ (hr % 8)) << 4); with hb
      // 1024-aligned that is (hb + 128 hr + ((hr % 8) << 4)) ^ (c << 4)
      uint32_t rb[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int hr = pg + 32 * i + off;
        rb[i] = (hb + static_cast<uint32_t>(hr) * 128u) | ((hr & 7) << 4);
      }
      mbar_wait(wfull0 + 8 * ws, wphase);
      const uint32_t wk = wring0 + ws * kWTapBytesF + cg * 16;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int chunk = 0; chunk < 8; ++chunk) {
          float4 a[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            a[i] = lds128((rb[i] + half * half_bytes) ^ (chunk << 4));
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t wrow = wk + (half * 32 + chunk * 4 + c) * kC * 4;
            const float4 w0 = lds128(wrow), w1 = lds128(wrow + 128);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float av = comp(a[i], c);
              acc[i][0] = fmaf(av, w0.x, acc[i][0]);
              acc[i][1] = fmaf(av, w0.y, acc[i][1]);
              acc[i][2] = fmaf(av, w0.z, acc[i][2]);
              acc[i][3] = fmaf(av, w0.w, acc[i][3]);
              acc[i][4] = fmaf(av, w1.x, acc[i][4]);
              acc[i][5] = fmaf(av, w1.y, acc[i][5]);
              acc[i][6] = fmaf(av, w1.z, acc[i][6]);
              acc[i][7] = fmaf(av, w1.w, acc[i][7]);
            }
          }
        }
      }
      mbar_arrive(wempty0 + 8 * ws);
      if (++ws == kWStagesF) { ws = 0; wphase ^= 1; }
    }
    mbar_arrive(hempty0 + 8 * hs);
    if (++hs == kStagesF) { hs = 0; hphase ^= 1; }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = pg + 32 * i;
      const int yy = q / wp, xx = q - yy * wp;
      if (xx < w && yy < rows && t.y0 + yy < h) {
        float* o = out + ((static_cast<long long>(t.b) * h + t.y0 + yy) * w + xx) * kC + 4 * cg;
        *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(o + 32) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
  }
}

// ---------------------------------------------------------------- host ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so that the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess) {
      return nullptr;
    }
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

struct Plan {
  bool f32;
  int batch, h, w, rows, buf_rows;
  int smem_bytes() const {
    return kAlign + kBarrierBytes +
           (f32 ? kStagesF * 2 * buf_rows * 128 + kWStagesF * kWTapBytesF
                : kWBytesB + kStagesB * buf_rows * 128);
  }
  // tile_plan's geometry, and buffers that fit in a block's shared memory
  bool valid() const {
    const int wp = w + 2;
    if (batch < 1 || h < 1 || w < 1 || rows < 1 || rows > h) return false;
    if (rows * wp > kBand || wp > 256 || rows + 2 > 256) return false;
    if (buf_rows % 8 != 0 || buf_rows < kBand + 2 * wp + 2) return false;
    return smem_bytes() <= kSmemLimit;
  }
};

// blocks, threads, dynamic shared memory, band rows of the launch
cudaError_t grid_of(const Plan& p, const void* kernel, int (&cfg)[4]) {
  const int smem = p.smem_bytes();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                           smem)) != cudaSuccess) {
    return err;
  }
  const long long tiles =
      static_cast<long long>(p.batch) * ((p.h + p.rows - 1) / p.rows);
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > tiles) blocks = tiles;
  cfg[0] = static_cast<int>(blocks);
  cfg[1] = kThreads;
  cfg[2] = smem;
  cfg[3] = p.rows;
  return cudaSuccess;
}

// The tensor map of x as [C, W, H, B], innermost first; a box of
// [channels, W+2, R+2, 1], 128-byte swizzled, zeros outside the tensor.
cudaError_t encode_x(const Plan& p, const void* x, CUtensorMap* map) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint32_t es = p.f32 ? 4 : 2;
  const cuuint64_t dims[4] = {kC, static_cast<cuuint64_t>(p.w),
                              static_cast<cuuint64_t>(p.h),
                              static_cast<cuuint64_t>(p.batch)};
  const cuuint64_t strides[3] = {kC * es, static_cast<cuuint64_t>(p.w) * kC * es,
                                 static_cast<cuuint64_t>(p.h) * p.w * kC * es};
  const cuuint32_t box[4] = {128 / es, static_cast<cuuint32_t>(p.w + 2),
                             static_cast<cuuint32_t>(p.rows + 2), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, p.f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      const_cast<void*>(x), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
int launch(void (*kernel)(const CUtensorMap, const T*, T*, int, int, int, int, int),
           const Plan& p, const void* x, const void* w, void* out, cudaStream_t stream,
           int* config) {
  if (!p.valid()) return kPlanRefused;
  int cfg[4];
  cudaError_t err = grid_of(p, reinterpret_cast<const void*>(kernel), cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (config != nullptr) {
    for (int i = 0; i < 4; ++i) config[i] = cfg[i];
  }
  CUtensorMap map;
  if ((err = encode_x(p, x, &map)) != cudaSuccess) return static_cast<int>(err);
  kernel<<<cfg[0], cfg[1], cfg[2], stream>>>(map, static_cast<const T*>(w),
                                              static_cast<T*>(out), p.batch, p.h, p.w,
                                              p.rows, p.buf_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// config, if not null, receives {blocks, threads, dynamic shared bytes, R}
int conv3x3_bf16_launch(const void* x, const void* w, void* out, int batch, int h,
                        int width, int rows, int buf_rows, int* config,
                        cudaStream_t stream) {
  const Plan p{false, batch, h, width, rows, buf_rows};
  return launch(conv3x3_bf16_kernel, p, x, w, out, stream, config);
}

int conv3x3_f32_launch(const void* x, const void* w, void* out, int batch, int h,
                       int width, int rows, int buf_rows, int* config,
                       cudaStream_t stream) {
  const Plan p{true, batch, h, width, rows, buf_rows};
  return launch(conv3x3_f32_kernel, p, x, w, out, stream, config);
}

}  // extern "C"
