// Shifted-window attention of Swin's blocks, forward and input gradient, for
// bfloat16 activations, written for Hopper (sm_90a).
//
// It replaces no Pallas TPU kernel: the JAX package's Swin leaves its window
// attention to XLA.  In PyTorch the written-out attention
// (models/swin.py::WindowAttention._attend) rolls the map, partitions it into
// windows, splits the heads, runs a batched q k^T, a divide, a bias add, a
// softmax and a batched P v, merges the heads, reverses the partition and
// rolls back; in the forward and in autograd's mirror of it those copies,
// rolls and adds move several times the bytes of the attention itself.
//
// What a call computes (models/swin.py calls it through kernels/window_attn.py,
// with qkv = self.qkv(x) on the unpartitioned [B, H, W, C] map, channels
// packed (part, head, 32) as split_heads reads them):
//
//   forward   for each window (wy, wx) and head h, the window's tokens at their
//             unrolled positions ((wy*ws + i + s) mod H, (wx*ws + j + s) mod W):
//             S = q k^T / sqrt(32) + table[(di + ws-1)(2ws-1) + (dj + ws-1)]
//                 - 100 where the rolled coordinates fall in different seam
//                 regions (s > 0), in float32;
//             P = softmax(S) in float32, rounded to bf16; O = P v, written as
//             bf16 to the same positions of [B, H, W, C], heads packed as
//             merge_heads packs them.  The roll, the partition, the head split,
//             their reverses and the bias gather are all in the addressing.
//   backward  from qkv, the table and dO (the gradient of O, [B, H, W, C]):
//             S and P recomputed as above (a window's 49 keys fit one tile, so
//             there is no key loop and nothing saved from the forward),
//             dV = P^T dO, dP = dO v^T, dS = P (dP - rowsum(P dP)),
//             dQ = dS k / sqrt(32), dK = dS^T q / sqrt(32), written to dqkv
//             ([B, H, W, 3C]) at the same positions.  Each (window, head) owns
//             its outputs, and every element of dqkv is written once: no
//             atomics, no zeroing.  The table gets no gradient (the wrapper
//             sends a call whose table needs one to the written-out path).
//
// Bound: bytes.  About 24.5 flop a byte against ~295 on an H100, so the least
// time is the bytes over 3.35 TB/s: forward reads 3C and writes C bf16 per
// token (8C bytes), backward reads 3C + C and writes 3C (14C bytes).
//
// Design.  The kernels are templates of the window size (ws^2 tokens padded
// to 16-row tiles), so that every division by the window is by a constant and
// no product runs over a key tile that holds no token; only ws = 7, every Swin
// variant's window and the one the card tests check, is instantiated, and the
// launchers refuse every other window.  A block
// has one warp per 16 query rows (4 for ws = 7), keeps one head for its whole
// life and walks windows (a grid of the blocks that fit the card at once): it
// builds its head's bias, in log2 units and with -inf on padding keys, as a
// [rows, keys] matrix in shared memory once, and the seam masks of a thread's
// 32 score elements as bits in registers once, so that a score costs a shared
// load and a multiply-add.  For each window it copies the head's q, k, v (and
// dO) rows into shared memory with 16-byte cp.async loads at computed
// addresses (a wrap-around window is not one box), 64 contiguous bytes per
// token and part, each thread's token offsets computed once for all parts;
// it keeps two such buffers, so that the next window's loads are in flight
// while it computes the current one.  Padding rows are zeroed once and never
// written.  (Measured on an H100: the kernels are bound by issue and latency
// long before the bytes, and each of these steps took a share of it.)  Products
// are mma.sync m16n8k16 bf16 with float32 accumulators, fed by ldmatrix
// (.trans where the operand's k runs across rows); warp w owns query rows
// 16w..16w+15, so a row's softmax lives in the registers of one quad.  Tiles
// of 32 bf16 are stored at a stride of 40 (80 bytes) and of 64 at 72 (144
// bytes), so the 8 rows an ldmatrix reads fall on distinct banks.  The
// backward runs in two phases: by query rows (S, P, dP, dS, dQ; P and dS go to
// shared memory as bf16), then by key rows (dV = P^T dO, dK = dS^T q).
// Outputs are staged in shared memory and written back 16 bytes a thread.  A
// launcher returns kRefused for shapes it does not take, and
// cudaGetLastError() otherwise; none allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHeadDim = 32;
constexpr int kStride = kHeadDim + 8;  // [rows, 32] tiles: 80-byte rows
constexpr int kChunks = kHeadDim / 8;  // 16-byte chunks of a head's row
constexpr int kWindow = 7;             // the one instantiated window
constexpr int kDevices = 64;           // cards whose grids a launcher keeps
constexpr int kRefused = -1;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMask = -100.0f;

// Sizes of a window of kWs x kWs tokens.
template <int kWs>
struct Shape {
  static constexpr int kTokens = kWs * kWs;
  static constexpr int kWarps = (kTokens + 15) / 16;  // 16-row tiles
  static constexpr int kRows = 16 * kWarps;           // padded rows, and keys
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSteps = kWarps;                // 16-key steps of P v
  static constexpr int kKeyTiles = (kTokens + 7) / 8;  // 8-key tiles with a token
  static constexpr int kPStride = kRows + 8;           // [rows, keys] bf16 tiles
  // float bias rows 8 or 24 (mod 32) words apart: a quad-row load is
  // conflict-free
  static constexpr int kBiasCols = 8 * kKeyTiles;
  static constexpr int kBiasStride = kBiasCols % 16 == 8 ? kBiasCols : kBiasCols + 8;
};

struct Geometry {
  int height, width, channels, heads, shift;
};

// One window's rows of a head's q, k, v (and dO).  A block keeps two, so that
// the next window's loads are in flight while it computes the current one.
template <int kWs>
struct alignas(16) ForwardTiles {
  bf16 q[Shape<kWs>::kRows][kStride];  // a warp's rows of O overwrite its own rows of q
  bf16 k[Shape<kWs>::kRows][kStride];
  bf16 v[Shape<kWs>::kRows][kStride];
};

template <int kWs>
struct alignas(16) BackwardTiles {
  bf16 q[Shape<kWs>::kRows][kStride];
  bf16 k[Shape<kWs>::kRows][kStride];     // dK once phase 2 is done
  bf16 v[Shape<kWs>::kRows][kStride];     // dQ once phase 1 is done
  bf16 dout[Shape<kWs>::kRows][kStride];  // dV once phase 2 is done
};

template <int kWs>
struct alignas(16) ForwardSmem {
  using S = Shape<kWs>;
  ForwardTiles<kWs> buf[2];
  float bias[S::kRows][S::kBiasStride];  // the block's head's bias, log2 units
};

template <int kWs>
struct alignas(16) BackwardSmem {
  using S = Shape<kWs>;
  BackwardTiles<kWs> buf[2];
  bf16 p[S::kRows][S::kPStride];  // P and dS as bf16, rows by query
  bf16 ds[S::kRows][S::kPStride];
  float bias[S::kRows][S::kBiasStride];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most `pending` committed groups of this thread are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b: a 16x16 row-major (4 registers), b 16x8 column-major (2), float32 d
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two float32 rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A block's head, and the windows it walks: w0, w0 + stride, ...  The grid
// is a multiple of the heads.
struct Walk {
  int h, w0, stride;
};

__device__ __forceinline__ Walk walk_of(const Geometry& g) {
  return Walk{static_cast<int>(blockIdx.x) % g.heads, static_cast<int>(blockIdx.x) / g.heads,
              static_cast<int>(gridDim.x) / g.heads};
}

// One window (images, then rows of windows, then windows along a row), and
// whether it lies on the seams of a shifted block.
struct Window {
  int b, wy, wx;
  bool last_row, last_col;
};

template <int kWs>
__device__ __forceinline__ Window window_of(const Geometry& g, int w) {
  const unsigned nwx = g.width / kWs, nwy = g.height / kWs;
  const unsigned row = static_cast<unsigned>(w) / nwx;
  Window win;
  win.wx = static_cast<int>(w - row * nwx);
  win.b = static_cast<int>(row / nwy);
  win.wy = static_cast<int>(row - win.b * nwy);
  win.last_row = g.shift > 0 && win.wy == static_cast<int>(nwy) - 1;
  win.last_col = g.shift > 0 && win.wx == static_cast<int>(nwx) - 1;
  return win;
}

// Index in the [B, H, W] map (< 2^31) of the window's token t: its unrolled
// position.
template <int kWs>
__device__ __forceinline__ int token_index(const Geometry& g, const Window& win, int t) {
  const int i = t / kWs, j = t % kWs;
  int y = win.wy * kWs + i + g.shift, x = win.wx * kWs + j + g.shift;
  y -= y >= g.height ? g.height : 0;
  x -= x >= g.width ? g.width : 0;
  return (win.b * g.height + y) * g.width + x;
}

// The head's bias as [query row, key] in log2 units: -inf on padding keys, 0
// on padding rows.  Read after the next __syncthreads.
template <int kWs>
__device__ __forceinline__ void fill_bias(float (*bias)[Shape<kWs>::kBiasStride],
                                          const bf16* __restrict__ table, int heads, int h) {
  using S = Shape<kWs>;
  for (int e = threadIdx.x; e < S::kRows * S::kBiasCols; e += S::kThreads) {
    const int r = e / S::kBiasCols, c = e % S::kBiasCols;
    float v = 0.0f;
    if (c >= S::kTokens) {
      v = -INFINITY;
    } else if (r < S::kTokens) {
      const int rel =
          (r / kWs - c / kWs + kWs - 1) * (2 * kWs - 1) + (r % kWs - c % kWs + kWs - 1);
      v = __bfloat162float(table[rel * heads + h]) * kLog2e;
    }
    bias[r][c] = v;
  }
}

// Zeroes rows [tokens, rows) of a [rows, 32] tile: padding rows are never
// written after this.
template <int kWs>
__device__ __forceinline__ void zero_padding(bf16 (*tile)[kStride]) {
  using S = Shape<kWs>;
  for (int idx = S::kTokens * kChunks + threadIdx.x; idx < S::kRows * kChunks;
       idx += S::kThreads) {
    *reinterpret_cast<uint4*>(&tile[idx / kChunks][(idx % kChunks) * 8]) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// Where a window's token rows come from or go to: tile p holds the head's 32
// channels at column col[p] of map p, whose tokens are elems[p] bf16 apart.
template <int kParts>
struct Parts {
  bf16* map[kParts];
  bf16 (*tile[kParts])[kStride];
  long long elems[kParts], col[kParts];
};

// A thread's 16-byte chunks of a window's token rows: chunk idx = threadIdx.x
// + s * threads is chunk idx % 4 of token idx / 4 (consecutive threads take
// consecutive chunks), the same for every part; token[s] is the token's
// index in the map, or -1 past the window's tokens.
template <int kWs>
struct Slots {
  static constexpr int kSlots =
      (Shape<kWs>::kTokens * kChunks + Shape<kWs>::kThreads - 1) / Shape<kWs>::kThreads;
  int token[kSlots];

  __device__ __forceinline__ Slots(const Geometry& g, const Window& win) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int idx = threadIdx.x + s * Shape<kWs>::kThreads;
      token[s] = idx < Shape<kWs>::kTokens * kChunks ? token_index<kWs>(g, win, idx / kChunks)
                                                     : -1;
    }
  }
};

// The window's rows of each part's tile <- its map, 16 bytes a cp.async.
template <int kWs, int kParts>
__device__ __forceinline__ void load_window(const Parts<kParts>& parts, const Slots<kWs>& slots) {
#pragma unroll
  for (int part = 0; part < kParts; ++part) {
#pragma unroll
    for (int s = 0; s < Slots<kWs>::kSlots; ++s) {
      const int idx = threadIdx.x + s * Shape<kWs>::kThreads;
      if (slots.token[s] >= 0) {
        cp_async16(&parts.tile[part][idx / kChunks][(idx % kChunks) * 8],
                   parts.map[part] + slots.token[s] * parts.elems[part] + parts.col[part] +
                       (idx % kChunks) * 8);
      }
    }
  }
}

// Each part's map <- the window's rows of its tile, 16 bytes a store.
template <int kWs, int kParts>
__device__ __forceinline__ void store_window(const Parts<kParts>& parts,
                                             const Slots<kWs>& slots) {
#pragma unroll
  for (int part = 0; part < kParts; ++part) {
#pragma unroll
    for (int s = 0; s < Slots<kWs>::kSlots; ++s) {
      const int idx = threadIdx.x + s * Shape<kWs>::kThreads;
      if (slots.token[s] >= 0) {
        *reinterpret_cast<uint4*>(parts.map[part] + slots.token[s] * parts.elems[part] +
                                  parts.col[part] + (idx % kChunks) * 8) =
            *reinterpret_cast<const uint4*>(
                &parts.tile[part][idx / kChunks][(idx % kChunks) * 8]);
      }
    }
  }
}

// A fragments (16 rows from row0, k = 0..31 in two steps) of a [rows, 32] tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const bf16 (*tile)[kStride],
                                       int row0, int lane) {
  const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    ldmatrix_x4(a[ks], &tile[row0 + r8 + (mi & 1) * 8][ks * 16 + (mi >> 1) * 8]);
  }
}

// acc[n] (keys 8n..8n+7) = A (16 x 32) B^T, B's rows taken from a [rows, 32]
// tile: q k^T and dO v^T.  Key tiles that hold no token are 0.
template <int kWs>
__device__ __forceinline__ void product_nt(float (&acc)[2 * Shape<kWs>::kSteps][4],
                                           const uint32_t (&a)[2][4],
                                           const bf16 (*tile)[kStride], int lane) {
  const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int n = 0; n < 2 * Shape<kWs>::kSteps; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    if (n < Shape<kWs>::kKeyTiles) {
      uint32_t b[4];
      ldmatrix_x4(b, &tile[n * 8 + r8][mi * 8]);
      mma(acc[n], a[0], b[0], b[1]);
      mma(acc[n], a[1], b[2], b[3]);
    }
  }
}

// The A fragment of k-step kk (columns 16kk..16kk+15) from accumulators.
template <int kN>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&acc)[kN][4], int kk) {
  a[0] = pack(acc[2 * kk][0], acc[2 * kk][1]);
  a[1] = pack(acc[2 * kk][2], acc[2 * kk][3]);
  a[2] = pack(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  a[3] = pack(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

// out[n] (hd 8n..) += A (16 x 16, k-step kk) B with B = rows 16kk.. of a
// [rows, 32] tile taken as [k, n] (ldmatrix .trans): P v, dS k, P^T dO, dS^T q.
__device__ __forceinline__ void product_nn_step(float (&out)[4][4], const uint32_t (&a)[4],
                                                const bf16 (*tile)[kStride], int kk, int lane) {
  const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, &tile[kk * 16 + r8 + (mi & 1) * 8][np * 16 + (mi >> 1) * 8]);
    mma(out[2 * np], a, b[0], b[1]);
    mma(out[2 * np + 1], a, b[2], b[3]);
  }
}

// A thread's seam masks: bit 4n + 2r + j is set where its query row
// row0 + lane/4 + 8r and key 8n + 2(lane%4) + j lie on different sides of a
// seam in y (dy) or in x (dx): ws - shift tokens into a window of the last
// row (column) of windows, where the rolled map's regions meet.
template <int kWs>
struct Seams {
  uint32_t dy = 0, dx = 0;

  __device__ __forceinline__ Seams(int shift, int row0, int lane) {
    if (shift == 0) return;
    const int cut = kWs - shift;
#pragma unroll
    for (int n = 0; n < Shape<kWs>::kKeyTiles; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int q = row0 + (lane >> 2) + 8 * r, k = n * 8 + 2 * (lane & 3) + j;
          const uint32_t bit = 1u << (4 * n + 2 * r + j);
          if ((q / kWs < cut) != (k / kWs < cut)) dy |= bit;
          if ((q % kWs < cut) != (k % kWs < cut)) dx |= bit;
        }
      }
    }
  }

  __device__ __forceinline__ uint32_t of(const Window& win) const {
    return (win.last_row ? dy : 0u) | (win.last_col ? dx : 0u);
  }
};

// P (float32, normalized) of the warp's 16 query rows from row0, in the
// accumulator layout: p[n][0..1] row row0 + lane/4, keys 8n + 2(lane%4) +
// {0, 1}; p[n][2..3] eight rows below.  Keys past the window's tokens are 0.
template <int kWs>
__device__ __forceinline__ void probabilities(float (&p)[2 * Shape<kWs>::kSteps][4],
                                              const bf16 (*q)[kStride],
                                              const bf16 (*k)[kStride],
                                              const float (*bias)[Shape<kWs>::kBiasStride],
                                              uint32_t mask, int row0, int lane) {
  constexpr int kN = 2 * Shape<kWs>::kSteps, kT = Shape<kWs>::kKeyTiles;
  uint32_t qa[2][4];
  load_a(qa, q, row0, lane);
  product_nt<kWs>(p, qa, k, lane);
  // scores in log2 units, so that exp2f takes them as they are
  const float scale = rsqrtf(static_cast<float>(kHeadDim)) * kLog2e;
  const float* rows[2] = {bias[row0 + (lane >> 2)] + 2 * (lane & 3),
                          bias[row0 + (lane >> 2) + 8] + 2 * (lane & 3)};
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kT; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 b = *reinterpret_cast<const float2*>(rows[r] + 8 * n);
      float s0 = p[n][2 * r] * scale + b.x, s1 = p[n][2 * r + 1] * scale + b.y;
      if (mask & (1u << (4 * n + 2 * r))) s0 += kMask * kLog2e;
      if (mask & (2u << (4 * n + 2 * r))) s1 += kMask * kLog2e;
      p[n][2 * r] = s0;
      p[n][2 * r + 1] = s1;
      mx[r] = fmaxf(mx[r], fmaxf(s0, s1));
    }
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int n = 0; n < kT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[n][e] = exp2f(p[n][e] - mx[e >> 1]);
      sum[e >> 1] += p[n][e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    sum[r] = 1.0f / sum[r];
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) p[n][e] = n < kT ? p[n][e] * sum[e >> 1] : 0.0f;
  }
}

// Accumulators of a 16 x 32 product -> rows row0.. of a [rows, 32] tile, bf16,
// times `scale`; padding rows are left as they are (0).
template <int kWs>
__device__ __forceinline__ void acc_to_tile(bf16 (*tile)[kStride], const float (&acc)[4][4],
                                            float scale, int row0, int lane) {
  const int r = row0 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (r < Shape<kWs>::kTokens) {
      *reinterpret_cast<uint32_t*>(&tile[r][n * 8 + c]) =
          pack(acc[n][0] * scale, acc[n][1] * scale);
    }
    if (r + 8 < Shape<kWs>::kTokens) {
      *reinterpret_cast<uint32_t*>(&tile[r + 8][n * 8 + c]) =
          pack(acc[n][2] * scale, acc[n][3] * scale);
    }
  }
}

template <int kWs>
__global__ void __launch_bounds__(Shape<kWs>::kThreads) window_attn_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ table, bf16* __restrict__ out,
    Geometry g, int windows) {
  using S = Shape<kWs>;
  __shared__ ForwardSmem<kWs> sm;
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 16;
  const Walk walk = walk_of(g);
  if (walk.w0 >= windows) return;
  fill_bias<kWs>(sm.bias, table, g.heads, walk.h);
  for (ForwardTiles<kWs>& b : sm.buf) {
    zero_padding<kWs>(b.q);
    zero_padding<kWs>(b.k);
    zero_padding<kWs>(b.v);
  }
  const Seams<kWs> seams(g.shift, row0, lane);
  const long long c3 = 3LL * g.channels, col = static_cast<long long>(walk.h) * kHeadDim;
  bf16* map = const_cast<bf16*>(qkv);  // read only
  auto in = [&](ForwardTiles<kWs>& b) {
    return Parts<3>{{map, map, map}, {b.q, b.k, b.v}, {c3, c3, c3},
                    {col, g.channels + col, 2LL * g.channels + col}};
  };
  Window next = window_of<kWs>(g, walk.w0);
  Slots<kWs> next_slots(g, next);
  load_window<kWs>(in(sm.buf[0]), next_slots);
  cp_async_commit();
  for (int w = walk.w0, cur = 0; w < windows; w += walk.stride, cur ^= 1) {
    const Window win = next;
    const Slots<kWs> slots = next_slots;
    ForwardTiles<kWs>& b = sm.buf[cur];
    if (w + walk.stride < windows) {
      next = window_of<kWs>(g, w + walk.stride);
      next_slots = Slots<kWs>(g, next);
      load_window<kWs>(in(sm.buf[cur ^ 1]), next_slots);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float p[2 * S::kSteps][4];
    probabilities<kWs>(p, b.q, b.k, sm.bias, seams.of(win), row0, lane);
    float o[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < S::kSteps; ++kk) {
      uint32_t a[4];
      acc_to_a(a, p, kk);
      product_nn_step(o, a, b.v, kk, lane);
    }
    __syncwarp();
    acc_to_tile<kWs>(b.q, o, 1.0f, row0, lane);  // only this warp reads these rows of q
    __syncthreads();
    store_window<kWs>(Parts<1>{{out}, {b.q}, {g.channels}, {col}}, slots);  // O in q's rows
    __syncthreads();  // b is free for the window after next
  }
}

template <int kWs>
__global__ void __launch_bounds__(Shape<kWs>::kThreads) window_attn_backward_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ table,
    const bf16* __restrict__ grad_out, bf16* __restrict__ grad_qkv, Geometry g, int windows) {
  using S = Shape<kWs>;
  constexpr int kN = 2 * S::kSteps;
  extern __shared__ __align__(16) unsigned char smem[];
  BackwardSmem<kWs>& sm = *reinterpret_cast<BackwardSmem<kWs>*>(smem);
  const int lane = threadIdx.x & 31, w16 = (threadIdx.x >> 5) * 16;
  const int gr = lane >> 2, tq = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const float scale = rsqrtf(static_cast<float>(kHeadDim));
  const Walk walk = walk_of(g);
  if (walk.w0 >= windows) return;
  fill_bias<kWs>(sm.bias, table, g.heads, walk.h);
  for (BackwardTiles<kWs>& b : sm.buf) {
    zero_padding<kWs>(b.q);
    zero_padding<kWs>(b.k);
    zero_padding<kWs>(b.v);
    zero_padding<kWs>(b.dout);
  }
  const Seams<kWs> seams(g.shift, w16, lane);
  const long long c3 = 3LL * g.channels, col = static_cast<long long>(walk.h) * kHeadDim;
  bf16* map = const_cast<bf16*>(qkv);  // read only
  bf16* grad = const_cast<bf16*>(grad_out);
  auto in = [&](BackwardTiles<kWs>& b) {
    return Parts<4>{{map, map, map, grad}, {b.q, b.k, b.v, b.dout}, {c3, c3, c3, g.channels},
                    {col, g.channels + col, 2LL * g.channels + col, col}};
  };
  Window next = window_of<kWs>(g, walk.w0);
  Slots<kWs> next_slots(g, next);
  load_window<kWs>(in(sm.buf[0]), next_slots);
  cp_async_commit();
  for (int w = walk.w0, cur = 0; w < windows; w += walk.stride, cur ^= 1) {
    const Window win = next;
    const Slots<kWs> slots = next_slots;
    BackwardTiles<kWs>& b = sm.buf[cur];
    if (w + walk.stride < windows) {
      next = window_of<kWs>(g, w + walk.stride);
      next_slots = Slots<kWs>(g, next);
      load_window<kWs>(in(sm.buf[cur ^ 1]), next_slots);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // phase 1, by query rows w16..w16+15: P, dP = dO v^T, dS, dQ = dS k
    float dq[4][4] = {};
    {
      float p[kN][4], dp[kN][4];
      probabilities<kWs>(p, b.q, b.k, sm.bias, seams.of(win), w16, lane);
      uint32_t da[2][4];
      load_a(da, b.dout, w16, lane);
      product_nt<kWs>(dp, da, b.v, lane);
      float d[2] = {0.0f, 0.0f};
#pragma unroll
      for (int n = 0; n < kN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e >> 1] += p[n][e] * dp[n][e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        d[r] += __shfl_xor_sync(0xffffffffu, d[r], 1);
        d[r] += __shfl_xor_sync(0xffffffffu, d[r], 2);
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[n][e] = p[n][e] * (dp[n][e] - d[e >> 1]);  // dS
      }
      // P and dS to shared memory, padding rows as 0 (phase 2 sums over rows)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = w16 + gr + half * 8;
        const bool valid = row < S::kTokens;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const int cc = n * 8 + 2 * tq;
          *reinterpret_cast<uint32_t*>(&sm.p[row][cc]) =
              valid ? pack(p[n][2 * half], p[n][2 * half + 1]) : 0u;
          *reinterpret_cast<uint32_t*>(&sm.ds[row][cc]) =
              valid ? pack(dp[n][2 * half], dp[n][2 * half + 1]) : 0u;
        }
      }
#pragma unroll
      for (int kk = 0; kk < S::kSteps; ++kk) {
        uint32_t a[4];
        acc_to_a(a, dp, kk);
        product_nn_step(dq, a, b.k, kk, lane);
      }
    }
    __syncthreads();  // P and dS complete; v free
    acc_to_tile<kWs>(b.v, dq, scale, w16, lane);

    // phase 2, by key rows w16..w16+15: dV = P^T dO, dK = dS^T q
    float dv[4][4] = {}, dk[4][4] = {};
#pragma unroll
    for (int kq = 0; kq < S::kSteps; ++kq) {
      uint32_t pa[4], sa[4];
      ldmatrix_x4_trans(pa, &sm.p[kq * 16 + r8 + (mi >> 1) * 8][w16 + (mi & 1) * 8]);
      ldmatrix_x4_trans(sa, &sm.ds[kq * 16 + r8 + (mi >> 1) * 8][w16 + (mi & 1) * 8]);
      product_nn_step(dv, pa, b.dout, kq, lane);
      product_nn_step(dk, sa, b.q, kq, lane);
    }
    __syncthreads();  // every warp is done with dO, q, P and dS
    acc_to_tile<kWs>(b.k, dk, scale, w16, lane);
    acc_to_tile<kWs>(b.dout, dv, 1.0f, w16, lane);
    __syncthreads();
    // dQ, dK and dV are in the tiles of v, k and dO
    store_window<kWs>(Parts<3>{{grad_qkv, grad_qkv, grad_qkv}, {b.v, b.k, b.dout}, {c3, c3, c3},
                               {col, g.channels + col, 2LL * g.channels + col}},
                      slots);
    __syncthreads();  // b is free for the window after next
  }
}

// The windows of a call (every window holds each head), 0 where the kernels
// do not take its shape (or it has 2^31 (token, head) pairs or more), or -1
// where it has none.
long long windows_of(int batch, int window, const Geometry& g) {
  if (batch < 0 || g.heads < 1 || g.channels != g.heads * kHeadDim) return 0;
  if (window != kWindow) return 0;
  if (g.height < window || g.width < window) return 0;
  if (g.height % window || g.width % window) return 0;
  if (g.shift < 0 || g.shift >= window) return 0;
  const long long tokens = static_cast<long long>(batch) * g.height * g.width;
  if (tokens * g.heads > 0x7fffffffLL) return 0;
  const long long windows = tokens / (window * window);
  return windows == 0 ? -1 : windows;
}

// The grid: a multiple of the heads, no more blocks than fit the card at once
// (so none waits for a slot and starts late) unless the heads are more, and at
// most one a (window, head).  `resident` keeps the
// blocks a card holds, read once per card after raising the kernel's dynamic
// shared memory limit; 0 where the runtime refuses.
template <typename Kernel>
long long grid_of(Kernel kernel, long long (&resident)[kDevices], int threads, int smem,
                  long long windows, int heads) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kDevices) return 0;
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    if (smem > 48 * 1024 &&
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
            cudaSuccess) {
      return 0;
    }
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
            cudaSuccess) {
      return 0;
    }
    resident[device] = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  }
  long long per_head = resident[device] / heads;
  if (per_head < 1) per_head = 1;
  if (per_head > windows) per_head = windows;
  return per_head * heads;
}

template <int kWs>
int forward(const void* qkv, const void* table, void* out, const Geometry& g, long long windows,
            cudaStream_t stream) {
  static long long resident[kDevices] = {};
  const int threads = Shape<kWs>::kThreads;
  const long long grid = grid_of(window_attn_kernel<kWs>, resident, threads, 0, windows,
                                 g.heads);
  if (grid > 0) {
    window_attn_kernel<kWs><<<static_cast<unsigned>(grid), threads, 0, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(table), static_cast<bf16*>(out),
        g, static_cast<int>(windows));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kWs>
int backward(const void* qkv, const void* table, const void* grad_out, void* grad_qkv,
             const Geometry& g, long long windows, cudaStream_t stream) {
  static long long resident[kDevices] = {};
  const int threads = Shape<kWs>::kThreads, smem = sizeof(BackwardSmem<kWs>);
  const long long grid = grid_of(window_attn_backward_kernel<kWs>, resident, threads, smem,
                                 windows, g.heads);
  if (grid > 0) {
    window_attn_backward_kernel<kWs><<<static_cast<unsigned>(grid), threads, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(table),
        static_cast<const bf16*>(grad_out), static_cast<bf16*>(grad_qkv), g,
        static_cast<int>(windows));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qkv [B, H, W, 3C] and the table [(2ws-1)^2, heads] in, out [B, H, W, C];
// all bf16 and contiguous, C = 32 * heads
int window_attn_forward_launch(const void* qkv, const void* table, void* out, int batch,
                               int height, int width, int channels, int heads, int window,
                               int shift, cudaStream_t stream) {
  const Geometry g{height, width, channels, heads, shift};
  const long long windows = windows_of(batch, window, g);
  if (windows == 0) return kRefused;
  if (windows < 0) return static_cast<int>(cudaGetLastError());
  return forward<kWindow>(qkv, table, out, g, windows, stream);
}

// qkv, the table and grad_out [B, H, W, C] in, grad_qkv [B, H, W, 3C] out
int window_attn_backward_launch(const void* qkv, const void* table, const void* grad_out,
                                void* grad_qkv, int batch, int height, int width, int channels,
                                int heads, int window, int shift, cudaStream_t stream) {
  const Geometry g{height, width, channels, heads, shift};
  const long long windows = windows_of(batch, window, g);
  if (windows == 0) return kRefused;
  if (windows < 0) return static_cast<int>(cudaGetLastError());
  return backward<kWindow>(qkv, table, grad_out, grad_qkv, g, windows, stream);
}

}  // extern "C"
