// Fused UNet-Xception down block for Hopper (sm_90a), plain C interface.
//
// Replaces: tmat_tpu/ops/pallas_unet.py::_down_block_kernel (the Pallas
// TPU kernel). Per image it computes
//
//   h = first ? x : relu(x)
//   t = bf(relu(bf(dw3x3(h, dw1)) @ w1 + b1))     dw3x3: SAME, zero pad
//   u = bf(dw3x3(t, dw2)) @ w2 + b2                (f32)
//   y = maxpool3x3/s2 TF-SAME(u)                   (pad (0,1) with -inf)
//   out = bf(y + (x[::2, ::2] @ wr + br))
//
// where bf() rounds to the storage type (bf16 in production, identity for
// f32), every product accumulates in f32, and the rounding points are the
// Pallas kernel's. x is NHWC; dw1 (9,C), dw2 (9,F), w1 (C,F), w2 (F,F),
// wr (C,F) in the storage type; b1, b2, br (F,) f32; out (B,H/2,W/2,F).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense on the tensor cores,
// 67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s): a production block does
// ~1.4 GFLOP per image against ~1.2-4.9 MB of HBM traffic. Blocks 2 and 3
// are bound by the products (pw1, pw2, residual) on the tensor cores;
// block 1 sits on the ridge, bound by its bytes by 3%, with its depthwise
// taps at the f32 rate taking about as long as its products.
//
// Design. The Pallas kernel keeps a whole 160x160x64 image (a ~40 MB live
// set) in VMEM; a Hopper block has at most 227 KB of shared memory, so
// this kernel tiles space. One CTA computes a TxT tile of pooled output
// for one image. That tile needs u on rows/cols [2i0, 2i0+2T] (2T+1),
// t on [2i0-1, 2i0+2T+1] (2T+3) and x on [2i0-2, 2i0+2T+2] (2T+5): the
// halo is recomputed by neighbouring CTAs. Outside the image t is 0 (dw2's
// SAME padding reads zeros, not relu(b1)), and the pool reads -inf only at
// the bottom/right pad.
//
// The file holds two forms of the kernel, chosen by pick_config from the
// shape, the type and the alignment of the tensors alone:
//
// The warpgroup form (namespace wg, below) takes the bf16 blocks whose C is
// a multiple of 64 and F of 128 and whose tensors start on 16 bytes: the
// production blocks. Its products are wgmma instructions fed from swizzled
// shared memory, its weights arrive by TMA through a ring while products
// run, its epilogues work on the accumulator registers, and its depthwise
// passes keep a 3x3 window in registers. Its own comment says how.
//
// The general form (first in the file) takes everything else: float32
// (FMA loops; it exists to hold the kernel against its plain version
// exactly), odd widths, unaligned bases, and blocks too wide for the
// warpgroup form's shared memory.
//
//   phase 1a: the x tile (zero outside the image) is copied into shared
//             memory with 16-byte loads, then xdw = bf(dw1(h)) is computed
//             for the whole t tile and all C channels, once, with each
//             thread's dw1 taps held in registers.
//   phase 1b: per 32-channel chunk of F: the w1 chunk is staged, the pw1
//             product xdw @ w1_chunk lands in an f32 t chunk, each warp
//             applies bias, relu and rounding to its own rows, and dw2 of
//             the chunk goes into d2, which holds all F channels of the u
//             tile (it reuses the x tile's space).
//   phase 2:  per 32-channel chunk of F: the w2 and wr chunks are staged,
//             u_chunk = d2 @ w2_chunk + b2 and the residual chunk
//             x[::2, ::2] @ wr_chunk (both f32, the x samples staged once
//             in the space xdw held), then the pool and the sum.
//
// A CTA of the general form is 16 warps. Each warp computes 16x16 output
// tiles of the three products: with wmma (bf16 in, f32 accumulate) for bf16,
// with FMA loops for f32. bf16 operands sit at a leading dimension padded by
// 16 bytes, so the fragment loads do not collide on shared-memory banks. The
// depthwise taps and the pool run on the CUDA cores. T is 8, 4 or 2: the
// largest whose shared memory fits; a block too wide for its x tile to fit
// beside the rest (C=512, F=1024 in bf16) reads x from global memory
// instead.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>
#include <initializer_list>

// Cycle counts per phase for tools/down_block_probe.py, which builds this
// file with -DTMAT_DOWN_BLOCK_PROBE: thread 0 of each CTA adds the cycles
// since its previous mark to a phase's counter. Empty in the library.
#ifdef TMAT_DOWN_BLOCK_PROBE
__device__ unsigned long long tmat_phase_cycles[8];
#define PHASE_START long long phase_t0_ = clock64()
#define PHASE_MARK(k)                                                          \
  do {                                                                         \
    if (threadIdx.x == 0) {                                                    \
      const long long now_ = clock64();                                        \
      atomicAdd(&tmat_phase_cycles[(k)], (unsigned long long)(now_ - phase_t0_)); \
      phase_t0_ = now_;                                                        \
    }                                                                          \
  } while (0)
#else
#define PHASE_START
#define PHASE_MARK(k)
#endif
// With -DTMAT_DOWN_BLOCK_STEP_PROBE as well, the counters hold the parts of a
// weight-tile step of the warpgroup form instead (the phase marks then only
// restart the clock): thread 0's wait for the tile, its launch of the
// products, its wait for the products of the tile before, the barrier, its
// request for the next tile, and what lies between steps; counter 6 counts
// the steps.
#if defined(TMAT_DOWN_BLOCK_PROBE) && defined(TMAT_DOWN_BLOCK_STEP_PROBE)
#undef PHASE_MARK
#define PHASE_MARK(k)                              \
  do {                                             \
    if (threadIdx.x == 0) phase_t0_ = clock64();   \
  } while (0)
#define STEP_MARK(k)                                                              \
  do {                                                                            \
    if (threadIdx.x == 0) {                                                       \
      const long long now_ = clock64();                                           \
      atomicAdd(&tmat_phase_cycles[(k)], (unsigned long long)(now_ - phase_t0_)); \
      phase_t0_ = now_;                                                           \
    }                                                                             \
  } while (0)
#define STEP_COUNT(k)                                            \
  do {                                                           \
    if (threadIdx.x == 0) atomicAdd(&tmat_phase_cycles[(k)], 1); \
  } while (0)
#else
#define STEP_MARK(k)
#define STEP_COUNT(k)
#endif

namespace {

constexpr int NT = 512;   // threads per CTA
constexpr int NW = NT / 32;
constexpr int NC = 32;    // output-channel chunk of the products
constexpr int FL = NC + 4;  // leading dimension of the f32 t and u chunks
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round a float to the storage type and back
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// padding of the bf16 operands' leading dimension (none for the FMA path)
template <typename T> __host__ __device__ constexpr int lpad() { return sizeof(T) == 2 ? 8 : 0; }

template <int TILE> struct Geo {
  static constexpr int SX = 2 * TILE + 5;           // x tile side
  static constexpr int S1 = 2 * TILE + 3;           // t tile side
  static constexpr int S2 = 2 * TILE + 1;           // u tile side
  static constexpr int P1 = S1 * S1;
  static constexpr int P2 = S2 * S2;
  static constexpr int M1 = round_up(P1, 16);       // rows of the pw1 product
  static constexpr int M2 = round_up(P2, 16);       // rows of the pw2 product
  static constexpr int M3 = round_up(TILE * TILE, 16);  // rows of the residual product
  static constexpr int RPW = (TILE * TILE + NW - 1) / NW;  // pooled outputs per warp
};

// Shared-memory layout, byte offsets (each region 128-byte aligned).
//   A: xdw [M1][CP+pad] (phase 1) |
//      ubuf [M2][FL] f32, rbuf [M3][FL] f32, xs [M3][CP+pad], wrs [CP][WL] (phase 2)
//   B: tch [M1][FL] f32
//   D: xt [SX*SX][C] (phase 1a, when staged) | d2 [M2][FP+pad]
//   W: wst [max(CP,FP)][WL]
struct Layout {
  size_t xdw, ubuf, rbuf, xs, wrs, tch, xt, d2, wst, total;
};

__host__ __device__ inline size_t align128(size_t v) { return (v + 127) / 128 * 128; }

template <int TILE, bool STAGE>
__host__ __device__ Layout layout(int C, int F, int elem, int pad) {
  using G = Geo<TILE>;
  const int CP = round_up(C, 16), FP = round_up(F, NC), WL = NC + pad;
  Layout L;
  L.xdw = 0;
  L.ubuf = 0;
  L.rbuf = align128(size_t(G::M2) * FL * 4);
  L.xs = L.rbuf + align128(size_t(G::M3) * FL * 4);
  L.wrs = L.xs + align128(size_t(G::M3) * (CP + pad) * elem);
  const size_t a_end = L.wrs + align128(size_t(CP) * WL * elem);
  const size_t xdw_end = align128(size_t(G::M1) * (CP + pad) * elem);
  L.tch = a_end > xdw_end ? a_end : xdw_end;
  L.xt = L.d2 = L.tch + align128(size_t(G::M1) * FL * 4);
  const size_t xt_end = STAGE ? L.xt + align128(size_t(G::SX) * G::SX * C * elem) : 0;
  const size_t d2_end = L.d2 + align128(size_t(G::M2) * (FP + pad) * elem);
  L.wst = xt_end > d2_end ? xt_end : d2_end;
  L.total = L.wst + size_t(CP > FP ? CP : FP) * WL * elem;
  return L;
}

// out[16][16] (f32, row-major, ldo) = A[16][K] (row-major, lda) @ B[K][16]
// (row-major, ldb); K % 16 == 0. One warp.
template <typename T> struct WarpGemm;

template <> struct WarpGemm<__nv_bfloat16> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* A, int lda,
                                             const __nv_bfloat16* B, int ldb, int K,
                                             float* out, int ldo) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.f);
    for (int k = 0; k < K; k += 16) {
      wmma::load_matrix_sync(a, A + k, lda);
      wmma::load_matrix_sync(b, B + k * ldb, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(out, c, ldo, wmma::mem_row_major);
  }
};

template <> struct WarpGemm<float> {
  static __device__ __forceinline__ void run(const float* A, int lda, const float* B, int ldb,
                                             int K, float* out, int ldo) {
    const int col = threadIdx.x % 16, r0 = threadIdx.x / 16 % 2;  // rows r0, r0+2, ...
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float b = B[k * ldb + col];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(A[(r0 + 2 * i) * lda + k], b, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) out[(r0 + 2 * i) * ldo + col] = acc[i];
  }
};

template <typename T> __device__ __forceinline__ bool aligned16(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// dst[p][0:CW] (ld ldd), p < rows: the C channels of x pixel
// (y0 + step*(p / side), x0 + step*(p % side)) of one image, zero for
// channels >= C, for p >= side*side and outside the image.
template <typename T>
__device__ void stage_pixels(T* dst, int ldd, int CW, int rows, const T* xb, int H, int W,
                             int C, int y0, int x0, int side, int step) {
  constexpr int E = 16 / sizeof(T);
  const int n = side * side;
  if (C % E == 0 && CW % E == 0 && ldd % E == 0 && aligned16(xb)) {
    const int vpp = CW / E;
    for (int i = threadIdx.x; i < rows * vpp; i += NT) {
      const int p = i / vpp, v = i % vpp;
      const int y = y0 + step * (p / side), xx = x0 + step * (p % side);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (p < n && v * E < C && y >= 0 && y < H && xx >= 0 && xx < W)
        val = __ldg(reinterpret_cast<const uint4*>(xb + (size_t(y) * W + xx) * C) + v);
      reinterpret_cast<uint4*>(dst + size_t(p) * ldd)[v] = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * CW; i += NT) {
      const int p = i / CW, c = i % CW;
      const int y = y0 + step * (p / side), xx = x0 + step * (p % side);
      dst[size_t(p) * ldd + c] = (p < n && c < C && y >= 0 && y < H && xx >= 0 && xx < W)
                                     ? xb[(size_t(y) * W + xx) * C + c]
                                     : from_f<T>(0.f);
    }
  }
}

// dst[k][0:NC] (ld ldd) = src[k][col0 : col0+NC] (ld N), zero where
// k >= K or the column >= N; k < rows.
template <typename T>
__device__ void stage_chunk(T* dst, int ldd, const T* src, int rows, int K, int N, int col0) {
  constexpr int E = 16 / sizeof(T);
  if (col0 + NC <= N && N % E == 0 && aligned16(src)) {
    constexpr int VPR = NC / E;
    for (int i = threadIdx.x; i < rows * VPR; i += NT) {
      const int k = i / VPR, v = i % VPR;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k < K) val = __ldg(reinterpret_cast<const uint4*>(src + size_t(k) * N + col0) + v);
      reinterpret_cast<uint4*>(dst + size_t(k) * ldd)[v] = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * NC; i += NT) {
      const int k = i / NC, n = i % NC;
      dst[size_t(k) * ldd + n] =
          (k < K && col0 + n < N) ? src[size_t(k) * N + col0 + n] : from_f<T>(0.f);
    }
  }
}

template <int TILE, bool STAGE, typename T>
__global__ void __launch_bounds__(NT)
down_block_kernel(const T* __restrict__ x, const T* __restrict__ dw1,
                  const T* __restrict__ w1, const float* __restrict__ b1,
                  const T* __restrict__ dw2, const T* __restrict__ w2,
                  const float* __restrict__ b2, const T* __restrict__ wr,
                  const float* __restrict__ br, T* __restrict__ out,
                  int H, int W, int C, int F, int first, int tiles_w) {
  using G = Geo<TILE>;
  constexpr int PAD = lpad<T>(), WL = NC + PAD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Layout L = layout<TILE, STAGE>(C, F, sizeof(T), PAD);
  const int CP = round_up(C, 16), FP = round_up(F, NC);
  const int CPA = CP + PAD, FPA = FP + PAD;
  T* xdw = reinterpret_cast<T*>(smem_raw + L.xdw);             // [M1][CPA]
  float* ubuf = reinterpret_cast<float*>(smem_raw + L.ubuf);   // [M2][FL], phase 2
  float* rbuf = reinterpret_cast<float*>(smem_raw + L.rbuf);   // [M3][FL], phase 2
  T* xs = reinterpret_cast<T*>(smem_raw + L.xs);               // [M3][CPA], phase 2
  T* wrs = reinterpret_cast<T*>(smem_raw + L.wrs);             // [CP][WL], phase 2
  float* tch = reinterpret_cast<float*>(smem_raw + L.tch);     // [M1][FL]
  T* xt = reinterpret_cast<T*>(smem_raw + L.xt);               // [SX*SX][C], phase 1a
  T* d2 = reinterpret_cast<T*>(smem_raw + L.d2);               // [M2][FPA]
  T* wst = reinterpret_cast<T*>(smem_raw + L.wst);             // [CP or FP][WL]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int b = blockIdx.y;
  const int Ho = H / 2, Wo = W / 2;
  const int i0 = (blockIdx.x / tiles_w) * TILE;
  const int j0 = (blockIdx.x % tiles_w) * TILE;
  const T* xb = x + size_t(b) * H * W * C;
  PHASE_START;

  // ---------------- phase 1a: xdw = bf(dw1(h)) over the t tile ----------------
  if constexpr (STAGE) {
    stage_pixels(xt, C, C, G::SX * G::SX, xb, H, W, C, 2 * i0 - 2, 2 * j0 - 2, G::SX, 1);
    __syncthreads();
    PHASE_MARK(0);  // x tile staged
  }
  // When CP divides NT, every element of this thread is channel tid % CP:
  // its 9 taps stay in registers.
  const bool c_fixed = NT % CP == 0;
  float wk[9];
#pragma unroll
  for (int k = 0; k < 9; ++k)
    wk[k] = c_fixed && tid % CP < C ? to_f(dw1[k * C + tid % CP]) : 0.f;
  for (int i = tid; i < G::M1 * CP; i += NT) {
    const int p = i / CP, c = i % CP;
    float v = 0.f;
    if (p < G::P1 && c < C) {
      const int py = p / G::S1, px = p % G::S1;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        float hv;
        if constexpr (STAGE) {
          hv = to_f(xt[((py + k / 3) * G::SX + px + k % 3) * C + c]);
        } else {
          const int yy = 2 * i0 - 2 + py + k / 3, xx = 2 * j0 - 2 + px + k % 3;
          hv = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? to_f(xb[(size_t(yy) * W + xx) * C + c])
                                                       : 0.f;
        }
        const float wv = c_fixed ? wk[k] : to_f(dw1[k * C + c]);
        if (!first) hv = fmaxf(hv, 0.f);
        v = fmaf(hv, wv, v);
      }
      v = rnd<T>(v);
    }
    xdw[p * CPA + c] = from_f<T>(v);
  }

  // ---------------- phase 1b: per F chunk, t = relu(pw1) and d2 = dw2(t) ----------------
  for (int fc0 = 0; fc0 < FP; fc0 += NC) {
    __syncthreads();  // xdw complete; tch, wst and (first chunk) xt free
    PHASE_MARK(fc0 == 0 ? 1 : 4);  // dw1, or the previous chunk's dw2
    stage_chunk(wst, WL, w1, CP, C, F, fc0);
    __syncthreads();
    PHASE_MARK(2);  // w1 chunk staged
    // every dw2 element of this thread is channel fc0 + lane (NC divides NT)
    const int f = fc0 + lane;
    float wt[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) wt[k] = f < F ? to_f(dw2[k * F + f]) : 0.f;
    // work items: 16-row tile mt, 16-column half of the chunk
    for (int it = warp; it < 2 * (G::M1 / 16); it += NW) {
      const int mt = it / 2, col = it % 2 * 16 + lane % 16;
      WarpGemm<T>::run(xdw + mt * 16 * CPA, CPA, wst + it % 2 * 16, WL, CP,
                       tch + mt * 16 * FL + it % 2 * 16, FL);
      __syncwarp();
      const int fe = fc0 + col;
      const float bias = fe < F ? b1[fe] : 0.f;
#pragma unroll 4
      for (int r = lane / 16; r < 16; r += 2) {
        const int p = mt * 16 + r;
        const int ty = 2 * i0 - 1 + p / G::S1;
        const int tx = 2 * j0 - 1 + p % G::S1;
        const bool inside = p < G::P1 && fe < F && ty >= 0 && ty < H && tx >= 0 && tx < W;
        float* e = tch + p * FL + col;
        *e = inside ? rnd<T>(fmaxf(*e + bias, 0.f)) : 0.f;
      }
      __syncwarp();
    }
    __syncthreads();  // t chunk complete
    PHASE_MARK(3);  // pw1
    for (int i = tid; i < G::M2 * NC; i += NT) {
      const int q = i / NC, n = i % NC;
      float v = 0.f;
      if (q < G::P2 && f < F) {
        const int a = q / G::S2, bb = q % G::S2;
#pragma unroll
        for (int k = 0; k < 9; ++k)
          v = fmaf(tch[((a + k / 3) * G::S1 + bb + k % 3) * FL + n], wt[k], v);
      }
      d2[q * FPA + fc0 + n] = from_f<T>(v);
    }
  }

  // ---------------- phase 2: u = pw2(d2) + b2, pool, residual ----------------
  for (int gc0 = 0; gc0 < FP; gc0 += NC) {
    __syncthreads();  // d2 complete; wst, ubuf and wrs free
    PHASE_MARK(gc0 == 0 ? 4 : 7);  // the last dw2, or the previous pool
    if (gc0 == 0) stage_pixels(xs, CPA, CP, G::M3, xb, H, W, C, 2 * i0, 2 * j0, TILE, 2);
    stage_chunk(wst, WL, w2, FP, F, F, gc0);
    stage_chunk(wrs, WL, wr, CP, C, F, gc0);
    __syncthreads();
    PHASE_MARK(5);  // w2, wr chunks (and x[::2, ::2]) staged
    for (int it = warp; it < 2 * (G::M2 / 16 + G::M3 / 16); it += NW) {
      const int mt = it / 2, col = it % 2 * 16 + lane % 16;
      if (mt >= G::M2 / 16) {  // residual rows: x[::2, ::2] @ wr_chunk
        const int rt = mt - G::M2 / 16;
        WarpGemm<T>::run(xs + rt * 16 * CPA, CPA, wrs + it % 2 * 16, WL, CP,
                         rbuf + rt * 16 * FL + it % 2 * 16, FL);
        continue;
      }
      WarpGemm<T>::run(d2 + mt * 16 * FPA, FPA, wst + it % 2 * 16, WL, FP,
                       ubuf + mt * 16 * FL + it % 2 * 16, FL);
      __syncwarp();
      const int ge = gc0 + col;
      const float bias = ge < F ? b2[ge] : 0.f;
#pragma unroll 4
      for (int r = lane / 16; r < 16; r += 2) {
        const int q = mt * 16 + r;
        const int uy = 2 * i0 + q / G::S2;
        const int ux = 2 * j0 + q % G::S2;
        const bool inside = q < G::P2 && uy < H && ux < W;
        float* e = ubuf + q * FL + col;
        *e = inside ? *e + bias : -CUDART_INF_F;
      }
      __syncwarp();
    }
    __syncthreads();  // u and residual chunks complete
    PHASE_MARK(6);  // pw2 and the residual product
    const int g = gc0 + lane;
    if (g >= F) continue;
    const float rb = br[g];
#pragma unroll
    for (int j = 0; j < G::RPW; ++j) {
      const int o = warp + j * NW;
      const int oa = o / TILE, ob = o % TILE;
      const int oi = i0 + oa, oj = j0 + ob;
      if (o >= TILE * TILE || oi >= Ho || oj >= Wo) continue;
      float m = -CUDART_INF_F;
#pragma unroll
      for (int k = 0; k < 9; ++k)
        m = fmaxf(m, ubuf[((2 * oa + k / 3) * G::S2 + 2 * ob + k % 3) * FL + lane]);
      out[((size_t(b) * Ho + oi) * Wo + oj) * F + g] = from_f<T>(m + (rbuf[o * FL + lane] + rb));
    }
  }
  PHASE_MARK(7);  // thread 0's last pool
}

// ---------------------------------------------------------------------------
// The warpgroup form (bf16, C % 64 == 0, F % 128 == 0, 16-byte aligned bases).
//
// The three products run as wgmma m64n64k16: 64 rows x 64 columns per
// warpgroup and instruction, A (xdw, d2, the x samples) and B (weight tiles)
// read from shared memory in the 128-byte swizzled layout, accumulators in
// registers.
//   A, K-major: a [rows][K] operand is K/64 panels of [rows][64] (128 bytes a
//     row); the 16-byte chunk j of row r sits at chunk j ^ (r % 8). The
//     depthwise passes and the sample copy write that layout directly.
//   B, MN-major: a weight tile is rows k0..k0+63 of NCH columns of the
//     row-major [K][N] matrix, as NCH/64 panels of [64 k][64 n] with the same
//     swizzle on k: what the TMA writes for a 64 x 64 box of the weight's
//     tensor map, so no transposed copy of a weight exists.
// Weight tiles flow through a ring of 2-4 stages in one order (pw1:
// chunk-major over w1; then per chunk w2's tiles and wr's); where phase 1
// leaves room behind (xdw and the t chunk are dead in phase 2), phase 2
// starts a longer ring of its own. One thread asks the TMA for a tile and
// an mbarrier counts its bytes off; the products of
// tile s are launched as soon as it has landed and stay in flight while those
// of tile s + 1 are launched, and the stage of tile s is refilled when every
// warpgroup has waited for its products on it: one barrier per 64 x NCH tile
// where the general form has three per 32-column chunk, and the tensor cores
// never drain inside a chunk. The thread that asks walks the order with
// counters: dividing a tile's index by run-time widths cost it more cycles
// a tile than the tile's products take.
// The epilogues read the accumulator registers: t goes to shared memory once
// as bf16 (bias, relu, rounding, zero outside the image), u once as f32 (bias,
// -inf outside). The depthwise passes walk along a tile row with a 3x3 window
// of a channel pair in registers: three 4-byte loads per step instead of nine
// per output. Rows of A past the tile's pixels are never written: a product
// row depends on its own A row alone, and those rows are dropped. The x
// tile arrives by cp.async (zero-filled outside the image), and the
// residual's samples are fetched again into the space xdw leaves.
//
// Three launches, the first that fits (pick_config):
//   tile 8, three warpgroups of two row groups, 64-column chunks (block 1);
//   tile 4, two warpgroups, 64-column chunks, where two CTAs then share an
//     SM, so that one's products cover the other's depthwise passes (block 2);
//   tile 4, four warpgroups as two row groups x two column halves of a
//     128-column chunk (block 3, whose shared memory leaves the ring 2 stages).
// Measured on an H100 and not kept (PERF.md): weight tiles by cp.async from
// all threads; a producer warp with full/empty mbarriers; 2- and 4-CTA
// cluster multicast of the tiles; 32-row tiles in deeper rings; four
// channels a lane in the depthwise walks; dw2 and the pool of the chunk
// before run under the next chunk's products.

namespace wg {

constexpr int KT = 64;  // rows (k) of a weight tile: one swizzle span of A
constexpr int MAX_STAGES = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait for this thread's copies
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// make this thread's shared-memory writes visible to wgmma's reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// wait until only the group committed last may still run
__device__ __forceinline__ void wgmma_wait_but_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// one arrival, and `bytes` more to be counted off by the copies that name this barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// spin until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// TMA: the box of the tensor map at (c0, c1) -> shared memory, counted off on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* tm, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(tm), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo_bytes >> 4) << 16) |
         (uint64_t(sbo_bytes >> 4) << 32) | (uint64_t(1) << 62);
}

// address of the 64 x 16 block at row group g, column k0 of a K-major operand
// at `base` whose panels are `rows` rows long
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int rows, int g, int k0) {
  return base + uint32_t(k0 / 64) * rows * 128 + g * 8192 + (k0 % 64) * 2;
}

// byte offset of byte `byte` (< 128) of row `row` in a swizzled panel
__device__ __forceinline__ uint32_t sw_off(int row, int byte) {
  return uint32_t(row) * 128u + uint32_t((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15));
}

#define TMAT_D8(o)                                                                     \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),          \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d[64 x N] (+)= A[64 x 16] (K-major) @ B[16 x N] (MN-major); d is kept when
// scale_d is not 0, overwritten when it is 0
template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : TMAT_D8(0), TMAT_D8(8), TMAT_D8(16), TMAT_D8(24)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

#undef TMAT_D8

// keeps reads of the accumulators behind the wait that completes them
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory layout, byte offsets from a 1024-byte aligned base.
//   [xdw [ma1][C] | tch [P1][NCH+8] bf16]  (phase 1)  overlaid by
//   [ubuf [P2][NCH+8] f32 | rbuf [T*T][NCH+8] f32 | xs [ma3][C]]  (phase 2)
//   [... | further ring stages]                         (phase 2)
//   d2 [ma2][F] overlaid on xt [SX*SX][C]   ring [stages][64][NCH]
struct Layout {
  uint32_t xdw, tch, ubuf, rbuf, xs, extra, d2, ring, bars, total;
  int ma1, ma2, ma3, extra_stages;
};

__host__ __device__ inline uint32_t align_up(uint32_t v, uint32_t a) { return (v + a - 1) / a * a; }

template <int TILE, int NCH>
__host__ __device__ Layout layout(int C, int F, int stages) {
  using G = Geo<TILE>;
  Layout L;
  L.ma1 = round_up(G::P1, 8);
  L.ma2 = round_up(G::P2, 8);
  L.ma3 = round_up(TILE * TILE, 8);
  L.xdw = 0;
  L.tch = align_up(uint32_t(L.ma1) * C * 2, 1024);
  const uint32_t end1 = L.tch + uint32_t(G::P1) * (NCH + 8) * 2;
  L.ubuf = 0;
  L.rbuf = align_up(uint32_t(G::P2) * (NCH + 8) * 4, 128);
  L.xs = align_up(L.rbuf + uint32_t(TILE * TILE) * (NCH + 8) * 4, 1024);
  const uint32_t end2 = L.xs + uint32_t(L.ma3) * C * 2;
  L.d2 = align_up(end1 > end2 ? end1 : end2, 1024);
  // phase 2 has a ring of its own: the stages below and as many more (up to
  // MAX_STAGES in all) as fit into what phase 1 leaves behind
  L.extra = align_up(end2, 1024);
  const int room = L.extra < L.d2 ? int((L.d2 - L.extra) / (KT * NCH * 2)) : 0;
  L.extra_stages = room < MAX_STAGES - stages ? room : MAX_STAGES - stages;
  const uint32_t d2_bytes = uint32_t(L.ma2) * F * 2;
  const uint32_t xt_bytes = uint32_t(G::SX * G::SX) * C * 2;
  L.ring = align_up(L.d2 + (d2_bytes > xt_bytes ? d2_bytes : xt_bytes), 1024);
  L.bars = L.ring + uint32_t(stages) * KT * NCH * 2;  // one mbarrier a stage and phase
  L.total = L.bars + 16 * MAX_STAGES + 1024;  // 1024: slack to align the base
  return L;
}

// One 3x3 depthwise pass over a row of N_OUT outputs for this lane's
// channel pair: src points at the pair in the top-left input pixel, pixels
// are `pix` bf16 apart and rows `row` apart; w[k] are the nine taps. The 3x3
// window stays in registers: a step loads one new column of three. The taps
// are summed in the order k = 0..8 from 0, in f32, then rounded.
template <int N_OUT, bool RELU, typename Store>
__device__ __forceinline__ void dw_row(const __nv_bfloat16* src, int pix, int row,
                                       const float2 (&w)[9], Store store) {
  float2 h[3][3];
  auto load = [&](int dy, int dx) {
    float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(src + size_t(dy) * row + size_t(dx) * pix));
    if (RELU) {
      v.x = fmaxf(v.x, 0.f);
      v.y = fmaxf(v.y, 0.f);
    }
    return v;
  };
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    h[dy][0] = load(dy, 0);
    h[dy][1] = load(dy, 1);
  }
#pragma unroll
  for (int px = 0; px < N_OUT; ++px) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) h[dy][2] = load(dy, px + 2);
    float2 v = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      v.x = fmaf(h[k / 3][k % 3].x, w[k].x, v.x);
      v.y = fmaf(h[k / 3][k % 3].y, w[k].y, v.y);
    }
    store(px, __floats2bfloat162_rn(v.x, v.y));
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      h[dy][0] = h[dy][1];
      h[dy][1] = h[dy][2];
    }
  }
}

template <int TILE, int NWG, int RG, int NCH, int MINB>
__global__ void __launch_bounds__(NWG * 128, MINB)
down_block_wgmma_kernel(const __grid_constant__ CUtensorMap tm_w1,
                        const __grid_constant__ CUtensorMap tm_w2,
                        const __grid_constant__ CUtensorMap tm_wr,
                        const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dw1,
                        const float* __restrict__ b1, const __nv_bfloat16* __restrict__ dw2,
                        const float* __restrict__ b2, const float* __restrict__ br,
                        __nv_bfloat16* __restrict__ out,
                        int H, int W, int C, int F, int first, int tiles_w, int stages) {
  using G = Geo<TILE>;
  using bf16 = __nv_bfloat16;
  constexpr int NTH = NWG * 128, NWARP = NWG * 4;
  constexpr int LDT = NCH + 8, LDU = NCH + 8;
  constexpr int MG1 = (G::P1 + 63) / 64, MG2 = (G::P2 + 63) / 64;
  constexpr int STAGE_BYTES = KT * NCH * 2;
  // a warpgroup's products are 64 columns wide: a chunk has NCH / 64 halves,
  // and warpgroup wgid takes rows wrow (+ NROW per further row group) of half
  constexpr int NHALF = NCH / 64, NROW = NWG / NHALF;
  static_assert(NWG % NHALF == 0 && MG1 <= NROW * RG && MG2 <= NROW * RG,
                "a row group without a warpgroup");
  static_assert(TILE * TILE <= 64, "the residual is one row group");
  // The residual product of a half chunk (64 columns) is one warpgroup's:
  // the last row's where that has a pw2 row group less than the others (its
  // last accumulator is then free), else the first row's (two halves) or each
  // row's in turn by chunk, in an accumulator of its own.
  constexpr bool FREE = MG2 <= (RG - 1) * NROW + NROW - 1;
  constexpr int RI = FREE ? RG - 1 : RG;

  extern __shared__ unsigned char smem_dyn[];
  unsigned char* smem = smem_dyn + ((1024u - (smem_u32(smem_dyn) & 1023u)) & 1023u);
  const Layout L = layout<TILE, NCH>(C, F, stages);
  unsigned char* xdw = smem + L.xdw;                      // A of pw1, swizzled
  bf16* tch = reinterpret_cast<bf16*>(smem + L.tch);      // [P1][LDT]
  float* ubuf = reinterpret_cast<float*>(smem + L.ubuf);  // [P2][LDU], phase 2
  float* rbuf = reinterpret_cast<float*>(smem + L.rbuf);  // [T*T][LDU], phase 2
  unsigned char* xs = smem + L.xs;                        // A of the residual, swizzled
  unsigned char* d2 = smem + L.d2;                        // A of pw2, swizzled
  bf16* xt = reinterpret_cast<bf16*>(smem + L.d2);        // [SX*SX][C], until dw1 is done
  const uint32_t ring = smem_u32(smem + L.ring);
  const uint32_t xdw_a = smem_u32(xdw), d2_a = smem_u32(d2), xs_a = smem_u32(xs);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wgid = warp / 4, w4 = warp % 4;
  const int wrow = wgid % NROW, half = wgid / NROW;
  const int b = blockIdx.y;
  const int Ho = H / 2, Wo = W / 2;
  const int i0 = (blockIdx.x / tiles_w) * TILE;
  const int j0 = (blockIdx.x % tiles_w) * TILE;
  const bf16* xb = x + size_t(b) * H * W * C;
  const int KC = C / KT, KF = F / KT, NCHUNK = F / NCH;
  PHASE_START;

  // The weight tiles in the order the products take them.
  const int n_tiles1 = NCHUNK * KC, n_tiles = n_tiles1 + NCHUNK * (KF + KC);
  // One thread asks the TMA for the next tile of the order; its bytes are
  // counted off on the stage's barrier. The order is walked with counters:
  // a division by a run-time width costs that thread hundreds of cycles.
  // Where phase 1 leaves room for more stages (L.extra_stages, where xdw and
  // the t chunk were), phase 2 starts a longer ring of its own, with its own
  // barriers; else one ring runs through both phases.
  const uint32_t extra = smem_u32(smem + L.extra);
  uint32_t full = smem_u32(smem + L.bars);
  int n_st = stages;
  auto stage_addr = [&](int i) {
    return i < stages ? ring + uint32_t(i) * STAGE_BYTES : extra + uint32_t(i - stages) * STAGE_BYTES;
  };
  int i_left = L.extra_stages ? n_tiles1 : n_tiles, i_stage = 0, i_mat = 0, i_nc = 0, i_kt = 0;  // i_mat: 0 w1, 1 w2, 2 wr
  auto request_tile = [&]() {
    if (tid != 0 || i_left == 0) return;
    const CUtensorMap* tm = i_mat == 0 ? &tm_w1 : i_mat == 1 ? &tm_w2 : &tm_wr;
    const uint32_t bar = full + 8 * i_stage, dst = stage_addr(i_stage);
    mbar_expect_tx(bar, STAGE_BYTES);
    for (int pn = 0; pn < NCH / 64; ++pn)
      tma_load_2d(dst + pn * (KT * 128), tm, i_nc * NCH + pn * 64, i_kt * KT, bar);
    --i_left;
    if (++i_stage == n_st) i_stage = 0;
    ++i_kt;
    if (i_mat == 0) {  // w1: chunk-major
      if (i_kt == KC) {
        i_kt = 0;
        if (++i_nc == NCHUNK) i_nc = 0, i_mat = 1;
      }
    } else if (i_mat == 1) {  // w2's tiles of a chunk, then wr's
      if (i_kt == KF) i_kt = 0, i_mat = 2;
    } else if (i_kt == KC) {
      i_kt = 0, i_mat = 1, ++i_nc;
    }
  };
  // Wait for the next tile; the stage of the one before it is then refilled
  // (release_tile), once every warpgroup has left it.
  int c_stage = 0, c_parity = 0;
  auto next_tile = [&]() -> uint32_t {
    STEP_MARK(5);  // between steps
    STEP_COUNT(6);
    mbar_wait(full + 8 * c_stage, c_parity);
    STEP_MARK(0);  // the wait for the tile
    const uint32_t stage = stage_addr(c_stage);
    if (++c_stage == n_st) c_stage = 0, c_parity ^= 1;
    return stage;
  };
  // A tile's products stay in flight while the next tile's are launched; the
  // stage of the tile before is refilled once every warpgroup's products on
  // it are done (each has waited for all but its newest group).
  bool tile_held = false;
  auto release_tile = [&]() {
    __syncthreads();
    STEP_MARK(3);  // the barrier
    request_tile();
    STEP_MARK(4);  // the request for the next tile
  };
  if (tid == 0) {
    for (int i = 0; i < 2 * MAX_STAGES; ++i) mbar_init(full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ---------------- the x tile and the first weight tiles ----------------
  {
    const int cpp = C / 8;  // 16-byte chunks per pixel
    const uint32_t xt_a = smem_u32(xt);
    for (int i = tid; i < G::SX * G::SX * cpp; i += NTH) {
      const int p = i / cpp, j = i % cpp;
      const int y = 2 * i0 - 2 + p / G::SX, xx = 2 * j0 - 2 + p % G::SX;
      const bool ok = y >= 0 && y < H && xx >= 0 && xx < W;
      cp_async16(xt_a + uint32_t(i) * 16, ok ? xb + (size_t(y) * W + xx) * C + j * 8 : xb, ok ? 16 : 0);
    }
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) request_tile();
  cp_async_wait_all();
  __syncthreads();
  PHASE_MARK(0);  // x tile arrived

  // ---------------- xdw = bf(dw1(h)) ----------------
  {
    // a task is a tile row of 64 channels: a warp walks along it, a lane
    // on its channel pair
    const int groups = C / 64;
    for (int task = warp; task < G::S1 * groups; task += NWARP) {
      const int py = task / groups, cg = task % groups, c = cg * 64 + 2 * lane;
      float2 wk[9];
#pragma unroll
      for (int k = 0; k < 9; ++k)
        wk[k] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dw1 + k * C + c));
      unsigned char* dst = xdw + size_t(cg) * L.ma1 * 128;
      auto store = [&](int px, __nv_bfloat162 v) {
        *reinterpret_cast<__nv_bfloat162*>(dst + sw_off(py * G::S1 + px, lane * 4)) = v;
      };
      const bf16* src = xt + size_t(py) * G::SX * C + c;
      if (first) dw_row<G::S1, false>(src, C, G::SX * C, wk, store);
      else dw_row<G::S1, true>(src, C, G::SX * C, wk, store);
    }
    fence_async_proxy();
  }
  __syncthreads();  // xdw complete
  PHASE_MARK(1);  // dw1

  float acc[RI + 1][32];
  float (&accr)[32] = acc[RI];

  // ---------------- phase 1: per chunk of F, t = relu(pw1) and d2 = dw2(t) ----------------
  for (int nc = 0; nc < NCHUNK; ++nc) {
    for (int kt = 0; kt < KC; ++kt) {
      const uint32_t stage = next_tile();
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KT / 16; ++ks) {
        const uint64_t db_ = make_desc(stage + half * (KT * 128) + ks * 2048, KT * 128, 1024);
#pragma unroll
        for (int rg = 0; rg < RG; ++rg) {
          const int g = wrow + rg * NROW;
          if (g < MG1)
            Wgmma<64>::run(acc[rg],
                           make_desc(a_addr(xdw_a, L.ma1, g, kt * KT + ks * 16), 16, 1024),
                           db_, kt | ks);
        }
      }
      wgmma_commit();
      STEP_MARK(1);  // the launch of the products
      wgmma_wait_but_one();
      STEP_MARK(2);  // the wait for the products of the tile before
      if (tile_held) release_tile();
      tile_held = true;
    }
    wgmma_wait_all();
    release_tile();
    tile_held = false;
#pragma unroll
    for (int rg = 0; rg < RG; ++rg) fence_regs(acc[rg]);
    PHASE_MARK(2);  // pw1, with the wait for its weight tiles
    // t = bf(relu(acc + b1)), 0 outside the image
    float2 bias[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bias[j] = __ldg(reinterpret_cast<const float2*>(b1 + nc * NCH + half * 64 + 8 * j + 2 * (lane % 4)));
#pragma unroll
    for (int rg = 0; rg < RG; ++rg) {
      const int g = wrow + rg * NROW;
      if (g >= MG1) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = g * 64 + 16 * w4 + lane / 4 + 8 * hh;
        if (p >= G::P1) continue;
        const int ty = 2 * i0 - 1 + p / G::S1, tx = 2 * j0 - 1 + p % G::S1;
        const bool inside = ty >= 0 && ty < H && tx >= 0 && tx < W;
        bf16* row = tch + p * LDT + half * 64 + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 bb = bias[j];
          const float v0 = inside ? fmaxf(acc[rg][4 * j + 2 * hh] + bb.x, 0.f) : 0.f;
          const float v1 = inside ? fmaxf(acc[rg][4 * j + 2 * hh + 1] + bb.y, 0.f) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncthreads();  // t chunk complete
    PHASE_MARK(3);  // pw1's epilogue
    {
      constexpr int groups = NCH / 64;
      for (int task = warp; task < G::S2 * groups; task += NWARP) {
        const int a = task / groups, cg = task % groups, f = nc * NCH + cg * 64 + 2 * lane;
        float2 wt[9];
#pragma unroll
        for (int k = 0; k < 9; ++k)
          wt[k] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dw2 + k * F + f));
        unsigned char* dst = d2 + size_t(f / 64) * L.ma2 * 128;
        auto store = [&](int px, __nv_bfloat162 v) {
          *reinterpret_cast<__nv_bfloat162*>(dst + sw_off(a * G::S2 + px, lane * 4)) = v;
        };
        dw_row<G::S2, false>(tch + size_t(a) * G::S1 * LDT + cg * 64 + 2 * lane, LDT, G::S1 * LDT, wt,
                             store);
      }
      fence_async_proxy();
    }
    PHASE_MARK(4);  // dw2
  }

  // ---------------- phase 2: u = pw2(d2) + b2, the residual, pool ----------------
  // The residual's samples x[::2, ::2] go where xdw was (the x tile is gone),
  // and phase 2's own ring starts (phase 1 has taken all its tiles).
  __syncthreads();
  if (L.extra_stages) {
    full += 8 * MAX_STAGES, n_st = stages + L.extra_stages;
    i_left = n_tiles - n_tiles1, i_stage = 0, c_stage = 0, c_parity = 0;
    for (int s = 0; s < n_st; ++s) request_tile();
  }
  {
    const int cpp = C / 8;
    for (int i = tid; i < TILE * TILE * cpp; i += NTH) {
      const int o = i / cpp, j = i % cpp;
      const int y = 2 * (i0 + o / TILE), xx = 2 * (j0 + o % TILE);
      const bool ok = y < H && xx < W;
      cp_async16(xs_a + uint32_t(j / 8) * L.ma3 * 128 + sw_off(o, (j % 8) * 16),
                 ok ? xb + (size_t(y) * W + xx) * C + j * 8 : xb, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait_all();
    fence_async_proxy();
  }
  const int res_col = half * 64;
  for (int nc = 0; nc < NCHUNK; ++nc) {
    const bool res_wg = wrow == (FREE ? NROW - 1 : NHALF == 2 ? 0 : nc % NROW);
    for (int kt = 0; kt < KF; ++kt) {
      const uint32_t stage = next_tile();
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KT / 16; ++ks) {
        const uint64_t db_ = make_desc(stage + half * (KT * 128) + ks * 2048, KT * 128, 1024);
#pragma unroll
        for (int rg = 0; rg < RG; ++rg) {
          const int g = wrow + rg * NROW;
          if (g < MG2)
            Wgmma<64>::run(acc[rg],
                           make_desc(a_addr(d2_a, L.ma2, g, kt * KT + ks * 16), 16, 1024),
                           db_, kt | ks);
        }
      }
      wgmma_commit();
      STEP_MARK(1);  // the launch of the products
      wgmma_wait_but_one();
      STEP_MARK(2);  // the wait for the products of the tile before
      if (tile_held) release_tile();
      tile_held = true;
    }
    for (int kt = 0; kt < KC; ++kt) {
      const uint32_t stage = next_tile();
      if (res_wg) {
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KT / 16; ++ks)
          Wgmma<64>::run(accr, make_desc(a_addr(xs_a, L.ma3, 0, kt * KT + ks * 16), 16, 1024),
                         make_desc(stage + (res_col / 64) * (KT * 128) + ks * 2048, KT * 128, 1024),
                         kt | ks);
        wgmma_commit();
        STEP_MARK(1);
        wgmma_wait_but_one();
      } else {
        // no group of this step: all of pw2's products on the tile that is
        // released below must have read it
        STEP_MARK(1);
        wgmma_wait_all();
      }
      STEP_MARK(2);
      if (tile_held) release_tile();
      tile_held = true;
    }
    wgmma_wait_all();
    release_tile();
    tile_held = false;
#pragma unroll
    for (int rg = 0; rg <= RI; ++rg) fence_regs(acc[rg]);
    PHASE_MARK(5);  // pw2 and the residual product, with the wait for their weight tiles
    // u = acc + b2, -inf outside the image (the pool's bottom/right pad)
    float2 bias[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bias[j] = __ldg(reinterpret_cast<const float2*>(b2 + nc * NCH + half * 64 + 8 * j + 2 * (lane % 4)));
#pragma unroll
    for (int rg = 0; rg < RG; ++rg) {
      const int g = wrow + rg * NROW;
      if (g >= MG2) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = g * 64 + 16 * w4 + lane / 4 + 8 * hh;
        if (q >= G::P2) continue;
        const bool inside = 2 * i0 + q / G::S2 < H && 2 * j0 + q % G::S2 < W;
        float* row = ubuf + q * LDU + half * 64 + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 bb = bias[j];
          float2 v;
          v.x = inside ? acc[rg][4 * j + 2 * hh] + bb.x : -CUDART_INF_F;
          v.y = inside ? acc[rg][4 * j + 2 * hh + 1] + bb.y : -CUDART_INF_F;
          *reinterpret_cast<float2*>(row + 8 * j) = v;
        }
      }
    }
    if (res_wg) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = 16 * w4 + lane / 4 + 8 * hh;
        if (o >= TILE * TILE) continue;
        float* row = rbuf + o * LDU + res_col + 2 * (lane % 4);
        const float* rbias = br + nc * NCH + res_col + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 bb = __ldg(reinterpret_cast<const float2*>(rbias + 8 * j));
          *reinterpret_cast<float2*>(row + 8 * j) =
              make_float2(accr[4 * j + 2 * hh] + bb.x, accr[4 * j + 2 * hh + 1] + bb.y);
        }
      }
    }
    __syncthreads();  // u and residual chunks complete
    PHASE_MARK(6);  // their epilogue
    for (int i = tid; i < TILE * TILE * (NCH / 2); i += NTH) {
      const int o = i / (NCH / 2), cp = i % (NCH / 2);
      const int oa = o / TILE, ob = o % TILE;
      const int oi = i0 + oa, oj = j0 + ob;
      if (oi >= Ho || oj >= Wo) continue;
      float2 m = make_float2(-CUDART_INF_F, -CUDART_INF_F);
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float2 u = *reinterpret_cast<const float2*>(
            ubuf + ((2 * oa + k / 3) * G::S2 + 2 * ob + k % 3) * LDU + 2 * cp);
        m.x = fmaxf(m.x, u.x);
        m.y = fmaxf(m.y, u.y);
      }
      const float2 r = *reinterpret_cast<const float2*>(rbuf + o * LDU + 2 * cp);
      *reinterpret_cast<__nv_bfloat162*>(out + ((size_t(b) * Ho + oi) * Wo + oj) * F + nc * NCH + 2 * cp) =
          __floats2bfloat162_rn(m.x + r.x, m.y + r.y);
    }
    PHASE_MARK(7);  // pool
  }
}

// What the warpgroup form launches for a block: tile 8 (three warpgroups,
// two row groups each), tile 4 with two warpgroups and 64-column chunks where
// two CTAs then share an SM, else tile 4 with four warpgroups and 128-column
// chunks; and the depth of the weight ring. Tile 0: the form does not apply
// or nothing fits.
struct Config {
  int tile, warpgroups, stages;
};
constexpr uint32_t SMEM_TWO_CTAS = (233472 - 2 * 1024) / 2;

// the deepest ring, of four stages at most, that fits `limit`; 0 if none does
template <int TILE, int NCH> inline int fit_ring(int C, int F, uint32_t limit) {
  for (int st = MAX_STAGES; st >= 2; --st)
    if (layout<TILE, NCH>(C, F, st).total <= limit) return st;
  return 0;
}

inline Config pick_config(int C, int F) {
  if (C % 64 || F % 128) return {0, 0, 0};
  if (const int st = fit_ring<8, 64>(C, F, SMEM_MAX)) return {8, 3, st};
  if (const int st = fit_ring<4, 64>(C, F, SMEM_TWO_CTAS)) return {4, 2, st};
  if (const int st = fit_ring<4, 128>(C, F, SMEM_MAX)) return {4, 4, st};
  return {0, 0, 0};
}

// cuTensorMapEncodeTiled, looked up through the runtime: the library links
// against no libcuda symbol
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major bf16 [K][N] weight whose box is `rows` rows
// of 64 columns, written to shared memory with the 128-byte swizzle.
inline bool weight_map(CUtensorMap* tm, const void* w, int K, int N, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {cuuint64_t(N), cuuint64_t(K)}, strides[1] = {cuuint64_t(N) * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(rows)}, elem[2] = {1, 1};
  return encode(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TILE, int NWG, int RG, int NCH, int MINB>
cudaError_t launch(const void* x, const void* dw1, const void* w1, const void* b1,
                   const void* dw2, const void* w2, const void* b2, const void* wr,
                   const void* br, void* out, int B, int H, int W, int C, int F,
                   int first, int stages, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  CUtensorMap tm_w1, tm_w2, tm_wr;
  if (!weight_map(&tm_w1, w1, C, F, KT) || !weight_map(&tm_w2, w2, F, F, KT) ||
      !weight_map(&tm_wr, wr, C, F, KT))
    return cudaErrorInvalidValue;
  const size_t smem = layout<TILE, NCH>(C, F, stages).total;
  auto kern = down_block_wgmma_kernel<TILE, NWG, RG, NCH, MINB>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int tiles_h = (H / 2 + TILE - 1) / TILE, tiles_w = (W / 2 + TILE - 1) / TILE;
  dim3 grid(tiles_h * tiles_w, B);
  kern<<<grid, NWG * 128, smem, stream>>>(
      tm_w1, tm_w2, tm_wr, static_cast<const bf16*>(x), static_cast<const bf16*>(dw1),
      static_cast<const float*>(b1), static_cast<const bf16*>(dw2), static_cast<const float*>(b2),
      static_cast<const float*>(br), static_cast<bf16*>(out), H, W, C, F, first, tiles_w, stages);
  return cudaGetLastError();
}

inline bool aligned16_all(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  return true;
}

}  // namespace wg

template <int TILE, bool STAGE, typename T>
cudaError_t launch(const void* x, const void* dw1, const void* w1, const void* b1,
                   const void* dw2, const void* w2, const void* b2, const void* wr,
                   const void* br, void* out, int B, int H, int W, int C, int F,
                   int first, cudaStream_t stream) {
  const size_t smem = layout<TILE, STAGE>(C, F, sizeof(T), lpad<T>()).total;
  auto kern = down_block_kernel<TILE, STAGE, T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int tiles_h = (H / 2 + TILE - 1) / TILE, tiles_w = (W / 2 + TILE - 1) / TILE;
  dim3 grid(tiles_h * tiles_w, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dw1), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(dw2), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(wr), static_cast<const float*>(br),
      static_cast<T*>(out), H, W, C, F, first, tiles_w);
  return cudaGetLastError();
}

// The launch configuration: tile side, plus 100 when x is read from global
// memory instead of a staged tile; 0 if nothing fits.
template <typename T>
int pick_config(int C, int F) {
  constexpr int p = lpad<T>(), e = sizeof(T);
  if (layout<8, true>(C, F, e, p).total <= SMEM_MAX) return 8;
  if (layout<4, true>(C, F, e, p).total <= SMEM_MAX) return 4;
  if (layout<2, true>(C, F, e, p).total <= SMEM_MAX) return 2;
  if (layout<8, false>(C, F, e, p).total <= SMEM_MAX) return 108;
  if (layout<4, false>(C, F, e, p).total <= SMEM_MAX) return 104;
  if (layout<2, false>(C, F, e, p).total <= SMEM_MAX) return 102;
  return 0;
}

// What this thread's last call launched: tmat_down_block_tile's code, 0
// before the first launch and after a call that launched nothing.
thread_local int last_launch_code = 0;

template <typename T>
cudaError_t dispatch(const void* x, const void* dw1, const void* w1, const void* b1,
                     const void* dw2, const void* w2, const void* b2, const void* wr,
                     const void* br, void* out, int B, int H, int W, int C, int F,
                     int first, cudaStream_t s) {
  if constexpr (sizeof(T) == 2) {
    const wg::Config cfg = wg::pick_config(C, F);
    if (cfg.tile && wg::aligned16_all({x, dw1, w1, b1, dw2, w2, b2, wr, br, out})) {
#define TMAT_WG_LAUNCH(...) \
  wg::launch<__VA_ARGS__>(x, dw1, w1, b1, dw2, w2, b2, wr, br, out, B, H, W, C, F, first, cfg.stages, s)
      last_launch_code = 1000 + cfg.tile;
      if (cfg.tile == 8) return TMAT_WG_LAUNCH(8, 3, 2, 64, 1);
      if (cfg.warpgroups == 2) return TMAT_WG_LAUNCH(4, 2, 1, 64, 2);
      return TMAT_WG_LAUNCH(4, 4, 1, 128, 1);
#undef TMAT_WG_LAUNCH
    }
  }
#define TMAT_LAUNCH(TL, ST) \
  launch<TL, ST, T>(x, dw1, w1, b1, dw2, w2, b2, wr, br, out, B, H, W, C, F, first, s)
  switch (last_launch_code = pick_config<T>(C, F)) {
    case 8: return TMAT_LAUNCH(8, true);
    case 4: return TMAT_LAUNCH(4, true);
    case 2: return TMAT_LAUNCH(2, true);
    case 108: return TMAT_LAUNCH(8, false);
    case 104: return TMAT_LAUNCH(4, false);
    case 102: return TMAT_LAUNCH(2, false);
    default: return cudaErrorInvalidValue;
  }
#undef TMAT_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success).
int tmat_down_block(const void* x, const void* dw1, const void* w1, const void* b1,
                    const void* dw2, const void* w2, const void* b2, const void* wr,
                    const void* br, void* out, int B, int H, int W, int C, int F,
                    int first, int dtype, void* stream) {
  last_launch_code = 0;
  if (B <= 0 || H <= 0 || W <= 0 || (H | W) & 1 || C <= 0 || F <= 0 || B > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(dispatch<float>(x, dw1, w1, b1, dw2, w2, b2, wr, br, out, B, H, W, C, F, first, s));
  if (dtype == 1)
    return int(dispatch<__nv_bfloat16>(x, dw1, w1, b1, dw2, w2, b2, wr, br, out, B, H, W, C, F, first, s));
  return int(cudaErrorInvalidValue);
}

// The launch configuration the kernel would use for a block of 16-byte
// aligned tensors (see pick_config): the tile side, plus 100 when x is not
// staged, plus 1000 for the warpgroup form; 0 if none fits.
int tmat_down_block_tile(int C, int F, int dtype) {
  if (dtype == 0) return pick_config<float>(C, F);
  const wg::Config cfg = wg::pick_config(C, F);
  return cfg.tile ? 1000 + cfg.tile : pick_config<__nv_bfloat16>(C, F);
}

// The configuration that the calling thread's last tmat_down_block launched,
// as tmat_down_block_tile codes it: what dispatch took for those tensors,
// their alignment included. 0 if that call launched nothing.
int tmat_down_block_last_launch() { return last_launch_code; }

#ifdef TMAT_DOWN_BLOCK_PROBE
// Copy the 8 phase counters to host memory and zero them.
int tmat_down_block_probe_read(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, tmat_phase_cycles, sizeof(tmat_phase_cycles));
  if (err != cudaSuccess) return int(err);
  const unsigned long long zero[8] = {0};
  return int(cudaMemcpyToSymbol(tmat_phase_cycles, zero, sizeof(zero)));
}
#endif

}  // extern "C"
