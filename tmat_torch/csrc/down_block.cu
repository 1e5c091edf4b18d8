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
// A CTA is 16 warps. Each warp computes 16x16 output tiles of the three
// products: on the tensor cores (wmma, bf16 in, f32 accumulate) for bf16, with FMA loops
// for f32 (the f32 path exists to hold the kernel against its plain
// version). bf16 operands sit at a leading dimension padded by 16 bytes,
// so the fragment loads do not collide on shared-memory banks. The
// depthwise taps and the pool run on the CUDA cores. T is 8, 4 or 2: the
// largest whose shared memory fits; a block too wide for its x tile to fit
// beside the rest (C=512, F=1024 in bf16) reads x from global memory
// instead. No TMA, wgmma or pipelining yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

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

template <typename T>
cudaError_t dispatch(const void* x, const void* dw1, const void* w1, const void* b1,
                     const void* dw2, const void* w2, const void* b2, const void* wr,
                     const void* br, void* out, int B, int H, int W, int C, int F,
                     int first, cudaStream_t s) {
#define TMAT_LAUNCH(TL, ST) \
  launch<TL, ST, T>(x, dw1, w1, b1, dw2, w2, b2, wr, br, out, B, H, W, C, F, first, s)
  switch (pick_config<T>(C, F)) {
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
  if (B <= 0 || H <= 0 || W <= 0 || (H | W) & 1 || C <= 0 || F <= 0 || B > 65535)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(dispatch<float>(x, dw1, w1, b1, dw2, w2, b2, wr, br, out, B, H, W, C, F, first, s));
  if (dtype == 1)
    return int(dispatch<__nv_bfloat16>(x, dw1, w1, b1, dw2, w2, b2, wr, br, out, B, H, W, C, F, first, s));
  return int(cudaErrorInvalidValue);
}

// The launch configuration the kernel would use for a block (see
// pick_config): the tile side, plus 100 when x is not staged; 0 if none fits.
int tmat_down_block_tile(int C, int F, int dtype) {
  return dtype == 0 ? pick_config<float>(C, F) : pick_config<__nv_bfloat16>(C, F);
}

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
