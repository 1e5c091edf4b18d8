// Int8 convolution (s8 x s8 -> s32) with a fused epilogue, for sm_90a.
//
// No Pallas kernel stands behind it: the JAX package computes this
// convolution with lax.conv_general_dilated(..., preferred_element_type=int32)
// (tmat_tpu/models/quant.py, forward_quant and forward_mixed) and its
// epilogue as a separate XLA pass, which on the TPU materialised an s32
// intermediate and lost to bf16. Here the epilogue runs on the sums while
// they are in registers, and only the epilogue's output is written.
//
// Function (tmat_torch/ops/int8_conv.py has the plain version): x int8 NHWC
// (B, H, W, Cin); weights packed (Cout, Kp), row n = output channel n's taps
// in (dy, dx, ci) order, zero beyond K = kh*kh*Cin; TF-SAME zero padding
// (pad_t, pad_l before; the rest implied by the bounds); then
//   v = f32(acc) * m[n] + c[n]  [relu]  -> int8 (round half to even, clip
//   +-127), or [* sout[n]] -> float32 / bfloat16.
// Built with -fmad=false and written with __fmul_rn/__fadd_rn, so every
// output is bit-equal to the plain version's.
//
// Design: an implicit GEMM, M = B*Ho*Wo output pixels, N = Cout, K = the
// taps. A block computes a 128 x 64 tile with 8 warps (4 along M, 2 along
// N), each warp 32 x 32 with mma.sync m16n8k32 (s8 x s8 + s32). K runs in
// steps of 64 bytes through a 3-stage cp.async ring in shared memory; rows
// are 80 bytes apart, so the fragment reads of a warp hit 32 distinct
// banks. The A tile is gathered from the batch as im2col rows: with Cin a
// multiple of 16, each 16-byte piece of a row lies in one tap and is one
// cp.async (zero-filled outside the image); otherwise (the entry conv,
// Cin = 1) byte by byte. It is bound by int8 tensor-core operations at the
// up path's widths and by bytes at the entry conv's. Not yet done: wgmma and
// TMA, and fusing the input requantisation into the A load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int LDS = BK + 16;  // bytes between rows of a tile in shared memory

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* m;
  const float* c;
  const float* sout;
  void* out;
  int H, W, Cin, Cout, kw, stride, pad_t, pad_l, Ho, Wo, K, Kp, M, relu, out_kind;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output pixel's row of the A tile: its image and the top-left input
// coordinate of its window.
struct Row {
  int b, iy0, ix0;
  bool ok;
};

template <bool VEC>
__device__ __forceinline__ void load_a(const Params& p, uint8_t* As, const Row (&rows)[2], int tid, int k_tile) {
  const int kseg = tid & 3;
  const int k0 = k_tile * BK + kseg * 16;
  if (VEC) {
    int ci = 0, dy = 0, dx = 0;
    if (k0 < p.K) {
      const int tap = k0 / p.Cin;
      ci = k0 - tap * p.Cin;
      dy = tap / p.kw;
      dx = tap - dy * p.kw;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = (tid >> 2) + j * (BM / 2);
      const int iy = rows[j].iy0 + dy, ix = rows[j].ix0 + dx;
      const bool valid = rows[j].ok && k0 < p.K && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      const int8_t* src =
          valid ? p.x + ((static_cast<size_t>(rows[j].b) * p.H + iy) * p.W + ix) * p.Cin + ci : p.x;
      cp_async16(As + row * LDS + kseg * 16, src, valid);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = (tid >> 2) + j * (BM / 2);
      unsigned words[4] = {0u, 0u, 0u, 0u};
      for (int e = 0; e < 16; ++e) {
        const int k = k0 + e;
        if (!rows[j].ok || k >= p.K) break;
        const int tap = k / p.Cin;
        const int ci = k - tap * p.Cin;
        const int dy = tap / p.kw, dx = tap - (tap / p.kw) * p.kw;
        const int iy = rows[j].iy0 + dy, ix = rows[j].ix0 + dx;
        if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) {
          const uint8_t v = static_cast<uint8_t>(
              p.x[((static_cast<size_t>(rows[j].b) * p.H + iy) * p.W + ix) * p.Cin + ci]);
          words[e >> 2] |= static_cast<unsigned>(v) << (8 * (e & 3));
        }
      }
      *reinterpret_cast<uint4*>(As + row * LDS + kseg * 16) = make_uint4(words[0], words[1], words[2], words[3]);
    }
  }
}

__device__ __forceinline__ void load_b(const Params& p, uint8_t* Bs, int n0, int tid, int k_tile) {
  const int row = tid >> 2, kseg = tid & 3;
  const int k0 = k_tile * BK + kseg * 16;
  const bool valid = n0 + row < p.Cout && k0 < p.Kp;
  const int8_t* src = valid ? p.w + static_cast<size_t>(n0 + row) * p.Kp + k0 : p.w;
  cp_async16(Bs + row * LDS + kseg * 16, src, valid);
}

__device__ __forceinline__ void store(const Params& p, int row, int col, int acc) {
  if (row >= p.M || col >= p.Cout) return;
  float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), p.m[col]), p.c[col]);
  if (p.relu) v = fmaxf(v, 0.0f);
  const size_t o = static_cast<size_t>(row) * p.Cout + col;
  if (p.out_kind == 0) {
    const int q = min(max(__float2int_rn(v), -127), 127);
    static_cast<int8_t*>(p.out)[o] = static_cast<int8_t>(q);
    return;
  }
  if (p.sout != nullptr) v = __fmul_rn(v, p.sout[col]);
  if (p.out_kind == 1)
    static_cast<float*>(p.out)[o] = v;
  else
    static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(v);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) int8_conv_kernel(const Params p) {
  __shared__ __align__(16) uint8_t smem[STAGES * (BM + BN) * LDS];
  uint8_t* a_ring = smem;
  uint8_t* b_ring = smem + STAGES * BM * LDS;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int hw = p.Ho * p.Wo;

  Row rows[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = m0 + (tid >> 2) + j * (BM / 2);
    rows[j].ok = m < p.M;
    const int b = m / hw, rem = m - (m / hw) * hw;
    const int oy = rem / p.Wo, ox = rem - (rem / p.Wo) * p.Wo;
    rows[j].b = b;
    rows[j].iy0 = oy * p.stride - p.pad_t;
    rows[j].ix0 = ox * p.stride - p.pad_l;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int k_tiles = (p.Kp + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) {
      load_a<VEC>(p, a_ring + s * BM * LDS, rows, tid, s);
      load_b(p, b_ring + s * BN * LDS, n0, tid, s);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt has landed for every thread; tile kt - 1's buffer is free
    const int next = kt + STAGES - 1;
    if (next < k_tiles) {
      load_a<VEC>(p, a_ring + (next % STAGES) * BM * LDS, rows, tid, next);
      load_b(p, b_ring + (next % STAGES) * BN * LDS, n0, tid, next);
    }
    cp_async_commit();

    const uint8_t* As = a_ring + (kt % STAGES) * BM * LDS;
    const uint8_t* Bs = b_ring + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint8_t* r = As + (wm * 32 + mt * 16 + g) * LDS + kk + t * 4;
        a[mt][0] = *reinterpret_cast<const unsigned*>(r);
        a[mt][1] = *reinterpret_cast<const unsigned*>(r + 8 * LDS);
        a[mt][2] = *reinterpret_cast<const unsigned*>(r + 16);
        a[mt][3] = *reinterpret_cast<const unsigned*>(r + 8 * LDS + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint8_t* r = Bs + (wn * 32 + nt * 8 + g) * LDS + kk + t * 4;
        b[nt][0] = *reinterpret_cast<const unsigned*>(r);
        b[nt][1] = *reinterpret_cast<const unsigned*>(r + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mt * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn * 32 + nt * 8 + t * 2 + (e & 1);
        store(p, row, col, acc[mt][nt][e]);
      }
}

}  // namespace

extern "C" int tmat_int8_conv(const void* x, const void* w, const void* m, const void* c, const void* sout,
                              void* out, int B, int H, int W, int Cin, int Cout, int kh, int stride, int pad_t,
                              int pad_l, int Ho, int Wo, int Kp, int relu, int out_kind, int vec, void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.m = static_cast<const float*>(m);
  p.c = static_cast<const float*>(c);
  p.sout = static_cast<const float*>(sout);
  p.out = out;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.kw = kh;
  p.stride = stride;
  p.pad_t = pad_t;
  p.pad_l = pad_l;
  p.Ho = Ho;
  p.Wo = Wo;
  p.K = kh * kh * Cin;
  p.Kp = Kp;
  p.M = B * Ho * Wo;
  p.relu = relu;
  p.out_kind = out_kind;
  const dim3 grid((p.M + BM - 1) / BM, (Cout + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    int8_conv_kernel<true><<<grid, THREADS, 0, s>>>(p);
  else
    int8_conv_kernel<false><<<grid, THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
