// Int8 convolution (s8 x s8 -> s32) with a fused epilogue, for sm_90a.
//
// No Pallas kernel stands behind it: the JAX package computes this
// convolution with lax.conv_general_dilated(..., preferred_element_type=int32)
// (tmat_tpu/models/quant.py, forward_quant and forward_mixed), with the
// requantisation of its input and its epilogue as separate XLA passes. Here
// both run inside the kernel: the input may arrive as floats and be
// requantised while it is loaded, and the output may leave requantised for
// the next conv.
//
// Function (tmat_torch/ops/int8_conv.py has the plain version): x NHWC
// (B, H, W, Cin), int8, or float32 / bfloat16 with inv_sx[Cin]: then the A
// element is clip(rint(relu_in?(f32(x)) * inv_sx[ci]), -127, 127), and 0 in
// the padding. Weights packed (Cout, Kp), row n = output channel n's taps in
// (dy, dx, ci) order, zero beyond K = kh*kh*Cin; TF-SAME zero padding (pad_t,
// pad_l before; the rest implied by the bounds). Then per output channel n
//   v = f32(acc) * m[n] + c[n]  [relu]  and one of
//   int8:    clip(rint(v), -127, 127)
//   float:   v [* sout[n]] rounded to float32 / bfloat16
//   requant: clip(rint(f32(mid(v)) * inv_next[n]), -127, 127), mid() the
//            rounding to float32 or bfloat16: the next conv's int8 input.
// Built with -fmad=false and written with __fmul_rn/__fadd_rn, so every
// output is bit-equal to the plain version's.
//
// Both forms are implicit GEMMs: M = B*Ho*Wo output pixels, N = Cout, K =
// the taps. tmat_int8_conv's pick rule (wg::pick) chooses:
//
// The warpgroup form (namespace wg) takes the 3x3 stride-1 convs of int8 or
// bfloat16 inputs whose Cin and Cout are multiples of 128, on 16-byte
// aligned tensors: the mixed segmentor's six up convs. A CTA computes 256
// output rows x 128 channels with two consumer warpgroups of 128 rows (two
// wgmma row groups of 64 each, 128 accumulators a thread); a producer
// warpgroup gives up its registers (setmaxnreg) and one of its threads
// feeds the weights. K runs slab by slab (128 input channels) and within a
// slab tap by tap: a chunk is 128 bytes of K, one 128-byte swizzle row a
// pixel. Products are wgmma m64n128k32 s8 (both operands K-major, the only
// layout s8 takes), eight a chunk and warpgroup, each k-step 32 bytes
// further along the swizzle row.
//   Weights: TMA copies the chunk's 128 x 128 box of the packed matrix
//     (128-byte swizzle) into a ring of 3-6 stages (what shared memory
//     leaves) with full/empty mbarriers. Each CTA reads every weight once
//     for 256 rows: the weights are most of what it reads from L2.
//   Activations: rows run over the batch padded by one pixel on each side,
//     so that a tile row's tap (dy, dx) is the padded pixel dy * Wp + dx
//     rows further: the A operand of every tap is one buffer, the slab's
//     halo (the tile's rows and two padded image rows beyond), at another
//     start row. The halo is loaded and requantised once a slab instead of
//     once a tap (9x fewer loads and conversions): slab 0's by cp.async, all
//     in flight at once (a bfloat16 halo raw into the spare halo buffers,
//     then requantised), each next one by both consumer warpgroups in
//     ninths after each chunk's products are launched (two ninths in flight
//     in registers, a thread's eight input scales of the slab in registers)
//     into the third of three halo buffers, with a proxy fence and a barrier
//     at the slab's end; the tensor cores never drain between slabs. The
//     padded rows cost 5-21% more products (image widths 80 to 20); a tile
//     may span two images.
//   Epilogue: the tile is staged in shared memory, rows padded by 16 bytes
//     against bank conflicts, and each warpgroup writes its rows' pixels
//     with coalesced 16-byte stores.
// Its bound is int8 tensor-core operations at these widths; what holds it
// back is the weight and halo traffic from L2 and each CTA's first halo and
// epilogue, which no products overlap (PERF.md). Measured on an H100 and not
// kept: every tap's A rows loaded and requantised from L2 (about nine times
// the halo's loads), 128-row tiles (twice the weight traffic a product), and
// a cluster of two CTAs sharing each weight chunk by TMA multicast (the two
// CTAs then wait for each other).
//
// The mma.sync form takes everything else: the entry conv (Cin 1),
// widths off those multiples, float32 inputs, unaligned tensors. A block
// computes a 128 x 64 tile with 8 warps, each 32 x 32 with mma.sync
// m16n8k32; K runs in steps of 64 bytes through a 3-stage ring, rows 80
// bytes apart. An int8 batch with Cin a multiple of 16 arrives by 16-byte
// cp.async (zero-filled outside the image); anything else element by
// element, a float input requantised on the way.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

enum InKind { IN_S8 = 0, IN_F32 = 1, IN_BF16 = 2 };
enum OutKind { OUT_S8 = 0, OUT_F32 = 1, OUT_BF16 = 2, OUT_REQ_F32 = 3, OUT_REQ_BF16 = 4 };

struct Params {
  const void* x;
  const int8_t* w;
  const float* m;
  const float* c;
  const float* sout;
  const float* inv_sx;
  const float* inv_next;
  void* out;
  int B, H, W, Cin, Cout, kw, stride, pad_t, pad_l, Ho, Wo, K, Kp, M, relu, relu_in, out_kind;
  int Hp, Wp, HR, stages;  // the warpgroup form's padded image, its halo rows, its weight ring
};

__device__ __forceinline__ int clip127(int q) { return min(max(q, -127), 127); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// v = f32(acc) * m + c [relu]
__device__ __forceinline__ float affine(int acc, float m, float c, bool relu) {
  const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), m), c);
  return relu ? fmaxf(v, 0.0f) : v;
}

// the requantised output: v rounded to the float type, then to the next input scale
__device__ __forceinline__ int requant(float v, float inv, bool bf16_mid) {
  if (bf16_mid) v = __bfloat162float(__float2bfloat16_rn(v));
  return clip127(__float2int_rn(__fmul_rn(v, inv)));
}

// ---------------------------------------------------------------------------
// The mma.sync form
// ---------------------------------------------------------------------------

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int LDS = BK + 16;  // bytes between rows of a tile in shared memory

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

// element k of row `r`'s im2col row as int8 (0 in the padding and past K)
template <typename TIn>
__device__ __forceinline__ unsigned a_elem(const Params& p, const Row& r, int k) {
  if (!r.ok || k >= p.K) return 0u;
  const int tap = k / p.Cin;
  const int ci = k - tap * p.Cin;
  const int dy = tap / p.kw, dx = tap - (tap / p.kw) * p.kw;
  const int iy = r.iy0 + dy, ix = r.ix0 + dx;
  if (iy < 0 || iy >= p.H || ix < 0 || ix >= p.W) return 0u;
  const size_t i = ((static_cast<size_t>(r.b) * p.H + iy) * p.W + ix) * p.Cin + ci;
  int q;
  if constexpr (std::is_same<TIn, int8_t>::value) {
    q = static_cast<const int8_t*>(p.x)[i];
  } else {
    float v = to_f(static_cast<const TIn*>(p.x)[i]);
    if (p.relu_in) v = fmaxf(v, 0.0f);
    q = clip127(__float2int_rn(__fmul_rn(v, p.inv_sx[ci])));
  }
  return static_cast<unsigned>(static_cast<uint8_t>(q));
}

template <typename TIn, bool VEC>
__device__ __forceinline__ void load_a(const Params& p, uint8_t* As, const Row (&rows)[2], int tid, int k_tile) {
  const int kseg = tid & 3;
  const int k0 = k_tile * BK + kseg * 16;
  if constexpr (VEC) {
    int ci = 0, dy = 0, dx = 0;
    if (k0 < p.K) {
      const int tap = k0 / p.Cin;
      ci = k0 - tap * p.Cin;
      dy = tap / p.kw;
      dx = tap - dy * p.kw;
    }
    const int8_t* x = static_cast<const int8_t*>(p.x);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = (tid >> 2) + j * (BM / 2);
      const int iy = rows[j].iy0 + dy, ix = rows[j].ix0 + dx;
      const bool valid = rows[j].ok && k0 < p.K && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W;
      const int8_t* src =
          valid ? x + ((static_cast<size_t>(rows[j].b) * p.H + iy) * p.W + ix) * p.Cin + ci : x;
      cp_async16(As + row * LDS + kseg * 16, src, valid);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = (tid >> 2) + j * (BM / 2);
      unsigned words[4] = {0u, 0u, 0u, 0u};
      for (int e = 0; e < 16; ++e) words[e >> 2] |= a_elem<TIn>(p, rows[j], k0 + e) << (8 * (e & 3));
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
  const float v = affine(acc, p.m[col], p.c[col], p.relu);
  const size_t o = static_cast<size_t>(row) * p.Cout + col;
  switch (p.out_kind) {
    case OUT_S8:
      static_cast<int8_t*>(p.out)[o] = static_cast<int8_t>(clip127(__float2int_rn(v)));
      return;
    case OUT_F32:
      static_cast<float*>(p.out)[o] = p.sout != nullptr ? __fmul_rn(v, p.sout[col]) : v;
      return;
    case OUT_BF16:
      static_cast<bf16*>(p.out)[o] = __float2bfloat16_rn(p.sout != nullptr ? __fmul_rn(v, p.sout[col]) : v);
      return;
    default:
      static_cast<int8_t*>(p.out)[o] =
          static_cast<int8_t>(requant(v, p.inv_next[col], p.out_kind == OUT_REQ_BF16));
  }
}

template <typename TIn, bool VEC>
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
      load_a<TIn, VEC>(p, a_ring + s * BM * LDS, rows, tid, s);
      load_b(p, b_ring + s * BN * LDS, n0, tid, s);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt has landed for every thread; tile kt - 1's buffer is free
    const int next = kt + STAGES - 1;
    if (next < k_tiles) {
      load_a<TIn, VEC>(p, a_ring + (next % STAGES) * BM * LDS, rows, tid, next);
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

// ---------------------------------------------------------------------------
// The warpgroup form
// ---------------------------------------------------------------------------

namespace wg {

// tools/int8_conv_probe.py builds this file with TMAT_INT8_PROBE set to a
// mask of parts of the warpgroup form to leave out, to time the rest (the
// outputs are then wrong): 1 the epilogue's stores, 2 slab 0's halo, 4 the
// products, 8 the later slabs' halos, 16 the requantisation of a bfloat16
// halo. 0 in the library.
#ifndef TMAT_INT8_PROBE
#define TMAT_INT8_PROBE 0
#endif
__host__ __device__ constexpr bool keep(int part) { return !(TMAT_INT8_PROBE & part); }

constexpr int BM = 256;  // output rows of a tile: two warpgroups of 128, each two wgmma row groups of 64
constexpr int BN = 128;  // output channels of a tile
constexpr int BK = 128;  // bytes of K a chunk: 128 channels of one tap, one 128-byte swizzle row
constexpr int THREADS = 384;  // two consumer warpgroups and the producer's
// registers a thread: the producer warpgroup gives its registers to the
// consumers, whose accumulators (128 a thread) need them
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr uint32_t SMEM_MAX = 232448;  // the dynamic shared memory a block may have
constexpr int MIN_STAGES = 3, MAX_STAGES = 6;  // of the weight ring
// the A operand: int8 rows, or bfloat16 rows requantised with or without a relu first
enum AKind { A_S8 = 0, A_BF16 = 1, A_BF16_RELU = 2 };
// 16-byte input loads a thread makes for each chunk (of nine a slab) to
// bring the next slab's halo in: the halo may have 576 rows
__host__ __device__ constexpr int upt(int ak) { return ak == A_S8 ? 2 : 4; }
constexpr int MAX_HALO = 9 * 256 * 4 / 16;

// Byte offsets in dynamic shared memory, from a 1024-byte aligned base:
// the weight ring, three halo buffers, then the epilogue's per-column vectors
// (m, c, sout or inv_next), the input scales, and the halo rows' and tile
// rows' pixel tables. The epilogue stages its tile over ring and halos.
struct Layout {
  uint32_t halo, halo_bytes, vec, scales, src, orow, bars, total;
};
__host__ __device__ inline uint32_t align_up(uint32_t v, uint32_t a) { return (v + a - 1) / a * a; }
__host__ __device__ inline Layout layout(int n_stages, int halo_rows, int cin) {
  Layout L;
  L.halo = uint32_t(n_stages) * BN * BK;
  L.halo_bytes = align_up(uint32_t(halo_rows) * BK, 1024);
  L.vec = L.halo + 3 * L.halo_bytes;
  L.scales = L.vec + 3 * BN * 4;
  L.src = L.scales + cin * 4;
  L.orow = L.src + align_up(halo_rows * 4, 16);
  L.bars = L.orow + BM * 4;
  L.total = L.bars + 2 * MAX_STAGES * 8 + 1024;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// make this thread's shared-memory writes visible to wgmma's reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival, and `bytes` more to be counted off by the copies that name this barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
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
// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
// TMA: the box of the tensor map at (c0, c1) -> shared memory, counted off on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* tm, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(tm), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// shared-memory matrix descriptor of a K-major operand in 128-byte swizzled
// rows, 8-row groups 1024 bytes apart. The swizzle follows the address's
// own bits, as the halo's stores and the TMA write it, so the rows may start
// anywhere in a 1024-byte pattern (a tap's shift of the halo) with the base
// offset field left 0 (setting it to the start's row in the pattern was
// measured wrong on an H100).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

#define TMAT_R8(o)                                                                                       \
  "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]), "+r"(d[o + 4]), "+r"(d[o + 5]), \
      "+r"(d[o + 6]), "+r"(d[o + 7])

// d[64 x 128] (+)= A[64 x 32] @ B[32 x 128]^T, s8 x s8 -> s32, both K-major
// in shared memory; d is kept when scale_d is not 0, overwritten when it is 0
struct Wgmma {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : TMAT_R8(0), TMAT_R8(8), TMAT_R8(16), TMAT_R8(24), TMAT_R8(32), TMAT_R8(40), TMAT_R8(48), TMAT_R8(56)
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

#undef TMAT_R8

// keeps reads of the accumulators behind the wait that completes them
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// clip(rint(v * s), -127, 127) in the low byte of a float's bits: the clip
// first (rint is monotone and +-127 are integers), then adding 1.5 * 2^23
// rounds half to even to an integer held in the low mantissa bits
template <bool RELU>
__device__ __forceinline__ uint32_t q_bits(float v, float s) {
  float t = fminf(__fmul_rn(v, s), 127.0f);
  if (!RELU) t = fmaxf(t, -127.0f);
  return __float_as_uint(__fadd_rn(t, 12582912.0f));
}

// eight bfloat16 inputs (one 16-byte load) -> eight int8 A bytes; the relu
// on the bfloat16 pairs (exact: relu commutes with the widening)
template <bool RELU>
__device__ __forceinline__ uint2 quant8(const uint4& raw, const float (&s)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t q[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t v = w[i];
    if (RELU) {
      __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
      h = __hmax2(h, __float2bfloat162_rn(0.0f));
      v = *reinterpret_cast<const uint32_t*>(&h);
    }
    q[2 * i] = q_bits<RELU>(__uint_as_float(v << 16), s[2 * i]);
    q[2 * i + 1] = q_bits<RELU>(__uint_as_float(v & 0xFFFF0000u), s[2 * i + 1]);
  }
  return make_uint2(__byte_perm(__byte_perm(q[0], q[1], 0x0040), __byte_perm(q[2], q[3], 0x0040), 0x5410),
                    __byte_perm(__byte_perm(q[4], q[5], 0x0040), __byte_perm(q[6], q[7], 0x0040), 0x5410));
}

// The tile's outputs from the accumulators: staged row by row in shared
// memory (rows BN * size + 16 bytes apart), then written by each warpgroup
// for its 128 rows with 16-byte stores to the pixels that the rows are.
template <int KIND>
__device__ __forceinline__ void epilogue(const Params& p, int (&acc)[2][64], unsigned char* smem, const float* vec,
                                         const int* orow, int n0, int wg, int w4, int lane) {
  using OutT = typename std::conditional<KIND == OUT_F32, float,
                                         typename std::conditional<KIND == OUT_BF16, bf16, int8_t>::type>::type;
  constexpr int ESZ = sizeof(OutT);
  constexpr int LDO = BN * ESZ + 16;
  const bool relu = p.relu;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int r0 = wg * 128 + g * 64 + w4 * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
      const float2 mm = *reinterpret_cast<const float2*>(vec + col);
      const float2 cc = *reinterpret_cast<const float2*>(vec + BN + col);
      const float2 ee = *reinterpret_cast<const float2*>(vec + 2 * BN + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = affine(acc[g][4 * j + 2 * h], mm.x, cc.x, relu);
        const float v1 = affine(acc[g][4 * j + 2 * h + 1], mm.y, cc.y, relu);
        unsigned char* dst = smem + (r0 + 8 * h) * LDO + col * ESZ;
        if constexpr (KIND == OUT_F32) {
          *reinterpret_cast<float2*>(dst) = make_float2(__fmul_rn(v0, ee.x), __fmul_rn(v1, ee.y));
        } else if constexpr (KIND == OUT_BF16) {
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __nv_bfloat162(__float2bfloat16_rn(__fmul_rn(v0, ee.x)), __float2bfloat16_rn(__fmul_rn(v1, ee.y)));
        } else {
          int q0, q1;
          if constexpr (KIND == OUT_S8) {
            q0 = clip127(__float2int_rn(v0));
            q1 = clip127(__float2int_rn(v1));
          } else {
            q0 = requant(v0, ee.x, KIND == OUT_REQ_BF16);
            q1 = requant(v1, ee.y, KIND == OUT_REQ_BF16);
          }
          *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>((q0 & 0xFF) | ((q1 & 0xFF) << 8));
        }
      }
    }
  }
  named_sync(1 + wg, 128);  // the warpgroup's rows are staged
  constexpr int CHUNKS = BN * ESZ / 16;  // 16-byte pieces of a row
  unsigned char* out = static_cast<unsigned char*>(p.out);
#pragma unroll 4
  for (int i = w4 * 32 + lane; i < 128 * CHUNKS; i += 128) {
    const int r = wg * 128 + i / CHUNKS, ch = i % CHUNKS;
    const int m = orow[r];
    if (m >= 0 && keep(1))
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(m) * p.Cout + n0) * ESZ + ch * 16) =
          *reinterpret_cast<const uint4*>(smem + r * LDO + ch * 16);
  }
}

// A consumer warpgroup: 128 rows of the tile and their products, and with
// the other warpgroup the halo of each slab and the outputs.
template <int AK>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, const Layout& L, uint32_t full,
                                        uint32_t empty, int n0, int warp, int lane) {
  constexpr int UPT = upt(AK);
  constexpr int ESZ = AK == A_S8 ? 1 : 2;
  constexpr int UNITS = BK * ESZ / 16, EPU = 16 / ESZ;  // 16-byte loads a halo row; input elements a load
  const uint32_t sbase = smem_u32(smem), ring = sbase, halo = sbase + L.halo;
  const float* scales = reinterpret_cast<const float*>(smem + L.scales);
  const int* src = reinterpret_cast<const int*>(smem + L.src);
  const int wg = warp >> 2, w4 = warp & 3, th = warp * 32 + lane;
  const int S = p.Cin / BK, KC = 9 * S, units = p.HR * UNITS;
  const unsigned char* x = static_cast<const unsigned char*>(p.x);
  auto gsrc = [&](int pix, int s, int u) {
    return x + (static_cast<size_t>(pix) * p.Cin + s * BK + u * EPU) * ESZ;
  };
  // A thread always takes the same 16-byte piece u = th % UNITS of a halo
  // row (256 is a multiple of UNITS): its eight input scales of a slab stay
  // in registers.
  float scl[8];
  auto load_scales = [&](int s) {
    if constexpr (AK != A_S8) {
      const float* sp = scales + s * BK + (th % UNITS) * 8;
      const float4 s0 = *reinterpret_cast<const float4*>(sp), s1 = *reinterpret_cast<const float4*>(sp + 4);
      scl[0] = s0.x, scl[1] = s0.y, scl[2] = s0.z, scl[3] = s0.w;
      scl[4] = s1.x, scl[5] = s1.y, scl[6] = s1.z, scl[7] = s1.w;
    }
  };
  // 16-byte piece u of halo row `row`, swizzled: piece c of a row at c ^ (row % 8)
  auto put = [&](uint32_t buf, int row, int u, const uint4& v) {
    if constexpr (AK == A_S8) {
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(buf + row * BK + ((u ^ (row & 7)) << 4)),
                   "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    } else {
      const uint2 q = keep(16) ? quant8<AK == A_BF16_RELU>(v, scl) : make_uint2(v.x, v.y);
      const uint32_t dst = buf + row * BK + ((((u >> 1) ^ (row & 7)) << 4) | ((u & 1) << 3));
      asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(dst), "r"(q.x), "r"(q.y) : "memory");
    }
  };
  // unit j of ninth `part` of slab s's halo
  auto load = [&](uint4 (&r)[UPT], int s, int part) {
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      const int idx = (part * UPT + j) * 256 + th;
      const int pix = idx < units ? src[idx / UNITS] : -1;
      r[j] = pix >= 0 ? __ldg(reinterpret_cast<const uint4*>(gsrc(pix, s, idx % UNITS))) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store = [&](const uint4 (&r)[UPT], int part, uint32_t buf) {
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      const int idx = (part * UPT + j) * 256 + th;
      if (idx < units) put(buf, idx / UNITS, idx % UNITS, r[j]);
    }
  };

  // Slab 0's halo by cp.async, all in flight at once: int8 rows straight
  // into halo buffer 0; bfloat16 rows into buffers 1-2 as they are, then
  // requantised into buffer 0.
  const uint32_t stage = AK == A_S8 ? halo : halo + L.halo_bytes;
  for (int idx = th; idx < units; idx += 256) {
    const int row = idx / UNITS, u = idx % UNITS, pix = src[row];
    const uint32_t dst = AK == A_S8 ? stage + row * BK + ((u ^ (row & 7)) << 4) : stage + idx * 16;
    if (keep(2)) cp_async16(dst, pix >= 0 ? gsrc(pix, 0, u) : x, pix >= 0 ? 16 : 0);
  }
  cp_async_wait_all();
  if constexpr (AK != A_S8) {
    named_sync(3, 256);  // the raw rows are in place
    load_scales(0);
    for (int idx = th; idx < units; idx += 256) {
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(stage + idx * 16));
      if (keep(2)) put(halo, idx / UNITS, idx % UNITS, v);
    }
  }
  // The next slab's halo comes in ninths, two in flight: ninth g (of all the
  // slabs' after the first, counted from 9) in ra when g is even, rb when odd.
  uint4 ra[UPT], rb[UPT];
  int ls = 1, lp = 0;  // the slab and ninth to load next
  auto load_next = [&](uint4 (&r)[UPT]) {
    if (ls < S) load(r, ls, lp);
    if (++lp == 9) lp = 0, ++ls;
  };
  load_next(rb);
  load_next(ra);
  fence_async_proxy();
  named_sync(3, 256);  // slab 0's halo is in place, the raw rows are read

  int acc[2][64];
  int st = 0, prev_st = 0, s = 0, t = 0, tap_row = 0;  // tap_row: dy * Wp + dx
  uint32_t ph = 0;
  for (int i = 0; i < KC; ++i) {
    mbar_wait(full + 8 * st, ph);
    const uint32_t a = halo + (s % 3) * L.halo_bytes + (wg * 128 + tap_row) * BK, b = ring + st * (BN * BK);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const uint64_t db = make_desc(b + ks * 32);
      if (keep(4)) {
        Wgmma::run(acc[0], make_desc(a + ks * 32), db, i | ks);
        Wgmma::run(acc[1], make_desc(a + 64 * BK + ks * 32), db, i | ks);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // chunk i - 1's products are done: its weight stage is free
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * prev_st);
    }
    if (keep(8) && s + 1 < S) {  // a ninth of the next slab's halo, into the buffer slab s - 2 left
      const uint32_t buf = halo + ((s + 1) % 3) * L.halo_bytes;
      if (t == 0) load_scales(s + 1);
      if ((s + 1 + t) & 1) {  // ninth (s + 1) * 9 + t is odd
        store(rb, t, buf);
        load_next(rb);
      } else {
        store(ra, t, buf);
        load_next(ra);
      }
    }
    prev_st = st;
    if (++st == p.stages) st = 0, ph ^= 1;
    tap_row += (t % 3 == 2) ? p.Wp - 2 : 1;
    if (++t == 9) {  // the next slab's halo is in place (for both warpgroups)
      fence_async_proxy();
      named_sync(3, 256);
      t = 0, tap_row = 0, ++s;
    }
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);
  named_sync(3, 256);  // both warpgroups' products are done: the epilogue stages over ring and halos
  const float* vec = reinterpret_cast<const float*>(smem + L.vec);
  const int* orow = reinterpret_cast<const int*>(smem + L.orow);
  switch (p.out_kind) {
    case OUT_S8: epilogue<OUT_S8>(p, acc, smem, vec, orow, n0, wg, w4, lane); break;
    case OUT_F32: epilogue<OUT_F32>(p, acc, smem, vec, orow, n0, wg, w4, lane); break;
    case OUT_BF16: epilogue<OUT_BF16>(p, acc, smem, vec, orow, n0, wg, w4, lane); break;
    case OUT_REQ_F32: epilogue<OUT_REQ_F32>(p, acc, smem, vec, orow, n0, wg, w4, lane); break;
    default: epilogue<OUT_REQ_BF16>(p, acc, smem, vec, orow, n0, wg, w4, lane);
  }
}

template <int AK>
__global__ void __launch_bounds__(THREADS, 1) wg_conv_kernel(const __grid_constant__ CUtensorMap tm_w, const Params p) {
  extern __shared__ unsigned char smem_dyn[];
  unsigned char* smem = smem_dyn + ((1024u - (smem_u32(smem_dyn) & 1023u)) & 1023u);
  const Layout L = layout(p.stages, p.HR, p.Cin);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + L.bars, empty = full + 8 * MAX_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = p.Cout / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN, q0 = (blockIdx.x / n_tiles) * BM;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  const bool req = p.out_kind == OUT_REQ_F32 || p.out_kind == OUT_REQ_BF16;
  for (int i = tid; i < BN; i += THREADS) {
    vec[i] = p.m[n0 + i];
    vec[BN + i] = p.c[n0 + i];
    vec[2 * BN + i] = req ? p.inv_next[n0 + i] : p.sout != nullptr ? p.sout[n0 + i] : 1.0f;
  }
  if (AK != A_S8)
    for (int i = tid; i < p.Cin; i += THREADS) reinterpret_cast<float*>(smem + L.scales)[i] = p.inv_sx[i];
  // Rows run over the batch padded by one pixel on each side (Hp x Wp an
  // image): tile row r is output pixel q0 + r where that is inside an image,
  // and the halo row r is padded pixel q0 + r, zero outside the image, so
  // that tap (dy, dx) of tile row r is halo row r + dy * Wp + dx.
  const int img = p.Hp * p.Wp;
  int* src = reinterpret_cast<int*>(smem + L.src);
  for (int r = tid; r < p.HR; r += THREADS) {
    const int q = q0 + r, b = q / img, y = (q - b * img) / p.Wp, xx = q - b * img - y * p.Wp;
    src[r] = b < p.B && y >= 1 && y <= p.H && xx >= 1 && xx <= p.W ? (b * p.H + y - 1) * p.W + xx - 1 : -1;
  }
  int* orow = reinterpret_cast<int*>(smem + L.orow);
  for (int r = tid; r < BM; r += THREADS) {
    const int q = q0 + r, b = q / img, y = (q - b * img) / p.Wp, xx = q - b * img - y * p.Wp;
    orow[r] = b < p.B && y < p.H && xx < p.W ? (b * p.H + y) * p.W + xx : -1;
  }
  __syncthreads();

  if (warp >= 8) {  // the producer: the weights' chunks by TMA through the ring, slab by slab, tap by tap
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == 8 && lane == 0) {
      int st = 0, k0 = 0, t = 0;
      uint32_t ph = 0;
      for (int i = 0; i < 9 * (p.Cin / BK); ++i) {
        if (i >= p.stages) mbar_wait(empty + 8 * st, ph ^ 1);  // its previous chunk's products are done
        mbar_expect_tx(full + 8 * st, BN * BK);
        tma_load_2d(sbase + st * (BN * BK), &tm_w, k0, n0, full + 8 * st);
        if (++st == p.stages) st = 0, ph ^= 1;
        k0 += p.Cin;  // the next tap's channels of this slab, or the next slab's first tap
        if (++t == 9) t = 0, k0 += BK - 9 * p.Cin;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume<AK>(p, smem, L, full, empty, n0, warp, lane);
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime: the library links
// against no libcuda symbol
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The tensor map of the packed (Cout, Kp) int8 weights: boxes of 128 bytes
// of K by `rows` output channels, written with the 128-byte swizzle.
inline bool weight_map(CUtensorMap* tm, const void* w, int Kp, int Cout, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {cuuint64_t(Kp), cuuint64_t(Cout)}, strides[1] = {cuuint64_t(Kp)};
  const cuuint32_t box[2] = {BK, cuuint32_t(rows)}, elem[2] = {1, 1};
  return encode(tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int AK>
cudaError_t launch(const Params& p, cudaStream_t s) {
  CUtensorMap tm;
  if (!weight_map(&tm, p.w, p.Kp, p.Cout, BN)) return cudaErrorInvalidValue;
  auto kern = wg_conv_kernel<AK>;
  const uint32_t smem = layout(p.stages, p.HR, p.Cin).total;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  // tile rows cover the padded batch up to its last output pixel
  const int rows = (p.B - 1) * p.Hp * p.Wp + (p.H - 1) * p.Wp + p.W;
  const int grid = (rows + BM - 1) / BM * (p.Cout / BN);
  kern<<<grid, THREADS, smem, s>>>(tm, p);
  return cudaGetLastError();
}

inline int halo_rows(int W) { return BM + 2 * (W + 2) + 2; }

// The weight ring's depth for the warpgroup form, 0 where the form does not
// apply. It takes int8 or bfloat16 inputs of 3x3 stride-1 convs whose Cin
// and Cout are multiples of 128 and whose halo (a tile and two padded image
// rows) fits beside a ring of 3 stages or more: the mixed segmentor's up
// convs. A library built with TMAT_INT8_MMA_SYNC_ONLY takes the mma.sync
// form only (to time one form against the other).
inline int pick(int in_kind, int Cin, int Cout, int kh, int stride, int W) {
#ifdef TMAT_INT8_MMA_SYNC_ONLY
  return 0;
#endif
  if (in_kind == IN_F32 || kh != 3 || stride != 1 || Cin % BK || Cout % BN || halo_rows(W) > MAX_HALO) return 0;
  for (int st = MAX_STAGES; st >= MIN_STAGES; --st) {
    const Layout L = layout(st, halo_rows(W), Cin);
    if (L.total <= SMEM_MAX && L.vec >= BM * (BN * 4 + 16)) return st;  // the f32 epilogue's staging fits too
  }
  return 0;
}

}  // namespace wg

inline bool aligned16_all(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  return true;
}

// What this thread's last call launched: 3 for the warpgroup form, 1 for
// the mma.sync form with cp.async loads of the batch, 2 for it loading
// element by element; 0 before the first launch and after a call that
// launched nothing.
thread_local int last_launch_code = 0;

cudaError_t dispatch(const Params& p, int in_kind, cudaStream_t s) {
  const int stages = wg::pick(in_kind, p.Cin, p.Cout, p.kw, p.stride, p.W);
  if (stages && aligned16_all({p.x, p.w, p.out})) {
    last_launch_code = 3;
    Params q = p;
    q.stages = stages;
    if (in_kind == IN_S8) return wg::launch<wg::A_S8>(q, s);
    return p.relu_in ? wg::launch<wg::A_BF16_RELU>(q, s) : wg::launch<wg::A_BF16>(q, s);
  }
  const dim3 grid((p.M + BM - 1) / BM, (p.Cout + BN - 1) / BN);
  if (in_kind == IN_S8 && p.Cin % 16 == 0 && aligned16_all({p.x})) {
    last_launch_code = 1;
    int8_conv_kernel<int8_t, true><<<grid, THREADS, 0, s>>>(p);
  } else {
    last_launch_code = 2;
    if (in_kind == IN_S8)
      int8_conv_kernel<int8_t, false><<<grid, THREADS, 0, s>>>(p);
    else if (in_kind == IN_F32)
      int8_conv_kernel<float, false><<<grid, THREADS, 0, s>>>(p);
    else
      int8_conv_kernel<bf16, false><<<grid, THREADS, 0, s>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in_kind: 0 int8, 1 float32, 2 bfloat16 (then inv_sx, and relu_in); out_kind:
// 0 int8, 1 float32, 2 bfloat16 (sout may be null), 3 / 4 int8 requantised by
// inv_next through a float32 / bfloat16 rounding. Returns cudaGetLastError()
// after the launch (0 on success).
int tmat_int8_conv(const void* x, const void* w, const void* m, const void* c, const void* sout, const void* inv_sx,
                   const void* inv_next, void* out, int B, int H, int W, int Cin, int Cout, int kh, int stride,
                   int pad_t, int pad_l, int Ho, int Wo, int Kp, int relu, int relu_in, int in_kind, int out_kind,
                   void* stream) {
  last_launch_code = 0;
  if (in_kind < IN_S8 || in_kind > IN_BF16 || out_kind < OUT_S8 || out_kind > OUT_REQ_BF16)
    return int(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.m = static_cast<const float*>(m);
  p.c = static_cast<const float*>(c);
  p.sout = static_cast<const float*>(sout);
  p.inv_sx = static_cast<const float*>(inv_sx);
  p.inv_next = static_cast<const float*>(inv_next);
  p.out = out;
  p.B = B;
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
  p.relu_in = relu_in;
  p.out_kind = out_kind;
  p.Hp = H + 2;
  p.Wp = W + 2;
  p.HR = wg::halo_rows(W);
  return int(dispatch(p, in_kind, static_cast<cudaStream_t>(stream)));
}

// The form a call with 16-byte aligned tensors takes, coded as
// tmat_int8_conv_last_launch codes it.
int tmat_int8_conv_form(int in_kind, int Cin, int Cout, int kh, int stride, int W) {
  if (wg::pick(in_kind, Cin, Cout, kh, stride, W)) return 3;
  return in_kind == IN_S8 && Cin % 16 == 0 ? 1 : 2;
}

// The form that the calling thread's last tmat_int8_conv launched (see
// last_launch_code), its tensors' alignment included.
int tmat_int8_conv_last_launch() { return last_launch_code; }

}  // extern "C"
