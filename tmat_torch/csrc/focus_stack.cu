// Focus-stacking Z projection for Hopper (sm_90a), one launch per batch.
//
// Replaces the Pallas TPU kernel tmat_tpu/ops/pallas_zproj.py::_focus_kernel.
// Per pixel, over the first z_count slices of a (B, Z, H, W) stack:
//   5-tap binomial blur (1,4,6,4,1)/16 along rows, then along columns ->
//   ksize-5 Laplacian = deriv (1,0,-2,0,1) x smooth (1,4,6,4,1) along each
//   axis, the two summed -> score = |Laplacian| -> a strict-greater running
//   update from -inf keeps the source pixel of the best score (the first
//   slice of the largest score). The border is REFLECT_101, 4 pixels deep,
//   and keeps reflecting on images smaller than the support.
//
// What bounds it on this card: at 26 multiply-adds and a compare (53 f32
// operations) per pixel and slice against one byte read (uint8), the CUDA
// cores, not the memory, set the least time; both are a few microseconds
// at 8 x 1024^2. Compiled without FMA contraction, every one of those
// operations is an instruction of its own.
//
// Design: one CTA of 256 threads owns a 32 x 120 output tile of one stack and
// loops over the slices. Each of the four 1-D passes runs along its own axis
// from a sliding 5-window in registers, one shared-memory read and one write
// per element (plus 4 to fill a window), where the first kernel read every
// tap from shared memory:
//   P1  blur down the columns of the 40 x 128 source tile   (256 column halves)
//   P2  blur along the rows of the result                   (252 row pieces)
//   P3  deriv5 and smooth5 down the columns of the blurred  (248 column halves)
//   P4  smooth5 / deriv5 along the rows of those, |sum|, and the running
//       best score and source pixel of 15 outputs in registers (256 row pieces)
// with one barrier between passes: four a slice, not five. Row-direction
// passes read down a column of the tile across a warp, so the float tiles
// have an odd pitch. The source tile is double-buffered over Z in its own
// type: an interior tile of a stack whose rows are 4-element aligned is
// fetched with cp.async (4 elements a copy: 4, 8 or 16 bytes) while the
// slice before is scored; a border tile, a partial tile, an image smaller
// than the support or an unaligned stack goes through the REFLECT_101 index
// tables into registers before the passes and into the buffer after them.
// Two CTAs share an SM (128 registers a thread): with one, or with three
// and spills, the same stacks take longer.
// No padded copy of the stack exists. The projection leaves through shared
// memory, so that its rows are written contiguously.
//
// The taps are summed left to right, rows before columns, zero taps skipped,
// as the TPU kernel does, and the file is compiled with -fmad=false, so every
// intermediate rounds as in the plain PyTorch version (ops/focus_stack.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TH = 32;               // output tile rows
constexpr int TW = 120;              // output tile columns
constexpr int HALO = 4;
constexpr int IH = TH + 2 * HALO;    // 40: source tile with the full support
constexpr int IW = TW + 2 * HALO;    // 128
constexpr int MH = TH + 4;           // 36: blurred tile with the Laplacian's halo
constexpr int MW = TW + 4;           // 124
constexpr int THREADS = 256;
constexpr int RAW_PITCH = 132;       // source tile pitch, elements: a multiple of 4, 33 words for uint8
constexpr int FP = 129;              // float tile pitch: odd, so a column read spreads over the banks
constexpr int PRE = IH * IW / THREADS;  // 20 source elements a thread fetches through the tables
constexpr int P2_LEN = 18, P2_PIECES = (MW + P2_LEN - 1) / P2_LEN;  // 7 pieces a row
constexpr int P4_LEN = 15, P4_PIECES = TW / P4_LEN;                 // 8 pieces a row
static_assert(IH * IW % THREADS == 0 && 2 * IW == THREADS && TW % P4_LEN == 0 && TH * P4_PIECES == THREADS,
              "the passes' task counts follow the tile");

template <typename In> constexpr size_t smem_bytes() {
    return sizeof(float) * (2 * MH * FP + TH * FP) + sizeof(In) * 2 * IH * RAW_PITCH;
}

// index of the REFLECT_101 image of i on an axis of length n, reflecting
// as often as needed (period 2(n-1)); an axis of length 1 repeats its pixel
__device__ __forceinline__ int reflect101(int i, int n) {
    if (n == 1) return 0;
    const int period = 2 * (n - 1);
    int m = i % period;
    if (m < 0) m += period;
    return m < n ? m : period - m;
}

__device__ __forceinline__ float blur5(float a, float b, float c, float d, float e) {
    float o = 0.0625f * a;
    o = o + 0.25f * b;
    o = o + 0.375f * c;
    o = o + 0.25f * d;
    o = o + 0.0625f * e;
    return o;
}

__device__ __forceinline__ float smooth5(float a, float b, float c, float d, float e) {
    float o = a;
    o = o + 4.0f * b;
    o = o + 6.0f * c;
    o = o + 4.0f * d;
    o = o + e;
    return o;
}

__device__ __forceinline__ float deriv5(float a, float c, float e) {
    float o = a;
    o = o + -2.0f * c;
    o = o + e;
    return o;
}

// BYTES (4, 8 or 16) global -> shared, asynchronously
template <int BYTES> __device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES) : "memory");
}

template <typename In>
__global__ void __launch_bounds__(THREADS, 2)
focus_stack_kernel(const In* __restrict__ stack, const int* __restrict__ z_counts,
                   In* __restrict__ out, int Z, int H, int W) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* t_a = reinterpret_cast<float*>(smem);  // [MH][FP]: P1's blur, then P3's deriv
    float* t_b = t_a + MH * FP;                   // [MH][FP]: the blurred tile
    float* t_s = t_b + MH * FP;                   // [TH][FP]: P3's smooth
    In* raw = reinterpret_cast<In*>(t_s + TH * FP);  // [2][IH][RAW_PITCH]: source tiles
    __shared__ int s_row[IH];
    __shared__ int s_col[IW];

    const int tid = threadIdx.x;
    const int b = blockIdx.z;
    const int row0 = blockIdx.y * TH;
    const int col0 = blockIdx.x * TW;

    if (tid < IH) s_row[tid] = reflect101(row0 - HALO + tid, H);
    if (tid >= IW) s_col[tid - IW] = reflect101(col0 - HALO + tid - IW, W);

    // an interior tile of a stack whose rows and base are 4-element aligned
    const bool async = row0 >= HALO && row0 + TH + HALO <= H && col0 >= HALO &&
                       col0 + TW + HALO <= W && W % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(stack) % (4 * sizeof(In)) == 0;

    const size_t plane = (size_t)H * (size_t)W;
    const In* src = stack + (size_t)b * (size_t)Z * plane;
    // depths from the device are not seen by the host: held to 1..Z here, so
    // that none reads past the stack or leaves the projection unwritten
    const int z_count = z_counts ? min(max(z_counts[b], 1), Z) : Z;

    In pre[PRE];
    // start the fetch of a slice: copies in flight, or loads into registers
    auto fetch = [&](const In* slice, In* dst) {
        if (async) {
            const In* from = slice + (size_t)(row0 - HALO) * W + (col0 - HALO);
            for (int v = tid; v < IH * (IW / 4); v += THREADS) {
                const int r = v / (IW / 4), k = v % (IW / 4);
                cp_async<4 * sizeof(In)>(dst + r * RAW_PITCH + 4 * k, from + (size_t)r * W + 4 * k);
            }
            asm volatile("cp.async.commit_group;\n" ::: "memory");
        } else {
#pragma unroll
            for (int k = 0; k < PRE; ++k) {
                const int e = tid + k * THREADS;
                pre[k] = slice[(size_t)s_row[e / IW] * W + s_col[e % IW]];
            }
        }
    };
    // finish it: the tile is in `dst` for this thread's part
    auto land = [&](In* dst) {
        if (async) {
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        } else {
#pragma unroll
            for (int k = 0; k < PRE; ++k) {
                const int e = tid + k * THREADS;
                dst[(e / IW) * RAW_PITCH + e % IW] = pre[k];
            }
        }
    };

    float best[P4_LEN];
    float val[P4_LEN];
#pragma unroll
    for (int k = 0; k < P4_LEN; ++k) {
        best[k] = -INFINITY;
        val[k] = 0.0f;
    }

    __syncthreads();  // the index tables
    fetch(src, raw);
    land(raw);

    for (int z = 0; z < z_count; ++z) {
        In* cur = raw + (z & 1) * IH * RAW_PITCH;
        In* nxt = raw + ((z + 1) & 1) * IH * RAW_PITCH;
        __syncthreads();  // slice z is in `cur`; the pass that read `nxt` is over
        const bool more = z + 1 < z_count;
        if (more) fetch(src + (size_t)(z + 1) * plane, nxt);

        {   // P1: blur down a column half of the source tile
            const int c = tid % IW, r0 = (tid / IW) * (MH / 2);
            const In* p = cur + r0 * RAW_PITCH + c;
            float w0 = (float)p[0], w1 = (float)p[RAW_PITCH], w2 = (float)p[2 * RAW_PITCH],
                  w3 = (float)p[3 * RAW_PITCH];
#pragma unroll
            for (int i = 0; i < MH / 2; ++i) {
                const float w4 = (float)p[(i + 4) * RAW_PITCH];
                t_a[(r0 + i) * FP + c] = blur5(w0, w1, w2, w3, w4);
                w0 = w1, w1 = w2, w2 = w3, w3 = w4;
            }
        }
        __syncthreads();
        if (tid < MH * P2_PIECES) {  // P2: blur along a row piece
            const int r = tid % MH, c0 = (tid / MH) * P2_LEN;
            const float* p = t_a + r * FP + c0;
            float w0 = p[0], w1 = p[1], w2 = p[2], w3 = p[3];
#pragma unroll
            for (int i = 0; i < P2_LEN; ++i) {
                if (c0 + i < MW) {
                    const float w4 = p[i + 4];
                    t_b[r * FP + c0 + i] = blur5(w0, w1, w2, w3, w4);
                    w0 = w1, w1 = w2, w2 = w3, w3 = w4;
                }
            }
        }
        __syncthreads();
        if (tid < 2 * MW) {  // P3: deriv5 and smooth5 down a column half of the blurred tile
            const int c = tid % MW, r0 = (tid / MW) * (TH / 2);
            const float* p = t_b + r0 * FP + c;
            float w0 = p[0], w1 = p[FP], w2 = p[2 * FP], w3 = p[3 * FP];
#pragma unroll
            for (int i = 0; i < TH / 2; ++i) {
                const float w4 = p[(i + 4) * FP];
                t_a[(r0 + i) * FP + c] = deriv5(w0, w2, w4);
                t_s[(r0 + i) * FP + c] = smooth5(w0, w1, w2, w3, w4);
                w0 = w1, w1 = w2, w2 = w3, w3 = w4;
            }
        }
        __syncthreads();
        {   // P4: the Laplacian along a row piece, and the running best
            const int r = tid % TH, c0 = (tid / TH) * P4_LEN;
            const float* pd = t_a + r * FP + c0;
            const float* ps = t_s + r * FP + c0;
            const In* pv = cur + (r + HALO) * RAW_PITCH + c0 + HALO;
            float d0 = pd[0], d1 = pd[1], d2 = pd[2], d3 = pd[3];
            float s0 = ps[0], s1 = ps[1], s2 = ps[2], s3 = ps[3];
#pragma unroll
            for (int i = 0; i < P4_LEN; ++i) {
                const float d4 = pd[i + 4], s4 = ps[i + 4];
                const float dyy = smooth5(d0, d1, d2, d3, d4);
                const float dxx = deriv5(s0, s2, s4);
                const float score = fabsf(dyy + dxx);
                if (score > best[i]) {
                    best[i] = score;
                    val[i] = (float)pv[i];
                }
                d0 = d1, d1 = d2, d2 = d3, d3 = d4;
                s0 = s1, s1 = s2, s2 = s3, s3 = s4;
            }
        }
        if (more) land(nxt);
    }

    // the projection leaves through the blurred tile's space (P3 is over)
    In* t_out = reinterpret_cast<In*>(t_b);  // [TH][TW]
    {
        const int r = tid % TH, c0 = (tid / TH) * P4_LEN;
#pragma unroll
        for (int i = 0; i < P4_LEN; ++i) t_out[r * TW + c0 + i] = (In)val[i];
    }
    __syncthreads();
    for (int e = tid; e < TH * TW; e += THREADS) {
        const int r = row0 + e / TW, c = col0 + e % TW;
        if (r < H && c < W) out[(size_t)b * plane + (size_t)r * W + c] = t_out[e];
    }
}

template <typename In>
int launch(const void* stack, const int* z_counts, void* out, int B, int Z, int H, int W,
           cudaStream_t stream) {
    auto kern = focus_stack_kernel<In>;
    const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem_bytes<In>());
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
    kern<<<grid, THREADS, smem_bytes<In>(), stream>>>(
        static_cast<const In*>(stack), z_counts, static_cast<In*>(out), Z, H, W);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = uint8, 1 = uint16, 2 = float32. z_counts: B device ints (values
// outside 1..Z count as the nearer end), or null for the full depth Z of
// every stack. Returns the launch's CUDA
// error code (0 = launched); -1 for a dtype or grid this kernel does not take.
extern "C" int tmat_focus_stack(const void* stack, const int* z_counts, void* out, int B, int Z,
                                int H, int W, int dtype, void* stream) {
    if (B < 1 || Z < 1 || H < 1 || W < 1 || B > 65535 || (H + TH - 1) / TH > 65535) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<uint8_t>(stack, z_counts, out, B, Z, H, W, s);
        case 1: return launch<uint16_t>(stack, z_counts, out, B, Z, H, W, s);
        case 2: return launch<float>(stack, z_counts, out, B, Z, H, W, s);
        default: return -1;
    }
}
