// Lanczos-4 resize of a (Z, H, W) stack to (Z, h, w) for Hopper (sm_90a),
// one launch a stack.
//
// No TPU kernel is behind it: the JAX package resizes the invasion
// classifier's slices in numpy on the host (tmat_tpu/models/preprocess.py:71-81,
// prep_inv_depth_imgs_hybrid: two dense float32 GEMMs). This kernel computes
// the same function on the card, so the inv_depth tool uploads the raw stack
// instead of resizing on the dispatching thread (ops/resize_lanczos4.py).
//
// Function: out[z] = round_clip(Wv . in[z] . Wh^T), the vertical pass first,
// as the host's two GEMMs are ordered; Wv (h x H) and Wh (w x W) are
// lanczos4_weight_matrix's float32 weights. Every product and the
// intermediate are float32; integer inputs are rounded half to even (rintf)
// and clipped to their dtype's range, float32 inputs are stored as summed.
//
// Weights arrive in banded form, built by the wrapper from the dense
// matrices' own nonzeros: for each output row, the first nonzero column,
// the number of taps up to the last nonzero one, and those taps, padded to
// the widest band (32 taps at 1024 -> 256; 7 at an unchanged size). So the
// kernel leaves out only products the dense GEMMs multiply by zero. Bands
// start and end in nondecreasing columns (the wrapper checks it), so a tile
// of outputs reads one rectangle of the input.
//
// What bounds it on this card: a uint8 8 x 1024^2 stack is 8.39 MB in and
// 0.52 MB out (2.7 us at 3.35 TB/s); its 84 M multiply-adds are 2.5 us of
// the CUDA cores at 67 TFLOP/s. The taps are read from shared memory, about
// one a multiply-add, and the loop waits on those reads: the kernel takes
// ~46 us there, ~0.3% of a stack's time in the inv_depth tool.
//
// Design: a CTA of 256 threads owns a TH x TW output tile of one slice. It
// loads the input rows its tile needs, across the columns the tile's bands
// cover, into shared memory as float32 (converted once, not once a tap),
// runs the vertical pass into a TH x span float32 tile in shared memory,
// then the horizontal pass into the output. Warps own rows and lanes own
// columns, so a warp's taps and band bounds are uniform and its global
// reads and writes contiguous. The wrapper picks TH, TW and the number of
// input rows loaded at once (RC) so that all of it fits in 72 KB (three
// CTAs an SM); where the tile's rows do not fit at once (a large downsample)
// they are loaded in chunks of RC rows and the vertical sums carry over in
// the intermediate tile. The tile's taps are staged in shared memory too. A
// lane loads four input rows before it stores them, so their latencies
// overlap; a lane of the vertical pass sums five columns at once and one of
// the horizontal pass two rows, so each tap's weight is read once for them.
// Each output's taps are summed in ascending index with fmaf, chunks in
// ascending order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// Tried at 8 x 1024^2 uint8 -> 256^2 on an H100 (700 W): 4 or 5 columns a
// lane, 1-12 rows a load, taps unrolled by 1-8. These were fastest: 46 us,
// against 72 us with 4 / 1 / 1. Five columns cover a tile's 156 input
// columns in one sweep of a warp.
constexpr int VCOLS = 5;    // columns a lane sums at once in the vertical pass
constexpr int SROWS = 4;    // input rows a lane loads at once
constexpr int KUNROLL = 4;  // taps a loop step

template <typename T> __device__ __forceinline__ T store(float v);
template <> __device__ __forceinline__ uint8_t store<uint8_t>(float v) {
    return (uint8_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}
template <> __device__ __forceinline__ uint16_t store<uint16_t>(float v) {
    return (uint16_t)fminf(fmaxf(rintf(v), 0.0f), 65535.0f);
}
template <> __device__ __forceinline__ float store<float>(float v) { return v; }

struct Band {
    const int* first;   // [out] first input index of each output's taps
    const int* count;   // [out] its taps, up to the last nonzero weight
    const float* w;     // [out][k] the taps' weights, zero beyond count
    int k;
};

template <typename In>
__global__ void __launch_bounds__(THREADS)
resize_lanczos4_kernel(const In* __restrict__ in, In* __restrict__ out, int H, int W, int h, int w,
                       Band bv, Band bh, int TH, int TW, int RC, int CP) {
    extern __shared__ __align__(16) float smem[];
    float* s_v = smem;                 // [TH][CP]: the vertical pass
    float* s_in = s_v + TH * CP;       // [RC][CP]: input rows as float32
    float* s_wh = s_in + RC * CP;      // [bh.k][TW]: the tile's horizontal taps, transposed
    float* s_wv = s_wh + bh.k * TW;    // [TH][bv.k]: its vertical taps

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
    const int th = min(TH, h - i0), tw = min(TW, w - j0);
    const int r_lo = bv.first[i0], r_hi = bv.first[i0 + th - 1] + bv.count[i0 + th - 1];
    const int c_lo = bh.first[j0], cs = bh.first[j0 + tw - 1] + bh.count[j0 + tw - 1] - c_lo;
    const In* src = in + (size_t)blockIdx.z * H * W + c_lo;

    for (int e = threadIdx.x; e < bh.k * tw; e += THREADS) {
        const int k = e / tw, j = e - k * tw;
        s_wh[k * TW + j] = bh.w[(size_t)(j0 + j) * bh.k + k];
    }
    for (int e = threadIdx.x; e < th * bv.k; e += THREADS) s_wv[e] = bv.w[(size_t)i0 * bv.k + e];
    for (int a = r_lo; a < r_hi; a += RC) {
        const int n = min(RC, r_hi - a);
        if (a != r_lo) __syncthreads();  // the pass over the chunk before is over
        for (int q0 = warp; q0 < n; q0 += SROWS * WARPS) {
            for (int c = lane; c < cs; c += 32) {
                float v[SROWS];
#pragma unroll
                for (int u = 0; u < SROWS; ++u) {
                    const int q = q0 + u * WARPS;
                    v[u] = q < n ? (float)src[(size_t)(a + q) * W + c] : 0.0f;
                }
#pragma unroll
                for (int u = 0; u < SROWS; ++u)
                    if (q0 + u * WARPS < n) s_in[(q0 + u * WARPS) * CP + c] = v[u];
            }
        }
        __syncthreads();
        for (int r = warp; r < th; r += WARPS) {
            const int s = bv.first[i0 + r], cnt = bv.count[i0 + r];
            const int k0 = max(0, a - s), k1 = min(cnt, a + n - s);
            const float* wr = s_wv + r * bv.k;
            const int x0 = (s - a) * CP;  // tap k of this row is chunk row s + k - a
            float* vr = s_v + r * CP;
            for (int c = lane; c < cs; c += VCOLS * 32) {  // VCOLS columns a lane, one tap load
                bool live[VCOLS];
                float acc[VCOLS];
#pragma unroll
                for (int u = 0; u < VCOLS; ++u) {
                    live[u] = c + 32 * u < cs;
                    acc[u] = a == r_lo || !live[u] ? 0.0f : vr[c + 32 * u];
                }
#pragma unroll KUNROLL
                for (int k = k0; k < k1; ++k) {
                    const float wk = wr[k];
                    const float* xk = s_in + x0 + k * CP + c;
#pragma unroll
                    for (int u = 0; u < VCOLS; ++u)
                        if (live[u]) acc[u] = fmaf(wk, xk[32 * u], acc[u]);
                }
#pragma unroll
                for (int u = 0; u < VCOLS; ++u)
                    if (live[u]) vr[c + 32 * u] = acc[u];
            }
        }
    }
    __syncthreads();
    In* dst = out + ((size_t)blockIdx.z * h + i0) * w + j0;
    for (int j = lane; j < tw; j += 32) {
        const int s = bh.first[j0 + j] - c_lo, cnt = bh.count[j0 + j];
        for (int r = warp; r < th; r += 2 * WARPS) {  // two rows a lane, one tap load
            const bool two = r + WARPS < th;
            const float* v0 = s_v + r * CP + s;
            const float* v1 = v0 + WARPS * CP;
            float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll KUNROLL
            for (int k = 0; k < cnt; ++k) {
                const float wk = s_wh[k * TW + j];
                acc0 = fmaf(wk, v0[k], acc0);
                if (two) acc1 = fmaf(wk, v1[k], acc1);
            }
            dst[(size_t)r * w + j] = store<In>(acc0);
            if (two) dst[(size_t)(r + WARPS) * w + j] = store<In>(acc1);
        }
    }
}

template <typename In>
int launch(const void* in, void* out, int Z, int H, int W, int h, int w, Band bv, Band bh, int TH,
           int TW, int RC, int CP, cudaStream_t stream) {
    auto kern = resize_lanczos4_kernel<In>;
    const int smem = (int)sizeof(float) * ((TH + RC) * CP + bh.k * TW + TH * bv.k);
    const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, Z);
    kern<<<grid, THREADS, smem, stream>>>(static_cast<const In*>(in), static_cast<In*>(out), H, W, h, w,
                                          bv, bh, TH, TW, RC, CP);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = uint8, 1 = uint16, 2 = float32. v_* and h_* are the vertical
// (h outputs over H) and horizontal (w over W) bands on the device. TH x TW
// is the output tile, RC the input rows loaded at once, CP the widest
// tile's input columns (the shared-memory pitch). Returns the launch's CUDA
// error code (0 = launched); -1 for a dtype or grid this kernel does not take.
extern "C" int tmat_resize_lanczos4(const void* in, void* out, int Z, int H, int W, int h, int w,
                                    const int* v_first, const int* v_count, const float* v_w, int v_k,
                                    const int* h_first, const int* h_count, const float* h_w, int h_k,
                                    int TH, int TW, int RC, int CP, int dtype, void* stream) {
    if (Z < 1 || H < 1 || W < 1 || h < 1 || w < 1 || TH < 1 || TW < 1 || RC < 1 || CP < 1 ||
        Z > 65535 || (h + TH - 1) / TH > 65535)
        return -1;
    const Band bv{v_first, v_count, v_w, v_k}, bh{h_first, h_count, h_w, h_k};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<uint8_t>(in, out, Z, H, W, h, w, bv, bh, TH, TW, RC, CP, s);
        case 1: return launch<uint16_t>(in, out, Z, H, W, h, w, bv, bh, TH, TW, RC, CP, s);
        case 2: return launch<float>(in, out, Z, H, W, h, w, bv, bh, TH, TW, RC, CP, s);
        default: return -1;
    }
}
