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
// at 8 x 1024^2.
//
// Design: one CTA of 256 threads owns a 32x32 output tile of one stack and
// loops over the slices. The reflected source row and column of each of the
// tile's 40 rows and columns are computed once into shared memory, so no
// padded copy of the stack exists: the stack is read once in its own type
// (plus the tile halos, which mostly hit in L2) and the projection written
// once. Each stage writes a shared tile the next stage reads across
// threads; best score and best value stay in registers. The taps are summed
// left to right, rows before columns, zero taps skipped, as the TPU kernel
// does, and the file is compiled with -fmad=false, so every intermediate
// rounds as in the plain PyTorch version (ops/focus_stack.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 4;
constexpr int IN = TILE + 2 * HALO;  // 40: input tile with the full support
constexpr int MID = TILE + 4;        // 36: blurred tile with the Laplacian's halo
constexpr int THREADS = 256;
constexpr int PER_THREAD = TILE * TILE / THREADS;

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

template <typename In>
__global__ void __launch_bounds__(THREADS)
focus_stack_kernel(const In* __restrict__ stack, const int* __restrict__ z_counts,
                   In* __restrict__ out, int Z, int H, int W) {
    __shared__ int s_row[IN];
    __shared__ int s_col[IN];
    __shared__ float s_in[IN * IN];        // source pixels
    __shared__ float s_rb[MID * IN];       // blurred along rows
    __shared__ float s_bl[MID * MID];      // blurred
    __shared__ float s_dr[TILE * MID];     // deriv along rows of the blurred tile
    __shared__ float s_sr[TILE * MID];     // smooth along rows of the blurred tile

    const int tid = threadIdx.x;
    const int b = blockIdx.z;
    const int row0 = blockIdx.y * TILE;
    const int col0 = blockIdx.x * TILE;

    if (tid < IN) {
        s_row[tid] = reflect101(row0 - HALO + tid, H);
    } else if (tid < 2 * IN) {
        s_col[tid - IN] = reflect101(col0 - HALO + tid - IN, W);
    }
    __syncthreads();

    float best[PER_THREAD];
    float val[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
        best[k] = -INFINITY;
        val[k] = 0.0f;
    }

    const size_t plane = (size_t)H * (size_t)W;
    const In* src = stack + (size_t)b * (size_t)Z * plane;
    const int z_count = z_counts[b];

    for (int z = 0; z < z_count; ++z, src += plane) {
        for (int e = tid; e < IN * IN; e += THREADS) {
            const int r = e / IN, c = e - r * IN;
            s_in[e] = (float)src[(size_t)s_row[r] * W + s_col[c]];
        }
        __syncthreads();
        for (int e = tid; e < MID * IN; e += THREADS) {
            s_rb[e] = blur5(s_in[e], s_in[e + IN], s_in[e + 2 * IN], s_in[e + 3 * IN],
                            s_in[e + 4 * IN]);
        }
        __syncthreads();
        for (int e = tid; e < MID * MID; e += THREADS) {
            const int r = e / MID, c = e - r * MID;
            const float* p = s_rb + r * IN + c;
            s_bl[e] = blur5(p[0], p[1], p[2], p[3], p[4]);
        }
        __syncthreads();
        for (int e = tid; e < TILE * MID; e += THREADS) {
            const float a = s_bl[e], bb = s_bl[e + MID], c = s_bl[e + 2 * MID],
                        d = s_bl[e + 3 * MID], f = s_bl[e + 4 * MID];
            s_dr[e] = deriv5(a, c, f);
            s_sr[e] = smooth5(a, bb, c, d, f);
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < PER_THREAD; ++k) {
            const int e = tid + k * THREADS;
            const int r = e / TILE, c = e - r * TILE;
            const float* pd = s_dr + r * MID + c;
            const float* ps = s_sr + r * MID + c;
            const float dyy = smooth5(pd[0], pd[1], pd[2], pd[3], pd[4]);
            const float dxx = deriv5(ps[0], ps[2], ps[4]);
            const float score = fabsf(dyy + dxx);
            if (score > best[k]) {
                best[k] = score;
                val[k] = s_in[(r + HALO) * IN + c + HALO];
            }
        }
        __syncthreads();  // the next slice overwrites s_in
    }

#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
        const int e = tid + k * THREADS;
        const int r = row0 + e / TILE, c = col0 + e % TILE;
        if (r < H && c < W) {
            out[(size_t)b * plane + (size_t)r * W + c] = (In)val[k];
        }
    }
}

template <typename In>
int launch(const void* stack, const int* z_counts, void* out, int B, int Z, int H, int W,
           cudaStream_t stream) {
    const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
    focus_stack_kernel<In><<<grid, THREADS, 0, stream>>>(
        static_cast<const In*>(stack), z_counts, static_cast<In*>(out), Z, H, W);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = uint8, 1 = uint16, 2 = float32. Returns the launch's CUDA error
// code (0 = launched); -1 for a dtype or grid this kernel does not take.
extern "C" int tmat_focus_stack(const void* stack, const int* z_counts, void* out, int B, int Z,
                                int H, int W, int dtype, void* stream) {
    if (B < 1 || Z < 1 || H < 1 || W < 1 || B > 65535 || (H + TILE - 1) / TILE > 65535) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<uint8_t>(stack, z_counts, out, B, Z, H, W, s);
        case 1: return launch<uint16_t>(stack, z_counts, out, B, Z, H, W, s);
        case 2: return launch<float>(stack, z_counts, out, B, Z, H, W, s);
        default: return -1;
    }
}
