// Bilinear resize + BGR mean subtract of uint8 frames (kernel E).
//
// Replaces the TPU kernel vdetlib_tpu/kernels/preprocess.py::
// fused_resize_normalize_pallas. Same function as the plain version beside
// this kernel's wrapper (kernels/preprocess.py::fused_resize_normalize):
// out[b, p, q, c] = (sum_w Wx[q, w] * (sum_h Wy[p, h] * x[b, h, w, c]) - mean[c]) * scale,
// with Wy, Wx the align_corners=False interpolation matrices. Each matrix row
// has at most two non-zero taps (lo, hi), and the wrapper passes exactly those
// float32 entries of the same numpy matrix the plain version contracts with,
// so the dense sums differ from this one only by exact zero terms.
//
// What bounds it on an H100: bytes. The staged detector's call, 8 frames of
// 360x480x3 uint8 to 240x320x3 float32, reads 4.1 MB and writes 7.4 MB
// (3.4 us at 3.35 TB/s) for 11 float32 operations per output value (0.04 us
// at the float32 peak).
//
// Design. The TPU kernel ran both contractions as MXU matmuls over a planar
// (C, H, W) copy of each frame. Here one thread owns one output pixel and its
// three channels: it reads the 2x2 source pixels of its taps straight from
// the NHWC frame (no planar transpose), blends along H first, then along W,
// as the plain version's einsums do, and writes 12 contiguous bytes. A block
// owns part of one output row (the grid's y and z are the row and the
// frame, so no thread divides an index), so a warp's reads hit two source
// rows and its writes are one contiguous span.
//
// Exactness: compiled with -fmad=false, so every product and sum rounds once
// in the plain version's order; with exact zero terms dropped the result
// differs from the dense float32 einsums only where those sum in another
// order than (lo + hi), i.e. in the last bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// grid (ceil(Wo / kThreads), Ho, B): block (x, p, b) owns output row p of
// frame b, one thread per output column q
__global__ void __launch_bounds__(kThreads)
resize_normalize_kernel(const uint8_t* __restrict__ frames,  // (B, H, W, 3)
                        const int* __restrict__ ylo, const int* __restrict__ yhi,
                        const float* __restrict__ wylo, const float* __restrict__ wyhi,
                        const int* __restrict__ xlo, const int* __restrict__ xhi,
                        const float* __restrict__ wxlo, const float* __restrict__ wxhi,
                        float* __restrict__ out,  // (B, Ho, Wo, 3)
                        int H, int W, int Ho, int Wo, float m0, float m1, float m2,
                        float scale) {
    const int q = blockIdx.x * kThreads + threadIdx.x;
    if (q >= Wo) return;
    const int p = blockIdx.y;
    const int b = blockIdx.z;
    const int y0 = ylo[p], y1 = yhi[p], x0 = xlo[q] * 3, x1 = xhi[q] * 3;
    const float a0 = wylo[p], a1 = wyhi[p], c0 = wxlo[q], c1 = wxhi[q];
    const uint8_t* f = frames + static_cast<size_t>(b) * H * W * 3;
    const uint8_t* r0 = f + static_cast<size_t>(y0) * W * 3;
    const uint8_t* r1 = f + static_cast<size_t>(y1) * W * 3;
    const float mean[3] = {m0, m1, m2};
    float* o = out + ((static_cast<size_t>(b) * Ho + p) * Wo + q) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        // contract H: rows = Wy[p, lo] * x[lo] + Wy[p, hi] * x[hi], per source column
        const float u0 = __fadd_rn(__fmul_rn(a0, static_cast<float>(r0[x0 + c])),
                                   __fmul_rn(a1, static_cast<float>(r1[x0 + c])));
        const float u1 = __fadd_rn(__fmul_rn(a0, static_cast<float>(r0[x1 + c])),
                                   __fmul_rn(a1, static_cast<float>(r1[x1 + c])));
        // contract W, then normalize
        const float v = __fadd_rn(__fmul_rn(c0, u0), __fmul_rn(c1, u1));
        o[c] = __fmul_rn(__fsub_rn(v, mean[c]), scale);
    }
}

}  // namespace

// frames (B, H, W, 3) uint8 → out (B, Ho, Wo, 3) float32; taps as int32 /
// float32 arrays of length Ho (y) and Wo (x). Returns cudaGetLastError().
extern "C" int vdet_resize_normalize(const void* frames, const void* ylo, const void* yhi,
                                     const void* wylo, const void* wyhi, const void* xlo,
                                     const void* xhi, const void* wxlo, const void* wxhi,
                                     void* out, int B, int H, int W, int Ho, int Wo, float m0,
                                     float m1, float m2, float scale, void* stream) {
    const dim3 grid((Wo + kThreads - 1) / kThreads, Ho, B);
    resize_normalize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(frames), static_cast<const int*>(ylo),
        static_cast<const int*>(yhi), static_cast<const float*>(wylo),
        static_cast<const float*>(wyhi), static_cast<const int*>(xlo),
        static_cast<const int*>(xhi), static_cast<const float*>(wxlo),
        static_cast<const float*>(wxhi), static_cast<float*>(out), H, W, Ho, Wo, m0, m1, m2, scale);
    return static_cast<int>(cudaGetLastError());
}
