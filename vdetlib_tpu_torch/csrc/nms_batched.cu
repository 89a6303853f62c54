// Exact greedy NMS for many independent problems of at most 128 slots (kernel C).
//
// Replaces the TPU kernel vdetlib_tpu/kernels/nms_pallas.py::nms_pallas_fixpoint
// (both of its variants, _fixpoint2d_kernel and _fixpoint_kernel: they are
// TPU layouts of one function). Same keep set as
// vdetlib_tpu_torch/kernels/nms_grouped.py::nms_unsorted_fixpoint, the plain
// version beside this kernel's wrapper (kernels/nms_batched.py): slot j
// suppresses slot i iff IoU(i, j) > thresh (legacy +1 area offset, strict >),
// j precedes i in the greedy visit order (masked score desc, then index asc)
// and j is valid. The greedy keep set is the unique fixpoint of
// keep = valid & !any(adj[i] & keep), reached by Jacobi iteration in as many
// steps as the longest suppression chain.
//
// What bounds it on an H100: neither bytes nor flops. The stream's call is
// B = 32 frames x 30 classes = 960 problems of N = 64 slots: ~1.1M IoUs the
// fixpoint needs (~17 MFLOP, well under 1 us at the float32 peak) and 1.3
// MB in and out (0.4 us at 3.35 TB/s). What is left is latency: each
// problem's chain of dependent phases and steps, and the launch.
//
// Design. The TPU kernel packs 128/N problems side by side in one 128-lane
// row; on Hopper that layout buys nothing. Here one block owns one problem
// and runs kernel B's block body (nms_common.cuh::vdet_nms_block) without
// groups: it compacts the valid slots in index order, builds the adjacency
// in 32 x 32 warp tiles (a lane a row, each pair's IoU once, the column's
// box broadcast to the warp, the reverse bits by ballot), a warp a tile,
// and runs the Jacobi steps with a thread a row. The wrapper sizes the
// block (kernels/nms_grouped.py::launch_threads): at the stream's 64 slots,
// three warps for the three tiles, so no warp walks more than 32 columns.
//
// Exactness: the IoU is computed in the reference's op order with
// round-to-nearest intrinsics (nms_common.cuh), and this file is compiled
// with -fmad=false; never with --use_fast_math. The IoU is symmetric bit
// for bit, so computing it once a pair changes no decision.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_common.cuh"

namespace {

constexpr int kMaxN = 128;
constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads)
nms_batched_kernel(const float* __restrict__ boxes,    // (B, N, 4)
                   const float* __restrict__ scores,   // (B, N)
                   const uint8_t* __restrict__ valid,  // (B, N) bool
                   uint8_t* __restrict__ keep,         // (B, N) bool
                   int N, float thresh, float offset) {
    vdet_nms_block<false>(boxes, scores, valid, nullptr, keep, N, thresh, offset);
}

}  // namespace

// boxes (B, N, 4) f32 (16-byte aligned), scores (B, N) f32, valid (B, N)
// bool → keep (B, N) bool; 1 <= N <= 128, `threads` a multiple of 32 in
// [N, 1024]. Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// launch the kernel cannot take.
extern "C" int vdet_nms_batched(const void* boxes, const void* scores, const void* valid,
                                void* keep, int B, int N, int threads, float thresh,
                                float offset, void* stream) {
    if (B < 1 || N < 1 || N > kMaxN || threads < N || threads > kMaxThreads ||
        threads % 32 != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    nms_batched_kernel<<<B, threads, vdet_nms_smem_bytes(N),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const float*>(scores),
        static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), N, thresh, offset);
    return static_cast<int>(cudaGetLastError());
}
