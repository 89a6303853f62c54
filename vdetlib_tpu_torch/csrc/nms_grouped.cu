// Exact greedy NMS over disjoint class groups sharing one slot axis (kernel B).
//
// Replaces the TPU kernel vdetlib_tpu/kernels/nms_pallas.py::nms_pallas_grouped
// (_fixpoint_kernel with group ids). Same keep set as
// vdetlib_tpu_torch/kernels/nms_grouped.py::nms_unsorted_fixpoint(groups=), the
// plain version beside this kernel's wrapper: slot j suppresses slot i iff
// IoU(i, j) > thresh (legacy +1 area offset, strict >), j precedes i in the
// greedy visit order (masked score desc, then index asc), both carry the same
// group id, and j is valid. The greedy keep set is the unique fixpoint of
// keep = valid & !any(adj[i] & keep), reached by Jacobi iteration in as many
// steps as the longest suppression chain.
//
// What bounds it on an H100: the IoUs and the block's barriers, not bytes.
// The fused dedup is T = 64-256 frames of N = 192 slots in 30 class groups
// (~150 valid, ~360 IoUs a frame needed); the stream's MGP dedup reaches it
// through batched_nms as 960 problems (32 frames x 30 classes) of 192 slots
// in one group (~11,000 IoUs each). A few hundred KB move either way.
//
// Design. One block per problem, `threads` (>= N, a multiple of 32, chosen
// by the wrapper: kernels/nms_grouped.py::launch_threads) so that the grid
// fills the card; the block body is nms_common.cuh::vdet_nms_block, shared
// with kernel C. Only valid slots matter (an invalid slot is never kept and
// never suppresses): the block compacts them, ranks them by (group, index)
// so that each group is one segment (the valid position where all share
// one group, else a count split between several threads a slot), and builds
// the adjacency in 32 x 32 warp tiles over that order: a lane a row, each
// pair's IoU once, the column's box broadcast to the warp, the reverse bits
// by ballot, no atomics; a tile whose rows and columns hold no common group
// is skipped, and a zero intersection skips the division. At 30 groups most
// tiles are skipped; at one group each pair is computed once, the least the
// fixpoint needs. The Jacobi steps follow: a thread a row, N/32 word ANDs,
// the keep set a bitmask from warp ballots, double buffered,
// __syncthreads_or as the convergence test, capped at N steps.
//
// Exactness: the keep set is a threshold decision on the IoU, so the IoU is
// computed in the reference's op order (vdetlib_tpu/geometry/boxes.py:47-57)
// with round-to-nearest intrinsics (nms_common.cuh), and this file is compiled with
// -fmad=false (no contraction of a*b+c into one rounding); never with
// --use_fast_math. The IoU is symmetric bit for bit, so computing it once a
// pair changes no decision. Group ids are compared, never used as indices,
// so any int32 is a group.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_common.cuh"

namespace {

constexpr int kMaxSlots = 512;
constexpr int kMaxThreads = 1024;
constexpr int kSmemDefault = 48 * 1024;  // above it only after an opt-in

__global__ void __launch_bounds__(kMaxThreads)
nms_grouped_kernel(const float* __restrict__ boxes,   // (B, N, 4)
                   const float* __restrict__ scores,  // (B, N)
                   const uint8_t* __restrict__ valid, // (B, N) bool
                   const int32_t* __restrict__ groups,// (B, N)
                   uint8_t* __restrict__ keep,        // (B, N) bool
                   int N, float thresh, float offset) {
    vdet_nms_block<true>(boxes, scores, valid, groups, keep, N, thresh, offset);
}

}  // namespace

// boxes (B, N, 4) f32 (16-byte aligned), scores (B, N) f32, valid (B, N)
// bool, groups (B, N) int32 → keep (B, N) bool; 1 <= N <= 512, `threads` a
// multiple of 32 in [N, 1024]. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a launch the kernel cannot take.
extern "C" int vdet_nms_grouped(const void* boxes, const void* scores, const void* valid,
                                const void* groups, void* keep, int B, int N, int threads,
                                float thresh, float offset, void* stream) {
    if (B < 1 || N < 1 || N > kMaxSlots || threads < N || threads > kMaxThreads ||
        threads % 32 != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int smem = vdet_nms_smem_bytes(N);
    if (smem > kSmemDefault) {
        const cudaError_t err = cudaFuncSetAttribute(
            nms_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    nms_grouped_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const float*>(scores),
        static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(groups),
        static_cast<uint8_t*>(keep), N, thresh, offset);
    return static_cast<int>(cudaGetLastError());
}
