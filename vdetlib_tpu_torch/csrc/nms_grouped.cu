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
// What bounds it on an H100: latency of the fixpoint's dependent steps, not
// bytes or flops. The production call is B = T = 256 frames of N = 192
// slots: ~9.4M IoUs in all, a few hundred KB in and out.
//
// Design: one block per problem (frame), one thread per slot (N padded to a
// multiple of 32, at most 512). Each thread builds its adjacency row once as
// a bitmask held in registers (N/32 <= 16 words); the keep set is a bitmask
// in shared memory, rebuilt every step from warp ballots and double
// buffered, so a Jacobi step is N/32 ANDs per thread plus one barrier
// (__syncthreads_or doubles as the convergence test). The step count is
// capped at N like the reference's loop.
//
// Exactness: the keep set is a threshold decision on the IoU, so the IoU is
// computed in the reference's op order (vdetlib_tpu/geometry/boxes.py:47-57)
// with round-to-nearest intrinsics, and this file is compiled with
// -fmad=false (no contraction of a*b+c into one rounding); never with
// --use_fast_math. Scores of invalid slots are masked to -inf for the
// precedence test only; validity itself comes from the mask, never from a
// sentinel value.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 512;
constexpr int kMaxWords = kMaxSlots / 32;

__device__ __forceinline__ float area_rn(float x1, float y1, float x2, float y2, float offset) {
    return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), offset), __fadd_rn(__fsub_rn(y2, y1), offset));
}

// IoU of boxes a and b, op for op as vdetlib_tpu/geometry/boxes.py::pairwise_iou.
__device__ __forceinline__ float iou_rn(float ax1, float ay1, float ax2, float ay2, float area_a,
                                        float bx1, float by1, float bx2, float by2, float area_b,
                                        float offset) {
    const float ix1 = fmaxf(ax1, bx1);
    const float iy1 = fmaxf(ay1, by1);
    const float ix2 = fminf(ax2, bx2);
    const float iy2 = fminf(ay2, by2);
    const float iw = fmaxf(__fadd_rn(__fsub_rn(ix2, ix1), offset), 0.f);
    const float ih = fmaxf(__fadd_rn(__fsub_rn(iy2, iy1), offset), 0.f);
    const float inter = __fmul_rn(iw, ih);
    const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
    return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__global__ void nms_grouped_kernel(const float* __restrict__ boxes,   // (B, N, 4)
                                   const float* __restrict__ scores,  // (B, N)
                                   const uint8_t* __restrict__ valid, // (B, N) bool
                                   const int32_t* __restrict__ groups,// (B, N)
                                   uint8_t* __restrict__ keep,        // (B, N) bool
                                   int N, float thresh, float offset) {
    __shared__ float sx1[kMaxSlots], sy1[kMaxSlots], sx2[kMaxSlots], sy2[kMaxSlots];
    __shared__ float sarea[kMaxSlots], sscore[kMaxSlots];
    __shared__ int32_t sgroup[kMaxSlots];
    __shared__ uint32_t svalid[kMaxWords];
    __shared__ uint32_t kbuf[2][kMaxWords];

    const int b = blockIdx.x;
    const int i = threadIdx.x;
    const int nw = (N + 31) / 32;
    const bool in = i < N;
    const size_t base = static_cast<size_t>(b) * N;

    bool vi = false;
    if (in) {
        const float* bx = boxes + (base + i) * 4;
        sx1[i] = bx[0];
        sy1[i] = bx[1];
        sx2[i] = bx[2];
        sy2[i] = bx[3];
        sarea[i] = area_rn(bx[0], bx[1], bx[2], bx[3], offset);
        vi = valid[base + i] != 0;
        sscore[i] = vi ? scores[base + i] : -INFINITY;
        sgroup[i] = groups[base + i];
    }
    const uint32_t vword = __ballot_sync(0xffffffffu, vi);
    if ((i & 31) == 0) {
        svalid[i >> 5] = vword;
        kbuf[0][i >> 5] = vword;  // Jacobi starts from keep = valid
    }
    __syncthreads();

    // adjacency row i: bit j set iff j suppresses i
    uint32_t row[kMaxWords];
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w) {
        uint32_t bits = 0;
        if (in && w < nw) {
            const float si = sscore[i];
            const int32_t gi = sgroup[i];
            const uint32_t vw = svalid[w];
            for (int l = 0; l < 32; ++l) {
                const int j = w * 32 + l;
                if (j >= N) break;
                if (!((vw >> l) & 1u) || sgroup[j] != gi) continue;
                const float sj = sscore[j];
                if (!(sj > si || (sj == si && j < i))) continue;
                const float v = iou_rn(sx1[i], sy1[i], sx2[i], sy2[i], sarea[i],
                                       sx1[j], sy1[j], sx2[j], sy2[j], sarea[j], offset);
                if (v > thresh) bits |= 1u << l;
            }
        }
        row[w] = bits;
    }

    bool ki = vi;
    int cur = 0;
    for (int it = 0; it < N; ++it) {
        bool sup = false;
#pragma unroll
        for (int w = 0; w < kMaxWords; ++w) {
            if (w < nw) sup |= (row[w] & kbuf[cur][w]) != 0u;
        }
        const bool nk = vi && !sup;
        const uint32_t kword = __ballot_sync(0xffffffffu, nk);
        if ((i & 31) == 0) kbuf[cur ^ 1][i >> 5] = kword;
        const int changed = __syncthreads_or(nk != ki);
        ki = nk;
        cur ^= 1;
        if (!changed) break;
    }
    if (in) keep[base + i] = ki ? 1 : 0;
}

}  // namespace

// boxes (B, N, 4) f32, scores (B, N) f32, valid (B, N) bool, groups (B, N)
// int32 → keep (B, N) bool. 1 <= N <= 512. Returns cudaGetLastError().
extern "C" int vdet_nms_grouped(const void* boxes, const void* scores, const void* valid,
                                const void* groups, void* keep, int B, int N, float thresh,
                                float offset, void* stream) {
    const int threads = ((N + 31) / 32) * 32;
    nms_grouped_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const float*>(scores),
        static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(groups),
        static_cast<uint8_t*>(keep), N, thresh, offset);
    return static_cast<int>(cudaGetLastError());
}
