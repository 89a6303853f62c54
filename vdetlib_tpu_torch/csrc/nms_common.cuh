// Box area and IoU shared by the NMS kernels (B, C, D).
//
// Keep sets are threshold decisions on the IoU, so every kernel rounds it
// exactly like the reference: the op order of
// vdetlib_tpu/geometry/boxes.py::pairwise_iou (and of the port's
// geometry/boxes.py), each add/sub/mul/div rounded on its own through the
// _rn intrinsics. Files that include this header are compiled with
// -fmad=false and never with --use_fast_math. The IoU is symmetric bit for
// bit (max/min and the area sum commute), so either box may come first.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float vdet_area_rn(float x1, float y1, float x2, float y2,
                                              float offset) {
    return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), offset), __fadd_rn(__fsub_rn(y2, y1), offset));
}

__device__ __forceinline__ float vdet_inter_rn(float ax1, float ay1, float ax2, float ay2,
                                               float bx1, float by1, float bx2, float by2,
                                               float offset) {
    const float ix1 = fmaxf(ax1, bx1);
    const float iy1 = fmaxf(ay1, by1);
    const float ix2 = fminf(ax2, bx2);
    const float iy2 = fminf(ay2, by2);
    const float iw = fmaxf(__fadd_rn(__fsub_rn(ix2, ix1), offset), 0.f);
    const float ih = fmaxf(__fadd_rn(__fsub_rn(iy2, iy1), offset), 0.f);
    return __fmul_rn(iw, ih);
}

__device__ __forceinline__ float vdet_iou_rn(float ax1, float ay1, float ax2, float ay2,
                                             float area_a, float bx1, float by1, float bx2,
                                             float by2, float area_b, float offset) {
    const float inter = vdet_inter_rn(ax1, ay1, ax2, ay2, bx1, by1, bx2, by2, offset);
    const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
    return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

// vdet_iou_rn(a, b) > thresh, decided without the division where the
// answer is certain (kernels/nms_grouped.py::iou_exceeds is its model on the
// CPU). With q = inter / uni exact and RN(q) the rounded IoU:
// - inter == 0: the IoU is exactly 0 (0 / uni, or 0 where uni <= 0), so the
//   answer is 0 > thresh, for every thresh;
// - otherwise, where 2^-60 <= thresh <= 2^60 and 2^-60 <= uni <= 2^60 (so
//   every product below is a normal float), with t_hi = RN(thresh (1 +
//   2^-20)) and t_lo = RN(thresh (1 - 2^-20)): inter > RN(t_hi uni) gives
//   q > thresh (1 + 2^-21), so RN(q) >= q (1 - 2^-24) > thresh; inter <
//   RN(t_lo uni) gives q < thresh (1 - 2^-21), so RN(q) < thresh (each
//   rounding moves a value by at most 2^-24 of it);
// - in the band between, and outside those ranges, the IoU is divided as
//   vdet_iou_rn divides it.
struct VdetIouThresh {
    float thresh, t_lo, t_hi;
    bool filter;  // thresh within [2^-60, 2^60]
    bool zero_over;  // 0 > thresh
};

__device__ __forceinline__ VdetIouThresh vdet_iou_thresh(float thresh) {
    return {thresh, __fmul_rn(thresh, 1.f - 0x1p-20f), __fmul_rn(thresh, 1.f + 0x1p-20f),
            thresh >= 0x1p-60f && thresh <= 0x1p60f, 0.f > thresh};
}

__device__ __forceinline__ bool vdet_iou_above_rn(float4 a, float area_a, float4 b,
                                                  float area_b, float offset,
                                                  const VdetIouThresh& th) {
    const float inter = vdet_inter_rn(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, offset);
    const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
    const float hi = __fmul_rn(th.t_hi, uni);
    const float lo = __fmul_rn(th.t_lo, uni);
    const bool zero = inter == 0.f;
    const bool sure = zero || (th.filter && uni >= 0x1p-60f && uni <= 0x1p60f &&
                               (inter > hi || inter < lo));
    if (sure) return zero ? th.zero_over : inter > hi;
    return (uni > 0.f ? __fdiv_rn(inter, uni) : 0.f) > th.thresh;
}

// One warp's tile of a problem's adjacency (B, C): the pairs (r, j), r in
// the 32 rows of word R, j in the 32 columns of word w >= R, j > r, of the
// n_v valid slots held in (group, index) order, both of one group when
// `group` is given. Lane l owns row r = 32 R + l and walks the columns: each
// pair's IoU is computed once (it is symmetric bit for bit), j's box comes
// to every lane at once (a shared-memory broadcast), and the pair sets the
// bit of the slot that is suppressed. j has the higher index, so j precedes
// r iff its score is higher (bit j of row r, word w: the lane's own word)
// and r precedes j iff its score is higher or equal (bit r of row j, word R:
// one ballot a column, kept by lane j - 32 w); with a NaN score neither
// precedes. The tile writes words (rows of R, w) and (rows of w, R), each
// of which no other tile writes, so the adjacency needs no clearing and no
// atomics; a tile with no pair of one group writes zeros.
__device__ __forceinline__ void vdet_adjacency_tile(const float4* box, const float* area,
                                                    const float* score, const int* group,
                                                    uint32_t* adj, int nw, int n_v, int R,
                                                    int w, const VdetIouThresh& th,
                                                    float offset) {
    const int lane = threadIdx.x & 31;
    const int r = 32 * R + lane;
    const bool row = r < n_v;
    int jn = min(32, n_v - 32 * w);  // columns of word w
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float area_a = 0.f, sr = 0.f;
    int gr = 0;
    if (row) {
        a = box[r];
        area_a = area[r];
        sr = score[r];
        if (group != nullptr) gr = group[r];
    }
    if (group != nullptr && w != R) {
        // sorted by group, the columns after the rows share a group with
        // them only where it is the rows' last group: a prefix of the word
        const int g_last = group[min(32 * R + 31, n_v - 1)];
        jn = __popc(__ballot_sync(0xffffffffu, lane < jn && group[32 * w + lane] == g_last));
    }
    uint32_t mine = 0, theirs = 0;
    for (int k = 0; k < jn; ++k) {
        const int j = 32 * w + k;
        const float sj = score[j];
        bool over = row && j > r && (group == nullptr || group[j] == gr);
        if (over) over = vdet_iou_above_rn(a, area_a, box[j], area[j], offset, th);
        if (over && sj > sr) mine |= 1u << k;
        const uint32_t up = __ballot_sync(0xffffffffu, over && sr >= sj);
        if (lane == k) theirs = up;
    }
    if (R == w) {
        if (row) adj[r * nw + w] = mine | theirs;
    } else {
        if (row) adj[r * nw + w] = mine;
        if (32 * w + lane < n_v) adj[(32 * w + lane) * nw + R] = theirs;
    }
}

// A debug build (-DVDET_NMS_PHASE_CLOCKS, scripts/nms_phases.py) sums each
// block's clock64() cycles per phase over all blocks (thread 0's view: a
// phase ends at the barrier after it); the main build has no counters.
#ifdef VDET_NMS_PHASE_CLOCKS
__device__ unsigned long long vdet_nms_phase_cycles[8];
#define VDET_NMS_PHASE(k)                                                   \
    do {                                                                    \
        if (threadIdx.x == 0) {                                             \
            const long long now_ = clock64();                               \
            atomicAdd(&vdet_nms_phase_cycles[k],                            \
                      static_cast<unsigned long long>(now_ - mark_));       \
            mark_ = now_;                                                   \
        }                                                                   \
    } while (0)
#define VDET_NMS_PHASE_START long long mark_ = clock64()
// The summed cycles (8 counters) into `host`; zeroed with `reset`.
extern "C" int vdet_nms_phase_clocks(unsigned long long* host, int reset) {
    cudaError_t err = cudaMemcpyFromSymbol(host, vdet_nms_phase_cycles, 8 * sizeof(*host));
    if (err == cudaSuccess && reset) {
        const unsigned long long zero[8] = {};
        err = cudaMemcpyToSymbol(vdet_nms_phase_cycles, zero, sizeof(zero));
    }
    return static_cast<int>(err);
}
#else
#define VDET_NMS_PHASE(k) \
    do {                  \
    } while (0)
#define VDET_NMS_PHASE_START
#endif

// A block's shared memory for a problem of N slots (kernels/nms_grouped.py::
// smem_bytes mirrors it): box (16 bytes), area, score, group, original
// index, valid-order group and rank (4 bytes each), the adjacency (N rows of
// ceil(N / 32) words) and a keep byte a slot.
__host__ __device__ inline int vdet_nms_smem_bytes(int N) {
    return N * (16 + 6 * 4) + N * ((N + 31) / 32) * 4 + N;
}

// The exact greedy keep set of problem blockIdx.x (B, C): one block a
// problem, blockDim.x a multiple of 32 and >= N. Only valid slots matter
// (an invalid slot is never kept and never suppresses), so the block
// 1. compacts the valid slots in index order (warp ballots);
// 2. with groups, ranks them by (group, index): the valid position where
//    every valid slot shares one group, else a count over the other valid
//    slots, split between several threads a slot;
// 3. stores them in that order, so each group is one segment;
// 4. builds the adjacency by warp tiles (vdet_adjacency_tile), a warp at a
//    time on each of the nw (nw + 1) / 2 tiles;
// 5. runs the Jacobi steps: a thread a row, <= nw word ANDs, the keep set a
//    bitmask from warp ballots, double buffered, __syncthreads_or as the
//    convergence test, capped at n_v steps;
// 6. writes keep back at the original positions.
template <bool kGrouped>
__device__ __forceinline__ void vdet_nms_block(const float* __restrict__ boxes,
                                               const float* __restrict__ scores,
                                               const uint8_t* __restrict__ valid,
                                               const int32_t* __restrict__ groups,
                                               uint8_t* __restrict__ keep, int N, float thresh,
                                               float offset) {
    constexpr int kMaxWarps = 32;
    extern __shared__ __align__(16) unsigned char vdet_nms_smem[];
    float4* sbox = reinterpret_cast<float4*>(vdet_nms_smem);
    float* sarea = reinterpret_cast<float*>(sbox + N);
    float* sscore = sarea + N;
    int* sgroup = reinterpret_cast<int*>(sscore + N);
    int* sorig = sgroup + N;
    int* vgroup = sorig + N;
    int* vrank = vgroup + N;
    uint32_t* adj = reinterpret_cast<uint32_t*>(vrank + N);
    uint8_t* skeep = reinterpret_cast<uint8_t*>(adj + N * ((N + 31) / 32));
    __shared__ uint32_t kbuf[2][kMaxWarps];
    __shared__ int wcount[kMaxWarps];
    VDET_NMS_PHASE_START;

    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int nwarps = blockDim.x >> 5;
    const size_t base = static_cast<size_t>(blockIdx.x) * N;

    // 1. load slot t; its position v among the valid slots, in index order
    float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
    float score = 0.f;
    int group = 0;
    bool vt = false;
    if (t < N) {
        box = reinterpret_cast<const float4*>(boxes)[base + t];
        score = scores[base + t];
        if (kGrouped) group = groups[base + t];
        vt = valid[base + t] != 0;
        skeep[t] = 0;
    }
    const uint32_t vball = __ballot_sync(0xffffffffu, vt);
    if (lane == 0) wcount[warp] = __popc(vball);
    __syncthreads();
    int v = __popc(vball & ((1u << lane) - 1u));
    int n_v = 0;
    for (int k = 0; k < nwarps; ++k) {
        const int c = wcount[k];
        n_v += c;
        if (k < warp) v += c;
    }
    if (n_v == 0) {  // the same in every thread: nothing is kept
        if (t < N) keep[base + t] = 0;
        return;
    }
    VDET_NMS_PHASE(0);

    // 2. rank the valid slots by (group, index)
    bool one_group = true;
    if (kGrouped) {
        if (vt) {
            vgroup[v] = group;
            vrank[v] = 0;
        }
        __syncthreads();
        one_group = __syncthreads_and(!vt || group == vgroup[0]);
        if (!one_group) {
            // thread t counts, for valid slot u = t / parts, the valid slots
            // of its part that come first: a lower group, or the same and a
            // lower index
            const int parts = max(1, static_cast<int>(blockDim.x) / n_v);
            const int len = (n_v + parts - 1) / parts;
            const int u = t / parts;
            if (u < n_v) {
                const int p = t - u * parts;
                const int gu = vgroup[u];
                const int k1 = min(n_v, (p + 1) * len);
                int before = 0;
                for (int k = p * len; k < k1; ++k) {
                    const int gk = vgroup[k];
                    before += (gk < gu) || (gk == gu && k < u);
                }
                if (before) atomicAdd(&vrank[u], before);
            }
            __syncthreads();
        }
    }
    VDET_NMS_PHASE(1);

    // 3. the valid slots in (group, index) order; Jacobi starts from keep =
    // every valid slot
    const int nw = (n_v + 31) >> 5;
    if (vt) {
        const int r = one_group ? v : vrank[v];
        sbox[r] = box;
        sarea[r] = vdet_area_rn(box.x, box.y, box.z, box.w, offset);
        sscore[r] = score;
        if (kGrouped) sgroup[r] = group;
        sorig[r] = t;
    }
    const bool own = t < n_v;  // thread t owns row t in the Jacobi steps
    const uint32_t own_ball = __ballot_sync(0xffffffffu, own);
    if (lane == 0) kbuf[0][warp] = own_ball;
    __syncthreads();
    VDET_NMS_PHASE(2);

    // 4. the adjacency, a warp a tile (R, w), R <= w
    const VdetIouThresh th = vdet_iou_thresh(thresh);
    for (int it = warp; it < nw * (nw + 1) / 2; it += nwarps) {
        int R = 0, rest = it;
        while (rest >= nw - R) {
            rest -= nw - R;
            ++R;
        }
        vdet_adjacency_tile(sbox, sarea, sscore, kGrouped && !one_group ? sgroup : nullptr,
                            adj, nw, n_v, R, R + rest, th, offset);
    }
    __syncthreads();
    VDET_NMS_PHASE(3);

    // 5. Jacobi steps
    bool kr = own;
    int cur = 0;
    for (int step = 0; step < n_v; ++step) {
        bool sup = false;
        if (own) {
            for (int w = 0; w < nw; ++w) sup |= (adj[t * nw + w] & kbuf[cur][w]) != 0u;
        }
        const bool nk = own && !sup;
        const uint32_t kword = __ballot_sync(0xffffffffu, nk);
        if (lane == 0) kbuf[cur ^ 1][warp] = kword;
        const int changed = __syncthreads_or(nk != kr);
        kr = nk;
        cur ^= 1;
        if (!changed) break;
    }
    VDET_NMS_PHASE(4);

    // 6. keep at the original positions
    if (own) skeep[sorig[t]] = kr ? 1 : 0;
    __syncthreads();
    if (t < N) keep[base + t] = skeep[t];
    VDET_NMS_PHASE(5);
}
