// Greedy NMS in visit order, the whole function in one launch (kernel D).
//
// Replaces the TPU kernel vdetlib_tpu/kernels/nms_pallas.py::nms_pallas_batch
// (the stable sort by masked score, _nms_kernel's walk, and the scatter back
// to input order). Same keep set as the plain version beside the wrapper,
// kernels/nms_sorted.py::nms_sorted_greedy: visit the valid slots by score
// desc, index asc; a kept box i drops every later box j with IoU(i, j) >
// thresh (legacy +1 area offset, strict >); keep is returned in input order.
//
// What bounds it on an H100: not bytes (a valid and a keep byte a slot, a
// box and a score a valid slot) but the block's dependent steps. The
// frame-NMS tool's call is B = T x C problems of N = max_boxes slots (64
// frames x 30 classes x 512 at the smoke run's shape), most of them sparse
// (~17 valid slots of 512 on the tool's data, ~390 on the smoke run's dense
// problems), and the greedy walk needs only the IoUs of each kept box with
// the later boxes still alive (~2,600 a dense problem).
//
// Design: one block a problem; `threads` (kernels/nms_sorted.py::
// launch_threads: 128 at N = 512, so that the tool's 1,920 blocks are all
// resident at once) stride over the slots, so N is bounded by the block's
// shared memory (vdet_nms_sorted_smem_bytes), not by its threads. A block's
// time is mostly latency (dependent loads, IoUs and picks), so many small
// blocks an SM hide it.
// 1. load, 4 consecutive slots a thread a pass (one pass at N = 512): each
//    slot's valid byte, the score of a valid slot; an invalid slot's keep
//    is written 0 at once and nothing else ever touches it. The valid slots
//    are compacted by a prefix over the lanes (shuffles) and over the warps,
//    and each leaves a 64-bit visit key (vdet_visit_key) in shared memory.
// 2. sort the n_v keys: where n_v <= 32, one warp sorts them in registers
//    (a bitonic network by shuffles) and does the rest alone, with no
//    further block barrier; else a bitonic network over n_v rounded up to a
//    power of two: its stages that pair keys less than 64 apart run in
//    registers (a warp a segment of 64 keys, by shuffles), the wider ones in
//    shared memory, a barrier each (10 barriers at 512 keys, not 45). Then
//    each valid box is read from device
//    memory once, by its key's index, into shared memory in visit order.
// 3. the walk, blocked by 32 positions: warp 0 settles a chunk alone (the
//    IoU bits among its rows still alive, then the greedy picks on a
//    bitmask in registers); then every warp tests its later live rows, a
//    lane a row and a warp a 32-row word, against that chunk's kept rows
//    only, and writes the word's suppressed bits by ballot. Warp 0 owns the
//    word after the chunk, so it settles the next chunk right after its own
//    word, before the barrier: one barrier a chunk, <= ceil(n_v / 32).
// 4. write keep at the valid slots' original positions.
//
// Exactness: every IoU decision goes through nms_common.cuh::
// vdet_iou_above_rn (the reference's op order with round-to-nearest
// intrinsics, the division skipped only where its side of thresh is
// certain), and this file is compiled with -fmad=false; never with
// --use_fast_math. The visit order is the plain version's torch.sort of
// -masked score, stable (vdet_visit_key). Validity comes from the mask only.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemDefault = 48 * 1024;  // above it only after an opt-in
constexpr uint32_t kFull = 0xffffffffu;

__host__ __device__ inline int vdet_pow2_at_least(int n) {
    int p = 32;
    while (p < n) p <<= 1;
    return p;
}

// A block's shared memory for N slots (kernels/nms_sorted.py::smem_bytes
// mirrors it): a 64-bit visit key for each of N rounded up to a power of two
// (>= 32) slots, a box (16 bytes) and an area (4) a slot in visit order, a
// suppressed bit a slot, and 66 words: two rows of 32 warp counts and two
// chunk keep masks.
__host__ __device__ inline int vdet_nms_sorted_smem_bytes(int N) {
    return 8 * vdet_pow2_at_least(N) + 20 * N + 4 * ((N + 31) / 32) + 4 * 66;
}

// The visit order as a 64-bit key, ascending: the order-preserving bits of
// -score above the slot's index. -0.0 is +0.0 (the two tie and go by
// index), every NaN is 0xffffffff (after +inf, i.e. after every number,
// NaNs by index), as torch.sort(-masked, stable=True) orders them
// (kernels/nms_sorted.py::visit_key is its model).
__device__ __forceinline__ uint64_t vdet_visit_key(float score, uint32_t index) {
    float v = -score;
    uint32_t u = 0xffffffffu;
    if (v == v) {
        if (v == 0.f) v = 0.f;
        u = __float_as_uint(v);
        u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    }
    return (static_cast<uint64_t>(u) << 32) | index;
}

__device__ __forceinline__ uint64_t vdet_pick(uint64_t x, uint64_t y, bool take_min) {
    return take_min ? (y < x ? y : x) : (y > x ? y : x);
}

// The bitonic stages j = jtop, jtop / 2, ..., 1 of the merge of width kk on
// the 64 keys s + l (in a) and s + 32 + l (in b) that lane l holds: the key
// at e pairs with e ^ j, the lower of the two takes the min where e & kk is
// 0 (ascending) and the max elsewhere. j = 32 pairs a with b in one lane;
// j < 32 pairs lanes by shuffles.
__device__ __forceinline__ void vdet_merge_regs(uint64_t& a, uint64_t& b, int s, int kk,
                                                int jtop) {
    const int lane = threadIdx.x & 31;
    const bool up0 = ((s + lane) & kk) == 0;
    const bool up1 = ((s + 32 + lane) & kk) == 0;
    for (int j = jtop; j > 0; j >>= 1) {
        if (j == 32) {  // kk >= 64: a and b sort the same way
            const uint64_t lo = vdet_pick(a, b, up0), hi = vdet_pick(a, b, !up0);
            a = lo;
            b = hi;
        } else {
            const uint64_t oa = __shfl_xor_sync(kFull, a, j);
            const uint64_t ob = __shfl_xor_sync(kFull, b, j);
            const bool lower = (lane & j) == 0;
            a = vdet_pick(a, oa, lower == up0);
            b = vdet_pick(b, ob, lower == up1);
        }
    }
}

// The bitonic stages of merge width kk that pair keys less than 64 apart,
// on each 64-key segment of key[0, Pv) in registers, a warp a segment; kk =
// 64 runs every stage of the widths 2..64 (each segment sorted, in the
// direction its width-128 merge needs).
__device__ __forceinline__ void vdet_sort_segments(uint64_t* key, int Pv, int kk) {
    const int lane = threadIdx.x & 31;
    for (int s = 64 * (threadIdx.x >> 5); s < Pv; s += 2 * blockDim.x) {
        uint64_t a = key[s + lane], b = key[s + 32 + lane];
        if (kk == 64) {
            for (int k2 = 2; k2 <= 64; k2 <<= 1) vdet_merge_regs(a, b, s, k2, k2 >> 1);
        } else {
            vdet_merge_regs(a, b, s, kk, 32);
        }
        key[s + lane] = a;
        key[s + 32 + lane] = b;
    }
}

// The greedy keep set of the rows r0 + l (bit l of `alive`) whose boxes and
// areas lie in shared memory, in visit order, run by one warp: lane l sets
// bit k of its mask for each later live row k that it would suppress, then
// the picks walk the live rows in order on bitmasks in registers. Returns
// the kept rows' bits, the same in every lane.
__device__ __forceinline__ uint32_t vdet_settle_chunk(const float4* sbox, const float* sarea,
                                                      int r0, uint32_t alive,
                                                      const VdetIouThresh& th, float offset) {
    const int lane = threadIdx.x & 31;
    uint32_t m = 0;
    if ((alive >> lane) & 1u) {
        const float4 a = sbox[r0 + lane];
        const float aa = sarea[r0 + lane];
        // two later rows an iteration: two independent IoUs in flight
        for (uint32_t rest = alive & ((kFull << lane) << 1); rest;) {
            const int k1 = __ffs(rest) - 1;
            rest &= rest - 1u;
            const int k2 = rest ? __ffs(rest) - 1 : k1;
            rest &= rest - 1u;
            const bool o1 = vdet_iou_above_rn(a, aa, sbox[r0 + k1], sarea[r0 + k1], offset, th);
            const bool o2 = vdet_iou_above_rn(a, aa, sbox[r0 + k2], sarea[r0 + k2], offset, th);
            m |= (o1 ? 1u << k1 : 0u) | (o2 ? 1u << k2 : 0u);
        }
    }
    uint32_t kept = 0, cand = alive;
    while (cand) {
        const int i = __ffs(cand) - 1;
        kept |= 1u << i;
        cand &= ~(1u << i) & ~__shfl_sync(kFull, m, i);
    }
    return kept;
}

__global__ void __launch_bounds__(kMaxThreads)
nms_sorted_kernel(const float* __restrict__ boxes,    // (B, N, 4)
                  const float* __restrict__ scores,   // (B, N)
                  const uint8_t* __restrict__ valid,  // (B, N) bool
                  uint8_t* __restrict__ keep,         // (B, N) bool
                  int N, float thresh, float offset) {
    extern __shared__ __align__(16) unsigned char vdet_sorted_smem[];
    const int P = vdet_pow2_at_least(N);
    uint64_t* key = reinterpret_cast<uint64_t*>(vdet_sorted_smem);
    float4* sbox = reinterpret_cast<float4*>(key + P);
    float* sarea = reinterpret_cast<float*>(sbox + N);
    uint32_t* dead = reinterpret_cast<uint32_t*>(sarea + N);  // suppressed bits, visit order
    int* wcount = reinterpret_cast<int*>(dead + (N + 31) / 32);  // [2][32]
    uint32_t* kword = reinterpret_cast<uint32_t*>(wcount + 64);  // [2]
    VDET_NMS_PHASE_START;

    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int nwarps = blockDim.x >> 5;
    const size_t base = static_cast<size_t>(blockIdx.x) * N;
    const float4* box4 = reinterpret_cast<const float4*>(boxes) + base;

    // 1. load and compact, 4 consecutive slots a thread a pass: slot s's
    // position v among the valid slots
    for (int w = t; w < (N + 31) / 32; w += blockDim.x) dead[w] = 0u;
    int n_v = 0;
    for (int s0 = 0, it = 0; s0 < N; s0 += 4 * blockDim.x, ++it) {
        const int s = s0 + 4 * t;
        bool vs[4];
        float sc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) vs[q] = s + q < N && valid[base + s + q] != 0;
        int c = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            sc[q] = 0.f;
            if (vs[q]) {
                sc[q] = scores[base + s + q];
                ++c;
            } else if (s + q < N) {
                keep[base + s + q] = 0;
            }
        }
        int incl = c;  // inclusive prefix of the counts over the warp
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int o = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += o;
        }
        int* wc = wcount + 32 * (it & 1);  // double buffered: one barrier a pass
        if (lane == 31) wc[warp] = incl;
        __syncthreads();
        int v = n_v + incl - c;
        for (int k = 0; k < nwarps; ++k) {
            const int wk = wc[k];
            if (k < warp) v += wk;
            n_v += wk;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (vs[q]) key[v++] = vdet_visit_key(sc[q], static_cast<uint32_t>(s + q));
        }
    }
    if (n_v == 0) return;  // the same in every thread: every keep is written
    const int Pv = vdet_pow2_at_least(n_v);
    for (int i = n_v + t; i < Pv; i += blockDim.x) key[i] = ~0ull;
    __syncthreads();
    VDET_NMS_PHASE(0);
    const VdetIouThresh th = vdet_iou_thresh(thresh);

    if (n_v <= 32) {  // one warp does the rest: no further block barrier
        if (warp != 0) return;
        uint64_t k = key[lane];
        for (int kk = 2; kk <= 32; kk <<= 1) {
            for (int j = kk >> 1; j > 0; j >>= 1) {
                const uint64_t o = __shfl_xor_sync(kFull, k, j);
                const bool take_min = ((lane & j) == 0) == ((lane & kk) == 0);
                k = take_min ? (o < k ? o : k) : (o > k ? o : k);
            }
        }
        const bool row = lane < n_v;
        const uint32_t orig = static_cast<uint32_t>(k);
        if (row) {
            const float4 b = box4[orig];
            sbox[lane] = b;
            sarea[lane] = vdet_area_rn(b.x, b.y, b.z, b.w, offset);
        }
        __syncwarp();
        VDET_NMS_PHASE(1);
        const uint32_t kept = vdet_settle_chunk(sbox, sarea, 0, __ballot_sync(kFull, row), th,
                                                offset);
        VDET_NMS_PHASE(2);
        if (row) keep[base + orig] = (kept >> lane) & 1u;
        VDET_NMS_PHASE(3);
        return;
    }

    // 2. bitonic sort of the Pv keys, ascending: the stages that pair keys
    // less than 64 apart run in registers, a warp a segment of 64 keys;
    // only the wider ones go through shared memory, a barrier each
    vdet_sort_segments(key, Pv, 64);
    __syncthreads();
    for (int kk = 128; kk <= Pv; kk <<= 1) {
        for (int j = kk >> 1; j >= 64; j >>= 1) {
            for (int i = t; i < Pv / 2; i += blockDim.x) {
                const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
                const int hi = lo | j;
                const uint64_t a = key[lo], b = key[hi];
                if ((a > b) == ((lo & kk) == 0)) {
                    key[lo] = b;
                    key[hi] = a;
                }
            }
            __syncthreads();
        }
        vdet_sort_segments(key, Pv, kk);
        __syncthreads();
    }
    for (int p = t; p < n_v; p += blockDim.x) {
        const float4 b = box4[static_cast<uint32_t>(key[p])];
        sbox[p] = b;
        sarea[p] = vdet_area_rn(b.x, b.y, b.z, b.w, offset);
    }
    __syncthreads();
    VDET_NMS_PHASE(1);

    // 3. the walk, a chunk of 32 positions at a time
    const int nc = (n_v + 31) >> 5;
    if (warp == 0) {
        const uint32_t kept = vdet_settle_chunk(sbox, sarea, 0, kFull, th, offset);
        if (lane == 0) {
            kword[0] = kept;
            dead[0] = ~kept;
        }
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
        const uint32_t km = kword[c & 1];
        for (int w = c + 1 + warp; w < nc; w += nwarps) {
            const int j = 32 * w + lane;
            bool alive = j < n_v && !((dead[w] >> lane) & 1u);
            if (km != 0u && __any_sync(kFull, alive)) {
                if (alive) {
                    const float4 bj = sbox[j];
                    const float aj = sarea[j];
                    for (uint32_t rest = km; rest; rest &= rest - 1u) {
                        const int i = 32 * c + __ffs(rest) - 1;
                        if (vdet_iou_above_rn(sbox[i], sarea[i], bj, aj, offset, th)) {
                            alive = false;
                            break;
                        }
                    }
                }
                const uint32_t gone = __ballot_sync(kFull, !alive);
                if (lane == 0) dead[w] = gone;
            }
        }
        if (warp == 0 && c + 1 < nc) {  // warp 0 just wrote word c + 1: settle it
            __syncwarp();
            const int r0 = 32 * (c + 1);
            const uint32_t in = n_v - r0 >= 32 ? kFull : (1u << (n_v - r0)) - 1u;
            const uint32_t kept = vdet_settle_chunk(sbox, sarea, r0, in & ~dead[c + 1], th,
                                                    offset);
            __syncwarp();
            if (lane == 0) {
                kword[(c + 1) & 1] = kept;
                dead[c + 1] = ~kept;
            }
        }
        __syncthreads();
    }
    VDET_NMS_PHASE(2);

    // 4. keep at the original positions: every live row is kept
    for (int p = t; p < n_v; p += blockDim.x) {
        keep[base + static_cast<uint32_t>(key[p])] = !((dead[p >> 5] >> (p & 31)) & 1u);
    }
    VDET_NMS_PHASE(3);
}

}  // namespace

// boxes (B, N, 4) f32 (16-byte aligned), scores (B, N) f32 and valid (B, N)
// bool, in input order → keep (B, N) bool in input order; B >= 1, N >= 1
// and vdet_nms_sorted_smem_bytes(N) within the device's opt-in shared
// memory, `threads` a multiple of 32 in [32, 1024]. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a launch the kernel
// cannot take.
extern "C" int vdet_nms_sorted(const void* boxes, const void* scores, const void* valid,
                               void* keep, int B, int N, int threads, float thresh, float offset,
                               void* stream) {
    if (B < 1 || N < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int smem = vdet_nms_sorted_smem_bytes(N);
    if (smem > kSmemDefault) {
        const cudaError_t err = cudaFuncSetAttribute(
            nms_sorted_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    nms_sorted_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const float*>(scores),
        static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), N, thresh, offset);
    return static_cast<int>(cudaGetLastError());
}
