// Seq-NMS linking, the whole path loop of a call in one launch (kernel G).
//
// Replaces no TPU kernel: the JAX package's seq-NMS is an XLA while_loop
// (vdetlib_tpu/kernels/seq_nms.py). Same function as the plain version
// beside the wrapper, kernels/seq_nms.py::seq_nms_plain: per class lane,
// up to max_paths times, the Viterbi max-score path over the frame graph
// (slot i of frame t-1 linked to slot j of frame t where their IoU >
// link_thresh), rescored to its "avg" or "max" statistic, taken out, and
// every alive slot of its frames overlapping its box by > suppress_thresh
// suppressed to -1. Ties break as torch.argmax breaks them (the first
// maximum) in the global argmax and in every backpointer.
//
// What bounds it on an H100: neither bytes nor operations (the sweep's call,
// 30 lanes x 288 frames x 64 slots x 100 paths, is ~15 GFLOP by
// utils/flops.py::seq_nms_flops, ~0.2 ms at the float32 peak) but the
// dependent chain: paths x frames of a lane, each frame's maxima waiting on
// the frame before, with one block a lane and a few warps a scheduler, so
// a frame costs the latency of its longest chain of dependent instructions.
// The plain version runs that chain as ~10 torch launches a step, ~580,000
// a call.
//
// Design: a block a lane (the lanes are independent), a thread a slot (32
// threads where N <= 32, else 64), so a frame of the forward DP is one
// block barrier and the thread's own linked predecessors:
// - the IoU tests come packed from the wrapper (kernels/seq_nms.py::
//   link_masks, torch's pairwise_iou on the card, the plain version's own
//   decisions): link[t-1][j] holds the predecessors of slot j of frame t as
//   bits, over[t][p] the slots of frame t overlapping slot p. The kernel
//   does no geometry;
// - a lane's state: dp of frames t-1 and t in shared memory; its alive
//   slots (a 64-bit word a frame), the backpointers (a byte a slot and
//   frame) and the path's slot a frame in scratch the wrapper allocates,
//   for every T (the alive words are read a frame ahead, the backpointers
//   written by their own slot and read back by the one backtracking thread,
//   so they stay off the chain's critical loads);
// - forward DP: thread j takes the max over the set bits of link &
//   alive[t-1] of dp[t-1][i] (ascending i, strict >: the first maximum;
//   four bits a trip, their loads together), stores the backpointer where
//   that maximum is > 0, dp[t][j] = s + max(0, it) with the plain version's
//   float32 add, and keeps its running first maximum. The next frame's link
//   words, scores and alive words are loaded a frame ahead;
// - global argmax: a block reduction by (value desc, flat index t*N + j
//   asc); a NaN dp (the plain argmax would pick it, then fail its > 0 test)
//   or a best <= 0 ends the lane: every later iteration of the plain
//   version changes no state;
// - backtrack: one thread walks the backpointers;
// - the path's frames in parallel: the statistic (the "avg" sum in double,
//   rounded once: within a few ulp of torch's float32 sum in any order),
//   then per frame the path slot's score and id, and the kill set
//   over[t][p] & alive[t], written -1.
// Each slot is written at most once after the lane's first pass (scores *
// mask, id -1): once on a path or suppressed it is no longer alive.
//
// A frame costs ~760 cycles of the slowest warp's dependent instructions
// (clock64() probes on the sweep's data, NVIDIA H100 at 1,980 MHz): the
// bit walk, the address arithmetic and the barrier, not memory (staging the
// link words and scores in shared memory by cp.async changed nothing).
// Tried and slower on the same data: four threads a slot comparing 16
// predecessors each (1,100 cycles), a warp a slot with a max-reduce over
// its lanes (2.5x: 32 warps contend for the schedulers), 32-bit halves with
// pointers stepping a row a frame (+9%).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 64;
constexpr int kAhead = 1;  // frames of link words, scores and alive words in flight
constexpr float kNeg = -1e30f;  // kernels/seq_nms.py::NEG: a slot that is not alive

// (v, f) is a better maximum than (bv, bf): larger, or equal and first.
__device__ __forceinline__ bool better(float v, int f, float bv, int bf) {
    return v > bv || (v == bv && f < bf);
}

__global__ void __launch_bounds__(kMaxSlots)
seq_nms_kernel(const float* __restrict__ scores, const uint8_t* __restrict__ mask,
               const uint64_t* __restrict__ link, const uint64_t* __restrict__ over,
               float* __restrict__ out, int* __restrict__ pid, uint64_t* alive_all,
               int8_t* path_all, int8_t* bp_all, int T, int N, int max_paths, int rescore_max) {
    __shared__ float dp[2][kMaxSlots];
    __shared__ float red_v[2];
    __shared__ int red_f[2];
    __shared__ int red_nan[2];
    __shared__ double red_sum[2];
    __shared__ float red_max[2];
    __shared__ int ctrl[3];  // t_start, t_end (t_end < 0: the lane is done), stat bits

    const int c = blockIdx.x;
    const int j = threadIdx.x;
    const int lane = j & 31;
    const int warp = j >> 5;
    const int n_warps = blockDim.x >> 5;
    const long long TN = static_cast<long long>(T) * N;
    uint64_t* alive = alive_all + static_cast<long long>(c) * T;
    int8_t* path = path_all + static_cast<long long>(c) * T;
    int8_t* bp = bp_all + c * TN;
    const float* sc = scores + c * TN;
    const uint8_t* mk = mask + c * TN;
    float* o = out + c * TN;
    int* pi = pid + c * TN;

    // first pass: out = scores * mask, ids -1, alive words by ballot (a warp a frame)
    for (int t = warp; t < T; t += n_warps) {
        uint64_t word = 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int s = lane + 32 * h;
            bool m = false;
            if (s < N) {
                const long long k = static_cast<long long>(t) * N + s;
                m = mk[k] != 0;
                o[k] = __fmul_rn(sc[k], m ? 1.f : 0.f);
                pi[k] = -1;
            }
            word |= static_cast<uint64_t>(__ballot_sync(0xffffffffu, m)) << (32 * h);
        }
        if (lane == 0) alive[t] = word;
    }
    __syncthreads();

    const bool live = j < N;
    for (int n = 0; n < max_paths; ++n) {
        // ---- forward DP; (best, best_f) the thread's first maximum
        float best = -__int_as_float(0x7f800000);
        int best_f = 0x7fffffff;
        bool nan = false;
        uint64_t aw_prev = alive[0];
        if (live) {
            const float d = (aw_prev >> j) & 1 ? sc[j] : kNeg;
            dp[0][j] = d;
            nan = d != d;
            if (better(d, j, best, best_f)) best = d, best_f = j;
        }
        uint64_t lw[kAhead], aw[kAhead];
        float sv[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
            const int t = 1 + k;
            if (live && t < T) {
                lw[k] = link[static_cast<long long>(t - 1) * N + j];
                sv[k] = sc[static_cast<long long>(t) * N + j];
                aw[k] = alive[t];
            }
        }
        __syncthreads();
        for (int t0 = 1; t0 < T; t0 += kAhead) {
#pragma unroll
            for (int k = 0; k < kAhead; ++k) {
                const int t = t0 + k;
                if (t >= T) break;  // the same for every thread
                if (live) {
                    const float* prev = dp[(t - 1) & 1];
                    uint64_t w = lw[k] & aw_prev;
                    float m = -__int_as_float(0x7f800000);
                    int arg = -1;
                    while (w) {  // four predecessors a trip, their loads together
                        int i[4];  // ascending; past the last set bit, the first again
                        i[0] = __ffsll(static_cast<long long>(w)) - 1;
                        w &= w - 1;
#pragma unroll
                        for (int q = 1; q < 4; ++q) {
                            i[q] = w ? __ffsll(static_cast<long long>(w)) - 1 : i[0];
                            w &= w - 1;
                        }
                        float v[4];
#pragma unroll
                        for (int q = 0; q < 4; ++q) v[q] = prev[i[q]];
#pragma unroll
                        for (int q = 0; q < 4; ++q) {
                            if (v[q] > m) m = v[q], arg = i[q];
                        }
                    }
                    const bool pos = m > 0.f;
                    const float d = (aw[k] >> j) & 1 ? __fadd_rn(sv[k], pos ? m : 0.f) : kNeg;
                    bp[static_cast<long long>(t) * N + j] = static_cast<int8_t>(pos ? arg : -1);
                    dp[t & 1][j] = d;
                    nan |= d != d;
                    if (d > best) best = d, best_f = t * N + j;  // t rises: the first stays
                    aw_prev = aw[k];
                    const int tn = t + kAhead;
                    if (tn < T) {
                        lw[k] = link[static_cast<long long>(tn - 1) * N + j];
                        sv[k] = sc[static_cast<long long>(tn) * N + j];
                        aw[k] = alive[tn];
                    }
                }
                __syncthreads();
            }
        }

        // ---- global argmax (first maximum), then the backtrack by thread 0
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_down_sync(0xffffffffu, best, off);
            const int of = __shfl_down_sync(0xffffffffu, best_f, off);
            if (better(ov, of, best, best_f)) best = ov, best_f = of;
        }
        const bool any_nan = __any_sync(0xffffffffu, nan);
        if (lane == 0) {
            red_v[warp] = best;
            red_f[warp] = best_f;
            red_nan[warp] = any_nan;
        }
        __syncthreads();
        if (j == 0) {
            for (int w = 1; w < n_warps; ++w) {
                if (better(red_v[w], red_f[w], best, best_f)) best = red_v[w], best_f = red_f[w];
            }
            bool stop = !(best > 0.f);
            for (int w = 0; w < n_warps; ++w) stop |= red_nan[w] != 0;
            int t = best_f / N;
            if (stop) {
                ctrl[1] = -1;
            } else {
                int p = best_f - t * N;
                ctrl[1] = t;
                path[t] = static_cast<int8_t>(p);
                while (t > 0) {
                    const int b = bp[static_cast<long long>(t) * N + p];
                    if (b < 0) break;
                    --t;
                    p = b;
                    path[t] = static_cast<int8_t>(p);
                }
                ctrl[0] = t;
            }
        }
        __syncthreads();
        const int t_start = ctrl[0], t_end = ctrl[1];
        if (t_end < 0) break;  // the same for every thread

        // ---- the path's statistic
        double sum = 0.0;
        float mx = -__int_as_float(0x7f800000);
        for (int t = t_start + j; t <= t_end; t += blockDim.x) {
            const float s = sc[static_cast<long long>(t) * N + path[t]];
            sum += static_cast<double>(s);
            mx = fmaxf(mx, s);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            sum += __shfl_down_sync(0xffffffffu, sum, off);
            mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
        }
        if (lane == 0) red_sum[warp] = sum, red_max[warp] = mx;
        __syncthreads();
        if (j == 0) {
            for (int w = 1; w < n_warps; ++w) sum += red_sum[w], mx = fmaxf(mx, red_max[w]);
            const float n_on = static_cast<float>(t_end - t_start + 1);
            const float stat = rescore_max ? mx : __fdiv_rn(static_cast<float>(sum), n_on);
            ctrl[2] = __float_as_int(stat);
        }
        __syncthreads();
        const float stat = __int_as_float(ctrl[2]);

        // ---- take the path out, suppress its frames' overlaps
        for (int t = t_start + j; t <= t_end; t += blockDim.x) {
            const int p = path[t];
            const long long row = static_cast<long long>(t) * N;
            o[row + p] = stat;
            pi[row + p] = n;
            const uint64_t a = alive[t] & ~(1ULL << p);
            uint64_t kill = over[row + p] & a;
            alive[t] = a & ~kill;
            while (kill) {
                o[row + __ffsll(static_cast<long long>(kill)) - 1] = -1.f;
                kill &= kill - 1;
            }
        }
        __syncthreads();
    }
}

}  // namespace

// scores (C, T, N) f32, mask (C, T, N) bool, link (T-1, N) and over (T, N)
// 64-bit words (kernels/seq_nms.py::link_masks), scratch alive (C, T)
// 64-bit words, path (C, T) and bp (C, T, N) bytes → out (C, T, N) f32 and
// pid (C, T, N) int32, every element written. C >= 1, T >= 1, 1 <= N <= 64.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a launch the
// kernel cannot take.
extern "C" int vdet_seq_nms(const void* scores, const void* mask, const void* link,
                            const void* over, void* out, void* pid, void* alive, void* path,
                            void* bp, int C, int T, int N, int max_paths, int rescore_max,
                            void* stream) {
    if (C < 1 || T < 1 || N < 1 || N > kMaxSlots || max_paths < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int threads = N <= 32 ? 32 : 64;  // a thread a slot
    seq_nms_kernel<<<C, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scores), static_cast<const uint8_t*>(mask),
        static_cast<const uint64_t*>(link), static_cast<const uint64_t*>(over),
        static_cast<float*>(out), static_cast<int*>(pid), static_cast<uint64_t*>(alive),
        static_cast<int8_t*>(path), static_cast<int8_t*>(bp), T, N, max_paths, rescore_max);
    return static_cast<int>(cudaGetLastError());
}
