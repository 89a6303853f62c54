// The folded forward+backward correlation-tracker scan in one launch (kernel F).
//
// Replaces the TPU kernel vdetlib_tpu/kernels/track_pallas.py::
// track_scan_pallas (body _track_kernel). Same function as the plain version
// beside this kernel's wrapper (kernels/track_scan.py::track_scan_plain):
// for each of A anchors, a forward lane walks frames 0..T-1 and a backward
// lane frames T-1..0; at every step a lane takes the search window around
// its box (search_factor times its size), ROI-aligns the window's Q x Q bins
// from the frame's features in bf16, correlates the anchor's P x P template
// over it (cosine similarity at each of the R x R offsets, R = Q - P + 1),
// moves its box by the soft-argmax (temperature 50) of the response, and
// applies the self-gated update: it starts at its anchor frame (anchor box,
// conf 1), tracks while the peak exceeds conf_thresh, and keeps its last
// box once dead. Outputs are indexed by frame: (2, T, A) for the two
// directions. Q and P are arguments (the tracker's search_pool and
// template_pool); shared memory bounds them (the wrapper checks).
//
// What bounds it on an H100: a step that tracks reads only the feature rows
// and columns of its window's taps (at most 2Q x 2Q positions of the frame,
// C channels each) and does ~1.3 MFLOP (the correlation's 0.5 M
// multiply-adds at Q = 16, P = 8, C = 96, the pooling and the norms). By the
// card's peaks that is a few microseconds for a round of 48 steps. In
// practice the chain of T dependent steps bounds it: each step waits for the
// previous step's box, so a step costs one feature gather, two barriers and
// the step's reductions, and one SM alone would need ~2.2 us a step for the
// correlation's float32 FMAs (128 lanes/clk) and as much for the pooling.
//
// Design. Each of the 2A lanes is an independent chain that shares only the
// read-only features. A lane runs on a thread-block cluster of n_cta blocks
// of 256 threads that loop over the T steps together (the wrapper picks
// n_cta, kernels/track_scan.py::cluster_ctas: 4 at A = 8, 64 SMs; fewer where
// 2A clusters of 4 would not fit the card's SMs at once).
// Every thread of the cluster holds the lane's box and alive flag in
// registers, and a step has two cluster barriers:
//  1. every warp derives the search window; lane j computes the bilinear taps
//     j and j + 32 of the 2Q row and column taps (_bilinear_weights has at
//     most two non-zero weights a row), and the warp shares them by shuffles;
//  2. pooling as a wide gather: block r pools its Q / n_cta rows of bins; an
//     item is (bin, group of 8 bf16 channels) (4 float32; one channel where C
//     is not a multiple of the vector or the features are not 16-byte
//     aligned); the lanes of a power-of-two group share a bin, a thread
//     issues the 16-byte loads of its items before the first use, and the
//     group's shuffle sum gives the bin's sum of squares over C while
//     pooling:
//       u = bf16(wy_lo * f_lo + wy_hi * f_hi) per source column,
//       bf16(wx_lo * u_lo + wx_hi * u_hi) (no last rounding for float32),
//     the two u of a channel rounded by one conversion; the window is stored
//     in the features' type (bf16 is exact: every pooled value is already
//     rounded to bf16) into the shared memory of every block of the cluster
//     (distributed shared memory);
//     -- cluster barrier 1 --
//  3. correlation over the cluster's warps: an item is (template row p, 3 of
//     the R response rows), one a warp at the default pools; a lane holds
//     the template row's P values of its channels c = lane + 32k in
//     registers and loads the window values of a 9-offset tile once, and the
//     warp's reduce-scatter gives the per-p partial responses, stored into
//     every block; the P x P window sums of the bins' norms are separable:
//     Q x R row sums in each block;
//     -- cluster barrier 2 --
//  4. every warp of every block sums the P partials and the P row sums of
//     each offset in the same order and computes the same normalized
//     response, peak, softmax, soft-argmax and update, so every thread holds
//     the new box bit for bit and no barrier closes the step.
// One buffer suffices: the next step's pooling (window, bin norms) starts
// after barrier 2, when every block has finished reading the window and the
// bin norms, and the next step's partials and row sums are written after its
// barrier 1, when every warp has finished this step's update.
// Shared memory of a block: the window (Q*Q*C in the features' type: 48 KiB
// at Q = 16, C = 96, bf16), the float32 template (24 KiB at P = 8), P partial
// responses (P*R*R), the row sums (Q*R) and the bin norms (Q*Q). Where P
// partials do not fit (float32 at Q = 23), the wrapper asks for one
// (kernels/track_scan.py::launch_parts): a warp then sums every template
// row of its response rows. The tracker's default pools and
// width (Q = 16, P = 8, C = 96) are compiled in (every bound and index a
// constant; the template in registers); any other shape runs on run-time
// bounds, reading the template from shared memory.
//
// Exactness: compiled with -fmad=false, so the window, the bilinear weights,
// the pooling and the box update round exactly as the plain version's ops
// do: bf16 x bf16 products are exact in float32 and the dense einsums add
// only exact zeros beside the two taps, so the pooled window is bit-equal to
// the plain version's. The correlation and norm sums (fmaf) and the softmax
// sums run in another order than cuDNN's or the CPU's: last-bit differences
// that the tracker's rollout amplifies over many steps. Every sum has a
// fixed order, so a launch's outputs do not change from run to run.
//
// A debug build (-DTRACK_SCAN_PHASE_CLOCKS, scripts/track_scan_phases.py)
// adds clock64() counters per phase of the first block's thread 0; the main
// path never has them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifdef TRACK_SCAN_PHASE_CLOCKS
// per-phase clocks of block 0's thread 0 summed over steps: taps, pooling,
// barrier 1, correlation, barrier 2, update; then the step count. Counted
// in registers, written once at the end of the launch.
__device__ unsigned long long g_phase_clocks[7];
#define PHASE(k)                                                        \
    do {                                                                \
        const long long now_ = clock64();                               \
        clk_[k] += static_cast<unsigned long long>(now_ - mark_);       \
        mark_ = now_;                                                   \
    } while (0)
#else
#define PHASE(k) \
    do {         \
    } while (0)
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 9;     // response offsets along a row in one accumulator tile
constexpr int kBatch = 8;    // pooling items whose feature loads are in flight together
constexpr int kTapSets = 2;  // taps a lane computes and shares (2Q <= 64; beyond, computed)
constexpr int kMaxK = 8;     // responses a lane keeps in registers (R*R <= 256; beyond, recomputed)
constexpr float kTemperature = 50.0f;
constexpr int kMaxCluster = 8;  // the portable thread-block cluster size

__device__ __forceinline__ float bf16r(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    return v;
}

// The warp's sums of a[0..7] in 9 shuffles (a reduce-scatter): lane l ends
// with the sum of a[(l >> 2) & 7]. Each sum's tree is fixed.
__device__ __forceinline__ float reduce_scatter8(const float (&a)[8], int lane) {
    const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
    float b[4], c[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float keep = h4 ? a[i + 4] : a[i];
        const float send = h4 ? a[i] : a[i + 4];
        b[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, 16));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const float keep = h3 ? b[i + 2] : b[i];
        const float send = h3 ? b[i] : b[i + 2];
        c[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, 8));
    }
    const float keep = h2 ? c[1] : c[0];
    const float send = h2 ? c[0] : c[1];
    float d = __fadd_rn(keep, __shfl_xor_sync(kFull, send, 4));
    d = __fadd_rn(d, __shfl_xor_sync(kFull, d, 2));
    return __fadd_rn(d, __shfl_xor_sync(kFull, d, 1));
}

// x / d as __fdiv_rn rounds it; a power-of-two d (the stride, Q = 16, 2)
// scales exactly, so multiplying by its exact reciprocal gives the same bits
__device__ __forceinline__ float div_rn(float x, float d) {
    return (__float_as_uint(d) & 0x007fffffu) == 0 ? __fmul_rn(x, __frcp_rn(d)) : __fdiv_rn(x, d);
}

// The sum of the n values p[0], p[stride], ...: a pairwise tree where n is
// the compiled-in 8 (three dependent adds, not eight), else in order.
template <int kN>
__device__ __forceinline__ float fixed_sum(const float* p, int n, int stride) {
    if constexpr (kN == 8) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = p[i * stride];
        return __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                         __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
    } else {
        float s = 0.0f;
        for (int i = 0; i < n; ++i) s = __fadd_rn(s, p[i * stride]);
        return s;
    }
}

// The two non-zero taps of row j of nn/heads.py::_bilinear_weights(start,
// end, size, pool) rounded to bf16, in its op order: bin = (end - start) /
// pool, center = start + (j + 0.5) * bin, pos = clamp(center - 0.5, 0,
// size - 1), weight(g) = max(1 - |pos - g|, 0) at g = floor(pos) and g + 1.
// At the clamped end the second tap (min(g + 1, size - 1)) gets weight 0.
__device__ __forceinline__ void bilinear_taps(float start, float end, int j, int size, int pool,
                                              int& g0, float& w0, float& w1) {
    const float bin = div_rn(__fsub_rn(end, start), static_cast<float>(pool));
    const float center = __fadd_rn(start, __fmul_rn(__fadd_rn(static_cast<float>(j), 0.5f), bin));
    const float pos = fminf(fmaxf(__fsub_rn(center, 0.5f), 0.0f), static_cast<float>(size - 1));
    const int lo = min(max(static_cast<int>(floorf(pos)), 0), size - 1);
    g0 = lo;
    w0 = bf16r(fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, static_cast<float>(lo)))), 0.0f));
    w1 = lo + 1 < size
             ? bf16r(fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, static_cast<float>(lo + 1)))), 0.0f))
             : 0.0f;
}

// lo and hi rounded to bf16 (nearest even) by one conversion, packed (hi high)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// both bf16-exact weights of a tap in one word (w1 high, w0 low)
__device__ __forceinline__ uint32_t pack_w(float w0, float w1) {
    return (__float_as_uint(w1) & 0xffff0000u) | (__float_as_uint(w0) >> 16);
}
__device__ __forceinline__ float w_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float w_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Tap idx of the window: rows idx < Q, columns idx - Q.
__device__ __forceinline__ void axis_tap(const float (&win)[4], int idx, int Q, int H, int W,
                                         float stride_f, int& g, uint32_t& w) {
    const bool row = idx < Q;
    float w0, w1;
    bilinear_taps(div_rn(row ? win[1] : win[0], stride_f), div_rn(row ? win[3] : win[2], stride_f),
                  row ? idx : idx - Q, row ? H : W, Q, g, w0, w1);
    w = pack_w(w0, w1);
}

// The taps a lane computed (j = lane + 32 s) ...
struct LaneTaps {
    int g[kTapSets];
    uint32_t w[kTapSets];
};

// ... and tap idx from the lane that owns it. Every lane of the warp calls
// this together (the shuffles); idx may differ from lane to lane.
template <int kQ>
__device__ __forceinline__ void get_tap(const LaneTaps& lt, int idx, int n_sets,
                                        const float (&win)[4], int Q, int H, int W,
                                        float stride_f, int& g, uint32_t& w) {
    g = 0;
    w = 0;
#pragma unroll
    for (int s = 0; s < kTapSets; ++s) {
        if (s < n_sets) {
            const int gs = __shfl_sync(kFull, lt.g[s], idx & 31);
            const uint32_t ws = __shfl_sync(kFull, lt.w[s], idx & 31);
            if ((idx >> 5) == s) {
                g = gs;
                w = ws;
            }
        }
    }
    if ((kQ == 0 || 2 * kQ > 32 * kTapSets) && idx >= 32 * kTapSets)
        axis_tap(win, idx, Q, H, W, stride_f, g, w);
}

// Feature loads: N channels a load (16 bytes, or one channel), each value
// as features.to(bfloat16).float(); the window element in shared memory.
template <typename FeatT, bool kVec>
struct Vec;
template <>
struct Vec<__nv_bfloat16, true> {
    using T = uint4;
    using W = unsigned short;  // bf16 bits
    static constexpr int N = 8;
    __device__ static T load(const __nv_bfloat16* p) {
        return __ldg(reinterpret_cast<const uint4*>(p));
    }
    __device__ static float get(const T& v, int e) {
        const uint32_t x = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
        return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
    }
};
template <>
struct Vec<__nv_bfloat16, false> {
    using T = unsigned short;
    using W = unsigned short;
    static constexpr int N = 1;
    __device__ static T load(const __nv_bfloat16* p) {
        return __ldg(reinterpret_cast<const unsigned short*>(p));
    }
    __device__ static float get(const T& v, int) {
        return __uint_as_float(static_cast<uint32_t>(v) << 16);
    }
};
template <>
struct Vec<float, true> {
    using T = float4;
    using W = float;
    static constexpr int N = 4;
    __device__ static T load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
    __device__ static float get(const T& v, int e) {
        return bf16r(e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w);
    }
};
template <>
struct Vec<float, false> {
    using T = float;
    using W = float;
    static constexpr int N = 1;
    __device__ static T load(const float* p) { return __ldg(p); }
    __device__ static float get(const T& v, int) { return bf16r(v); }
};

__device__ __forceinline__ float win_load(const unsigned short* p) {
    return __uint_as_float(static_cast<uint32_t>(*p) << 16);
}
__device__ __forceinline__ float win_load(const float* p) { return *p; }

// The pooled values' last rounding, to the window's type (bf16 in pairs, one
// conversion each; float32 as they are), packed into one store.
__device__ __forceinline__ uint4 win_value(const unsigned short*, float (&v)[8]) {
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        o[k] = pack_bf16x2(v[2 * k], v[2 * k + 1]);
        v[2 * k] = w_lo(o[k]);
        v[2 * k + 1] = w_hi(o[k]);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ unsigned short win_value(const unsigned short*, float (&v)[1]) {
    v[0] = bf16r(v[0]);
    return static_cast<unsigned short>(__float_as_uint(v[0]) >> 16);
}
__device__ __forceinline__ float4 win_value(const float*, float (&v)[4]) {
    return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ float win_value(const float*, float (&v)[1]) { return v[0]; }

// Step 2: pool bins [bin0, bin0 + n_bins) of frame f's Q x Q x C window and their
// sums of squares over C, into s_win and s_sqbin of each of the cluster's
// n_cta blocks. Every thread of the block calls it.
template <typename FeatT, bool kVec, int kQ, int kC>
__device__ __forceinline__ void pool_window(const FeatT* __restrict__ f,
                                            typename Vec<FeatT, kVec>::W* s_win, float* s_sqbin,
                                            cg::cluster_group& cluster, int n_cta, int bin0,
                                            int n_bins, const LaneTaps& lt, int n_sets,
                                            const float (&win)[4], int Q_, int H, int W, int C_,
                                            float stride_f, int tid) {
    const int Q = kQ ? kQ : Q_, C = kC ? kC : C_;
    using V = Vec<FeatT, kVec>;
    using VT = typename V::T;
    constexpr int N = V::N;
    const int CG = C / N;  // channel groups of a bin
    int G = 1;             // lanes that share a bin: a power of two, <= 32
    while (G < CG && G < 32) G <<= 1;
    const int nG = kThreads / G;
    const int grp = tid / G, gl = tid - grp * G;
    const int nM = (CG + G - 1) / G;  // channel groups a lane takes per bin
    const int nI = ((n_bins + nG - 1) / nG) * nM;  // items per thread, the same for all
    float sq = 0.0f;
#pragma unroll 1
    for (int i0 = 0; i0 < nI; i0 += kBatch) {
        VT v[kBatch][4];
        uint32_t wy[kBatch], wx[kBatch];
        int off[kBatch];
        bool ok[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {  // issue every load of the batch
            const int i = i0 + b;
            ok[b] = false;
            off[b] = 0;
            wy[b] = wx[b] = 0;
            if (i < nI) {
                const int k = i / nM, m = i - k * nM;
                const int bin = grp + k * nG, cg = gl + m * G;
                const int binc = bin0 + min(bin, n_bins - 1);
                const int p = binc / Q, q = binc - p * Q;
                int gy, gx;
                get_tap<kQ>(lt, p, n_sets, win, Q, H, W, stride_f, gy, wy[b]);
                get_tap<kQ>(lt, Q + q, n_sets, win, Q, H, W, stride_f, gx, wx[b]);
                ok[b] = bin < n_bins && cg < CG;
                off[b] = binc * C + cg * N;
                if (ok[b]) {
                    const int gy1 = min(gy + 1, H - 1), gx1 = min(gx + 1, W - 1);
                    const FeatT* c0 = f + cg * N;
                    v[b][0] = V::load(c0 + (static_cast<size_t>(gy) * W + gx) * C);
                    v[b][1] = V::load(c0 + (static_cast<size_t>(gy1) * W + gx) * C);
                    v[b][2] = V::load(c0 + (static_cast<size_t>(gy) * W + gx1) * C);
                    v[b][3] = V::load(c0 + (static_cast<size_t>(gy1) * W + gx1) * C);
                }
            }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            const int i = i0 + b;
            if (i < nI) {
                if (ok[b]) {
                    const float a0 = w_lo(wy[b]), a1 = w_hi(wy[b]);
                    const float b0 = w_lo(wx[b]), b1 = w_hi(wx[b]);
                    float out[N];
#pragma unroll
                    for (int e = 0; e < N; ++e) {  // both source columns rounded by one conversion
                        const uint32_t u = pack_bf16x2(__fadd_rn(__fmul_rn(a0, V::get(v[b][0], e)),
                                                                 __fmul_rn(a1, V::get(v[b][1], e))),
                                                       __fadd_rn(__fmul_rn(a0, V::get(v[b][2], e)),
                                                                 __fmul_rn(a1, V::get(v[b][3], e))));
                        out[e] = __fadd_rn(__fmul_rn(b0, w_lo(u)), __fmul_rn(b1, w_hi(u)));
                    }
                    auto val = win_value(s_win, out);  // rounds out to the window's type
                    for (int r = 0; r < n_cta; ++r) {  // into every block of the cluster
                        auto* dst = cluster.map_shared_rank(s_win + off[b], r);
                        *reinterpret_cast<decltype(val)*>(dst) = val;
                    }
#pragma unroll
                    for (int e = 0; e < N; ++e) sq = fmaf(out[e], out[e], sq);
                }
                const int k = i / nM;
                if (i - k * nM == nM - 1) {  // the group's bin is complete (uniform)
                    for (int o = G >> 1; o > 0; o >>= 1)
                        sq = __fadd_rn(sq, __shfl_xor_sync(kFull, sq, o));
                    const int bin = grp + k * nG;
                    if (gl == 0 && bin < n_bins) {
                        for (int r = 0; r < n_cta; ++r)
                            *cluster.map_shared_rank(s_sqbin + bin0 + bin, r) = sq;
                    }
                    sq = 0.0f;
                }
            }
        }
    }
}

// Step 3: the partial responses of template rows [pa, pb) (partial pc) over
// response rows [ra, rb): s_part[pc][r1][r2] = sum over p, q, c of
// window[r1 + p][r2 + q][c] * template[p][q][c]. One warp; lanes on channels
// c = lane + 32 j. With a compile-time shape (kP > 0: one template row, pb =
// pa + 1), a lane holds its channels' template row in registers and loads
// the kTile + P - 1 window values of a tile once; else it reads the template
// from shared memory and slides its window values along the row.
template <int kQ, int kP, int kC, typename WinE>
__device__ __forceinline__ void correlate_rows(const WinE* s_win, const float* s_tpl,
                                               float* s_part, cg::cluster_group& cluster,
                                               int n_cta, int pc, int pa, int pb, int ra, int rb,
                                               int Q_, int P_, int C_, int lane) {
    const int Q = kQ ? kQ : Q_, P = kP ? kP : P_, C = kC ? kC : C_;
    const int R = Q - P + 1;
    const int nJ = (C + 31) >> 5;
    constexpr int kJ = kC ? (kC + 31) / 32 : 1;
    constexpr int kPr = kP ? kP : 1;
    float t[kJ][kPr];
    if constexpr (kP > 0) {
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
            const int c = lane + 32 * j;
#pragma unroll
            for (int q = 0; q < kP; ++q) t[j][q] = c < C ? s_tpl[(pa * P + q) * C + c] : 0.0f;
        }
    }
    for (int r1 = ra; r1 < rb; ++r1) {
#pragma unroll
        for (int x0 = 0; x0 < (kQ ? kQ - kP + 1 : R); x0 += kTile) {
            float acc[kTile];
#pragma unroll
            for (int m = 0; m < kTile; ++m) acc[m] = 0.0f;
            for (int p = pa; p < pb; ++p) {
                const WinE* row = s_win + static_cast<size_t>(r1 + p) * Q * C;
                if constexpr (kP > 0) {
#pragma unroll
                    for (int j = 0; j < kJ; ++j) {
                        const int c = lane + 32 * j;
                        const bool cv = c < C;
                        float wv[kTile + kP - 1];  // the window at columns x0 .. x0 + kTile + P - 2
#pragma unroll
                        for (int m = 0; m < kTile + kP - 1; ++m)
                            wv[m] = (cv && x0 + m < Q) ? win_load(row + (x0 + m) * C + c) : 0.0f;
#pragma unroll
                        for (int q = 0; q < kP; ++q) {
#pragma unroll
                            for (int m = 0; m < kTile; ++m) acc[m] = fmaf(wv[m + q], t[j][q], acc[m]);
                        }
                    }
                } else {
                    const float* trow = s_tpl + p * P * C;
                    for (int j = 0; j < nJ; ++j) {
                        const int c = lane + 32 * j;
                        const bool cv = c < C;
                        float wv[kTile];
#pragma unroll
                        for (int m = 0; m < kTile; ++m)
                            wv[m] = (cv && x0 + m < Q) ? win_load(row + (x0 + m) * C + c) : 0.0f;
                        for (int q = 0; q < P; ++q) {
                            if (q > 0) {
#pragma unroll
                                for (int m = 0; m < kTile - 1; ++m) wv[m] = wv[m + 1];
                                const int xn = x0 + kTile - 1 + q;
                                wv[kTile - 1] = (cv && xn < Q) ? win_load(row + xn * C + c) : 0.0f;
                            }
                            const float tv = cv ? trow[q * C + c] : 0.0f;
#pragma unroll
                            for (int m = 0; m < kTile; ++m) acc[m] = fmaf(wv[m], tv, acc[m]);
                        }
                    }
                }
            }
            float a8[8];
#pragma unroll
            for (int m = 0; m < 8; ++m) a8[m] = acc[m];
            const float s8 = reduce_scatter8(a8, lane);
            const float s9 = warp_sum(acc[8]);
            float* out = s_part + (static_cast<size_t>(pc) * R + r1) * R + x0;
            const int v = (lane >> 2) & 7;
            for (int r = 0; r < n_cta; ++r) {  // into every block of the cluster
                float* o = cluster.map_shared_rank(out, r);
                if ((lane & 3) == 0 && x0 + v < R) o[v] = s8;
                if (lane == 0 && x0 + 8 < R) o[8] = s9;
            }
        }
    }
}

// kQ, kP, kC > 0: the shape compiled in (the tracker's defaults, the main
// path; every loop bound and index is a constant); 0: the launch's values.
template <typename FeatT, bool kVec, int kQ, int kP, int kC>
__global__ void __launch_bounds__(kThreads, 1)
track_scan_kernel(const FeatT* __restrict__ feats,         // (T, H, W, C)
                  const int* __restrict__ anchor_ts,       // (A,)
                  const float* __restrict__ anchor_boxes,  // (A, 4)
                  const float* __restrict__ templates,     // (A, P, P, C)
                  float* __restrict__ out_box,             // (2, T, A, 4)
                  float* __restrict__ out_conf,            // (2, T, A)
                  uint8_t* __restrict__ out_alive,         // (2, T, A) bool
                  int T, int A, int H, int W, int C_, int Q_, int P_, int stride, float factor,
                  float conf_thresh, int n_parts_, size_t win_bytes) {
    using WinE = typename Vec<FeatT, kVec>::W;
    const int Q = kQ ? kQ : Q_, P = kP ? kP : P_, C = kC ? kC : C_;
    const int n_parts = kP ? kP : n_parts_;
    const int R = Q - P + 1;
    const int n_pos = R * R;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    WinE* s_win = reinterpret_cast<WinE*>(smem_raw);            // (Q, Q, C) pooled window
    float* s_tpl = reinterpret_cast<float*>(smem_raw + win_bytes);  // (P, P, C) template
    float* s_part = s_tpl + P * P * C;       // (n_parts, R, R) partial responses
    float* s_rowsq = s_part + n_parts * n_pos;  // (Q, R) row sums of the bin norms
    float* s_sqbin = s_rowsq + Q * R;        // (Q, Q) sum over C of the window's squares

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    // the cluster's n_cta blocks share one lane: block crank pools window
    // rows [p0, p1) and takes every n_cta-th correlation item
    cg::cluster_group cluster = cg::this_cluster();
    const int n_cta = static_cast<int>(cluster.num_blocks());
    const int crank = static_cast<int>(cluster.block_rank());
    const int lane_id = blockIdx.x / n_cta;
    const int dir = lane_id / A;  // 0: forward lane, 1: backward lane
    const int a = lane_id - dir * A;
    const int at = anchor_ts[a];
    const float* tg = templates + static_cast<size_t>(a) * P * P * C;
    for (int k = tid; k < P * P * C; k += kThreads) s_tpl[k] = tg[k];
    const int p0 = crank * Q / n_cta, p1 = (crank + 1) * Q / n_cta;
    const float stride_f = static_cast<float>(stride);
    const size_t frame = static_cast<size_t>(H) * W * C;
    const int n_sets = min(kTapSets, (2 * Q + 31) / 32);
    // correlation items: (partial pc, chunk of response rows)
    const int n_pp = (P + n_parts - 1) / n_parts;  // template rows of a partial
    const int n_ch = min(R, max(1, (kWarps * n_cta + n_parts - 1) / n_parts));
    const int rows_ch = (R + n_ch - 1) / n_ch;
    const int n_items = n_parts * n_ch;

    // the lane's state, held identically by every thread
    float abox[4], box[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    bool alive = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) abox[j] = anchor_boxes[a * 4 + j];

    cluster.sync();  // every block runs (its shared memory is a target) and has its template
#ifdef TRACK_SCAN_PHASE_CLOCKS
    unsigned long long clk_[6] = {0, 0, 0, 0, 0, 0};
#endif
    for (int i = 0; i < T; ++i) {
#ifdef TRACK_SCAN_PHASE_CLOCKS
        long long mark_ = clock64();
#endif
        const int t = dir == 0 ? i : T - 1 - i;
        const bool started = t == at;
        // 1. box, search window, bilinear taps
        float cur[4], sbox[4], win[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) cur[j] = started ? abox[j] : box[j];
        // ncc_update at scale 1.0 (a multiplication by 1.0 is exact)
        const float cx = __fmul_rn(0.5f, __fadd_rn(cur[0], cur[2]));
        const float cy = __fmul_rn(0.5f, __fadd_rn(cur[1], cur[3]));
        const float bw = __fsub_rn(cur[2], cur[0]);
        const float bh = __fsub_rn(cur[3], cur[1]);
        sbox[0] = __fsub_rn(cx, __fmul_rn(bw, 0.5f));
        sbox[1] = __fsub_rn(cy, __fmul_rn(bh, 0.5f));
        sbox[2] = __fadd_rn(cx, __fmul_rn(bw, 0.5f));
        sbox[3] = __fadd_rn(cy, __fmul_rn(bh, 0.5f));
        // search_window
        const float wcx = __fmul_rn(0.5f, __fadd_rn(sbox[0], sbox[2]));
        const float wcy = __fmul_rn(0.5f, __fadd_rn(sbox[1], sbox[3]));
        const float ww = __fmul_rn(__fsub_rn(sbox[2], sbox[0]), factor);
        const float wh = __fmul_rn(__fsub_rn(sbox[3], sbox[1]), factor);
        win[0] = __fsub_rn(wcx, __fmul_rn(0.5f, ww));
        win[1] = __fsub_rn(wcy, __fmul_rn(0.5f, wh));
        win[2] = __fadd_rn(wcx, __fmul_rn(0.5f, ww));
        win[3] = __fadd_rn(wcy, __fmul_rn(0.5f, wh));
        LaneTaps lt;
#pragma unroll
        for (int s = 0; s < kTapSets; ++s) {
            const int j = lane + 32 * s;
            lt.g[s] = 0;
            lt.w[s] = 0;
            if (s < n_sets && j < 2 * Q) axis_tap(win, j, Q, H, W, stride_f, lt.g[s], lt.w[s]);
        }
        PHASE(0);

        // 2. pool this block's rows of the window and their norms into every block
        pool_window<FeatT, kVec, kQ, kC>(feats + t * frame, s_win, s_sqbin, cluster, n_cta, p0 * Q,
                                         (p1 - p0) * Q, lt, n_sets, win, Q, H, W, C, stride_f, tid);
        PHASE(1);
        cluster.sync();  // barrier 1: the whole window is in every block
        PHASE(2);

        // 3. row sums of the bin norms; partial responses
        for (int e = tid; e < Q * R; e += kThreads) {
            const int y = e / R, r2 = e - y * R;
            s_rowsq[e] = fixed_sum<kP>(s_sqbin + y * Q + r2, P, 1);
        }
        for (int it = crank * kWarps + warp; it < n_items; it += kWarps * n_cta) {
            const int pc = it / n_ch, ch = it - pc * n_ch;
            const int pa = pc * n_pp, pb = min(P, pa + n_pp);
            const int ra = ch * rows_ch, rb = min(R, ra + rows_ch);
            correlate_rows<kQ, kP, kC>(s_win, s_tpl, s_part, cluster, n_cta, pc, pa, pb, ra, rb,
                                       Q, P, C, lane);
        }
        PHASE(3);
        cluster.sync();  // barrier 2: every partial response is in every block
        PHASE(4);

        // 4. every warp alike: normalized response, soft-argmax, self-gated
        // update; lane l takes the offsets k = l + 32 j
        auto ncc_at = [&](int k) {
            const int r1 = k / R, r2 = k - r1 * R;
            const float resp = fixed_sum<kP>(s_part + k, n_parts, n_pos);
            const float sq = fixed_sum<kP>(s_rowsq + r1 * R + r2, P, R);
            return __fdiv_rn(resp, __fsqrt_rn(__fadd_rn(sq, 1e-6f)));
        };
        float val[kMaxK];
        float peak = -INFINITY;
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) {
            const int k = lane + 32 * j;
            val[j] = k < n_pos ? ncc_at(k) : -INFINITY;
            peak = fmaxf(peak, val[j]);
        }
        for (int k = lane + 32 * kMaxK; k < n_pos; k += 32) peak = fmaxf(peak, ncc_at(k));
        peak = warp_max(peak);
        // softmax(50 * resp) with its maximum subtracted, then the expectation
        const float mx = __fmul_rn(kTemperature, peak);
        float den = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) {
            if (lane + 32 * j < n_pos) {
                val[j] = expf(__fsub_rn(__fmul_rn(kTemperature, val[j]), mx));
                den = __fadd_rn(den, val[j]);
            }
        }
        for (int k = lane + 32 * kMaxK; k < n_pos; k += 32)
            den = __fadd_rn(den, expf(__fsub_rn(__fmul_rn(kTemperature, ncc_at(k)), mx)));
        den = warp_sum(den);
        float py = 0.0f, px = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) {
            const int k = lane + 32 * j;
            if (k < n_pos) {
                const float wk = __fdiv_rn(val[j], den);
                py = __fadd_rn(py, __fmul_rn(wk, static_cast<float>(k / R)));
                px = __fadd_rn(px, __fmul_rn(wk, static_cast<float>(k - (k / R) * R)));
            }
        }
        for (int k = lane + 32 * kMaxK; k < n_pos; k += 32) {
            const float e = expf(__fsub_rn(__fmul_rn(kTemperature, ncc_at(k)), mx));
            const float wk = __fdiv_rn(e, den);
            py = __fadd_rn(py, __fmul_rn(wk, static_cast<float>(k / R)));
            px = __fadd_rn(px, __fmul_rn(wk, static_cast<float>(k - (k / R) * R)));
        }
        py = warp_sum(py);
        px = warp_sum(px);
        const float half = static_cast<float>(R - 1) / 2.0f;
        const float dx = __fmul_rn(__fsub_rn(px, half),
                                   div_rn(__fsub_rn(win[2], win[0]), static_cast<float>(Q)));
        const float dy = __fmul_rn(__fsub_rn(py, half),
                                   div_rn(__fsub_rn(win[3], win[1]), static_cast<float>(Q)));
        const bool alive2 = alive || started;
        const bool track_now = alive2 && !started;
        const bool ok = peak > conf_thresh;
        const bool upd = track_now && ok;
        alive = track_now ? (alive2 && ok) : alive2;
        box[0] = upd ? __fadd_rn(sbox[0], dx) : cur[0];
        box[1] = upd ? __fadd_rn(sbox[1], dy) : cur[1];
        box[2] = upd ? __fadd_rn(sbox[2], dx) : cur[2];
        box[3] = upd ? __fadd_rn(sbox[3], dy) : cur[3];
        if (crank == 0 && tid == 0) {
            const size_t o = (static_cast<size_t>(dir) * T + t) * A + a;
#pragma unroll
            for (int j = 0; j < 4; ++j) out_box[o * 4 + j] = box[j];
            out_conf[o] = started ? 1.0f : peak;
            out_alive[o] = (started || alive) ? 1 : 0;
        }
        PHASE(5);
    }
#ifdef TRACK_SCAN_PHASE_CLOCKS
    if (blockIdx.x == 0 && tid == 0) {
        for (int k = 0; k < 6; ++k) g_phase_clocks[k] += clk_[k];
        g_phase_clocks[6] += T;
    }
#endif
}

// The layout of the dynamic shared memory (kernels/track_scan.py::_smem_bytes
// mirrors it): the window in the features' type, 16-byte aligned, then
// float32 template, partials, row sums and bin norms.
size_t window_bytes(int Q, int C, size_t elem) {
    return (static_cast<size_t>(Q) * Q * C * elem + 15) & ~static_cast<size_t>(15);
}

size_t smem_bytes(int Q, int P, int C, size_t elem, int parts) {
    const size_t R = static_cast<size_t>(Q - P + 1);
    return window_bytes(Q, C, elem) +
           4 * (static_cast<size_t>(P) * P * C + parts * R * R + Q * R + static_cast<size_t>(Q) * Q);
}

template <typename FeatT, bool kVec, int kQ, int kP, int kC>
int launch_as(const FeatT* feats, const int* anchor_ts, const float* anchor_boxes,
              const float* templates, float* out_box, float* out_conf, uint8_t* out_alive, int T,
              int A, int H, int W, int C, int Q, int P, int stride, float factor,
              float conf_thresh, int n_cta, int parts, size_t smem, cudaStream_t stream) {
    auto kernel = track_scan_kernel<FeatT, kVec, kQ, kP, kC>;
    // fails where the layout exceeds what one block may opt in to
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2 * A * n_cta);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n_cta;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, feats, anchor_ts, anchor_boxes, templates, out_box,
                             out_conf, out_alive, T, A, H, W, C, Q, P, stride, factor, conf_thresh,
                             parts, window_bytes(Q, C, sizeof(FeatT)));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

template <typename FeatT>
int launch(const FeatT* feats, const int* anchor_ts, const float* anchor_boxes,
           const float* templates, float* out_box, float* out_conf, uint8_t* out_alive, int T,
           int A, int H, int W, int C, int Q, int P, int stride, float factor, float conf_thresh,
           int n_cta, int parts, cudaStream_t stream) {
    const size_t smem = smem_bytes(Q, P, C, sizeof(FeatT), parts);
    const int vw = 16 / static_cast<int>(sizeof(FeatT));
    const bool vec = C % vw == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0;
#define VDET_TRACK_LAUNCH(V, Qc, Pc, Cc)                                                  \
    return launch_as<FeatT, V, Qc, Pc, Cc>(feats, anchor_ts, anchor_boxes, templates, out_box, \
                                           out_conf, out_alive, T, A, H, W, C, Q, P, stride,   \
                                           factor, conf_thresh, n_cta, parts, smem, stream)
    // the tracker's default pools and width (search_pool 16, template_pool 8,
    // 96 channels) compiled in; any other shape at run time
    if (vec && Q == 16 && P == 8 && C == 96 && parts == P) VDET_TRACK_LAUNCH(true, 16, 8, 96);
    if (vec) VDET_TRACK_LAUNCH(true, 0, 0, 0);
    VDET_TRACK_LAUNCH(false, 0, 0, 0);
#undef VDET_TRACK_LAUNCH
}

}  // namespace

// feats (T, H, W, C) bf16 (feats_bf16 = 1) or float32; anchor_ts (A,) int32;
// anchor_boxes (A, 4), templates (A, P, P, C) float32 → out_box (2, T, A, 4),
// out_conf (2, T, A) float32 and out_alive (2, T, A) bool, by frame.
// 1 <= P <= Q. The wrapper (kernels/track_scan.py) chooses the launch: n_cta
// blocks a lane (1..8, a cluster) and parts partial responses (1..P); the
// dynamic shared memory (smem_bytes above) must fit one block. Returns
// cudaGetLastError() (or the attribute call's error).
extern "C" int vdet_track_scan(const void* feats, int feats_bf16, const void* anchor_ts,
                               const void* anchor_boxes, const void* templates, void* out_box,
                               void* out_conf, void* out_alive, int T, int A, int H, int W, int C,
                               int Q, int P, int stride, float factor, float conf_thresh,
                               int n_cta, int parts, void* stream) {
    if (P < 1 || Q < P || n_cta < 1 || n_cta > kMaxCluster || parts < 1 || parts > P)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto* ats = static_cast<const int*>(anchor_ts);
    const auto* boxes = static_cast<const float*>(anchor_boxes);
    const auto* tpls = static_cast<const float*>(templates);
    auto* ob = static_cast<float*>(out_box);
    auto* oc = static_cast<float*>(out_conf);
    auto* oa = static_cast<uint8_t*>(out_alive);
    auto st = static_cast<cudaStream_t>(stream);
    if (feats_bf16)
        return launch(static_cast<const __nv_bfloat16*>(feats), ats, boxes, tpls, ob, oc, oa, T,
                      A, H, W, C, Q, P, stride, factor, conf_thresh, n_cta, parts, st);
    return launch(static_cast<const float*>(feats), ats, boxes, tpls, ob, oc, oa, T, A, H, W, C, Q,
                  P, stride, factor, conf_thresh, n_cta, parts, st);
}

#ifdef TRACK_SCAN_PHASE_CLOCKS
// Debug build only: copy block 0's per-phase clocks and step count into
// host[0..6] (reset = 1 zeroes them instead).
extern "C" int vdet_track_scan_phase_clocks(unsigned long long* host, int reset) {
    if (reset) {
        const unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};
        return static_cast<int>(cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero)));
    }
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_phase_clocks, sizeof(unsigned long long) * 7));
}
#endif
