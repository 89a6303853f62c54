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
// multiply-adds at Q = 16, P = 8, C = 96, the pooling and the norms); steps
// before a lane's anchor, at it and after its death need no features at
// all. By the card's peaks that is a few microseconds for a round of 48
// steps. In practice the chain of T dependent steps bounds it: each step
// waits for the previous step's box.
//
// Design. The Pallas body is shaped by Mosaic's limits (dense (A*Q, h)
// one-hot matmuls, scratch refs, a hand-unrolled fori loop); none applies
// here. Each of the 2A lanes is an independent sequential chain that shares
// only the read-only features, so one persistent block of 512 threads owns
// one lane and loops over the T steps itself; its box and alive flag live in
// the registers of warp 0 (every lane of warp 0 holds the same copy), and no
// grid-wide synchronisation is needed. One step:
//  1. warp 0 computes the window and the two non-zero bilinear taps of each
//     of the Q rows and Q columns (_bilinear_weights has at most two per row);
//  2. the warps pool the Q x Q x C window into shared memory, one bin at a
//     time per warp, its lanes on neighbouring channels (coalesced feature
//     reads, no index division per value):
//     u = bf16(wy_lo * f_lo + wy_hi * f_hi) per source column, then
//     bf16(wx_lo * u_lo + wx_hi * u_hi) (no rounding for float32 features);
//  3. the warps share out the response's (row, kTile offsets) tiles: each
//     lane owns channels c = lane + 32k and slides kTile window values of
//     its channel along the template row in registers, then the warp sums
//     the kTile accumulators; the per-bin sums of squares over C are shared
//     out to the warps the same way;
//  4. warp 0 takes the P x P window sums of the bin norms, the normalized
//     response, its maximum (the peak), the softmax and the soft-argmax, and
//     updates the lane; lane 0 writes the step's outputs.
// The window (Q*Q*C floats, 96 KiB at Q = 16, C = 96) and the template
// (24 KiB at P = 8) need dynamic shared memory, opted in with
// cudaFuncSetAttribute. 2A blocks use 16 of the 132 SMs at A = 8; spreading
// a lane over a cluster is later work.
//
// Exactness: compiled with -fmad=false, so the window, the bilinear weights,
// the pooling and the box update round exactly as the plain version's ops
// do: bf16 x bf16 products are exact in float32 and the dense einsums add
// only exact zeros beside the two taps, so the pooled window is bit-equal to
// the plain version's. The correlation and norm sums (fmaf) and the softmax
// sums run in another order than cuDNN's or the CPU's: last-bit differences
// that the tracker's rollout amplifies over many steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4;  // response offsets along a row that one warp accumulates at once
constexpr float kTemperature = 50.0f;

__device__ __forceinline__ float bf16r(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// features.to(bfloat16).float()
__device__ __forceinline__ float load_feat(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_feat(const float* p) { return bf16r(*p); }

// the pooled value's last rounding, to the features' own dtype
__device__ __forceinline__ float round_out(float v, const __nv_bfloat16*) { return bf16r(v); }
__device__ __forceinline__ float round_out(float v, const float*) { return v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// The two non-zero taps of row j of nn/heads.py::_bilinear_weights(start,
// end, size, pool) rounded to bf16, in its op order: bin = (end - start) /
// pool, center = start + (j + 0.5) * bin, pos = clamp(center - 0.5, 0,
// size - 1), weight(g) = max(1 - |pos - g|, 0) at g = floor(pos) and g + 1.
// At the clamped end the second tap does not exist; it gets weight 0.
__device__ __forceinline__ void bilinear_taps(float start, float end, int j, int size,
                                              int pool, int& g0, int& g1, float& w0,
                                              float& w1) {
    const float bin = __fdiv_rn(__fsub_rn(end, start), static_cast<float>(pool));
    const float center = __fadd_rn(start, __fmul_rn(__fadd_rn(static_cast<float>(j), 0.5f), bin));
    const float pos = fminf(fmaxf(__fsub_rn(center, 0.5f), 0.0f), static_cast<float>(size - 1));
    const int lo = min(max(static_cast<int>(floorf(pos)), 0), size - 1);
    g0 = lo;
    w0 = bf16r(fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, static_cast<float>(lo)))), 0.0f));
    if (lo + 1 < size) {
        g1 = lo + 1;
        w1 = bf16r(fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, static_cast<float>(lo + 1)))),
                         0.0f));
    } else {
        g1 = lo;
        w1 = 0.0f;
    }
}

template <typename FeatT>
__global__ void __launch_bounds__(kThreads, 1)
track_scan_kernel(const FeatT* __restrict__ feats,         // (T, H, W, C)
                  const int* __restrict__ anchor_ts,       // (A,)
                  const float* __restrict__ anchor_boxes,  // (A, 4)
                  const float* __restrict__ templates,     // (A, P, P, C)
                  float* __restrict__ out_box,             // (2, T, A, 4)
                  float* __restrict__ out_conf,            // (2, T, A)
                  uint8_t* __restrict__ out_alive,         // (2, T, A) bool
                  int T, int A, int H, int W, int C, int Q, int P, int stride, float factor,
                  float conf_thresh) {
    const int R = Q - P + 1;
    const int n_pos = R * R;
    const int n_tiles = (R + kTile - 1) / kTile;

    extern __shared__ float smem[];
    float* s_win = smem;                  // (Q, Q, C) pooled search window
    float* s_tpl = s_win + Q * Q * C;     // (P, P, C) template
    float* s_sqbin = s_tpl + P * P * C;   // (Q, Q) sum over C of the window's squares
    float* s_resp = s_sqbin + Q * Q;      // (R, R) template dot products, then softmax terms
    float* s_wy = s_resp + R * R;         // (2, Q) row tap weights
    float* s_wx = s_wy + 2 * Q;           // (2, Q) column tap weights
    int* s_gy = reinterpret_cast<int*>(s_wx + 2 * Q);  // (2, Q) row tap indices
    int* s_gx = s_gy + 2 * Q;                          // (2, Q) column tap indices

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int dir = blockIdx.x / A;  // 0: forward lane, 1: backward lane
    const int a = blockIdx.x - dir * A;
    const int at = anchor_ts[a];
    const float* tg = templates + static_cast<size_t>(a) * P * P * C;
    for (int k = tid; k < P * P * C; k += kThreads) s_tpl[k] = tg[k];
    const float stride_f = static_cast<float>(stride);

    // the lane's state, held identically by every lane of warp 0
    float abox[4], box[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    bool alive = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) abox[j] = anchor_boxes[a * 4 + j];

    for (int i = 0; i < T; ++i) {
        const int t = dir == 0 ? i : T - 1 - i;
        const bool started = t == at;
        float cur[4], sbox[4], win[4];
        // 1. warp 0: box, search window, bilinear taps
        if (warp == 0) {
#pragma unroll
            for (int j = 0; j < 4; ++j) cur[j] = started ? abox[j] : box[j];
            // ncc_update at scale 1.0 (a multiplication by 1.0 is exact)
            const float cx = __fmul_rn(0.5f, __fadd_rn(cur[0], cur[2]));
            const float cy = __fmul_rn(0.5f, __fadd_rn(cur[1], cur[3]));
            const float bw = __fsub_rn(cur[2], cur[0]);
            const float bh = __fsub_rn(cur[3], cur[1]);
            sbox[0] = __fsub_rn(cx, __fdiv_rn(bw, 2.0f));
            sbox[1] = __fsub_rn(cy, __fdiv_rn(bh, 2.0f));
            sbox[2] = __fadd_rn(cx, __fdiv_rn(bw, 2.0f));
            sbox[3] = __fadd_rn(cy, __fdiv_rn(bh, 2.0f));
            // search_window
            const float wcx = __fmul_rn(0.5f, __fadd_rn(sbox[0], sbox[2]));
            const float wcy = __fmul_rn(0.5f, __fadd_rn(sbox[1], sbox[3]));
            const float ww = __fmul_rn(__fsub_rn(sbox[2], sbox[0]), factor);
            const float wh = __fmul_rn(__fsub_rn(sbox[3], sbox[1]), factor);
            win[0] = __fsub_rn(wcx, __fmul_rn(0.5f, ww));
            win[1] = __fsub_rn(wcy, __fmul_rn(0.5f, wh));
            win[2] = __fadd_rn(wcx, __fmul_rn(0.5f, ww));
            win[3] = __fadd_rn(wcy, __fmul_rn(0.5f, wh));
            for (int j = lane; j < 2 * Q; j += 32) {  // rows j < Q, columns j - Q
                const bool row = j < Q;
                const int b = row ? j : j - Q;
                int g0, g1;
                float w0, w1;
                bilinear_taps(__fdiv_rn(row ? win[1] : win[0], stride_f),
                              __fdiv_rn(row ? win[3] : win[2], stride_f), b, row ? H : W, Q, g0,
                              g1, w0, w1);
                int* g = row ? s_gy : s_gx;
                float* w = row ? s_wy : s_wx;
                g[b] = g0;
                g[Q + b] = g1;
                w[b] = w0;
                w[Q + b] = w1;
            }
        }
        __syncthreads();

        // 2. pool the window: contract the rows, round to bf16, contract the
        // columns; a warp takes whole bins (p, q), its lanes the channels
        const FeatT* f = feats + static_cast<size_t>(t) * H * W * C;
        for (int pq = warp; pq < Q * Q; pq += kWarps) {
            const int p = pq / Q;
            const int q = pq - p * Q;
            const size_t y0 = static_cast<size_t>(s_gy[p]) * W, y1 = static_cast<size_t>(s_gy[Q + p]) * W;
            const FeatT* f00 = f + (y0 + s_gx[q]) * C;
            const FeatT* f10 = f + (y1 + s_gx[q]) * C;
            const FeatT* f01 = f + (y0 + s_gx[Q + q]) * C;
            const FeatT* f11 = f + (y1 + s_gx[Q + q]) * C;
            const float a0 = s_wy[p], a1 = s_wy[Q + p], b0 = s_wx[q], b1 = s_wx[Q + q];
            float* out = s_win + pq * C;
#pragma unroll 4  // several channels' feature loads in flight at once
            for (int c = lane; c < C; c += 32) {
                const float u0 = bf16r(__fadd_rn(__fmul_rn(a0, load_feat(f00 + c)),
                                                 __fmul_rn(a1, load_feat(f10 + c))));
                const float u1 = bf16r(__fadd_rn(__fmul_rn(a0, load_feat(f01 + c)),
                                                 __fmul_rn(a1, load_feat(f11 + c))));
                out[c] = round_out(__fadd_rn(__fmul_rn(b0, u0), __fmul_rn(b1, u1)), f);
            }
        }
        __syncthreads();

        // 3. response tiles (template dot products) and the bins' sums of squares.
        // Tile (r1, x0) holds offsets r2 = x0 .. x0 + kTile - 1 of row r1; a
        // lane's window registers slide along the template row: at template
        // column q, wv[j] is the window value at column x0 + j + q
        for (int item = warp; item < R * n_tiles; item += kWarps) {
            const int r1 = item / n_tiles;
            const int x0 = (item - r1 * n_tiles) * kTile;
            float acc[kTile];
#pragma unroll
            for (int j = 0; j < kTile; ++j) acc[j] = 0.0f;
            for (int p = 0; p < P; ++p) {
                const float* wrow = s_win + (r1 + p) * Q * C;
                const float* trow = s_tpl + p * P * C;
                for (int c = lane; c < C; c += 32) {
                    float wv[kTile];
#pragma unroll
                    for (int j = 0; j < kTile; ++j)
                        wv[j] = x0 + j < Q ? wrow[(x0 + j) * C + c] : 0.0f;
#pragma unroll 4
                    for (int q = 0; q < P; ++q) {
                        const float tv = trow[q * C + c];
#pragma unroll
                        for (int j = 0; j < kTile; ++j) acc[j] = fmaf(wv[j], tv, acc[j]);
#pragma unroll
                        for (int j = 0; j < kTile - 1; ++j) wv[j] = wv[j + 1];
                        const int xn = x0 + kTile + q;
                        wv[kTile - 1] = xn < Q ? wrow[xn * C + c] : 0.0f;
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < kTile; ++j) {
                const float s = warp_sum(acc[j]);
                if (lane == 0 && x0 + j < R) s_resp[r1 * R + x0 + j] = s;
            }
        }
        for (int bin = warp; bin < Q * Q; bin += kWarps) {
            float s = 0.0f;
            for (int c = lane; c < C; c += 32) {
                const float v = s_win[bin * C + c];
                s = fmaf(v, v, s);
            }
            s = warp_sum(s);
            if (lane == 0) s_sqbin[bin] = s;
        }
        __syncthreads();

        // 4. warp 0: normalized response, soft-argmax, self-gated update; each
        // lane rewrites its own offsets k = lane + 32j of s_resp in place
        if (warp == 0) {
            float peak = -INFINITY;
            for (int k = lane; k < n_pos; k += 32) {
                const int r1 = k / R, r2 = k - (k / R) * R;
                float sq = 0.0f;
                for (int p = 0; p < P; ++p) {
                    for (int q = 0; q < P; ++q) sq = __fadd_rn(sq, s_sqbin[(r1 + p) * Q + r2 + q]);
                }
                const float ncc = __fdiv_rn(s_resp[k], __fsqrt_rn(__fadd_rn(sq, 1e-6f)));
                s_resp[k] = ncc;
                peak = fmaxf(peak, ncc);
            }
            peak = warp_max(peak);
            // softmax(50 * resp) with its maximum subtracted, then the expectation
            const float m = __fmul_rn(kTemperature, peak);
            float den = 0.0f;
            for (int k = lane; k < n_pos; k += 32) {
                const float e = expf(__fsub_rn(__fmul_rn(kTemperature, s_resp[k]), m));
                s_resp[k] = e;
                den = __fadd_rn(den, e);
            }
            den = warp_sum(den);
            float py = 0.0f, px = 0.0f;
            for (int k = lane; k < n_pos; k += 32) {
                const float wk = __fdiv_rn(s_resp[k], den);
                py = __fadd_rn(py, __fmul_rn(wk, static_cast<float>(k / R)));
                px = __fadd_rn(px, __fmul_rn(wk, static_cast<float>(k - (k / R) * R)));
            }
            py = warp_sum(py);
            px = warp_sum(px);
            const float half = static_cast<float>(R - 1) / 2.0f;
            const float dx = __fmul_rn(__fsub_rn(px, half),
                                       __fdiv_rn(__fsub_rn(win[2], win[0]), static_cast<float>(Q)));
            const float dy = __fmul_rn(__fsub_rn(py, half),
                                       __fdiv_rn(__fsub_rn(win[3], win[1]), static_cast<float>(Q)));
            const bool alive2 = alive || started;
            const bool track_now = alive2 && !started;
            const bool ok = peak > conf_thresh;
            const bool upd = track_now && ok;
            alive = track_now ? (alive2 && ok) : alive2;
            box[0] = upd ? __fadd_rn(sbox[0], dx) : cur[0];
            box[1] = upd ? __fadd_rn(sbox[1], dy) : cur[1];
            box[2] = upd ? __fadd_rn(sbox[2], dx) : cur[2];
            box[3] = upd ? __fadd_rn(sbox[3], dy) : cur[3];
            if (lane == 0) {
                const size_t o = (static_cast<size_t>(dir) * T + t) * A + a;
#pragma unroll
                for (int j = 0; j < 4; ++j) out_box[o * 4 + j] = box[j];
                out_conf[o] = started ? 1.0f : peak;
                out_alive[o] = (started || alive) ? 1 : 0;
            }
        }
        // no barrier here: the next step's first writes are warp 0's taps
        // and its own s_resp offsets, and every other warp waits for them at
        // the barrier after step 1
    }
}

template <typename FeatT>
int launch(const FeatT* feats, const int* anchor_ts, const float* anchor_boxes,
           const float* templates, float* out_box, float* out_conf, uint8_t* out_alive, int T,
           int A, int H, int W, int C, int Q, int P, int stride, float factor, float conf_thresh,
           cudaStream_t stream) {
    const int R = Q - P + 1;
    const size_t smem = sizeof(float) * (static_cast<size_t>(Q * Q + P * P) * C + Q * Q + R * R +
                                         8 * static_cast<size_t>(Q));
    auto kernel = track_scan_kernel<FeatT>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<2 * A, kThreads, smem, stream>>>(feats, anchor_ts, anchor_boxes, templates, out_box,
                                              out_conf, out_alive, T, A, H, W, C, Q, P, stride,
                                              factor, conf_thresh);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats (T, H, W, C) bf16 (feats_bf16 = 1) or float32; anchor_ts (A,) int32;
// anchor_boxes (A, 4), templates (A, P, P, C) float32 → out_box (2, T, A, 4),
// out_conf (2, T, A) float32 and out_alive (2, T, A) bool, by frame.
// 1 <= P <= Q; the dynamic shared memory, 4 * (Q*Q*C + P*P*C + Q*Q + R*R +
// 8*Q) bytes, must fit one block. Returns cudaGetLastError() (or the
// attribute call's error).
extern "C" int vdet_track_scan(const void* feats, int feats_bf16, const void* anchor_ts,
                               const void* anchor_boxes, const void* templates, void* out_box,
                               void* out_conf, void* out_alive, int T, int A, int H, int W, int C,
                               int Q, int P, int stride, float factor, float conf_thresh,
                               void* stream) {
    if (P < 1 || Q < P) return static_cast<int>(cudaErrorInvalidValue);
    const auto* ats = static_cast<const int*>(anchor_ts);
    const auto* boxes = static_cast<const float*>(anchor_boxes);
    const auto* tpls = static_cast<const float*>(templates);
    auto* ob = static_cast<float*>(out_box);
    auto* oc = static_cast<float*>(out_conf);
    auto* oa = static_cast<uint8_t*>(out_alive);
    auto st = static_cast<cudaStream_t>(stream);
    if (feats_bf16)
        return launch(static_cast<const __nv_bfloat16*>(feats), ats, boxes, tpls, ob, oc, oa, T,
                      A, H, W, C, Q, P, stride, factor, conf_thresh, st);
    return launch(static_cast<const float*>(feats), ats, boxes, tpls, ob, oc, oa, T, A, H, W, C, Q,
                  P, stride, factor, conf_thresh, st);
}
