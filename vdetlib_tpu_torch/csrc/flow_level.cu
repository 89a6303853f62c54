// Block-matching flow level for P frame pairs (kernel A of the port).
//
// Replaces the TPU kernel vdetlib_tpu/kernels/flow_pallas.py::flow_level_pallas
// (_flow_kernel). Same function as vdetlib_tpu_torch/kernels/flow_level.py::_flow_level,
// the plain version beside this kernel's wrapper: for each of the S*S integer
// shifts (dx, dy) in [-search, search]^2 the squared difference between i1 and
// the shifted i2 (rows and columns clamped to the image edge) is box-filtered
// over a (2r+1)^2 window with zero padding and divided by (2r+1)^2; a
// soft-argmin over the shifts (temperature, f32 accumulators) gives the flow
// (dx, dy) of each pixel. Inputs are bf16 (the fast presets' reduced levels)
// or f32 (the accurate pyramid's levels); all arithmetic is f32. The element
// type enters only where the staging loads turn each value into f32 in
// shared memory, so the two types share every line of the shift loop.
//
// What bounds it on an H100: float32 instructions and their latency, not
// bytes. At P = 255 pairs of 60x80 the inputs are 4.9 MB and the output 9.8
// MB (0.0044 ms at 3.35 TB/s), while the cost volume is 121 shifts x 4800 px
// x ~30 operations a pair. The TPU kernel's problem was HBM traffic of
// per-shift temporaries; here nothing but the inputs and the flow touches
// device memory. The first port of this kernel was bound by block barriers
// (two per shift), a row pass that recomputed its halo, integer divisions in
// the loop and a grid of one partial wave at the paths' 32 pairs. This one
// runs one 11-warp block per SM (168 registers a thread for the ring below),
// so its limit is how well 11 warps hide the latency of their FMA chains.
//
// Design: one block per (pair, tile of 32 columns x tile_h rows); a lane owns
// one column of the tile and the block's warps split the shifts by dy (one dy
// a warp when 2*search+1 <= 32), so the grid has 2*search+1 warps per tile and
// fills the card at P = 32. The tile's i1 window and the i2 rows and columns
// any shift reaches are staged in shared memory once; after one barrier the
// shift loop reads only shared memory and registers, with no further barrier:
// - a lane walks down its column; for each row it loads the i1 taps and the i2
//   taps of every dx once and forms the horizontal window sums of all dx from
//   registers;
// - the vertical window is a register ring of the last 2r+1 row sums of each
//   dx, summed afresh for each output row (no add-new/subtract-old residue);
//   the row loop is unrolled by 2r+1, so every ring index is static;
// - once a row's sums are complete, the lane forms the soft-argmin over its dx
//   in two passes: the minimum m, then exp2((m - c) * t * log2(e) / (2r+1)^2)
//   once per shift (the weight of the minimum is exp2(0) = 1 exactly);
// - after a second barrier the warps' partial states (m, den, fx, fy) of each
//   pixel are merged in shared memory: m = min m_j, den = sum den_j
//   exp(-t (m_j - m)), the same for fx and fy; a part with m_j = m weighs 1.
// Rows outside the image add nothing (a warp-uniform skip); columns outside
// the image add nothing (a per-lane tap mask, only in tiles at the image's
// left or right edge). The ring needs the window sizes at compile time:
// (search, radius) = (5, 3), the fast presets' window, and (3, 3), the
// accurate pyramid's, have that specialisation; any other search and radius
// take the run-time kernel, which sums each window directly from shared
// memory and updates its soft-argmin online with one exponential per shift.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;  // columns of a tile: one per lane

__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// an input element as f32: bf16 arrives as its raw 16-bit word
__device__ __forceinline__ float to_f32(uint16_t v) { return bf16_to_f32(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// 2^x in one SFU instruction (subnormal results flush to zero)
__device__ __forceinline__ float exp2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

struct Tile {
    int pair, x0, y0, th;  // th: output rows of this tile (the last is ragged)
};

__device__ __forceinline__ Tile tile_of(int H, int W, int tile_h) {
    const int ntx = (W + TILE_W - 1) / TILE_W;
    Tile t;
    t.pair = blockIdx.y;
    t.x0 = (blockIdx.x % ntx) * TILE_W;
    t.y0 = (blockIdx.x / ntx) * tile_h;
    t.th = min(tile_h, H - t.y0);
    return t;
}

// Shared memory of a block: the warps' partial states, then the i1 window
// (tile_h + 2r rows of 32 + 2r columns, zero outside the image), then the i2
// window (2s more rows and columns, clamped to the image). The wrapper
// (kernels/flow_level.py::smem_bytes) sizes it the same way.
struct Smem {
    float4* part;
    float* s1;
    float* s2;
};

__device__ __forceinline__ Smem smem_of(int tile_h, int nw, int search, int radius) {
    extern __shared__ float4 smem4[];
    Smem s;
    s.part = smem4;
    s.s1 = reinterpret_cast<float*>(smem4 + nw * tile_h * TILE_W);
    s.s2 = s.s1 + (tile_h + 2 * radius) * (TILE_W + 2 * radius);
    return s;
}

template <typename T>
__device__ void stage(const T* __restrict__ i1, const T* __restrict__ i2,
                      const Smem& s, const Tile& t, int H, int W, int search, int radius) {
    const int c1 = TILE_W + 2 * radius, r1 = t.th + 2 * radius;
    const int c2 = c1 + 2 * search, r2 = r1 + 2 * search;
    const T* p1 = i1 + static_cast<size_t>(t.pair) * H * W;
    const T* p2 = i2 + static_cast<size_t>(t.pair) * H * W;
#pragma unroll 4
    for (int e = threadIdx.x; e < r1 * c1; e += blockDim.x) {
        const int r = e / c1;
        const int y = t.y0 - radius + r;
        const int x = t.x0 - radius + (e - r * c1);
        s.s1[e] = (y >= 0 && y < H && x >= 0 && x < W) ? to_f32(p1[y * W + x]) : 0.f;
    }
#pragma unroll 4
    for (int e = threadIdx.x; e < r2 * c2; e += blockDim.x) {
        const int r = e / c2;
        const int y = min(max(t.y0 - radius - search + r, 0), H - 1);
        const int x = min(max(t.x0 - radius - search + (e - r * c2), 0), W - 1);
        s.s2[e] = to_f32(p2[y * W + x]);
    }
}

// Merge the nw partial soft-argmin states of each pixel of the tile (costs in
// box-sum units; tl = temperature * log2(e) / area) and write its flow.
__device__ void merge(const float4* part, int nw, float* __restrict__ out, const Tile& t,
                      int H, int W, float tl) {
    const int n = t.th * TILE_W;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
        const int x = t.x0 + p % TILE_W;
        if (x >= W) continue;
        float m = INFINITY;
        for (int j = 0; j < nw; ++j) m = fminf(m, part[j * n + p].x);
        float den = 0.f, fx = 0.f, fy = 0.f;
        for (int j = 0; j < nw; ++j) {
            const float4 q = part[j * n + p];
            const float e = q.x == m ? 1.f : exp2_ftz((m - q.x) * tl);
            den = fmaf(q.y, e, den);
            fx = fmaf(q.z, e, fx);
            fy = fmaf(q.w, e, fy);
        }
        const size_t o = (static_cast<size_t>(t.pair) * H + t.y0 + p / TILE_W) * W + x;
        reinterpret_cast<float2*>(out)[o] = make_float2(fx / den, fy / den);
    }
}

// Horizontal window sums of one row for every dx: a[k] are the lane's i1
// taps, b[j] its i2 taps (tap k of shift dx is b[k + dx]). In a tile at the
// image's LEFT (RIGHT) edge the taps left (right) of the centre may lie
// outside the image: there mask[k] = 0 drops them.
template <int K, int S, bool LEFT, bool RIGHT>
__device__ __forceinline__ void row_sums(const float* __restrict__ a_row,
                                         const float* __restrict__ b_row,
                                         const float (&mask)[K], float (&h)[S]) {
    float a[K], b[K + S - 1];
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] = a_row[k];
#pragma unroll
    for (int j = 0; j < K + S - 1; ++j) b[j] = b_row[j];
#pragma unroll
    for (int dx = 0; dx < S; ++dx) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            float d = a[k] - b[k + dx];
            if ((LEFT && k < K / 2) || (RIGHT && k > K / 2)) d *= mask[k];
            acc = fmaf(d, d, acc);
        }
        h[dx] = acc;
    }
}

// The (search, radius) = (SEARCH, RADIUS) kernel: one warp per dy, the
// vertical window as a register ring of row sums. T is the input element:
// uint16_t (bf16 words) or float.
template <int SEARCH, int RADIUS, typename T>
__global__ void __launch_bounds__((2 * SEARCH + 1) * 32, 1)
flow_level_kernel(const T* __restrict__ i1, const T* __restrict__ i2,
                 float* __restrict__ out, int H, int W, int tile_h, float tl) {
    constexpr int S = 2 * SEARCH + 1, K = 2 * RADIUS + 1;
    constexpr int C1 = TILE_W + 2 * RADIUS, C2 = C1 + 2 * SEARCH;
    const Tile t = tile_of(H, W, tile_h);
    const Smem s = smem_of(tile_h, S, SEARCH, RADIUS);
    stage(i1, i2, s, t, H, W, SEARCH, RADIUS);
    __syncthreads();

    const int lane = threadIdx.x % 32;
    const int w = threadIdx.x / 32;  // this warp's dy is w - SEARCH
    const int x = t.x0 + lane;
    const bool left = t.x0 < RADIUS, right = t.x0 + TILE_W + RADIUS > W;
    float mask[K];
#pragma unroll
    for (int k = 0; k < K; ++k) mask[k] = (x - RADIUS + k >= 0 && x - RADIUS + k < W) ? 1.f : 0.f;
    // row r of the i1 window is image row y0 - RADIUS + r; the i2 window's row
    // r + w holds image row clamp(y0 - RADIUS + r + dy)
    const float* a_base = s.s1 + lane;
    const float* b_base = s.s2 + w * C2 + lane;
    const int rows = t.th + 2 * RADIUS;
    const int n = t.th * TILE_W;
    const float dyf = static_cast<float>(w - SEARCH);
    float ring[K][S];
    for (int r0 = 0; r0 < rows; r0 += K) {
#pragma unroll
        for (int q = 0; q < K; ++q) {  // ring slot q holds row r0 + q
            const int r = r0 + q;
            if (r >= rows) break;
            const int y = t.y0 - RADIUS + r;
            if (y < 0 || y >= H) {
#pragma unroll
                for (int dx = 0; dx < S; ++dx) ring[q][dx] = 0.f;
            } else if (left && right) {
                row_sums<K, S, true, true>(a_base + r * C1, b_base + r * C2, mask, ring[q]);
            } else if (left) {
                row_sums<K, S, true, false>(a_base + r * C1, b_base + r * C2, mask, ring[q]);
            } else if (right) {
                row_sums<K, S, false, true>(a_base + r * C1, b_base + r * C2, mask, ring[q]);
            } else {
                row_sums<K, S, false, false>(a_base + r * C1, b_base + r * C2, mask, ring[q]);
            }
            if (r < 2 * RADIUS) continue;
            // output row r - 2 RADIUS: its window is the whole ring
            float c[S];
#pragma unroll
            for (int dx = 0; dx < S; ++dx) {
                float v = ring[0][dx];
#pragma unroll
                for (int k = 1; k < K; ++k) v += ring[k][dx];
                c[dx] = v;
            }
            float m = c[0];
#pragma unroll
            for (int dx = 1; dx < S; ++dx) m = fminf(m, c[dx]);
            float den = 0.f, fx = 0.f;
#pragma unroll
            for (int dx = 0; dx < S; ++dx) {
                const float e = exp2_ftz((m - c[dx]) * tl);
                den += e;
                fx = fmaf(e, static_cast<float>(dx - SEARCH), fx);
            }
            s.part[w * n + (r - 2 * RADIUS) * TILE_W + lane] = make_float4(m, den, fx, den * dyf);
        }
    }
    __syncthreads();
    merge(s.part, S, out, t, H, W, tl);
}

// Any search and radius: warp w takes dy = w - search, w + nw - search, ...;
// each window is summed directly from shared memory over its in-image taps,
// and the soft-argmin is updated online with one exponential per shift.
template <typename T>
__global__ void __launch_bounds__(1024)
flow_level_kernel_any(const T* __restrict__ i1, const T* __restrict__ i2,
               float* __restrict__ out, int H, int W, int tile_h, int search, int radius,
               float tl) {
    const int S = 2 * search + 1, K = 2 * radius + 1;
    const int c1 = TILE_W + 2 * radius, c2 = c1 + 2 * search;
    const int nw = blockDim.x / 32;
    const Tile t = tile_of(H, W, tile_h);
    const Smem s = smem_of(tile_h, nw, search, radius);
    stage(i1, i2, s, t, H, W, search, radius);
    __syncthreads();

    const int lane = threadIdx.x % 32;
    const int w = threadIdx.x / 32;
    const int x = t.x0 + lane;
    const int k_lo = max(0, radius - x), k_hi = min(K, W + radius - x);  // in-image column taps
    const int n = t.th * TILE_W;
    for (int o = 0; o < t.th; ++o) {
        const int y = t.y0 + o;
        const int q_lo = max(0, radius - y), q_hi = min(K, H + radius - y);  // in-image row taps
        float m = INFINITY, den = 0.f, fx = 0.f, fy = 0.f;
        for (int dyi = w; dyi < S; dyi += nw) {
            for (int dxi = 0; dxi < S; ++dxi) {
                float c = 0.f;
                for (int q = q_lo; q < q_hi; ++q) {
                    const float* a = s.s1 + (o + q) * c1 + lane;
                    const float* b = s.s2 + (o + q + dyi) * c2 + lane + dxi;
                    for (int k = k_lo; k < k_hi; ++k) {
                        const float d = a[k] - b[k];
                        c = fmaf(d, d, c);
                    }
                }
                // one exponential: the old state's rescale or the new
                // shift's weight is exp(0) = 1 (m = inf: rescale 0, weight 1)
                const float e = exp2_ftz(-fabsf(c - m) * tl);
                const bool lower = c < m;
                const float rescale = lower ? e : 1.f, wgt = lower ? 1.f : e;
                den = fmaf(den, rescale, wgt);
                fx = fmaf(fx, rescale, wgt * static_cast<float>(dxi - search));
                fy = fmaf(fy, rescale, wgt * static_cast<float>(dyi - search));
                m = fminf(m, c);
            }
        }
        s.part[w * n + o * TILE_W + lane] = make_float4(m, den, fx, fy);
    }
    __syncthreads();
    merge(s.part, nw, out, t, H, W, tl);
}

// One launch at the element type T: the ring kernel where its window sizes
// are compiled in ((5, 3): the fast presets; (3, 3): the accurate pyramid),
// else the run-time kernel.
template <typename T>
int launch(const T* a, const T* b, float* f, int H, int W, int tile_h, int search, int radius,
           float tl, dim3 grid, int threads, size_t smem, cudaStream_t st) {
    const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    cudaError_t err;
    if (search == 5 && radius == 3) {
        err = cudaFuncSetAttribute(flow_level_kernel<5, 3, T>, attr, static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        flow_level_kernel<5, 3, T><<<grid, threads, smem, st>>>(a, b, f, H, W, tile_h, tl);
    } else if (search == 3 && radius == 3) {
        err = cudaFuncSetAttribute(flow_level_kernel<3, 3, T>, attr, static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        flow_level_kernel<3, 3, T><<<grid, threads, smem, st>>>(a, b, f, H, W, tile_h, tl);
    } else {
        err = cudaFuncSetAttribute(flow_level_kernel_any<T>, attr, static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        flow_level_kernel_any<T><<<grid, threads, smem, st>>>(a, b, f, H, W, tile_h, search,
                                                             radius, tl);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// i1, i2: (P, H, W) bf16 (raw 16-bit words; f32 = 0) or f32 (f32 = 1); out:
// (P, H, W, 2) f32. The grid is (column tiles x row tiles of tile_h rows, P),
// 2*search+1 warps a block (at most 32); the wrapper picks tile_h and checks
// that the block's shared memory fits, that P <= 65535 and that H * W < 2^31.
extern "C" int vdet_flow_level(const void* i1, const void* i2, void* out, int f32,
                               int P, int H, int W, int tile_h, int search,
                               int radius, float temperature, void* stream) {
    const int S = 2 * search + 1, K = 2 * radius + 1;
    const int nw = S < 32 ? S : 32;
    const size_t smem = static_cast<size_t>(nw) * tile_h * TILE_W * sizeof(float4)
        + ((static_cast<size_t>(tile_h) + K - 1) * (TILE_W + K - 1)
           + (static_cast<size_t>(tile_h) + K - 1 + S - 1) * (TILE_W + K - 1 + S - 1))
          * sizeof(float);
    const float tl = static_cast<float>(static_cast<double>(temperature) * 1.4426950408889634
                                        / static_cast<double>(K * K));
    const dim3 grid(((W + TILE_W - 1) / TILE_W) * ((H + tile_h - 1) / tile_h), P);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto* f = static_cast<float*>(out);
    if (f32) {
        return launch(static_cast<const float*>(i1), static_cast<const float*>(i2), f, H, W,
                      tile_h, search, radius, tl, grid, nw * 32, smem, st);
    }
    return launch(static_cast<const uint16_t*>(i1), static_cast<const uint16_t*>(i2), f, H, W,
                  tile_h, search, radius, tl, grid, nw * 32, smem, st);
}
