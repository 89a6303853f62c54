// Block-matching flow level for P frame pairs (kernel A of the port).
//
// Replaces the TPU kernel vdetlib_tpu/kernels/flow_pallas.py::flow_level_pallas
// (_flow_kernel). Same math as vdetlib_tpu_torch/kernels/flow_level.py::_flow_level,
// the plain version beside this kernel's wrapper: for each of the S*S integer
// shifts (dx, dy) in [-search, search]^2 the SSD between i1 and the shifted i2
// (rows and columns clamped to the image edge) is box-filtered over a
// (2r+1)^2 window with zero padding and divided by (2r+1)^2; an online
// soft-argmin over the shifts (temperature, f32 accumulators) gives the flow
// (dx, dy) of each pixel. Inputs are bf16; all arithmetic is f32.
//
// What bounds it on an H100: arithmetic and barriers, not bytes. At the
// production shape (P = 255 pairs of 60x80) the inputs are ~2.5 MB and the
// output ~10 MB, while the cost volume is 121 shifts x 4800 px x ~25 flops
// per pair. The TPU kernel's problem was HBM traffic of per-shift
// temporaries; here nothing but the inputs and the flow touches device
// memory.
//
// Design: one block per (pair, tile of rows), one thread per output pixel of
// the tile, so the soft-argmin state (m, den, fx, fy) lives in registers for
// all 121 shifts. The tile's i1 rows and the i2 rows it can reach (tile +
// box radius + search, edge-clamped) are staged once in shared memory as
// f32. Per shift: a row pass writes the horizontal window sums of the
// squared difference for the tile plus its vertical halo into shared memory
// (rows outside the image are zero: the "SAME" zero padding), a barrier, then
// each thread sums its column of 2r+1 row sums and updates its soft-argmin.
// Tiles of ~1000 pixels give 5 tiles per 60x80 pair, ~1300 blocks at P=255:
// enough to fill 132 SMs with two blocks each. The halo rows are recomputed
// by neighbouring tiles (1.5x the row-pass work at 12-row tiles); that is
// the price of keeping every block independent.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__global__ void flow_level_kernel(const uint16_t* __restrict__ i1,
                                  const uint16_t* __restrict__ i2,
                                  float* __restrict__ out,
                                  int H, int W, int tile_h, int search, int radius,
                                  float temperature) {
    extern __shared__ float smem[];
    const int pair = blockIdx.y;
    const int y0 = blockIdx.x * tile_h;
    const int th = min(tile_h, H - y0);   // output rows of this tile
    const int hr = th + 2 * radius;       // rows of the row-pass buffer
    const int r1 = y0 - radius;           // image row of row-pass row 0
    const int rows2 = hr + 2 * search;    // i2 rows any shift can reach
    const int r2 = r1 - search;           // image row of staged i2 row 0 (before clamping)

    float* s1 = smem;                     // hr x W     i1 rows r1 ..
    float* s2 = s1 + hr * W;              // rows2 x W  i2 rows r2 .., clamped to the image
    float* rs = s2 + rows2 * W;           // hr x W     horizontal window sums

    const uint16_t* p1 = i1 + static_cast<size_t>(pair) * H * W;
    const uint16_t* p2 = i2 + static_cast<size_t>(pair) * H * W;
    for (int e = threadIdx.x; e < hr * W; e += blockDim.x) {
        const int y = r1 + e / W;
        s1[e] = (y >= 0 && y < H) ? bf16_to_f32(p1[y * W + e % W]) : 0.f;
    }
    for (int e = threadIdx.x; e < rows2 * W; e += blockDim.x) {
        const int y = min(max(r2 + e / W, 0), H - 1);
        s2[e] = bf16_to_f32(p2[y * W + e % W]);
    }

    const int ty = threadIdx.x / W;
    const int tx = threadIdx.x % W;
    const bool own = threadIdx.x < th * W;
    const int S = 2 * search + 1;
    const int K = 2 * radius + 1;
    const float area = static_cast<float>(K * K);
    float m = INFINITY, den = 0.f, fx = 0.f, fy = 0.f;

    for (int sh = 0; sh < S * S; ++sh) {
        const int dy = sh / S - search;
        const int dx = sh % S - search;
        __syncthreads();  // staging done / previous column pass done with rs
        for (int e = threadIdx.x; e < hr * W; e += blockDim.x) {
            const int ly = e / W;
            const int x = e % W;
            const int y = r1 + ly;
            float acc = 0.f;
            if (y >= 0 && y < H) {
                const float* row1 = s1 + ly * W;
                const float* row2 = s2 + (ly + search + dy) * W;  // image row clamp(y + dy)
                for (int k = -radius; k <= radius; ++k) {
                    const int xx = x + k;
                    if (xx < 0 || xx >= W) continue;
                    const float d = row1[xx] - row2[min(max(xx + dx, 0), W - 1)];
                    acc += d * d;
                }
            }
            rs[e] = acc;
        }
        __syncthreads();
        if (own) {
            float c = 0.f;
            for (int k = 0; k < K; ++k) c += rs[(ty + k) * W + tx];
            c = c / area;
            const float m_new = fminf(m, c);
            const float rescale = expf(-temperature * (m - m_new));
            const float w = expf(-temperature * (c - m_new));
            den = den * rescale + w;
            fx = fx * rescale + w * static_cast<float>(dx);
            fy = fy * rescale + w * static_cast<float>(dy);
            m = m_new;
        }
    }
    if (own) {
        const size_t o = ((static_cast<size_t>(pair) * H + (y0 + ty)) * W + tx) * 2;
        out[o] = fx / den;
        out[o + 1] = fy / den;
    }
}

}  // namespace

// i1, i2: (P, H, W) bf16 (raw 16-bit words); out: (P, H, W, 2) f32.
// tile_h * W must be <= 1024 (one thread per pixel of a tile).
extern "C" int vdet_flow_level(const void* i1, const void* i2, void* out,
                               int P, int H, int W, int tile_h, int search,
                               int radius, float temperature, void* stream) {
    const int hr = tile_h + 2 * radius;
    const size_t smem = static_cast<size_t>(2 * hr + hr + 2 * search) * W * sizeof(float);
    if (smem > 48 * 1024) {
        cudaFuncSetAttribute(flow_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    }
    const int threads = ((tile_h * W + 31) / 32) * 32;
    const dim3 grid((H + tile_h - 1) / tile_h, P);
    flow_level_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(i1), static_cast<const uint16_t*>(i2),
        static_cast<float*>(out), H, W, tile_h, search, radius, temperature);
    return static_cast<int>(cudaGetLastError());
}
