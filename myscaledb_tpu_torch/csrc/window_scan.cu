// Kernel: the IVF window step's scores,
//     out[q, w*512 + r] = metric(sum_d q[q, d] * dec(x[widx[q, w]*512 + r, d]))
// in f32, for q < Q, w < W, r < 512; dec widens a bf16 or f32 row, or
// decodes an SQ8 code as quantize.sq8_decode_dev does,
// bf16(code * scale[d] + lo[d]) widened to f32; metric: L2 2 dot - aux[row],
// IP and Cosine dot (a Cosine index stores normalised rows and scores
// normalised queries). A window slot whose valid byte is 0 is not read:
// its 512 scores are -inf.
//
// Replaces no TPU kernel: in the JAX package the window step of
// myscaledb_tpu/index/ivf.py (IVFIndex._scan_stage) is `jnp.take` of each
// query's windows and an einsum, which XLA fuses on the TPU. In PyTorch
// the same step was library passes, each a full trip through device
// memory: a gather that wrote every query's windows out as
// [Q, G, 512, D], the decode (for SQ8 five elementwise passes: u8 -> f32,
// x scale, + lo, -> bf16, -> f32) and a batched GEMV that read the f32
// copy back. Here each live window is read once and decoded in registers.
//
// What bounds it on the H100: bytes. Each (query, live window) pair reads
// its 512 rows once and does one FMA a value: at the SIFT IVFFLAT shape
// (Q 1,000, W 10, D 128 bf16, about 4.5 live windows a query) about
// 0.59 GB (0.18 ms at 3.35 TB/s), at the Cohere MSTG shape (Q 256, W 12,
// D 768 SQ8, about 5.3 live) about 0.53 GB (0.16 ms); the f32 FMAs are
// about 1 GFLOP (15 us at 67 TF/s). The SQ8 decode costs five more
// instructions a value, which holds the 768-d SQ8 shape near 80% of its
// byte bound (bf16 rows at 128-d reach about 90%).
// Products are exact f32 FMAs of the widened (or decoded) row and the f32
// query: no tensor cores, no TF32, no bf16 rounding of the query, the
// arithmetic of the plain version with its sums in another order. The
// decode's multiply and add are the `_rn` intrinsics, never contracted to
// an FMA, because PyTorch runs them as two kernels.
//
// Design (csrc/tile_rescore.cu's geometry): one block of 8 warps a
// (query, window slot, 128-row quarter), on a 1-D grid of Q * W * 4
// blocks, so each block is one coalesced stream of 128 contiguous rows.
// A row is C = D * elem / 16 chunks of 16 bytes; L lanes share a row (32,
// 16 or 8, the largest that divides C), lane c taking chunks c, c + L, ...,
// so neighbouring lanes read neighbouring 16 bytes. Each warp owns 16
// rows; a lane keeps RU = min(8, L / 2) rows' accumulators and starts
// their loads for one chunk before it uses any, and reads that chunk's
// query values once (from L1: every warp of the block walks the same query
// row) for the RU rows. SQ8's scale and lo sit in shared memory (8 D
// bytes). The row sums meet across the L lanes by `shfl_xor`; then lane r
// of the row group holds row r's sum and writes it, so a warp's stores are
// contiguous. A dead slot's four blocks write -inf and return.

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace msd {

constexpr int WS_WINDOW = 512;  // rows a window
constexpr int WS_ROWS = 128;    // rows a block: a quarter of a window
constexpr int WS_QUARTERS = WS_WINDOW / WS_ROWS;
constexpr int WS_WARPS = 8;     // warps a block
constexpr int WS_WARP_ROWS = WS_ROWS / WS_WARPS;  // 16 rows a warp
constexpr int WS_MAX_SMEM = 232448;  // shared memory one block may use on Hopper

__device__ __forceinline__ float ws_neg_inf() {
    return __int_as_float(static_cast<int>(0xff800000u));
}

__device__ __forceinline__ uint32_t ws_word(const uint4& v, int k) {
    return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// byte b of w as an exact f32: the word 0x4b0000bb is 2^23 + b
__device__ __forceinline__ float ws_code(uint32_t w, int b) {
    return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4b000000u, 0x7440 + b)), 8388608.0f);
}

// acc += the 4 values of w (4 SQ8 codes) against 4 query values, each
// decoded as bf16(code * scale + lo): a multiply and an add rounded apart,
// then rounded to bf16 (nearest, ties to even) and widened
__device__ __forceinline__ float ws_sq8_quad(uint32_t w, const float4 qv, const float4 s,
                                             const float4 lo, float acc) {
    const float d0 = __fadd_rn(__fmul_rn(ws_code(w, 0), s.x), lo.x);
    const float d1 = __fadd_rn(__fmul_rn(ws_code(w, 1), s.y), lo.y);
    const float d2 = __fadd_rn(__fmul_rn(ws_code(w, 2), s.z), lo.z);
    const float d3 = __fadd_rn(__fmul_rn(ws_code(w, 3), s.w), lo.w);
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(d0, d1);  // d0 in the low half
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(d2, d3);
    const uint32_t b01 = *reinterpret_cast<const uint32_t*>(&h01);
    const uint32_t b23 = *reinterpret_cast<const uint32_t*>(&h23);
    acc = fmaf(__uint_as_float(b01 << 16), qv.x, acc);
    acc = fmaf(__uint_as_float(b01 & 0xffff0000u), qv.y, acc);
    acc = fmaf(__uint_as_float(b23 << 16), qv.z, acc);
    acc = fmaf(__uint_as_float(b23 & 0xffff0000u), qv.w, acc);
    return acc;
}

// acc += 4 bf16 values (words w0, w1; the low half of each word is the
// earlier element, and a bf16 widened to f32 is its bits in the high half)
__device__ __forceinline__ float ws_bf16_quad(uint32_t w0, uint32_t w1, const float4 qv,
                                              float acc) {
    acc = fmaf(__uint_as_float(w0 << 16), qv.x, acc);
    acc = fmaf(__uint_as_float(w0 & 0xffff0000u), qv.y, acc);
    acc = fmaf(__uint_as_float(w1 << 16), qv.z, acc);
    acc = fmaf(__uint_as_float(w1 & 0xffff0000u), qv.w, acc);
    return acc;
}

// T: uint8_t (SQ8 codes), uint16_t (bf16 bits) or float; L: lanes a row
template <typename T, int L>
__global__ void __launch_bounds__(WS_WARPS * 32)
window_scan_kernel(const float* __restrict__ q, const T* __restrict__ x,
                   const float* __restrict__ aux, const float* __restrict__ lo,
                   const float* __restrict__ scale, const int64_t* __restrict__ widx,
                   const uint8_t* __restrict__ valid, float* __restrict__ out, int W, int D,
                   int metric) {
    constexpr bool SQ8 = sizeof(T) == 1;
    constexpr int VALS = 16 / sizeof(T);     // values a 16-byte chunk
    constexpr int GROUPS = 32 / L;           // row groups a warp
    constexpr int GROUP_ROWS = WS_WARP_ROWS / GROUPS;
    constexpr int RU = GROUP_ROWS < 8 ? GROUP_ROWS : 8;  // rows a lane at once
    extern __shared__ float4 ws_smem[];      // SQ8: scale[D], then lo[D]
    const size_t blk = blockIdx.x;           // (query * W + w) * 4 + quarter
    const size_t slot = blk / WS_QUARTERS;   // query * W + w
    float* o = out + blk * WS_ROWS;
    if (__ldg(valid + slot) == 0) {
        if (threadIdx.x < WS_ROWS) o[threadIdx.x] = ws_neg_inf();
        return;
    }
    const float* sm = reinterpret_cast<const float*>(ws_smem);
    if constexpr (SQ8) {
        float* w = reinterpret_cast<float*>(ws_smem);
        for (int d = threadIdx.x; d < D; d += blockDim.x) {
            w[d] = __ldg(scale + d);
            w[D + d] = __ldg(lo + d);
        }
        __syncthreads();
    }
    const size_t qi = slot / W;
    const int64_t win = __ldg(widx + slot);
    const int quarter = static_cast<int>(blk % WS_QUARTERS);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int c = lane % L;
    const int cpl = D / VALS / L;            // chunks a lane a row
    const float* qrow = q + qi * D;
    for (int b = 0; b < GROUP_ROWS; b += RU) {
        const int r0 = warp * WS_WARP_ROWS + (lane / L) * GROUP_ROWS + b;  // in the block
        const size_t row0 = static_cast<size_t>(win) * WS_WINDOW + quarter * WS_ROWS + r0;
        const T* xr = x + row0 * D;
        float acc[RU];
#pragma unroll
        for (int r = 0; r < RU; ++r) acc[r] = 0.0f;
#pragma unroll 2
        for (int i = 0; i < cpl; ++i) {
            const int col = (i * L + c) * VALS;
            uint4 v[RU];
#pragma unroll
            for (int r = 0; r < RU; ++r)
                v[r] = __ldg(reinterpret_cast<const uint4*>(xr + static_cast<size_t>(r) * D + col));
#pragma unroll
            for (int j = 0; j < VALS; j += 4) {
                const float4 qv = __ldg(reinterpret_cast<const float4*>(qrow + col + j));
                if constexpr (SQ8) {
                    const float4 s = *reinterpret_cast<const float4*>(sm + col + j);
                    const float4 l = *reinterpret_cast<const float4*>(sm + D + col + j);
#pragma unroll
                    for (int r = 0; r < RU; ++r)
                        acc[r] = ws_sq8_quad(ws_word(v[r], j / 4), qv, s, l, acc[r]);
                } else if constexpr (sizeof(T) == 2) {
#pragma unroll
                    for (int r = 0; r < RU; ++r)
                        acc[r] = ws_bf16_quad(ws_word(v[r], j / 2), ws_word(v[r], j / 2 + 1), qv,
                                              acc[r]);
                } else {
#pragma unroll
                    for (int r = 0; r < RU; ++r) {
                        acc[r] = fmaf(__uint_as_float(v[r].x), qv.x, acc[r]);
                        acc[r] = fmaf(__uint_as_float(v[r].y), qv.y, acc[r]);
                        acc[r] = fmaf(__uint_as_float(v[r].z), qv.z, acc[r]);
                        acc[r] = fmaf(__uint_as_float(v[r].w), qv.w, acc[r]);
                    }
                }
            }
        }
#pragma unroll
        for (int r = 0; r < RU; ++r) {
#pragma unroll
            for (int off = L / 2; off > 0; off >>= 1)
                acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
        }
        if (c < RU) {
            float dot = acc[0];
#pragma unroll
            for (int r = 1; r < RU; ++r)
                if (c == r) dot = acc[r];
            o[r0 + c] = metric == 0 ? 2.0f * dot - __ldg(aux + row0 + c) : dot;
        }
    }
}

template <typename T, int L>
int ws_launch(const void* q, const void* x, const void* aux, const void* lo, const void* scale,
              const void* widx, const void* valid, void* out, int Q, int W, int D, int metric,
              cudaStream_t stream) {
    const unsigned blocks = static_cast<unsigned>(Q) * static_cast<unsigned>(W) * WS_QUARTERS;
    const int smem = sizeof(T) == 1 ? 2 * D * static_cast<int>(sizeof(float)) : 0;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            window_scan_kernel<T, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    window_scan_kernel<T, L><<<blocks, WS_WARPS * 32, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const T*>(x), static_cast<const float*>(aux),
        static_cast<const float*>(lo), static_cast<const float*>(scale),
        static_cast<const int64_t*>(widx), static_cast<const uint8_t*>(valid),
        static_cast<float*>(out), W, D, metric);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace msd

// q f32[Q, D], x [N, D] of elem_bytes 1 (SQ8 codes, with lo and scale
// f32[D]), 2 (bf16) or 4 (f32), aux f32[N], widx int64[Q, W] window ids in
// [0, N / 512), valid u8[Q, W], out f32[Q, W * 512]; D a multiple of 128
// (an SQ8 D at most 29,056: scale and lo in one block's shared memory);
// metric 0 L2, 1 IP, 2 Cosine. The lanes a row follow from D and
// elem_bytes. Returns cudaErrorInvalidValue for anything else (or
// Q * W * 4 >= 2^31), else cudaGetLastError() after the launch.
extern "C" int msd_window_scan(const void* q, const void* x, const void* aux, const void* lo,
                               const void* scale, const void* widx, const void* valid, void* out,
                               int Q, int W, int D, int elem_bytes, int metric, void* stream) {
    using namespace msd;
    if (Q <= 0 || W <= 0) return 0;
    const bool sq8 = elem_bytes == 1;
    if ((elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4) || D <= 0 || D % 128 != 0 ||
        static_cast<long long>(Q) * W * WS_QUARTERS > 0x7fffffffLL ||
        (sq8 && (lo == nullptr || scale == nullptr ||
                 2LL * D * static_cast<long long>(sizeof(float)) > WS_MAX_SMEM)))
        return static_cast<int>(cudaErrorInvalidValue);
    // 16-byte chunks a row: D / 16 (SQ8, a multiple of 8), D / 8 (bf16, a
    // multiple of 16), D / 4 (f32, a multiple of 32); the most lanes a row
    // that divide them
    const long long chunks = static_cast<long long>(D) * elem_bytes / 16;
    const int lanes = chunks % 32 == 0 ? 32 : (chunks % 16 == 0 ? 16 : 8);
    auto launch = ws_launch<float, 32>;
    if (sq8)
        launch = lanes == 32 ? ws_launch<uint8_t, 32>
                             : (lanes == 16 ? ws_launch<uint8_t, 16> : ws_launch<uint8_t, 8>);
    else if (elem_bytes == 2)
        launch = lanes == 32 ? ws_launch<uint16_t, 32> : ws_launch<uint16_t, 16>;
    return launch(q, x, aux, lo, scale, widx, valid, out, Q, W, D, metric,
                  static_cast<cudaStream_t>(stream));
}
