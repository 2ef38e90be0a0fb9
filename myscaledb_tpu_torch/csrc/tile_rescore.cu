// Kernel: the exact rescore of the tile prune's chosen sub-tiles,
//     out[q, s*128 + r] = metric(sum_d q[q, d] * float(x[sub[q, s]*128 + r, d]))
// in f32, -inf where the row's mask byte is 0, for q < Q, s < S, r < 128;
// metric: L2 2 dot - aux[row], Cosine dot * aux[row], IP dot.
//
// Replaces no TPU kernel: in the JAX package this step of
// myscaledb_tpu/ops/tilescan.py::tile_topk_scan is `jnp.take` of the
// chosen sub-tiles and an `einsum`, which XLA fuses on the TPU. In
// PyTorch the same step was three library ops (a gather that wrote every
// query's sub-tiles out as [Q, S, 128, D], an f32 multiply that wrote
// products of that size, a sum that read them back); here the chosen rows
// are read once and nothing of size [Q, S, 128, D] reaches device memory.
//
// What bounds it on the H100: bytes. Each (query, sub-tile) pair reads
// its 128 rows once and does one FMA a value: at SIFT's shape (Q 1,000,
// S 12, D 128, bf16) 393 MB against 0.2 GFLOP (0.117 ms at 3.35 TB/s
// against 6 us of f32 FMAs on the CUDA cores); at GIST's (Q 256, S 12,
// D 1,024) 805 MB (0.240 ms). The products are exact f32 FMAs of the
// widened row and the f32 query: no tensor cores, no TF32, no bf16
// rounding of the query, the arithmetic of the plain version with its sums
// in another order.
//
// Design: one block of 8 warps a (query, sub-tile) pair, on a 1-D grid of
// Q * S blocks. A sub-tile is 128 contiguous rows, so each pair is one
// coalesced stream. A row is C = D * elem / 16 chunks of 16 bytes; L lanes
// share a row (L = 32, or 16 where C is an odd multiple of 16: the rows of
// D = 128 bf16), lane c taking chunks c, c + L, ..., so neighbouring lanes
// read neighbouring 16 bytes. Each warp owns 16 rows; a lane keeps RU = 8
// rows' accumulators and issues their 8 loads for one column chunk before
// it uses any, and reads that chunk's query values once (from L1: every
// warp of the block walks the same query row) for the 8 rows. The row
// sums meet across the L lanes by `shfl_xor`; then lane r of the row group
// holds row r's sum and writes it, so a warp's stores are contiguous.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace msd {

constexpr int RS_SUB = 128;    // rows a sub-tile
constexpr int RS_WARPS = 8;    // warps a block
constexpr int RS_WARP_ROWS = RS_SUB / RS_WARPS;  // 16 rows a warp
constexpr int RS_RU = 8;       // rows a lane accumulates at once (loads in flight)

__device__ __forceinline__ float rs_neg_inf() {
    return __int_as_float(static_cast<int>(0xff800000u));
}

// acc += the dot of 16 bytes of payload with the matching query values
__device__ __forceinline__ float rs_dot16(const uint4 v, const float* qv, float acc, uint16_t) {
    // 8 bf16 values: the low half of each word is the earlier element;
    // a bf16 widened to f32 is its bits in the high half
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        acc = fmaf(__uint_as_float(w[i] << 16), qv[2 * i], acc);
        acc = fmaf(__uint_as_float(w[i] & 0xffff0000u), qv[2 * i + 1], acc);
    }
    return acc;
}

__device__ __forceinline__ float rs_dot16(const uint4 v, const float* qv, float acc, float) {
    acc = fmaf(__uint_as_float(v.x), qv[0], acc);
    acc = fmaf(__uint_as_float(v.y), qv[1], acc);
    acc = fmaf(__uint_as_float(v.z), qv[2], acc);
    acc = fmaf(__uint_as_float(v.w), qv[3], acc);
    return acc;
}

// T: uint16_t (bf16 bits) or float; L: lanes a row
template <typename T, int L>
__global__ void __launch_bounds__(RS_WARPS * 32)
tile_rescore_kernel(const float* __restrict__ q, const T* __restrict__ x,
                    const float* __restrict__ aux, const uint8_t* __restrict__ mask,
                    const int64_t* __restrict__ sub, float* __restrict__ out, int S, int D,
                    int metric) {
    constexpr int VALS = 16 / sizeof(T);     // values a 16-byte chunk
    constexpr int GROUPS = 32 / L;           // row groups a warp
    constexpr int GROUP_ROWS = RS_WARP_ROWS / GROUPS;
    const size_t pair = blockIdx.x;          // query * S + s
    const size_t qi = pair / S;
    const int64_t tile = __ldg(sub + pair);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int c = lane % L;
    const int cpl = D / VALS / L;            // chunks a lane a row
    const float* qrow = q + qi * D;
    for (int b = 0; b < GROUP_ROWS; b += RS_RU) {
        const int r0 = warp * RS_WARP_ROWS + (lane / L) * GROUP_ROWS + b;  // in the sub-tile
        const size_t row0 = static_cast<size_t>(tile) * RS_SUB + r0;
        const T* xr = x + row0 * D;
        float acc[RS_RU];
#pragma unroll
        for (int r = 0; r < RS_RU; ++r) acc[r] = 0.0f;
#pragma unroll 2
        for (int i = 0; i < cpl; ++i) {
            const int col = (i * L + c) * VALS;
            uint4 v[RS_RU];
#pragma unroll
            for (int r = 0; r < RS_RU; ++r)
                v[r] = __ldg(reinterpret_cast<const uint4*>(xr + static_cast<size_t>(r) * D + col));
            float qv[VALS];
#pragma unroll
            for (int j = 0; j < VALS; j += 4) {
                const float4 f = __ldg(reinterpret_cast<const float4*>(qrow + col + j));
                qv[j] = f.x;
                qv[j + 1] = f.y;
                qv[j + 2] = f.z;
                qv[j + 3] = f.w;
            }
#pragma unroll
            for (int r = 0; r < RS_RU; ++r) acc[r] = rs_dot16(v[r], qv, acc[r], T());
        }
#pragma unroll
        for (int r = 0; r < RS_RU; ++r) {
#pragma unroll
            for (int off = L / 2; off > 0; off >>= 1)
                acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
        }
        if (c < RS_RU) {
            float dot = acc[0];
#pragma unroll
            for (int r = 1; r < RS_RU; ++r)
                if (c == r) dot = acc[r];
            const size_t row = row0 + c;
            const float a = __ldg(aux + row);
            float s = metric == 0 ? 2.0f * dot - a : (metric == 2 ? dot * a : dot);
            if (__ldg(mask + row) == 0) s = rs_neg_inf();
            out[pair * RS_SUB + r0 + c] = s;
        }
    }
}

template <typename T, int L>
int rs_launch(const void* q, const void* x, const void* aux, const void* mask, const void* sub,
              void* out, int Q, int S, int D, int metric, cudaStream_t stream) {
    const unsigned blocks = static_cast<unsigned>(Q) * static_cast<unsigned>(S);
    tile_rescore_kernel<T, L><<<blocks, RS_WARPS * 32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const T*>(x), static_cast<const float*>(aux),
        static_cast<const uint8_t*>(mask), static_cast<const int64_t*>(sub),
        static_cast<float*>(out), S, D, metric);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace msd

// q f32[Q, D], x [N, D] of elem_bytes 2 (bf16) or 4 (f32), aux f32[N],
// mask u8[N], sub int64[Q, S] sub-tile ids in [0, N / 128), out f32[Q, S *
// 128]; D a multiple of 128; metric 0 L2, 1 IP, 2 Cosine. The lanes a
// row follow from D and elem_bytes. Returns
// cudaErrorInvalidValue for anything else (or Q * S >= 2^31), else
// cudaGetLastError() after the launch.
extern "C" int msd_tile_rescore(const void* q, const void* x, const void* aux, const void* mask,
                                const void* sub, void* out, int Q, int S, int D, int elem_bytes,
                                int metric, void* stream) {
    using namespace msd;
    if (Q <= 0 || S <= 0) return 0;
    const long long chunks = static_cast<long long>(D) * elem_bytes / 16;  // 16 bytes a row
    if ((elem_bytes != 2 && elem_bytes != 4) || D <= 0 || D % 128 != 0 ||
        static_cast<long long>(Q) * S > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
    // an f32 row of D % 128 == 0 has D / 4 chunks, a multiple of 32, so it
    // always takes 32 lanes; a bf16 row takes 16 where its D / 8 chunks are
    // an odd multiple of 16 (D = 128)
    const bool wide = chunks % 32 == 0;
    auto launch = elem_bytes == 4 ? rs_launch<float, 32>
                                  : (wide ? rs_launch<uint16_t, 32> : rs_launch<uint16_t, 16>);
    return launch(q, x, aux, mask, sub, out, Q, S, D, metric, static_cast<cudaStream_t>(stream));
}
