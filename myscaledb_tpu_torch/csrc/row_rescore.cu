// Kernel: the exact re-rank of a two-stage IVF index's candidates,
//     out[q, c] = metric(sum_d q[q, d] * float(x[ids[q, c], d]))
// in f32, for q < Q, c < C; -inf where ids[q, c] < 0, and such a row is
// not read. metric: L2 2 dot - aux[row], IP dot, Cosine dot * (1 / |x|)
// where |x| > 0, else 0, with |x| the f32 norm of the same widened row,
// summed in the same pass (the payload's stored inverse norm is not used:
// the re-rank reports the norm of the row it scores).
//
// Replaces no TPU kernel: in the JAX package this step,
// myscaledb_tpu/index/ivf.py `IVFIndex._exact_scores`, is `jnp.take` of
// the candidate rows and an einsum, which XLA fuses on the TPU. In PyTorch
// the same step was four library passes, each a full trip through device
// memory: a gather that wrote every query's candidate rows out as
// [Q, C, D], their f32 copy (twice the bytes), a batched GEMV that read
// the copy back, and for Cosine a norm that read it once more. Here each
// candidate row is read once by its id and widened in registers.
//
// What bounds it on the H100: bytes. Each (query, candidate) pair reads
// its row once and does one FMA a value (two for Cosine: the dot and the
// sum of squares): at the Cohere MSTG shape (Q 256, C 400, D 768 bf16)
// 157.3 MB (0.047 ms at 3.35 TB/s) against 0.31 GFLOP (5 us on the CUDA
// cores). The rows are scattered, so what the design has to buy is enough
// independent 16-byte loads in flight to cover device memory's latency.
// Products are exact f32 FMAs of the widened row and the f32 query: no
// tensor cores, no TF32, no bf16 rounding of the query, the arithmetic of
// the plain version with its sums in another order.
//
// Design (csrc/tile_rescore.cu's geometry, for rows gathered by id): one
// block of 8 warps a (query, group of 64 candidates), on a 1-D grid of
// Q * ceil(C / 64) blocks. The block loads its 64 ids into shared memory.
// A row is K = D * elem / 16 chunks of 16 bytes; L lanes share a row (32,
// or 16 where K is an odd multiple of 16: the rows of D = 128 bf16), lane
// c taking chunks c, c + L, ..., so neighbouring lanes read neighbouring
// 16 bytes of one row. Each warp owns 8 candidates; a lane keeps the
// accumulators of its RU = L / 4 rows (the dot, and the sum of squares for
// Cosine) and issues their loads for one chunk before it uses any, and
// reads that chunk's query values once (from L1: every warp of the block
// walks the same query row) for the RU rows. A row whose id is negative
// takes no load. The row sums meet across the L lanes by `shfl_xor`; then
// lane r of the row group holds row r's sums and writes its score, so a
// warp's stores are contiguous.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace msd {

constexpr int RR_CANDS = 64;   // candidates a block
constexpr int RR_WARPS = 8;    // warps a block
constexpr int RR_WARP_ROWS = RR_CANDS / RR_WARPS;  // 8 candidates a warp

__device__ __forceinline__ float rr_neg_inf() {
    return __int_as_float(static_cast<int>(0xff800000u));
}

// dot += the 16 bytes of payload against the matching query values; with
// SQ, ss += their squares too (the widened values, as the plain version's
// norm of the f32 copy sums them)
template <bool SQ>
__device__ __forceinline__ void rr_dot16(const uint4 v, const float* qv, float& dot, float& ss,
                                         uint16_t) {
    // 8 bf16 values: the low half of each word is the earlier element;
    // a bf16 widened to f32 is its bits in the high half
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float a = __uint_as_float(w[i] << 16), b = __uint_as_float(w[i] & 0xffff0000u);
        dot = fmaf(a, qv[2 * i], dot);
        dot = fmaf(b, qv[2 * i + 1], dot);
        if constexpr (SQ) {
            ss = fmaf(a, a, ss);
            ss = fmaf(b, b, ss);
        }
    }
}

template <bool SQ>
__device__ __forceinline__ void rr_dot16(const uint4 v, const float* qv, float& dot, float& ss,
                                         float) {
    const float e[4] = {__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                        __uint_as_float(v.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        dot = fmaf(e[i], qv[i], dot);
        if constexpr (SQ) ss = fmaf(e[i], e[i], ss);
    }
}

// T: uint16_t (bf16 bits) or float; L: lanes a row; COS: the Cosine
// epilogue, which needs each row's sum of squares
template <typename T, int L, bool COS>
__global__ void __launch_bounds__(RR_WARPS * 32)
row_rescore_kernel(const float* __restrict__ q, const T* __restrict__ x,
                   const float* __restrict__ aux, const int32_t* __restrict__ ids,
                   float* __restrict__ out, int C, int groups, int D, int metric) {
    constexpr int VALS = 16 / sizeof(T);     // values a 16-byte chunk
    constexpr int GROUPS = 32 / L;           // row groups a warp
    constexpr int RU = RR_WARP_ROWS / GROUPS;  // rows a lane, all in flight
    __shared__ int32_t sid[RR_CANDS];
    const size_t qi = blockIdx.x / groups;
    const int c0 = static_cast<int>(blockIdx.x % groups) * RR_CANDS;
    if (threadIdx.x < RR_CANDS) {
        const int c = c0 + static_cast<int>(threadIdx.x);
        sid[threadIdx.x] = c < C ? __ldg(ids + qi * C + c) : -1;
    }
    __syncthreads();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int c = lane % L;
    const int cpl = D / VALS / L;            // chunks a lane a row
    const int r0 = warp * RR_WARP_ROWS + (lane / L) * RU;  // in the block
    const float* qrow = q + qi * D;
    const T* xr[RU];
    float dot[RU], ss[RU];
#pragma unroll
    for (int r = 0; r < RU; ++r) {
        const int32_t id = sid[r0 + r];
        xr[r] = id >= 0 ? x + static_cast<size_t>(id) * D : nullptr;
        dot[r] = 0.0f;
        ss[r] = 0.0f;
    }
#pragma unroll 2
    for (int i = 0; i < cpl; ++i) {
        const int col = (i * L + c) * VALS;
        uint4 v[RU];
#pragma unroll
        for (int r = 0; r < RU; ++r)
            v[r] = xr[r] != nullptr ? __ldg(reinterpret_cast<const uint4*>(xr[r] + col))
                                    : make_uint4(0u, 0u, 0u, 0u);
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
        for (int r = 0; r < RU; ++r) rr_dot16<COS>(v[r], qv, dot[r], ss[r], T());
    }
#pragma unroll
    for (int r = 0; r < RU; ++r) {
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) {
            dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
            if constexpr (COS) ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], off);
        }
    }
    if (c < RU && c0 + r0 + c < C) {
        float d = dot[0], s2 = ss[0];
#pragma unroll
        for (int r = 1; r < RU; ++r)
            if (c == r) {
                d = dot[r];
                s2 = ss[r];
            }
        const int32_t id = sid[r0 + c];
        float s = rr_neg_inf();
        if (id >= 0) {
            if constexpr (COS) {
                const float nrm = sqrtf(s2);
                s = nrm > 0.0f ? d * (1.0f / nrm) : 0.0f;
            } else {
                s = metric == 0 ? 2.0f * d - __ldg(aux + id) : d;
            }
        }
        out[qi * C + c0 + r0 + c] = s;
    }
}

template <typename T, int L, bool COS>
int rr_launch(const void* q, const void* x, const void* aux, const void* ids, void* out, int Q,
              int C, int D, int metric, cudaStream_t stream) {
    const int groups = (C + RR_CANDS - 1) / RR_CANDS;
    const unsigned blocks = static_cast<unsigned>(Q) * static_cast<unsigned>(groups);
    row_rescore_kernel<T, L, COS><<<blocks, RR_WARPS * 32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const T*>(x), static_cast<const float*>(aux),
        static_cast<const int32_t*>(ids), static_cast<float*>(out), C, groups, D, metric);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace msd

// q f32[Q, D], x [N, D] of elem_bytes 2 (bf16) or 4 (f32), aux f32[N]
// (read by L2 only; may be null otherwise), ids int32[Q, C] row ids in
// [0, N) or negative (not read: -inf), out f32[Q, C]; D a multiple of 128;
// metric 0 L2, 1 IP, 2 Cosine. The lanes a row follow from D and
// elem_bytes. Returns cudaErrorInvalidValue for anything else (or
// Q * ceil(C / 64) >= 2^31), else cudaGetLastError() after the launch.
extern "C" int msd_row_rescore(const void* q, const void* x, const void* aux, const void* ids,
                               void* out, int Q, int C, int D, int elem_bytes, int metric,
                               void* stream) {
    using namespace msd;
    if (Q <= 0 || C <= 0) return 0;
    const long long chunks = static_cast<long long>(D) * elem_bytes / 16;  // 16 bytes a row
    if ((elem_bytes != 2 && elem_bytes != 4) || D <= 0 || D % 128 != 0 ||
        metric < 0 || metric > 2 || (metric == 0 && aux == nullptr) ||
        static_cast<long long>(Q) * ((C + RR_CANDS - 1) / RR_CANDS) > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
    // an f32 row of D % 128 == 0 has D / 4 chunks, a multiple of 32, so it
    // always takes 32 lanes; a bf16 row takes 16 where its D / 8 chunks are
    // an odd multiple of 16 (D = 128)
    const bool wide = chunks % 32 == 0;
    const bool cos = metric == 2;
    auto launch = elem_bytes == 4
                      ? (cos ? rr_launch<float, 32, true> : rr_launch<float, 32, false>)
                      : (wide ? (cos ? rr_launch<uint16_t, 32, true>
                                     : rr_launch<uint16_t, 32, false>)
                              : (cos ? rr_launch<uint16_t, 16, true>
                                     : rr_launch<uint16_t, 16, false>));
    return launch(q, x, aux, ids, out, Q, C, D, metric, static_cast<cudaStream_t>(stream));
}
