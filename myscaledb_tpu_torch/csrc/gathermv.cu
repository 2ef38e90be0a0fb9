// Kernel 3: fused neighbour-block gather + traversal mat-vec,
//     out[q, b*m + j] = sum_d bf16(qs[q, d]) * float(nbdata[rows[q, b], j, d])
// accumulated in f32, for q < Q, b < BEAM, j < m.
//
// Replaces myscaledb_tpu/ops/gathermv.py::_kernel (launched by
// `gather_block_scores`). The HNSW frontier expansion scores each query's
// BEAM expanded nodes against their neighbours' u8 codes, which the index
// stores per node as one contiguous [m, Dt] block (node-block layout,
// index/hnsw.py). The gathered blocks are read once and never written
// back: no [Q, BEAM, m, Dt] copy reaches device memory.
//
// What bounds it on the H100: every code byte is read once and used for
// one multiply and one add. At the main path's shape (Q = 256, BEAM = 8,
// m = 32, Dt = 1024) a launch reads 67.1 MB of codes, ~20 us at
// 3.35 TB/s, against 0.13 GFLOP, so memory bounds it and it needs no
// tensor cores. Every product of a bf16 query value and a u8 code is exact
// in f32 (8 + 8 significant bits), so the kernel and its plain version
// differ only in the order of their f32 sums.
//
// Design (a simple kernel that is right; pipelining comes later): one
// block per (query, beam slot), 8 warps, on a 1-D grid of Q * BEAM
// blocks. The block rounds its query to bf16 and keeps it in shared
// memory as f32 (4 KB at Dt = 1024). Each warp
// takes rows j = warp, warp + 8, ... of the block in groups of RG rows;
// lane l loads 16 codes per 16-byte load from chunks l, l + 32, ... of
// each row, so the warp reads 512 contiguous bytes per step, FMAs them
// against the query, and a shuffle reduction leaves each row's dot in
// lane 0, which stores it. The TPU kernel's QSUB = 8 query grouping was a
// sublane rule: here Q needs no padding. Unlike the TPU kernel, this one
// clamps each row id to [0, N) itself, so a caller that forgets to clamp
// reads a wrong block, never out of bounds; clamped rows score as before.

#include <cuda_bf16.h>
#include <cstddef>
#include <cstdint>

namespace msd {

constexpr int GM_WARPS = 8;
constexpr int GM_THREADS = GM_WARPS * 32;
constexpr int RG = 4;  // rows a warp accumulates at once

__device__ __forceinline__ void fma16(float& acc, const uint4 c, const float* q) {
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            acc = fmaf(q[4 * i + b], static_cast<float>((w[i] >> (8 * b)) & 0xffu), acc);
        }
    }
}

__global__ void __launch_bounds__(GM_THREADS)
gathermv_kernel(const float* __restrict__ qs, const int32_t* __restrict__ rows,
                const uint8_t* __restrict__ nbdata, float* __restrict__ out,
                int beam, int N, int m, int Dt) {
    extern __shared__ float qsh[];  // [Dt] bf16-rounded query, as f32
    const int b = blockIdx.x % beam;
    const int q = blockIdx.x / beam;
    const float* qrow = qs + (size_t)q * Dt;
    for (int d = threadIdx.x; d < Dt; d += GM_THREADS) {
        qsh[d] = __bfloat162float(__float2bfloat16_rn(qrow[d]));
    }
    int row = rows[(size_t)q * beam + b];
    row = row < 0 ? 0 : (row >= N ? N - 1 : row);
    __syncthreads();

    const uint8_t* blk = nbdata + (size_t)row * m * Dt;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int nchunk = Dt / 16;
    float* orow = out + (size_t)q * beam * m + (size_t)b * m;
    for (int j0 = warp; j0 < m; j0 += GM_WARPS * RG) {
        float acc[RG];
#pragma unroll
        for (int r = 0; r < RG; ++r) acc[r] = 0.0f;
        for (int c = lane; c < nchunk; c += 32) {
            float qv[16];
#pragma unroll
            for (int i = 0; i < 16; ++i) qv[i] = qsh[16 * c + i];
#pragma unroll
            for (int r = 0; r < RG; ++r) {
                const int j = j0 + r * GM_WARPS;
                if (j < m) {
                    const uint4 v = *reinterpret_cast<const uint4*>(blk + (size_t)j * Dt + 16 * c);
                    fma16(acc[r], v, qv);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < RG; ++r) {
            float s = acc[r];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
            const int j = j0 + r * GM_WARPS;
            if (lane == 0 && j < m) orow[j] = s;
        }
    }
}

}  // namespace msd

// qs f32[Q, Dt], rows int32[Q, beam], nbdata u8[N, m, Dt] (16-byte aligned,
// Dt % 16 == 0), out f32[Q, beam * m]. Returns cudaGetLastError() after
// the launch.
extern "C" int msd_gathermv(const void* qs, const void* rows, const void* nbdata,
                            void* out, int Q, int beam, int N, int m, int Dt,
                            void* stream) {
    using namespace msd;
    const dim3 grid(Q * beam);
    const size_t smem = sizeof(float) * (size_t)Dt;
    gathermv_kernel<<<grid, GM_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(qs), static_cast<const int32_t*>(rows),
        static_cast<const uint8_t*>(nbdata), static_cast<float*>(out), beam, N, m, Dt);
    return static_cast<int>(cudaGetLastError());
}
