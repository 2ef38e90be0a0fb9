// Kernel 2: per-sub-tile maxima of the masked score matrix,
// out[Q, N/128][q][t] = max over rows n of sub-tile t of
//     (mask[n] != 0 ? metric(q . x_n) : -3.4e38).
//
// Replaces myscaledb_tpu/ops/tilescan.py::_tile_max_kernel (launched by
// `tile_maxes`). The caller (tile_topk_scan) keeps the top k+2 sub-tiles
// per query and rescores only those rows exactly, so the Q x N score
// matrix never reaches device memory: the traffic is the payload read
// plus Q*N/128*4 bytes of maxima.
//
// What bounds it on the H100: at batch 104 over 1,048,576 x 128 bf16 it
// reads a 256 MiB payload (0.080 ms at 3.35 TB/s; 277 MB with aux, mask
// and maxima, 0.083 ms) and does 2 x 28 GFLOP of hi/lo products (0.057
// ms at 989 TF/s; 0.069 ms as the 128-row query tile pads it). The two
// bounds are close, so the payload loads must overlap the MMAs: only the
// asynchronous TMA ring and `wgmma` of score_tile.cuh make the byte bound
// reachable.
//
// Design: for a bf16 payload, the persistent TMA-ring + wgmma engine of
// score_tile.cuh with the query resident in shared memory at the SIFT
// shapes (Q <= 128, D <= 128). Its epilogue applies the mask and `aux` to
// the accumulator in registers: each thread folds the 32 columns it holds
// of each of its two rows per 128-row sub-tile, then two `shfl_xor`
// steps fold the 4 lanes of a quad, and one lane writes the query's max.
// No shared-memory round trip and no block-wide barrier. A 256-row tile
// holds two sub-tiles; N % 128 == 0 (the wrapper checks), and a sub-tile
// past N is skipped. The TPU kernel's lane-tiling read-modify-write and
// VMEM block sizing are Mosaic workarounds and have no counterpart here.
// Masked rows take -3.4e38 exactly as on the TPU, so an all-masked
// sub-tile reports -3.4e38 and the caller's -inf / -1 handling is
// unchanged. For an f32 payload (off the main path), f32 FMA on the CUDA
// cores, one 128 x 128 block per sub-tile, folded through shared memory.

#include "score_tile.cuh"

namespace msd {

__global__ void __launch_bounds__(THREADS)
tile_max_kernel_f32(const float* __restrict__ q, const float* __restrict__ x,
                    const float* __restrict__ aux, const uint8_t* __restrict__ mask,
                    float* __restrict__ out, int Q, int N, int D, int metric) {
    __shared__ float part[SLOTS][BM];
    const int q0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;
    Tile t;
    fma_tile(q, x, Q, N, D, q0, n0, t);

    // each thread folds its 8 rows per query (N % BN == 0: rows in range)
    bool keep[8];
    float a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int n = n0 + t.ni(j);
        keep[j] = mask[n] != 0;
        a[j] = aux[n];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        float m = NEG;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (keep[j]) m = fmaxf(m, apply_metric(metric, t.acc[i][j], a[j]));
        part[t.slot][t.qi(i)] = m;
    }
    __syncthreads();
    // then one thread per query folds the 16 partial maxima
    const int tid = threadIdx.x;
    if (tid < BM && q0 + tid < Q) {
        float m = part[0][tid];
#pragma unroll
        for (int s = 1; s < SLOTS; ++s) m = fmaxf(m, part[s][tid]);
        out[(size_t)(q0 + tid) * (N / BN) + blockIdx.x] = m;
    }
}

}  // namespace msd

// stages / resident / smem_bytes / grid: the bf16 engine's geometry from
// ops/distance.py::scan_geometry (unused for an f32 payload)
extern "C" int msd_tile_max(const void* q, const void* x, const void* aux,
                            const void* mask, void* out, int Q, int N, int D,
                            int metric, int x_bf16, int stages, int resident,
                            int smem_bytes, int grid, void* stream) {
    using namespace msd;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_bf16)
        return wg::launch<wg::TILE_MAX>(q, x, aux, mask, out, Q, N, D, metric, stages,
                                        resident, smem_bytes, grid, s);
    const dim3 blocks(N / BN, (Q + BM - 1) / BM);
    tile_max_kernel_f32<<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(x),
        static_cast<const float*>(aux), static_cast<const uint8_t*>(mask),
        static_cast<float*>(out), Q, N, D, metric);
    return static_cast<int>(cudaGetLastError());
}
