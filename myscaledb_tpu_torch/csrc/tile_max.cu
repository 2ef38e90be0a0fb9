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
// What bounds it on the H100:
// * bf16 payload, at batch 104 over 1,048,576 x 128: it reads a 256 MiB
//   payload (0.080 ms at 3.35 TB/s; 277 MB with aux, mask and maxima,
//   0.083 ms) and does 2 x 28 GFLOP of hi/lo products (0.057 ms at
//   989 TF/s; 0.069 ms as the 128-row query tile pads it).
// * f32 payload, at one stream chunk (Q=104, N=131,072, D=1,024): 537 MB
//   of payload (0.161 ms with the maxima) against 3 x 27.9 GFLOP of TF32
//   products (0.169 ms at 495 TF/s).
// Both bounds are close at both, so the payload loads must overlap the
// MMAs: only the asynchronous TMA ring and `wgmma` of score_tile.cuh make
// them reachable.
//
// Design: the persistent TMA-ring + wgmma engines of score_tile.cuh. bf16
// (namespace wg, the query resident in shared memory at the SIFT shapes,
// Q <= 128, D <= 128): its epilogue applies the mask and `aux` to the
// accumulator in registers: each thread folds the 32 columns it holds of
// each of its two rows per 128-row sub-tile, then two `shfl_xor` steps
// fold the 4 lanes of a quad, and one lane writes the query's max. No
// shared-memory round trip and no block-wide barrier. A 256-row tile holds
// two sub-tiles; a sub-tile past N is skipped. f32 (namespace tf, 3xTF32):
// a tile is one 128-row sub-tile with the payload rows on the accumulator's
// rows, so each thread folds its two rows, `shfl_xor` 4, 8, 16 fold a
// warp's 16 rows, and the 8 warps' maxima meet in shared memory behind one
// barrier of the two consumer warpgroups. N % 128 == 0 (the wrapper
// checks). The TPU kernel's lane-tiling read-modify-write and VMEM block
// sizing are Mosaic workarounds and have no counterpart here. Masked rows
// take -3.4e38 exactly as on the TPU, so an all-masked sub-tile reports
// -3.4e38 and the caller's -inf / -1 handling is unchanged.

#include "score_tile.cuh"

// stages / resident / smem_bytes / grid: the bf16 engine's geometry from
// ops/distance.py::scan_geometry
extern "C" int msd_tile_max(const void* q, const void* x, const void* aux, const void* mask,
                            void* out, int Q, int N, int D, int metric, int stages, int resident,
                            int smem_bytes, int grid, void* stream) {
    using namespace msd;
    return wg::launch<wg::TILE_MAX>(q, x, aux, mask, out, Q, N, D, metric, stages, resident,
                                    smem_bytes, grid, static_cast<cudaStream_t>(stream));
}

// the f32 engine: qsplit is scratch for the query's TF32 halves, b32[2 Qp,
// Dp]; nt / stages / resident / smem_bytes / grid from
// ops/distance.py::f32_scan_geometry
extern "C" int msd_tile_max_f32(const void* q, void* qsplit, const void* x, const void* aux,
                                const void* mask, void* out, int Q, int N, int D, int metric,
                                int nt, int stages, int resident, int smem_bytes, int grid,
                                void* stream) {
    using namespace msd;
    return tf::launch<wg::TILE_MAX>(q, qsplit, x, aux, mask, out, Q, N, D, metric, nt, stages,
                                    resident, smem_bytes, grid, static_cast<cudaStream_t>(stream));
}
