// Kernel 1: the full score matrix out[Q, N] = metric(q . x^T).
//
// Replaces myscaledb_tpu/ops/distance.py::_score_kernel (launched by
// `scores`). Same math, max-is-better scores:
//   L2:     2 q.x - |x|^2      (aux = |x|^2)
//   Cosine: (q.x) * 1/|x|      (aux = 1/|x|, queries pre-normalised)
//   IP:     q.x                (aux unused, may be null)
//
// What bounds it on the H100:
// * bf16 payload (the main path): at the GIST shape (Q=256, N=114,688,
//   D=1,024) it does 2 x 60 GFLOP (the hi/lo query split), 0.122 ms at
//   the bf16 tensor-core peak; it reads a 235 MB payload (0.070 ms at
//   3.35 TB/s) and writes Q*N*4 = 117 MB of scores (0.035 ms). So the
//   tensor-core rate bounds it, with the score write next.
// * f32 payload: at one host-tier stream chunk (Q=104, N=131,072,
//   D=1,024) it does 3 x 27.9 GFLOP of TF32 products (0.169 ms at
//   495 TF/s) and moves 537 MB of payload + 54.5 MB of scores (0.177 ms):
//   bytes and operations bound it about equally.
//
// Design (score_tile.cuh): the persistent TMA-ring + wgmma engines, the
// bf16 one with the query split in the kernel (namespace wg), the f32 one
// with both operands split into TF32 hi and lo halves (namespace tf). Each
// epilogue applies the metric, stages a slice of scores through shared
// memory and writes it with coalesced 16-byte stores (4-byte stores where
// N % 4 != 0, since the rows are then not 16-byte aligned), masked at the
// ragged Q and N edges, while the producer already loads the next tile.
// Plain stores, not TMA stores: a TMA store needs a row stride that is a
// multiple of 16 bytes. The TPU kernel's padding rules (Q%8, N%512) do not
// apply.

#include "score_tile.cuh"

// stages / resident / smem_bytes / grid: the bf16 engine's geometry from
// ops/distance.py::scan_geometry
extern "C" int msd_scores(const void* q, const void* x, const void* aux, void* out, int Q, int N,
                          int D, int metric, int stages, int resident, int smem_bytes, int grid,
                          void* stream) {
    using namespace msd;
    return wg::launch<wg::SCORE>(q, x, aux, nullptr, out, Q, N, D, metric, stages, resident,
                                 smem_bytes, grid, static_cast<cudaStream_t>(stream));
}

// the f32 engine: qsplit is scratch for the query's TF32 halves, b32[2 Qp,
// Dp]; nt / stages / resident / smem_bytes / grid from
// ops/distance.py::f32_scan_geometry
extern "C" int msd_scores_f32(const void* q, void* qsplit, const void* x, const void* aux,
                              void* out, int Q, int N, int D, int metric, int nt, int stages,
                              int resident, int smem_bytes, int grid, void* stream) {
    using namespace msd;
    return tf::launch<wg::SCORE>(q, qsplit, x, aux, nullptr, out, Q, N, D, metric, nt, stages,
                                 resident, smem_bytes, grid, static_cast<cudaStream_t>(stream));
}
