// Kernel 1: the full score matrix out[Q, N] = metric(q . x^T).
//
// Replaces myscaledb_tpu/ops/distance.py::_score_kernel (launched by
// `scores`). Same math, max-is-better scores:
//   L2:     2 q.x - |x|^2      (aux = |x|^2)
//   Cosine: (q.x) * 1/|x|      (aux = 1/|x|, queries pre-normalised)
//   IP:     q.x                (aux unused, may be null)
//
// What bounds it on the H100: at the GIST shape (Q=256, N=114,688,
// D=1,024, bf16) it does 2 x 60 GFLOP (the hi/lo query split), 0.122 ms
// at the bf16 tensor-core peak; it reads a 235 MB payload (0.070 ms at
// 3.35 TB/s) and writes Q*N*4 = 117 MB of scores (0.035 ms). So the
// tensor-core rate bounds it, with the score write next.
//
// Design (score_tile.cuh): for a bf16 payload, the persistent TMA-ring +
// wgmma engine with the query split in the kernel; its epilogue applies
// the metric, stages each warpgroup's 64 x 32 slice of scores through
// shared memory and writes it with coalesced 16-byte stores (4-byte
// stores where N % 4 != 0, since the rows are then not 16-byte aligned),
// masked at the ragged Q and N edges, while the producer already loads
// the next tile. Plain stores, not TMA stores: a TMA store needs a row
// stride that is a multiple of 16 bytes. The TPU kernel's padding rules
// (Q%8, N%512) do not apply. For an f32 payload (off the main path), f32
// FMA on the CUDA cores, which keeps every product exact.

#include "score_tile.cuh"

namespace msd {

__global__ void __launch_bounds__(THREADS)
score_kernel_f32(const float* __restrict__ q, const float* __restrict__ x,
                 const float* __restrict__ aux, float* __restrict__ out,
                 int Q, int N, int D, int metric) {
    const int q0 = blockIdx.y * BM;
    const int n0 = blockIdx.x * BN;
    Tile t;
    fma_tile(q, x, Q, N, D, q0, n0, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int n = n0 + t.ni(j);
        if (n >= N) continue;
        const float a = metric == IP ? 0.0f : aux[n];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int qq = q0 + t.qi(i);
            if (qq < Q) out[(size_t)qq * N + n] = apply_metric(metric, t.acc[i][j], a);
        }
    }
}

}  // namespace msd

// stages / resident / smem_bytes / grid: the bf16 engine's geometry from
// ops/distance.py::scan_geometry (unused for an f32 payload)
extern "C" int msd_scores(const void* q, const void* x, const void* aux, void* out,
                          int Q, int N, int D, int metric, int x_bf16, int stages,
                          int resident, int smem_bytes, int grid, void* stream) {
    using namespace msd;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (x_bf16)
        return wg::launch<wg::SCORE>(q, x, aux, nullptr, out, Q, N, D, metric, stages,
                                     resident, smem_bytes, grid, s);
    const dim3 blocks((N + BN - 1) / BN, (Q + BM - 1) / BM);
    score_kernel_f32<<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(x),
        static_cast<const float*>(aux), static_cast<float*>(out), Q, N, D, metric);
    return static_cast<int>(cudaGetLastError());
}
