// The partial reduce of the approximate top-k: each score row folded into
// L bins, the max of each bin with its index.
//
// Replaces `jax.lax.approx_max_k` in myscaledb_tpu/ops/topk.py
// (`topk_scores(approx=True)`), which on the TPU is XLA's PartialReduce
// (Chern et al., 2022, "TPU-KNN"): the row, padded with -inf, is reshaped
// to [2^r, L] and reduced over its first axis, so element i goes to bin
// i mod L; the L winners then go through an exact top-k
// (aggregate_to_topk). This kernel computes the reduce; the exact top-k of
// the [Q, L] winners stays a torch op in ops/topk.py, as XLA's own top-k
// after the PartialReduce is.
//
// Bound: bytes. Every score is read once (4 bytes) and each bin writes its
// value and index (8 bytes): at Q 104, N 131,072, L 1,024, 54.5 MB read
// and 0.85 MB written, ~0.017 ms at 3.35 TB/s. The work is a compare a
// score.
//
// Design: a block takes 32 consecutive bins of one row, one a lane, so
// that a warp reads 128 consecutive bytes a step; its 8 warps split the
// row's fold rows j (element j * L + bin) among them, each warp keeping 4
// loads in flight, and fold their 8 partial winners in shared memory.
// A winner is the larger score, and of two equal scores the lower index:
// the first occurrence, as the plain version (`approx_bin_max_plain`)
// takes it, so the two agree bit for bit. The row stride is a parameter,
// so a column slice of a wider score matrix is read in place.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace msd {

constexpr int AB_BINS = 32;   // bins a block (one a lane)
constexpr int AB_WARPS = 8;   // warps a block, each over every 8th fold row
constexpr int AB_UNROLL = 4;  // loads a thread keeps in flight
constexpr int AB_MAX_GRID_Y = 65535;

__device__ __forceinline__ float ab_neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

__device__ __forceinline__ bool ab_better(float v, int i, float best, int arg) {
    return v > best || (v == best && i < arg);
}

__global__ void __launch_bounds__(AB_BINS * AB_WARPS)
approx_bin_max_kernel(const float* __restrict__ scores, float* __restrict__ out_v,
                      int32_t* __restrict__ out_i, int Q, int N, int ld, int L) {
    __shared__ float sv[AB_WARPS][AB_BINS];
    __shared__ int si[AB_WARPS][AB_BINS];
    const int lane = threadIdx.x % AB_BINS;
    const int warp = threadIdx.x / AB_BINS;
    const int b = blockIdx.x * AB_BINS + lane;
    const int nfold = (N + L - 1) / L;
    for (int q = blockIdx.y; q < Q; q += gridDim.y) {
        const float* row = scores + (size_t)q * ld;
        float best = ab_neg_inf();
        int arg = 0x7fffffff;
        if (b < L) {
            int j = warp;
            for (; j + (AB_UNROLL - 1) * AB_WARPS < nfold; j += AB_UNROLL * AB_WARPS) {
                float v[AB_UNROLL];
                int ix[AB_UNROLL];
#pragma unroll
                for (int u = 0; u < AB_UNROLL; ++u) {
                    ix[u] = (j + u * AB_WARPS) * L + b;
                    v[u] = ix[u] < N ? __ldg(row + ix[u]) : ab_neg_inf();
                }
#pragma unroll
                for (int u = 0; u < AB_UNROLL; ++u) {
                    if (ix[u] < N && ab_better(v[u], ix[u], best, arg)) {
                        best = v[u];
                        arg = ix[u];
                    }
                }
            }
            for (; j < nfold; j += AB_WARPS) {
                const int i = j * L + b;
                if (i < N) {
                    const float v = __ldg(row + i);
                    if (ab_better(v, i, best, arg)) {
                        best = v;
                        arg = i;
                    }
                }
            }
        }
        sv[warp][lane] = best;
        si[warp][lane] = arg;
        __syncthreads();
        if (warp == 0 && b < L) {
#pragma unroll
            for (int w = 1; w < AB_WARPS; ++w) {
                if (ab_better(sv[w][lane], si[w][lane], best, arg)) {
                    best = sv[w][lane];
                    arg = si[w][lane];
                }
            }
            // a bin of -inf scores keeps its first element, as the plain
            // version's first occurrence of the max does
            out_v[(size_t)q * L + b] = best;
            out_i[(size_t)q * L + b] = arg;
        }
        __syncthreads();
    }
}

}  // namespace msd

// scores f32 rows of Q x N at a stride of ld elements (ld >= N), out_v
// f32[Q, L], out_i int32[Q, L], 1 <= L <= N, N + L < 2^31.
// Returns cudaGetLastError() after the launch.
extern "C" int msd_approx_bin_max(const void* scores, void* out_v, void* out_i, int Q, int N,
                                  int ld, int L, void* stream) {
    using namespace msd;
    if (Q <= 0) return 0;
    const dim3 grid((L + AB_BINS - 1) / AB_BINS, Q < AB_MAX_GRID_Y ? Q : AB_MAX_GRID_Y);
    approx_bin_max_kernel<<<grid, AB_BINS * AB_WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scores), static_cast<float*>(out_v),
        static_cast<int32_t*>(out_i), Q, N, ld, L);
    return static_cast<int>(cudaGetLastError());
}
