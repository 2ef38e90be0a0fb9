// Kernel 4: Hamming and Jaccard scores over packed bit rows,
//     Hamming  score = -popcount(q ^ x)
//     Jaccard  score = popcount(q & x) / popcount(q | x)   (1.0 when the union is 0)
// with the row mask fused (a row that is not searchable scores -inf).
//
// Replaces the `lax.population_count` scoring of the JAX package:
// myscaledb_tpu/ops/binary.py::binary_chunk_scores (the BinaryFLAT scan and
// BinaryMSTG's overflow scan) and the bucket step of
// myscaledb_tpu/index/binary.py::BinaryMSTGIndex.search_t. torch has no
// popcount; its plain version (a 256-entry lookup table over bytes) would
// build a [Q, N, B] tensor of XORed bytes.
//
// Two layouts:
//   rows    q u8[Q, B] against one shared base x u8[N, B] (the flat scan, in
//           the caller's 64k-row chunks): rows >= n_valid and rows whose
//           mask byte is 0 score -inf;
//   blocks  q u8[Q, B] against P blocks per query, block blk[q, p] of
//           x u8[C, M, B] (BinaryMSTG's buckets, read in place: no gathered
//           [Q, M, B] copy), out f32[Q, P * M]; a slot whose row id
//           rows[c, m] is < 0, or whose row the mask drops, scores -inf.
//
// What bounds it on the H100: one popcount per 32-bit word per (query,
// row) for Hamming, two for Jaccard. The card retires 16 popcounts per
// clock per SM (CUDA C++ Programming Guide, arithmetic instruction
// throughput, compute capability 9.0), about 4.2e12 a second on 132 SMs at
// 1.98 GHz, against 64 per clock for the XOR/AND/OR and the adds. At
// the main path's shape (Q = 100, 1,024-bit rows: 32 words) a row costs
// 3,200 popcounts for 128 bytes read, 25 popcounts a byte, so the
// popcount unit bounds it (e.g. ~0.05 ms per 64k-row chunk), not memory
// (~0.0025 ms for the same chunk's 8.4 MB).
//
// Design (a simple kernel that is right): 256 threads a block, one row
// each. The block stages its rows' words in shared memory through
// coalesced loads (a row stride of 33 words, so a thread reading its own
// row hits a bank of its own) and the words of a tile of up to 16 queries
// (read as broadcasts), 32 words at a time; every thread keeps one count
// (two for Jaccard) per query of the tile in registers. Rows whose byte
// count B is not a multiple of 4, or that do not start 4-byte aligned,
// are assembled byte by byte; bytes past B read as 0 in q and x alike, so
// the tail adds nothing to any popcount. Counts are exact integers and the
// Jaccard quotient is one IEEE division (__fdiv_rn), so the kernel equals
// its plain version bit for bit.

#include <cstddef>
#include <cstdint>

namespace msd {

constexpr int BN_THREADS = 256;  // rows of a block, one per thread
constexpr int BN_QT = 16;        // queries of a block (rows layout)
constexpr int BN_WC = 32;        // 32-bit words staged per step (128 bytes)

__device__ __forceinline__ uint32_t load_word(const uint8_t* row, int word, int B, bool aligned) {
    const int b0 = word * 4;
    if (b0 >= B) return 0u;
    if (aligned) return *reinterpret_cast<const uint32_t*>(row + b0);
    uint32_t v = 0u;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        if (b0 + t < B) v |= static_cast<uint32_t>(row[b0 + t]) << (8 * t);
    }
    return v;
}

template <bool JACCARD>
__device__ __forceinline__ float finish(int a, int u, bool valid) {
    if (!valid) return -__int_as_float(0x7f800000);
    if (JACCARD) return u > 0 ? __fdiv_rn(static_cast<float>(a), static_cast<float>(u)) : 1.0f;
    return -static_cast<float>(a);
}

// Counts of this thread's row (staged in xs) against QT staged queries.
template <bool JACCARD, int QT>
__device__ __forceinline__ void count_step(const uint32_t (*xs)[BN_WC + 1],
                                           const uint32_t (*qs)[BN_WC], int* a, int* u) {
#pragma unroll 4
    for (int w = 0; w < BN_WC; ++w) {
        const uint32_t xv = xs[threadIdx.x][w];
#pragma unroll
        for (int j = 0; j < QT; ++j) {
            const uint32_t qv = qs[j][w];
            if (JACCARD) {
                a[j] += __popc(qv & xv);
                u[j] += __popc(qv | xv);
            } else {
                a[j] += __popc(qv ^ xv);
            }
        }
    }
}

// Stage words [c0, c0 + BN_WC) of `nrows` rows, row i at base + i * B
// (rows past `limit` read as 0), into dst[i][*].
template <int STRIDE>
__device__ __forceinline__ void stage(uint32_t (*dst)[STRIDE], const uint8_t* base, int nrows,
                                      int limit, int B, int c0, bool aligned) {
    for (int i = threadIdx.x; i < nrows * BN_WC; i += BN_THREADS) {
        const int r = i / BN_WC, w = i % BN_WC;
        dst[r][w] = r < limit ? load_word(base + (size_t)r * B, c0 + w, B, aligned) : 0u;
    }
}

template <bool JACCARD>
__global__ void __launch_bounds__(BN_THREADS)
binary_rows_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ x,
                   const uint8_t* __restrict__ mask, float* __restrict__ out,
                   int Q, int N, int B, int n_valid, int aligned) {
    __shared__ uint32_t xs[BN_THREADS][BN_WC + 1];
    __shared__ uint32_t qs[BN_QT][BN_WC];
    const int n0 = blockIdx.x * BN_THREADS;
    const int q0 = blockIdx.y * BN_QT;
    const int W = (B + 3) / 4;
    int a[BN_QT], u[BN_QT];
#pragma unroll
    for (int j = 0; j < BN_QT; ++j) a[j] = u[j] = 0;
    for (int c0 = 0; c0 < W; c0 += BN_WC) {
        stage<BN_WC + 1>(xs, x + (size_t)n0 * B, BN_THREADS, N - n0, B, c0, aligned);
        stage<BN_WC>(qs, q + (size_t)q0 * B, BN_QT, Q - q0, B, c0, aligned);
        __syncthreads();
        count_step<JACCARD, BN_QT>(xs, qs, a, u);
        __syncthreads();
    }
    const int n = n0 + threadIdx.x;
    if (n >= N) return;
    const bool valid = n < n_valid && (mask == nullptr || mask[n] != 0);
#pragma unroll
    for (int j = 0; j < BN_QT; ++j) {
        if (q0 + j < Q) out[(size_t)(q0 + j) * N + n] = finish<JACCARD>(a[j], u[j], valid);
    }
}

template <bool JACCARD>
__global__ void __launch_bounds__(BN_THREADS)
binary_blocks_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ x,
                     const int32_t* __restrict__ blk, const int32_t* __restrict__ rows,
                     const uint8_t* __restrict__ mask, float* __restrict__ out,
                     int P, int M, int B, int C, int n_mask, int aligned) {
    __shared__ uint32_t xs[BN_THREADS][BN_WC + 1];
    __shared__ uint32_t qs[1][BN_WC];
    const int m0 = blockIdx.x * BN_THREADS;
    const int p = blockIdx.y;
    const int qi = blockIdx.z;
    int c = blk[(size_t)qi * P + p];
    c = c < 0 ? 0 : (c >= C ? C - 1 : c);
    const uint8_t* base = x + ((size_t)c * M + m0) * B;
    const int W = (B + 3) / 4;
    int a[1] = {0}, u[1] = {0};
    for (int c0 = 0; c0 < W; c0 += BN_WC) {
        stage<BN_WC + 1>(xs, base, BN_THREADS, M - m0, B, c0, aligned);
        stage<BN_WC>(qs, q + (size_t)qi * B, 1, 1, B, c0, aligned);
        __syncthreads();
        count_step<JACCARD, 1>(xs, qs, a, u);
        __syncthreads();
    }
    const int m = m0 + threadIdx.x;
    if (m >= M) return;
    const int row = rows[(size_t)c * M + m];
    const bool valid = row >= 0 && (mask == nullptr || (row < n_mask && mask[row] != 0));
    out[((size_t)qi * P + p) * M + m] = finish<JACCARD>(a[0], u[0], valid);
}

}  // namespace msd

// q u8[Q, B], x u8[N, B], mask u8[N] or null, out f32[Q, N]; metric 0 =
// Hamming, 1 = Jaccard; aligned = B % 4 == 0 and q, x 4-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int msd_binary_rows(const void* q, const void* x, const void* mask, void* out,
                               int Q, int N, int B, int n_valid, int metric, int aligned,
                               void* stream) {
    using namespace msd;
    const dim3 grid((N + BN_THREADS - 1) / BN_THREADS, (Q + BN_QT - 1) / BN_QT);
    auto* s = static_cast<cudaStream_t>(stream);
    auto qp = static_cast<const uint8_t*>(q);
    auto xp = static_cast<const uint8_t*>(x);
    auto mp = static_cast<const uint8_t*>(mask);
    auto op = static_cast<float*>(out);
    if (metric == 1) {
        binary_rows_kernel<true><<<grid, BN_THREADS, 0, s>>>(qp, xp, mp, op, Q, N, B, n_valid, aligned);
    } else {
        binary_rows_kernel<false><<<grid, BN_THREADS, 0, s>>>(qp, xp, mp, op, Q, N, B, n_valid, aligned);
    }
    return static_cast<int>(cudaGetLastError());
}

// q u8[Q, B], x u8[C, M, B], blk int32[Q, P] (clamped to [0, C) here),
// rows int32[C, M], mask u8[n_mask] or null, out f32[Q, P * M].
extern "C" int msd_binary_blocks(const void* q, const void* x, const void* blk, const void* rows,
                                 const void* mask, void* out, int Q, int P, int M, int B, int C,
                                 int n_mask, int metric, int aligned, void* stream) {
    using namespace msd;
    const dim3 grid((M + BN_THREADS - 1) / BN_THREADS, P, Q);
    auto* s = static_cast<cudaStream_t>(stream);
    auto qp = static_cast<const uint8_t*>(q);
    auto xp = static_cast<const uint8_t*>(x);
    auto bp = static_cast<const int32_t*>(blk);
    auto rp = static_cast<const int32_t*>(rows);
    auto mp = static_cast<const uint8_t*>(mask);
    auto op = static_cast<float*>(out);
    if (metric == 1) {
        binary_blocks_kernel<true><<<grid, BN_THREADS, 0, s>>>(qp, xp, bp, rp, mp, op, P, M, B, C, n_mask, aligned);
    } else {
        binary_blocks_kernel<false><<<grid, BN_THREADS, 0, s>>>(qp, xp, bp, rp, mp, op, P, M, B, C, n_mask, aligned);
    }
    return static_cast<int>(cudaGetLastError());
}
