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
// row). The card retires 16 popcounts per clock per SM (CUDA C++
// Programming Guide, arithmetic instruction throughput, compute capability
// 9.0), about 4.2e12 a second on 132 SMs at 1.98 GHz, against 64 per clock
// for the XOR/AND/OR and the adds. At the main path's shape (Q = 100,
// 1,024-bit rows: 32 words) a row costs 3,200 popcounts for 128 bytes
// read, 25 popcounts a byte, so the popcount unit bounds it (e.g. ~0.05
// ms per 64k-row chunk), not memory (~0.0025 ms for the same chunk's 8.4
// MB). So both layouts feed every staged word of a row to a tile of up to
// 16 queries, and Jaccard takes one popcount a word where the row counts
// are known: |q | x| = |q| + |x| - |q & x|.
//
// Rows layout: 256 threads a block, one row each. The block stages its
// rows' words in shared memory through coalesced loads (a row stride of 33
// words, so a thread reading its own row hits a bank of its own) and the
// words of a tile of up to 16 queries (read as broadcasts), 32 words at a
// time; every thread keeps one count (two for Jaccard) per query of the
// tile in registers.
//
// Blocks layout, in two kernels:
//   1. binary_group_kernel (one block) orders the Q * P (query, probe)
//      pairs by (bucket, q * P + p) and cuts each bucket's run into groups
//      of at most 16 pairs: (bucket, first pair, count). It is a
//      counting sort whose order is deterministic (no atomic decides a
//      pair's final place), and the group count stays on the device.
//   2. binary_groups_kernel: persistent blocks (SMs x occupancy) walk the
//      work items (group, 256-row tile of its bucket); the item count is
//      read from the device. Each thread takes one row of the tile, reads
//      it straight from global memory (16-byte loads where aligned) and
//      scores it against the group's query words staged in shared memory,
//      so each word read feeds up to 16 popcounts, where the one-query-a-
//      block design fed one.
// A batch probes few distinct buckets (149 of 1,024 at BinaryMSTG's main
// path for 1,600 probes), so grouping also cuts the reads of a bucket from
// one per probe to about one per 16.
//
// Rows whose byte count B is not a multiple of 4, or that do not start
// 4-byte aligned, are assembled byte by byte; bytes past B read as 0 in q
// and x alike, so the tail adds nothing to any popcount. Counts are exact
// integers and the Jaccard quotient is one IEEE division (__fdiv_rn), so
// the kernel equals its plain version bit for bit.

#include <cstddef>
#include <cstdint>

namespace msd {

constexpr int BN_THREADS = 256;  // rows of a block, one per thread
constexpr int BN_QT = 16;        // queries of a tile (rows layout) or a group (blocks layout)
constexpr int BN_WC = 32;        // 32-bit words staged per step (128 bytes)
constexpr int BB_ROWS = 256;     // bucket rows of a work item (blocks layout), one a thread
constexpr int BB_QSTEP = 4;      // a group's queries are scored in steps of this many
constexpr int BB_MIN_BLOCKS = 3; // resident scoring blocks an SM must fit (a register cap)
constexpr int BG_THREADS = 1024;            // threads of the grouping block
constexpr int BG_CHUNK = 2 * BG_THREADS;    // pairs sorted per scatter step
constexpr int BG_LOCAL_BITS = 11;           // bits of a pair's place in its chunk
constexpr uint32_t BG_PAD = 0xFFFFFFFFu;    // sort key of an empty chunk slot
constexpr int BG_RADIX = 5;                 // bucket bits sorted per radix pass
constexpr int BG_SMEM_BUCKETS = 2048;       // buckets the grouping counts in shared memory

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

// ------------------------------------------------------------ blocks layout

__device__ __forceinline__ int clamp_bucket(int c, int C) { return c < 0 ? 0 : (c >= C ? C - 1 : c); }

__device__ __forceinline__ uint32_t pair_key(const int32_t* blk, int i, int l, int n, int C) {
    return i < n ? (static_cast<uint32_t>(clamp_bucket(blk[i], C)) << BG_LOCAL_BITS) | l : BG_PAD;
}

// Exclusive block-wide scan of two ints (BG_THREADS threads), a sum (ADD)
// or a maximum (from -1); returns the prefixes in *s, *g and the totals in
// *s_all, *g_all.
template <bool ADD>
__device__ __forceinline__ void block_scan2(int* s, int* g, int* s_all, int* g_all) {
    __shared__ int ws[BG_THREADS / 32][2];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int none = ADD ? 0 : -1;
    auto op = [](int x, int y) { return ADD ? x + y : max(x, y); };
    int si = *s, gi = *g;  // inclusive within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int so = __shfl_up_sync(0xffffffffu, si, d), go = __shfl_up_sync(0xffffffffu, gi, d);
        if (lane >= d) {
            si = op(si, so);
            gi = op(gi, go);
        }
    }
    if (lane == 31) {
        ws[warp][0] = si;
        ws[warp][1] = gi;
    }
    __syncthreads();
    if (warp == 0) {
        int a = ws[lane][0], b = ws[lane][1];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int ao = __shfl_up_sync(0xffffffffu, a, d), bo = __shfl_up_sync(0xffffffffu, b, d);
            if (lane >= d) {
                a = op(a, ao);
                b = op(b, bo);
            }
        }
        ws[lane][0] = a;
        ws[lane][1] = b;
    }
    __syncthreads();
    const int sw = warp > 0 ? ws[warp - 1][0] : none, gw = warp > 0 ? ws[warp - 1][1] : none;
    *s_all = ws[BG_THREADS / 32 - 1][0];
    *g_all = ws[BG_THREADS / 32 - 1][1];
    // exclusive: the earlier warps, then the earlier lanes of this one
    const int sl = __shfl_up_sync(0xffffffffu, si, 1), gl = __shfl_up_sync(0xffffffffu, gi, 1);
    *s = op(sw, lane > 0 ? sl : none);
    *g = op(gw, lane > 0 ? gl : none);
    __syncthreads();  // ws may be written again
}

// Sort the BG_CHUNK keys of a[] by the low `bits` bits of their bucket,
// stably (so by (bucket, place) for buckets < 2^bits), with b[] as
// scratch: an LSD radix sort of BG_RADIX bits a pass. In a pass, element e
// (round e / BG_THREADS, then warp, then lane: the order of e) goes to the
// count of (smaller digit) + (equal digit, earlier round, warp) plus its
// rank among the equal digits of its warp (__match_any_sync). The padding's
// digits are all ones, so it stays last. Returns the array that holds the
// sorted keys; the block is in step at the end.
__device__ __forceinline__ uint32_t* sort_chunk(uint32_t* a, uint32_t* b, int bits) {
    constexpr int ROUNDS = BG_CHUNK / BG_THREADS, WARPS = BG_THREADS / 32;
    constexpr int BINS = 1 << BG_RADIX;
    __shared__ int hist[BINS * ROUNDS * WARPS];
    static_assert(BINS * ROUNDS * WARPS == 2 * BG_THREADS, "two counts a thread");
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const unsigned below = (1u << lane) - 1u;
    for (int shift = BG_LOCAL_BITS; shift < BG_LOCAL_BITS + bits; shift += BG_RADIX) {
        uint32_t key[ROUNDS];
        int cell[ROUNDS], rank[ROUNDS], count[ROUNDS];
#pragma unroll
        for (int r = 0; r < ROUNDS; ++r) {
            key[r] = a[r * BG_THREADS + tid];
            const int d = static_cast<int>((key[r] >> shift) & (BINS - 1));
            const unsigned peers = __match_any_sync(0xffffffffu, d);
            cell[r] = (d * ROUNDS + r) * WARPS + warp;
            rank[r] = __popc(peers & below);
            count[r] = rank[r] == 0 ? __popc(peers) : 0;  // the first of the peers writes the count
            hist[ROUNDS * tid + r] = 0;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < ROUNDS; ++r) {
            if (count[r] > 0) hist[cell[r]] = count[r];
        }
        __syncthreads();
        int h0 = hist[2 * tid], h1 = hist[2 * tid + 1], s = h0 + h1, unused = 0, total, unused_all;
        block_scan2<true>(&s, &unused, &total, &unused_all);
        hist[2 * tid] = s;
        hist[2 * tid + 1] = s + h0;
        __syncthreads();
#pragma unroll
        for (int r = 0; r < ROUNDS; ++r) b[hist[cell[r]] + rank[r]] = key[r];
        __syncthreads();
        uint32_t* t = a;
        a = b;
        b = t;
    }
    return a;
}

// For the sorted keys[2 * tid + r], r = 0, 1: its rank within the run of
// its bucket (a block max-scan of the runs' first places).
__device__ __forceinline__ void run_ranks(const uint32_t* keys, int* rank) {
    int head[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int l = 2 * threadIdx.x + r;
        head[r] = l == 0 || (keys[l - 1] >> BG_LOCAL_BITS) != (keys[l] >> BG_LOCAL_BITS) ? l : -1;
    }
    int first = max(head[0], head[1]), unused = -1, first_all, unused_all;
    block_scan2<false>(&first, &unused, &first_all, &unused_all);
    const int s0 = max(first, head[0]), s1 = max(s0, head[1]);
    rank[0] = 2 * static_cast<int>(threadIdx.x) - s0;
    rank[1] = 2 * static_cast<int>(threadIdx.x) + 1 - s1;
}

// The Q * P = n pairs (pair i = q * P + p, bucket clamp(blk[i])) in
// (bucket, i) order into pairs[n], and the groups of at most BN_QT pairs of
// one bucket as groups[g] = (bucket, first pair, count), their number in
// *ngroups. cursor[C] is scratch. One block of BG_THREADS threads.
//
// Up to BG_CHUNK pairs over up to BG_SMEM_BUCKETS buckets (the main
// path's batches) everything stays in shared memory: the pairs are
// counted per bucket (shared atomics), an exclusive scan gives each
// bucket's first place and its groups, the pairs are dropped into their
// buckets' places in any order (shared atomics again), and each pair then
// takes the place of its rank by index among its bucket's pairs, so the
// order is deterministic. More pairs or buckets take a counting sort
// through global memory: a histogram over the C buckets in `cursor` (read
// through L2 only: it is written by atomics and by other threads of the
// block), an exclusive scan, then a stable scatter of BG_CHUNK pairs at a
// time, each chunk radix-sorted in shared memory (two neighbouring keys a
// thread), so that a pair's place within its bucket needs no atomics.
__global__ void __launch_bounds__(BG_THREADS)
binary_group_kernel(const int32_t* __restrict__ blk, int n, int C, int32_t* __restrict__ cursor,
                    int32_t* __restrict__ pairs, int32_t* __restrict__ groups,
                    int32_t* __restrict__ ngroups) {
    __shared__ uint32_t smem[BG_CHUNK + 2 * BG_SMEM_BUCKETS];
    const int tid = threadIdx.x;
    if (n <= BG_CHUNK && C <= BG_SMEM_BUCKETS) {
        uint32_t* placed = smem;                                      // [n] pair ids
        int* cnt = reinterpret_cast<int*>(smem + BG_CHUNK);           // [C] counts, then cursors
        int* first = reinterpret_cast<int*>(smem + BG_CHUNK + BG_SMEM_BUCKETS);  // [C]
        for (int c = tid; c < C; c += BG_THREADS) cnt[c] = 0;
        int bq[BG_CHUNK / BG_THREADS];
#pragma unroll
        for (int r = 0; r < BG_CHUNK / BG_THREADS; ++r) {
            const int i = r * BG_THREADS + tid;
            bq[r] = i < n ? clamp_bucket(blk[i], C) : -1;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < BG_CHUNK / BG_THREADS; ++r) {
            if (bq[r] >= 0) atomicAdd(cnt + bq[r], 1);
        }
        __syncthreads();
        const int span = (C + BG_THREADS - 1) / BG_THREADS;
        const int c0 = min(C, tid * span), c1 = min(C, c0 + span);
        int s = 0, g = 0;
        for (int c = c0; c < c1; ++c) {
            s += cnt[c];
            g += (cnt[c] + BN_QT - 1) / BN_QT;
        }
        int s_all, g_all;
        block_scan2<true>(&s, &g, &s_all, &g_all);
        for (int c = c0; c < c1; ++c) {
            const int k = cnt[c];
            first[c] = cnt[c] = s;
            for (int f = 0; f < k; f += BN_QT, ++g) {
                groups[3 * (size_t)g] = c;
                groups[3 * (size_t)g + 1] = s + f;
                groups[3 * (size_t)g + 2] = min(BN_QT, k - f);
            }
            s += k;
        }
        if (tid == 0) *ngroups = g_all;
        __syncthreads();
#pragma unroll
        for (int r = 0; r < BG_CHUNK / BG_THREADS; ++r) {
            if (bq[r] >= 0) placed[atomicAdd(cnt + bq[r], 1)] = r * BG_THREADS + tid;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < BG_CHUNK / BG_THREADS; ++r) {
            if (bq[r] < 0) continue;
            const uint32_t i = r * BG_THREADS + tid;
            // the bucket's places, each lane starting at its own offset so
            // that lanes on neighbouring buckets read other banks
            const int lo = first[bq[r]], len = cnt[bq[r]] - lo;
            int rank = 0;
            for (int t = 0, p = tid % len; t < len; ++t, p = p + 1 == len ? 0 : p + 1) {
                rank += placed[lo + p] < i;
            }
            pairs[lo + rank] = static_cast<int>(i);
        }
        return;
    }
    // 1. pairs per bucket
    for (int c = tid; c < C; c += BG_THREADS) __stcg(cursor + c, 0);
    __syncthreads();
    for (int i = tid; i < n; i += BG_THREADS) atomicAdd(cursor + clamp_bucket(blk[i], C), 1);
    __syncthreads();
    // 2. each thread a contiguous span of buckets: exclusive scans of the
    //    pair counts (each bucket's first place) and of the group counts;
    //    the span's groups are written, and cursor[c] becomes c's first place
    const int span = (C + BG_THREADS - 1) / BG_THREADS;
    const int c0 = min(C, tid * span), c1 = min(C, c0 + span);
    int s = 0, g = 0;
    for (int c = c0; c < c1; ++c) {
        const int k = __ldcg(cursor + c);
        s += k;
        g += (k + BN_QT - 1) / BN_QT;
    }
    int s_all, g_all;
    block_scan2<true>(&s, &g, &s_all, &g_all);
    for (int c = c0; c < c1; ++c) {
        const int k = __ldcg(cursor + c);
        __stcg(cursor + c, s);
        for (int f = 0; f < k; f += BN_QT, ++g) {
            groups[3 * (size_t)g] = c;
            groups[3 * (size_t)g + 1] = s + f;
            groups[3 * (size_t)g + 2] = min(BN_QT, k - f);
        }
        s += k;
    }
    if (tid == 0) *ngroups = g_all;
    __syncthreads();
    // 3. stable scatter, BG_CHUNK pairs at a time: the sorted chunk puts
    //    each bucket's pairs of the chunk in order, side by side; a pair
    //    goes to its bucket's cursor plus its rank in the run, and the
    //    run's last pair advances the cursor past the run
    const int bits = C > 1 ? 32 - __clz(C - 1) : 0;
    uint32_t* buf0 = smem;
    uint32_t* buf1 = smem + BG_CHUNK;
    for (int base = 0; base < n; base += BG_CHUNK) {
        for (int l = tid; l < BG_CHUNK; l += BG_THREADS) buf0[l] = pair_key(blk, base + l, l, n, C);
        __syncthreads();
        const uint32_t* keys = sort_chunk(buf0, buf1, bits);
        int rank[2];
        run_ranks(keys, rank);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const uint32_t key = keys[2 * tid + r];
            if (key == BG_PAD) continue;
            pairs[__ldcg(cursor + (key >> BG_LOCAL_BITS)) + rank[r]] =
                base + static_cast<int>(key & (BG_CHUNK - 1));
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int l = 2 * tid + r;
            const uint32_t key = keys[l];
            if (key == BG_PAD) continue;
            const uint32_t b = key >> BG_LOCAL_BITS;
            if (l == BG_CHUNK - 1 || (keys[l + 1] >> BG_LOCAL_BITS) != b) {
                __stcg(cursor + b, __ldcg(cursor + b) + rank[r] + 1);
            }
        }
        __syncthreads();
    }
}

// Count of four words of a query against four of a row: |q ^ x| (Hamming)
// or |q & x| (Jaccard).
template <bool JACCARD>
__device__ __forceinline__ void count4(const uint4& qv, const uint4& xv, int& a) {
    if (JACCARD) {
        a += __popc(qv.x & xv.x) + __popc(qv.y & xv.y) + __popc(qv.z & xv.z) + __popc(qv.w & xv.w);
    } else {
        a += __popc(qv.x ^ xv.x) + __popc(qv.y ^ xv.y) + __popc(qv.z ^ xv.z) + __popc(qv.w ^ xv.w);
    }
}

// One chunk of BN_WC words: the thread's row words xv against the first
// NQ staged queries, in straight-line code (the staged words of queries
// past the group's count are zeros, and their counts are not written).
template <bool JACCARD, int NQ>
__device__ __forceinline__ void count_chunk(const uint4 (*qs)[BN_WC / 4], const uint4* xv, int kn,
                                            int* a) {
#pragma unroll
    for (int k = 0; k < BN_WC / 4; ++k) {
        if (k < kn) {
#pragma unroll
            for (int j = 0; j < NQ; ++j) count4<JACCARD>(qs[j][k], xv[k], a[j]);
        }
    }
}

// Hamming, or Jaccard with one popcount a word: |q & x|, the union from |q|
// (summed as the query words are staged) and popcnt = |x|.
// A work item is a group and a tile of BB_ROWS rows of its bucket, one row
// a thread, numbered tile-major (every group's first tile, then every
// second one: the short last tiles come at the end); block b takes items
// b, b + gridDim.x, ... While it scores one item it loads the next one's
// group and pairs, and each item's row words, row id, mask byte and bit
// count are loaded before its query words are staged, so that few loads
// stand between two items. A group of n queries is scored as
// ceil(n / BB_QSTEP) * BB_QSTEP of them in branch-free code (one instance
// each), so the loads and popcounts of several queries overlap.
template <bool JACCARD>
__global__ void __launch_bounds__(BB_ROWS, BB_MIN_BLOCKS)
binary_groups_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ x,
                     const int32_t* __restrict__ rows, const uint8_t* __restrict__ mask,
                     const int32_t* __restrict__ popcnt, const int32_t* __restrict__ pairs,
                     const int32_t* __restrict__ groups, const int32_t* __restrict__ ngroups,
                     float* __restrict__ out, int P, int M, int B, int n_mask, int aligned,
                     int vec) {
    __shared__ uint4 qs[BN_QT][BN_WC / 4];
    __shared__ int pq[BN_QT];  // the group's pairs (q * P + p)
    __shared__ int qn[BN_QT];  // |q| of the group's queries (Jaccard)
    const int tid = threadIdx.x, lane = tid % 32;
    const int n_groups = *ngroups;
    const int items = n_groups * ((M + BB_ROWS - 1) / BB_ROWS);
    const int W = (B + 3) / 4;
    // the item's group (bucket, first pair, count) and, for tid < BN_QT,
    // its pair: loaded one item ahead
    int item = blockIdx.x, gc = 0, gf = 0, gn = 0, gp = 0;
    if (item < items) {
        const int g = item % n_groups;
        gc = groups[3 * (size_t)g];
        gf = groups[3 * (size_t)g + 1];
        gn = groups[3 * (size_t)g + 2];
        gp = tid < gn ? pairs[gf + tid] : 0;
    }
    for (; item < items; item += gridDim.x) {
        const int c = gc, n = gn, m = (item / n_groups) * BB_ROWS + tid;
        __syncthreads();  // the previous item is done with pq, qn and qs
        if (tid < BN_QT) {
            pq[tid] = gp;
            qn[tid] = 0;
        }
        const bool live = m < M;
        const size_t slot = (size_t)c * M + (live ? m : 0);
        const uint8_t* xr = x + slot * B;
        const int row = live ? rows[slot] : -1;
        const bool valid = row >= 0 && (mask == nullptr || (row < n_mask && mask[row] != 0));
        const int xp = JACCARD && live ? popcnt[slot] : 0;
        int a[BN_QT];
#pragma unroll
        for (int j = 0; j < BN_QT; ++j) a[j] = 0;
        for (int c0 = 0; c0 < W; c0 += BN_WC) {
            const int kn = min(BN_WC / 4, (W - c0 + 3) / 4);
            uint4 xv[BN_WC / 4];
#pragma unroll
            for (int k = 0; k < BN_WC / 4; ++k) {
                const int w = c0 + 4 * k;
                if (!live || k >= kn) {
                    xv[k] = make_uint4(0u, 0u, 0u, 0u);
                } else if (vec) {
                    xv[k] = *reinterpret_cast<const uint4*>(xr + 4 * w);
                } else {
                    xv[k] = make_uint4(load_word(xr, w, B, aligned), load_word(xr, w + 1, B, aligned),
                                       load_word(xr, w + 2, B, aligned),
                                       load_word(xr, w + 3, B, aligned));
                }
            }
            __syncthreads();  // pq is set; the previous words are done with
            // stage the group's query words [c0, c0 + BN_WC): a warp takes
            // one query's 32 words, so its |q| part is one warp sum
            uint32_t* qw = reinterpret_cast<uint32_t*>(qs);
            for (int i = tid; i < BN_QT * BN_WC; i += BB_ROWS) {
                const int j = i / BN_WC;
                const uint32_t v = j < n ? load_word(q + (size_t)(pq[j] / P) * B, c0 + i % BN_WC, B,
                                                     aligned)
                                         : 0u;
                qw[i] = v;
                if (JACCARD) {
                    const int part = __reduce_add_sync(0xffffffffu, __popc(v));
                    if (lane == 0) qn[j] += part;
                }
            }
            __syncthreads();
            if (c0 == 0 && item + static_cast<int>(gridDim.x) < items) {  // the next item's group
                const int g = (item + gridDim.x) % n_groups;
                gc = groups[3 * (size_t)g];
                gf = groups[3 * (size_t)g + 1];
                gn = groups[3 * (size_t)g + 2];
                gp = tid < gn ? pairs[gf + tid] : 0;
            }
            if (!live) continue;
            switch ((n + BB_QSTEP - 1) / BB_QSTEP) {  // block-uniform
                case 1: count_chunk<JACCARD, BB_QSTEP>(qs, xv, kn, a); break;
                case 2: count_chunk<JACCARD, 2 * BB_QSTEP>(qs, xv, kn, a); break;
                case 3: count_chunk<JACCARD, 3 * BB_QSTEP>(qs, xv, kn, a); break;
                default: count_chunk<JACCARD, BN_QT>(qs, xv, kn, a); break;
            }
        }
        if (!live) continue;
#pragma unroll
        for (int j = 0; j < BN_QT; ++j) {
            if (j < n) {
                out[(size_t)pq[j] * M + m] = finish<JACCARD>(a[j], qn[j] + xp - a[j], valid);
            }
        }
    }
}

// Persistent grid of the groups kernel: SMs x resident blocks per SM.
template <bool JACCARD>
static int groups_grid() {
    static int grid = 0;
    if (grid == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, binary_groups_kernel<JACCARD>, BB_ROWS, 0);
        grid = sms * (per_sm > 0 ? per_sm : 1);
    }
    return grid;
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

// blk int32[n] (n = Q * P, clamped to [0, C) here; C < 2^21), cursor
// int32[C] scratch, pairs int32[n], groups int32[>= ceil(n / 16) +
// min(C, n), 3], ngroups int32[1].
extern "C" int msd_binary_group(const void* blk, int n, int C, void* cursor, void* pairs,
                                void* groups, void* ngroups, void* stream) {
    using namespace msd;
    binary_group_kernel<<<1, BG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(blk), n, C, static_cast<int32_t*>(cursor),
        static_cast<int32_t*>(pairs), static_cast<int32_t*>(groups), static_cast<int32_t*>(ngroups));
    return static_cast<int>(cudaGetLastError());
}

// q u8[Q, B], x u8[C, M, B], rows int32[C, M], mask u8[n_mask] or null,
// popcnt int32[C, M] (|x| of each slot; Jaccard needs it, Hamming does not
// read it), the grouping of msd_binary_group (pairs, groups, ngroups), out
// f32[Q, P * M]. metric 0 = Hamming, 1 = Jaccard; aligned = B % 4 == 0 and
// q, x 4-byte aligned; vec = B % 16 == 0 and x 16-byte aligned.
extern "C" int msd_binary_blocks(const void* q, const void* x, const void* rows, const void* mask,
                                 const void* popcnt, const void* pairs, const void* groups,
                                 const void* ngroups, void* out, int P, int M, int B, int n_mask,
                                 int metric, int aligned, int vec, void* stream) {
    using namespace msd;
    auto* s = static_cast<cudaStream_t>(stream);
    auto qp = static_cast<const uint8_t*>(q);
    auto xp = static_cast<const uint8_t*>(x);
    auto rp = static_cast<const int32_t*>(rows);
    auto mp = static_cast<const uint8_t*>(mask);
    auto cp = static_cast<const int32_t*>(popcnt);
    auto pp = static_cast<const int32_t*>(pairs);
    auto gp = static_cast<const int32_t*>(groups);
    auto np = static_cast<const int32_t*>(ngroups);
    auto op = static_cast<float*>(out);
    if (metric == 1) {
        if (popcnt == nullptr) return static_cast<int>(cudaErrorInvalidValue);
        binary_groups_kernel<true><<<groups_grid<true>(), BB_ROWS, 0, s>>>(
            qp, xp, rp, mp, cp, pp, gp, np, op, P, M, B, n_mask, aligned, vec);
    } else {
        binary_groups_kernel<false><<<groups_grid<false>(), BB_ROWS, 0, s>>>(
            qp, xp, rp, mp, cp, pp, gp, np, op, P, M, B, n_mask, aligned, vec);
    }
    return static_cast<int>(cudaGetLastError());
}
