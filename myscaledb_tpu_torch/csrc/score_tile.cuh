// Shared engines of the two scan kernels (score.cu, tile_max.cu).
//
// Both kernels compute s[q][n] = sum_d q[q][d] * x[n][d] over a query
// tile and a payload tile, then apply an epilogue (score.cu: the metric
// and a store of every score; tile_max.cu: the mask, the metric and the
// max over each 128-row sub-tile). Which engine runs depends on the
// payload type.
//
// * bf16 payload (the main path) -> `wgmma_scan_kernel`, below. It
//   replaces the tensor-core core of myscaledb_tpu/ops/distance.py::
//   _score_kernel and myscaledb_tpu/ops/tilescan.py::_tile_max_kernel.
//   The f32 query is split in the kernel into bf16 hi and lo halves
//   (round to nearest even, q ~= hi + lo, ~16 mantissa bits, bit for bit
//   as ops/distance.py::split_query_bf16), and both halves multiply the
//   bf16 payload on the tensor cores into one f32 accumulator, as the TPU
//   kernels do. A single bf16 pass of the query would reorder near-tied
//   neighbours at SIFT scale.
// * f32 payload (off the main path) -> `fma_tile`: f32 FMA on the CUDA
//   cores (no tensor-core format keeps f32 exact), one 128 x 128 tile per
//   256-thread block. Thread (ty, tx) of a 16 x 16 grid owns queries
//   ty + 16*i and rows tx + 16*j, which keeps shared-memory reads
//   conflict-free.
//
// What bounds the bf16 engine on the H100, and what the design does:
//
// * Tensor-core rate. The hi/lo split doubles the MMA work: at the GIST
//   shape (Q=256, N=114,688, D=1,024) 120 GFLOP, 0.122 ms at 989 TF/s.
//   `wgmma.mma_async` m64n256k16 (bf16 x bf16 -> f32, the payload as the
//   K-major B operand from 128B-swizzled shared memory) is the only
//   instruction that reaches that rate; two per 16-deep step (hi, then
//   lo) into the same accumulator.
// * Payload bytes. At the SIFT shape (Q=104, N=1,048,576, D=128) tile_max
//   reads 256 MiB, 0.080 ms at 3.35 TB/s, against 0.069 ms of padded MMA
//   work: both bounds are close, so loads and MMAs must overlap. One
//   producer thread keeps TMA loads (`cp.async.bulk.tensor`) of
//   [256 rows x 64] payload chunks in flight through a ring of 2-4
//   mbarrier-guarded stages; `setmaxnreg` moves the producer warpgroup's
//   registers to the two consumer warpgroups (40 / 232). A tile's last
//   chunk also brings its aux (and mask) into the stage, so the epilogue
//   reads them from shared memory.
// * The query. A block tile is BM = 128 queries (one 64-row wgmma per
//   consumer warpgroup) x BN = 256 rows. Its hi+lo halves take as many
//   bytes as its f32 values: 2 x 128 x D x 2 B.
//   - Resident (Q <= 128 and D <= 128, the SIFT shapes): each persistent
//     block loads the query once, splits it into swizzled hi/lo tiles
//     (<= 64 KiB) and keeps them for its whole life; the wgmmas read A
//     from there, and the ring carries only payload (4 stages of 34 KiB).
//   - Streamed (every other shape, e.g. GIST's 256 x 1,024 = 1 MiB of
//     hi+lo): the f32 query chunk [128 x 64] rides the ring beside the
//     payload chunk (3 stages of 66 KiB). Each consumer thread reads its
//     own A fragments of it, splits them in registers and issues the
//     register-A wgmma: no hi/lo tile is written to shared memory and read
//     back, a round trip that would compete with the wgmmas for shared-
//     memory bandwidth on every chunk. L2 -> SM traffic at GIST:
//     896 tiles x 512 KiB of f32 query (470 MB) plus the payload once per
//     q-tile (2 x 235 MB): ~0.94 GB, half of what BN = 128 would move
//     (the query traffic scales with N / BN). BN = 256 is the widest
//     wgmma.
// * Persistent blocks. One block per SM walks the output tiles n-major
//   with the q-tiles inner (tile t -> n-tile t / q_tiles, q-tile
//   t % q_tiles), so the q-tiles of one payload tile run at the same time
//   on neighbouring blocks and the payload comes from HBM once. A
//   consumer warpgroup whose 64 queries all lie past Q issues no MMA.
// * Epilogues read the wgmma accumulator layout directly (thread t of a
//   warpgroup holds rows 16*(t/32) + (t%32)/4 (+8) and column pairs
//   8*j + 2*(t%4)) while the producer already loads the next tile.
//
// Ragged edges: TMA zero-fills reads past Q, N and D, so any Q, any N and
// any D % 8 == 0 run (the tensor maps need 16-byte row strides); the
// epilogues mask queries and rows past the edges out of their output.
// The tile geometry (stages, resident or streamed, shared bytes, grid) is
// chosen in Python (ops/distance.py::scan_geometry) and checked here.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace msd {

constexpr int BM = 128;  // queries per f32 block tile
constexpr int BN = 128;  // payload rows per f32 block tile (= one tilescan sub-tile)
constexpr int THREADS = 256;
constexpr int SLOTS = 16;  // threads sharing one query in an f32 tile
constexpr float NEG = -3.4e38f;  // the score of a masked row

enum Metric { L2 = 0, IP = 1, COSINE = 2 };

struct Tile {
    float acc[8][8];  // acc[i][j]: query qi(i), row ni(j)
    int q_base, n_base;
    int slot;
    // tile-local query of acc[i][*] and row of acc[*][j]
    __device__ __forceinline__ int qi(int i) const { return q_base + 16 * i; }
    __device__ __forceinline__ int ni(int j) const { return n_base + 16 * j; }
};

__host__ __device__ __forceinline__ float apply_metric(int metric, float s, float aux) {
    if (metric == L2) return 2.0f * s - aux;
    if (metric == COSINE) return s * aux;
    return s;
}

// ---------------------------------------------------------------- f32 FMA
constexpr int FK = 8;  // depth per stage

__device__ __forceinline__ void fma_tile(const float* __restrict__ q, const float* __restrict__ x,
                                         int Q, int N, int D, int q0, int n0, Tile& t) {
    __shared__ float As[FK][BM];
    __shared__ float Bs[FK][BN];
    const int tid = threadIdx.x;
    const int ty = tid / 16;
    const int tx = tid % 16;
    t.q_base = ty;
    t.n_base = tx;
    t.slot = tx;
    // loader: each thread brings 4 consecutive depth values of one row of
    // each operand (BM * FK / 4 == THREADS)
    const int lr = tid / (FK / 4);
    const int lc = (tid % (FK / 4)) * 4;
    const bool q_ok = q0 + lr < Q;
    const bool x_ok = n0 + lr < N;
    const float* qrow = q + (size_t)(q0 + lr) * D + lc;
    const float* xrow = x + (size_t)(n0 + lr) * D + lc;

#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) t.acc[i][j] = 0.0f;

    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 a = q_ok ? *reinterpret_cast<const float4*>(qrow) : zero;
    float4 b = x_ok ? *reinterpret_cast<const float4*>(xrow) : zero;
    for (int k0 = 0; k0 < D; k0 += FK) {
        __syncthreads();  // the previous stage is no longer read
        As[lc + 0][lr] = a.x; As[lc + 1][lr] = a.y; As[lc + 2][lr] = a.z; As[lc + 3][lr] = a.w;
        Bs[lc + 0][lr] = b.x; Bs[lc + 1][lr] = b.y; Bs[lc + 2][lr] = b.z; Bs[lc + 3][lr] = b.w;
        __syncthreads();
        if (k0 + FK < D) {  // prefetch the next stage while this one runs
            if (q_ok) a = *reinterpret_cast<const float4*>(qrow + k0 + FK);
            if (x_ok) b = *reinterpret_cast<const float4*>(xrow + k0 + FK);
        }
#pragma unroll
        for (int kk = 0; kk < FK; ++kk) {
            float ra[8], rb[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) ra[i] = As[kk][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 8; ++j) rb[j] = Bs[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) t.acc[i][j] = fmaf(ra[i], rb[j], t.acc[i][j]);
        }
    }
}

// --------------------------------------------- bf16: TMA ring + wgmma
namespace wg {

constexpr int BM = 128;  // queries per tile: one m64 wgmma per consumer warpgroup
constexpr int BN = 256;  // payload rows per tile: the n of m64n256k16
constexpr int BK = 64;   // depth per ring stage: 64 bf16 = one 128-byte swizzle row
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr uint32_t STAGE_X = BN * BK * 2;  // payload chunk, bf16, 128B-swizzled
constexpr uint32_t STAGE_Q = BM * BK * 4;  // f32 query chunk (streamed mode)
constexpr uint32_t STAGE_EPI = 2048;  // the tile's aux (BN f32) and mask (BN u8)
constexpr uint32_t EPI_AUX = BN * 4, EPI_MASK = BN;
constexpr uint32_t HALF_TILE = 64 * BK * 2;  // one warpgroup's hi or lo tile
constexpr int STG_STRIDE = 40;  // score staging row stride in floats (conflict-free)
constexpr uint32_t STAGING = 2 * 64 * STG_STRIDE * 4;
constexpr int RESIDENT_MAX_DK = 128;
constexpr int SMEM_LIMIT = 232448;
constexpr int SCORE = 0, TILE_MAX = 1;  // epilogues

// Byte offsets in the dynamic shared memory (after aligning its base to
// 1,024 bytes, which the 128B swizzle needs); ops/distance.py::
// scan_geometry computes the same total. A stage holds the payload chunk,
// then (streamed) the f32 query chunk, then the epilogue's aux and mask,
// which only a tile's last chunk loads.
struct Layout {
    int stages, resident, kc;
    uint32_t stage_bytes, epi_off, res_off, staging_off, bar_off, total;
    __host__ __device__ Layout(int stages_, int resident_, int d)
        : stages(stages_), resident(resident_), kc((d + BK - 1) / BK) {
        epi_off = STAGE_X + (resident ? 0u : STAGE_Q);
        stage_bytes = epi_off + STAGE_EPI;
        res_off = stages * stage_bytes;
        staging_off = res_off + (resident ? 2u * BM * kc * BK * 2 : 0u);
        bar_off = staging_off + STAGING;
        total = bar_off + 2u * stages * 8u + 1024u;
    }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
    asm volatile(
        "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
        : "memory");
}

// generic-proxy shared writes -> visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one consumer warpgroup's barrier (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_bar(int id) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// K-major operand in the canonical 128B-swizzled layout: rows of 128 bytes
// (64 bf16 of depth), 8-row groups 1,024 bytes apart (SBO), tile base
// aligned to 1,024. A 16-deep step inside the row is +32 bytes (+2 in
// the 16-byte address field).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
           (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] (+)= A[64 x 16] . B[256 x 16]^T, bf16 in, f32 accumulate
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 256] (+)= A[64 x 16] . B[256 x 16]^T with A from registers: a[0..3]
// hold rows 16w + lane/4 (a[0], a[2]) and +8 (a[1], a[3]) of warp w, at
// depth 2(lane%4) (a[0], a[1]) and +8 (a[2], a[3]), two bf16 each. The
// registers must not change until the wgmma has completed.
__device__ __forceinline__ void wgmma_256_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// 8 f32 query values -> their bf16 hi and lo halves (round to nearest
// even, as torch's f32 -> bf16 cast): hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split8(float4 a, float4 b, uint4& hi, uint4& lo) {
    const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const __nv_bfloat16 h0 = __float2bfloat16_rn(f[2 * e]);
        const __nv_bfloat16 h1 = __float2bfloat16_rn(f[2 * e + 1]);
        const __nv_bfloat16 l0 = __float2bfloat16_rn(f[2 * e] - __bfloat162float(h0));
        const __nv_bfloat16 l1 = __float2bfloat16_rn(f[2 * e + 1] - __bfloat162float(h1));
        h[e] = __bfloat16_as_ushort(h0) | (uint32_t(__bfloat16_as_ushort(h1)) << 16);
        l[e] = __bfloat16_as_ushort(l0) | (uint32_t(__bfloat16_as_ushort(l1)) << 16);
    }
    hi = make_uint4(h[0], h[1], h[2], h[3]);
    lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// 2 f32 query values -> their packed bf16 hi and lo halves
__device__ __forceinline__ void split2(float2 v, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat16 h0 = __float2bfloat16_rn(v.x), h1 = __float2bfloat16_rn(v.y);
    const __nv_bfloat16 l0 = __float2bfloat16_rn(v.x - __bfloat162float(h0));
    const __nv_bfloat16 l1 = __float2bfloat16_rn(v.y - __bfloat162float(h1));
    hi = __bfloat16_as_ushort(h0) | (uint32_t(__bfloat16_as_ushort(h1)) << 16);
    lo = __bfloat16_as_ushort(l0) | (uint32_t(__bfloat16_as_ushort(l1)) << 16);
}

// byte offset of the 16-byte chunk `ch` of row `row` in a 128B-swizzled tile
__device__ __forceinline__ uint32_t swizzled(int row, int ch) {
    return row * 128 + ((ch ^ (row & 7)) << 4);
}

template <int KIND>
__global__ void __launch_bounds__(THREADS, 1)
wgmma_scan_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap auxmap,
                  const __grid_constant__ CUtensorMap maskmap, const float* __restrict__ q,
                  float* __restrict__ out, int Q, int N, int D, int metric, int stages,
                  int resident) {
    extern __shared__ uint8_t smem_raw[];
    const Layout L(stages, resident, D);
    uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
    uint64_t* empty = full + stages;
    const int q_tiles = (Q + BM - 1) / BM;
    const int tiles = q_tiles * ((N + BN - 1) / BN);
    const int group = threadIdx.x / 128;
    const bool has_aux = metric != IP || KIND == TILE_MAX;  // tile_max's aux is never null

    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(&full[s], 1);   // the producer's arrive.expect_tx
            mbar_init(&empty[s], 8);  // one lane of each consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (group == 2) {
        // ---- producer: one thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (threadIdx.x == 2 * 128) {
            int s = 0;
            uint32_t ph = 0;
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int n0 = (t / q_tiles) * BN, q0 = (t % q_tiles) * BM;
                for (int kc = 0; kc < L.kc; ++kc) {
                    mbar_wait(&empty[s], ph ^ 1);
                    uint8_t* st = smem + s * L.stage_bytes;
                    const bool last = kc == L.kc - 1;
                    // boxes count whole, past the edges too
                    mbar_expect_tx(&full[s], L.epi_off + (last && has_aux ? EPI_AUX : 0) +
                                                 (last && KIND == TILE_MAX ? EPI_MASK : 0));
                    tma_load_2d(st, &xmap, &full[s], kc * BK, n0);
                    if (!resident) {  // two 32-deep f32 boxes, 128B-swizzled
                        tma_load_2d(st + STAGE_X, &qmap, &full[s], kc * BK, q0);
                        tma_load_2d(st + STAGE_X + STAGE_Q / 2, &qmap, &full[s], kc * BK + 32, q0);
                    }
                    if (last && has_aux) tma_load_1d(st + L.epi_off, &auxmap, &full[s], n0);
                    if (last && KIND == TILE_MAX)
                        tma_load_1d(st + L.epi_off + EPI_AUX, &maskmap, &full[s], n0);
                    if (++s == stages) { s = 0; ph ^= 1; }
                }
            }
        }
    } else {
        // ---- consumers: warpgroup `group` owns queries 64*group..+63 of each tile
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
        const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
        const int bar_id = 1 + group;
        const int row_a = warp * 16 + lane / 4;  // accumulator rows row_a and row_a + 8
        const int col_a = (lane % 4) * 2;        // and column pairs col_a + 8j (+1)

        // this warpgroup's resident 64 x 64 hi (half 0) or lo (half 1) tile
        // of depth chunk kc, chunk-major after the ring
        auto a_tile = [&](int kc, int half) -> uint32_t {
            return smem_u32(smem + L.res_off + ((kc * 2 + group) * 2 + half) * HALF_TILE);
        };
        // streamed: this thread's A fragments of the stage's f32 query chunk
        // (two 128B-swizzled [128 x 32] boxes), split into bf16 hi and lo
        // registers: frag[kk][e] holds row row_a + 8 (e & 1), depth
        // 16 kk + col_a + 8 (e >> 1) and the next one, as wgmma_256_rs takes it
        auto load_frags = [&](int s, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
            const uint8_t* qs = smem + s * L.stage_bytes + STAGE_X;
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int row = group * 64 + row_a + 8 * (e & 1);
                    const int c = 16 * kk + col_a + 8 * (e >> 1), cb = c % 32;
                    const float2 v = *reinterpret_cast<const float2*>(
                        qs + (c / 32) * (STAGE_Q / 2) + row * 128 + (((cb / 4) ^ (row & 7)) << 4) +
                        (cb % 4) * 4);
                    split2(v, hi[kk][e], lo[kk][e]);
                }
            }
        };
        auto active_for = [&](int t) { return (t % q_tiles) * BM + group * 64 < Q; };

        // resident (q_tiles == 1): split this warpgroup's 64 query rows once
        // into its swizzled hi/lo tiles, 8 values a thread at a time; rows
        // past Q and depth past D are zeros
        if (resident && group * 64 < Q) {
            for (int kc = 0; kc < L.kc; ++kc) {
                uint8_t* hi = smem + L.res_off + (kc * 2 + group) * 2 * HALF_TILE;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int g = tid + 128 * j, row = g / 8, ch = g % 8;
                    const int qr = group * 64 + row, k = kc * BK + ch * 8;
                    const bool ok = qr < Q && k < D;  // D % 8 == 0: 8 values are in or out
                    const float4* src = reinterpret_cast<const float4*>(q + (size_t)qr * D + k);
                    uint4 h, l;
                    split8(ok ? src[0] : make_float4(0.f, 0.f, 0.f, 0.f),
                           ok ? src[1] : make_float4(0.f, 0.f, 0.f, 0.f), h, l);
                    *reinterpret_cast<uint4*>(hi + swizzled(row, ch)) = h;
                    *reinterpret_cast<uint4*>(hi + HALF_TILE + swizzled(row, ch)) = l;
                }
            }
            fence_proxy_async();  // the tiles are read by wgmma
            warpgroup_bar(bar_id);
        }

        // Each step waits for its stage, (streamed) splits this thread's
        // fragments of its query chunk, and issues its wgmmas; the previous
        // step's stage goes back to the producer once those have run. The
        // register-A wgmmas are waited for at once: their fragment registers
        // must not change before. The last step of a tile drains the tensor
        // cores for the epilogue.
        float acc[128];
        int kc = 0, s = 0, held = -1;  // held: the stage the last wgmmas may still read
        uint32_t ph = 0;
        for (int t = blockIdx.x; t < tiles;) {
            const bool active = active_for(t);
            mbar_wait(&full[s], ph);
            if (active) {
                const uint64_t dx = sw128_desc(smem_u32(smem + s * L.stage_bytes));
                if (resident) {  // A from the resident hi/lo tiles in shared memory
                    const uint64_t dh = sw128_desc(a_tile(kc, 0));
                    const uint64_t dl = sw128_desc(a_tile(kc, 1));
                    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
                    fence_acc(acc);
#pragma unroll
                    for (int kk = 0; kk < BK / 16; ++kk) {
                        wgmma_256(acc, dh + 2 * kk, dx + 2 * kk, kc > 0 || kk > 0);
                        wgmma_256(acc, dl + 2 * kk, dx + 2 * kk, 1);
                    }
                    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
                    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
                } else {  // A from registers, split from the stage's f32 chunk
                    uint32_t hi[4][4], lo[4][4];
                    load_frags(s, hi, lo);
                    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
                    fence_acc(acc);
#pragma unroll
                    for (int kk = 0; kk < BK / 16; ++kk) {
                        wgmma_256_rs(acc, hi[kk], dx + 2 * kk, kc > 0 || kk > 0);
                        wgmma_256_rs(acc, lo[kk], dx + 2 * kk, 1);
                    }
                    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
                    // the fragments are read until the wgmmas complete
                    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
                    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            asm volatile("" : "+r"(hi[kk][e]), "+r"(lo[kk][e])::"memory");
                }
                fence_acc(acc);
            }
            if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
            held = s;
            if (++s == stages) { s = 0; ph ^= 1; }
            if (++kc < L.kc) continue;
            kc = 0;
            if (active) {
                asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
                fence_acc(acc);
                // ---- epilogue of tile t; the last stage brought its aux and mask
                const int qb = (t % q_tiles) * BM + group * 64;
                const int nb = (t / q_tiles) * BN;
                const uint8_t* epi = smem + held * L.stage_bytes + L.epi_off;
                const float* saux = reinterpret_cast<const float*>(epi);
                if constexpr (KIND == SCORE) {
                    if (metric != IP) {
#pragma unroll
                        for (int j = 0; j < BN / 8; ++j) {
                            const float2 a = *reinterpret_cast<const float2*>(saux + 8 * j + col_a);
                            acc[4 * j] = apply_metric(metric, acc[4 * j], a.x);
                            acc[4 * j + 1] = apply_metric(metric, acc[4 * j + 1], a.y);
                            acc[4 * j + 2] = apply_metric(metric, acc[4 * j + 2], a.x);
                            acc[4 * j + 3] = apply_metric(metric, acc[4 * j + 3], a.y);
                        }
                    }
                    // 32 columns at a time through shared memory, then rows of
                    // 16-byte stores (4-byte where N % 4 != 0: rows unaligned)
                    float* stg = reinterpret_cast<float*>(smem + L.staging_off) +
                                 group * 64 * STG_STRIDE;
                    const bool vec = (N % 4) == 0;
#pragma unroll
                    for (int c = 0; c < BN / 32; ++c) {
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            const int i = 16 * c + 4 * j;
                            *reinterpret_cast<float2*>(&stg[row_a * STG_STRIDE + 8 * j + col_a]) =
                                make_float2(acc[i], acc[i + 1]);
                            *reinterpret_cast<float2*>(
                                &stg[(row_a + 8) * STG_STRIDE + 8 * j + col_a]) =
                                make_float2(acc[i + 2], acc[i + 3]);
                        }
                        warpgroup_bar(bar_id);
#pragma unroll
                        for (int r = 0; r < 4; ++r) {
                            const int idx = tid + 128 * r, row = idx / 8, c4 = (idx % 8) * 4;
                            const int qq = qb + row, n = nb + 32 * c + c4;
                            if (qq < Q && n < N) {
                                const float4 v =
                                    *reinterpret_cast<const float4*>(&stg[row * STG_STRIDE + c4]);
                                float* o = out + (size_t)qq * N + n;
                                if (vec) {  // N % 4 == 0 and n % 4 == 0: all four in range
                                    *reinterpret_cast<float4*>(o) = v;
                                } else {
                                    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                                    for (int u = 0; u < 4; ++u)
                                        if (n + u < N) o[u] = e[u];
                                }
                            }
                        }
                        warpgroup_bar(bar_id);  // the staging rows are free again
                    }
                } else {
                    const uint8_t* smask = epi + EPI_AUX;
                    const int n_sub = N / 128;
#pragma unroll
                    for (int h = 0; h < BN / 128; ++h) {
                        const int sub = nb / 128 + h;
                        if (sub >= n_sub) continue;
                        float m0 = NEG, m1 = NEG;  // rows row_a and row_a + 8
#pragma unroll
                        for (int j = 0; j < 16; ++j) {
                            const int i = 64 * h + 4 * j, col = 128 * h + 8 * j + col_a;
                            const float2 a = *reinterpret_cast<const float2*>(saux + col);
                            const uint32_t keep = *reinterpret_cast<const uint16_t*>(smask + col);
                            const float v0 = apply_metric(metric, acc[i], a.x);
                            const float v1 = apply_metric(metric, acc[i + 1], a.y);
                            const float v2 = apply_metric(metric, acc[i + 2], a.x);
                            const float v3 = apply_metric(metric, acc[i + 3], a.y);
                            if (keep & 0xFFu) { m0 = fmaxf(m0, v0); m1 = fmaxf(m1, v2); }
                            if (keep & 0xFF00u) { m0 = fmaxf(m0, v1); m1 = fmaxf(m1, v3); }
                        }
                        // the 4 lanes of a quad hold the other columns of the same rows
                        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
                        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
                        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
                        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
                        if ((lane & 3) == 0) {
                            const int qq = qb + row_a;
                            if (qq < Q) out[(size_t)qq * n_sub + sub] = m0;
                            if (qq + 8 < Q) out[(size_t)(qq + 8) * n_sub + sub] = m1;
                        }
                    }
                }
            }
            if (lane == 0) mbar_arrive(&empty[held]);
            held = -1;
            t += gridDim.x;
        }
    }
}

// ---- host side: tensor maps (cuTensorMapEncodeTiled through the runtime's
// driver entry point, so the library needs no -lcuda) and the launch. The
// functions are static so that their cached state is private to each
// translation unit and to each loaded copy of the library.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
                cudaSuccess &&
            found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// a row-major [rows, cols] tensor cut into [box_rows, box_cols] boxes (a
// vector of `cols` values when rows == 0); reads past its edges fill with
// zeros
static bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
                     int cols, int rows, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
    const EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t elem_strides[2] = {1, 1};
    return fn(map, type, rows == 0 ? 1 : 2, const_cast<void*>(ptr), dims, strides, box,
              elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KIND>
static int launch(const void* q, const void* x, const void* aux, const void* mask, void* out,
                  int Q, int N, int D, int metric, int stages, int resident, int smem_bytes,
                  int grid, cudaStream_t stream) {
    const Layout L(stages, resident, D);
    const int q_tiles = (Q + BM - 1) / BM;
    if (stages < 2 || (resident && (q_tiles != 1 || L.kc * BK > RESIDENT_MAX_DK)) ||
        (int)L.total > smem_bytes || smem_bytes > SMEM_LIMIT || grid < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap xmap, qmap, auxmap, maskmap;
    memset(&qmap, 0, sizeof(qmap));
    memset(&auxmap, 0, sizeof(auxmap));
    memset(&maskmap, 0, sizeof(maskmap));
    const bool ok =
        make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, D, N, BK, BN,
                 CU_TENSOR_MAP_SWIZZLE_128B) &&
        (resident || make_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, q, D, Q, BK / 2, BM,
                              CU_TENSOR_MAP_SWIZZLE_128B)) &&
        (aux == nullptr || make_map(&auxmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, aux, N, 0, BN, 0,
                                    CU_TENSOR_MAP_SWIZZLE_NONE)) &&
        (mask == nullptr || make_map(&maskmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, mask, N, 0, BN, 0,
                                     CU_TENSOR_MAP_SWIZZLE_NONE));
    // the kernel reads aux unless it scores IP, and tile_max reads the mask
    if (!ok || (aux == nullptr && (metric != IP || KIND == TILE_MAX)) ||
        (mask == nullptr) != (KIND == SCORE))
        return static_cast<int>(cudaErrorInvalidValue);
    static bool sized = false;  // the >48 KiB dynamic shared memory opt-in, once
    if (!sized) {
        const cudaError_t e = cudaFuncSetAttribute(
            wgmma_scan_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
        if (e != cudaSuccess) return static_cast<int>(e);
        sized = true;
    }
    wgmma_scan_kernel<KIND><<<grid, THREADS, smem_bytes, stream>>>(
        xmap, qmap, auxmap, maskmap, static_cast<const float*>(q), static_cast<float*>(out), Q, N,
        D, metric, stages, resident);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
}  // namespace msd
