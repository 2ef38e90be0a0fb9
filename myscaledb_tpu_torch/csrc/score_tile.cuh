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
// * f32 payload (`storage_dtype="float32"`, the host tier's streamed scan,
//   a spilled table) -> `tf32_scan_kernel`, namespace tf below. It replaces
//   the `split=False` branch of the same two TPU kernels, a single f32
//   dot_general under exact_precision. No tensor-core format holds an f32
//   operand, but three TF32 products keep ~22 bits of it ("3xTF32"): each
//   f32 value v splits into hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v -
//   hi) (v - hi is exact in f32), and q.x ~= q_hi.x_hi + q_hi.x_lo +
//   q_lo.x_hi, all three into one f32 accumulator. Each product errs by at
//   most ~3 * 2^-22 of |q_i x_i| (ops/distance.py::F32_SUM_TOL holds the
//   kernel to 2^-18 of sum |q_i x_i|).
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

constexpr float NEG = -3.4e38f;  // the score of a masked row

enum Metric { L2 = 0, IP = 1, COSINE = 2 };

__host__ __device__ __forceinline__ float apply_metric(int metric, float s, float aux) {
    if (metric == L2) return 2.0f * s - aux;
    if (metric == COSINE) return s * aux;
    return s;
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

// The >48 KiB dynamic shared memory opt-in of `kernel`, once a device: the
// attribute belongs to the current device, so a process that launches on
// several cards sets it on each. `done` holds the caller's flags, one a
// device.
constexpr int MAX_DEVICES = 64;
template <typename Kernel>
static cudaError_t opt_in_smem(Kernel kernel, bool (&done)[MAX_DEVICES]) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!done[dev]) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
        if (e != cudaSuccess) return e;
        done[dev] = true;
    }
    return cudaSuccess;
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
    static bool sized[MAX_DEVICES] = {};
    const cudaError_t opt = opt_in_smem(wgmma_scan_kernel<KIND>, sized);
    if (opt != cudaSuccess) return static_cast<int>(opt);
    wgmma_scan_kernel<KIND><<<grid, THREADS, smem_bytes, stream>>>(
        xmap, qmap, auxmap, maskmap, static_cast<const float*>(q), static_cast<float*>(out), Q, N,
        D, metric, stages, resident);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ------------------------------------- f32: split-TF32 (3xTF32) wgmma
// What bounds the f32 engine on the H100, and what the design does:
//
// * Tensor-core rate. 3xTF32 triples the MMA work: at one host-tier
//   stream chunk (Q=104, N=131,072, D=1,024) 3 x 27.9 GFLOP, 0.169 ms at
//   the 495 TF/s TF32 peak, against 0.42 ms of f32 FMA at 67 TF/s (the
//   CUDA cores, which the engine this replaced ran on). `wgmma` m64nNk8
//   .tf32 is the instruction; TF32 takes K-major A and B only, which the
//   payload [N, D] and the query [Q, D] already are.
// * Payload bytes. The same chunk reads 537 MB of payload and writes 54.5
//   MB of scores, ~0.177 ms at 3.35 TB/s: the two bounds are close, so
//   TMA loads of the payload overlap the MMAs as in the bf16 engine (one
//   producer thread, a ring of 2-4 mbarrier stages, persistent blocks,
//   `setmaxnreg` 40 / 232).
// * The payload is the register-A operand: each consumer warpgroup takes
//   64 payload rows (a block tile is BN = 128 rows, one tilescan sub-tile)
//   and the query is B from shared memory (n = NT queries: 64, 104 or
//   128, several q-tiles of 128 above; 104 is a batch of 100 padded to 8,
//   the batch of bench.py and of the exact paths, which NT = 128 would pad
//   by 23%; 8-13% faster than 128 there on the H100, ab_f32_engine.py).
//   The accumulator is two-level (a chunk's wgmmas into a fresh tile,
//   then f32 adds into the tile's sum; see the consumer loop), which
//   takes 2 x NT / 2 registers a thread. Each thread loads its A
//   fragments from the 128B-swizzled f32 stage, splits them in registers
//   and issues its wgmmas: the huge operand is never written back to
//   shared memory as hi/lo tiles.
//   TF32 register-A fragments are 4 x b32 a thread: rows lane/4 and +8,
//   depth lane%4 and +4 of a k8 step. Loaded as they lie, they would be 16
//   scalar loads a 32-deep chunk; instead the depth of each 32-deep chunk
//   is permuted (logical depth 8i + 4h + t holds depth 16h + 4t + i), so
//   a thread's depths for all four k8 steps are two float4 a row. The
//   query, split into hi and lo once per call by `split_query_kernel`,
//   is written in the same permuted order; a dot product does not see the
//   order of its depth.
// * The query's L2 -> SM traffic. A 128-row tile needs the whole hi+lo
//   query: at the stream chunk 2 x 104 x 1,024 x 4 B = 0.85 MB per tile,
//   1,024 tiles, 0.87 GB against the payload's 0.54 GB. Two m64 tiles a
//   warpgroup would halve it but need twice the accumulator registers
//   (2 x NT with the two-level sum): the engine keeps one m64 tile and
//   rides the query's hi/lo chunk in the ring beside the payload chunk.
//   Where the
//   query fits (one q-tile, 2 x NT x D x 4 B <= 128 KiB: the SIFT shapes,
//   Q <= 128 and D <= 128), each persistent block loads it once and keeps
//   it resident; the ring then carries only payload, and the L2 -> SM
//   traffic is the payload's.
// * Epilogues. The accumulator holds [64 payload rows x NT queries].
//   score: the metric, then 32 queries at a time transposed through
//   shared memory into out[q][n] rows of 16-byte stores, masked at the
//   ragged Q and N edges. tile_max: the max over the tile's 128 rows, in
//   the thread (2 rows), across the 8 row groups of a warp (`shfl_xor` 4,
//   8, 16), then across the 8 warps of both warpgroups through shared
//   memory (one 256-thread barrier, two buffers by tile parity); masked
//   rows give -3.4e38 exactly.
//
// Ragged edges as in the bf16 engine: any Q, any N (N % 128 for
// tile_max), D % 8 == 0; the geometry comes from ops/distance.py::
// f32_scan_geometry and is checked here.
namespace tf {

using wg::fence_acc;
using wg::make_map;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::SCORE;
using wg::smem_u32;
using wg::sw128_desc;
using wg::swizzled;
using wg::TILE_MAX;
using wg::tma_load_1d;
using wg::tma_load_2d;
using wg::warpgroup_bar;

constexpr int BN = 128;  // payload rows per tile: one m64 per consumer warpgroup
constexpr int BK = 32;   // depth per ring stage: 32 f32 = one 128-byte swizzle row
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr uint32_t STAGE_X = BN * BK * 4;  // payload chunk, f32, 128B-swizzled
constexpr uint32_t STAGE_EPI = 1024;       // the tile's aux (BN f32) and mask (BN u8)
constexpr uint32_t EPI_AUX = BN * 4, EPI_MASK = BN;
constexpr int STG_Q = 32;        // queries a score staging round
constexpr int STG_STRIDE = 68;   // floats a staged query: 64 rows + 4 (conflict-free writes)
// score staging (both warpgroups) or the tile_max fold (two buffers of 8 warps x NT)
constexpr uint32_t SCRATCH = 2 * STG_Q * STG_STRIDE * 4;
constexpr uint32_t RESIDENT_MAX = 131072;  // the resident hi+lo query
constexpr int PART_CHUNKS = 4;  // depth chunks (128 deep) summed in one `part` accumulator
static_assert(2 * 8 * 128 * 4 <= SCRATCH, "the tile_max fold must fit the scratch");

// Byte offsets in the dynamic shared memory after aligning its base to
// 1,024; ops/distance.py::f32_scan_geometry computes the same total. A
// stage holds the payload chunk, then (unless resident) the query's hi
// and lo chunks, then the epilogue's aux and mask.
struct Layout {
    int nt, stages, resident, kc;
    uint32_t q_bytes, stage_bytes, epi_off, res_off, scratch_off, bar_off, total;
    __host__ __device__ Layout(int nt_, int stages_, int resident_, int d)
        : nt(nt_), stages(stages_), resident(resident_), kc((d + BK - 1) / BK) {
        q_bytes = nt * BK * 4;  // one hi or lo query chunk
        epi_off = STAGE_X + (resident ? 0u : 2u * q_bytes);
        stage_bytes = epi_off + STAGE_EPI;
        res_off = stages * stage_bytes;
        scratch_off = res_off + (resident ? 2u * kc * q_bytes : 0u);
        bar_off = scratch_off + SCRATCH;
        total = bar_off + (2u * stages + 1u) * 8u + 1024u;
    }
};

__device__ __forceinline__ uint32_t to_tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
    return r;
}

// the depth (within its 32-deep chunk) that logical depth l = 8i + 4h + t
// of the wgmmas holds: 16h + 4t + i
__host__ __device__ __forceinline__ int chunk_depth(int l) {
    return 16 * ((l >> 2) & 1) + 4 * (l & 3) + (l >> 3);
}

// The query's hi and lo halves, [2 * Qp, Dp] as b32: hi in rows [0, Qp),
// lo in rows [Qp, 2 Qp), each 32-deep chunk in the wgmmas' logical depth
// order; rows past Q and depth past D are zeros.
static __global__ void split_query_kernel(const float* __restrict__ q,
                                          uint32_t* __restrict__ out, int Q, int D, int Qp,
                                          int Dp) {
    const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (i >= (size_t)Qp * Dp) return;
    const int r = static_cast<int>(i / Dp), l = static_cast<int>(i % Dp);
    const int d = (l & ~31) + chunk_depth(l & 31);
    const float v = r < Q && d < D ? q[(size_t)r * D + d] : 0.0f;
    const uint32_t hi = to_tf32(v);
    out[(size_t)r * Dp + l] = hi;
    out[(size_t)(Qp + r) * Dp + l] = to_tf32(v - __uint_as_float(hi));
}

// d[64 x NT] (+)= A[64 x 8] . B[NT x 8]^T, TF32 in, f32 accumulate, A from
// registers: a[0] row lane/4, depth lane%4; a[1] row +8; a[2] depth +4;
// a[3] both (rows of warp w offset by 16w). The registers must not change
// until the wgmma has completed.
template <int NT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NT / 2], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                               int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<104>(float (&d)[52], const uint32_t (&a)[4], uint64_t db,
                                               int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %57, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51"
        "}, {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                               int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int KIND, int NT>
__global__ void __launch_bounds__(THREADS, 1)
tf32_scan_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap auxmap,
                 const __grid_constant__ CUtensorMap maskmap, float* __restrict__ out, int Q,
                 int N, int D, int metric, int stages, int resident) {
    extern __shared__ uint8_t smem_raw[];
    const Layout L(NT, stages, resident, D);
    uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
    uint64_t* empty = full + stages;
    uint64_t* qbar = empty + stages;  // the resident query
    const int q_tiles = (Q + NT - 1) / NT;
    const int qp = q_tiles * NT;  // the lo half's first row in the split query
    const int tiles = q_tiles * ((N + BN - 1) / BN);
    const int group = threadIdx.x / 128;
    const bool has_aux = metric != IP || KIND == TILE_MAX;  // tile_max's aux is never null

    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(&full[s], 1);   // the producer's arrive.expect_tx
            mbar_init(&empty[s], 8);  // one lane of each consumer warp
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (group == 2) {
        // ---- producer: one thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
        if (threadIdx.x == 2 * 128) {
            if (resident) {  // the whole hi+lo query once, chunk-major after the ring
                mbar_expect_tx(qbar, 2u * L.kc * L.q_bytes);
                for (int kc = 0; kc < L.kc; ++kc) {
                    uint8_t* dst = smem + L.res_off + 2u * kc * L.q_bytes;
                    tma_load_2d(dst, &qmap, qbar, kc * BK, 0);
                    tma_load_2d(dst + L.q_bytes, &qmap, qbar, kc * BK, qp);
                }
            }
            int s = 0;
            uint32_t ph = 0;
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int n0 = (t / q_tiles) * BN, q0 = (t % q_tiles) * NT;
                for (int kc = 0; kc < L.kc; ++kc) {
                    mbar_wait(&empty[s], ph ^ 1);
                    uint8_t* st = smem + s * L.stage_bytes;
                    const bool last = kc == L.kc - 1;
                    // boxes count whole, past the edges too
                    mbar_expect_tx(&full[s], L.epi_off + (last && has_aux ? EPI_AUX : 0) +
                                                 (last && KIND == TILE_MAX ? EPI_MASK : 0));
                    tma_load_2d(st, &xmap, &full[s], kc * BK, n0);
                    if (!resident) {
                        tma_load_2d(st + STAGE_X, &qmap, &full[s], kc * BK, q0);
                        tma_load_2d(st + STAGE_X + L.q_bytes, &qmap, &full[s], kc * BK, qp + q0);
                    }
                    if (last && has_aux) tma_load_1d(st + L.epi_off, &auxmap, &full[s], n0);
                    if (last && KIND == TILE_MAX)
                        tma_load_1d(st + L.epi_off + EPI_AUX, &maskmap, &full[s], n0);
                    if (++s == stages) { s = 0; ph ^= 1; }
                }
            }
        }
    } else {
        // ---- consumers: warpgroup `group` owns payload rows 64*group..+63 of each tile
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
        const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
        const int bar_id = 1 + group;
        const int g = warp * 16 + lane / 4;  // accumulator rows g and g + 8 of the warpgroup
        const int col = (lane % 4) * 2;      // and query pairs col + 8j (+1)
        const int row = group * 64 + g;      // tile row of a[0] / a[2] (a[1] / a[3]: row + 8)
        // This thread's two float4 of each of its rows in a 128B-swizzled
        // [128 x 32] payload chunk: the 16-byte pieces 4h + lane%4, h = 0, 1.
        // Lanes of odd row groups load h = 1 first, so that the eight lanes
        // of each load phase cover all 32 banks.
        const int hf = (lane / 4) & 1;
        const uint32_t first = swizzled(row, 4 * hf + lane % 4);
        const uint32_t second = swizzled(row, 4 * (hf ^ 1) + lane % 4);
        // row + 8 has the same swizzle phase (row & 7) as row
        auto load = [&](int s, float4 (&raw)[4]) {
            const uint8_t* xs = smem + s * L.stage_bytes;
            raw[0] = *reinterpret_cast<const float4*>(xs + first);
            raw[1] = *reinterpret_cast<const float4*>(xs + second);
            raw[2] = *reinterpret_cast<const float4*>(xs + first + 8 * 128);
            raw[3] = *reinterpret_cast<const float4*>(xs + second + 8 * 128);
        };
        // raw -> the TF32 hi and lo fragments of the chunk's four k8 steps:
        // step i takes component i of the float4 at depth 16h + 4(lane%4)
        auto split = [&](const float4 (&raw)[4], uint32_t (&xh)[4][4], uint32_t (&xl)[4][4]) {
            const float4 r0h0 = hf ? raw[1] : raw[0], r0h1 = hf ? raw[0] : raw[1];
            const float4 r1h0 = hf ? raw[3] : raw[2], r1h1 = hf ? raw[2] : raw[3];
            const float v[4][4] = {{r0h0.x, r1h0.x, r0h1.x, r1h1.x},
                                   {r0h0.y, r1h0.y, r0h1.y, r1h1.y},
                                   {r0h0.z, r1h0.z, r0h1.z, r1h1.z},
                                   {r0h0.w, r1h0.w, r0h1.w, r1h1.w}};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    xh[i][e] = to_tf32(v[i][e]);
                    xl[i][e] = to_tf32(v[i][e] - __uint_as_float(xh[i][e]));
                }
        };

        // Each step splits the fragments loaded from its stage and issues
        // its 12 wgmmas (per k8 step: x_hi.q_hi, x_hi.q_lo, x_lo.q_hi) into
        // `part`; while they run, it waits for the next stage and loads that
        // stage's raw fragments, then waits for its wgmmas (a register-A
        // wgmma's fragments must not change until it completes: the empty
        // asm after the wait keeps them live until then) and hands its stage
        // back. Every PART_CHUNKS steps (and at a tile's end) the thread adds
        // `part` to the tile's sum `acc` with f32 adds, and the next step
        // starts `part` afresh. A tile's last stage is held until its
        // epilogue has read the aux and mask. Why two levels: with all of a
        // tile's wgmmas (384 at D 1,024) adding into one accumulator, L2
        // scores of clustered data (bench.py's corpus shape: sums that only
        // grow) fell outside F32_SUM_TOL on the H100, worst err/bound
        // 1.54-1.61 at the stream chunk; parts of 4 chunks (48 wgmmas) give
        // 0.33-0.34 for 2.5-3.4% more time (parts of 1 chunk: 0.24, +11%;
        // ab_f32_engine.py). The tensor cores' accumulation error grows with
        // the wgmmas that add into an accumulator and with its magnitude.
        // It costs NT/2 registers, which is why NT stops at 128.
        float acc[NT / 2], part[NT / 2];
        uint32_t xh[4][4], xl[4][4];
        float4 raw[4];
        int s = 0, parity = 0;
        uint32_t ph = 0;
        if (resident) mbar_wait(qbar, 0);
        for (int t = blockIdx.x; t < tiles; t += gridDim.x, parity ^= 1) {
            const int n0 = (t / q_tiles) * BN, q0 = (t % q_tiles) * NT;
            const bool active = n0 + group * 64 < N;  // tile_max: always (N % 128 == 0)
            int held = s;
            mbar_wait(&full[s], ph);
            if (active) load(s, raw);
            for (int kc = 0; kc < L.kc; ++kc) {
                const int cur = s;
                if (active) {
                    split(raw, xh, xl);
                    const uint8_t* qh = resident ? smem + L.res_off + 2u * kc * L.q_bytes
                                                 : smem + cur * L.stage_bytes + STAGE_X;
                    const uint64_t dh = sw128_desc(smem_u32(qh));
                    const uint64_t dl = sw128_desc(smem_u32(qh + L.q_bytes));
                    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
                    fence_acc(part);
#pragma unroll
                    for (int i = 0; i < BK / 8; ++i) {  // +32 bytes a k8 step
                        wgmma_tf32<NT>(part, xh[i], dh + 2 * i, kc % PART_CHUNKS > 0 || i > 0);
                        wgmma_tf32<NT>(part, xh[i], dl + 2 * i, 1);
                        wgmma_tf32<NT>(part, xl[i], dh + 2 * i, 1);
                    }
                    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
                }
                if (++s == stages) { s = 0; ph ^= 1; }
                if (kc + 1 < L.kc) {
                    mbar_wait(&full[s], ph);
                    if (active) load(s, raw);
                }
                if (active) {
                    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
                    fence_acc(part);
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            asm volatile("" : "+r"(xh[i][e]), "+r"(xl[i][e])::"memory");
                    if (kc % PART_CHUNKS == PART_CHUNKS - 1 || kc + 1 == L.kc) {
#pragma unroll
                        for (int i = 0; i < NT / 2; ++i)
                            acc[i] = kc >= PART_CHUNKS ? acc[i] + part[i] : part[i];
                    }
                }
                if (kc + 1 < L.kc) {
                    if (lane == 0) mbar_arrive(&empty[cur]);
                } else {
                    held = cur;
                }
            }
            if (active) {
                // ---- epilogue of tile t; its last stage brought the aux and mask
                const uint8_t* epi = smem + held * L.stage_bytes + L.epi_off;
                const float* saux = reinterpret_cast<const float*>(epi);
                if constexpr (KIND == SCORE) {
                    if (metric != IP) {
                        const float a0 = saux[row], a1 = saux[row + 8];
#pragma unroll
                        for (int j = 0; j < NT / 8; ++j) {
                            acc[4 * j] = apply_metric(metric, acc[4 * j], a0);
                            acc[4 * j + 1] = apply_metric(metric, acc[4 * j + 1], a0);
                            acc[4 * j + 2] = apply_metric(metric, acc[4 * j + 2], a1);
                            acc[4 * j + 3] = apply_metric(metric, acc[4 * j + 3], a1);
                        }
                    }
                    // STG_Q queries at a time, transposed through shared
                    // memory, then rows of 16-byte stores (4-byte where
                    // N % 4 != 0: rows unaligned)
                    float* stg = reinterpret_cast<float*>(smem + L.scratch_off) +
                                 group * STG_Q * STG_STRIDE;
                    const bool vec = (N % 4) == 0;
#pragma unroll
                    for (int c = 0; c < (NT + STG_Q - 1) / STG_Q; ++c) {
#pragma unroll
                        for (int jj = 0; jj < STG_Q / 8; ++jj) {
                            if (STG_Q / 8 * c + jj >= NT / 8) continue;  // NT % 32 != 0
                            const int i = 4 * (c * STG_Q / 8 + jj), qc = 8 * jj + col;
                            stg[qc * STG_STRIDE + g] = acc[i];
                            stg[(qc + 1) * STG_STRIDE + g] = acc[i + 1];
                            stg[qc * STG_STRIDE + g + 8] = acc[i + 2];
                            stg[(qc + 1) * STG_STRIDE + g + 8] = acc[i + 3];
                        }
                        warpgroup_bar(bar_id);
#pragma unroll
                        for (int r = 0; r < STG_Q * 64 / 4 / 128; ++r) {
                            const int idx = tid + 128 * r, ql = idx / 16, n4 = (idx % 16) * 4;
                            const int qq = q0 + STG_Q * c + ql, n = n0 + group * 64 + n4;
                            if (STG_Q * c + ql < NT && qq < Q && n < N) {
                                const float4 v =
                                    *reinterpret_cast<const float4*>(&stg[ql * STG_STRIDE + n4]);
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
                    const float a0 = saux[row], a1 = saux[row + 8];
                    const bool k0 = smask[row] != 0, k1 = smask[row + 8] != 0;
                    // two buffers by tile parity: a warpgroup writes this one
                    // again only after both have passed the next tile's barrier
                    float* red = reinterpret_cast<float*>(smem + L.scratch_off) + parity * 8 * NT;
#pragma unroll
                    for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            float m = NEG;
                            if (k0) m = fmaxf(m, apply_metric(metric, acc[4 * j + e], a0));
                            if (k1) m = fmaxf(m, apply_metric(metric, acc[4 * j + 2 + e], a1));
                            // the 8 row groups of the warp hold the other rows
                            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
                            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
                            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
                            if (lane < 4) red[(group * 4 + warp) * NT + 8 * j + col + e] = m;
                        }
                    }
                    asm volatile("bar.sync 3, 256;\n" ::: "memory");  // both consumer warpgroups
                    const int c = threadIdx.x;  // 0..255: one query each
                    if (c < NT && q0 + c < Q) {
                        float m = red[c];
#pragma unroll
                        for (int w = 1; w < 8; ++w) m = fmaxf(m, red[w * NT + c]);
                        out[(size_t)(q0 + c) * (N / BN) + n0 / BN] = m;
                    }
                }
            }
            if (lane == 0) mbar_arrive(&empty[held]);
        }
    }
}

// ---- host side: split the query, then launch the engine at width NT
template <int KIND, int NT>
static int launch_nt(const void* q, void* qsplit, const void* x, const void* aux,
                     const void* mask, void* out, int Q, int N, int D, int metric, int stages,
                     int resident, int smem_bytes, int grid, cudaStream_t stream) {
    const Layout L(NT, stages, resident, D);
    const int q_tiles = (Q + NT - 1) / NT, qp = q_tiles * NT, dp = L.kc * BK;
    if (stages < 2 || (resident && (q_tiles != 1 || 2u * L.kc * L.q_bytes > RESIDENT_MAX)) ||
        (int)L.total > smem_bytes || smem_bytes > wg::SMEM_LIMIT || grid < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap xmap, qmap, auxmap, maskmap;
    memset(&auxmap, 0, sizeof(auxmap));
    memset(&maskmap, 0, sizeof(maskmap));
    const bool ok =
        make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, D, N, BK, BN,
                 CU_TENSOR_MAP_SWIZZLE_128B) &&
        make_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, qsplit, dp, 2 * qp, BK, NT,
                 CU_TENSOR_MAP_SWIZZLE_128B) &&
        (aux == nullptr || make_map(&auxmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, aux, N, 0, BN, 0,
                                    CU_TENSOR_MAP_SWIZZLE_NONE)) &&
        (mask == nullptr || make_map(&maskmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, mask, N, 0, BN, 0,
                                     CU_TENSOR_MAP_SWIZZLE_NONE));
    // the kernel reads aux unless it scores IP, and tile_max reads the mask
    if (!ok || (aux == nullptr && (metric != IP || KIND == TILE_MAX)) ||
        (mask == nullptr) != (KIND == SCORE))
        return static_cast<int>(cudaErrorInvalidValue);
    static bool sized[wg::MAX_DEVICES] = {};
    const cudaError_t opt = wg::opt_in_smem(tf32_scan_kernel<KIND, NT>, sized);
    if (opt != cudaSuccess) return static_cast<int>(opt);
    const size_t n_split = (size_t)qp * dp;
    split_query_kernel<<<static_cast<unsigned>((n_split + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(q), static_cast<uint32_t*>(qsplit), Q, D, qp, dp);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    tf32_scan_kernel<KIND, NT><<<grid, THREADS, smem_bytes, stream>>>(
        xmap, qmap, auxmap, maskmap, static_cast<float*>(out), Q, N, D, metric, stages,
        resident);
    return static_cast<int>(cudaGetLastError());
}

// nt: the query tile width (the wgmmas' n), one of 64, 104, 128
template <int KIND>
static int launch(const void* q, void* qsplit, const void* x, const void* aux, const void* mask,
                  void* out, int Q, int N, int D, int metric, int nt, int stages, int resident,
                  int smem_bytes, int grid, cudaStream_t stream) {
    switch (nt) {
        case 64:
            return launch_nt<KIND, 64>(q, qsplit, x, aux, mask, out, Q, N, D, metric, stages,
                                       resident, smem_bytes, grid, stream);
        case 104:
            return launch_nt<KIND, 104>(q, qsplit, x, aux, mask, out, Q, N, D, metric, stages,
                                        resident, smem_bytes, grid, stream);
        case 128:
            return launch_nt<KIND, 128>(q, qsplit, x, aux, mask, out, Q, N, D, metric, stages,
                                        resident, smem_bytes, grid, stream);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace tf
}  // namespace msd
