// The bf16 tiers' Gram tile of K1 (gram_matvec.cu) and K3 (pair_contrib.cu),
// designed for Hopper: operands by TMA, the product by wgmma, one persistent
// CTA per SM whose two consumer warpgroups take alternate tile pairs, so one
// tile's transform and GEMVs run while the other's products do.  K2's bf16
// tiers and every exact tier keep the tiles of gram_tile.cuh.
//
// What it computes is what gram_tile_bf16<NPROD> computes: G = A B^T for one
// 128 x 128 tile pair from bf16 operands (bf16cast: one product; bf16x3: per
// 16 features hi hi^T, then hi lo^T, then lo hi^T into one f32 accumulator),
// the f32 kernel transform, K v_b for the tile's rows into the pair's row
// slot of the slab and K^T v_a for its columns into the column slot.  Every
// slot is written by exactly one warpgroup and every sum runs in a fixed
// order, so the result is bitwise repeatable whatever CTA runs a pair.
//
// Layout of one CTA (384 threads, 1 per SM, grid = min(tile pairs, SMs)):
//
//   warpgroup 2, one thread   producer: walks the CTA's tile pairs
//                             t = blockIdx.x, + gridDim.x, ... and, per 64
//                             features, fills one stage of the ring with the
//                             128 x 64 boxes of A hi, B hi (, A lo, B lo) by
//                             TMA (cp.async.bulk.tensor.2d, 128-byte swizzle,
//                             rows and features out of range read as 0),
//                             completion on the stage's `full` mbarrier of
//                             the warpgroup that owns the pair.
//   warpgroups 0 and 1        consumers: warpgroup c takes the CTA's pairs
//                             number c, c + 2, ...: waits for each stage,
//                             issues wgmma.mma_async m64n128k16 (two per 16
//                             features and product: rows 0-63 and 64-127),
//                             keeps one group in flight, releases the stage
//                             on its `empty` mbarrier, then runs the epilogue
//                             on the accumulator in wgmma's own register
//                             layout.  setmaxnreg moves registers from the
//                             producer's warpgroup (40) to the consumers
//                             (232): a full 128 x 128 f32 tile is 128
//                             registers a thread.
//
// A stage is 32 KB at bf16cast (6 stages) and 64 KB at bf16x3 (3 stages).
// The ring is shared, but each consumer has its own `full` barrier per
// stage: an mbarrier wait tells phases apart by one parity bit, so a waiter
// must see every phase of its barrier, and a consumer that skipped the other
// warpgroup's uses of a stage would take a phase for the one before.  The
// `empty` barriers are waited on by the producer alone, use after use.
// Both operand tiles are row-major (rows x features), which is wgmma's
// K-major layout for A and B alike: no transpose anywhere.  The tensor maps
// are built on the host per call (K3's panels are transient) through
// cuTensorMapEncodeTiled, looked up in libcuda by cudaGetDriverEntryPoint,
// so the library links no libcuda.  TMA needs 16-byte aligned bases and row
// strides: f % 8 == 0 (the wrapper pads the feature axis to 64 with zeros).
//
// Epilogue, per warpgroup, thread (warp w, lane l) holding rows
// 64 h + 16 w + l / 4 (+ 8) and columns 8 j + 2 (l % 4) (+ 1), j = 0..15:
// row sums over the thread's 32 columns in j order, then over the 4 lanes of
// a row (xor 1, 2); column sums over the thread's 4 rows, then over the 8
// lanes of a column by recursive halving (xor 16, 8, 4: 28 shuffles for the
// thread's 32 columns), then over the 4 warps through shared memory in warp
// order.  All 128 entries of a thread are transformed before the first
// shuffle, with no branch among them, so the compiler can overlap their
// latencies: one warp per scheduler runs an epilogue while the other
// warpgroup waits on its products, and nothing else hides them.  The column
// side's norms and v are staged in shared memory once per tile.  rbf is
// evaluated as 2^(2 gamma' g - gamma' |x_i|^2 - gamma' |x_j|^2), gamma' =
// gamma log2(e), with the norms pre-scaled once per tile and ex2.approx.ftz:
// four operations per entry.  The bf16 tiers are held to 1e-4 of the plain
// version's scale, which leaves room for its 2 ulp.
//
// Nothing that ptxas treats as a function call (printf, a division it does
// not inline) may run between a tile's first wgmma and its wait: it would
// serialise every wgmma of the kernel (note C7510 in the build log).

#pragma once

#include <cuda.h>

#include "gram_tile.cuh"

namespace {

constexpr int WG_THREADS = 128;
constexpr int WGMMA_THREADS = 3 * WG_THREADS;  // consumers 0, 1 and the producer's warpgroup
constexpr int KCHUNK = 64;                     // features per stage: 128 bytes, the swizzle span
constexpr int TILE_BYTES = BM * KCHUNK * 2;    // one 128 x 64 bf16 box
constexpr int PAIR_GROUP = 8;                  // K3: row blocks per raster group

template <int NPROD>
__host__ __device__ constexpr int wgmma_stages() {
    return NPROD == 3 ? 3 : 6;
}

// 1 KB of slack to align the ring to the swizzle's 1024 bytes, the ring,
// the column-side sums [2][4][BM], the column-side sq and v [2][2][BM], and
// the mbarriers: full [2][STAGES] (per consumer), empty [STAGES].
template <int NPROD>
__host__ __device__ constexpr size_t wgmma_smem_bytes() {
    return 1024 + (size_t)wgmma_stages<NPROD>() * (NPROD == 3 ? 4 : 2) * TILE_BYTES +
           (2 * 4 * BM + 2 * 2 * BM) * sizeof(float) + 3 * wgmma_stages<NPROD>() * 8;
}

struct TileArgs {
    const float* sqa;   // row norms of the A side (na,)
    const float* sqb;   // of the B side (nb,)
    const float* va;    // v of the A side, contracted on the column side
    const float* vb;    // v of the B side, contracted on the row side
    float* slab_row;    // K1: the one slab; K3: slab_i
    float* slab_col;    // K3: slab_j (K1: unused)
    int na, nb;         // rows of each side
    int nbi, nbj;       // 128-row blocks of each side
    int nchunks;        // ceil(f / 64)
    long long tiles;    // tile pairs: K1 nbi (nbi + 1) / 2, K3 nbi nbj
    KernelParams p;
};

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    return done != 0;
}

// Spin until the barrier's phase differs from `parity`.  A wait that lasts
// WATCHDOG_CYCLES (seconds; a stage turns over in microseconds) is a fault
// of the pipeline: it traps, so the launch ends in a CUDA error that the
// wrapper raises on, instead of hanging the card.  It prints nothing: a
// printf is a function call, and ptxas serialises every wgmma of a kernel
// whose products are in flight across one (its note C7510).
constexpr long long WATCHDOG_CYCLES = 1ll << 33;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    if (mbar_try_wait(bar, parity)) return;
    const long long start = clock64();
    while (!mbar_try_wait(bar, parity)) {
        if (clock64() - start > WATCHDOG_CYCLES) __trap();
    }
}

// One 128 x 64 box at (feature c0, row c1) into shared memory at dst.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products' fence and wait.
__device__ __forceinline__ void fence_accumulator(float (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major bf16 tile with 128-byte rows
// under the 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), the
// leading offset unused (1), layout type 1 (B128) in bits 62-63.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x 128 f32) = a (64 x 16 bf16) b^T (128 x 16 bf16) + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// Barrier over the 128 threads of consumer warpgroup wg (ids 1 and 2; 0 is
// __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int wg) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(wg + 1), "n"(WG_THREADS) : "memory");
}

// ------------------------------------------------------------ tile walk

// Tile pair t -> (i, j).  K1: the lower triangle in row-major order
// (tri_pair).  K3: groups of PAIR_GROUP row blocks, column-major inside a
// group, so the tiles that run at one time share A and B boxes in the L2.
template <bool SYM>
__device__ __forceinline__ void tile_coords(const TileArgs& a, long long t, int& i, int& j) {
    if (SYM) {
        tri_pair(t, i, j);
    } else {
        const long long per_group = (long long)PAIR_GROUP * a.nbj;
        const int g = (int)(t / per_group);
        const int r = (int)(t % per_group);
        const int rows = min(PAIR_GROUP, a.nbi - g * PAIR_GROUP);
        i = g * PAIR_GROUP + r % rows;
        j = r / rows;
    }
}

// The transform variants of the epilogue, chosen once per tile so that no
// entry pays for a branch: the kernel kinds of gram_tile.cuh and the two
// polynomial degrees that need no loop.
enum EpilogueKind { EPI_LINEAR = 0, EPI_POLY = 1, EPI_RBF = 2, EPI_POLY2 = 3, EPI_POLY3 = 4 };

__host__ __device__ inline int epilogue_kind(const KernelParams& p) {
    if (p.kernel == POLYNOMIAL) return p.degree == 2 ? EPI_POLY2 : p.degree == 3 ? EPI_POLY3 : EPI_POLY;
    return p.kernel == RBF ? EPI_RBF : EPI_LINEAR;
}

// 2^x by the special function unit alone (ex2.approx.ftz: 2 ulp, denormal
// results flushed to zero), without __expf's scaling of small results.
__device__ __forceinline__ float exp2_fast(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

constexpr float LOG2E = 1.4426950408889634f;

// What the rbf epilogue takes in place of a norm |x|^2: -gamma log2(e) |x|^2,
// so that K = 2^min(2 gamma log2(e) g + (s_i + s_j), 0) costs an add, an FMA,
// a min and the special function per entry.  Other kernels: the norm itself
// (unused).
__device__ __forceinline__ float epilogue_norm(const KernelParams& p, float sq) {
    return p.kernel == RBF ? -p.gamma * LOG2E * sq : sq;
}

// The bf16 tiers' kernel transform; `c` is 2 gamma log2(e) for rbf, si and sj
// are epilogue_norm's.  Unlike gram_tile.cuh's `transform` it contracts into
// FMAs and takes the fast exponential: a few ulp, inside the tiers' 1e-4
// tolerance against their plain versions.  Degree 3 multiplies in
// integer_pow's order, x (x x).
template <int KIND>
__device__ __forceinline__ float transform_fast(const KernelParams& p, float c, float g, float si,
                                                float sj) {
    if (KIND == EPI_RBF) return exp2_fast(fminf(fmaf(c, g, si + sj), 0.0f));
    if (KIND == EPI_LINEAR) return g;
    const float b = fmaf(p.gamma, g, p.coef0);
    if (KIND == EPI_POLY2) return b * b;
    if (KIND == EPI_POLY3) return b * (b * b);
    return integer_pow(b, p.degree);
}

// Sum cs[e] over the 8 lanes that share (lane & 3), by recursive halving: a
// lane hands over the half of its values that its partner (lane ^ 16, then
// ^ 8, then ^ 4) keeps and adds what it receives to the half it keeps, so 32
// values take 16 + 8 + 4 shuffles instead of 3 x 32.  Lane l ends with the
// full sums of entries 4 (l / 4) + 0..3 in cs[0..3].  The tree is fixed.
template <int HALF>
__device__ __forceinline__ void halving_step(float (&cs)[32], int lane) {
    const bool upper = (lane & HALF) != 0;  // keeps entries HALF .. 2 HALF - 1
#pragma unroll
    for (int e = 0; e < HALF; ++e) {
        const float keep = upper ? cs[e + HALF] : cs[e];
        const float send = upper ? cs[e] : cs[e + HALF];
        cs[e] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
    }
}

__device__ __forceinline__ void halving_sum32(float (&cs)[32], int lane) {
    halving_step<16>(cs, lane);
    halving_step<8>(cs, lane);
    halving_step<4>(cs, lane);
}

// Transform, mask (GENERAL: rows >= rows_left and columns >= cols_left get
// K := 0, and the column side may be absent) and contract one accumulator.
// Writes the row sums to row_out[0..BM) and, when col_out != nullptr, the
// column sums to col_out[0..BM).  sqc, vc: the column side in shared memory
// (0 beyond cols_left); sqr, vr: the thread's 4 rows (vr = 0 without a column
// side); the norms are epilogue_norm's.  !GENERAL: a full tile with a column
// side.  Every thread of the warpgroup runs every shuffle and barrier.
template <bool GENERAL, int KIND>
__device__ __forceinline__ void wgmma_epilogue(
    const float (&acc0)[64], const float (&acc1)[64], const KernelParams& p,
    const float (&sqr)[4], const float (&vr)[4], int rows_left, int cols_left,
    const float* __restrict__ sqc, const float* __restrict__ vc, float* __restrict__ red,
    float* __restrict__ row_out, float* __restrict__ col_out, int wg, int tid) {
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int r0 = 16 * warp + (lane >> 2);  // row of slot q: r0 + 64 (q / 2) + 8 (q % 2)
    const int c0 = 2 * (lane & 3);           // column of (j, e): c0 + 8 j + e
    const float c2g = 2.0f * LOG2E * p.gamma;
    bool okr[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) okr[q] = r0 + 64 * (q >> 1) + 8 * (q & 1) < rows_left;

    float rs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float cs[32];  // the thread's part of column c0 + 8 j + e at [2 j + e]
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const int c = c0 + 8 * j;
        const float2 sq2 = *reinterpret_cast<const float2*>(sqc + c);
        const float2 v2 = *reinterpret_cast<const float2*>(vc + c);
        const bool okc0 = c < cols_left;
        const bool okc1 = c + 1 < cols_left;
        float cs0 = 0.0f, cs1 = 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float g0 = (q < 2) ? acc0[4 * j + 2 * (q & 1)] : acc1[4 * j + 2 * (q & 1)];
            const float g1 = (q < 2) ? acc0[4 * j + 2 * (q & 1) + 1] : acc1[4 * j + 2 * (q & 1) + 1];
            float k0 = transform_fast<KIND>(p, c2g, g0, sqr[q], sq2.x);
            float k1 = transform_fast<KIND>(p, c2g, g1, sqr[q], sq2.y);
            if (GENERAL) {
                k0 = (okr[q] && okc0) ? k0 : 0.0f;
                k1 = (okr[q] && okc1) ? k1 : 0.0f;
            }
            rs[q] = fmaf(k0, v2.x, rs[q]);
            rs[q] = fmaf(k1, v2.y, rs[q]);
            cs0 = fmaf(k0, vr[q], cs0);
            cs1 = fmaf(k1, vr[q], cs1);
        }
        cs[2 * j] = cs0;
        cs[2 * j + 1] = cs1;
    }

    // column side: the 8 lanes sharing a column, then (below) the 4 warps
    halving_sum32(cs, lane);
    {
        float* dst = red + warp * BM + c0 + 16 * (lane >> 2);
        *reinterpret_cast<float2*>(dst) = make_float2(cs[0], cs[1]);
        *reinterpret_cast<float2*>(dst + 8) = make_float2(cs[2], cs[3]);
    }

    // row side: the 4 lanes sharing a row
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        rs[q] += __shfl_xor_sync(0xffffffffu, rs[q], 1);
        rs[q] += __shfl_xor_sync(0xffffffffu, rs[q], 2);
    }
    if ((lane & 3) == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) row_out[r0 + 64 * (q >> 1) + 8 * (q & 1)] = rs[q];
    }

    // column side: the 4 warps, in warp order.  The barrier also ends every
    // read of sqc and vc before the warpgroup's next tile overwrites them.
    warpgroup_sync(wg);
    if (!GENERAL || col_out != nullptr) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < 4; ++w) s += red[w * BM + tid];
        col_out[tid] = s;
    }
}

// ---------------------------------------------------------------- kernel

// SYM: K1 (A = B = X, lower-triangular pairs, one slab); else K3 (every pair
// of Xi x Xj, two slabs).  The *_lo maps are read only when NPROD == 3.
template <int NPROD, bool SYM>
__global__ void __launch_bounds__(WGMMA_THREADS, 1)
gram_wgmma_kernel(const __grid_constant__ CUtensorMap map_a_hi,
                  const __grid_constant__ CUtensorMap map_a_lo,
                  const __grid_constant__ CUtensorMap map_b_hi,
                  const __grid_constant__ CUtensorMap map_b_lo, const TileArgs a) {
    constexpr int NT = NPROD == 3 ? 4 : 2;  // boxes per stage: A hi, B hi (, A lo, B lo)
    constexpr int STAGES = wgmma_stages<NPROD>();
    constexpr uint32_t STAGE_BYTES = NT * TILE_BYTES;

    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle needs 1024-byte aligned boxes
    float* red_all = reinterpret_cast<float*>(smem_raw + (ring - raw) + STAGES * STAGE_BYTES);
    float* colv_all = red_all + 2 * 4 * BM;
    const uint32_t full_all = smem_u32(colv_all + 2 * 2 * BM);  // [2][STAGES]
    const uint32_t empty = full_all + 2 * 8 * STAGES;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            // full: the producer's arrive with its byte count
            mbar_init(full_all + 8 * s, 1);
            mbar_init(full_all + 8 * (STAGES + s), 1);
            mbar_init(empty + 8 * s, 4);  // one arrive per warp of the consuming warpgroup
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / WG_THREADS;
    if (wg == 2) {
        // ------------------------------------------------------ producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 2 * WG_THREADS) {
            uint32_t it = 0;
            int n = 0;
            for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x, ++n) {
                int i, j;
                tile_coords<SYM>(a, t, i, j);
                for (int kc = 0; kc < a.nchunks; ++kc, ++it) {
                    const uint32_t s = it % STAGES;
                    const uint32_t full = full_all + 8 * ((n & 1) * STAGES + s);  // the owner's
                    mbar_wait(empty + 8 * s, ((it / STAGES) & 1u) ^ 1u);
                    mbar_expect_tx(full, STAGE_BYTES);
                    const uint32_t dst = ring + s * STAGE_BYTES;
                    tma_load_2d(dst, &map_a_hi, full, kc * KCHUNK, i * BM);
                    tma_load_2d(dst + TILE_BYTES, &map_b_hi, full, kc * KCHUNK, j * BM);
                    if (NPROD == 3) {
                        tma_load_2d(dst + 2 * TILE_BYTES, &map_a_lo, full, kc * KCHUNK, i * BM);
                        tma_load_2d(dst + 3 * TILE_BYTES, &map_b_lo, full, kc * KCHUNK, j * BM);
                    }
                }
            }
        }
    } else {
        // ----------------------------------------------------- consumers
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int tid = threadIdx.x % WG_THREADS;
        const int warp = tid >> 5;
        const int lane = tid & 31;
        float* red = red_all + wg * 4 * BM;
        float* sqc = colv_all + wg * 2 * BM;
        float* vc = sqc + BM;
        const uint32_t full = full_all + 8 * wg * STAGES;
        uint32_t full_parity = 0;  // bit s: the parity of this warpgroup's next use of stage s

        float acc0[64] = {}, acc1[64] = {};  // rows 0-63 and 64-127 of the tile
        uint32_t it = 0;
        int n = 0;
        for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x, ++n) {
            if ((n & 1) != wg) {  // the other warpgroup's pair: skip its stages
                it += a.nchunks;
                continue;
            }
            int i, j;
            tile_coords<SYM>(a, t, i, j);
            const int ri0 = i * BM, rj0 = j * BM;
            float* row_out;
            float* col_out;
            if (SYM) {
                row_out = a.slab_row + ((size_t)i * a.nbi + j) * BM;
                col_out = (i != j) ? a.slab_row + ((size_t)j * a.nbi + i) * BM : nullptr;
            } else {
                row_out = a.slab_row + ((size_t)i * a.nbj + j) * BM;
                col_out = a.slab_col + ((size_t)j * a.nbi + i) * BM;
            }

            // the column side's sq and v into shared memory, the thread's
            // four rows into registers, while the first stages arrive
            {
                const int c = rj0 + tid;
                sqc[tid] = c < a.nb ? epilogue_norm(a.p, a.sqb[c]) : 0.0f;
                vc[tid] = c < a.nb ? a.vb[c] : 0.0f;
            }
            float sqr[4], vr[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = ri0 + 16 * warp + (lane >> 2) + 64 * (q >> 1) + 8 * (q & 1);
                sqr[q] = r < a.na ? epilogue_norm(a.p, a.sqa[r]) : 0.0f;
                vr[q] = (r < a.na && col_out != nullptr) ? a.va[r] : 0.0f;
            }
            warpgroup_sync(wg);  // also: the previous tile's reads of red, sqc, vc are over

            if (a.nchunks == 0) {
#pragma unroll
                for (int e = 0; e < 64; ++e) acc0[e] = acc1[e] = 0.0f;
            }
            fence_accumulator(acc0);
            fence_accumulator(acc1);
            for (int kc = 0; kc < a.nchunks; ++kc, ++it) {
                const uint32_t s = it % STAGES;
                mbar_wait(full + 8 * s, (full_parity >> s) & 1u);
                full_parity ^= 1u << s;
                const uint32_t box = ring + s * STAGE_BYTES;
                const uint64_t a_hi = wgmma_desc(box);
                const uint64_t b_hi = wgmma_desc(box + TILE_BYTES);
                const uint64_t a_lo = wgmma_desc(box + 2 * TILE_BYTES);
                const uint64_t b_lo = wgmma_desc(box + 3 * TILE_BYTES);
                wgmma_fence();
#pragma unroll
                for (int k = 0; k < KCHUNK / 16; ++k) {
                    // 16 features are 32 bytes: 2 in the descriptor's 16-byte
                    // units; rows 64-127 start 64 * 128 bytes on: 512 units
                    const uint64_t ko = 2 * k;
                    const int keep = (kc | k) != 0;  // the tile's first product overwrites
                    wgmma_m64n128k16(acc0, a_hi + ko, b_hi + ko, keep);
                    wgmma_m64n128k16(acc1, a_hi + ko + 512, b_hi + ko, keep);
                    if (NPROD == 3) {
                        wgmma_m64n128k16(acc0, a_hi + ko, b_lo + ko, 1);
                        wgmma_m64n128k16(acc1, a_hi + ko + 512, b_lo + ko, 1);
                        wgmma_m64n128k16(acc0, a_lo + ko, b_hi + ko, 1);
                        wgmma_m64n128k16(acc1, a_lo + ko + 512, b_hi + ko, 1);
                    }
                }
                wgmma_commit();
                if (kc > 0) {
                    // the previous stage's products are done: hand it back
                    wgmma_wait<1>();
                    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
                }
            }
            wgmma_wait<0>();
            if (a.nchunks > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
            fence_accumulator(acc0);
            fence_accumulator(acc1);

            const int rows_left = a.na - ri0, cols_left = a.nb - rj0;
#define GRAM_EPILOGUE(GENERAL, KIND)                                                          \
    wgmma_epilogue<GENERAL, KIND>(acc0, acc1, a.p, sqr, vr, rows_left, cols_left, sqc, vc, red, \
                                  row_out, col_out, wg, tid)
            // ragged tiles and K1's diagonal ones are few: they take the
            // general epilogue in the kinds' general forms
            if (rows_left < BM || cols_left < BM || col_out == nullptr) {
                if (a.p.kernel == RBF) GRAM_EPILOGUE(true, EPI_RBF);
                else if (a.p.kernel == POLYNOMIAL) GRAM_EPILOGUE(true, EPI_POLY);
                else GRAM_EPILOGUE(true, EPI_LINEAR);
            } else {
                switch (epilogue_kind(a.p)) {
                    case EPI_RBF: GRAM_EPILOGUE(false, EPI_RBF); break;
                    case EPI_POLY2: GRAM_EPILOGUE(false, EPI_POLY2); break;
                    case EPI_POLY3: GRAM_EPILOGUE(false, EPI_POLY3); break;
                    case EPI_POLY: GRAM_EPILOGUE(false, EPI_POLY); break;
                    default: GRAM_EPILOGUE(false, EPI_LINEAR); break;
                }
            }
#undef GRAM_EPILOGUE
        }
    }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the loaded libcuda, or nullptr.
inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
        return reinterpret_cast<EncodeTiledFn>(p);
    }();
    return fn;
}

// The tensor map of a row-major (rows, f) bf16 matrix cut into 128 x 64
// boxes under the 128-byte swizzle; out-of-range elements read as zero.
inline cudaError_t make_operand_map(CUtensorMap* map, const void* X, int rows, int f) {
    EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return cudaErrorSymbolNotFound;
    const cuuint64_t dims[2] = {(cuuint64_t)f, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)f * sizeof(__nv_bfloat16)};
    const cuuint32_t box[2] = {KCHUNK, BM};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(X), dims,
                               strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch the tile walk over A (na, f) x B (nb, f) on stream s.  SYM: B is A.
// Returns cudaErrorInvalidValue for operands TMA cannot take (f % 8 != 0 or
// a base not 16-byte aligned).
template <int NPROD, bool SYM>
cudaError_t launch_gram_wgmma(const void* A_hi, const void* A_lo, const void* B_hi,
                              const void* B_lo, int f, TileArgs args, cudaStream_t s) {
    if (f % 8 != 0 || !aligned16(A_hi) || !aligned16(B_hi) ||
        (NPROD == 3 && (!aligned16(A_lo) || !aligned16(B_lo))))
        return cudaErrorInvalidValue;
    CUtensorMap maps[4];
    const void* src[4] = {A_hi, NPROD == 3 ? A_lo : A_hi, B_hi, NPROD == 3 ? B_lo : B_hi};
    const int rows[4] = {args.na, args.na, args.nb, args.nb};
    for (int m = 0; m < 4; ++m) {
        const cudaError_t err = make_operand_map(&maps[m], src[m], rows[m], f);
        if (err != cudaSuccess) return err;
    }
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(gram_wgmma_kernel<NPROD, SYM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)wgmma_smem_bytes<NPROD>());
    if (err != cudaSuccess) return err;
    args.nchunks = (f + KCHUNK - 1) / KCHUNK;
    const unsigned grid = (unsigned)(args.tiles < sms ? args.tiles : sms);
    gram_wgmma_kernel<NPROD, SYM><<<grid, WGMMA_THREADS, wgmma_smem_bytes<NPROD>(), s>>>(
        maps[0], maps[1], maps[2], maps[3], args);
    return cudaGetLastError();
}

}  // namespace
