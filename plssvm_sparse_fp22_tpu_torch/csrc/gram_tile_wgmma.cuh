// The bf16 tiers' Gram tile of K1, K2 (gram_matvec.cu) and K3
// (pair_contrib.cu), designed for Hopper: operands by TMA, the product by
// wgmma, one persistent CTA per SM whose two consumer warpgroups take
// alternate tile pairs, so one tile's transform and GEMVs run while the
// other's products do.  Every exact tier keeps the tile of gram_tile.cuh.
//
// What it computes: G = A B^T for one 128 x 128 tile pair from bf16 operands
// (bf16cast: one product; bf16x3: per 16 features hi hi^T, then hi lo^T,
// then lo hi^T into one f32 accumulator), the f32 kernel transform, K v_b
// for the tile's rows into the pair's row slot of the slab and, except in
// K2's mode, K^T v_a for its columns into the column slot.  Every slot is
// written by exactly one warpgroup and every sum runs in a fixed order, so
// the result is bitwise repeatable whatever CTA runs a pair.
//
// Three modes (TileMode), fixed at compile time:
//   TILE_SYM   K1: A = B = X, the lower-triangular pairs of one strip of
//              row blocks, one slab (sym_slot); a diagonal pair has no
//              column side.
//   TILE_PAIR  K3: every pair of Xi x Xj, a row slab and a column slab.
//   TILE_ROWS  K2: every pair of X x Y, the row side only.  Its epilogue has
//              no column side at all: no v of the A side, no column sums, no
//              shuffles across rows, no pass through shared memory, one
//              barrier a tile instead of two (the column side's norms and v
//              are staged in alternate buffers, so a tile's staging cannot
//              overtake the previous tile's reads), and the two consumers
//              issue their products in turns (turn_wait).  A one-row
//              predict still pays for both 64-row halves of its tiles: a
//              branch around the lower half's wgmma makes ptxas serialise
//              every wgmma of the kernel (its note C7520).  Where a row
//              block's whole operand fits shared memory (f <= 576 at
//              bf16cast, <= 320 at bf16x3), K2 runs gram_wgmma_rows_kernel
//              instead (below): the same products and epilogue with the A
//              side resident, half the operand traffic.
//
// Tile order.  K1 walks the lower triangle row by row.  K3 and K2 walk
// groups of PAIR_GROUP = 8 row blocks, column block by column block inside a
// group, so the 132 tiles in flight at one time are 8 row blocks against
// about 17 column blocks: every A box is pulled from the L2 17 times and
// every B box 8 times while it is hot, and B streams from device memory once
// per group.  K2's predict shape (32 row blocks of points, 256 column blocks
// of support vectors) would be 4 such groups; its B side, 16 MB in bf16 at
// f = 256 (32 MB as hi + lo), fits the 50 MB L2 with all of A, so the order
// only has to keep the boxes of concurrent tiles shared, which it does.  At
// that f, though, K2 takes gram_wgmma_rows_kernel, whose walk is described
// there.
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
// not inline) may run between a tile's first wgmma and its wait, and no wgmma
// may sit under a branch of its own: either serialises every wgmma of the
// kernel (notes C7510 and C7520 in the build log).

#pragma once

#include <cuda.h>

#include "gram_tile.cuh"

namespace {

constexpr int WG_THREADS = 128;
constexpr int WGMMA_THREADS = 3 * WG_THREADS;  // consumers 0, 1 and the producer's warpgroup
constexpr int KCHUNK = 64;                     // features per stage: 128 bytes, the swizzle span
constexpr int TILE_BYTES = BM * KCHUNK * 2;    // one 128 x 64 bf16 box
constexpr int PAIR_GROUP = 8;                  // K2, K3: row blocks per raster group

enum TileMode { TILE_SYM = 0, TILE_PAIR = 1, TILE_ROWS = 2 };

template <int NPROD>
__host__ __device__ constexpr int wgmma_stages() {
    return NPROD == 3 ? 3 : 6;
}

// 1 KB of slack to align the ring to the swizzle's 1024 bytes, the ring,
// the column-side sums [2][4][BM] (TILE_ROWS: the second buffer of sq and v),
// the column-side sq and v [2][2][BM], and the mbarriers: full [2][STAGES]
// (per consumer), empty [STAGES].
template <int NPROD>
__host__ __device__ constexpr size_t wgmma_smem_bytes() {
    return 1024 + (size_t)wgmma_stages<NPROD>() * (NPROD == 3 ? 4 : 2) * TILE_BYTES +
           (2 * 4 * BM + 2 * 2 * BM) * sizeof(float) + 3 * wgmma_stages<NPROD>() * 8;
}

struct TileArgs {
    const float* sqa;   // row norms of the A side (na,)
    const float* sqb;   // of the B side (nb,)
    const float* va;    // v of the A side, contracted on the column side (K2: null)
    const float* vb;    // v of the B side, contracted on the row side
    float* slab_row;    // K1, K2: the one slab; K3: slab_i
    float* slab_col;    // K3: slab_j (K1: unused, K2: null)
    int na, nb;         // rows of each side
    int nbi, nbj;       // 128-row blocks of each side
    int nchunks;        // ceil(f / 64)
    long long tiles;    // tile pairs: K1 the strip's, K2 and K3 nbi nbj
    KernelParams p;
    long long first;    // K1: the strip's first lower-triangle pair
    int i0, i1;         // K1: the strip's row blocks (sym_slot)
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

// K2's kernels order the two consumers' products: warpgroup wg waits for its
// turn before it issues a tile's products and passes the turn on once they
// are issued (named barriers 3 and 4, counted over both warpgroups: the 128
// threads that wait and the 128 that pass).  Left alone, the two fall into
// step, run their products together at half the rate each and then their
// epilogues together with the tensor cores idle; in turns, one's epilogue
// runs under the other's products.  Warpgroup 1 passes once before its first
// tile, so that warpgroup 0 starts.
__device__ __forceinline__ void turn_wait(int wg) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(wg + 3), "n"(2 * WG_THREADS) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"((wg ^ 1) + 3), "n"(2 * WG_THREADS) : "memory");
}

// ------------------------------------------------------------ tile walk

// Tile pair t -> (i, j).  K1: the lower triangle in row-major order
// (tri_pair), from the strip's first pair.  K2, K3: groups of PAIR_GROUP row blocks, column-major inside
// a group, so the tiles that run at one time share A and B boxes in the L2.
template <bool SYM>
__device__ __forceinline__ void tile_coords(const TileArgs& a, long long t, int& i, int& j) {
    if (SYM) {
        tri_pair(a.first + t, i, j);
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

// TILE_ROWS: transform and contract one accumulator on the row side alone.
// Writes the row sums of rows < rows_left to row_out.  GENERAL: columns >=
// cols_left get K := 0 (rows beyond rows_left are computed, from zero-filled
// operands, and dropped at the store).  No shuffle leaves the 4
// lanes of a row, nothing goes through shared memory and there is no barrier.
template <bool GENERAL, int KIND>
__device__ __forceinline__ void wgmma_epilogue_rows(
    const float (&acc0)[64], const float (&acc1)[64], const KernelParams& p,
    const float (&sqr)[4], int rows_left, int cols_left, const float* __restrict__ sqc,
    const float* __restrict__ vc, float* __restrict__ row_out, int tid) {
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int r0 = 16 * warp + (lane >> 2);  // row of slot q: r0 + 64 (q / 2) + 8 (q % 2)
    const int c0 = 2 * (lane & 3);           // column of (j, e): c0 + 8 j + e
    const float c2g = 2.0f * LOG2E * p.gamma;

    float rs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const int c = c0 + 8 * j;
        const float2 sq2 = *reinterpret_cast<const float2*>(sqc + c);
        const float2 v2 = *reinterpret_cast<const float2*>(vc + c);
        const bool okc0 = c < cols_left;
        const bool okc1 = c + 1 < cols_left;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float g0 = (q < 2) ? acc0[4 * j + 2 * (q & 1)] : acc1[4 * j + 2 * (q & 1)];
            const float g1 = (q < 2) ? acc0[4 * j + 2 * (q & 1) + 1] : acc1[4 * j + 2 * (q & 1) + 1];
            float k0 = transform_fast<KIND>(p, c2g, g0, sqr[q], sq2.x);
            float k1 = transform_fast<KIND>(p, c2g, g1, sqr[q], sq2.y);
            if (GENERAL) {
                k0 = okc0 ? k0 : 0.0f;
                k1 = okc1 ? k1 : 0.0f;
            }
            rs[q] = fmaf(k0, v2.x, rs[q]);
            rs[q] = fmaf(k1, v2.y, rs[q]);
        }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        rs[q] += __shfl_xor_sync(0xffffffffu, rs[q], 1);
        rs[q] += __shfl_xor_sync(0xffffffffu, rs[q], 2);
    }
    if ((lane & 3) == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int r = r0 + 64 * (q >> 1) + 8 * (q & 1);
            if (!GENERAL || r < rows_left) row_out[r] = rs[q];
        }
    }
}

// ---------------------------------------------------------------- kernel

// MODE: a TileMode.  The *_lo maps are read only when NPROD == 3.
template <int NPROD, int MODE>
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
                tile_coords<MODE == TILE_SYM>(a, t, i, j);
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
        float* sqc_all = colv_all + wg * 2 * BM;
        const uint32_t full = full_all + 8 * wg * STAGES;
        uint32_t full_parity = 0;  // bit s: the parity of this warpgroup's next use of stage s

        float acc0[64] = {}, acc1[64] = {};  // rows 0-63 and 64-127 of the tile
        uint32_t it = 0;
        int n = 0;
        if (MODE == TILE_ROWS && wg == 1) turn_pass(wg);
        for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x, ++n) {
            if ((n & 1) != wg) {  // the other warpgroup's pair: skip its stages
                it += a.nchunks;
                continue;
            }
            int i, j;
            tile_coords<MODE == TILE_SYM>(a, t, i, j);
            const int ri0 = i * BM, rj0 = j * BM;
            float* row_out;
            float* col_out;
            if (MODE == TILE_SYM) {
                row_out = sym_slot(a.slab_row, a.i0, a.i1, i, j);
                col_out = (i != j) ? sym_slot(a.slab_row, a.i0, a.i1, j, i) : nullptr;
            } else {
                row_out = a.slab_row + ((size_t)i * a.nbj + j) * BM;
                col_out = MODE == TILE_PAIR ? a.slab_col + ((size_t)j * a.nbi + i) * BM : nullptr;
            }
            const int rows_left = a.na - ri0, cols_left = a.nb - rj0;

            // the column side's sq and v into shared memory, the thread's
            // four rows into registers, while the first stages arrive.
            // TILE_ROWS has no barrier after a tile's reads of them, so the
            // warpgroup's tiles alternate between two buffers: a warp that
            // stages tile k + 2 has passed tile k + 1's barrier, which every
            // warp reaches only after its epilogue of tile k.
            float* sqc = sqc_all;
            if (MODE == TILE_ROWS && ((n >> 1) & 1)) sqc = red;
            float* vc = sqc + BM;
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
                vr[q] = (MODE != TILE_ROWS && r < a.na && col_out != nullptr) ? a.va[r] : 0.0f;
            }
            warpgroup_sync(wg);  // also: the previous tile's reads of red, sqc, vc are over

            if (a.nchunks == 0) {
#pragma unroll
                for (int e = 0; e < 64; ++e) acc0[e] = acc1[e] = 0.0f;
            }
            fence_accumulator(acc0);
            fence_accumulator(acc1);
            if (MODE == TILE_ROWS) turn_wait(wg);
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
            if (MODE == TILE_ROWS) turn_pass(wg);
            wgmma_wait<0>();
            if (a.nchunks > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % STAGES));
            fence_accumulator(acc0);
            fence_accumulator(acc1);

#define GRAM_EPILOGUE(GENERAL, KIND)                                                           \
    do {                                                                                       \
        if (MODE == TILE_ROWS)                                                                 \
            wgmma_epilogue_rows<GENERAL, KIND>(acc0, acc1, a.p, sqr, rows_left, cols_left, sqc, \
                                               vc, row_out, tid);                              \
        else                                                                                   \
            wgmma_epilogue<GENERAL, KIND>(acc0, acc1, a.p, sqr, vr, rows_left, cols_left, sqc,  \
                                          vc, red, row_out, col_out, wg, tid);                 \
    } while (0)
            // ragged tiles and K1's diagonal ones are few: they take the
            // general epilogue in the kinds' general forms
            if (rows_left < BM || cols_left < BM || (MODE != TILE_ROWS && col_out == nullptr)) {
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

// ----------------------------------------------- K2 with the A side resident
//
// gram_wgmma_kernel in TILE_ROWS mode pulls both 128 x f operands of every
// tile from the L2, and at f = 256 that traffic, not wgmma, sets its time
// (an H100 delivered about 6 TB/s of boxes, whatever the epilogue did).  K2's
// A side is short:
// a row block of points against hundreds of column blocks of support
// vectors.  Where a row block's operand (nchunks boxes of hi, and of lo at
// bf16x3) fits shared memory beside a ring of at least rows_min_stages()
// stages, this kernel loads it once per run of column blocks and streams only
// B through the ring: half the bytes per tile.  launch_gram_wgmma_rows takes
// it then (f <= 576 at bf16cast, f <= 320 at bf16x3) and the TILE_ROWS mode
// of gram_wgmma_kernel otherwise.  At bf16x3 and f = 256 the 128 KB of A
// leave room for three 32 KB stages, to the last 2 KB of the CTA's shared
// memory; with two, the ring's latency and not the product set the time.
//
// Work is cut into units (row block i, run of `run` column blocks); unit u is
// i = u % nbi, part u / nbi, so the CTAs running at one time hold different
// row blocks and walk the same column blocks in step: a B box comes from
// device memory once and from the L2 for every other row block.  `parts` is
// chosen so that nbi * parts units fill the SMs in one wave where nbi is
// small (the predict's 32 row blocks: 4 runs of 64 tiles on 128 SMs; one
// point: 128 runs of 2 tiles); with more row blocks than SMs a unit is a
// whole row of tiles.  The two consumer warpgroups take a CTA's tiles
// alternately and in turns (turn_wait), and the epilogue is TILE_ROWS' own.
//
// Barriers: the B ring's `full` (one per consumer and stage) and `empty` as in
// gram_wgmma_kernel; `a_full`, on which the producer's loads of a unit's A
// complete and both consumers wait once per unit (a consumer without a tile
// in the unit too: a waiter must see every phase); `a_empty`, on which the 8
// consumer warps arrive when their products of the unit are done and the
// producer waits before it overwrites A.

constexpr int ROWS_MAX_STAGES = 8;

template <int NPROD>
__host__ __device__ constexpr int rows_min_stages() {
    return NPROD == 3 ? 2 : 4;
}

// Bytes of one chunk (64 features) of one operand: hi (, lo).
template <int NPROD>
__host__ __device__ constexpr uint32_t rows_chunk_bytes() {
    return (NPROD == 3 ? 2 : 1) * TILE_BYTES;
}

// Buffers of the column side's sq and v per warpgroup: two, used alternately
// so that no barrier follows the epilogue (TILE_ROWS), where shared memory
// has the room; bf16x3 at f = 256 needs those 2 KB for its third stage.
template <int NPROD>
__host__ __device__ constexpr int rows_colv_buffers() {
    return NPROD == 3 ? 1 : 2;
}

// Beside A and the ring: the column side's sq and v [2 warpgroups][buffers]
// [2][BM], the mbarriers full [2][MAX], empty [MAX], a_full, a_empty.  No
// slack to align the boxes: the array is declared 1024-byte aligned.
template <int NPROD>
__host__ __device__ constexpr size_t rows_fixed_smem() {
    return 2 * rows_colv_buffers<NPROD>() * 2 * BM * sizeof(float) +
           (3 * ROWS_MAX_STAGES + 2) * 8;
}

constexpr size_t SMEM_PER_BLOCK = 232448;  // what one CTA may use on sm_90

struct RowsArgs {
    const float* sqa;  // row norms of the A side (na,)
    const float* sqb;  // of the B side (nb,)
    const float* vb;   // v of the B side
    float* slab;       // (nbi, nbj, BM)
    int na, nb;        // rows of each side
    int nbi, nbj;      // 128-row blocks of each side
    int nchunks;       // ceil(f / 64) >= 1
    int parts, run;    // a row of nbj tiles is cut into `parts` runs of `run`
    int units;         // nbi * parts
    int stages;        // of the B ring, 2 .. ROWS_MAX_STAGES
    KernelParams p;
};

template <int NPROD>
__global__ void __launch_bounds__(WGMMA_THREADS, 1)
gram_wgmma_rows_kernel(const __grid_constant__ CUtensorMap map_a_hi,
                       const __grid_constant__ CUtensorMap map_a_lo,
                       const __grid_constant__ CUtensorMap map_b_hi,
                       const __grid_constant__ CUtensorMap map_b_lo, const RowsArgs a) {
    constexpr uint32_t CHUNK_BYTES = rows_chunk_bytes<NPROD>();
    constexpr int BUFS = rows_colv_buffers<NPROD>();

    extern __shared__ __align__(1024) unsigned char smem_rows[];
    const uint32_t a_res = smem_u32(smem_rows);  // A: nchunks chunks of hi (, lo)
    if (a_res & 1023u) __trap();                 // the swizzle needs 1024-byte aligned boxes
    const uint32_t ring = a_res + a.nchunks * CHUNK_BYTES;
    float* colv_all =
        reinterpret_cast<float*>(smem_rows + (a.nchunks + a.stages) * CHUNK_BYTES);
    const uint32_t full_all = smem_u32(colv_all + 2 * BUFS * 2 * BM);  // [2][ROWS_MAX_STAGES]
    const uint32_t empty = full_all + 2 * 8 * ROWS_MAX_STAGES;
    const uint32_t a_full = empty + 8 * ROWS_MAX_STAGES;
    const uint32_t a_empty = a_full + 8;

    if (threadIdx.x == 0) {
        for (int s = 0; s < a.stages; ++s) {
            mbar_init(full_all + 8 * s, 1);
            mbar_init(full_all + 8 * (ROWS_MAX_STAGES + s), 1);
            mbar_init(empty + 8 * s, 4);  // one arrive per warp of the consuming warpgroup
        }
        mbar_init(a_full, 1);
        mbar_init(a_empty, 8);  // one arrive per consumer warp
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / WG_THREADS;
    if (wg == 2) {
        // ------------------------------------------------------ producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (threadIdx.x == 2 * WG_THREADS) {
            uint32_t s = 0;
            uint32_t empty_parity = ~0u;  // bit s: the parity of the next wait on stage s
            int n = 0, un = 0;
            for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++un) {
                const int i = u % a.nbi;
                const int j0 = (u / a.nbi) * a.run;
                const int j1 = min(a.nbj, j0 + a.run);
                mbar_wait(a_empty, (un & 1u) ^ 1u);
                mbar_expect_tx(a_full, a.nchunks * CHUNK_BYTES);
                for (int kc = 0; kc < a.nchunks; ++kc) {
                    const uint32_t dst = a_res + kc * CHUNK_BYTES;
                    tma_load_2d(dst, &map_a_hi, a_full, kc * KCHUNK, i * BM);
                    if (NPROD == 3)
                        tma_load_2d(dst + TILE_BYTES, &map_a_lo, a_full, kc * KCHUNK, i * BM);
                }
                for (int j = j0; j < j1; ++j, ++n) {
                    for (int kc = 0; kc < a.nchunks; ++kc) {
                        const uint32_t full =
                            full_all + 8 * ((n & 1) * ROWS_MAX_STAGES + s);  // the owner's
                        mbar_wait(empty + 8 * s, (empty_parity >> s) & 1u);
                        empty_parity ^= 1u << s;
                        mbar_expect_tx(full, CHUNK_BYTES);
                        const uint32_t dst = ring + s * CHUNK_BYTES;
                        tma_load_2d(dst, &map_b_hi, full, kc * KCHUNK, j * BM);
                        if (NPROD == 3)
                            tma_load_2d(dst + TILE_BYTES, &map_b_lo, full, kc * KCHUNK, j * BM);
                        s = (s + 1 == (uint32_t)a.stages) ? 0 : s + 1;
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
        float* colv = colv_all + wg * BUFS * 2 * BM;
        const uint32_t full = full_all + 8 * wg * ROWS_MAX_STAGES;
        uint32_t full_parity = 0;  // bit s: the parity of this warpgroup's next use of stage s

        float acc0[64] = {}, acc1[64] = {};  // rows 0-63 and 64-127 of the tile
        uint32_t s = 0;
        int n = 0, un = 0, mine = 0;
        if (wg == 1) turn_pass(wg);
        for (int u = blockIdx.x; u < a.units; u += gridDim.x, ++un) {
            const int i = u % a.nbi;
            const int j0 = (u / a.nbi) * a.run;
            const int j1 = min(a.nbj, j0 + a.run);
            const int ri0 = i * BM;
            const int rows_left = a.na - ri0;
            float sqr[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = ri0 + 16 * warp + (lane >> 2) + 64 * (q >> 1) + 8 * (q & 1);
                sqr[q] = r < a.na ? epilogue_norm(a.p, a.sqa[r]) : 0.0f;
            }
            mbar_wait(a_full, un & 1u);

            for (int j = j0; j < j1; ++j, ++n) {
                if ((n & 1) != wg) {  // the other warpgroup's tile: skip its stages
                    s = (s + a.nchunks) % a.stages;
                    continue;
                }
                const int rj0 = j * BM;
                const int cols_left = a.nb - rj0;
                float* row_out = a.slab + ((size_t)i * a.nbj + j) * BM;
                // alternate buffers, as in TILE_ROWS: no barrier after the epilogue
                float* sqc = colv + (mine % BUFS) * 2 * BM;
                float* vc = sqc + BM;
                ++mine;
                {
                    const int c = rj0 + tid;
                    sqc[tid] = c < a.nb ? epilogue_norm(a.p, a.sqb[c]) : 0.0f;
                    vc[tid] = c < a.nb ? a.vb[c] : 0.0f;
                }
                warpgroup_sync(wg);

                fence_accumulator(acc0);
                fence_accumulator(acc1);
                turn_wait(wg);
                uint32_t prev = 0;
                for (int kc = 0; kc < a.nchunks; ++kc) {
                    mbar_wait(full + 8 * s, (full_parity >> s) & 1u);
                    full_parity ^= 1u << s;
                    const uint64_t a_hi = wgmma_desc(a_res + kc * CHUNK_BYTES);
                    const uint64_t a_lo = wgmma_desc(a_res + kc * CHUNK_BYTES + TILE_BYTES);
                    const uint64_t b_hi = wgmma_desc(ring + s * CHUNK_BYTES);
                    const uint64_t b_lo = wgmma_desc(ring + s * CHUNK_BYTES + TILE_BYTES);
                    wgmma_fence();
#pragma unroll
                    for (int k = 0; k < KCHUNK / 16; ++k) {
                        const uint64_t ko = 2 * k;       // as in gram_wgmma_kernel
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
                        if (lane == 0) mbar_arrive(empty + 8 * prev);
                    }
                    prev = s;
                    s = (s + 1 == (uint32_t)a.stages) ? 0 : s + 1;
                }
                turn_pass(wg);
                wgmma_wait<0>();
                if (lane == 0) mbar_arrive(empty + 8 * prev);
                fence_accumulator(acc0);
                fence_accumulator(acc1);

#define ROWS_EPILOGUE(GENERAL, KIND)                                                         \
    wgmma_epilogue_rows<GENERAL, KIND>(acc0, acc1, a.p, sqr, rows_left, cols_left, sqc, vc, \
                                       row_out, tid)
                if (rows_left < BM || cols_left < BM) {
                    if (a.p.kernel == RBF) ROWS_EPILOGUE(true, EPI_RBF);
                    else if (a.p.kernel == POLYNOMIAL) ROWS_EPILOGUE(true, EPI_POLY);
                    else ROWS_EPILOGUE(true, EPI_LINEAR);
                } else {
                    switch (epilogue_kind(a.p)) {
                        case EPI_RBF: ROWS_EPILOGUE(false, EPI_RBF); break;
                        case EPI_POLY2: ROWS_EPILOGUE(false, EPI_POLY2); break;
                        case EPI_POLY3: ROWS_EPILOGUE(false, EPI_POLY3); break;
                        case EPI_POLY: ROWS_EPILOGUE(false, EPI_POLY); break;
                        default: ROWS_EPILOGUE(false, EPI_LINEAR); break;
                    }
                }
#undef ROWS_EPILOGUE
                // one buffer: its readers must be done before the next tile's staging
                if (BUFS == 1) warpgroup_sync(wg);
            }
            // every product of this warp that read the unit's A is complete
            if (lane == 0) mbar_arrive(a_empty);
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

// Launch the tile walk over A (na, f) x B (nb, f) on stream s in TileMode
// MODE (TILE_SYM: B is A).
// Returns cudaErrorInvalidValue for operands TMA cannot take (f % 8 != 0 or
// a base not 16-byte aligned).
// The four maps A hi, A lo, B hi, B lo (the lo maps repeat hi unless NPROD ==
// 3).  cudaErrorInvalidValue for operands TMA cannot take.
template <int NPROD>
cudaError_t make_operand_maps(CUtensorMap (&maps)[4], const void* A_hi, const void* A_lo,
                              const void* B_hi, const void* B_lo, int na, int nb, int f) {
    if (f % 8 != 0 || !aligned16(A_hi) || !aligned16(B_hi) ||
        (NPROD == 3 && (!aligned16(A_lo) || !aligned16(B_lo))))
        return cudaErrorInvalidValue;
    const void* src[4] = {A_hi, NPROD == 3 ? A_lo : A_hi, B_hi, NPROD == 3 ? B_lo : B_hi};
    const int rows[4] = {na, na, nb, nb};
    for (int m = 0; m < 4; ++m) {
        const cudaError_t err = make_operand_map(&maps[m], src[m], rows[m], f);
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

inline cudaError_t sm_count(int* sms) {
    int device = 0;
    const cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

template <int NPROD, int MODE>
cudaError_t launch_gram_wgmma(const void* A_hi, const void* A_lo, const void* B_hi,
                              const void* B_lo, int f, TileArgs args, cudaStream_t s) {
    CUtensorMap maps[4];
    cudaError_t err =
        make_operand_maps<NPROD>(maps, A_hi, A_lo, B_hi, B_lo, args.na, args.nb, f);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(gram_wgmma_kernel<NPROD, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)wgmma_smem_bytes<NPROD>());
    if (err != cudaSuccess) return err;
    args.nchunks = (f + KCHUNK - 1) / KCHUNK;
    const unsigned grid = (unsigned)(args.tiles < sms ? args.tiles : sms);
    gram_wgmma_kernel<NPROD, MODE><<<grid, WGMMA_THREADS, wgmma_smem_bytes<NPROD>(), s>>>(
        maps[0], maps[1], maps[2], maps[3], args);
    return cudaGetLastError();
}

// K2's bf16 tiers: out-of-kernel choice between the resident-A kernel, where
// a row block's operand fits shared memory beside the ring, and the TILE_ROWS
// mode of gram_wgmma_kernel.  slab (nbi, nbj, BM).
template <int NPROD>
cudaError_t launch_gram_wgmma_rows(const void* A_hi, const void* A_lo, const void* B_hi,
                                   const void* B_lo, const float* sqa, const float* sqb,
                                   const float* vb, int na, int nb, int f, KernelParams p,
                                   float* slab, cudaStream_t s) {
    const int nbi = (na + BM - 1) / BM, nbj = (nb + BM - 1) / BM;
    const int nchunks = (f + KCHUNK - 1) / KCHUNK;
    constexpr int room =
        (int)((SMEM_PER_BLOCK - rows_fixed_smem<NPROD>()) / rows_chunk_bytes<NPROD>());
    if (nchunks < 1 || nchunks + rows_min_stages<NPROD>() > room) {
        TileArgs args{sqa, sqb, nullptr, vb, slab, nullptr, na, nb, nbi, nbj, 0,
                      (long long)nbi * nbj, p};
        return launch_gram_wgmma<NPROD, TILE_ROWS>(A_hi, A_lo, B_hi, B_lo, f, args, s);
    }
    CUtensorMap maps[4];
    cudaError_t err = make_operand_maps<NPROD>(maps, A_hi, A_lo, B_hi, B_lo, na, nb, f);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    int parts = sms / nbi < 1 ? 1 : (sms / nbi > nbj ? nbj : sms / nbi);
    const int run = (nbj + parts - 1) / parts;
    parts = (nbj + run - 1) / run;  // no empty run
    if ((long long)nbi * parts > 2147483647ll) return cudaErrorInvalidValue;
    const int stages = room - nchunks < ROWS_MAX_STAGES ? room - nchunks : ROWS_MAX_STAGES;
    const RowsArgs args{sqa, sqb, vb, slab, na, nb, nbi, nbj, nchunks, parts, run,
                        nbi * parts, stages, p};
    const size_t smem =
        rows_fixed_smem<NPROD>() + (size_t)(nchunks + stages) * rows_chunk_bytes<NPROD>();
    err = cudaFuncSetAttribute(gram_wgmma_rows_kernel<NPROD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const unsigned grid = (unsigned)(args.units < sms ? args.units : sms);
    gram_wgmma_rows_kernel<NPROD><<<grid, WGMMA_THREADS, smem, s>>>(maps[0], maps[1], maps[2],
                                                                    maps[3], args);
    return cudaGetLastError();
}

}  // namespace
