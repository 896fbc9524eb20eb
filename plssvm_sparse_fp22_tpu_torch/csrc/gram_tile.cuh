// Shared device code of the Gram-matvec kernels (K1, K2 in gram_matvec.cu,
// K3 in pair_contrib.cu): the kernel transform, the BM x BM Gram tile of
// each precision tier with the row- and column-side epilogue they share, the
// lower-triangular pair order and the fixed-order slab reduction.  K1's and
// K3's bf16 tiers run the wgmma tile of gram_tile_wgmma.cuh instead of
// gram_tile_bf16, which K2 keeps.  See gram_matvec.cu for what bounds them on
// the H100 and why the cross-CTA reduction is deterministic.  Everything
// here has internal linkage, so each source that includes it gets its own
// copy.
//
// Tiers (the arms of _resolve_decomp, pallas_matvec.py:297-312):
//   exact     gram_tile: float32 operands, FFMA, f32 sums.
//   bf16x3    gram_tile_bf16<3>: operands split X = hi + lo in bf16 by the
//             caller (_split_bf16, pallas_matvec.py:282), G accumulated as
//             hi hi^T + hi lo^T + lo hi^T in that order per 16 features.
//   bf16cast  gram_tile_bf16<1>: operands rounded to bf16 by the caller,
//             one product.
// gram_tile_bf16 runs mma.sync m16n8k16 (bf16 in, f32 accumulate) on the
// tensor cores.  Each product of two bf16 values is exact in f32, but the
// tensor core's f32 accumulation does not round to nearest at every add, so
// a bf16 tile and its plain PyTorch version (exact products, f32 sums in
// another order) agree to the f32 rounding of the sums, not bitwise.  The
// tile is staged through shared memory in f32 and handed to the exact
// tier's epilogue in its register layout, so the transform, the two GEMVs
// and their fixed-order sums are the same code at every tier.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // tile rows = tile cols (CUDA_TILE in constants.py)
constexpr int BK = 8;        // features per chunk (CUDA_FEATURE_CHUNK)
constexpr int THREADS = 256; // 16 x 16 threads, each an 8 x 8 register tile
constexpr int REDUCE_THREADS = 256;

// bf16 tiers: 32 features per staged chunk, rows padded to 40 bf16 (80
// bytes) so the fragment loads of a warp hit 32 distinct banks; the f32
// Gram staging tile has rows of BM + 8 floats for conflict-free stores.
constexpr int BK16 = 32;
constexpr int SROW = BK16 + 8;
constexpr int GROW = BM + 8;
constexpr int STAGE_ELEMS = BM * SROW;

enum KernelKind { LINEAR = 0, POLYNOMIAL = 1, RBF = 2 };

struct KernelParams {
    int kernel;
    int degree;
    float gamma;
    float coef0;
};

// lax.integer_pow's binary exponentiation, in its multiplication order.
__device__ __forceinline__ float integer_pow(float x, int y) {
    if (y == 0) return 1.0f;
    const bool recip = y < 0;
    if (recip) y = -y;
    float acc = 0.0f;
    bool have = false;
    while (y > 0) {
        if (y & 1) {
            acc = have ? __fmul_rn(acc, x) : x;
            have = true;
        }
        y >>= 1;
        if (y > 0) x = __fmul_rn(x, x);
    }
    return recip ? 1.0f / acc : acc;
}

// The kernel transform of one Gram entry.  The _rn intrinsics keep nvcc
// from contracting into FMAs, so each step rounds as in the plain version.
__device__ __forceinline__ float transform(const KernelParams& p, float g,
                                           float sqi, float sqj) {
    if (p.kernel == POLYNOMIAL) {
        return integer_pow(__fadd_rn(__fmul_rn(p.gamma, g), p.coef0), p.degree);
    }
    if (p.kernel == RBF) {
        const float d = __fsub_rn(__fadd_rn(sqi, sqj), __fmul_rn(2.0f, g));
        return expf(__fmul_rn(-p.gamma, fmaxf(d, 0.0f)));
    }
    return g;
}

// Load a BM x BK chunk (rows row0.., features k0..) of a row-major (n, f)
// matrix into registers: thread t takes row t / 2, features 4 (t % 2) .. +3.
__device__ __forceinline__ void load_chunk(const float* __restrict__ X, int n,
                                           int f, int row0, int k0, bool vec4,
                                           float (&r)[4]) {
    const int row = row0 + (threadIdx.x >> 1);
    const int k = k0 + (threadIdx.x & 1) * 4;
    const float* src = X + (size_t)row * f + k;
    if (vec4 && row < n && k < f) {
        // f % 4 == 0 and a 16-byte aligned base: the whole float4 is in range
        const float4 q = *reinterpret_cast<const float4*>(src);
        r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
    } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
            r[c] = (row < n && k + c < f) ? src[c] : 0.0f;
    }
}

__device__ __forceinline__ void store_chunk(float (*S)[BM], const float (&r)[4]) {
    const int row = threadIdx.x >> 1;
    const int k = (threadIdx.x & 1) * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) S[k + c][row] = r[c];
}

// Row (col) of the thread's register tile entry i: two 4-wide groups, 64
// apart, so shared-memory reads are float4 and conflict free.
__device__ __forceinline__ int tile_index(int t, int i) {
    return (i < 4) ? t * 4 + i : 64 + t * 4 + (i - 4);
}

// The epilogue of every tier: transform, mask, contract with v.  Thread
// (ty, tx) holds G at rows tile_index(ty, i), columns tile_index(tx, j).
// Writes sum_b K[a][b] v_b for the tile's rows into row_out[0..BM) and, when
// col_out != nullptr, sum_a K[a][b] va_a into col_out[0..BM).
__device__ __forceinline__ void tile_epilogue(
    const float (&acc)[8][8], int na, int nb, const float* __restrict__ sqa,
    const float* __restrict__ sqb, const float* __restrict__ va,
    const float* __restrict__ vb, int ri0, int rj0, const KernelParams p,
    float* __restrict__ row_out, float* __restrict__ col_out, float (*red)[BM]) {
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    float sqr[8], vr[8], sqc[8], vc[8];
    bool okr[8], okc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = ri0 + tile_index(ty, i);
        okr[i] = r < na;
        sqr[i] = okr[i] ? sqa[r] : 0.0f;
        vr[i] = (okr[i] && col_out != nullptr) ? va[r] : 0.0f;
        const int c = rj0 + tile_index(tx, i);
        okc[i] = c < nb;
        sqc[i] = okc[i] ? sqb[c] : 0.0f;
        vc[i] = okc[i] ? vb[c] : 0.0f;
    }
    float rs[8], cs[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) { rs[i] = 0.0f; cs[i] = 0.0f; }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float kij = (okr[i] && okc[j]) ? transform(p, acc[i][j], sqr[i], sqc[j]) : 0.0f;
            rs[i] = fmaf(kij, vc[j], rs[i]);
            cs[j] = fmaf(kij, vr[i], cs[j]);
        }

    // row side: the 16 threads sharing rows are lanes tx = 0..15 of one
    // half-warp; a fixed xor tree sums them
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
            rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], off);
    if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) row_out[tile_index(ty, i)] = rs[i];
    }

    // column side: the 16 threads sharing columns sit in 8 warps; sum them
    // through shared memory in ty order
    if (col_out != nullptr) {
#pragma unroll
        for (int j = 0; j < 8; ++j) red[ty][tile_index(tx, j)] = cs[j];
        __syncthreads();
        if (threadIdx.x < BM) {
            float s = 0.0f;
#pragma unroll
            for (int t = 0; t < 16; ++t) s += red[t][threadIdx.x];
            col_out[threadIdx.x] = s;
        }
    }
}

// The exact tier's tile pair: rows [ri0, ri0+BM) of A against rows
// [rj0, rj0+BM) of B, float32 FFMA, then tile_epilogue.
__device__ __forceinline__ void gram_tile(
    const float* __restrict__ A, int na, const float* __restrict__ B, int nb,
    int f, bool vec4, const float* __restrict__ sqa, const float* __restrict__ sqb,
    const float* __restrict__ va, const float* __restrict__ vb, int ri0, int rj0,
    const KernelParams p, float* __restrict__ row_out, float* __restrict__ col_out) {
    __shared__ __align__(16) float As[2][BK][BM];
    __shared__ __align__(16) float Bs[2][BK][BM];
    __shared__ float red[16][BM];

    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    float ra[4], rb[4];
    load_chunk(A, na, f, ri0, 0, vec4, ra);
    load_chunk(B, nb, f, rj0, 0, vec4, rb);
    store_chunk(As[0], ra);
    store_chunk(Bs[0], rb);
    __syncthreads();

    int buf = 0;
    for (int k0 = 0; k0 < f; k0 += BK) {
        const bool next = k0 + BK < f;
        if (next) {
            load_chunk(A, na, f, ri0, k0 + BK, vec4, ra);
            load_chunk(B, nb, f, rj0, k0 + BK, vec4, rb);
        }
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
            const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
            const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        if (next) {
            // buf ^ 1 was last read before the previous iteration's sync
            store_chunk(As[buf ^ 1], ra);
            store_chunk(Bs[buf ^ 1], rb);
        }
        __syncthreads();
        buf ^= 1;
    }

    tile_epilogue(acc, na, nb, sqa, sqb, va, vb, ri0, rj0, p, row_out, col_out, red);
}

// ---------------------------------------------------------------- bf16 tiers

// Dynamic shared memory of gram_tile_bf16<NPROD>: two stages of NPROD == 3 ?
// 4 : 2 bf16 tiles (A hi, B hi, A lo, B lo), the f32 Gram staging tile
// aliased over them after the feature loop, and the column-side sums.
template <int NPROD>
__host__ __device__ constexpr size_t bf16_tile_smem_bytes() {
    constexpr size_t stages = 2 * (NPROD == 3 ? 4 : 2) * STAGE_ELEMS * sizeof(__nv_bfloat16);
    constexpr size_t gram = (size_t)BM * GROW * sizeof(float);
    return (stages > gram ? stages : gram) + 16 * BM * sizeof(float);
}

// Eight bf16 (16 bytes) of row `row`, features k..k+7, of a row-major (n, f)
// bf16 matrix; zero beyond n rows or f features.
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* __restrict__ X, int n,
                                            int f, int row, int k, bool vec8) {
    if (row >= n || k >= f) return make_uint4(0u, 0u, 0u, 0u);
    const unsigned short* src =
        reinterpret_cast<const unsigned short*>(X) + (size_t)row * f + k;
    if (vec8) return *reinterpret_cast<const uint4*>(src);  // f % 8 == 0, aligned
    uint32_t w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const uint32_t lo = (k + 2 * c < f) ? src[2 * c] : 0u;
        const uint32_t hi = (k + 2 * c + 1 < f) ? src[2 * c + 1] : 0u;
        w[c] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b for one m16n8k16 tile: a row-major 16 x 16 bf16, b "col" 16 x 8
// bf16 (each register two consecutive features of one column), d 16 x 8 f32.
// PTX ISA fragment layout, g = lane / 4, t = lane % 4:
//   a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   b0 (k 2t..2t+1, n g)              b1 (k 2t+8..2t+9, n g)
//   d0, d1 (g, 2t, 2t+1)              d2, d3 (g+8, 2t, 2t+1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The bf16 tiers' tile pair: same contract as gram_tile, operands in bf16
// (A_lo, B_lo only read when NPROD == 3).  Needs bf16_tile_smem_bytes<NPROD>()
// of dynamic shared memory.  Warp w computes rows 64 (w / 4) .. +63 and
// columns 32 (w % 4) .. +31 of G: 4 x 4 mma tiles, 64 f32 accumulators.
template <int NPROD>
__device__ __forceinline__ void gram_tile_bf16(
    const __nv_bfloat16* __restrict__ A_hi, const __nv_bfloat16* __restrict__ A_lo, int na,
    const __nv_bfloat16* __restrict__ B_hi, const __nv_bfloat16* __restrict__ B_lo, int nb,
    int f, bool vec8, const float* __restrict__ sqa, const float* __restrict__ sqb,
    const float* __restrict__ va, const float* __restrict__ vb, int ri0, int rj0,
    const KernelParams p, float* __restrict__ row_out, float* __restrict__ col_out) {
    constexpr int NT = NPROD == 3 ? 4 : 2;  // staged tiles: A hi, B hi (, A lo, B lo)
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem);   // [2][NT][BM][SROW]
    float* gs = reinterpret_cast<float*>(smem);                      // [BM][GROW], after the loop
    float (*red)[BM] = reinterpret_cast<float (*)[BM]>(
        smem + bf16_tile_smem_bytes<NPROD>() - 16 * BM * sizeof(float));

    const __nv_bfloat16* src[4] = {A_hi, B_hi, A_lo, B_lo};
    const int rows[4] = {na, nb, na, nb};
    const int row0[4] = {ri0, rj0, ri0, rj0};
    // loader: thread t stages rows t / 4 and t / 4 + 64, features 8 (t % 4) .. +7
    const int lrow = threadIdx.x >> 2;
    const int lk = (threadIdx.x & 3) * 8;

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int wr = (warp >> 2) * 64;
    const int wc = (warp & 3) * 32;

    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.0f;

    uint4 pre[NT][2];
#pragma unroll
    for (int s = 0; s < NT; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            pre[s][h] = load8_bf16(src[s], rows[s], f, row0[s] + lrow + 64 * h, lk, vec8);
#pragma unroll
    for (int s = 0; s < NT; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint4*>(&stage[s * STAGE_ELEMS + (lrow + 64 * h) * SROW + lk]) =
                pre[s][h];
    __syncthreads();

    int buf = 0;
    for (int k0 = 0; k0 < f; k0 += BK16) {
        const bool next = k0 + BK16 < f;
        if (next) {
#pragma unroll
            for (int s = 0; s < NT; ++s)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    pre[s][h] = load8_bf16(src[s], rows[s], f, row0[s] + lrow + 64 * h,
                                           k0 + BK16 + lk, vec8);
        }
        const __nv_bfloat16* sa = stage + (buf * NT + 0) * STAGE_ELEMS;
        const __nv_bfloat16* sb = stage + (buf * NT + 1) * STAGE_ELEMS;
        const __nv_bfloat16* sal = stage + (buf * NT + (NPROD == 3 ? 2 : 0)) * STAGE_ELEMS;
        const __nv_bfloat16* sbl = stage + (buf * NT + (NPROD == 3 ? 3 : 1)) * STAGE_ELEMS;
#pragma unroll
        for (int ks = 0; ks < BK16; ks += 16) {
            const int kk = ks + 2 * t4;
            uint32_t bh[4][2], bl[4][2];
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const int n = (wc + ni * 8 + g) * SROW + kk;
                bh[ni][0] = lds32(sb + n);
                bh[ni][1] = lds32(sb + n + 8);
                if (NPROD == 3) {
                    bl[ni][0] = lds32(sbl + n);
                    bl[ni][1] = lds32(sbl + n + 8);
                }
            }
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
                const int r = (wr + mi * 16 + g) * SROW + kk;
                const uint32_t ah[4] = {lds32(sa + r), lds32(sa + r + 8 * SROW),
                                        lds32(sa + r + 8), lds32(sa + r + 8 * SROW + 8)};
                uint32_t al[4] = {0u, 0u, 0u, 0u};
                if (NPROD == 3) {
                    al[0] = lds32(sal + r);
                    al[1] = lds32(sal + r + 8 * SROW);
                    al[2] = lds32(sal + r + 8);
                    al[3] = lds32(sal + r + 8 * SROW + 8);
                }
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) {
                    mma_bf16(acc[mi][ni], ah, bh[ni]);
                    if (NPROD == 3) {
                        mma_bf16(acc[mi][ni], ah, bl[ni]);
                        mma_bf16(acc[mi][ni], al, bh[ni]);
                    }
                }
            }
        }
        if (next) {
            // buf ^ 1 was last read before the previous iteration's sync
#pragma unroll
            for (int s = 0; s < NT; ++s)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    *reinterpret_cast<uint4*>(
                        &stage[((buf ^ 1) * NT + s) * STAGE_ELEMS + (lrow + 64 * h) * SROW + lk]) =
                        pre[s][h];
        }
        __syncthreads();
        buf ^= 1;
    }

    // the loop ended on a sync, so the stages are free: stage G in f32 and
    // read it back in the epilogue's register layout
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int r = wr + mi * 16 + g;
            const int c = wc + ni * 8 + 2 * t4;
            *reinterpret_cast<float2*>(&gs[r * GROW + c]) =
                make_float2(acc[mi][ni][0], acc[mi][ni][1]);
            *reinterpret_cast<float2*>(&gs[(r + 8) * GROW + c]) =
                make_float2(acc[mi][ni][2], acc[mi][ni][3]);
        }
    __syncthreads();
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    float tile[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const float* row = gs + tile_index(ty, i) * GROW;
        const float4 q0 = *reinterpret_cast<const float4*>(row + tx * 4);
        const float4 q1 = *reinterpret_cast<const float4*>(row + 64 + tx * 4);
        tile[i][0] = q0.x; tile[i][1] = q0.y; tile[i][2] = q0.z; tile[i][3] = q0.w;
        tile[i][4] = q1.x; tile[i][5] = q1.y; tile[i][6] = q1.z; tile[i][7] = q1.w;
    }
    tile_epilogue(tile, na, nb, sqa, sqb, va, vb, ri0, rj0, p, row_out, col_out, red);
}

// Allow a bf16 tile kernel its dynamic shared memory (above the 48 KB
// default); call before every launch.
template <int NPROD, typename Kernel>
cudaError_t allow_bf16_smem(Kernel* kernel) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bf16_tile_smem_bytes<NPROD>());
}

// Lower-triangular pair t -> (i, j), j <= i, in row-major order.
__device__ __forceinline__ void tri_pair(long long t, int& i, int& j) {
    i = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
    while ((long long)i * (i + 1) / 2 > t) --i;
    while ((long long)(i + 1) * (i + 2) / 2 <= t) ++i;
    j = (int)(t - (long long)i * (i + 1) / 2);
}

// out[a * BM + r] = sum_{b < inner} slab[a][b][r], b ascending.
__global__ void reduce_slab_kernel(const float* __restrict__ slab, int inner, int D,
                                   float* __restrict__ out) {
    const int idx = blockIdx.x * REDUCE_THREADS + threadIdx.x;
    if (idx >= D) return;
    const int a = idx / BM;
    const int r = idx % BM;
    const float* src = slab + (size_t)a * inner * BM + r;
    float s = 0.0f;
    for (int b = 0; b < inner; ++b) s += src[(size_t)b * BM];
    out[idx] = s;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace
