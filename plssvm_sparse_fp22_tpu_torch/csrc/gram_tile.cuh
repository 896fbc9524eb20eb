// Shared device code of the Gram-matvec kernels (K1, K2 in gram_matvec.cu,
// K3 in pair_contrib.cu): the kernel transform, the exact tier's BM x BM
// Gram tile with its row- and column-side epilogue, the lower-triangular
// pair order and the fixed-order slab reduction.  The bf16 tiers of all
// three kernels run the wgmma tile of gram_tile_wgmma.cuh.  See
// gram_matvec.cu for what bounds them on the H100 and why the cross-CTA
// reduction is deterministic.  Everything here has internal linkage, so each
// source that includes it gets its own copy.
//
// Tiers (the arms of _resolve_decomp, pallas_matvec.py:297-312):
//   exact     gram_tile (here): float32 operands, FFMA, f32 sums.
//   bf16x3    gram_wgmma_kernel<3, .>: operands split X = hi + lo in bf16 by
//             the caller (_split_bf16, pallas_matvec.py:282; split_bf16.cu),
//             G accumulated as hi hi^T + hi lo^T + lo hi^T in that order per
//             16 features.
//   bf16cast  gram_wgmma_kernel<1, .>: operands rounded to bf16 by the
//             caller, one product.
// Each product of two bf16 values is exact in f32, but the tensor core's f32
// accumulation does not round to nearest at every add, so a bf16 tile and
// its plain PyTorch version (exact products, f32 sums in another order)
// agree to the f32 rounding of the sums, not bitwise.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // tile rows = tile cols (CUDA_TILE in constants.py)
constexpr int BK = 8;        // features per chunk (CUDA_FEATURE_CHUNK)
constexpr int THREADS = 256; // 16 x 16 threads, each an 8 x 8 register tile
constexpr int REDUCE_THREADS = 256;

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
