// K3: the panel-pair Gram-matvec kernel for NVIDIA Hopper (sm_90a).
//
// Replaces pair_gram_contrib (plssvm_sparse_fp22_tpu/ops/pallas_matvec.py:716),
// which drives the body _gram_matvec_sym_kernel (pallas_matvec.py:388), with
// its exact, bf16x3 and bf16cast arms (403-408, 441-453), over two transient
// dense panels Xi (Di, f) and Xj (Dj, f) of the streaming sparse learn.  For
// a cross-panel pair it computes, from one pass over every BM x BM tile
// pair (i, j),
//
//   out_i = K(Xi, Xj) v_j        and        out_j = K(Xi, Xj)^T v_i,
//
// K never written to device memory.  The diagonal panel pair (same=True in
// the wrapper) is K1 on the panel (gram_matvec.cu); this file adds no second
// triangle kernel.
//
// Design.  The TPU grid runs the pairs in order and accumulates out_j in a
// VMEM-resident vector (pallas_matvec.py:415-421).  Concurrent CTAs cannot,
// so each tile pair's row side K_ij v_j goes into its own slot slab_i[i][j]
// and its column side K_ij^T v_i into slab_j[j][i]; both come out of the one
// Gram tile.  Two fixed-order reduce_slab passes then give out_i and out_j,
// so the result is bitwise repeatable at every tier, like K1 and K2.  Rows
// beyond Di / Dj and features beyond f are masked inside the tile, so panels
// need no padding in the rows.
//
// What bounds it on the H100: the Gram product, 2 f flops per tile
// element: float32 FFMA at the exact tier (67 TFLOP/s non-tensor peak, one
// CTA per tile pair, gram_tile), the bf16 tensor cores at the bf16x3 (three
// products) and bf16cast tiers (989 TFLOP/s dense).  At f = 4096 the feature
// loop is nearly all of the time, so the bf16 tiers run the tile of
// gram_tile_wgmma.cuh: a persistent CTA per SM, one producer thread that
// keeps TMA loads of the 128 x 64 operand boxes in flight in a ring of
// stages, two consumer warpgroups that issue wgmma on alternate tile pairs
// and overlap one pair's epilogue with the other's products; the pairs are
// walked in groups of 8 row blocks so the CTAs running at one time share
// their boxes in the L2 (each 128 x 128 tile pulls both of its operands
// from there).  The bf16 operands need f % 8 == 0 (TMA's 16-byte
// row stride): the wrapper pads the feature axis with zeros, once per panel.
// A 4096 x 4096 panel pair is 1024 tile pairs; panels of 512 rows give only
// 16 on 132 SMs and leave most of the card idle; splitting the feature axis
// over CTAs and a densify fused into the tile loads (ROADMAP K5) are later
// work.
//
// The C entry point takes the tier (exact 0, bf16x3 1, bf16cast 2) and the
// operand pointers for it, as gram_matvec.cu's do.

#include "gram_tile.cuh"
#include "gram_tile_wgmma.cuh"

namespace {

// One CTA per tile pair (i, j) = (blockIdx.y, blockIdx.x) of Xi x Xj.
__global__ void __launch_bounds__(THREADS, 2)
gram_pair_contrib_kernel(const float* __restrict__ Xi, const float* __restrict__ Xj,
                         const float* __restrict__ sqi, const float* __restrict__ sqj,
                         const float* __restrict__ vi, const float* __restrict__ vj,
                         int Di, int Dj, int f, bool vec4, KernelParams p,
                         float* __restrict__ slab_i, float* __restrict__ slab_j) {
    const int i = blockIdx.y;
    const int j = blockIdx.x;
    const int nbi = gridDim.y;
    const int nbj = gridDim.x;
    float* row_out = slab_i + ((size_t)i * nbj + j) * BM;
    float* col_out = slab_j + ((size_t)j * nbi + i) * BM;
    gram_tile(Xi, Di, Xj, Dj, f, vec4, sqi, sqj, vi, vj, i * BM, j * BM, p, row_out,
              col_out);
}

// The bf16 tiers: the wgmma tile walk over every pair of Xi x Xj.
template <int NPROD>
cudaError_t launch_pair_bf16(const void* Xi, const void* Xi_lo, const void* Xj,
                             const void* Xj_lo, const float* sqi, const float* sqj,
                             const float* vi, const float* vj, int Di, int Dj, int f, int nbi,
                             int nbj, KernelParams p, float* slab_i, float* slab_j,
                             cudaStream_t s) {
    TileArgs args{sqi, sqj, vi, vj, slab_i, slab_j, Di, Dj, nbi, nbj, 0, (long long)nbi * nbj, p};
    return launch_gram_wgmma<NPROD, TILE_PAIR>(Xi, Xi_lo, Xj, Xj_lo, f, args, s);
}

}  // namespace

extern "C" {

// out_i (Di,) = K(Xi, Xj) v_j and out_j (Dj,) = K(Xi, Xj)^T v_i.  Xi (Di, f),
// Xj (Dj, f) row-major at the tier's types (float32 at tier 0; bf16 hi and
// the *_lo parts at tier 1; bf16 at tier 2; f % 8 == 0 and 16-byte aligned
// bases at tiers 1 and 2, else cudaErrorInvalidValue), sqi (Di,), sqj (Dj,)
// row norms |x|^2 of the float32 rows, slab_i (nbi, nbj, BM) and slab_j
// (nbj, nbi, BM) scratch with nbi = ceil(Di / BM), nbj = ceil(Dj / BM).
int gram_pair_contrib(int tier, const void* Xi, const void* Xi_lo, const void* Xj,
                      const void* Xj_lo, const float* sqi, const float* sqj, const float* vi,
                      const float* vj, float* slab_i, float* slab_j, float* out_i,
                      float* out_j, int Di, int Dj, int f, int kernel, int degree, float gamma,
                      float coef0, void* stream) {
    const int nbi = (Di + BM - 1) / BM;
    const int nbj = (Dj + BM - 1) / BM;
    const KernelParams p{kernel, degree, gamma, coef0};
    const dim3 grid(nbj, nbi);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (tier == 0) {
        const bool vec4 = (f % 4 == 0) && aligned16(Xi) && aligned16(Xj);
        gram_pair_contrib_kernel<<<grid, THREADS, 0, s>>>(
            static_cast<const float*>(Xi), static_cast<const float*>(Xj), sqi, sqj, vi, vj, Di,
            Dj, f, vec4, p, slab_i, slab_j);
        err = cudaGetLastError();
    } else if (tier == 1) {
        err = launch_pair_bf16<3>(Xi, Xi_lo, Xj, Xj_lo, sqi, sqj, vi, vj, Di, Dj, f, nbi, nbj,
                                  p, slab_i, slab_j, s);
    } else if (tier == 2) {
        err = launch_pair_bf16<1>(Xi, nullptr, Xj, nullptr, sqi, sqj, vi, vj, Di, Dj, f, nbi,
                                  nbj, p, slab_i, slab_j, s);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    reduce_slab_kernel<<<(Di + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, s>>>(
        slab_i, nbj, Di, out_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    reduce_slab_kernel<<<(Dj + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, s>>>(
        slab_j, nbi, Dj, out_j);
    return (int)cudaGetLastError();
}

}  // extern "C"
