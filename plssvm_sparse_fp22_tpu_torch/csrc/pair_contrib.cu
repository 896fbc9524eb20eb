// K3: the panel-pair Gram-matvec kernel for NVIDIA Hopper (sm_90a).
//
// Replaces pair_gram_contrib (plssvm_sparse_fp22_tpu/ops/pallas_matvec.py:716),
// which drives the body _gram_matvec_sym_kernel (pallas_matvec.py:388) over
// two transient dense panels Xi (Di, f) and Xj (Dj, f) of the streaming
// sparse learn.  For a cross-panel pair it computes, from one pass over
// every BM x BM tile pair (i, j),
//
//   out_i = K(Xi, Xj) v_j        and        out_j = K(Xi, Xj)^T v_i,
//
// K never written to device memory.  The diagonal panel pair (same=True in
// the wrapper) is K1 on the panel (gram_matvec.cu); this file adds no second
// triangle kernel.
//
// Design.  The TPU grid runs the pairs in order and accumulates out_j in a
// VMEM-resident vector (pallas_matvec.py:415-421).  Concurrent CTAs cannot,
// so each CTA (one tile pair) writes its row side K_ij v_j into its own slot
// slab_i[i][j] and its column side K_ij^T v_i into slab_j[j][i]; both come
// out of the one Gram tile (gram_tile with col_out set).  Two fixed-order
// reduce_slab passes then give out_i and out_j, so the result is bitwise
// repeatable, like K1 and K2.  Rows beyond Di / Dj and features beyond f
// are masked inside the tile, so panels need no padding.
//
// What bounds it on the H100: the Gram product in exact float32 FFMA,
// 2 f flops per tile element, as for K1 (67 TFLOP/s f32 non-tensor peak).
// A 4096 x 4096 panel pair at f = 4096 is 1.4e11 flops over 32 x 32 = 1024
// CTAs.  Panels of 512 rows give only 4 x 4 = 16 CTAs on 132 SMs, and leave
// most of the card idle; splitting the feature axis over CTAs, wgmma/TMA
// and a densify fused into the tile loads (ROADMAP K5) are later work.

#include "gram_tile.cuh"

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

}  // namespace

extern "C" {

// out_i (Di,) = K(Xi, Xj) v_j and out_j (Dj,) = K(Xi, Xj)^T v_i.  Xi (Di, f),
// Xj (Dj, f) row-major f32, sqi (Di,), sqj (Dj,) row norms |x|^2, slab_i
// (nbi, nbj, BM) and slab_j (nbj, nbi, BM) scratch with nbi = ceil(Di / BM),
// nbj = ceil(Dj / BM).
int gram_pair_contrib(const float* Xi, const float* Xj, const float* sqi, const float* sqj,
                      const float* vi, const float* vj, float* slab_i, float* slab_j,
                      float* out_i, float* out_j, int Di, int Dj, int f, int kernel,
                      int degree, float gamma, float coef0, void* stream) {
    const int nbi = (Di + BM - 1) / BM;
    const int nbj = (Dj + BM - 1) / BM;
    const KernelParams p{kernel, degree, gamma, coef0};
    const bool vec4 = (f % 4 == 0) && aligned16(Xi) && aligned16(Xj);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    gram_pair_contrib_kernel<<<dim3(nbj, nbi), THREADS, 0, s>>>(
        Xi, Xj, sqi, sqj, vi, vj, Di, Dj, f, vec4, p, slab_i, slab_j);
    cudaError_t err = cudaGetLastError();
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
