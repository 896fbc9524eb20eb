// Fused Gram-matrix x vector kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernel bodies of the JAX package
// (plssvm_sparse_fp22_tpu/ops/pallas_matvec.py):
//
//   K1  gram_matvec_sym   out = K(X, X) v over the lower-triangular tile
//                         pairs (i >= j), each pair adding K_ij v_j to row
//                         block i and K_ij^T v_i to row block j
//                         (_gram_matvec_sym_kernel, pallas_matvec.py:388).
//   K2  gram_matvec_rect  out = K(X, Y) v over every tile pair
//                         (_gram_matvec_kernel, pallas_matvec.py:117).
//
// K(a, b) is linear <a,b>, polynomial (gamma <a,b> + coef0)^degree or rbf
// exp(-gamma max(|a|^2 + |b|^2 - 2<a,b>, 0)).  K is never written to device
// memory: a CTA computes one BM x BM Gram tile G in registers, applies the
// transform and contracts it with v in its epilogue.
//
// What bounds it on the H100: the Gram product, 2 f flops per tile element,
// in exact float32 FFMA (no TF32, no tensor cores, to match the reference's
// exact-f32 tier).  X of a training system fits the 50 MB L2 (32768 x 256
// f32 is 32 MB), so device memory is not the limit.  The design keeps the
// FFMA pipes fed with a 128 x 128 tile per CTA, an 8 x 8 register tile per
// thread (64 FFMA per 4 shared-memory vector loads), and double-buffered
// shared memory so one sync covers each feature chunk.
//
// Cross-CTA reduction, and why it is deterministic.  The TPU kernel adds
// every contribution into a resident output block because its grid runs in
// order; CTAs here run concurrently and in no order.  So no CTA adds into
// the output.  Each CTA writes its BM-long partial sums into its own slot
// of a scratch slab that the caller allocates:
//
//   K1: slab[a][b][r], (nb, nb, BM): the contribution to row block a from
//       the pair whose other row block is b.  Pair (i, j), j <= i, writes
//       slot [i][j] with K_ij v_j and, when i != j, slot [j][i] with
//       K_ij^T v_i.  Every slot is written by exactly one CTA.
//   K2: slab[i][j][r], (nbi, nbj, BM): K_ij v_j of pair (i, j).
//   K3 (pair_contrib.cu): slab_i[i][j][r] = K_ij v_j and
//       slab_j[j][i][r] = K_ij^T v_i of cross-panel pair (i, j).
//
// A second kernel sums each output entry over the slab's middle axis in
// ascending order.  Every sum inside a CTA (the feature loop, the warp
// shuffle tree over the row side, the shared-memory pass over the column
// side) also runs in a fixed order, so the result is bitwise repeatable
// from run to run, and CG iteration counts repeat with it.
//
// Ragged shapes: rows beyond D (or N) and features beyond f are masked at
// the loads (read as 0) and in the epilogue (K := 0), so callers need not
// pad to tile multiples.
//
// Each C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().  The Gram tile,
// the transform and the slab reduction live in gram_tile.cuh.

#include "gram_tile.cuh"

namespace {

// K1: one CTA per lower-triangular tile pair t -> (i, j), j <= i.
__global__ void __launch_bounds__(THREADS, 2)
gram_matvec_sym_kernel(const float* __restrict__ X, const float* __restrict__ sq,
                       const float* __restrict__ v, int D, int f, int nb, bool vec4,
                       KernelParams p, float* __restrict__ slab) {
    const long long t = blockIdx.x;
    int i = (int)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
    while ((long long)i * (i + 1) / 2 > t) --i;
    while ((long long)(i + 1) * (i + 2) / 2 <= t) ++i;
    const int j = (int)(t - (long long)i * (i + 1) / 2);
    float* row_out = slab + ((size_t)i * nb + j) * BM;
    float* col_out = (i != j) ? slab + ((size_t)j * nb + i) * BM : nullptr;
    gram_tile(X, D, X, D, f, vec4, sq, sq, v, v, i * BM, j * BM, p, row_out, col_out);
}

// K2: one CTA per tile pair (i, j) = (blockIdx.y, blockIdx.x): the j axis is
// split over CTAs, so a one-row predict still fills the card.
__global__ void __launch_bounds__(THREADS, 2)
gram_matvec_rect_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                        const float* __restrict__ sqx, const float* __restrict__ sqy,
                        const float* __restrict__ v, int D, int N, int f, bool vec4,
                        KernelParams p, float* __restrict__ slab) {
    const int i = blockIdx.y;
    const int j = blockIdx.x;
    float* row_out = slab + ((size_t)i * gridDim.x + j) * BM;
    gram_tile(X, D, Y, N, f, vec4, sqx, sqy, nullptr, v, i * BM, j * BM, p, row_out, nullptr);
}

}  // namespace

extern "C" {

// K1: out (D,) = K(X, X) v.  X (D, f) row-major f32, sq (D,) = row norms
// |x|^2, v (D,), slab (nb, nb, BM) scratch with nb = ceil(D / BM).
int gram_matvec_sym(const float* X, const float* sq, const float* v, float* slab,
                    float* out, int D, int f, int kernel, int degree, float gamma,
                    float coef0, void* stream) {
    const int nb = (D + BM - 1) / BM;
    const long long pairs = (long long)nb * (nb + 1) / 2;
    const KernelParams p{kernel, degree, gamma, coef0};
    const bool vec4 = (f % 4 == 0) && aligned16(X);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    gram_matvec_sym_kernel<<<(unsigned)pairs, THREADS, 0, s>>>(X, sq, v, D, f, nb, vec4, p, slab);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    reduce_slab_kernel<<<(D + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, s>>>(
        slab, nb, D, out);
    return (int)cudaGetLastError();
}

// K2: out (D,) = K(X, Y) v.  X (D, f), Y (N, f) row-major f32, sqx (D,),
// sqy (N,) row norms, v (N,), slab (nbi, nbj, BM) scratch with
// nbi = ceil(D / BM), nbj = ceil(N / BM).
int gram_matvec_rect(const float* X, const float* Y, const float* sqx, const float* sqy,
                     const float* v, float* slab, float* out, int D, int N, int f,
                     int kernel, int degree, float gamma, float coef0, void* stream) {
    const int nbi = (D + BM - 1) / BM;
    const int nbj = (N + BM - 1) / BM;
    const KernelParams p{kernel, degree, gamma, coef0};
    const bool vec4 = (f % 4 == 0) && aligned16(X) && aligned16(Y);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    gram_matvec_rect_kernel<<<dim3(nbj, nbi), THREADS, 0, s>>>(X, Y, sqx, sqy, v, D, N, f,
                                                               vec4, p, slab);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    reduce_slab_kernel<<<(D + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, s>>>(
        slab, nbj, D, out);
    return (int)cudaGetLastError();
}

// Lets the wrapper check that the library's tile size matches its own.
int gram_matvec_tile() { return BM; }

}  // extern "C"
