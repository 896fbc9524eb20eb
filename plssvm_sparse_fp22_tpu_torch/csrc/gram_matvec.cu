// Fused Gram-matrix x vector kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernel bodies of the JAX package
// (plssvm_sparse_fp22_tpu/ops/pallas_matvec.py), each with its three
// precision arms (exact, and the bf16x3 / bf16cast arms at 129-134, 157-165
// and 403-408, 441-453):
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
// memory: a CTA computes one BM x BM Gram tile G, applies the transform and
// contracts it with v in its epilogue.
//
// What bounds it on the H100.  Exact tier: the Gram product, 2 f flops per
// tile element, in float32 FFMA (67 TFLOP/s non-tensor peak); X of a
// training system fits the 50 MB L2 (32768 x 256 f32 is 32 MB), so device
// memory is not the limit.  The design keeps the FFMA pipes fed with a
// 128 x 128 tile per CTA, an 8 x 8 register tile per thread (64 FFMA per 4
// shared-memory vector loads), and double-buffered shared memory so one
// sync covers each feature chunk.  bf16 tiers: the product moves to the bf16
// tensor cores (989 TFLOP/s dense; three products per 16 features at bf16x3,
// one at bf16cast), which sets the bound; at f = 256 a tile's product is so
// short that its transform (one special-function op per element) and the
// operand boxes it pulls from the L2 (both 128 x f operands per 128 x 128
// tile) weigh as much.  K1's bf16 tiers run the tile of
// gram_tile_wgmma.cuh: TMA loads into a ring of stages, wgmma products, a
// persistent CTA per SM whose two consumer warpgroups overlap one tile's
// epilogue with the next tile's product, the accumulator read in wgmma's
// own register layout.  K2's bf16 tiers still run gram_tile_bf16
// (gram_tile.cuh): mma.sync fed by threads from a two-stage buffer, one CTA
// of 8 warps per SM, the epilogue serial with the product.
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
// from run to run at every tier, and CG iteration counts repeat with it.
//
// Ragged shapes: rows beyond D (or N) and features beyond f are masked at
// the loads (read as 0; by the TMA unit at the bf16 tiers) and in the
// epilogue (K := 0), so callers need not pad to tile multiples.  The bf16
// tiers need f % 8 == 0 (TMA's 16-byte row stride): the wrapper pads the
// bf16 operands' feature axis with zeros.
//
// Each C entry point takes the tier (exact 0, bf16x3 1, bf16cast 2) and the
// operand pointers for it: X float32 at exact; X = hi and X_lo = lo (bf16)
// at bf16x3; X = bf16(X) and X_lo = NULL at bf16cast.  It launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().  The Gram tiles, the transform and the slab reduction
// live in gram_tile.cuh and gram_tile_wgmma.cuh.

#include "gram_tile.cuh"
#include "gram_tile_wgmma.cuh"

namespace {

// K1: one CTA per lower-triangular tile pair t -> (i, j), j <= i.
__global__ void __launch_bounds__(THREADS, 2)
gram_matvec_sym_kernel(const float* __restrict__ X, const float* __restrict__ sq,
                       const float* __restrict__ v, int D, int f, int nb, bool vec4,
                       KernelParams p, float* __restrict__ slab) {
    int i, j;
    tri_pair(blockIdx.x, i, j);
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

// K1's bf16 tiers: the wgmma tile walk over the lower-triangular pairs.
template <int NPROD>
cudaError_t launch_sym_bf16(const void* X, const void* X_lo, const float* sq, const float* v,
                            int D, int f, int nb, long long pairs, KernelParams p, float* slab,
                            cudaStream_t s) {
    TileArgs args{sq, sq, v, v, slab, nullptr, D, D, nb, nb, 0, pairs, p};
    return launch_gram_wgmma<NPROD, TILE_SYM>(X, X_lo, X, X_lo, f, args, s);
}

}  // namespace

extern "C" {

// K1: out (D,) = K(X, X) v.  X (D, f) row-major (float32 at tier 0, bf16 hi
// with X_lo the bf16 lo at tier 1, bf16 at tier 2; f % 8 == 0 and 16-byte
// aligned bases at tiers 1 and 2, else cudaErrorInvalidValue), sq (D,) = row
// norms |x|^2 of the float32 rows, v (D,), slab (nb, nb, BM) scratch with
// nb = ceil(D / BM).
int gram_matvec_sym(int tier, const void* X, const void* X_lo, const float* sq,
                    const float* v, float* slab, float* out, int D, int f, int kernel,
                    int degree, float gamma, float coef0, void* stream) {
    const int nb = (D + BM - 1) / BM;
    const long long pairs = (long long)nb * (nb + 1) / 2;
    const KernelParams p{kernel, degree, gamma, coef0};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (tier == 0) {
        const bool vec4 = (f % 4 == 0) && aligned16(X);
        gram_matvec_sym_kernel<<<(unsigned)pairs, THREADS, 0, s>>>(
            static_cast<const float*>(X), sq, v, D, f, nb, vec4, p, slab);
        err = cudaGetLastError();
    } else if (tier == 1) {
        err = launch_sym_bf16<3>(X, X_lo, sq, v, D, f, nb, pairs, p, slab, s);
    } else if (tier == 2) {
        err = launch_sym_bf16<1>(X, nullptr, sq, v, D, f, nb, pairs, p, slab, s);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    reduce_slab_kernel<<<(D + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, s>>>(
        slab, nb, D, out);
    return (int)cudaGetLastError();
}

// K2: out (D,) = K(X, Y) v.  X (D, f), Y (N, f) row-major at the tier's
// types and with its demands on f and the bases (as gram_matvec_sym), sqx
// (D,), sqy (N,) row norms, v (N,), slab (nbi, nbj, BM) scratch with nbi =
// ceil(D / BM), nbj = ceil(N / BM).
int gram_matvec_rect(int tier, const void* X, const void* X_lo, const void* Y,
                     const void* Y_lo, const float* sqx, const float* sqy, const float* v,
                     float* slab, float* out, int D, int N, int f, int kernel, int degree,
                     float gamma, float coef0, void* stream) {
    const int nbi = (D + BM - 1) / BM;
    const int nbj = (N + BM - 1) / BM;
    const KernelParams p{kernel, degree, gamma, coef0};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (tier == 0) {
        const bool vec4 = (f % 4 == 0) && aligned16(X) && aligned16(Y);
        gram_matvec_rect_kernel<<<dim3(nbj, nbi), THREADS, 0, s>>>(
            static_cast<const float*>(X), static_cast<const float*>(Y), sqx, sqy, v, D, N, f,
            vec4, p, slab);
        err = cudaGetLastError();
    } else if (tier == 1) {
        err = launch_gram_wgmma_rows<3>(X, X_lo, Y, Y_lo, sqx, sqy, v, D, N, f, p, slab, s);
    } else if (tier == 2) {
        err = launch_gram_wgmma_rows<1>(X, nullptr, Y, nullptr, sqx, sqy, v, D, N, f, p, slab, s);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    reduce_slab_kernel<<<(D + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, s>>>(
        slab, nbj, D, out);
    return (int)cudaGetLastError();
}

// Lets the wrapper check that the library's tile size matches its own.
int gram_matvec_tile() { return BM; }

}  // extern "C"
