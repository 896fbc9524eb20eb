// The light columns' pairs of the sparse gram tier's Gram, and the tier's
// products with the last point, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package forms this Gram with one XLA
// product of the densified rows (plssvm_sparse_fp22_tpu/models/base.py:
// 944-950), and the products with the last point on the host with scipy
// (:956-957); on the card that product multiplies zeros almost only (rcv1's
// rows are 0.16 % dense).  The port splits the columns by their counts
// (ops/sparse_gram.py): the few heavy ones go to a dense slab whose product
// writes G, and this kernel adds the products of the light columns' entries
// into G, pair by pair, from the rows' light entries (CSR) and the light
// columns' lists (CSC), both built on the card.
//
// What it computes, bit for bit what sparse_gram_pairs_plain computes on the
// same G: for each row i < rows and each light entry (k, v) of row i, in
// stored order (ascending k), for each entry (j, w) of column k's list,
// G[i, j] = G[i, j] + v * w, the product and the sum each rounded to nearest
// (no fused multiply-add, so that the plain version's two roundings match).
//
// What bounds it on the H100: the pairs, sum over the light columns of
// count^2 updates (1.7e8 at rcv1's split), each reading one (j, w) of 8 bytes
// from the column lists, which stay in the 50 MB L2 (rcv1's light entries
// take ~10 MB), and updating one float in shared memory; beside them the
// Gram's rows that hold a light entry, read once and written once (2 x 4 x D
// bytes a row, 3.4 GB at rcv1's D = 20480: ~1 ms at 3.35 TB/s).  Few of the
// updates of one entry fill a block (most light columns hold tens of
// entries), so the latency of each entry's list, not the update rate, is
// what the design works on:
// - a block owns one row i, or one chunk of its columns where D floats exceed
//   shared memory, and keeps it in shared memory while it walks the row's
//   light entries; G is read and written once a row, coalesced, 16 bytes a
//   thread;
// - the threads of the block stride over one column's list at a time; the j
//   of one list are distinct, so no two threads update one float, and a
//   barrier between two entries fixes the order of the sums: the result is
//   the same bits on every run, with no atomics;
// - the bounds of a batch of entries' lists (and their values) are loaded at
//   once into shared memory, so an entry waits on one load, of its list, not
//   on three dependent ones;
// - rows without a light entry (padding rows, rows only in heavy columns) are
//   not touched at all.
// A chunked row narrows each list to the chunk by binary search (the lists
// hold their rows in ascending order).
//
// Beside it, the same tier's products with the last point, q[i] = <x_i, x_last>
// (sparse_rows_matvec): one warp a row, lane l summing the row's entries l,
// l + 32, ... in turn, then the 32 partial sums added in a fixed tree (halves
// first), each product and sum rounded to nearest; rows from `rows` on are
// written 0.  No atomics: the same bits on every run, and bit for bit what
// rows_matvec_plain computes.  It reads each entry once (12 bytes) and a
// gathered float of x_last, which stays in the L2: 21 MB at rcv1's 1.32 M
// entries, 0.006 ms at 3.35 TB/s.
//
// The C entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAIR_THREADS = 256;
constexpr int ROW_LANES = 32;                          // a warp a row
constexpr int ROWS_THREADS = 256;
constexpr int ROWS_PER_BLOCK = ROWS_THREADS / ROW_LANES;
constexpr int ENTRY_BATCH = PAIR_THREADS;  // entries whose list bounds are loaded at once

// first t in [lo, hi) with rows[t] >= x (the lists are ascending)
__device__ __forceinline__ long long lower_bound(const int* __restrict__ rows, long long lo,
                                                 long long hi, long long x) {
    while (lo < hi) {
        const long long mid = lo + (hi - lo) / 2;
        if (rows[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__global__ void __launch_bounds__(PAIR_THREADS)
sparse_gram_pairs_kernel(float* __restrict__ G, long long ld, int chunk,
                         const long long* __restrict__ rptr, const int* __restrict__ rcol,
                         const float* __restrict__ rval, const long long* __restrict__ cptr,
                         const int* __restrict__ crow, const float* __restrict__ cval,
                         bool vec) {
    extern __shared__ float4 row4[];  // the block's chunk of row i
    float* row = reinterpret_cast<float*>(row4);
    __shared__ long long lo_s[ENTRY_BATCH], hi_s[ENTRY_BATCH];
    __shared__ float v_s[ENTRY_BATCH];

    const long long i = blockIdx.x;
    const long long r0 = rptr[i], r1 = rptr[i + 1];
    if (r0 == r1) return;  // no light entry: G's row stays as the slab product wrote it
    const long long j0 = (long long)blockIdx.y * chunk;
    const int n = (int)min((long long)chunk, ld - j0);
    const bool chunked = gridDim.y > 1;
    float* g = G + i * ld + j0;

    if (vec) {
        for (int t = threadIdx.x; t < n / 4; t += PAIR_THREADS)
            row4[t] = reinterpret_cast<const float4*>(g)[t];
    } else {
        for (int t = threadIdx.x; t < n; t += PAIR_THREADS) row[t] = g[t];
    }

    for (long long b = r0; b < r1; b += ENTRY_BATCH) {
        const int m = (int)min((long long)ENTRY_BATCH, r1 - b);
        __syncthreads();  // the row is loaded; the last batch's bounds are read
        if (threadIdx.x < m) {
            const long long e = b + threadIdx.x;
            const int k = rcol[e];
            long long lo = cptr[k], hi = cptr[k + 1];
            if (chunked) {
                lo = lower_bound(crow, lo, hi, j0);
                hi = lower_bound(crow, lo, hi, j0 + n);
            }
            lo_s[threadIdx.x] = lo;
            hi_s[threadIdx.x] = hi;
            v_s[threadIdx.x] = rval[e];
        }
        __syncthreads();
        for (int q = 0; q < m; ++q) {
            const float v = v_s[q];
            const long long hi = hi_s[q];
            for (long long t = lo_s[q] + threadIdx.x; t < hi; t += PAIR_THREADS) {
                const int j = (int)(crow[t] - j0);
                row[j] = __fadd_rn(row[j], __fmul_rn(v, cval[t]));
            }
            __syncthreads();  // one entry's updates before the next one's
        }
    }

    if (vec) {
        for (int t = threadIdx.x; t < n / 4; t += PAIR_THREADS)
            reinterpret_cast<float4*>(g)[t] = row4[t];
    } else {
        for (int t = threadIdx.x; t < n; t += PAIR_THREADS) g[t] = row[t];
    }
}

__global__ void __launch_bounds__(ROWS_THREADS)
sparse_rows_matvec_kernel(float* __restrict__ q, long long D, long long rows,
                          const long long* __restrict__ rptr,
                          const long long* __restrict__ cols,
                          const float* __restrict__ vals, const float* __restrict__ x) {
    const long long i = (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / ROW_LANES;
    const int lane = threadIdx.x % ROW_LANES;
    if (i >= D) return;  // the whole warp: i is the warp's
    float acc = 0.0f;
    if (i < rows) {
        const long long end = rptr[i + 1];
        for (long long e = rptr[i] + lane; e < end; e += ROW_LANES)
            acc = __fadd_rn(acc, __fmul_rn(vals[e], x[cols[e]]));
    }
    for (int off = ROW_LANES / 2; off > 0; off /= 2)
        acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if (lane == 0) q[i] = acc;
}

bool is_aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// G (ld, ld) float32, row-major and contiguous: adds the light pairs of rows
// 0 .. rows - 1 (see the note above) into it.  rptr (rows + 1) int64 with
// rcol int32 and rval float32: the rows' light entries; cptr (f + 1) int64
// with crow int32 (ascending within a column, each < ld) and cval float32:
// the light columns' lists.  max_chunk > 0 caps a block's chunk of a row
// (floats) below what shared memory holds, so that a small G takes the
// chunked walk too; 0 leaves it at that.  cudaErrorInvalidValue for negative
// sizes or a grid beyond the card's limits.
int sparse_gram_pairs(float* G, long long ld, int rows, const long long* rptr, const int* rcol,
                      const float* rval, const long long* cptr, const int* crow,
                      const float* cval, long long max_chunk, void* stream) {
    if (ld < 0 || rows < 0 || rows > ld || max_chunk < 0) return (int)cudaErrorInvalidValue;
    if (rows == 0 || ld == 0) return (int)cudaSuccess;
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, sparse_gram_pairs_kernel);
    if (err != cudaSuccess) return (int)err;
    // the widest chunk of a row, a multiple of 4 floats, that shared memory holds
    long long widest = ((long long)(optin - (int)attr.sharedSizeBytes) / 4) & ~3ll;
    if (widest < 4) return (int)cudaErrorInvalidValue;
    if (max_chunk > 0 && max_chunk < widest) widest = max_chunk;
    const long long chunk = ld <= widest ? ld : widest;
    const long long chunks = (ld + chunk - 1) / chunk;
    if (chunks > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)chunk * 4;
    err = cudaFuncSetAttribute(sparse_gram_pairs_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const bool vec = (ld % 4 == 0) && (chunk % 4 == 0) && is_aligned16(G);
    const dim3 grid((unsigned)rows, (unsigned)chunks);
    sparse_gram_pairs_kernel<<<grid, PAIR_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        G, ld, (int)chunk, rptr, rcol, rval, cptr, crow, cval, vec);
    return (int)cudaGetLastError();
}

// q (D) float32: q[i] = sum over row i's entries e of vals[e] * x[cols[e]] for
// i < rows (rptr (rows + 1) int64, cols int64 indices into x, vals float32),
// 0 for rows <= i < D.  cudaErrorInvalidValue for negative sizes, rows > D or
// a grid beyond the card's limits.
int sparse_rows_matvec(float* q, long long D, long long rows, const long long* rptr,
                       const long long* cols, const float* vals, const float* x,
                       void* stream) {
    if (D < 0 || rows < 0 || rows > D) return (int)cudaErrorInvalidValue;
    if (D == 0) return (int)cudaSuccess;
    const long long blocks = (D + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    if (blocks > 2147483647ll) return (int)cudaErrorInvalidValue;
    sparse_rows_matvec_kernel<<<(unsigned)blocks, ROWS_THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(q, D, rows, rptr, cols,
                                                                     vals, x);
    return (int)cudaGetLastError();
}

}  // extern "C"
