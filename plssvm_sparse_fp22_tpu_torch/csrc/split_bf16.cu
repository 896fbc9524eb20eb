// The bf16x3 tier's operand split in one pass, for NVIDIA Hopper (sm_90a).
//
// Replaces _split_bf16 (plssvm_sparse_fp22_tpu/ops/pallas_matvec.py:282-290),
// the operand arm of the bf16x3 tier of every Pallas kernel body there: XLA
// fuses its mask, subtraction and casts into one pass over X; eager PyTorch
// runs them as nine elementwise passes and two padding copies, which this
// kernel folds back into one.
//
// What it computes, bit for bit what split_bf16_plain (ops/gram_matvec.py)
// computes: for each float32 x, hi = the upper 16 bits of x as a bf16 (a
// truncation, so hi is exact in bf16) and lo = x - hi rounded to bf16 to
// nearest even; the subtraction is exact in f32.  As in the JAX package,
// whose subtraction flushes denormals, a subnormal remainder becomes a zero
// of its sign and a subnormal x gives lo = +0.  inf and NaN follow the same
// arithmetic: x = inf gives hi = inf, lo = NaN (inf - inf); a NaN whose
// payload lies in the lower 16 bits alone gives hi = inf, lo = NaN.  Both
// parts are written into (rows, fp) buffers, fp >= f, columns f..fp zero:
// the feature axis padded to the TMA box of the wgmma tile, so the caller
// makes no padding copy.
//
// What bounds it on the H100: bytes.  4 bytes read and 4 written per value
// (8 (rows x f) + the pad), against some ten operations: 134 MB for a 4096 x
// 4096 panel, 0.040 ms at 3.35 TB/s.  So the design is about memory
// transactions only: a thread takes 8 consecutive features of one row, two
// 16-byte loads and one 16-byte store to each part, neighbouring threads on
// neighbouring addresses; a ragged f or a misaligned base falls back to
// scalar loads (and a ragged fp to scalar stores) element by element.  No
// shared memory, no reduction, no order to keep.
//
// The arithmetic uses the _rn intrinsics, so no compiler flag can contract or
// reorder it, and the build sets neither -use_fast_math nor -ftz.
//
// The C entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int SPLIT_THREADS = 256;
constexpr int SPLIT_WIDTH = 8;  // features per thread: one 16-byte store per part

__device__ __forceinline__ void split_value(float x, uint32_t& hi, uint32_t& lo) {
    const float h = __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
    float r = __fsub_rn(x, h);
    if (fabsf(x) < FLT_MIN) {
        r = 0.0f;
    } else if (fabsf(r) < FLT_MIN) {
        r = __fmul_rn(r, 0.0f);  // a zero of r's sign
    }
    // the cast of h is exact unless h is a NaN, which the conversion makes
    // the canonical one, as PyTorch's cast does
    hi = __bfloat16_as_ushort(__float2bfloat16_rn(h));
    lo = __bfloat16_as_ushort(__float2bfloat16_rn(r));
}

__global__ void __launch_bounds__(SPLIT_THREADS)
split_bf16_kernel(const float* __restrict__ X, unsigned short* __restrict__ hi,
                  unsigned short* __restrict__ lo, long long rows, int f, int fp, int groups,
                  bool vec_in, bool vec_out) {
    const long long g = (long long)blockIdx.x * SPLIT_THREADS + threadIdx.x;
    if (g >= rows * groups) return;
    const long long row = g / groups;
    const int c0 = (int)(g % groups) * SPLIT_WIDTH;
    const float* src = X + row * f;

    float x[SPLIT_WIDTH];
#pragma unroll
    for (int h = 0; h < SPLIT_WIDTH / 4; ++h) {
        const int c = c0 + 4 * h;
        if (vec_in && c + 4 <= f) {
            // f % 4 == 0 and a 16-byte aligned base: the float4 is aligned
            const float4 q = *reinterpret_cast<const float4*>(src + c);
            x[4 * h] = q.x; x[4 * h + 1] = q.y; x[4 * h + 2] = q.z; x[4 * h + 3] = q.w;
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) x[4 * h + e] = (c + e < f) ? src[c + e] : 0.0f;
        }
    }

    uint32_t h16[SPLIT_WIDTH], l16[SPLIT_WIDTH];
#pragma unroll
    for (int e = 0; e < SPLIT_WIDTH; ++e) split_value(x[e], h16[e], l16[e]);

    const long long dst = row * fp + c0;
    if (vec_out) {
        // fp % 8 == 0 and 16-byte aligned bases: all 8 columns are in range
        *reinterpret_cast<uint4*>(hi + dst) =
            make_uint4(h16[0] | (h16[1] << 16), h16[2] | (h16[3] << 16),
                       h16[4] | (h16[5] << 16), h16[6] | (h16[7] << 16));
        *reinterpret_cast<uint4*>(lo + dst) =
            make_uint4(l16[0] | (l16[1] << 16), l16[2] | (l16[3] << 16),
                       l16[4] | (l16[5] << 16), l16[6] | (l16[7] << 16));
    } else {
#pragma unroll
        for (int e = 0; e < SPLIT_WIDTH; ++e) {
            if (c0 + e < fp) {
                hi[dst + e] = (unsigned short)h16[e];
                lo[dst + e] = (unsigned short)l16[e];
            }
        }
    }
}

bool is_aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// hi, lo (rows, fp) bf16 = the split of X (rows, f) float32, row-major and
// contiguous, fp >= f, columns f..fp zero.  cudaErrorInvalidValue for
// fp < f or more thread blocks than a grid holds.
int split_bf16_rows(const float* X, void* hi, void* lo, long long rows, int f, int fp,
                    void* stream) {
    if (rows < 0 || f < 0 || fp < f) return (int)cudaErrorInvalidValue;
    if (rows == 0 || fp == 0) return (int)cudaSuccess;
    const int groups = (fp + SPLIT_WIDTH - 1) / SPLIT_WIDTH;
    const long long blocks = (rows * groups + SPLIT_THREADS - 1) / SPLIT_THREADS;
    if (blocks > 2147483647ll) return (int)cudaErrorInvalidValue;
    const bool vec_in = (f % 4 == 0) && is_aligned16(X);
    const bool vec_out = (fp % SPLIT_WIDTH == 0) && is_aligned16(hi) && is_aligned16(lo);
    split_bf16_kernel<<<(unsigned)blocks, SPLIT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        X, static_cast<unsigned short*>(hi), static_cast<unsigned short*>(lo), rows, f, fp,
        groups, vec_in, vec_out);
    return (int)cudaGetLastError();
}

}  // extern "C"
