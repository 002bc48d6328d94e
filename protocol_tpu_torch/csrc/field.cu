// Field kernels for Hopper (sm_90a): the Montgomery multiply and the
// modular add and subtract of the batched field engine.
//
// mont_mul replaces the TPU kernel
// protocol_tpu/ops/pallas_kernels.py::_mont_mul_kernel (called through
// pallas_mont_mul). For each element i of a batch it computes
//
//     out[i] = x[i] · y[i] · R⁻¹ mod p,   R = 2^264,
//
// on field elements stored as 22 little-endian limbs of 12 bits in int32
// rows: the layout, the radix and R of protocol_tpu_torch/ops/fieldops.py,
// which every caller's Montgomery form depends on. x may hold a lazy sum
// of canonical values (below R, e.g. up to 512·p for BN254 Fr); y is
// canonical. The output is canonical, in [0, p).
//
// add_mod and sub_mod compute (x + y) mod p and (x − y) mod p on the same
// rows. They are not TPU kernels: the plain versions cost about a hundred
// torch launches each (a carry ripple and a limb compare), and the
// recovery ladder runs thousands of them per chunk, so in one launch each
// they keep the card from waiting on the host.
//
// Arithmetic. mont_mul is the CIOS of fieldops.mont_mul, step for step:
// 22 steps, each adding x_s·y and u·p into a 24-limb accumulator without
// carrying (every partial sum stays below 2^30), the quotient digit u
// taken from the low 12 bits of limb 0, which are exact despite the
// deferred carries, then one carry pass and one conditional subtract of
// p. The limb sums are kept in uint32 (wrapping like the reference's
// int32, where signed overflow would be undefined); shifts of carries are
// arithmetic on the signed value. The carry pass here runs from the low
// limb up, in 64 bits; it gives the same digits as the reference's 22
// parallel passes (both compute the value mod 2^(12·width) with every
// limb in [0, 4096)), so the output is bit-identical to the plain
// version for any normalised input.
//
// Bound. Per element mont_mul moves 264 bytes (x and y read, out written:
// 3 × 22 int32) and does 968 32-bit multiply-adds (2 × 22 × 22). At
// 262,144 elements that is 69 MB, 21 µs at the H100's 3.35 TB/s (data
// sheet), against 254M multiply-adds, 15 µs at 64 integer multiply-adds
// per clock per SM (the CUDA C++ Programming Guide's throughput table for
// compute capability 9.0) × 132 SMs × 1.98 GHz: the bytes bind, though
// barely. add_mod and sub_mod move the same 264 bytes and do 22 adds:
// bytes bind.
//
// Design, simple first: one thread per element. It reads its two rows of
// the row-major (n, 22) tensors (a warp's rows are contiguous, so L1
// serves the strided reads), keeps x, y and the accumulator in registers
// for all 22 steps, and writes its row. The modulus limbs and -p⁻¹ mod
// 2^12 are kernel arguments, so one binary serves every modulus (BN254 Fr
// and Fq, secp256k1 p and n). Any n ≥ 1 works.
//
// Interface: one plain C function, loaded with ctypes. It launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBits = 12;
constexpr int kLimbs = 22;
constexpr int32_t kMask = (1 << kBits) - 1;
constexpr int kThreads = 128;

struct Modulus {
    int32_t p[kLimbs];
    int32_t p_inv_neg;  // -p^{-1} mod 2^12
};

// t ← t mod 2^(12·W) with every limb in [0, 2^12): a carry pass from the
// low limb up. The carry is kept in 64 bits and shifted arithmetically, so
// negative limbs (borrows) come out as the reference's ripple gives them.
template <int W>
__device__ __forceinline__ void ripple(int32_t (&t)[W]) {
    int64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
        const int64_t v = (int64_t)t[j] + c;
        t[j] = (int32_t)(v & kMask);
        c = v >> kBits;
    }
}

// a >= b, lexicographic from the top limb (signed limb compare, as the
// reference's _geq).
__device__ __forceinline__ bool geq(const int32_t (&a)[kLimbs],
                                    const int32_t (&b)[kLimbs]) {
    bool gt = false, eq = true;
#pragma unroll
    for (int j = kLimbs - 1; j >= 0; --j) {
        gt = gt || (eq && a[j] > b[j]);
        eq = eq && a[j] == b[j];
    }
    return gt || eq;
}

__device__ __forceinline__ void load_row(const int32_t *__restrict__ src,
                                         int64_t i, int32_t (&r)[kLimbs]) {
    const int32_t *row = src + i * kLimbs;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) r[j] = __ldg(row + j);
}

__device__ __forceinline__ void store_row(int32_t *__restrict__ dst,
                                          int64_t i,
                                          const int32_t (&r)[kLimbs]) {
    int32_t *row = dst + i * kLimbs;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) row[j] = r[j];
}

// one conditional subtract of p, then the carry pass (t normalised)
__device__ __forceinline__ void cond_sub_p(int32_t (&t)[kLimbs],
                                           const int32_t (&p)[kLimbs]) {
    if (geq(t, p)) {
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) t[j] -= p[j];
    }
    ripple<kLimbs>(t);
}

__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const int32_t *__restrict__ x, const int32_t *__restrict__ y,
                int32_t *__restrict__ out, int64_t n, Modulus m) {
    const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    int32_t xs[kLimbs], ys[kLimbs], p[kLimbs];
    load_row(x, i, xs);
    load_row(y, i, ys);
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) p[j] = m.p[j];
    const uint32_t p_inv_neg = (uint32_t)m.p_inv_neg;

    uint32_t t[kLimbs + 2];
#pragma unroll
    for (int j = 0; j < kLimbs + 2; ++j) t[j] = 0;
#pragma unroll
    for (int s = 0; s < kLimbs; ++s) {
        const uint32_t xi = (uint32_t)xs[s];
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) t[j] += xi * (uint32_t)ys[j];
        const uint32_t u = ((t[0] & kMask) * p_inv_neg) & kMask;
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) t[j] += u * (uint32_t)p[j];
        // t ≡ 0 mod 2^12 now: shift one limb down, keeping the carry
        const uint32_t carry0 = (uint32_t)((int32_t)t[0] >> kBits);
#pragma unroll
        for (int j = 0; j < kLimbs + 1; ++j) t[j] = t[j + 1];
        t[kLimbs + 1] = 0;
        t[0] += carry0;
    }
    int32_t full[kLimbs + 2];
#pragma unroll
    for (int j = 0; j < kLimbs + 2; ++j) full[j] = (int32_t)t[j];
    ripple<kLimbs + 2>(full);
    int32_t r[kLimbs];
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) r[j] = full[j];
    cond_sub_p(r, p);
    store_row(out, i, r);
}

__global__ void __launch_bounds__(kThreads)
add_mod_kernel(const int32_t *__restrict__ x, const int32_t *__restrict__ y,
               int32_t *__restrict__ out, int64_t n, Modulus m) {
    const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    int32_t xs[kLimbs], ys[kLimbs], p[kLimbs];
    load_row(x, i, xs);
    load_row(y, i, ys);
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) {
        p[j] = m.p[j];
        xs[j] = (int32_t)((uint32_t)xs[j] + (uint32_t)ys[j]);
    }
    ripple<kLimbs>(xs);
    cond_sub_p(xs, p);
    store_row(out, i, xs);
}

__global__ void __launch_bounds__(kThreads)
sub_mod_kernel(const int32_t *__restrict__ x, const int32_t *__restrict__ y,
               int32_t *__restrict__ out, int64_t n, Modulus m) {
    const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    int32_t xs[kLimbs], ys[kLimbs];
    load_row(x, i, xs);
    load_row(y, i, ys);
    const bool need_p = !geq(xs, ys);
#pragma unroll
    for (int j = 0; j < kLimbs; ++j)
        xs[j] = (int32_t)((uint32_t)xs[j] - (uint32_t)ys[j] +
                          (need_p ? (uint32_t)m.p[j] : 0u));
    ripple<kLimbs>(xs);
    store_row(out, i, xs);
}

}  // namespace

extern "C" {

// op: 0 mont_mul, 1 add_mod, 2 sub_mod. x, y and out are contiguous
// (n, 22) int32 arrays on the device; p_limbs is a host array of the
// modulus's 22 limbs; p_inv_neg is read by mont_mul only.
// Returns 0, a cudaError_t from the launch, or -1 for a bad argument.
int field_launch(int op, const int32_t *x, const int32_t *y, int32_t *out,
                 int64_t n, const int32_t *p_limbs, int32_t p_inv_neg,
                 void *stream) {
    if (n < 1 || p_limbs == nullptr) return -1;
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > (int64_t)0x7fffffff) return -1;
    Modulus m;
    for (int j = 0; j < kLimbs; ++j) m.p[j] = p_limbs[j];
    m.p_inv_neg = p_inv_neg;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (op) {
        case 0:
            mont_mul_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(x, y, out,
                                                                  n, m);
            break;
        case 1:
            add_mod_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(x, y, out,
                                                                 n, m);
            break;
        case 2:
            sub_mod_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(x, y, out,
                                                                 n, m);
            break;
        default:
            return -1;
    }
    return (int)cudaGetLastError();
}

const char *field_error_string(int code) {
    if (code == -1) return "field kernel: bad argument";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
