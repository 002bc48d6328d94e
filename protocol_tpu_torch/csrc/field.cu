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
// rows. They are not TPU kernels (add_mod replaces the jnp
// protocol_tpu/ops/fieldops.py::add_mod, sub_mod its sub_mod): the plain
// versions cost about a hundred torch launches each, and the recovery
// ladder runs thousands of them per chunk.
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
// Bound (NVIDIA H100 SXM, 3.35 TB/s; 64 integer multiply-adds per clock
// per SM × 132 SMs × 1.98 GHz, the CUDA C++ Programming Guide's table for
// compute capability 9.0). Per element each kernel moves 264 bytes (x
// and y read, out written: 3 × 22 int32); mont_mul also does 968 32-bit
// multiply-adds (2 × 22 × 22), add_mod and sub_mod 22 adds. The path
// runs them at three lane counts:
//
//     lanes      bytes bound   mont_mul operations
//     32,768     0.0026 ms     0.0019 ms   (an ingest recovery chunk)
//     262,144    0.0207 ms     0.0152 ms   (field_converge at N = 512)
//     819,200    0.0646 ms     0.0474 ms   (the Poseidon MDS step)
//
// Bytes bind every kernel at every size, mont_mul's operations close
// behind. At 32,768 lanes the grid is 512 blocks on 132 SMs: latency
// and launch, not a rate, decide there.
//
// Design. The first design gave each thread its own 88-byte row, read
// and written one int32 at a time: a warp's load then spans 2,816 bytes
// on 22 cache lines, and every kernel took the same time whatever its
// arithmetic, a fifth of the bytes bound. Now a block of kRows = 64
// threads owns 64 consecutive rows. Each operand's tile is 64 × 88 =
// 5,632 contiguous bytes in device memory, and it comes into shared
// memory in one bulk copy (cp.async.bulk, the TMA's 1-D form), issued by
// thread 0 and completing on an mbarrier; the result tile goes back the
// same way. Each thread reads its rows from shared memory in 8-byte
// pieces (read_row; mont_mul's x limbs two at a time, one piece every
// two CIOS steps): the row stride of 11 such pieces is odd, so the 16
// threads of each half-warp phase touch 32 distinct banks, with no
// conflict (a 4-byte read of a 22-word stride would conflict 2-way,
// gcd(22, 32) = 2). mont_mul reads its x limbs from shared memory inside
// the CIOS steps rather than holding all 22 in registers, which with
// __launch_bounds__(64, 16) keeps it at 64 registers with no spills. The
// arithmetic is the same as before, step for step; each result row goes
// back into the x tile. A tile whose address or length is not a multiple
// of 16 bytes (the ragged last tile of an odd row count; a view such as
// x[1:], 88 bytes into its storage) moves as coalesced 4-byte words by
// the threads instead, in the same kernel: the path is chosen per tile
// from the pointer and the rows. An operand whose rows are all one
// broadcast row (row stride 0, as fieldops.const_rows makes them) is
// read once per block: 22 words into shared memory, which every thread
// then reads as a broadcast. The bulk copy beat 16-byte words moved by
// the threads for mont_mul and matched them for add_mod; 64-row tiles
// beat 128-row ones at 32,768 lanes, where the recovery ladder runs
// them, and came within a few per cent at the larger sizes (PERF.md has
// the numbers).
//
// add_mod and sub_mod are one kernel body, staged as mont_mul is, with
// the operation a template argument; each keeps its arithmetic (add,
// ripple, conditional subtract of p; or the borrow test, a conditional
// +p, ripple).
//
// The modulus limbs and -p⁻¹ mod 2^12 are kernel arguments, so one binary
// serves every modulus (BN254 Fr and Fq, secp256k1 p and n). Any n ≥ 1
// works.
//
// Interface: one plain C function, loaded with ctypes. It launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBits = 12;
constexpr int kLimbs = 22;
constexpr int32_t kMask = (1 << kBits) - 1;
constexpr int kRows = 64;  // rows (and threads) of a staged block
constexpr int kTileWords = kRows * kLimbs;
// blocks per SM that mont_mul must fit: 64 registers a thread at most
constexpr int kMinBlocks = 65536 / (64 * kRows);

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

// one conditional subtract of p, then the carry pass (t normalised)
__device__ __forceinline__ void cond_sub_p(int32_t (&t)[kLimbs],
                                           const int32_t (&p)[kLimbs]) {
    if (geq(t, p)) {
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) t[j] -= p[j];
    }
    ripple<kLimbs>(t);
}

// one CIOS step: t ← (t + xi·y + u·p) / 2^12, u making the sum ≡ 0 mod 2^12
__device__ __forceinline__ void cios_step(uint32_t (&t)[kLimbs + 2],
                                          uint32_t xi,
                                          const int32_t (&ys)[kLimbs],
                                          const int32_t (&p)[kLimbs],
                                          uint32_t p_inv_neg) {
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

// xs is the x row in shared memory: steps 2k and 2k + 1 take their limbs
// from its k-th 8-byte piece, so the 22 limbs need no registers of their
// own and the reads are conflict-free
__device__ __forceinline__ void mont_mul_row(const int32_t *xs,
                                             const int32_t (&ys)[kLimbs],
                                             const Modulus &m,
                                             int32_t (&r)[kLimbs]) {
    int32_t p[kLimbs];
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) p[j] = m.p[j];
    const uint32_t p_inv_neg = (uint32_t)m.p_inv_neg;
    const int2 *x2 = reinterpret_cast<const int2 *>(xs);

    uint32_t t[kLimbs + 2];
#pragma unroll
    for (int j = 0; j < kLimbs + 2; ++j) t[j] = 0;
#pragma unroll
    for (int k = 0; k < kLimbs / 2; ++k) {
        const int2 q = x2[k];
        cios_step(t, (uint32_t)q.x, ys, p, p_inv_neg);
        cios_step(t, (uint32_t)q.y, ys, p, p_inv_neg);
    }
    int32_t full[kLimbs + 2];
#pragma unroll
    for (int j = 0; j < kLimbs + 2; ++j) full[j] = (int32_t)t[j];
    ripple<kLimbs + 2>(full);
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) r[j] = full[j];
    cond_sub_p(r, p);
}

enum Op { kMontMul = 0, kAddMod = 1, kSubMod = 2 };

// xs ← (xs + ys) mod p, or (xs − ys) mod p
template <int kOp>
__device__ __forceinline__ void add_sub_row(int32_t (&xs)[kLimbs],
                                            const int32_t (&ys)[kLimbs],
                                            const Modulus &m) {
    int32_t p[kLimbs];
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) p[j] = m.p[j];
    if (kOp == kAddMod) {
#pragma unroll
        for (int j = 0; j < kLimbs; ++j)
            xs[j] = (int32_t)((uint32_t)xs[j] + (uint32_t)ys[j]);
        ripple<kLimbs>(xs);
        cond_sub_p(xs, p);
    } else {
        const bool need_p = !geq(xs, ys);
#pragma unroll
        for (int j = 0; j < kLimbs; ++j)
            xs[j] = (int32_t)((uint32_t)xs[j] - (uint32_t)ys[j] +
                              (need_p ? (uint32_t)p[j] : 0u));
        ripple<kLimbs>(xs);
    }
}

// --- staging through shared memory -----------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void *p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// true where `words` int32 at `p` move as whole 16-byte units
__device__ __forceinline__ bool vec_ok(const int32_t *p, int words) {
    return ((reinterpret_cast<uintptr_t>(p) & 15) == 0) && ((words & 3) == 0);
}

// One operand's rows [r0, r0 + rows) into its tile by the block's threads,
// for a tile the bulk copy cannot take: one broadcast row (stride 0) as
// 22 words, else coalesced 4-byte words. The caller synchronises.
__device__ __forceinline__ void stage_in(int32_t *tile,
                                         const int32_t *__restrict__ src,
                                         int64_t stride, int64_t r0,
                                         int rows) {
    if (stride == 0) {
        if (threadIdx.x < kLimbs) tile[threadIdx.x] = __ldg(src + threadIdx.x);
        return;
    }
    const int32_t *g = src + r0 * kLimbs;
    const int words = rows * kLimbs;
    for (int k = threadIdx.x; k < words; k += kRows) tile[k] = __ldg(g + k);
}

// the result tile out as coalesced 4-byte words, where the bulk copy
// cannot take it
__device__ __forceinline__ void stage_out(int32_t *__restrict__ dst,
                                          const int32_t *tile, int64_t r0,
                                          int rows) {
    int32_t *g = dst + r0 * kLimbs;
    const int words = rows * kLimbs;
    for (int k = threadIdx.x; k < words; k += kRows) g[k] = tile[k];
}

// a thread's row of a tile (row 0 of a broadcast tile), in 8-byte pieces:
// conflict-free, since the 11-piece row stride is odd
__device__ __forceinline__ void read_row(const int32_t *tile, int r,
                                         int32_t (&v)[kLimbs]) {
    const int2 *row = reinterpret_cast<const int2 *>(tile + r * kLimbs);
#pragma unroll
    for (int j = 0; j < kLimbs / 2; ++j) {
        const int2 q = row[j];
        v[2 * j] = q.x;
        v[2 * j + 1] = q.y;
    }
}

__device__ __forceinline__ void write_row(int32_t *tile, int r,
                                          const int32_t (&v)[kLimbs]) {
    int2 *row = reinterpret_cast<int2 *>(tile + r * kLimbs);
#pragma unroll
    for (int j = 0; j < kLimbs / 2; ++j) row[j] = make_int2(v[2 * j], v[2 * j + 1]);
}

// one bulk copy (TMA, no tensor map) of `bytes` into shared memory,
// completing on the block's mbarrier
__device__ __forceinline__ void bulk_in(int32_t *tile, const int32_t *g,
                                        uint32_t bytes, uint64_t *bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(tile)),
        "l"(g), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// Stage x and y of this block's rows into xt and yt; on return every
// thread may read both tiles. A tile that vec_ok allows comes in one bulk
// copy issued by thread 0; the others come through stage_in.
__device__ __forceinline__ void load_tiles(int32_t *xt, int32_t *yt,
                                           const int32_t *__restrict__ x,
                                           int64_t sx,
                                           const int32_t *__restrict__ y,
                                           int64_t sy, int64_t r0, int rows) {
    __shared__ __align__(8) uint64_t bar;
    const int words = rows * kLimbs;
    const uint32_t bytes = (uint32_t)words * 4u;
    const int32_t *gx = x + r0 * kLimbs, *gy = y + r0 * kLimbs;
    const bool bx = sx != 0 && vec_ok(gx, words);
    const bool by = sy != 0 && vec_ok(gy, words);
    const uint32_t b = smem_addr(&bar);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                     : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
            "r"(bytes * ((bx ? 1u : 0u) + (by ? 1u : 0u)))
            : "memory");
        if (bx) bulk_in(xt, gx, bytes, &bar);
        if (by) bulk_in(yt, gy, bytes, &bar);
    }
    if (!bx) stage_in(xt, x, sx, r0, rows);
    if (!by) stage_in(yt, y, sy, r0, rows);
    __syncthreads();  // the barrier is initialised before anyone waits
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(b), "r"(0u)
            : "memory");
    }
}

// Store the result tile (in xt, every thread's row written): one bulk copy
// by thread 0 where vec_ok allows it, else through stage_out.
__device__ __forceinline__ void store_tile(int32_t *__restrict__ out,
                                           int32_t *xt, int64_t r0, int rows) {
    const int words = rows * kLimbs;
    int32_t *g = out + r0 * kLimbs;
    if (vec_ok(g, words)) {
        // the threads' writes to xt become visible to the bulk copy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (threadIdx.x == 0) {
            asm volatile(
                "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], "
                "%2;\n" ::"l"(g),
                "r"(smem_addr(xt)), "r"((uint32_t)words * 4u)
                : "memory");
            asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
            // xt stays allocated until the copy has read it
            asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        return;
    }
    __syncthreads();
    stage_out(out, xt, r0, rows);
}

__global__ void __launch_bounds__(kRows, kMinBlocks)
mont_mul_kernel(const int32_t *__restrict__ x, int64_t sx,
                const int32_t *__restrict__ y, int64_t sy,
                int32_t *__restrict__ out, int64_t n, Modulus m) {
    __shared__ __align__(16) int32_t xt[kTileWords];
    __shared__ __align__(16) int32_t yt[kTileWords];
    const int64_t r0 = (int64_t)blockIdx.x * kRows;
    const int rows = (int)(n - r0 < kRows ? n - r0 : kRows);
    load_tiles(xt, yt, x, sx, y, sy, r0, rows);
    const int r = threadIdx.x;
    const bool live = r < rows;
    int32_t res[kLimbs];
    if (live) {
        int32_t ys[kLimbs];
        read_row(yt, sy ? r : 0, ys);
        mont_mul_row(xt + (sx ? r : 0) * kLimbs, ys, m, res);
    }
    __syncthreads();  // every read of xt is done before it takes results
    if (live) write_row(xt, r, res);
    store_tile(out, xt, r0, rows);
}

template <int kOp>
__global__ void __launch_bounds__(kRows)
add_sub_kernel(const int32_t *__restrict__ x, int64_t sx,
               const int32_t *__restrict__ y, int64_t sy,
               int32_t *__restrict__ out, int64_t n, Modulus m) {
    __shared__ __align__(16) int32_t xt[kTileWords];
    __shared__ __align__(16) int32_t yt[kTileWords];
    const int64_t r0 = (int64_t)blockIdx.x * kRows;
    const int rows = (int)(n - r0 < kRows ? n - r0 : kRows);
    load_tiles(xt, yt, x, sx, y, sy, r0, rows);
    const int r = threadIdx.x;
    const bool live = r < rows;
    int32_t xs[kLimbs];
    if (live) {
        int32_t ys[kLimbs];
        read_row(xt, sx ? r : 0, xs);
        read_row(yt, sy ? r : 0, ys);
        add_sub_row<kOp>(xs, ys, m);
    }
    __syncthreads();
    if (live) write_row(xt, r, xs);
    store_tile(out, xt, r0, rows);
}

}  // namespace

extern "C" {

// op: 0 mont_mul, 1 add_mod, 2 sub_mod. x and y are (n, 22) int32 arrays
// on the device with row strides sx and sy in int32 (22, or 0 for one
// row broadcast to all n); out is a contiguous (n, 22) array; p_limbs is
// a host array of the modulus's 22 limbs; p_inv_neg is read by mont_mul
// only. Returns 0, a cudaError_t from the launch, or -1 for a bad
// argument.
int field_launch(int op, const int32_t *x, int64_t sx, const int32_t *y,
                 int64_t sy, int32_t *out, int64_t n, const int32_t *p_limbs,
                 int32_t p_inv_neg, void *stream) {
    if (n < 1 || p_limbs == nullptr) return -1;
    if ((sx != 0 && sx != kLimbs) || (sy != 0 && sy != kLimbs)) return -1;
    Modulus m;
    for (int j = 0; j < kLimbs; ++j) m.p[j] = p_limbs[j];
    m.p_inv_neg = p_inv_neg;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t tiles = (n + kRows - 1) / kRows;
    if (tiles > (int64_t)0x7fffffff) return -1;
    switch (op) {
        case kMontMul:
            mont_mul_kernel<<<(unsigned)tiles, kRows, 0, s>>>(x, sx, y, sy,
                                                              out, n, m);
            break;
        case kAddMod:
            add_sub_kernel<kAddMod><<<(unsigned)tiles, kRows, 0, s>>>(
                x, sx, y, sy, out, n, m);
            break;
        case kSubMod:
            add_sub_kernel<kSubMod><<<(unsigned)tiles, kRows, 0, s>>>(
                x, sx, y, sy, out, n, m);
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
