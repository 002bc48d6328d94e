// One stage of a Clos route, transpose included, for Hopper (sm_90a).
//
// Replaces the TPU kernel protocol_tpu/ops/clos.py::_lane_perm_pallas
// (Mosaic tpu.dynamic_gather over 1024-row tiles) together with the
// transposes that the reference's route_core runs between its calls. A
// route over E = B·2^e slots runs 2·levels − 1 stages (ops/clos.py
// route_core); with x, idx and out as [T, 128] rows, T = E / 128, and a
// forward or reverse stage's m (a power of two, T = B·m), each stage is
// one launch of one of three forms:
//
//     forward  out[b, j, r] = x[b, r, idx[b, r, j]]    x, idx as (B, m, 128)
//     middle   out[t, j]    = x[t, idx[t, j]]          (the TPU kernel)
//     reverse  out[b, r, l] = x[b, idx[b, r, l], r]    x as (B, 128, m)
//
// The forward form is a gather inside each 128-lane row that stores its
// result transposed; the reverse form loads transposed and then gathers.
// They are the loops of the host replay clos_apply_route
// (csrc/clos_plan.cpp). Indices are uint8, values float32, float64 or
// int32.
//
// Topic batch: x and out may hold K arrays of [T, 128] back to back that
// share one idx (K score vectors through one operator, the reference's
// vmap of the sweep). One launch runs the stage for all K: blockIdx.y
// picks the array, and the K blocks of a tile read the same index bytes.
// K = 1 runs an instantiation without that offset: compiled in, it made
// the single-vector stage 3-7 % slower on an H100
// (tools/torch_stage_ab.py).
//
// Bound: device memory. Each element is read once (4 or 8 bytes), its
// index once (1 byte) and written once: 9 bytes per element in float32,
// 17 in float64, and no arithmetic to speak of; a batch of K needs the
// index bytes once, 8K + 1 bytes per float32 element. The transpose
// adds no bytes, since it happens in shared memory. At the 1M-peer converge's
// edge route (T = 262,144, seven stages) the bound is 0.0901 ms a stage
// on an H100 SXM (3.35 TB/s); the state route's five stages (T = 8,192)
// are bound at 0.0028 ms, about a launch's fixed cost.
//
// Design. A block owns R consecutive rows (a 16 KB tile: 32 rows in
// float32 and int32, 16 in float64), so every global access is a
// coalesced 16-byte word and the random part of the access pattern stays
// in shared memory:
//
// - middle: the tile's rows come in as they lie; four indices are read
//   at a time as one uchar4, the four values gathered from the row in
//   shared memory and stored as consecutive elements.
// - forward: the rows come in as they lie, and so do the indices, into a
//   tile with a 33-word row pitch. Each thread then makes V outputs
//   (V = 16 bytes / element) that are consecutive in memory, in one
//   output row j at consecutive r where m ≥ V: it reads each output's
//   index down a column of the index tile (conflict-free: the pitch is
//   odd), gathers its value, and stores the V as one 16-byte word.
//   Where R ≤ m, each output row receives R consecutive elements
//   (128 bytes); where m < R, the tile holds R / m whole subproblems and
//   its output is one contiguous region.
// - reverse: the inverse of the forward store. The tile's source is R
//   consecutive elements of each of the 128 columns (or, where m < R,
//   one contiguous region), loaded as 16-byte words and written into the
//   tile transposed, at a 129-element row pitch, so that the 32 (or 16)
//   rows a warp writes at once fall in distinct banks. The gather then
//   runs as in the middle form.
//
// The same enumeration of a tile's (row, column) pairs serves the
// forward store and the reverse load (tposed below): consecutive numbers
// walk runs of s = min(R, m) consecutive rows of one column, which are
// consecutive addresses on the transposed side. Every m that a route
// produces works (a power of two ≥ 2), and any T that is a multiple of
// m; a ragged last tile holds whole subproblems.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kTileBytes = 16384;
constexpr int kIdxPitch = kLanes / 4 + 1;  // words of an index row, padded

enum Form { kForward = 0, kMiddle = 1, kReverse = 2 };

// V values as one 16-byte word
template <typename T>
union Vec {
    int4 raw;
    T v[16 / sizeof(T)];
};

// Number k of a tile's (row, column) pairs: its row rr and column c, and
// its offset from the start of the array on the transposed side, where
// row t of a subproblem b = t / m sits at b·128·m + c·m + t % m.
__device__ __forceinline__ int64_t tposed(int64_t t0, int k, int lg_s,
                                          int lg_m, int &rr, int &c) {
    c = (k >> lg_s) & (kLanes - 1);
    rr = ((k >> (lg_s + 7)) << lg_s) | (k & ((1 << lg_s) - 1));
    const int64_t t = t0 + rr;
    return ((t >> lg_m) << (lg_m + 7)) + ((int64_t)c << lg_m) +
           (t & ((int64_t(1) << lg_m) - 1));
}

template <typename T, int kForm, bool kBatch>
__global__ void __launch_bounds__(kThreads)
route_stage_kernel(const T *__restrict__ x, const uint8_t *__restrict__ idx,
                   T *__restrict__ out, int64_t rows, int lg_m) {
    constexpr int kRows = kTileBytes / (kLanes * (int)sizeof(T));
    constexpr int kLgRows = sizeof(T) == 8 ? 4 : 5;
    constexpr int kV = 16 / (int)sizeof(T);
    constexpr int kPitch = kForm == kReverse ? kLanes + 1 : kLanes;
    __shared__ __align__(16) T tile[kRows * kPitch];
    __shared__ uint32_t ids[kForm == kForward ? kRows * kIdxPitch : 1];

    if (kBatch) {  // blockIdx.y: one array of the batch, all sharing idx
        const int64_t shift = (int64_t)blockIdx.y * rows * kLanes;
        x += shift;
        out += shift;
    }
    const int64_t t0 = (int64_t)blockIdx.x * kRows;
    const int64_t left = rows - t0;
    const int n = (int)(left < kRows ? left : kRows) * kLanes;
    const int64_t base = t0 * kLanes;
    const int lg_s = lg_m < kLgRows ? lg_m : kLgRows;

    // 1. the tile into shared memory
    if (kForm == kReverse) {
        for (int k = threadIdx.x * kV; k < n; k += kThreads * kV) {
            int rr, c;
            Vec<T> w;
            w.raw = __ldg(reinterpret_cast<const int4 *>(
                x + tposed(t0, k, lg_s, lg_m, rr, c)));
#pragma unroll
            for (int v = 0; v < kV; ++v) {
                tposed(t0, k + v, lg_s, lg_m, rr, c);
                tile[rr * kPitch + c] = w.v[v];
            }
        }
    } else {
        const int4 *xv = reinterpret_cast<const int4 *>(x + base);
        int4 *tv = reinterpret_cast<int4 *>(tile);
        for (int i = threadIdx.x; i < n / kV; i += kThreads)
            tv[i] = __ldg(xv + i);
    }
    if (kForm == kForward) {
        const uint32_t *iw = reinterpret_cast<const uint32_t *>(idx + base);
        for (int i = threadIdx.x; i < n / 4; i += kThreads)
            ids[(i >> 5) * kIdxPitch + (i & 31)] = __ldg(iw + i);
    }
    __syncthreads();

    // 2. the outputs
    if (kForm == kForward) {
        const uint8_t *ib = reinterpret_cast<const uint8_t *>(ids);
        for (int k = threadIdx.x * kV; k < n; k += kThreads * kV) {
            int rr, c;
            const int64_t o = tposed(t0, k, lg_s, lg_m, rr, c);
            Vec<T> w;
#pragma unroll
            for (int v = 0; v < kV; ++v) {
                tposed(t0, k + v, lg_s, lg_m, rr, c);
                w.v[v] = tile[rr * kPitch + ib[rr * 4 * kIdxPitch + c]];
            }
            *reinterpret_cast<int4 *>(out + o) = w.raw;
        }
    } else {
        // four outputs a step: one uchar4 of indices, four shared reads
        const uchar4 *iv = reinterpret_cast<const uchar4 *>(idx + base);
        for (int i = threadIdx.x; i < n / 4; i += kThreads) {
            const uchar4 q = __ldg(iv + i);
            const T *row = tile + ((4 * i) >> 7) * kPitch;
            const T g[4] = {row[q.x], row[q.y], row[q.z], row[q.w]};
            Vec<T> w[4 / kV];
#pragma unroll
            for (int v = 0; v < 4; ++v) w[v / kV].v[v % kV] = g[v];
#pragma unroll
            for (int h = 0; h < 4 / kV; ++h)
                reinterpret_cast<int4 *>(out + base + 4 * i)[h] = w[h].raw;
        }
    }
}

template <typename T>
int launch(int form, const void *x, const uint8_t *idx, void *out,
           int64_t rows, int lg_m, int batch, cudaStream_t stream) {
    using Kernel = void (*)(const T *, const uint8_t *, T *, int64_t, int);
    const Kernel kernels[2][3] = {
        {route_stage_kernel<T, kForward, false>,
         route_stage_kernel<T, kMiddle, false>,
         route_stage_kernel<T, kReverse, false>},
        {route_stage_kernel<T, kForward, true>,
         route_stage_kernel<T, kMiddle, true>,
         route_stage_kernel<T, kReverse, true>}};
    if (form < kForward || form > kReverse) return -1;
    constexpr int kRows = kTileBytes / (kLanes * (int)sizeof(T));
    const int64_t blocks = (rows + kRows - 1) / kRows;
    const dim3 grid((unsigned)blocks, (unsigned)batch);
    kernels[batch > 1][form]<<<grid, kThreads, 0, stream>>>(
        static_cast<const T *>(x), idx, static_cast<T *>(out), rows, lg_m);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64, 2 int32; form: 0 forward, 1 middle,
// 2 reverse. idx is a contiguous [rows, 128] array on the device, x and
// out contiguous [batch, rows, 128] arrays, each 16-byte aligned;
// rows >= 1, 1 <= batch <= 65535. lg_m is log2 of the forward or reverse
// form's m, 1 <= lg_m, with rows a multiple of m; the middle form
// ignores it. Returns 0, a cudaError_t from the launch, or -1 for a bad
// argument.
int route_stage(int dtype, int form, const void *x, const uint8_t *idx,
                void *out, int64_t rows, int lg_m, int batch,
                void *stream) {
    if (rows < 1 || rows > (int64_t)0x7fffffff) return -1;
    if (batch < 1 || batch > 65535) return -1;
    if (form != kMiddle &&
        (lg_m < 1 || lg_m > 31 || (rows & ((int64_t(1) << lg_m) - 1))))
        return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0:
            return launch<float>(form, x, idx, out, rows, lg_m, batch, s);
        case 1:
            return launch<double>(form, x, idx, out, rows, lg_m, batch, s);
        case 2:
            return launch<int32_t>(form, x, idx, out, rows, lg_m, batch, s);
        default: return -1;
    }
}

const char *route_stage_error_string(int code) {
    if (code == -1) return "route_stage: bad argument";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
