// Lane permutation: one stage of a Clos route, for Hopper (sm_90a).
//
// Replaces the TPU kernel protocol_tpu/ops/clos.py::_lane_perm_pallas
// (Mosaic tpu.dynamic_gather over 1024-row tiles). It computes, for x and
// idx viewed as [T, 128],
//
//     out[r, j] = x[r, idx[r, j]]
//
// a gather inside each 128-lane row. Every stage of both routes of a routed
// sweep runs it (ops/clos.py route_core).
//
// Bound: device memory. Each element is read once (4 or 8 bytes), its
// index once (1 byte) and written once (4 or 8 bytes): 9 bytes per element
// in float32, 17 in float64, and no arithmetic to speak of. The least time
// is those bytes over the card's memory rate.
//
// Design, simple first: one block owns a tile of whole rows (16 KB of
// data). It copies the tile into shared memory with 16-byte loads, reads
// four indices at a time as one uchar4, gathers the four values from
// shared memory and writes them back as consecutive elements. Global
// traffic is therefore coalesced on every side; the random part of the
// access pattern stays in shared memory. Any T >= 1 works: the last tile
// may hold fewer rows. Fusing the transposes between stages into the
// kernel (as the host replay clos_apply_route does) is left for later.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kTileBytes = 16384;

template <typename T>
struct Store4;

template <>
struct Store4<float> {
    __device__ static void run(float *p, float a, float b, float c, float d) {
        *reinterpret_cast<float4 *>(p) = make_float4(a, b, c, d);
    }
};

template <>
struct Store4<int32_t> {
    __device__ static void run(int32_t *p, int32_t a, int32_t b, int32_t c,
                               int32_t d) {
        *reinterpret_cast<int4 *>(p) = make_int4(a, b, c, d);
    }
};

template <>
struct Store4<double> {
    __device__ static void run(double *p, double a, double b, double c,
                               double d) {
        reinterpret_cast<double2 *>(p)[0] = make_double2(a, b);
        reinterpret_cast<double2 *>(p)[1] = make_double2(c, d);
    }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
lane_perm_kernel(const T *__restrict__ x, const uint8_t *__restrict__ idx,
                 T *__restrict__ out, int64_t rows) {
    constexpr int kRows = kTileBytes / (kLanes * (int)sizeof(T));
    __shared__ __align__(16) T tile[kRows * kLanes];

    const int64_t row0 = (int64_t)blockIdx.x * kRows;
    const int64_t left = rows - row0;
    const int n = (int)(left < kRows ? left : kRows) * kLanes;
    const int64_t base = row0 * kLanes;

    // 1. the tile's rows into shared memory, 16 bytes per load
    const int4 *xv = reinterpret_cast<const int4 *>(x + base);
    int4 *tv = reinterpret_cast<int4 *>(tile);
    const int nv = n * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < nv; i += kThreads) tv[i] = __ldg(xv + i);
    __syncthreads();

    // 2. four outputs per step: one uchar4 of indices, four shared reads,
    //    one (or two) 16-byte stores
    const uchar4 *iv = reinterpret_cast<const uchar4 *>(idx + base);
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
        const uchar4 q = __ldg(iv + i);
        const T *row = tile + ((4 * i) & ~(kLanes - 1));
        Store4<T>::run(out + base + 4 * i, row[q.x], row[q.y], row[q.z],
                       row[q.w]);
    }
}

template <typename T>
int launch(const void *x, const uint8_t *idx, void *out, int64_t rows,
           cudaStream_t stream) {
    constexpr int kRows = kTileBytes / (kLanes * (int)sizeof(T));
    const int64_t blocks = (rows + kRows - 1) / kRows;
    lane_perm_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T *>(x), idx, static_cast<T *>(out), rows);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64, 2 int32. x, idx and out are contiguous
// [rows, 128] arrays on the device, each 16-byte aligned; rows >= 1.
// Returns 0, a cudaError_t from the launch, or -1 for a bad argument.
int lane_perm(int dtype, const void *x, const uint8_t *idx, void *out,
              int64_t rows, void *stream) {
    if (rows < 1 || rows > (int64_t)0x7fffffff) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<float>(x, idx, out, rows, s);
        case 1: return launch<double>(x, idx, out, rows, s);
        case 2: return launch<int32_t>(x, idx, out, rows, s);
        default: return -1;
    }
}

const char *lane_perm_error_string(int code) {
    if (code == -1) return "lane_perm: bad argument";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
