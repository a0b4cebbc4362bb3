// Scaled copy of a run of rows whose start is read on the device:
//
//   out[r, c] = scale * x[row0[0] + r, c]    x (R, C), out (n_rows, C)
//
// Replaces the TPU kernels of examples/pallas_mosaic_repros.py, the Mosaic
// lowering repros of the structured kernel's building blocks:
//   :47  repro_reshape_merge — copy of (8, 4, 128) into (8, 512): the
//        merged view is contiguous, so row0 = 0, scale = 1;
//   :63  repro_dynslice_value — rows [i, i+8) of (16, 128) with i read from
//        SMEM: row0 from a device int32, scale = 1;
//   :86, :107, :128  repro_strip_loop{,_f32_carry,_pyint_bounds} — 2*x on
//        (8, 128) row by row; they differ only in the JAX loop-carry type,
//        which has no counterpart here: scale = 2.
//
// What bounds it on an H100: bytes, (n_rows*C read + n_rows*C written) /
// 3.35 TB/s, at sizes where bytes matter (0.04 ms for 134 MB moved). At the
// repros' 4-16 KB the device work is far below the launch latency, so the
// time of a call there is the host's: the wrapper's checks and its launch
// (femx_torch/launch.py), not this kernel.
//
// Design. The run of rows is contiguous in x and in out, so the copy is one
// flat stream of n_rows*C elements from x + row0*C. When a row is a whole
// number of 16-byte words and both pointers are 16-byte aligned (the host's
// test in launch() below), every thread moves 16-byte words (float4 or
// double2); otherwise one element at a time. A block of 256 threads moves
// 1,024 consecutive words, 4 per thread a block-width apart, all 4 loads
// issued before the stores; thread 0 reads row0 once per block into shared
// memory. On the H100 these one-pass blocks were no slower at 134 MB than a
// grid of 8 blocks per SM walking the stream, and need no SM count; they
// reach ~79 % of the bytes bound (chip_smoke.py). `scale * x` stays a
// multiply even for scale 1, so the result is bit-identical to the plain
// version's. row0 is trusted to keep the run inside x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;  // loads in flight per thread

__device__ __forceinline__ float4 scaled(float4 v, float s) {
  return make_float4(s * v.x, s * v.y, s * v.z, s * v.w);
}
__device__ __forceinline__ double2 scaled(double2 v, double s) {
  return make_double2(s * v.x, s * v.y);
}
__device__ __forceinline__ float scaled(float v, float s) { return s * v; }
__device__ __forceinline__ double scaled(double v, double s) { return s * v; }

// W is the unit of the copy (T, or its 16-byte vector); `row_units` units
// make one row of x
template <typename W, typename T>
__global__ void __launch_bounds__(kThreads)
row_copy_kernel(const W* __restrict__ x, const int32_t* __restrict__ row0,
                W* __restrict__ out, int64_t n_units, int64_t row_units, T scale) {
  __shared__ int64_t base;
  if (threadIdx.x == 0) base = static_cast<int64_t>(*row0) * row_units;
  __syncthreads();
  const W* __restrict__ src = x + base;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * (kThreads * kPerThread) + threadIdx.x;
  W v[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u)
    if (w0 + u * kThreads < n_units) v[u] = src[w0 + u * kThreads];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u)
    if (w0 + u * kThreads < n_units) out[w0 + u * kThreads] = scaled(v[u], scale);
}

template <typename W, typename T>
int launch_units(const T* x, const int32_t* row0, T* out, int64_t n_units, int64_t row_units,
                 T scale, cudaStream_t stream) {
  const int64_t blocks = (n_units + kThreads * kPerThread - 1) / (kThreads * kPerThread);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  row_copy_kernel<W, T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      reinterpret_cast<const W*>(x), row0, reinterpret_cast<W*>(out), n_units, row_units,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename V>
int launch(const T* x, const int32_t* row0, T* out, int64_t n_rows, int64_t cols, T scale,
           cudaStream_t stream) {
  const int64_t n_out = n_rows * cols;
  if (n_out == 0) return 0;
  constexpr int64_t kPer = sizeof(V) / sizeof(T);  // elements per 16-byte word
  if (cols % kPer == 0 && reinterpret_cast<uintptr_t>(x) % sizeof(V) == 0 &&
      reinterpret_cast<uintptr_t>(out) % sizeof(V) == 0)
    return launch_units<V, T>(x, row0, out, n_out / kPer, cols / kPer, scale, stream);
  return launch_units<T, T>(x, row0, out, n_out, cols, scale, stream);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int femx_row_copy_f32(const float* x, const int32_t* row0, float* out,
                      int64_t n_rows, int64_t cols, double scale,
                      cudaStream_t stream) {
  return launch<float, float4>(x, row0, out, n_rows, cols, static_cast<float>(scale), stream);
}

int femx_row_copy_f64(const double* x, const int32_t* row0, double* out,
                      int64_t n_rows, int64_t cols, double scale,
                      cudaStream_t stream) {
  return launch<double, double2>(x, row0, out, n_rows, cols, scale, stream);
}

}  // extern "C"
