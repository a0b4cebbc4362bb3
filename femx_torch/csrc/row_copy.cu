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
// 3.35 TB/s; at the repros' 4-16 KB the launch latency dominates.
//
// Design: one thread per output element, consecutive threads on consecutive
// addresses; every thread reads row0 (one broadcast load). row0 is trusted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_copy_kernel(const T* __restrict__ x, const int32_t* __restrict__ row0,
                T* __restrict__ out, int64_t n_out, int64_t cols, T scale) {
  const int64_t base = static_cast<int64_t>(row0[0]) * cols;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_out; e += stride) {
    out[e] = scale * x[base + e];
  }
}

template <typename T>
int launch(const T* x, const int32_t* row0, T* out, int64_t n_rows, int64_t cols,
           T scale, cudaStream_t stream) {
  const int64_t n_out = n_rows * cols;
  if (n_out == 0) return 0;
  int64_t blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  row_copy_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, row0, out, n_out, cols, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int femx_row_copy_f32(const float* x, const int32_t* row0, float* out,
                      int64_t n_rows, int64_t cols, double scale,
                      cudaStream_t stream) {
  return launch<float>(x, row0, out, n_rows, cols, static_cast<float>(scale), stream);
}

int femx_row_copy_f64(const double* x, const int32_t* row0, double* out,
                      int64_t n_rows, int64_t cols, double scale,
                      cudaStream_t stream) {
  return launch<double>(x, row0, out, n_rows, cols, scale, stream);
}

}  // extern "C"
