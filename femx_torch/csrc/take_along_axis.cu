// Per-element gather along one axis of a 2-D table, take_along_axis style:
//
//   axis 0: out[i, j] = tab[idx[i, j], j]   tab (H, W), idx and out (M, W)
//   axis 1: out[i, j] = tab[i, idx[i, j]]   tab (M, Wt), idx and out (M, K)
//
// Replaces the TPU kernels examples/pallas_gather_repros.py:90
// (repro_take_along_lanes, axis 1 on (8, 128)), :108
// (repro_take_along_sublanes, axis 0, tab (512, 128)) and
// examples/bench_dyngather.py:52 (`kernel` in main: axis 0 with a resident
// (H, 128) table and M = G*H index rows, H from 8 to 4096), the Mosaic
// tpu.dynamic_gather probes of a routed unstructured gather.
//
// What bounds it on an H100: data movement only. Least time = (table bytes
// + index bytes + output bytes) / 3.35 TB/s, each input read once. At
// bench_dyngather's sizes (32 Mi outputs) the index read and the output
// write are 256 MiB together against a table of at most 2 MiB, which stays
// in L2 (50 MB), so the streams, not the scattered table reads, set the
// time.
//
// Design (simple first version): one thread per output element, consecutive
// threads on consecutive (i, j), so the index loads and the stores coalesce;
// on axis 0 a warp reads 32 neighbouring columns of scattered rows, each a
// separate 4-byte sector request served from L2. Indices are trusted, as
// bench_dyngather's PROMISE_IN_BOUNDS trusts them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

template <typename T>
__global__ void __launch_bounds__(kThreads)
take_along_kernel(const T* __restrict__ tab, const int32_t* __restrict__ idx,
                  T* __restrict__ out, int64_t n_out, int cols, int tab_cols,
                  int axis) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n_out; e += stride) {
    const int64_t i = e / cols;
    const int j = static_cast<int>(e - i * cols);
    const int64_t k = idx[e];
    out[e] = axis == 0 ? tab[k * tab_cols + j] : tab[i * tab_cols + k];
  }
}

template <typename T>
int launch(const T* tab, const int32_t* idx, T* out, int64_t rows, int cols,
           int tab_cols, int axis, cudaStream_t stream) {
  const int64_t n_out = rows * cols;
  if (n_out == 0) return 0;
  int64_t blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  take_along_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      tab, idx, out, n_out, cols, tab_cols, axis);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// idx and out are (rows, cols) row-major; tab has tab_cols columns. Each
// returns cudaGetLastError() after the launch (0 = launched).
int femx_take_along_axis_f32(const float* tab, const int32_t* idx, float* out,
                             int64_t rows, int cols, int tab_cols, int axis,
                             cudaStream_t stream) {
  return launch<float>(tab, idx, out, rows, cols, tab_cols, axis, stream);
}

int femx_take_along_axis_f64(const double* tab, const int32_t* idx, double* out,
                             int64_t rows, int cols, int tab_cols, int axis,
                             cudaStream_t stream) {
  return launch<double>(tab, idx, out, rows, cols, tab_cols, axis, stream);
}

}  // extern "C"
