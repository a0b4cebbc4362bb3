// Row gather out[q, :] = tab[idx[q], :] for an int32 index array.
//
// Replaces the TPU kernels examples/pallas_gather_repros.py:56
// (repro_take_values: a 1-D table, width 1), :72 (repro_take_rows_2d: rows of
// a (128, 128) table) and :128 (repro_dynamic_ref_rows: the same row copy by
// SMEM indices in a loop). Those kernels probe whether the unstructured
// operator's row gathers can run inside a kernel; on the card they are the
// row gathers themselves: u3[connT] and the degree-bucketed fe3[idx] of the
// transpose-gather apply (femx/assembly_tg.py:163-181) and the lattice
// transfers' row gathers (femx/solve/lattice_precond.py:133-231), all of
// width 3.
//
// What bounds it on an H100: pure data movement. Each output element reads
// one 4-byte index (shared by the W elements of its row) and one table
// element and writes one element, so the least time is (table bytes + index
// bytes + output bytes) / 3.35 TB/s with each input read once. The table
// reads are scattered: where the indices jump around a table much larger
// than L2, each 12- or 24-byte row read costs at least one 32-byte sector,
// so a random gather cannot reach that bound.
//
// Design (simple first version): one thread per output element, threads in
// a warp on consecutive output addresses, so the stores and the index loads
// coalesce; the table load is a plain global load through L1/L2. Indices are
// trusted (the operator and transfer builders check their range once on the
// host), as B12's PROMISE_IN_BOUNDS trusts them. A grid-stride loop covers
// outputs beyond the grid. The width-3 case, the one on the solve path, is
// compiled with a constant width so the row/column split is a multiply, not
// a runtime division.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

template <typename T, int kWidth>
__global__ void __launch_bounds__(kThreads)
take_rows_kernel(const T* __restrict__ tab, const int32_t* __restrict__ idx,
                 T* __restrict__ out, int64_t n_out, int width) {
  const int w = kWidth > 0 ? kWidth : width;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_out; i += stride) {
    const int64_t q = i / w;
    const int c = static_cast<int>(i - q * w);
    out[i] = tab[static_cast<int64_t>(idx[q]) * w + c];
  }
}

template <typename T>
int launch(const T* tab, const int32_t* idx, T* out, int64_t n_rows, int width,
           cudaStream_t stream) {
  const int64_t n_out = n_rows * width;
  if (n_out == 0) return 0;
  int64_t blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (width == 3) {
    take_rows_kernel<T, 3><<<grid, kThreads, 0, stream>>>(tab, idx, out, n_out, 3);
  } else {
    take_rows_kernel<T, 0><<<grid, kThreads, 0, stream>>>(tab, idx, out, n_out, width);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (n_rows, width) = tab[idx] for a row-major table of `width` columns
// and n_rows int32 indices. Each returns cudaGetLastError() after the launch
// (0 = launched).
int femx_take_rows_f32(const float* tab, const int32_t* idx, float* out,
                       int64_t n_rows, int width, cudaStream_t stream) {
  return launch<float>(tab, idx, out, n_rows, width, stream);
}

int femx_take_rows_f64(const double* tab, const int32_t* idx, double* out,
                       int64_t n_rows, int width, cudaStream_t stream) {
  return launch<double>(tab, idx, out, n_rows, width, stream);
}

}  // extern "C"
