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
// What bounds it on an H100: pure data movement. Each input read once and
// each output written once gives (table bytes + index bytes + output bytes)
// / 3.35 TB/s. The table reads are scattered: where the indices jump around,
// each 12- or 24-byte row read costs at least one 32-byte sector, so a random
// gather is held to the sector bound (index bytes + 32 B per row + output
// bytes) / 3.35 TB/s instead. Indices are trusted (the operator and transfer
// constructors check their range once on the host), as B12's PROMISE_IN_BOUNDS
// trusts them.
//
// Width 3, the solve paths' width, default (take_rows3_kernel): one thread
// per output element, 4 elements per thread a block apart, unrolled so that
// all index loads come first and then all table loads: 4 independent loads in
// flight per thread, the row/column split a multiply by a constant. A warp's
// load covers 32 consecutive elements, i.e. ~11 rows, so every row costs
// about one L1 wavefront, and stores and index loads coalesce with no
// staging. On the H100 this beat the row-per-thread design below, the first
// version of this kernel (the same mapping, one load in flight, a 64-bit
// division per element) and torch.index_select in both types.
//
// Width 3, one thread per row (take_rows3_by_rows_kernel; built for
// scripts/kernel_sweep.py, which times it): a warp takes a chunk of 128
// consecutive rows, 4 per lane. It loads its 4 indices (coalesced, each read
// once), then each row in two loads (a pair and a single, ordered by the
// row's parity so both are aligned), all independent. The rows then pass
// through the warp's slice of shared memory (stride 3: no bank conflict) and
// leave as 16-byte stores over the chunk's contiguous output; a ragged last
// chunk is stored element by element. Every load instruction of a warp
// touches 32 different rows, 32 L1 wavefronts against the ~11 of the default,
// which is why it is the slower of the two.
//
// Any other width (take_rows_kernel; the examples' widths 1 and 128): one
// thread per output word, where a word is 16 bytes when the row's bytes and
// the pointers allow it (a row of 128 floats is then read by one warp with
// 16-byte loads) and one element otherwise. Threads in a warp are on
// consecutive output words, so index loads and stores coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

template <typename W, int kWidth>
__global__ void __launch_bounds__(kThreads)
take_rows_kernel(const W* __restrict__ tab, const int32_t* __restrict__ idx,
                 W* __restrict__ out, int64_t n_out, int width) {
  const int w = kWidth > 0 ? kWidth : width;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_out; i += stride) {
    const int64_t q = i / w;
    const int c = static_cast<int>(i - q * w);
    out[i] = tab[static_cast<int64_t>(idx[q]) * w + c];
  }
}

template <typename W>
void launch_words(const W* tab, const int32_t* idx, W* out, int64_t n_rows, int width,
                  cudaStream_t stream) {
  const int64_t n_out = n_rows * width;
  int64_t blocks = (n_out + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (width == 1) {
    take_rows_kernel<W, 1><<<grid, kThreads, 0, stream>>>(tab, idx, out, n_out, 1);
  } else {
    take_rows_kernel<W, 0><<<grid, kThreads, 0, stream>>>(tab, idx, out, n_out, width);
  }
}

constexpr int kElems3 = 4;  // elements per thread of the width-3 kernel

template <typename T>
__global__ void __launch_bounds__(kThreads)
take_rows3_kernel(const T* __restrict__ tab, const int32_t* __restrict__ idx,
                  T* __restrict__ out, int64_t n_out) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kElems3 + threadIdx.x;
  int64_t src[kElems3];
#pragma unroll
  for (int e = 0; e < kElems3; ++e) {
    const int64_t i = base + e * kThreads;
    const int64_t q = i / 3;
    src[e] = i < n_out ? static_cast<int64_t>(idx[q]) * 3 + (i - 3 * q) : 0;
  }
  T v[kElems3];
#pragma unroll
  for (int e = 0; e < kElems3; ++e) v[e] = tab[src[e]];
#pragma unroll
  for (int e = 0; e < kElems3; ++e) {
    const int64_t i = base + e * kThreads;
    if (i < n_out) out[i] = v[e];
  }
}

constexpr int kWarps3 = 4;  // warps per block of the row-per-thread kernel
constexpr int kRows3 = 4;   // rows per thread
constexpr int kChunk3 = 32 * kRows3;  // rows per warp

template <typename T, int kN>
struct alignas(sizeof(T) * kN) Pack {
  T v[kN];
};

template <typename T>
__global__ void __launch_bounds__(32 * kWarps3)
take_rows3_by_rows_kernel(const T* __restrict__ tab, const int32_t* __restrict__ idx,
                          T* __restrict__ out, int64_t n_rows) {
  constexpr int kPer16 = 16 / sizeof(T);
  constexpr int kVecs = 3 * kChunk3 / kPer16 / 32;  // 16-byte stores per lane
  static_assert(kVecs * kPer16 * 32 == 3 * kChunk3, "a chunk is whole 16-byte words per lane");
  __shared__ __align__(16) T stage[kWarps3][3 * kChunk3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t chunk0 = (static_cast<int64_t>(blockIdx.x) * kWarps3 + warp) * kChunk3;
  if (chunk0 >= n_rows) return;
  const int64_t left = n_rows - chunk0;

  int32_t ix[kRows3];
#pragma unroll
  for (int r = 0; r < kRows3; ++r) {
    const int q = r * 32 + lane;
    ix[r] = q < left ? idx[chunk0 + q] : 0;
  }
  Pack<T, 2> pair[kRows3];
  T single[kRows3];
#pragma unroll
  for (int r = 0; r < kRows3; ++r) {
    // row i starts on an even element when i is even (pair first), else on
    // an odd one (pair last)
    const T* p = tab + static_cast<int64_t>(ix[r]) * 3;
    const bool odd = ix[r] & 1;
    pair[r] = *reinterpret_cast<const Pack<T, 2>*>(p + (odd ? 1 : 0));
    single[r] = p[odd ? 0 : 2];
  }
  T* s = stage[warp];
#pragma unroll
  for (int r = 0; r < kRows3; ++r) {
    const bool odd = ix[r] & 1;
    T* d = s + (r * 32 + lane) * 3;
    d[0] = odd ? single[r] : pair[r].v[0];
    d[1] = odd ? pair[r].v[0] : pair[r].v[1];
    d[2] = odd ? pair[r].v[1] : single[r];
  }
  __syncwarp();
  T* dst = out + 3 * chunk0;
  if (left >= kChunk3) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
      reinterpret_cast<uint4*>(dst)[i * 32 + lane] =
          reinterpret_cast<const uint4*>(s)[i * 32 + lane];
  } else {
    for (int i = lane; i < 3 * left; i += 32) dst[i] = s[i];
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const T* tab, const int32_t* idx, T* out, int64_t n_rows, int width,
           int by_rows, cudaStream_t stream) {
  if (n_rows * width == 0) return 0;
  const int per16 = 16 / static_cast<int>(sizeof(T));
  if (width == 3 && by_rows && aligned16(tab) && aligned16(out)) {
    const int64_t per_block = static_cast<int64_t>(kChunk3) * kWarps3;
    take_rows3_by_rows_kernel<T><<<static_cast<unsigned>((n_rows + per_block - 1) / per_block),
                                   32 * kWarps3, 0, stream>>>(tab, idx, out, n_rows);
  } else if (width == 3) {
    const int64_t n_out = 3 * n_rows, per_block = kThreads * kElems3;
    take_rows3_kernel<T><<<static_cast<unsigned>((n_out + per_block - 1) / per_block),
                           kThreads, 0, stream>>>(tab, idx, out, n_out);
  } else if (width % per16 == 0 && aligned16(tab) && aligned16(out)) {
    launch_words(reinterpret_cast<const uint4*>(tab), idx, reinterpret_cast<uint4*>(out),
                 n_rows, width / per16, stream);
  } else {
    launch_words(tab, idx, out, n_rows, width, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (n_rows, width) = tab[idx] for a row-major table of `width` columns
// and n_rows int32 indices. by_rows != 0 picks the row-per-thread kernel for
// width 3 (timing only; the wrapper passes 0). Each returns
// cudaGetLastError() after the launch (0 = launched).
int femx_take_rows_f32(const float* tab, const int32_t* idx, float* out,
                       int64_t n_rows, int width, int by_rows, cudaStream_t stream) {
  return launch<float>(tab, idx, out, n_rows, width, by_rows, stream);
}

int femx_take_rows_f64(const double* tab, const int32_t* idx, double* out,
                       int64_t n_rows, int width, int by_rows, cudaStream_t stream) {
  return launch<double>(tab, idx, out, n_rows, width, by_rows, stream);
}

}  // extern "C"
