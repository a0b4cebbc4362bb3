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
// write are 256 MiB together against a table of at most 2 MiB, so the two
// streams set the time.
//
// The host plans every launch (femx_torch/gather.py: plan_take_along) and
// the entry refuses a plan that disagrees with this source (code 1001).
// Variants, all with 32-bit index arithmetic (the plan refuses 2^31
// outputs or table elements) and the axis a template parameter:
//
// 1, 2 — axis 0, slab (tables whose slab fits shared memory, H * 32 B <=
//   227 KB). A warp that reads 32 neighbouring columns of 32 random table
//   rows from global memory touches 32 L2 sectors for 128 useful bytes (the
//   first version of this kernel: 8x the output bytes in L2 traffic). So a
//   block owns a slab of table columns one 32-byte sector wide (8 float or 4
//   double columns) and stages that slab of all H rows in shared memory once
//   with cp.async; then it streams a contiguous range of index rows through
//   it. Block b takes slab b % n_slabs and row range b / n_slabs (one
//   division per block); the plan sizes the ranges so that the grid fills
//   the SMs once. Variant 1 (output rows in whole 16-byte words: W a
//   multiple of 4 float or 2 double columns, both streams 16-byte aligned):
//   a thread loads the indices of one 16-byte output word in one load (4
//   float or 2 double columns), reads their values from shared memory and
//   stores the word; two threads cover a row's slab (its indices are one
//   32-byte sector for float, half of one for double), so every store
//   instruction of a warp writes whole 32-byte sectors (with 4 double
//   columns per thread, two 16-byte stores each wrote half sectors, and the
//   float64 kernel ran at a quarter of its bound). 8 such loads are in
//   flight per thread (at H = 4096 only one block of 512 threads fits an
//   SM). Variant 2 (any other width, e.g. W = 50 or 7): the same with one
//   element per thread and per load. A ragged last slab (W not a multiple of
//   the slab) is masked by column. Random rows of an unswizzled slab would
//   hit only 8 of the 32 banks (a row is 8 banks wide, 4 rows a 128-byte
//   line), so column c of row k lives at k * S + (c ^ ((k >> 2) & (S - 1)))
//   (S = slab columns): random rows then spread over all 32 banks, and the
//   staging stores of 4 consecutive rows remain a permutation of the banks.
//
// 3 — axis 0, large table (H * 32 B > 227 KB): the table is read from L2. One
//   thread per output element, 4 elements per thread a block apart, all 4
//   index loads issued before the table loads.
//
// 4 — axis 1: the same per-element mapping (the (8, 128) repro and small
//   rows; the 4 values of a row a thread reads are neighbours in the table).
//
// Indices are trusted, as bench_dyngather's PROMISE_IN_BOUNDS trusts them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBadPlan = 1001;  // the host's plan disagrees with this source
constexpr int kSlabBytes = 32;  // a slab is one 32-byte sector of columns
constexpr int kSlabThreads = 512;
constexpr int kSlabUnroll = 8;  // index loads in flight per thread
constexpr int kSimpleThreads = 256;
constexpr int kSimplePerThread = 4;
constexpr int kMaxDynamicSmem = 232448;  // what a block may opt into on sm_90

enum Variant { kSlabVec = 1, kSlabScalar = 2, kL2 = 3, kAxis1 = 4 };

// dynamic shared memory of a slab block: the slab of all H table rows
__host__ __device__ constexpr size_t slab_smem(int tab_rows) {
  return static_cast<size_t>(tab_rows) * kSlabBytes;
}

template <typename T>
__device__ __forceinline__ int slab_pos(int k, int c) {
  constexpr int kS = kSlabBytes / sizeof(T);
  return k * kS + (c ^ ((k >> 2) & (kS - 1)));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(kBytes));
}

// kCols indices in one load: 4 for float (16 bytes), 2 for double (8 bytes)
template <int kCols>
struct IndexWord;
template <>
struct IndexWord<4> {
  using type = int4;
};
template <>
struct IndexWord<2> {
  using type = int2;
};

// out[0 .. kCols) = the slab's values at rows ix, columns c, c + 1, ..: one
// 16-byte store
__device__ __forceinline__ void store_word(float* out, const float* slab, int4 ix, int c) {
  *reinterpret_cast<float4*>(out) =
      make_float4(slab[slab_pos<float>(ix.x, c)], slab[slab_pos<float>(ix.y, c + 1)],
                  slab[slab_pos<float>(ix.z, c + 2)], slab[slab_pos<float>(ix.w, c + 3)]);
}

__device__ __forceinline__ void store_word(double* out, const double* slab, int2 ix, int c) {
  *reinterpret_cast<double2*>(out) =
      make_double2(slab[slab_pos<double>(ix.x, c)], slab[slab_pos<double>(ix.y, c + 1)]);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kSlabThreads)
take_along_slab(const T* __restrict__ tab, const int32_t* __restrict__ idx,
                T* __restrict__ out, int rows, int cols, int tab_rows, int n_slabs,
                int rows_per_block) {
  constexpr int kS = kSlabBytes / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* slab = reinterpret_cast<T*>(smem_raw);
  const int c0 = (blockIdx.x % n_slabs) * kS;
  const int r_begin = (blockIdx.x / n_slabs) * rows_per_block;
  const int r_end = min(rows, r_begin + rows_per_block);

  // stage the slab: lane e copies column e % S of row e / S (a warp: 4 rows
  // of one sector each)
  for (int e = threadIdx.x; e < tab_rows * kS; e += kSlabThreads) {
    const int k = e / kS, c = e % kS;
    if (c0 + c < cols) cp_async<sizeof(T)>(slab + slab_pos<T>(k, c), tab + k * cols + c0 + c);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  if constexpr (kVec) {
    // a thread owns kCols columns (c0 + kCols q ..) of every step-th row: one
    // 16-byte store, and a warp's store covers whole 32-byte sectors
    constexpr int kCols = 16 / sizeof(T);
    constexpr int kChunks = kS / kCols;
    constexpr int kStep = kSlabThreads / kChunks;
    using Ix = typename IndexWord<kCols>::type;
    const int q = threadIdx.x % kChunks;
    const int cq = c0 + kCols * q;
    if (cq >= cols) return;  // a chunk past a ragged last slab (W % kCols == 0)
    for (int r = r_begin + threadIdx.x / kChunks; r < r_end; r += kSlabUnroll * kStep) {
      Ix ix[kSlabUnroll];
#pragma unroll
      for (int u = 0; u < kSlabUnroll; ++u) {
        const int ru = r + u * kStep;
        if (ru < r_end) ix[u] = *reinterpret_cast<const Ix*>(idx + ru * cols + cq);
      }
#pragma unroll
      for (int u = 0; u < kSlabUnroll; ++u) {
        const int ru = r + u * kStep;
        if (ru < r_end) store_word(out + ru * cols + cq, slab, ix[u], kCols * q);
      }
    }
  } else {
    // a thread owns column c0 + c of every step-th row
    constexpr int kStep = kSlabThreads / kS;
    const int c = threadIdx.x % kS;
    if (c0 + c >= cols) return;  // past a ragged last slab
    for (int r = r_begin + threadIdx.x / kS; r < r_end; r += kSlabUnroll * kStep) {
      int ix[kSlabUnroll];
#pragma unroll
      for (int u = 0; u < kSlabUnroll; ++u) {
        const int ru = r + u * kStep;
        if (ru < r_end) ix[u] = idx[ru * cols + c0 + c];
      }
#pragma unroll
      for (int u = 0; u < kSlabUnroll; ++u) {
        const int ru = r + u * kStep;
        if (ru < r_end) out[ru * cols + c0 + c] = slab[slab_pos<T>(ix[u], c)];
      }
    }
  }
}

template <typename T, int kAxis>
__global__ void __launch_bounds__(kSimpleThreads)
take_along_simple(const T* __restrict__ tab, const int32_t* __restrict__ idx,
                  T* __restrict__ out, int n_out, int cols, int tab_cols) {
  const int e0 = blockIdx.x * (kSimpleThreads * kSimplePerThread) + threadIdx.x;
  int ix[kSimplePerThread];
#pragma unroll
  for (int u = 0; u < kSimplePerThread; ++u) {
    const int e = e0 + u * kSimpleThreads;
    if (e < n_out) ix[u] = idx[e];
  }
#pragma unroll
  for (int u = 0; u < kSimplePerThread; ++u) {
    const int e = e0 + u * kSimpleThreads;
    if (e < n_out) {
      const int i = e / cols;
      out[e] = kAxis == 0 ? tab[ix[u] * tab_cols + (e - i * cols)] : tab[i * tab_cols + ix[u]];
    }
  }
}

template <typename T, bool kVec>
int opt_in_smem() {
  // once per slab kernel and device: its blocks may need more than 48 KB
  static unsigned done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 32 && (done >> dev) & 1u) return 0;
  err = cudaFuncSetAttribute(take_along_slab<T, kVec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 32) done |= 1u << dev;
  return 0;
}

template <typename T>
int launch(const T* tab, const int32_t* idx, T* out, int rows, int cols, int tab_rows,
           int tab_cols, int variant, int grid, int smem, int rows_per_block,
           cudaStream_t stream) {
  const int64_t n_out = static_cast<int64_t>(rows) * cols;
  if (n_out == 0) return 0;
  if (n_out > INT32_MAX || static_cast<int64_t>(tab_rows) * tab_cols > INT32_MAX || grid < 1)
    return kBadPlan;
  if (variant == kSlabVec || variant == kSlabScalar) {
    constexpr int kS = kSlabBytes / sizeof(T);
    const int n_slabs = (cols + kS - 1) / kS;
    if (tab_cols != cols || static_cast<size_t>(smem) != slab_smem(tab_rows) ||
        smem > kMaxDynamicSmem || grid % n_slabs != 0 || rows_per_block < 1 ||
        static_cast<int64_t>(grid / n_slabs) * rows_per_block < rows)
      return kBadPlan;
    if (variant == kSlabVec) {
      if (cols % (16 / static_cast<int>(sizeof(T))) != 0 || reinterpret_cast<uintptr_t>(idx) % 16 != 0 ||
          reinterpret_cast<uintptr_t>(out) % 16 != 0)
        return kBadPlan;
      const int err = opt_in_smem<T, true>();
      if (err != 0) return err;
      take_along_slab<T, true><<<grid, kSlabThreads, smem, stream>>>(
          tab, idx, out, rows, cols, tab_rows, n_slabs, rows_per_block);
    } else {
      const int err = opt_in_smem<T, false>();
      if (err != 0) return err;
      take_along_slab<T, false><<<grid, kSlabThreads, smem, stream>>>(
          tab, idx, out, rows, cols, tab_rows, n_slabs, rows_per_block);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != kL2 && variant != kAxis1) return kBadPlan;
  constexpr int64_t kPerBlock = kSimpleThreads * kSimplePerThread;
  if (smem != 0 || grid != (n_out + kPerBlock - 1) / kPerBlock || rows_per_block != 0)
    return kBadPlan;
  if (variant == kL2) {
    if (tab_cols != cols) return kBadPlan;
    take_along_simple<T, 0><<<grid, kSimpleThreads, 0, stream>>>(
        tab, idx, out, static_cast<int>(n_out), cols, tab_cols);
  } else {
    if (tab_rows != rows) return kBadPlan;
    take_along_simple<T, 1><<<grid, kSimpleThreads, 0, stream>>>(
        tab, idx, out, static_cast<int>(n_out), cols, tab_cols);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// idx and out are (rows, cols) row-major, tab (tab_rows, tab_cols); variant,
// grid, smem and rows_per_block are the host's plan (gather.AlongPlan). Each
// returns cudaGetLastError() after the launch (0 = launched), or 1001 if the
// plan names no variant built here or disagrees with this source.
int femx_take_along_axis_f32(const float* tab, const int32_t* idx, float* out, int rows,
                             int cols, int tab_rows, int tab_cols, int variant, int grid,
                             int smem, int rows_per_block, cudaStream_t stream) {
  return launch<float>(tab, idx, out, rows, cols, tab_rows, tab_cols, variant, grid, smem,
                       rows_per_block, stream);
}

int femx_take_along_axis_f64(const double* tab, const int32_t* idx, double* out, int rows,
                             int cols, int tab_rows, int tab_cols, int variant, int grid,
                             int smem, int rows_per_block, cudaStream_t stream) {
  return launch<double>(tab, idx, out, rows, cols, tab_rows, tab_cols, variant, grid, smem,
                        rows_per_block, stream);
}

}  // extern "C"
