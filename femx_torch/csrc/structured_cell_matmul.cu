// Fused slot gather + cell-stiffness matmul of the structured Tet10 operator.
//
// Replaces the TPU kernel femx/elements/pallas_structured.py:101
// (structured_cell_matmul). For the flat internal-layout vector u (8 phase
// grids, phase p = 4px+2py+pz of shape (3, nx+1-px, ny+1-py, nz+1-pz), stored
// back to back) and every cell (x, y, z) it computes
//
//   fe[3s+c, cell] = sum_{s',c'} Kcell[3s+c, 3s'+c'] *
//                    u_phase(s')[c', x + a'/2, y + b'/2, z + c''/2]
//
// where slot s' = 9a' + 3b' + c'' runs over the 27 cell-local lattice slots
// and phase(s') = (a'%2, b'%2, c''%2). fe is (81, nx*ny*nz), cells in (x,y,z)
// raster order with z minor. The overlap-add of fe back onto the lattice
// stays outside the kernel (femx_torch/assembly_structured.py), as it stays
// in XLA beside the TPU kernel.
//
// What bounds it on an H100 SXM: 2*81*81 = 13,122 flops per cell against
// ~424 bytes per cell in f32 (81 outputs written, ~25 lattice values of u
// read), ~31 flops/byte, above the FP32 ridge of 67 TFLOP/s / 3.35 TB/s = 20,
// so the FP32 FMA rate bounds f32 (~10.8 us at 24x24x96 cells). In f64 it is
// ~15 flops/byte, below the ridge of the FP64 tensor cores (DMMA, full IEEE
// FP64, 67 / 3.35 = 20), so bytes bound f64 (~14.0 us). This version runs
// plain FP64 FMAs (34 TFLOP/s, ~21.3 us at best); reaching the f64 bound
// takes DMMA. No TF32 for f32: it breaks the operator's symmetry and CG
// diverges.
//
// Design (the simple, correct first version): one block of 256 threads per
// tile of 64 consecutive cells. Kcell (26 KB f32, 52.5 KB f64) is staged in
// dynamic shared memory, and the tile's 81x64 gathered values beside it;
// gather loads run along the cell index, i.e. along z, so they coalesce.
// Thread t owns cell t%64 and the rows r = t/64 + 4i: every warp reads the
// same Kcell entry (a shared-memory broadcast) and its own column of the
// gathered tile (conflict-free), and accumulates with true FP32/FP64 FMAs.
// Stores run along cells, so they coalesce. The shared-memory load per FMA
// keeps it below the FMA peak; register blocking over several cells, wgmma
// and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;              // cells per block
constexpr int kThreads = 256;          // 4 row groups x 64 cells
constexpr int kRowGroups = kThreads / kTile;
constexpr int kRowsPerThread = (81 + kRowGroups - 1) / kRowGroups;  // 21

struct Geometry {
  int nx, ny, nz;
  int64_t offset[8];  // start of phase p in u
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
cell_matmul_kernel(const T* __restrict__ u, const T* __restrict__ kcell,
                   T* __restrict__ fe, Geometry g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // (81, 81) row-major
  T* us = ks + 81 * 81;                    // (81, kTile)

  const int64_t n_cells = static_cast<int64_t>(g.nx) * g.ny * g.nz;
  const int j = threadIdx.x % kTile;
  const int group = threadIdx.x / kTile;
  const int64_t cell = static_cast<int64_t>(blockIdx.x) * kTile + j;
  const bool live = cell < n_cells;

  for (int i = threadIdx.x; i < 81 * 81; i += kThreads) ks[i] = kcell[i];

  int x = 0, y = 0, z = 0;
  if (live) {
    z = static_cast<int>(cell % g.nz);
    const int64_t xy = cell / g.nz;
    y = static_cast<int>(xy % g.ny);
    x = static_cast<int>(xy / g.ny);
  }
  for (int r = group; r < 81; r += kRowGroups) {
    T v = T(0);
    if (live) {
      const int s = r / 3, comp = r % 3;
      const int a = s / 9, b = (s / 3) % 3, c = s % 3;
      const int px = a & 1, py = b & 1, pz = c & 1;
      const int64_t sx = g.nx + 1 - px, sy = g.ny + 1 - py, sz = g.nz + 1 - pz;
      const int64_t idx = g.offset[4 * px + 2 * py + pz]
          + ((comp * sx + x + (a >> 1)) * sy + y + (b >> 1)) * sz + z + (c >> 1);
      v = u[idx];
    }
    us[r * kTile + j] = v;
  }
  __syncthreads();

  T acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = T(0);
  for (int k = 0; k < 81; ++k) {
    const T v = us[k * kTile + j];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = group + kRowGroups * i;
      if (r < 81) acc[i] = fma(ks[r * 81 + k], v, acc[i]);
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = group + kRowGroups * i;
    if (r < 81) fe[r * n_cells + cell] = acc[i];
  }
}

template <typename T>
int launch(const T* u, const T* kcell, T* fe, int nx, int ny, int nz,
           cudaStream_t stream) {
  Geometry g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  int64_t off = 0;
  for (int p = 0; p < 8; ++p) {
    g.offset[p] = off;
    off += 3LL * (nx + 1 - (p >> 2)) * (ny + 1 - ((p >> 1) & 1)) * (nz + 1 - (p & 1));
  }
  const int64_t n_cells = static_cast<int64_t>(nx) * ny * nz;
  if (n_cells == 0) return 0;
  const size_t smem = sizeof(T) * (81 * 81 + 81 * kTile);
  // Above 48 KB (the f64 case) dynamic shared memory must be opted into.
  cudaError_t err = cudaFuncSetAttribute(
      cell_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (n_cells + kTile - 1) / kTile;
  cell_matmul_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      u, kcell, fe, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int femx_structured_cell_matmul_f32(const float* u, const float* kcell,
                                    float* fe, int nx, int ny, int nz,
                                    cudaStream_t stream) {
  return launch<float>(u, kcell, fe, nx, ny, nz, stream);
}

int femx_structured_cell_matmul_f64(const double* u, const double* kcell,
                                    double* fe, int nx, int ny, int nz,
                                    cudaStream_t stream) {
  return launch<double>(u, kcell, fe, nx, ny, nz, stream);
}

}  // extern "C"
