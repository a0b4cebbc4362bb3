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
// raster order with z minor. The layer weights and the overlap-add of fe back
// onto the lattice stay outside the kernel (femx_torch/assembly_structured.py),
// as they stay in XLA beside the TPU kernel.
//
// What bounds it on an H100 SXM: 2*81*81 = 13,122 flops per cell against
// ~424 bytes per cell in f32 (81 outputs written, ~25 lattice values of u
// read), ~31 flops/byte, above the FP32 ridge of 67 TFLOP/s / 3.35 TB/s = 20,
// so the FP32 FMA rate bounds f32 (~10.8 us at 24x24x96 cells). The tensor
// cores have no FP32-input product: wgmma and mma.sync take TF32, which
// breaks the operator's symmetry (CG diverges), and a 3xTF32 split does so
// too. So f32 stays on the FMA pipe and wgmma does not apply here. In f64
// the kernel is ~15 flops/byte, below the ridge of the FP64 tensor cores
// (DMMA, full IEEE FP64, 67 / 3.35 = 20), so bytes bound f64 (~14.0 us);
// plain FP64 FMAs (34 TFLOP/s) could not pass ~21.3 us.
//
// Design, shared by both kernel families below:
//  * Persistent blocks. The host plans grid <= tiles (about SMs x blocks per
//    SM, femx_torch/elements/cell_matmul.py:plan_launch); block b walks the
//    tiles b, b + grid, ... of kTile consecutive cells. The cell matrix is
//    staged once per block, from a copy the host packed into the layout the
//    inner loop reads (cell_matmul.py:pack_kcell), by 16-byte cp.async.
//  * The gathered tile us (81 rows x kTile cells) is double-buffered with
//    cp.async: the next tile's gather is in flight while this tile is
//    multiplied. The gather keeps 81 values per cell rather than the tile's
//    unique lattice box: the loads run along z, coalesce, and mostly hit
//    L1/L2 (neighbouring cells share them), and the k-loop then reads us with
//    aligned vector loads, which a box layout would not allow.
//  * Gather arithmetic in 32 bits (the wrapper refuses ndof >= 2^31). A warp
//    item is one group of 9 rows (slots (a, b, .), all c and components) for
//    32 cells: the cell -> (x, y, z) split and the two phase bases are
//    computed once per item, each of its 9 loads adds a constant.
//  * The tile is picked from the cell count, so that the coarse lattices of
//    the V-cycle (6,912 / 864 / 108 cells) still spread over the SMs.
//
// f32 (and an f64 instantiation): cell_matmul_fma, register-blocked true
// FMAs. 9 warps; warp w owns rows 9w..9w+8 (81 = 9 x 9, no padded row),
// lane l owns kCpl cells, so a thread holds a 9 x kCpl micro-tile in
// registers. Per k it reads 9 entries of the k-major packed cell matrix
// (warp-broadcast 16-byte loads) and its kCpl values of us (one 4-, 8- or
// 16-byte load per 1, 2 or 4 cells): 9 kCpl FMAs per 3 + kCpl / 4 loads.
// Every output sums k = 0..80 in order, as the first version of this kernel
// did. On the card the tile of 64 cells (kCpl = 2, two blocks per SM) beat
// 128 and 256 at every lattice from 108 to 221,184 cells, so the host plans
// 64, and 32 where 64 would leave SMs without a tile; 4 and 8 stay built for
// scripts/kernel_sweep.py.
//
// f64: cell_matmul_dmma, the FP64 tensor cores through
// mma.sync.aligned.m16n8k4 with 4 warps on a tile of 32 cells, two blocks per
// SM (m8n8k4 and an 8-warp tile of 64 are built too: template), rows
// padded to a multiple of the m-tile and depth to a multiple of the k-step
// with zeros. The cell matrix sits in shared memory in fragment order (each
// lane's A values contiguous: conflict-free 8/16-byte loads), us with a row
// stride of kTile + 4 doubles, which spreads a B fragment's 4 k x 8 cells
// over all banks. A warp owns one n-tile of 8 cells and all m-tiles. DMMA
// sums in another order than a k = 0..80 chain; the result agrees with the
// plain version within 1e-12 relative (chip_smoke.py holds it to that).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Geometry {
  int nx, ny, nz;
  int n_cells, n_tiles;
  int offset[8];  // start of phase p in u
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copy of kBytes (4, 8 or 16); zero-fills the
// destination when !pred (src is then not read but must be a valid address).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool pred = true) {
  const int n = pred ? kBytes : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(smem_addr(dst)), "l"(src), "n"(kBytes), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

template <typename T, int kN>
struct alignas(sizeof(T) * kN) Pack {
  T v[kN];
};

// Copy n16 16-byte words of the packed cell matrix into shared memory.
__device__ __forceinline__ void stage_packed(void* dst, const void* src, int n16, int threads) {
  for (int i = threadIdx.x; i < n16; i += threads)
    cp_async<16>(static_cast<char*>(dst) + 16 * i, static_cast<const char*>(src) + 16 * i);
}

// Start the gather of one tile: us[r * kStride + j] = slot value r of cell
// tile * kTile + j (zero past the last cell), rows 0..80.
template <typename T, int kTile, int kStride, int kWarps>
__device__ __forceinline__ void gather_tile(const T* __restrict__ u, T* us,
                                            const Geometry& g, int tile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int item = warp; item < 9 * (kTile / 32); item += kWarps) {
    const int grp = item % 9, j = (item / 9) * 32 + lane;
    const int cell = tile * kTile + j;
    const bool live = cell < g.n_cells;
    const int cc = live ? cell : 0;
    const int z = cc % g.nz, xy = cc / g.nz, y = xy % g.ny, x = xy / g.ny;
    const int a = grp / 3, b = grp % 3, px = a & 1, py = b & 1;
    const int sx = g.nx + 1 - px, sy = g.ny + 1 - py;
    const int line = (x + (a >> 1)) * sy + y + (b >> 1);
    int base[2], comp_stride[2];
#pragma unroll
    for (int pz = 0; pz < 2; ++pz) {
      const int sz = g.nz + 1 - pz;
      base[pz] = g.offset[4 * px + 2 * py + pz] + line * sz + z;
      comp_stride[pz] = sx * sy * sz;
    }
    T* dst = us + 9 * grp * kStride + j;
#pragma unroll
    for (int i = 0; i < 9; ++i) {  // row 9 grp + i: slot c = i / 3, component i % 3
      const int c = i / 3, comp = i % 3, pz = c & 1;
      const int idx = base[pz] + comp * comp_stride[pz] + (c >> 1);
      cp_async<sizeof(T)>(dst + i * kStride, u + (live ? idx : 0), live);
    }
  }
}

// The persistent tile loop: block b takes tiles b, b + grid, ...; the next
// tile's gather (into the other of the two buffers) overlaps compute(cur,
// tile). Whatever cp.async the caller started before (the cell matrix) joins
// the first group.
template <typename T, int kTile, int kStride, int kBuf, int kWarps, typename Compute>
__device__ __forceinline__ void for_each_tile(const T* __restrict__ u, T* us,
                                              const Geometry& g, Compute compute) {
  const int step = gridDim.x;
  int tile = blockIdx.x;
  gather_tile<T, kTile, kStride, kWarps>(u, us, g, tile);
  cp_async_commit();
  for (int it = 0; tile < g.n_tiles; tile += step, ++it) {
    if (tile + step < g.n_tiles)
      gather_tile<T, kTile, kStride, kWarps>(u, us + ((it + 1) & 1) * kBuf, g, tile + step);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: this tile has landed
    __syncthreads();
    compute(us + (it & 1) * kBuf, tile);
    __syncthreads();  // this buffer is gathered into again in the next round
  }
}

// ---------------------------------------------------------------- FMA kernel
constexpr int kFmaWarps = 9;
constexpr int kFmaThreads = 32 * kFmaWarps;

template <typename T>
__host__ __device__ constexpr int fma_kpad() {  // 9 rows padded to whole 16-byte words
  return sizeof(T) == 4 ? 12 : 10;
}

template <typename T, int kCpl>
__host__ __device__ constexpr size_t fma_smem() {
  return sizeof(T) * (81 * 9 * fma_kpad<T>() + 2 * 81 * 32 * kCpl);
}

template <typename T, int kCpl>
__global__ void __launch_bounds__(kFmaThreads)
cell_matmul_fma(const T* __restrict__ u, const T* __restrict__ kpack,
                T* __restrict__ fe, Geometry g) {
  constexpr int kTile = 32 * kCpl;
  constexpr int kPad = fma_kpad<T>();
  constexpr int kPer16 = 16 / sizeof(T);
  constexpr int kVec = kCpl < kPer16 ? kCpl : kPer16;  // cells per load
  constexpr int kSeg = kCpl / kVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // (81 k, 9 warps, kPad): k-major
  T* us = ks + 81 * 9 * kPad;              // 2 x (81, kTile)

  stage_packed(ks, kpack, 81 * 9 * kPad / kPer16, kFmaThreads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec_ok = g.n_cells % kVec == 0;

  for_each_tile<T, kTile, kTile, 81 * kTile, kFmaWarps>(
      u, us, g, [&](const T* cur, int tile) {
        T acc[9][kCpl];
#pragma unroll
        for (int r = 0; r < 9; ++r)
#pragma unroll
          for (int c = 0; c < kCpl; ++c) acc[r][c] = T(0);
        const T* kw = ks + warp * kPad;
        const T* uw = cur + lane * kVec;
#pragma unroll 3
        for (int k = 0; k < 81; ++k) {
          T kv[kPad], uv[kCpl];
#pragma unroll
          for (int i = 0; i < kPad / kPer16; ++i) {
            const Pack<T, kPer16> p =
                *reinterpret_cast<const Pack<T, kPer16>*>(kw + k * 9 * kPad + i * kPer16);
#pragma unroll
            for (int e = 0; e < kPer16; ++e) kv[i * kPer16 + e] = p.v[e];
          }
#pragma unroll
          for (int s = 0; s < kSeg; ++s) {
            const Pack<T, kVec> p =
                *reinterpret_cast<const Pack<T, kVec>*>(uw + k * kTile + s * 32 * kVec);
#pragma unroll
            for (int e = 0; e < kVec; ++e) uv[s * kVec + e] = p.v[e];
          }
#pragma unroll
          for (int r = 0; r < 9; ++r)
#pragma unroll
            for (int c = 0; c < kCpl; ++c) acc[r][c] = fma(kv[r], uv[c], acc[r][c]);
        }
        const int cell0 = tile * kTile;
#pragma unroll
        for (int r = 0; r < 9; ++r) {
          T* out = fe + static_cast<size_t>(9 * warp + r) * g.n_cells + cell0;
#pragma unroll
          for (int s = 0; s < kSeg; ++s) {
            const int j = (s * 32 + lane) * kVec;
            if (vec_ok) {
              Pack<T, kVec> p;
#pragma unroll
              for (int e = 0; e < kVec; ++e) p.v[e] = acc[r][s * kVec + e];
              if (cell0 + j < g.n_cells) *reinterpret_cast<Pack<T, kVec>*>(out + j) = p;
            } else {
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                if (cell0 + j + e < g.n_cells) out[j + e] = acc[r][s * kVec + e];
            }
          }
        }
      });
}

// --------------------------------------------------------------- DMMA kernel
// One FP64 tensor-core product D (8 kM8 x 8) += A (8 kM8 x 4) B (4 x 8).
// With g = lane / 4 and t = lane % 4 a lane holds
//   a[i]: row g + 8 i, depth t;  b: depth t, column g;
//   c[i]: row g + 8 (i / 2), column 2 t + i % 2.
template <int kM8>
struct Dmma;

template <>
struct Dmma<1> {
  static __device__ __forceinline__ void mma(double* c, const double* a, double b) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
                 : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b));
  }
};

template <>
struct Dmma<2> {
  static __device__ __forceinline__ void mma(double* c, const double* a, double b) {
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
                 "{%0,%1,%2,%3};\n"
                 : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
                 : "d"(a[0]), "d"(a[1]), "d"(b));
  }
};

template <int kM8, int kWarps>
struct DmmaShape {
  static constexpr int kMp = (81 + 8 * kM8 - 1) / (8 * kM8) * (8 * kM8);  // padded rows
  static constexpr int kKp = 84;                                         // padded depth
  static constexpr int kMt = kMp / (8 * kM8);                            // m-tiles
  static constexpr int kKs = kKp / 4;                                    // k-steps
  static constexpr int kTile = 8 * kWarps;  // a warp owns one n-tile of 8 cells
  static constexpr int kStride = kTile + 4;
  static constexpr int kBuf = kKp * kStride;
  static constexpr size_t kSmem = sizeof(double) * (kMp * kKp + 2 * kBuf);
};

template <int kM8, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
cell_matmul_dmma(const double* __restrict__ u, const double* __restrict__ kpack,
                 double* __restrict__ fe, Geometry g) {
  using S = DmmaShape<kM8, kWarps>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* ks = reinterpret_cast<double*>(smem_raw);  // (kKs, kMt, 32 lanes, kM8)
  double* us = ks + S::kMp * S::kKp;                 // 2 x (kKp, kStride)

  stage_packed(ks, kpack, S::kMp * S::kKp / 2, 32 * kWarps);
  // depth rows 81..83 of both buffers stay zero: the gather never writes them
  for (int i = threadIdx.x; i < 2 * 3 * S::kStride; i += 32 * kWarps)
    us[(i / (3 * S::kStride)) * S::kBuf + 81 * S::kStride + i % (3 * S::kStride)] = 0.0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const bool pair_ok = g.n_cells % 2 == 0;

  for_each_tile<double, S::kTile, S::kStride, S::kBuf, kWarps>(
      u, us, g, [&](const double* cur, int tile) {
        double acc[S::kMt][2 * kM8];
#pragma unroll
        for (int m = 0; m < S::kMt; ++m)
#pragma unroll
          for (int i = 0; i < 2 * kM8; ++i) acc[m][i] = 0.0;
        const double* bw = cur + tig * S::kStride + warp * 8 + grp;
        const double* aw = ks + lane * kM8;
#pragma unroll 1
        for (int s = 0; s < S::kKs; ++s) {
          const double b = bw[s * 4 * S::kStride];
#pragma unroll
          for (int m = 0; m < S::kMt; ++m) {
            const Pack<double, kM8> a =
                *reinterpret_cast<const Pack<double, kM8>*>(aw + (s * S::kMt + m) * 32 * kM8);
            Dmma<kM8>::mma(acc[m], a.v, b);
          }
        }
        const int cell = tile * S::kTile + warp * 8 + 2 * tig;
#pragma unroll
        for (int m = 0; m < S::kMt; ++m)
#pragma unroll
          for (int h = 0; h < kM8; ++h) {
            const int row = m * 8 * kM8 + 8 * h + grp;
            if (row >= 81) continue;
            double* out = fe + static_cast<size_t>(row) * g.n_cells;
            if (pair_ok) {
              const Pack<double, 2> p = {{acc[m][2 * h], acc[m][2 * h + 1]}};
              if (cell < g.n_cells) *reinterpret_cast<Pack<double, 2>*>(out + cell) = p;
            } else {
              if (cell < g.n_cells) out[cell] = acc[m][2 * h];
              if (cell + 1 < g.n_cells) out[cell + 1] = acc[m][2 * h + 1];
            }
          }
      });
}

// ------------------------------------------------------------------- launch
constexpr int kBadPlan = 1001;  // the host's plan names no kernel built here

template <typename Kernel, typename T>
int launch_kernel(Kernel kernel, size_t smem, int threads, int tile, const T* u,
                  const T* kpack, T* fe, int nx, int ny, int nz, int grid, int smem_host,
                  cudaStream_t stream) {
  Geometry g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  int64_t off = 0;
  for (int p = 0; p < 8; ++p) {
    g.offset[p] = static_cast<int>(off);
    off += 3LL * (nx + 1 - (p >> 2)) * (ny + 1 - ((p >> 1) & 1)) * (nz + 1 - (p & 1));
  }
  const int64_t n_cells = static_cast<int64_t>(nx) * ny * nz;
  if (n_cells == 0) return 0;
  if (off > INT32_MAX || static_cast<size_t>(smem_host) != smem) return kBadPlan;
  g.n_cells = static_cast<int>(n_cells);
  g.n_tiles = static_cast<int>((n_cells + tile - 1) / tile);
  if (grid < 1 || grid > g.n_tiles) return kBadPlan;
  // Above 48 KB dynamic shared memory must be opted into, per instantiation.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(u, kpack, fe, g);
  return static_cast<int>(cudaGetLastError());
}

#define FEMX_FMA_CASE(T, CPL)                                                          \
  case 100 * CPL:                                                                      \
    return launch_kernel(cell_matmul_fma<T, CPL>, fma_smem<T, CPL>(), kFmaThreads,     \
                         32 * CPL, u, kpack, fe, nx, ny, nz, grid, smem, stream);

#define FEMX_DMMA_CASE(M8, WARPS)                                                      \
  case 10000 * M8 + WARPS:                                                             \
    return launch_kernel(cell_matmul_dmma<M8, WARPS>, DmmaShape<M8, WARPS>::kSmem,     \
                         32 * WARPS, DmmaShape<M8, WARPS>::kTile, u, kpack, fe, nx,    \
                         ny, nz, grid, smem, stream);

}  // namespace

extern "C" {

// fe = Kcell @ gathered u for the lattice (nx, ny, nz). kpack is the cell
// matrix packed by cell_matmul.pack_kcell for `variant`, the kernel the
// host's plan picked (cell_matmul.Variant.code); grid and smem are the plan's
// block count and dynamic shared-memory bytes. Each returns
// cudaGetLastError() after the launch (0 = launched), or 1001 if the plan
// names no kernel built here or disagrees with its shared-memory size.
int femx_structured_cell_matmul_f32(const float* u, const float* kpack, float* fe,
                                    int nx, int ny, int nz, int variant, int grid,
                                    int smem, cudaStream_t stream) {
  switch (variant) {
    FEMX_FMA_CASE(float, 1)
    FEMX_FMA_CASE(float, 2)
    FEMX_FMA_CASE(float, 4)
    FEMX_FMA_CASE(float, 8)
  }
  return kBadPlan;
}

int femx_structured_cell_matmul_f64(const double* u, const double* kpack, double* fe,
                                    int nx, int ny, int nz, int variant, int grid,
                                    int smem, cudaStream_t stream) {
  switch (variant) {
    FEMX_FMA_CASE(double, 1)
    FEMX_FMA_CASE(double, 2)
    FEMX_DMMA_CASE(1, 4)
    FEMX_DMMA_CASE(2, 4)
    FEMX_DMMA_CASE(2, 8)
  }
  return kBadPlan;
}

}  // extern "C"
