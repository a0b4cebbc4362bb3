// Copies between a caller's vector, whose address the device reads from a
// two-slot table, and a fixed buffer:
//
//   slot_set        slots[0] = in, slots[1] = out          (one thread)
//   slot_copy_in    buf[i] = ((T*) slots[0])[i]            i < n
//   slot_copy_out   ((T*) slots[1])[i] = buf[i]            i < n
//
// They let a CUDA graph take a new input and write a new output on every
// replay while it holds neither between calls: femx_torch.solve.multigrid
// captures its V-cycle between slot_copy_in and slot_copy_out, on a buffer
// of the graph's private memory pool, and before each replay launches
// slot_set with the call's two addresses on the same stream. The table is
// written in stream order, never from the host, so a replay still queued
// behind the host reads the addresses of its own call.
//
// What bounds it on an H100: bytes, 2 n sizeof(T) / 3.35 TB/s (4 us for the
// 1.6M-DOF float32 residual). Design: a grid-stride loop over 16-byte words
// (float4 or double2) when the caller's address and the buffer are both
// 16-byte aligned, else over single elements; the test is made on the device,
// since the caller's address changes between replays, and the grid fixed at
// capture serves either loop. A copy is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;  // words per thread on the aligned path

__global__ void slot_set_kernel(int64_t* slots, int64_t in, int64_t out) {
  slots[0] = in;
  slots[1] = out;
}

// kIn: copy from the address in slots[0] into buf; else from buf to the
// address in slots[1]. V is T's 16-byte vector.
template <typename T, typename V, bool kIn>
__global__ void __launch_bounds__(kThreads)
slot_copy_kernel(const int64_t* __restrict__ slots, T* buf, int64_t n) {
  T* ext = reinterpret_cast<T*>(slots[kIn ? 0 : 1]);
  const T* __restrict__ src = kIn ? ext : buf;
  T* __restrict__ dst = kIn ? buf : ext;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  constexpr int64_t kPer = sizeof(V) / sizeof(T);
  int64_t done = 0;
  if ((reinterpret_cast<uintptr_t>(ext) | reinterpret_cast<uintptr_t>(buf)) % sizeof(V) == 0) {
    const int64_t words = n / kPer;
    const V* __restrict__ vs = reinterpret_cast<const V*>(src);
    V* __restrict__ vd = reinterpret_cast<V*>(dst);
    for (int64_t w = first; w < words; w += stride) vd[w] = vs[w];
    done = words * kPer;
  }
  for (int64_t i = done + first; i < n; i += stride) dst[i] = src[i];
}

template <typename T, typename V, bool kIn>
int launch_copy(const int64_t* slots, T* buf, int64_t n, cudaStream_t stream) {
  if (n <= 0) return 0;
  constexpr int64_t kPer = sizeof(V) / sizeof(T);
  const int64_t words = (n + kPer - 1) / kPer;
  const int64_t blocks = (words + kThreads * kWordsPerThread - 1) / (kThreads * kWordsPerThread);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  slot_copy_kernel<T, V, kIn><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      slots, buf, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int femx_slot_set(int64_t* slots, int64_t in, int64_t out, cudaStream_t stream) {
  slot_set_kernel<<<1, 1, 0, stream>>>(slots, in, out);
  return static_cast<int>(cudaGetLastError());
}

int femx_slot_copy_in_f32(const int64_t* slots, float* buf, int64_t n, cudaStream_t stream) {
  return launch_copy<float, float4, true>(slots, buf, n, stream);
}

int femx_slot_copy_in_f64(const int64_t* slots, double* buf, int64_t n, cudaStream_t stream) {
  return launch_copy<double, double2, true>(slots, buf, n, stream);
}

int femx_slot_copy_out_f32(const int64_t* slots, float* buf, int64_t n, cudaStream_t stream) {
  return launch_copy<float, float4, false>(slots, buf, n, stream);
}

int femx_slot_copy_out_f64(const int64_t* slots, double* buf, int64_t n, cudaStream_t stream) {
  return launch_copy<double, double2, false>(slots, buf, n, stream);
}

}  // extern "C"
