// Front gather for the nested-dissection LU's front assembly, for Hopper.
//
// Replaces the TPU kernel scripts/attic/exp_front_gather.py::gather_kernel
// (called through pallas_gather). It computes the same function:
//   out[i] = v[clip(g[i], 0, len(v) - 1)]
// where v = [0, CSR values] and g is the dense per-slot map of one ND
// level's fronts (g[slot] = CSR position + 1, or 0 for a slot that holds no
// CSR entry), so every front slot is written exactly once, with a value or
// with the zero in v[0]; no separate zero fill. The TPU kernel pads the map
// to (8, 128) blocks and keeps all of v in VMEM; here the map is flat, of
// any length, and the kernel masks its own tail.
//
// What bounds it on an H100: memory. Per slot it reads a 4-byte index and
// writes one 4- or 8-byte value, and does no arithmetic. v (~2.9M entries,
// 11 MB in float32 on the 48x48 buoyant deck) is read at random but sits in
// the 50 MB L2. The least time for a level is (4 n + sizeof(T) (n + len v))
// bytes over 3.35 TB/s; for all 9 levels of the 48x48 buoyant tree, ~90M
// slots, that is ~0.7 GB and ~0.2 ms in float32.
//
// The design is the simple one that streams at the memory rate: a
// grid-stride loop in which each thread takes 4 consecutive slots, one
// 16-byte read-only load of their indices, 4 __ldg loads of the values and
// one vector store (two for float64), so a warp moves 512 contiguous index
// bytes per step. The n % 4 tail is written by the first threads. The map
// and the output must be 16-byte aligned (the caching allocator's blocks
// are); the launch refuses other pointers.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;

__device__ __forceinline__ void store4(float* o, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(o) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(double* o, double a, double b,
                                       double c, double d) {
  reinterpret_cast<double2*>(o)[0] = make_double2(a, b);
  reinterpret_cast<double2*>(o)[1] = make_double2(c, d);
}

// v[clip(k, 0, hi)]
template <typename T>
__device__ __forceinline__ T at(const T* __restrict__ v, int k, int hi) {
  return __ldg(v + min(max(k, 0), hi));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    front_gather_vec(const T* __restrict__ v, int hi,
                     const int* __restrict__ g, T* __restrict__ out,
                     int64_t n) {
  const int64_t n4 = n >> 2;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int4* g4 = reinterpret_cast<const int4*>(g);
  for (int64_t i = tid; i < n4; i += stride) {
    const int4 k = __ldg(g4 + i);
    store4(out + 4 * i, at(v, k.x, hi), at(v, k.y, hi), at(v, k.z, hi),
           at(v, k.w, hi));
  }
  const int64_t t = 4 * n4 + tid;  // the ragged tail, fewer than 4 slots
  if (t < n) out[t] = at(v, __ldg(g + t), hi);
}

template <typename T>
int launch(const void* v, int64_t nv, const void* g, void* out, int64_t n,
           void* stream) {
  if (n <= 0) return 0;
  if (nv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out)) & 15) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  // indices are int32, so no slot reads past INT_MAX whatever len(v) is
  const int hi = static_cast<int>(nv - 1 < INT_MAX ? nv - 1 : INT_MAX);
  const T* V = static_cast<const T*>(v);
  const int* G = static_cast<const int*>(g);
  T* O = static_cast<T*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  int64_t blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  front_gather_vec<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      V, hi, G, O, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// v: (nv,) values, g: (n,) int32 slot map, out: (n,) of v's type; all
// contiguous device arrays, g and out 16-byte aligned, out not aliasing v
// or g. out[i] =
// v[clip(g[i], 0, nv - 1)]. Returns the cudaError_t of the launch (0 =
// cudaSuccess).
int front_gather_f32(const void* v, int64_t nv, const void* g, void* out,
                     int64_t n, void* stream) {
  return launch<float>(v, nv, g, out, n, stream);
}

int front_gather_f64(const void* v, int64_t nv, const void* g, void* out,
                     int64_t n, void* stream) {
  return launch<double>(v, nv, g, out, n, stream);
}

}  // extern "C"
