// Batched single-RHS triangular substitution against packed front LUs, for
// Hopper.
//
// Replaces the TPU kernel goma_tpu/solvers/pallas_lu.py::_trsv_kernel
// (called through batched_trsv). It computes the same thing: for each front
// of a batch, with lu the packed L\U that batched_lu wrote (unit-lower L
// below the diagonal, U on and above it, the diagonal holding the boosted
// pivots) and one right-hand side b,
//   lower: y_k = b_k - sum_{j<k} L[k,j] y_j,              k = 0 .. m-1
//   upper: x_k = (b_k - sum_{j>k} U[k,j] x_j) / U[k,k],   k = m-1 .. 0
// The TPU kernel extracts rows with masked reductions because dynamic lane
// indexing is slow there; here every entry is indexed directly.
//
// What bounds it on an H100: each front is a chain of m dependent steps and
// moves only about m^2/2 entries, so it is bound by latency, not bandwidth
// (one NDLU solve of the 64x64 cavity is ~3,100 dependent steps over ~45 MB
// in f32, ~14 us of HBM time). The top levels have 1-4 fronts and leave
// most of the 132 SMs idle.
//
// The design is the simple correct one, a column sweep: one CTA per front
// (grid = nn), one thread per row (block = m rounded up to a warp, m <=
// 1024). Each thread keeps its row's running value in a register; once row
// k is final its owner publishes x_k (rounded to the working dtype) through
// shared memory, and after one barrier every row i still open applies
// acc_i -= M[i,k] * x_k with a full-precision FMA (no tensor cores). One
// barrier per step. The coefficients a thread needs do not depend on the
// chain, so they are fetched a chunk of steps ahead into registers, which
// hides the L2 latency behind the barriers.
//
// Every row accumulates in a float64 register, a float32 front too. The
// sweep sums each row in sequence, and a sequential float32 sum over up to
// m terms is less accurate than the plain version's tree reduction (on the
// H100, 2.7e-7 vs 7.1e-8 of max|x| from the float64 answer at m = 154); a
// float64 FMA costs nothing in a chain bound by latency. Inputs, outputs and
// the published entries stay in the working dtype. Speed is later work:
// several fronts per CTA for the 218-front level, clusters or warp-level
// blocking for the top fronts, CUDA graphs for the launch chain.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kChunk = 8;
constexpr int kMaxRows = 1024;

template <typename T, bool kLower>
__global__ void __launch_bounds__(kMaxRows)
    batched_trsv_kernel(const T* __restrict__ lu, const T* __restrict__ b,
                        T* __restrict__ out, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_x = reinterpret_cast<T*>(smem_raw);  // finished entries of x

  using A = double;  // the accumulator (see the note above)
  const int i = threadIdx.x;  // the row this thread owns
  const bool row = i < m;
  const T* a = lu + static_cast<size_t>(blockIdx.x) * m * m +
               static_cast<size_t>(row ? i : 0) * m;
  A acc = row ? A(b[static_cast<size_t>(blockIdx.x) * m + i]) : A(0);
  const A diag = (!kLower && row) ? A(a[i]) : A(1);
  // row i's final value in the working dtype
  auto result = [&] { return T(kLower ? acc : acc / diag); };

  // step t eliminates column col(t); row i takes part while it is open
  auto col = [m](int t) { return kLower ? t : m - 1 - t; };
  auto is_open = [i](int k) { return kLower ? i > k : i < k; };
  // row i's coefficient at step t (0 where it takes no part)
  auto coef = [&](int t) {
    return (row && t < m && is_open(col(t))) ? a[col(t)] : T(0);
  };

  // the first row needs no update
  if (i == col(0)) s_x[i] = result();
  T cur[kChunk], nxt[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) cur[u] = coef(u);
  __syncthreads();

  for (int t0 = 0; t0 < m - 1; t0 += kChunk) {
#pragma unroll
    for (int u = 0; u < kChunk; ++u) nxt[u] = coef(t0 + kChunk + u);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = t0 + u;
      if (t >= m - 1) break;  // uniform across the block
      const int k = col(t);
      const A xk = A(s_x[k]);
      if (row && is_open(k)) acc = fma(-A(cur[u]), xk, acc);
      // the next row to finish publishes itself (a slot nobody reads now)
      if (i == col(t + 1)) s_x[i] = result();
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) cur[u] = nxt[u];
  }
  // each row's final value was published by its own thread
  if (row) out[static_cast<size_t>(blockIdx.x) * m + i] = s_x[i];
}

template <typename T>
int launch(const void* lu, const void* b, void* out, int64_t nn, int m,
           int lower, void* stream) {
  if (nn <= 0 || m <= 0) return 0;
  if (m > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned threads = static_cast<unsigned>((m + 31) / 32 * 32);
  const size_t smem = static_cast<size_t>(m) * sizeof(T);
  auto s = static_cast<cudaStream_t>(stream);
  const T* L = static_cast<const T*>(lu);
  const T* B = static_cast<const T*>(b);
  T* O = static_cast<T*>(out);
  if (lower)
    batched_trsv_kernel<T, true>
        <<<static_cast<unsigned>(nn), threads, smem, s>>>(L, B, O, m);
  else
    batched_trsv_kernel<T, false>
        <<<static_cast<unsigned>(nn), threads, smem, s>>>(L, B, O, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// lu: (nn, m, m), b and out: (nn, m), contiguous device arrays; out must not
// alias b. lower != 0: unit-lower forward substitution; 0: upper backward
// substitution dividing by the stored pivots. m <= 1024. Returns the
// cudaError_t of the launch (0 = cudaSuccess).
int batched_trsv_f32(const void* lu, const void* b, void* out, int64_t nn,
                     int m, int lower, void* stream) {
  return launch<float>(lu, b, out, nn, m, lower, stream);
}

int batched_trsv_f64(const void* lu, const void* b, void* out, int64_t nn,
                     int m, int lower, void* stream) {
  return launch<double>(lu, b, out, nn, m, lower, stream);
}

}  // extern "C"
