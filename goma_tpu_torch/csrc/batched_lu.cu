// Batched unpivoted front LU with a GESP static pivot boost, for Hopper:
// blocked right-looking LU, several CTAs per front in a thread-block
// cluster.
//
// Replaces the TPU kernel goma_tpu/solvers/pallas_lu.py::_lu_kernel (called
// through batched_lu). It computes the same thing: for each front A (m x m)
// of a batch, tau = pivot_tol * max(max_i |A0[i,i]|, 1e-30) from the
// ORIGINAL diagonal; then for k = 0..m-1: piv = A[k,k], replaced by -tau
// (piv < 0) or +tau (otherwise) when |piv| < tau; the column below the
// pivot is divided by piv (L, unit lower); the strict trailing block takes
// the rank-1 update A[i,j] -= L[i,k] * A[k,j]; the diagonal stores the
// boosted piv. No row swaps. Output: packed L\U; A is not written.
//
// What bounds it on an H100: not bytes or FLOPs (the 9 level shapes of a
// 64x64 cavity factorization move 91 MB and 1.3 GFLOP: 0.027 ms) but the
// chain of m dependent column steps of each front, and on the top levels
// the few fronts (1-8) for 132 SMs.
//
// Design, per panel of NB columns (NB = 32 float32, 16 float64):
//  1. every CTA of the front's cluster loads the (m - j0) x NB panel into
//     shared memory (column-major, odd leading dimension: conflict-free both
//     ways) and factors it REDUNDANTLY in registers, each thread owning up
//     to kSlots rows (warp 0 the NB pivot rows); each pivot row is
//     published to shared memory with a release counter the moment it is
//     final, and the other threads wait for that row alone: no block
//     barrier per column and no round trip through L2. What is left per
//     column is warp 0's latency chain (wait, load the row, divide, update,
//     publish): a front cannot finish faster than m of those;
//  2. the trailing columns are split into one contiguous chunk per CTA of
//     the cluster; each CTA solves its chunk of U12 = L11^-1 A12 (one
//     thread per column) and applies A22 -= L21 U12 to all trailing rows of
//     its chunk in 4 x 4 register tiles (full-precision FMA: no tensor
//     cores, so no TF32 rounding; per element the same FMA sequence as the
//     unblocked order);
//  3. one cluster barrier; then each CTA writes its share of the factored
//     panel rows back (after the barrier: a slower CTA may still be reading
//     the unfactored panel before it).
// The front lives in the output buffer (L2-resident: 764 KB at m = 437 in
// float32); every read of it goes through __ldcg (L2, not the SM's L1),
// because another SM of the cluster may have written the line. The first
// panel step reads A itself, so there is no copy pass. The host side picks
// the cluster size C from nn (largest of 16, 8, 4, 2 with nn * C <= 132,
// else 1; 1 when the front is a single panel), the block size from m, and
// launches everything in one cudaLaunchKernelEx.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int NB = 32;
};
template <>
struct Cfg<double> {
  static constexpr int NB = 16;
};

constexpr int kSlots = 2;      // panel rows per thread: m <= kSlots * threads
constexpr int kUCols = 128;    // U12 columns staged in shared memory at once
constexpr int kMaxM = 1024;    // kSlots * the largest block size
constexpr int kSms = 132;      // H100 SXM
constexpr int kMaxSmem = 232448;

__host__ __device__ constexpr int panel_ld(int m) { return m | 1; }

template <typename T>
__host__ __device__ constexpr int smem_elems(int m) {
  return Cfg<T>::NB * (panel_ld(m) + kUCols + Cfg<T>::NB + 1) + 33;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(p))),
               "r"(v)
               : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
}

// The panel row a thread holds in slot s. Warp 0 holds the rows that become
// pivot rows (0..31) in slot 0 and, only when m > 2 * THREADS - 32, the last
// rows in slot 1; the other warps hold the rest, two slots each.
template <int THREADS>
__device__ __forceinline__ int panel_row(int t, int s) {
  return t < 32 ? (s == 0 ? t : 2 * THREADS - 32 + t) : t + s * (THREADS - 32);
}

template <typename T>
__device__ __forceinline__ T fma_t(T a, T b, T c);
template <>
__device__ __forceinline__ float fma_t<float>(float a, float b, float c) {
  return fmaf(a, b, c);
}
template <>
__device__ __forceinline__ double fma_t<double>(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS, 65536 / (128 * THREADS))
    blocked_lu_kernel(const T* __restrict__ A, T* out, int m, T pivot_tol) {
  constexpr int NB = Cfg<T>::NB;
  constexpr int kWarps = THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* P = reinterpret_cast<T*>(smem_raw);  // panel, column-major, ld = LDP
  const int LDP = panel_ld(m);
  T* sU = P + NB * LDP;                   // U12 block, NB x kUCols
  T* s_rows = sU + NB * kUCols;           // the panel's pivot rows, NB x NB
  T* s_piv = s_rows + NB * NB;            // boosted pivots of the panel
  T* s_red = s_piv + NB;                  // block reduction
  int* s_ready = reinterpret_cast<int*>(s_red + 32);  // pivot rows ready

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t mm = static_cast<size_t>(m) * m;
  const size_t front = blockIdx.x / C;
  const T* a = A + front * mm;
  T* f = out + front * mm;
  const int tid = threadIdx.x;

  // tau from the ORIGINAL diagonal (A is read-only, so every CTA reduces it
  // itself and none waits for another before the first panel)
  T dmax = T(0);
  for (int i = tid; i < m; i += THREADS) {
    T d = a[static_cast<size_t>(i) * m + i];
    d = d < T(0) ? -d : d;
    dmax = d > dmax ? d : dmax;
  }
  for (int off = 16; off > 0; off >>= 1) {
    T o = __shfl_down_sync(0xffffffffu, dmax, off);
    dmax = o > dmax ? o : dmax;
  }
  if ((tid & 31) == 0) s_red[tid >> 5] = dmax;
  __syncthreads();
  T mx = s_red[0];
  for (int w = 1; w < kWarps; ++w) mx = s_red[w] > mx ? s_red[w] : mx;
  const T tau = pivot_tol * (mx > T(1e-30) ? mx : T(1e-30));

  for (int j0 = 0; j0 < m; j0 += NB) {
    const int jb = min(NB, m - j0);
    const int rows = m - j0;
    const T* src = j0 == 0 ? a : f;

    // ---- 1. the panel: rows j0..m-1, columns j0..j0+jb-1 -> P
#pragma unroll 8
    for (int e = tid; e < rows * NB; e += THREADS) {
      const int r = e / NB, c = e % NB;
      P[c * LDP + r] =
          c < jb ? __ldcg(src + static_cast<size_t>(j0 + r) * m + j0 + c) : T(0);
    }
    if (tid == 0) *s_ready = 0;
    __syncthreads();
    T v[kSlots][NB];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int r = panel_row<THREADS>(tid, s);
#pragma unroll
      for (int c = 0; c < NB; ++c) v[s][c] = r < rows ? P[c * LDP + r] : T(0);
    }
    // the pivot rows of the panel go to s_rows as they become final, and
    // *s_ready counts them: a thread waits for row k alone (no block
    // barrier per column), so the threads run as a wavefront behind warp 0,
    // which owns every pivot row
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < NB; ++c) s_rows[c] = v[0][c];
      st_release(s_ready, 1);
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      if (k < jb) {
        while (ld_acquire(s_ready) <= k) {
        }
        const T* prow = s_rows + k * NB;
        T pr[NB];
#pragma unroll
        for (int c = k; c < NB; ++c) pr[c] = prow[c];
        T piv = pr[k];
        const T ap = piv < T(0) ? -piv : piv;
        if (ap < tau) piv = piv < T(0) ? -tau : tau;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int r = panel_row<THREADS>(tid, s);
          if (r > k && r < rows) {
            const T l = v[s][k] / piv;
            v[s][k] = l;
#pragma unroll
            for (int c = k + 1; c < NB; ++c) v[s][c] = fma_t(-l, pr[c], v[s][c]);
          }
          // row k+1 is final after slot 0: publish it before slot 1 (thread
          // k+1 owns it in slot 0, since k + 1 < NB <= 32)
          if (s == 0 && tid == k + 1 && k + 1 < jb) {
#pragma unroll
            for (int c = k + 1; c < NB; ++c) s_rows[(k + 1) * NB + c] = v[0][c];
            st_release(s_ready, k + 2);
          }
        }
        if (tid == 0) s_piv[k] = piv;
      }
    }
    __syncthreads();
    // factored panel -> P, the boosted pivots on the diagonal
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int r = panel_row<THREADS>(tid, s);
      if (r < rows) {
#pragma unroll
        for (int c = 0; c < NB; ++c) P[c * LDP + r] = v[s][c];
      }
    }
    if (tid < jb) P[tid * LDP + tid] = s_piv[tid];  // thread tid owns row tid
    __syncthreads();

    // ---- 2. this CTA's chunk of the trailing columns: U12, then A22
    const int cbeg = j0 + NB;  // a panel with trailing columns is full width
    if (cbeg < m) {
      const int w = m - cbeg;
      const int chunk = (w + C - 1) / C;
      const int c0 = cbeg + rank * chunk;
      const int c1 = min(m, c0 + chunk);
      const int nrows = rows - NB;  // trailing rows j0+NB..m-1
      for (int cs = c0; cs < c1; cs += kUCols) {
        const int wsub = min(kUCols, c1 - cs);
        // U12 = L11^-1 A12, one thread per column (kUCols <= THREADS)
        if (tid < wsub) {
          T x[NB];
#pragma unroll
          for (int c = 0; c < NB; ++c)
            x[c] = __ldcg(src + static_cast<size_t>(j0 + c) * m + cs + tid);
#pragma unroll
          for (int k = 0; k < NB; ++k) {
#pragma unroll
            for (int c = k + 1; c < NB; ++c)
              x[c] = fma_t(-P[k * LDP + c], x[k], x[c]);
          }
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            sU[c * kUCols + tid] = x[c];
            f[static_cast<size_t>(j0 + c) * m + cs + tid] = x[c];
          }
        }
        __syncthreads();
        // A22 -= L21 U12: thread tile rows trow + p*ty, columns tcol + q*tx
        // the narrowest tile that covers the block: tx = 4 * 2^i >= wsub / 4
        int tx = 1;
        while (4 * tx < wsub) tx *= 2;
        const int ty = THREADS / tx;
        const int tcol = tid % tx, trow = tid / tx;
        bool cok[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) cok[q] = tcol + q * tx < wsub;
        // row p of the thread's tile in the pass at rb, clamped into P
        auto prow_of = [&](int rb, int p) {
          const int r = rb + trow + p * ty;
          return NB + (r < nrows ? r : nrows - 1);
        };
        auto load_tile = [&](int rb, T (&t)[4][4]) {
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const bool rok = rb + trow + p * ty < nrows;
            const T* g = src + static_cast<size_t>(j0 + prow_of(rb, p)) * m + cs + tcol;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              t[p][q] = rok && cok[q] ? __ldcg(g + q * tx) : T(0);
          }
        };
        T acc[4][4];
        load_tile(0, acc);
        for (int rb = 0; rb < nrows; rb += 4 * ty) {
          // the next pass's tile is in flight while this one computes
          T nxt[4][4];
          load_tile(rb + 4 * ty, nxt);  // all masked after the last pass
          int pr[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) pr[p] = prow_of(rb, p);
#pragma unroll 4
          for (int k = 0; k < NB; ++k) {
            T l[4], u[4];
#pragma unroll
            for (int p = 0; p < 4; ++p) l[p] = P[k * LDP + pr[p]];
#pragma unroll
            for (int q = 0; q < 4; ++q) u[q] = sU[k * kUCols + tcol + q * tx];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[p][q] = fma_t(-l[p], u[q], acc[p][q]);
            }
          }
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            if (rb + trow + p * ty < nrows) {
              T* g = f + static_cast<size_t>(j0 + pr[p]) * m + cs + tcol;
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (cok[q]) g[q * tx] = acc[p][q];
            }
          }
#pragma unroll
          for (int p = 0; p < 4; ++p) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[p][q] = nxt[p][q];
          }
        }
        __syncthreads();  // sU is rewritten by the next column block
      }
    }

    // ---- 3. every CTA is past this panel step: the trailing writes are
    // visible to the next panel's loads, and nobody still reads this panel
    __threadfence();
    cluster.sync();
    const int per = (rows + C - 1) / C;
    const int r0 = rank * per;
    const int r1 = min(rows, r0 + per);
    for (int e = tid; e < (r1 - r0) * NB; e += THREADS) {
      const int r = r0 + e / NB, c = e % NB;
      if (c < jb) f[static_cast<size_t>(j0 + r) * m + j0 + c] = P[c * LDP + r];
    }
    __syncthreads();  // P is reloaded by the next panel
  }
}

struct Plan {
  int cluster, nb, threads, smem;
};

template <typename T>
Plan make_plan(int64_t nn, int m) {
  Plan p;
  p.nb = Cfg<T>::NB;
  p.threads = m <= 224 ? 128 : (m <= 480 ? 256 : 512);
  p.cluster = 1;
  if (m > p.nb) {
    for (int c : {16, 8, 4, 2}) {
      if (nn * c <= kSms) {
        p.cluster = c;
        break;
      }
    }
  }
  p.smem = static_cast<int>(sizeof(T)) * smem_elems<T>(m);
  return p;
}

template <typename T, int THREADS>
cudaError_t prepare(const void** fn) {
  auto kern = blocked_lu_kernel<T, THREADS>;
  static cudaError_t err = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  *fn = reinterpret_cast<const void*>(kern);
  return err;
}

template <typename T>
cudaError_t kernel_for(int threads, const void** fn) {
  switch (threads) {
    case 128:
      return prepare<T, 128>(fn);
    case 256:
      return prepare<T, 256>(fn);
    default:
      return prepare<T, 512>(fn);
  }
}

cudaLaunchConfig_t config(const Plan& p, int64_t nn, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nn * p.cluster), 1, 1);
  cfg.blockDim = dim3(p.threads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
int launch(const void* A, void* out, int64_t nn, int m, double pivot_tol,
           void* stream) {
  if (nn <= 0 || m <= 0) return 0;
  if (m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan<T>(nn, m);
  if (p.smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn;
  cudaError_t e = kernel_for<T>(p.threads, &fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      config(p, nn, static_cast<cudaStream_t>(stream), &attr);
  const T* a = static_cast<const T*>(A);
  T* o = static_cast<T*>(out);
  T tol = static_cast<T>(pivot_tol);
  void* args[] = {&a, &o, &m, &tol};
  e = cudaLaunchKernelExC(&cfg, fn, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// out[0..5) = cluster size, panel width, threads per CTA, dynamic shared
// bytes per CTA, and how many such clusters the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0 when it cannot place one).
template <typename T>
int plan(int64_t nn, int m, int* out5) {
  const Plan p = make_plan<T>(nn, m);
  out5[0] = p.cluster;
  out5[1] = p.nb;
  out5[2] = p.threads;
  out5[3] = p.smem;
  out5[4] = 0;
  const void* fn;
  cudaError_t e = kernel_for<T>(p.threads, &fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(p, nn, nullptr, &attr);
  e = cudaOccupancyMaxActiveClusters(&out5[4], fn, &cfg);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// A, out: (nn, m, m) contiguous device arrays; out must not alias A;
// 1 <= m <= 1024. Returns the cudaError_t of the launch (0 = cudaSuccess);
// a launch the card refuses (cluster or shared memory) returns its error.
int batched_lu_f32(const void* A, void* out, int64_t nn, int m,
                   double pivot_tol, void* stream) {
  return launch<float>(A, out, nn, m, pivot_tol, stream);
}

int batched_lu_f64(const void* A, void* out, int64_t nn, int m,
                   double pivot_tol, void* stream) {
  return launch<double>(A, out, nn, m, pivot_tol, stream);
}

int batched_lu_plan_f32(int64_t nn, int m, int* out5) {
  return plan<float>(nn, m, out5);
}

int batched_lu_plan_f64(int64_t nn, int m, int* out5) {
  return plan<double>(nn, m, out5);
}

}  // extern "C"
