// Batched single-RHS triangular substitution against packed front LUs, for
// Hopper: a blocked sweep whose dependent chain runs inside one warp.
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
// moves only about m^2/2 entries, so it is bound by the latency of one
// step, not by bandwidth (one NDLU solve of the 64x64 cavity is ~3,100
// dependent steps over ~45 MB in f32, ~14 us of HBM time). A column sweep
// with one block barrier per step costs ~280 cycles a step; the design
// below leaves one round of warp shuffles and two float64 FMAs on the chain
// per two steps, ~55 cycles a step as measured.
//
// Design: one CTA per front, the sweep cut into blocks of 32 rows (both
// sweeps run in a logical index t that counts from the end the sweep starts
// at, so the upper sweep is the lower one mirrored). The warps of a CTA take
// three roles and meet only through release/acquire counters in shared
// memory, with no block barrier between the first and the last:
//  - warp 0, the solver, owns the chain. Lane i holds row i of the current
//    block in a float64 register. A pair of steps broadcasts two entries
//    with one round of shuffles and every open row takes its two FMAs (see
//    solve_block); the same broadcasts also feed the rows of the next two
//    blocks against this block's columns (independent FMAs), so when a block
//    ends the next one lacks only the columns three or more blocks back. It
//    publishes the block's x to shared memory (rounded to the working dtype,
//    as it is written out at the end) and bumps `done`;
//  - warps 1-3, the loaders, stage for each block its 32x32 diagonal tile
//    and the two tiles below it (the next blocks' rows against its columns),
//    one warp per tile, into a ring of 4 slots in shared memory: read along
//    the rows (whole 128-byte lines), the next block's rows in flight in
//    registers meanwhile, stored as float64 with an odd leading dimension,
//    so the solver reads its row without bank conflicts and converts
//    nothing. The upper sweep's reciprocal pivots are computed here too, off
//    the chain;
//  - warps 4.., the updaters, each own every kUpd-th block from the fourth
//    on: the row sums of that block against all columns at least three
//    blocks back, b_K - M[K, 0..K-3] x. Lane = column, the 32 rows of a tile
//    in registers, read along the rows one tile ahead of the x they wait
//    for; per-lane float64 partial sums over all tiles, then ONE transposing
//    butterfly of shuffles per block leaves row r's sum in lane r. Only the
//    newest tile (three blocks back) waits on the solver, with two blocks'
//    solves as slack: the update runs ahead of the chain.
// x goes out in one pass of the whole CTA at the end.
//
// Accuracy: every sum is float64, for float32 fronts too (a float32
// accumulator sat 3.8x farther from float64 than the plain version), the
// products are full-precision FMAs (no tensor cores). Within a block the
// solver carries x in its float64 register; what other blocks see and what
// is written out is x rounded to the working dtype. The upper sweep
// multiplies by the reciprocal pivot; for float64 fronts one Newton step on
// the quotient makes it the correctly rounded division in all but rare
// cases.
//
// Few fronts: the chain lives in one warp, so a thread-block cluster per
// front could only split the updaters' work, which already runs ahead of
// the chain on the shapes measured (scripts/torch_trsv_phases.py prints
// when each block's row sums were ready and when the solver wanted them);
// the plan keeps cluster size 1 and gives the fronts with more than 8
// blocks six updater warps instead of two. Many fronts: a CTA of 192
// threads is held to 168 registers, so two share an SM and the 218 fronts
// of the deepest cavity level run in one wave.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kNB = 32;             // block width: one lane per row
constexpr int kLd = kNB + 1;        // odd leading dimension of a staged tile
constexpr int kTile = kNB * kLd;    // float64 entries of one staged tile
constexpr int kNear = 2;            // tiles below the diagonal the solver takes
constexpr int kSlot = (1 + kNear) * kTile + kNB;  // those tiles, 1/pivots
constexpr int kSlots = 4;           // ring depth: blocks staged ahead
constexpr int kSync = 2 + kNear + 32;  // done, ready per tile, flag per block
constexpr int kMaxM = 1024;
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kBackoffNs = 40;

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

// every lane's shared-memory writes are visible before lane 0 releases:
// the warp barrier orders them before the release, which is cumulative
__device__ __forceinline__ void publish(int* p, int v, int lane) {
  __syncwarp();
  if (lane == 0) st_release(p, v);
}

// One stage of the transposing butterfly over p[0 .. 2H): lanes whose bit H
// is set keep the upper half and send the lower, the others the reverse;
// after the stages H = 16 .. 1, p[0] of lane r is the sum over all lanes of
// their p[r]. H is a template argument so that p stays in registers.
template <int H>
__device__ __forceinline__ void fold(double (&p)[kNB], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const double send = up ? p[i] : p[i + H];
    const double keep = up ? p[i + H] : p[i];
    p[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

// The chain: the 32 steps of one diagonal block, in the solver warp, two at
// a time. Lane i holds row i (acc) and row i of the next kNear blocks
// (accn); S is the block's ring slot: the diagonal tile, the tiles below it
// kTile apart, then the reciprocal pivots; dg and rd are this lane's pivot
// and its reciprocal (upper sweep). A pair of steps (k, k+1) broadcasts
// acc_k and acc_{k+1} with one round of shuffles; every lane then forms
// x_{k+1} = acc_{k+1} - M[k+1,k] x_k itself (the FMA lane k+1 would do) and
// applies both columns, so the chain pays one shuffle and two FMAs per two
// steps, and each row still takes the same FMAs in the same order.
// kRagged: only jb < 32 steps exist (checked per pair, uniformly).
template <typename T, bool kLower, bool kRagged>
__device__ __forceinline__ void solve_block(const double* S, int jb, double dg,
                                            double rd, int lane, double& acc,
                                            double (&accn)[kNear],
                                            double& xfin) {
  const double* D = S + lane * kLd;  // this lane's row of each tile
  // v / pivot through the reciprocal; a float64 front adds one Newton step
  const auto quot = [](double v, double d, double r) {
    double q = v * r;
    if (sizeof(T) == 8) q = fma(fma(-d, q, v), r, q);
    return q;
  };
  // what the pair of steps (k, k+1) reads from the slot: this lane's entries
  // of the two columns in each tile, M[k+1,k], and row k+1's pivot and its
  // reciprocal (upper sweep)
  struct Pair {
    double d[1 + kNear][2], l, pd, pr;
  };
  const auto fetch = [&](int k) {
    Pair c;
#pragma unroll
    for (int h = 0; h <= kNear; ++h) {
      c.d[h][0] = D[h * kTile + k];
      c.d[h][1] = D[h * kTile + k + 1];
    }
    c.l = S[(k + 1) * kLd + k];
    c.pd = kLower ? 1.0 : S[(k + 1) * kLd + k + 1];
    c.pr = kLower ? 1.0 : S[(1 + kNear) * kTile + k + 1];
    return c;
  };
  Pair cur = fetch(0);
#pragma unroll
  for (int k = 0; k < kNB; k += 2) {
    // The next pair's entries are read one pair ahead of their use, and
    // behind this pair's shuffles: shuffles and shared-memory reads go
    // through one in-order pipe, and the shuffles are the chain. The empty
    // asm statements keep the compiler from moving the reads (up in front of
    // the block's first shuffle, or in front of this pair's).
    double xk = 0.0, y = 0.0;
    if (!kRagged || k < jb) {
      xk = __shfl_sync(kFull, kLower ? acc : quot(acc, dg, rd), k);
      y = __shfl_sync(kFull, acc, k + 1);
    }
    asm volatile("" : "+d"(xk), "+d"(y)::"memory");
    Pair nxt = cur;
    if (k + 2 < kNB) nxt = fetch(k + 2);
    asm volatile("" ::: "memory");
    if (!kRagged || k < jb) {
      const bool two = !kRagged || k + 1 < jb;
      double x1 = fma(-cur.l, xk, y);
      if (!kLower) x1 = quot(x1, cur.pd, cur.pr);
      if (lane > k) acc = fma(-cur.d[0][0], xk, acc);
      if (lane == k) xfin = xk;
#pragma unroll
      for (int h = 0; h < kNear; ++h)
        accn[h] = fma(-cur.d[h + 1][0], xk, accn[h]);
      if (two) {
        if (lane > k + 1) acc = fma(-cur.d[0][1], x1, acc);
        if (lane == k + 1) xfin = x1;
#pragma unroll
        for (int h = 0; h < kNear; ++h)
          accn[h] = fma(-cur.d[h + 1][1], x1, accn[h]);
      }
    }
    cur = nxt;
  }
}

// a spin of a warp that is not on the chain: back off, so that its polls do
// not crowd the shared-memory pipe the solver's shuffles go through
__device__ __forceinline__ void wait_above(const int* p, int v) {
  while (ld_acquire(p) <= v) __nanosleep(kBackoffNs);
}

__host__ __device__ constexpr int blocks_of(int m) { return (m + kNB - 1) / kNB; }

template <typename T>
__host__ __device__ constexpr int smem_bytes(int m) {
  return 8 * blocks_of(m) * kNB + 8 * kSlots * kSlot +
         static_cast<int>(sizeof(T)) * blocks_of(m) * kNB + 4 * kSync;
}

template <typename T, bool kLower, int THREADS>
__global__ void __launch_bounds__(THREADS, THREADS <= 192 ? 2 : 1)
    blocked_trsv_kernel(const T* __restrict__ lu, const T* __restrict__ b,
                        T* __restrict__ out, int m) {
  using A = double;  // every accumulator (see the note above)
  constexpr int kUpd = THREADS / 32 - 2 - kNear;  // updater warps
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nblk = blocks_of(m);
  const int mpad = nblk * kNB;
  A* s_far = reinterpret_cast<A*>(smem_raw);  // b_K - far columns, per row
  A* s_tile = s_far + mpad;                   // the ring of staged tiles
  T* s_x = reinterpret_cast<T*>(s_tile + kSlots * kSlot);  // finished x
  int* s_done = reinterpret_cast<int*>(s_x + mpad);  // blocks solved
  int* s_ready = s_done + 1;  // blocks staged, per tile of the slot
  int* s_flag = s_ready + 1 + kNear;  // s_far of block K set

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t front = blockIdx.x;
  const T* a = lu + front * m * m;
  const T* bb = b + front * m;
  T* o = out + front * m;
  // logical index t -> row/column of the front: the upper sweep is mirrored
  auto phys = [m](int t) { return kLower ? t : m - 1 - t; };

  if (tid < 2 + kNear + nblk) s_done[tid] = 0;
  __syncthreads();

  if (warp == 0) {
    // ---- the solver
    // the next kNear blocks' rows against the columns solved so far
    A accn[kNear];
#pragma unroll
    for (int h = 0; h < kNear; ++h) accn[h] = A(0);
    // the first blocks take b itself: fetched now, off the chain
    A bfirst[1 + kNear];
#pragma unroll
    for (int h = 0; h <= kNear; ++h) {
      const int t = h * kNB + lane;
      bfirst[h] = t < m ? A(bb[phys(t)]) : A(0);
    }
    for (int K = 0; K < nblk; ++K) {
      const int jb = min(kNB, m - K * kNB);
      const int t = K * kNB + lane;
      const bool valid = lane < jb;
      // the block's row sums and its tiles: polled together, one round trip
      for (;;) {
        bool ok = K <= kNear || ld_acquire(s_flag + K) != 0;
#pragma unroll
        for (int h = 0; h <= kNear; ++h) ok &= ld_acquire(s_ready + h) > K;
        if (ok) break;
      }
      A base = bfirst[0];
      if (K > kNear) {
        base = s_far[t];
      } else {
#pragma unroll
        for (int h = 1; h <= kNear; ++h)
          if (K == h) base = bfirst[h];
      }
      A acc = base + accn[0];
#pragma unroll
      for (int h = 0; h + 1 < kNear; ++h) accn[h] = accn[h + 1];
      accn[kNear - 1] = A(0);
      const A* S = s_tile + (K % kSlots) * kSlot;
      A dg = A(1), rd = A(1);
      if (!kLower) {
        dg = S[lane * kLd + lane];
        rd = S[(1 + kNear) * kTile + lane];
      }
      A xfin = A(0);
      if (jb == kNB)
        solve_block<T, kLower, false>(S, jb, dg, rd, lane, acc, accn, xfin);
      else
        solve_block<T, kLower, true>(S, jb, dg, rd, lane, acc, accn, xfin);
      if (valid) s_x[t] = T(xfin);
      publish(s_done, K + 1, lane);
    }
  } else if (warp <= 1 + kNear) {
    // ---- a loader: warp 1 stages every block's diagonal tile, warp 1 + h
    // the tile h blocks below it. The next block's 32 rows are in flight in
    // registers while this block's are converted and stored. Nothing is
    // masked: rows and columns past m repeat the last one (finite entries
    // that no valid lane reads), and the solver never reads a diagonal
    // tile's other triangle.
    const int below = warp - 1;
    const auto load = [&](int K, T(&v)[kNB]) {
      const T* col = a + phys(min(K * kNB + lane, m - 1));
      const int r0 = (K + below) * kNB;
#pragma unroll
      for (int r = 0; r < kNB; ++r) v[r] = col[phys(min(r0 + r, m - 1)) * m];
    };
    const auto stage = [&](int K, const T(&v)[kNB]) {
      if (K >= kSlots) wait_above(s_done, K - kSlots);
      A* tile = s_tile + (K % kSlots) * kSlot + below * kTile;
#pragma unroll
      for (int r = 0; r < kNB; ++r) tile[r * kLd + lane] = A(v[r]);
      if (!kLower && below == 0) {
        // this lane's pivot is v[lane]: pick it without indexing registers
        A dg = A(1);
#pragma unroll
        for (int r = 0; r < kNB; ++r)
          if (lane == r) dg = A(v[r]);
        tile[(1 + kNear) * kTile + lane] =
            K * kNB + lane < m ? A(1) / dg : A(1);
      }
      publish(s_ready + below, K + 1, lane);
    };
    T va[kNB], vb[kNB];
    load(0, va);
    for (int K = 0; K < nblk; K += 2) {
      if (K + 1 < nblk) load(K + 1, vb);
      stage(K, va);
      if (K + 1 < nblk) {
        if (K + 2 < nblk) load(K + 2, va);
        stage(K + 1, vb);
      }
    }
  } else {
    // ---- an updater: the first takes block kNear + 1, the next the block
    // after, and each every kUpd-th block from there
    for (int K = warp - 1; K < nblk; K += kUpd) {
      const int t = K * kNB + lane;
      const A base = t < m ? A(bb[phys(t)]) : A(0);
      // the block's first row at this lane's column of column block 0; one
      // row on is rstep entries, one column block on jstep; rows past m
      // repeat row m-1
      const T* tile0 = a + static_cast<size_t>(phys(K * kNB)) * m + phys(lane);
      const int rstep = kLower ? m : -m;
      const int jstep = kLower ? kNB : -kNB;
      const int rmax = min(kNB, m - K * kNB) - 1;
      A p[kNB];
      T cur[kNB], nxt[kNB];
#pragma unroll
      for (int r = 0; r < kNB; ++r) {
        p[r] = A(0);
        cur[r] = tile0[min(r, rmax) * rstep];
      }
      for (int J = 0; J < K - kNear; ++J) {
        const bool more = J + 1 < K - kNear;
        if (more) {  // the next tile is in flight during the wait
#pragma unroll
          for (int r = 0; r < kNB; ++r)
            nxt[r] = tile0[min(r, rmax) * rstep + (J + 1) * jstep];
        }
        wait_above(s_done, J);
        const A xj = A(s_x[J * kNB + lane]);
#pragma unroll
        for (int r = 0; r < kNB; ++r) p[r] = fma(A(cur[r]), xj, p[r]);
        if (more) {
#pragma unroll
          for (int r = 0; r < kNB; ++r) cur[r] = nxt[r];
        }
      }
      // transposing butterfly: afterwards p[0] of lane r is row r's sum over
      // the lanes (rows past m repeat row m-1 and are dropped)
      fold<16>(p, lane);
      fold<8>(p, lane);
      fold<4>(p, lane);
      fold<2>(p, lane);
      fold<1>(p, lane);
      s_far[t] = base - p[0];
      publish(s_flag + K, 1, lane);
    }
  }
  // x goes out in one pass of the whole CTA: a global store inside the
  // solver's loop would put its round trip to L2 on the chain
  __syncthreads();
  for (int t = tid; t < m; t += THREADS) o[phys(t)] = s_x[t];
}

struct Plan {
  int cluster, nb, threads, smem;
};

template <typename T>
Plan make_plan(int64_t /*nn*/, int m) {
  Plan p;
  p.cluster = 1;
  p.nb = kNB;
  p.threads = blocks_of(m) <= 8 ? 192 : 320;
  p.smem = smem_bytes<T>(m);
  return p;
}

template <typename T, bool kLower, int THREADS>
cudaError_t prepare(const void** fn) {
  // the shared-memory opt-in is an attribute of the function on one device:
  // it is set once for each device that launches this instantiation
  constexpr int kFlags = 64;
  static std::atomic<bool> ready[kFlags];
  auto kern = blocked_trsv_kernel<T, kLower, THREADS>;
  *fn = reinterpret_cast<const void*>(kern);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kFlags && ready[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < kFlags)
    ready[dev].store(true, std::memory_order_release);
  return err;
}

template <typename T>
cudaError_t kernel_for(int threads, int lower, const void** fn) {
  if (threads == 192)
    return lower ? prepare<T, true, 192>(fn) : prepare<T, false, 192>(fn);
  return lower ? prepare<T, true, 320>(fn) : prepare<T, false, 320>(fn);
}

template <typename T>
int launch(const void* lu, const void* b, void* out, int64_t nn, int m,
           int lower, void* stream) {
  if (nn <= 0 || m <= 0) return 0;
  if (m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan<T>(nn, m);
  const void* fn;
  cudaError_t e = kernel_for<T>(p.threads, lower, &fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  const T* L = static_cast<const T*>(lu);
  const T* B = static_cast<const T*>(b);
  T* O = static_cast<T*>(out);
  void* args[] = {&L, &B, &O, &m};
  e = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(nn * p.cluster)),
                       dim3(p.threads), args, p.smem,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// out[0..5) = cluster size, block width, threads per CTA, dynamic shared
// bytes per CTA, and how many such CTAs one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; 0 when it cannot place
// one).
template <typename T>
int plan(int64_t nn, int m, int* out5) {
  if (m <= 0 || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan<T>(nn, m);
  out5[0] = p.cluster;
  out5[1] = p.nb;
  out5[2] = p.threads;
  out5[3] = p.smem;
  out5[4] = 0;
  const void* fn;
  cudaError_t e = kernel_for<T>(p.threads, 1, &fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out5[4], fn, p.threads,
                                                    p.smem);
  return static_cast<int>(e);
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

int batched_trsv_plan_f32(int64_t nn, int m, int* out5) {
  return plan<float>(nn, m, out5);
}

int batched_trsv_plan_f64(int64_t nn, int m, int* out5) {
  return plan<double>(nn, m, out5);
}

}  // extern "C"
