// Jacobi-preconditioned conjugate gradient on the structured 7-point
// system, one inner iteration as four launches, for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package runs the CG loop
// (modflow6_tpu/ops/solvers/krylov.py:cg) as one lax.while_loop that XLA
// fuses.  Its PyTorch port ran each iteration as ~60 launches of
// elementwise and reduction kernels issued from Python, and the host's
// issue time set the pace.  Here an iteration is
//
//   1. pcg_direction_kernel:    beta = rho / rho0 (0 on the first
//      iteration); p = inv*d + beta*p, z = inv*d kept in registers;
//   2. pcg_stencil7_dot_kernel: q = A p with stencil7_kernel's terms in
//      its order (csrc/stencil7.cu), and each block's partial sum of p.q;
//   3. pcg_update_kernel:       alpha = rho / (p.q + sign*DPREC) from the
//      partials of 2; tv = alpha*p, x += tv, d -= alpha*q; each block's
//      signed absolute maxima of tv and d (lowest index on ties), and
//      partial sums of d.d and of the next rho = d.(inv*d);
//   4. pcg_finish_kernel:       one block sums the partials, computes
//      dvmax, rmax, l2norm, IMS's convergence test for ICNVGOPT 0-4, the
//      rcnvg == 0 rule and the stagnation of rho, and writes the exit flag
//      that the host reads once an iteration.
//
// The plain PyTorch versions of the four are in
// modflow6_torch/ops/solvers/pcg_jacobi.py, with the host loop around them.
//
// Bound: device-memory bandwidth.  Per cell and iteration the kernels move
// 32 + 72 + 56 = 160 B in double (inv, d and p read, p written; diag, six
// coefficients and p read, q written; inv, p, q, x and d read, x and d
// written), against ~350 B for the unfused loop, for about 30 operations.
//
// Reductions are deterministic: no atomics.  The three grid kernels run
// one fixed grid (every block resident at once, grid-stride loops), so
// there are a few hundred partials per sum, which the next kernel adds in
// a fixed order; two runs give the same bits.  The file is compiled with
// -fmad=false, and every product and sum is formed as the plain loop forms
// it, so the elementwise results are rounded as there; only the order of
// the sums differs.
//
// The C entry points launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <climits>

namespace pcg {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kNone = LLONG_MAX;       // index of an empty maximum
constexpr double kDprec = 2.220446049250313e-16;  // DPREC, float64 epsilon

// The scalar slots (s[]), the partial-sum rows (parts[row * nparts + b])
// and the index rows (iparts[row * nparts + b]); pcg_jacobi.py names the
// same slots.
enum Scalar { kRho0 = 0, kRho = 1, kDvmax = 2, kRmax = 3, kL2 = 4 };
enum Part { kPq = 0, kDd = 1, kRd = 2, kTv = 3, kD = 4 };
enum IPart { kTvIdx = 0, kDIdx = 1 };

template <typename T> struct Eps;
template <> struct Eps<float> { static constexpr double v = 1.1920928955078125e-07; };
template <> struct Eps<double> { static constexpr double v = 2.220446049250313e-16; };

// Does (a, ia) come before (b, ib) in torch.argmax(v.abs())'s order:
// NaN first, then the larger magnitude, then the lower index.
template <typename T>
__device__ __forceinline__ bool before(T a, long long ia, T b, long long ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na) {
    const T fa = fabs(a), fb = fabs(b);
    if (fa != fb) return fa > fb;
  }
  return ia < ib;
}

// Sum over the block in a fixed order; the result is thread 0's.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* sh) {
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(kFull, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sh[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v = v + __shfl_down_sync(kFull, v, o);
  }
  return v;
}

template <typename T>
__device__ __forceinline__ void warp_absmax(T& v, long long& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const T ov = __shfl_down_sync(kFull, v, o);
    const long long oi = __shfl_down_sync(kFull, i, o);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Signed absolute maximum over the block; the result is thread 0's.
template <typename T>
__device__ __forceinline__ void block_absmax(T& v, long long& i, T* shv,
                                             long long* shi) {
  warp_absmax(v, i);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    shv[warp] = v;
    shi[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? shv[lane] : T(0);
    i = lane < kWarps ? shi[lane] : kNone;
    warp_absmax(v, i);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pcg_direction_kernel(const T* __restrict__ inv, const T* __restrict__ d,
                     T* __restrict__ p, const T* __restrict__ s, int first,
                     long long n) {
  T beta = T(0);
  if (!first) {
    const T rho0 = s[kRho0];
    beta = s[kRho] / (rho0 != T(0) ? rho0 : T(1));
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
       idx < n; idx += stride) {
    const T z = inv[idx] * d[idx];
    p[idx] = z + beta * p[idx];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pcg_stencil7_dot_kernel(const T* __restrict__ diag, const T* __restrict__ off,
                        const T* __restrict__ x, T* __restrict__ y,
                        T* __restrict__ parts, int nlay, int nrow, int ncol) {
  __shared__ T sh[kWarps];
  const long long ncpl = static_cast<long long>(nrow) * ncol;
  const long long n = ncpl * nlay;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  T dot = T(0);
  for (long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
       idx < n; idx += stride) {
    const int j = static_cast<int>(idx % ncol);
    const int i = static_cast<int>((idx / ncol) % nrow);
    const int k = static_cast<int>(idx / ncpl);
    const T* c = off + 6 * idx;
    const T xc = x[idx];
    T acc = diag[idx] * xc;
    if (j + 1 < ncol) acc = acc + c[0] * x[idx + 1];     // east
    if (j > 0) acc = acc + c[1] * x[idx - 1];            // west
    if (i > 0) acc = acc + c[2] * x[idx - ncol];         // north
    if (i + 1 < nrow) acc = acc + c[3] * x[idx + ncol];  // south
    if (k > 0) acc = acc + c[4] * x[idx - ncpl];         // up
    if (k + 1 < nlay) acc = acc + c[5] * x[idx + ncpl];  // down
    y[idx] = acc;
    dot = dot + xc * acc;
  }
  dot = block_sum(dot, sh);
  if (threadIdx.x == 0) parts[kPq * gridDim.x + blockIdx.x] = dot;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pcg_update_kernel(const T* __restrict__ inv, const T* __restrict__ p,
                  const T* __restrict__ q, T* __restrict__ x,
                  T* __restrict__ d, T* __restrict__ parts,
                  long long* __restrict__ iparts, const T* __restrict__ s,
                  long long n) {
  __shared__ T sh_pq[kWarps], sh_dd[kWarps], sh_rd[kWarps];
  __shared__ T sh_tv[kWarps], sh_d[kWarps];
  __shared__ long long sh_tvi[kWarps], sh_di[kWarps];
  __shared__ T sh_alpha;
  const int nparts = gridDim.x;
  // p.q from the product's partials, the same sum in every block
  T pq = T(0);
  for (int b = threadIdx.x; b < nparts; b += kThreads)
    pq = pq + parts[kPq * nparts + b];
  pq = block_sum(pq, sh_pq);
  if (threadIdx.x == 0) {
    const T eps = pq >= T(0) ? T(kDprec) : T(-kDprec);
    sh_alpha = s[kRho] / (pq + eps);
  }
  __syncthreads();
  const T alpha = sh_alpha;

  T dd = T(0), rd = T(0), tvmax = T(0), dmax = T(0);
  long long tvi = kNone, di = kNone;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
       idx < n; idx += stride) {
    const T tv = alpha * p[idx];
    x[idx] = x[idx] + tv;
    const T dn = d[idx] - alpha * q[idx];
    d[idx] = dn;
    if (before(tv, idx, tvmax, tvi)) {
      tvmax = tv;
      tvi = idx;
    }
    if (before(dn, idx, dmax, di)) {
      dmax = dn;
      di = idx;
    }
    dd = dd + dn * dn;
    const T z = inv[idx] * dn;
    rd = rd + dn * z;
  }
  dd = block_sum(dd, sh_dd);
  rd = block_sum(rd, sh_rd);
  block_absmax(tvmax, tvi, sh_tv, sh_tvi);
  block_absmax(dmax, di, sh_d, sh_di);
  if (threadIdx.x == 0) {
    parts[kDd * nparts + blockIdx.x] = dd;
    parts[kRd * nparts + blockIdx.x] = rd;
    parts[kTv * nparts + blockIdx.x] = tvmax;
    parts[kD * nparts + blockIdx.x] = dmax;
    iparts[kTvIdx * nparts + blockIdx.x] = tvi;
    iparts[kDIdx * nparts + blockIdx.x] = di;
  }
}

// IMS's inner convergence test (ImsLinearBase.f90 ims_base_testcnvg), as
// modflow6_torch/ops/solvers/krylov.py:_test_cnvg makes it: the closures
// compared in the working type, the relative limit ``lim`` (l2norm0 times
// epfact, or times rclose for ICNVGOPT 3) in double, which is exact
// whichever type the plain loop compares it in.
template <typename T>
__device__ int test_cnvg(int icnvgopt, int iiter0, T dvmax, T rcnvg,
                         double lim, T dvclose, T rclose) {
  const bool advclose = fabs(dvmax) <= dvclose;
  const bool under_lim = static_cast<double>(rcnvg) <= lim;
  switch (icnvgopt) {
    case 0:
      return advclose && fabs(rcnvg) <= rclose ? 1 : 0;
    case 1:
      return advclose && fabs(rcnvg) <= rclose ? (iiter0 == 0 ? 1 : -1) : 0;
    case 2:
      return advclose || rcnvg <= rclose ? 1 : (under_lim ? -1 : 0);
    case 3:
      return advclose ? 1 : (under_lim ? -1 : 0);
    default:
      return advclose && rcnvg <= rclose ? 1 : (under_lim ? -1 : 0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pcg_finish_kernel(const T* __restrict__ parts,
                  const long long* __restrict__ iparts, int nparts,
                  T* __restrict__ s, int* __restrict__ flags,
                  const double* __restrict__ lim, double dvclose,
                  double rclose, int icnvgopt, int iiter0) {
  __shared__ T sh_dd[kWarps], sh_rd[kWarps], sh_tv[kWarps], sh_d[kWarps];
  __shared__ long long sh_tvi[kWarps], sh_di[kWarps];
  T dd = T(0), rd = T(0), tvmax = T(0), dmax = T(0);
  long long tvi = kNone, di = kNone;
  for (int b = threadIdx.x; b < nparts; b += kThreads) {
    dd = dd + parts[kDd * nparts + b];
    rd = rd + parts[kRd * nparts + b];
    const T tv = parts[kTv * nparts + b];
    const long long ti = iparts[kTvIdx * nparts + b];
    if (before(tv, ti, tvmax, tvi)) {
      tvmax = tv;
      tvi = ti;
    }
    const T dv = parts[kD * nparts + b];
    const long long dj = iparts[kDIdx * nparts + b];
    if (before(dv, dj, dmax, di)) {
      dmax = dv;
      di = dj;
    }
  }
  dd = block_sum(dd, sh_dd);
  rd = block_sum(rd, sh_rd);
  block_absmax(tvmax, tvi, sh_tv, sh_tvi);
  block_absmax(dmax, di, sh_d, sh_di);
  if (threadIdx.x != 0) return;

  const T l2 = sqrt(dd);
  const T rcnvg = icnvgopt >= 2 ? l2 : dmax;
  int icnvg = test_cnvg<T>(icnvgopt, iiter0, tvmax, rcnvg, *lim,
                           static_cast<T>(dvclose), static_cast<T>(rclose));
  if (rcnvg == T(0)) icnvg = 1;
  // stagnation: rho within 100 machine epsilons of the previous rho
  const T rho = s[kRho], rho0 = s[kRho0];
  const T rtol = static_cast<T>(100.0 * Eps<T>::v);
  const T arho = fabs(rho), arho0 = fabs(rho0);
  const bool stagnant =
      rho == rho0 || fabs(rho - rho0) <= rtol * (arho > arho0 ? arho : arho0);
  flags[0] = icnvg != 0 || stagnant || rho == T(0);
  flags[1] = icnvg;
  s[kRho0] = rho;
  s[kRho] = rd;
  s[kDvmax] = tvmax;
  s[kRmax] = dmax;
  s[kL2] = l2;
}

template <typename T>
int max_blocks(int device, int* out) {
  int sms = 0, least = INT_MAX, b = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* kernels[] = {
      reinterpret_cast<const void*>(pcg_direction_kernel<T>),
      reinterpret_cast<const void*>(pcg_stencil7_dot_kernel<T>),
      reinterpret_cast<const void*>(pcg_update_kernel<T>)};
  for (const void* k : kernels) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, k, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    least = b < least ? b : least;
  }
  *out = sms * least;
  return 0;
}

inline cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

template <typename T>
int direction(const void* inv, const void* d, void* p, const void* s,
              int first, long long n, int nblk, void* stream) {
  pcg_direction_kernel<T><<<nblk, kThreads, 0, as_stream(stream)>>>(
      static_cast<const T*>(inv), static_cast<const T*>(d),
      static_cast<T*>(p), static_cast<const T*>(s), first, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int product(const void* diag, const void* off, const void* p, void* q,
            void* parts, int nlay, int nrow, int ncol, int nblk,
            void* stream) {
  pcg_stencil7_dot_kernel<T><<<nblk, kThreads, 0, as_stream(stream)>>>(
      static_cast<const T*>(diag), static_cast<const T*>(off),
      static_cast<const T*>(p), static_cast<T*>(q), static_cast<T*>(parts),
      nlay, nrow, ncol);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int update(const void* inv, const void* p, const void* q, void* x, void* d,
           void* parts, void* iparts, const void* s, long long n, int nblk,
           void* stream) {
  pcg_update_kernel<T><<<nblk, kThreads, 0, as_stream(stream)>>>(
      static_cast<const T*>(inv), static_cast<const T*>(p),
      static_cast<const T*>(q), static_cast<T*>(x), static_cast<T*>(d),
      static_cast<T*>(parts), static_cast<long long*>(iparts),
      static_cast<const T*>(s), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int finish(const void* parts, const void* iparts, int nparts, void* s,
           void* flags, const void* lim, double dvclose, double rclose,
           int icnvgopt, int iiter0, void* stream) {
  pcg_finish_kernel<T><<<1, kThreads, 0, as_stream(stream)>>>(
      static_cast<const T*>(parts), static_cast<const long long*>(iparts),
      nparts, static_cast<T*>(s), static_cast<int*>(flags),
      static_cast<const double*>(lim), dvclose, rclose, icnvgopt, iiter0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pcg

#define PCG_ENTRY_POINTS(SFX, T)                                            \
  extern "C" int pcg_max_blocks_##SFX(int device, int* out) {               \
    return pcg::max_blocks<T>(device, out);                                 \
  }                                                                         \
  extern "C" int pcg_direction_##SFX(const void* inv, const void* d,        \
                                     void* p, const void* s, int first,     \
                                     long long n, int nblk, void* stream) { \
    return pcg::direction<T>(inv, d, p, s, first, n, nblk, stream);         \
  }                                                                         \
  extern "C" int pcg_product_##SFX(const void* diag, const void* off,       \
                                   const void* p, void* q, void* parts,     \
                                   int nlay, int nrow, int ncol, int nblk,  \
                                   void* stream) {                          \
    return pcg::product<T>(diag, off, p, q, parts, nlay, nrow, ncol, nblk,  \
                           stream);                                         \
  }                                                                         \
  extern "C" int pcg_update_##SFX(const void* inv, const void* p,           \
                                  const void* q, void* x, void* d,          \
                                  void* parts, void* iparts, const void* s, \
                                  long long n, int nblk, void* stream) {    \
    return pcg::update<T>(inv, p, q, x, d, parts, iparts, s, n, nblk,       \
                          stream);                                          \
  }                                                                         \
  extern "C" int pcg_finish_##SFX(const void* parts, const void* iparts,    \
                                  int nparts, void* s, void* flags,         \
                                  const void* lim, double dvclose,          \
                                  double rclose, int icnvgopt, int iiter0,  \
                                  void* stream) {                           \
    return pcg::finish<T>(parts, iparts, nparts, s, flags, lim, dvclose,    \
                          rclose, icnvgopt, iiter0, stream);                \
  }

PCG_ENTRY_POINTS(f32, float)
PCG_ENTRY_POINTS(f64, double)

extern "C" const char* pcg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
