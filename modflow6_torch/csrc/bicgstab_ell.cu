// Jacobi-preconditioned BiCGSTAB on the ELL system (nbr[N, K], diag[N],
// off[N, K]): the work of one inner iteration between its five dot
// products, as six launches, for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package runs the BiCGSTAB loop
// (modflow6_tpu/ops/solvers/krylov.py:bicgstab) as one lax.while_loop
// that XLA fuses, with the gather product of modflow6_tpu/ops/system.py
// inside it.  Its PyTorch port ran each iteration as ~80 launches of
// elementwise, gather and reduction kernels issued from Python, and the
// host's issue time set the pace.  Here an iteration is
//
//   1. bicgstab_direction_kernel: beta = (rho/rho0)*(alpha0/omega0) with
//      the plain loop's guards; p = d + beta*(p - omega0*v) (p = d on the
//      first iteration) and phat = inv*p;
//   2. bicgstab_ell_kernel:       v = A phat, and w = dhat*v, whose sum the
//      host takes with torch.sum;
//   3. bicgstab_half_kernel:      alpha = rho / (dhat.v + sign*DPREC);
//      q = d - alpha*v and qhat = inv*q;
//   4. bicgstab_ell_kernel:       t = A qhat, and w = t*q, w2 = t*t;
//   5. bicgstab_update_kernel:    omega = t.q / (t.t + sign*DPREC);
//      tv = alpha*phat + omega*qhat, x += tv, d = q - omega*t; w = d*d,
//      w2 = dhat*d (the next rho); each block's signed absolute maxima of
//      tv and d (lowest index on ties);
//   6. bicgstab_finish_kernel:    one block combines the maxima; dvmax,
//      rmax, l2norm = sqrt(d.d), IMS's convergence test for ICNVGOPT 0-4,
//      the rcnvg == 0 rule, the stagnation of rho, alpha and omega and the
//      rho*omega == 0 rule, and the exit flag that the host reads once an
//      iteration.
//
// The plain PyTorch versions of the six are in
// modflow6_torch/ops/solvers/bicgstab_ell.py, with the host loop around
// them.
//
// Bitwise the plain loop's iterates.  The transport that runs this closes
// its inner solves at a residual of inner_rclose, and a solve whose sums
// are taken in another order stops elsewhere inside that closure: its
// concentrations move by up to ~1e-4 at 2 M cells.  So every value here is
// rounded as the plain loop rounds it: the file is compiled with
// -fmad=false and forms each product and sum as krylov.py:bicgstab does; a
// product adds its slots in the order in which torch.sum(dim=1) adds a
// contiguous row of K < 128 values on CUDA (ell_row_sum); and the five dot
// products are torch.sum's of the vectors w that the kernels write, as the
// plain loop's are.  The maxima do not depend on the order.  Two runs give
// the same bits: no atomics.
//
// Bound: device-memory bandwidth.  Per cell and iteration in double, with
// K slots and an index of b bytes: 48 B (direction: inv, d, p, v read, p
// and phat written), 40 + K(8 + b) B (the first product: diag, the slots'
// coefficients and indices, phat and dhat read, v and w written; the
// gathered neighbours come from the cache), 40 B (the half-step: inv, d,
// v read, q and qhat written), 48 + K(8 + b) B (the second product: diag,
// the slots, qhat and q read, t, w and w2 written), 80 B (the update:
// phat, qhat, q, t, dhat, x read, x, d, w and w2 written) and 40 B (the
// five sums' reads): 440 B with K = 6 and int32 indices.
//
// The C entry points launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <climits>

namespace bicgstab {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kNone = LLONG_MAX;       // index of an empty maximum
constexpr double kDprec = 2.220446049250313e-16;  // DPREC, float64 epsilon

// The scalar slots (s[]), the dot products (sums[]), the rows of the
// maxima by block (parts[row * nparts + b], with their indices in
// iparts[]); bicgstab_ell.py names the same slots.
enum Scalar {
  kRho0 = 0, kRho = 1, kAlpha0 = 2, kAlpha = 3, kOmega0 = 4, kOmega = 5,
  kDvmax = 6, kRmax = 7, kL2 = 8
};
enum Sum { kDv = 0, kTq = 1, kTt = 2, kDd = 3, kRd = 4 };
enum Part { kTv = 0, kD = 1 };

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

// x + sign(x)*DPREC, krylov.py's ``denom + _sign_dprec(denom)``
template <typename T>
__device__ __forceinline__ T plus_sign_dprec(T x) {
  return x + (x >= T(0) ? T(kDprec) : T(-kDprec));
}

// krylov.py's _is_close: a == b, or |a - b| within 100 machine epsilons
// of the larger magnitude
template <typename T>
__device__ __forceinline__ bool is_close(T a, T b) {
  const T rtol = static_cast<T>(100.0 * Eps<T>::v);
  const T fa = fabs(a), fb = fabs(b);
  return a == b || fabs(a - b) <= rtol * (fa > fb ? fa : fb);
}

__device__ __forceinline__ long long first_index() {
  return static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * kThreads;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bicgstab_direction_kernel(const T* __restrict__ inv, const T* __restrict__ d,
                          T* __restrict__ p, const T* __restrict__ v,
                          T* __restrict__ phat, const T* __restrict__ s,
                          int first, long long n) {
  if (first) {
    for (long long idx = first_index(); idx < n; idx += grid_stride()) {
      const T pn = d[idx];
      p[idx] = pn;
      phat[idx] = inv[idx] * pn;
    }
    return;
  }
  const T rho0 = s[kRho0], omega0 = s[kOmega0];
  const T beta = (s[kRho] / (rho0 != T(0) ? rho0 : T(1))) *
                 (s[kAlpha0] / (omega0 != T(0) ? omega0 : T(1)));
  for (long long idx = first_index(); idx < n; idx += grid_stride()) {
    const T pn = d[idx] + beta * (p[idx] - omega0 * v[idx]);
    p[idx] = pn;
    phat[idx] = inv[idx] * pn;
  }
}

// The sum of a row's K < 128 slot products c[j]*x[nb[j]] in the order in
// which torch.sum(dim=1) adds a contiguous row of K values on CUDA
// (ATen/native/cuda/Reduce.cuh): BW = min(2^floor(log2 K), 32) lanes, lane
// l taking the values l, l + BW, l + 2 BW, ... into four accumulators in
// turn, which it adds as ((v0 + v1) + v2) + v3; then the lanes pairwise,
// lane l + o into lane l for o = BW/2, ..., 1.
template <typename T, typename I, int BW>
__device__ __forceinline__ T ell_row_sum(const I* __restrict__ nb,
                                         const T* __restrict__ c,
                                         const T* __restrict__ x, int k) {
  T lane[BW];
#pragma unroll
  for (int l = 0; l < BW; ++l) {
    T v0 = T(0), v1 = T(0), v2 = T(0), v3 = T(0);
    int j = l;
    for (; j + 3 * BW < k; j += 4 * BW) {
      v0 = v0 + c[j] * x[nb[j]];
      v1 = v1 + c[j + BW] * x[nb[j + BW]];
      v2 = v2 + c[j + 2 * BW] * x[nb[j + 2 * BW]];
      v3 = v3 + c[j + 3 * BW] * x[nb[j + 3 * BW]];
    }
    if (j < k) {
      v0 = v0 + c[j] * x[nb[j]];
      j += BW;
      if (j < k) {
        v1 = v1 + c[j] * x[nb[j]];
        j += BW;
        if (j < k) v2 = v2 + c[j] * x[nb[j]];
      }
    }
    lane[l] = ((v0 + v1) + v2) + v3;
  }
#pragma unroll
  for (int o = BW / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int l = 0; l < o; ++l) lane[l] = lane[l] + lane[l + o];
  }
  return lane[0];
}

// y = A x = diag*x + (the row's slot products, ell_row_sum), as
// ops/system.py:spmv; then w = u*y (kTwo false: u = dhat), or w = y*u and
// w2 = y*y (kTwo: u = q).
template <typename T, typename I, int BW, bool kTwo>
__global__ void __launch_bounds__(kThreads)
bicgstab_ell_kernel(const I* __restrict__ nbr, const T* __restrict__ diag,
                    const T* __restrict__ off, const T* __restrict__ x,
                    T* __restrict__ y, const T* __restrict__ u,
                    T* __restrict__ w, T* __restrict__ w2, long long n,
                    int k) {
  for (long long idx = first_index(); idx < n; idx += grid_stride()) {
    const T yi = diag[idx] * x[idx] +
                 ell_row_sum<T, I, BW>(nbr + idx * k, off + idx * k, x, k);
    y[idx] = yi;
    const T ui = u[idx];
    if (kTwo) {
      w[idx] = yi * ui;
      w2[idx] = yi * yi;
    } else {
      w[idx] = ui * yi;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bicgstab_half_kernel(const T* __restrict__ inv, const T* __restrict__ d,
                     const T* __restrict__ v, T* __restrict__ q,
                     T* __restrict__ qhat, const T* __restrict__ sums,
                     T* __restrict__ s, long long n) {
  const T alpha = s[kRho] / plus_sign_dprec(sums[kDv]);
  if (blockIdx.x == 0 && threadIdx.x == 0) s[kAlpha] = alpha;
  for (long long idx = first_index(); idx < n; idx += grid_stride()) {
    const T qn = d[idx] - alpha * v[idx];
    q[idx] = qn;
    qhat[idx] = inv[idx] * qn;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bicgstab_update_kernel(const T* __restrict__ phat, const T* __restrict__ qhat,
                       const T* __restrict__ q, const T* __restrict__ t,
                       const T* __restrict__ dhat, T* __restrict__ x,
                       T* __restrict__ d, T* __restrict__ w,
                       T* __restrict__ w2, const T* __restrict__ sums,
                       T* __restrict__ parts, long long* __restrict__ iparts,
                       T* __restrict__ s, long long n) {
  __shared__ T sh_tv[kWarps], sh_d[kWarps];
  __shared__ long long sh_tvi[kWarps], sh_di[kWarps];
  const T omega = sums[kTq] / plus_sign_dprec(sums[kTt]);
  const T alpha = s[kAlpha];
  if (blockIdx.x == 0 && threadIdx.x == 0) s[kOmega] = omega;

  T tvmax = T(0), dmax = T(0);
  long long tvi = kNone, di = kNone;
  for (long long idx = first_index(); idx < n; idx += grid_stride()) {
    const T tv = alpha * phat[idx] + omega * qhat[idx];
    x[idx] = x[idx] + tv;
    const T dn = q[idx] - omega * t[idx];
    d[idx] = dn;
    w[idx] = dn * dn;
    w2[idx] = dhat[idx] * dn;
    if (before(tv, idx, tvmax, tvi)) {
      tvmax = tv;
      tvi = idx;
    }
    if (before(dn, idx, dmax, di)) {
      dmax = dn;
      di = idx;
    }
  }
  block_absmax(tvmax, tvi, sh_tv, sh_tvi);
  block_absmax(dmax, di, sh_d, sh_di);
  if (threadIdx.x == 0) {
    parts[kTv * gridDim.x + blockIdx.x] = tvmax;
    parts[kD * gridDim.x + blockIdx.x] = dmax;
    iparts[kTv * gridDim.x + blockIdx.x] = tvi;
    iparts[kD * gridDim.x + blockIdx.x] = di;
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
bicgstab_finish_kernel(const T* __restrict__ sums,
                       const T* __restrict__ parts,
                       const long long* __restrict__ iparts, int nparts,
                       T* __restrict__ s, int* __restrict__ flags,
                       const double* __restrict__ lim, double dvclose,
                       double rclose, int icnvgopt, int iiter0) {
  __shared__ T sh_tv[kWarps], sh_d[kWarps];
  __shared__ long long sh_tvi[kWarps], sh_di[kWarps];
  T tvmax = T(0), dmax = T(0);
  long long tvi = kNone, di = kNone;
  for (int b = threadIdx.x; b < nparts; b += kThreads) {
    const T tv = parts[kTv * nparts + b];
    const long long ti = iparts[kTv * nparts + b];
    if (before(tv, ti, tvmax, tvi)) {
      tvmax = tv;
      tvi = ti;
    }
    const T dv = parts[kD * nparts + b];
    const long long dj = iparts[kD * nparts + b];
    if (before(dv, dj, dmax, di)) {
      dmax = dv;
      di = dj;
    }
  }
  block_absmax(tvmax, tvi, sh_tv, sh_tvi);
  block_absmax(dmax, di, sh_d, sh_di);
  if (threadIdx.x != 0) return;

  const T l2 = sqrt(sums[kDd]);
  const T rcnvg = icnvgopt >= 2 ? l2 : dmax;
  int icnvg = test_cnvg<T>(icnvgopt, iiter0, tvmax, rcnvg, *lim,
                           static_cast<T>(dvclose), static_cast<T>(rclose));
  if (rcnvg == T(0)) icnvg = 1;
  const T rho = s[kRho], alpha = s[kAlpha], omega = s[kOmega];
  const bool stagnant = is_close(rho, s[kRho0]) ||
                        is_close(alpha, s[kAlpha0]) ||
                        is_close(omega, s[kOmega0]);
  flags[0] = icnvg != 0 || stagnant || rho * omega == T(0);
  flags[1] = icnvg;
  s[kRho0] = rho;
  s[kAlpha0] = alpha;
  s[kOmega0] = omega;
  s[kRho] = sums[kRd];
  s[kDvmax] = tvmax;
  s[kRmax] = dmax;
  s[kL2] = l2;
}

// The lanes of ell_row_sum for a row of k slots: 2^floor(log2 k), at most
// 32.
inline int row_lanes(int k) {
  int bw = 1;
  while (bw < 32 && 2 * bw <= k) bw *= 2;
  return bw;
}

template <typename T, typename I, bool kTwo>
const void* ell_kernel(int bw) {
  switch (bw) {
    case 1: return reinterpret_cast<const void*>(bicgstab_ell_kernel<T, I, 1, kTwo>);
    case 2: return reinterpret_cast<const void*>(bicgstab_ell_kernel<T, I, 2, kTwo>);
    case 4: return reinterpret_cast<const void*>(bicgstab_ell_kernel<T, I, 4, kTwo>);
    case 8: return reinterpret_cast<const void*>(bicgstab_ell_kernel<T, I, 8, kTwo>);
    case 16: return reinterpret_cast<const void*>(bicgstab_ell_kernel<T, I, 16, kTwo>);
    default: return reinterpret_cast<const void*>(bicgstab_ell_kernel<T, I, 32, kTwo>);
  }
}

template <typename T>
int max_blocks(int device, int k, int* out) {
  int sms = 0, least = INT_MAX, b = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bw = row_lanes(k);
  const void* kernels[] = {
      reinterpret_cast<const void*>(bicgstab_direction_kernel<T>),
      ell_kernel<T, int, false>(bw), ell_kernel<T, int, true>(bw),
      ell_kernel<T, long long, false>(bw), ell_kernel<T, long long, true>(bw),
      reinterpret_cast<const void*>(bicgstab_half_kernel<T>),
      reinterpret_cast<const void*>(bicgstab_update_kernel<T>)};
  for (const void* kern : kernels) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kern, kThreads, 0);
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
int direction(const void* inv, const void* d, void* p, const void* v,
              void* phat, const void* s, int first, long long n, int nblk,
              void* stream) {
  bicgstab_direction_kernel<T><<<nblk, kThreads, 0, as_stream(stream)>>>(
      static_cast<const T*>(inv), static_cast<const T*>(d),
      static_cast<T*>(p), static_cast<const T*>(v), static_cast<T*>(phat),
      static_cast<const T*>(s), first, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I, bool kTwo>
void launch_ell(int bw, int nblk, cudaStream_t st, const I* nb, const T* dg,
                const T* of, const T* x, T* y, const T* u, T* w, T* w2,
                long long n, int k) {
#define BICGSTAB_ELL_CASE(BW)                                               \
  case BW:                                                                 \
    bicgstab_ell_kernel<T, I, BW, kTwo><<<nblk, kThreads, 0, st>>>(       \
        nb, dg, of, x, y, u, w, w2, n, k);                                 \
    break;
  switch (bw) {
    BICGSTAB_ELL_CASE(1)
    BICGSTAB_ELL_CASE(2)
    BICGSTAB_ELL_CASE(4)
    BICGSTAB_ELL_CASE(8)
    BICGSTAB_ELL_CASE(16)
    default:
      bicgstab_ell_kernel<T, I, 32, kTwo><<<nblk, kThreads, 0, st>>>(
          nb, dg, of, x, y, u, w, w2, n, k);
  }
#undef BICGSTAB_ELL_CASE
}

template <typename T, typename I>
int product(const void* nbr, const void* diag, const void* off,
            const void* x, void* y, const void* u, void* w, void* w2,
            long long n, int k, int two, int nblk, void* stream) {
  const int bw = row_lanes(k);
  const I* nb = static_cast<const I*>(nbr);
  const T* dg = static_cast<const T*>(diag);
  const T* of = static_cast<const T*>(off);
  const T* xx = static_cast<const T*>(x);
  const T* uu = static_cast<const T*>(u);
  T* yy = static_cast<T*>(y);
  T* ww = static_cast<T*>(w);
  T* ww2 = static_cast<T*>(w2);
  if (two)
    launch_ell<T, I, true>(bw, nblk, as_stream(stream), nb, dg, of, xx, yy,
                           uu, ww, ww2, n, k);
  else
    launch_ell<T, I, false>(bw, nblk, as_stream(stream), nb, dg, of, xx, yy,
                            uu, ww, ww2, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int half(const void* inv, const void* d, const void* v, void* q, void* qhat,
         const void* sums, void* s, long long n, int nblk, void* stream) {
  bicgstab_half_kernel<T><<<nblk, kThreads, 0, as_stream(stream)>>>(
      static_cast<const T*>(inv), static_cast<const T*>(d),
      static_cast<const T*>(v), static_cast<T*>(q), static_cast<T*>(qhat),
      static_cast<const T*>(sums), static_cast<T*>(s), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int update(const void* phat, const void* qhat, const void* q, const void* t,
           const void* dhat, void* x, void* d, void* w, void* w2,
           const void* sums, void* parts, void* iparts, void* s, long long n,
           int nblk, void* stream) {
  bicgstab_update_kernel<T><<<nblk, kThreads, 0, as_stream(stream)>>>(
      static_cast<const T*>(phat), static_cast<const T*>(qhat),
      static_cast<const T*>(q), static_cast<const T*>(t),
      static_cast<const T*>(dhat), static_cast<T*>(x), static_cast<T*>(d),
      static_cast<T*>(w), static_cast<T*>(w2), static_cast<const T*>(sums),
      static_cast<T*>(parts), static_cast<long long*>(iparts),
      static_cast<T*>(s), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int finish(const void* sums, const void* parts, const void* iparts,
           int nparts, void* s, void* flags, const void* lim, double dvclose,
           double rclose, int icnvgopt, int iiter0, void* stream) {
  bicgstab_finish_kernel<T><<<1, kThreads, 0, as_stream(stream)>>>(
      static_cast<const T*>(sums), static_cast<const T*>(parts),
      static_cast<const long long*>(iparts), nparts, static_cast<T*>(s),
      static_cast<int*>(flags), static_cast<const double*>(lim), dvclose,
      rclose, icnvgopt, iiter0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bicgstab

#define BICGSTAB_PRODUCT(SFX, ISFX, T, I)                                    \
  extern "C" int bicgstab_product_##ISFX##_##SFX(                            \
      const void* nbr, const void* diag, const void* off, const void* x,     \
      void* y, const void* u, void* w, void* w2, long long n, int k,         \
      int two, int nblk, void* stream) {                                     \
    return bicgstab::product<T, I>(nbr, diag, off, x, y, u, w, w2, n, k,     \
                                   two, nblk, stream);                       \
  }

#define BICGSTAB_ENTRY_POINTS(SFX, T)                                        \
  extern "C" int bicgstab_max_blocks_##SFX(int device, int k, int* out) {    \
    return bicgstab::max_blocks<T>(device, k, out);                          \
  }                                                                          \
  extern "C" int bicgstab_direction_##SFX(                                   \
      const void* inv, const void* d, void* p, const void* v, void* phat,    \
      const void* s, int first, long long n, int nblk, void* stream) {       \
    return bicgstab::direction<T>(inv, d, p, v, phat, s, first, n, nblk,     \
                                  stream);                                   \
  }                                                                          \
  BICGSTAB_PRODUCT(SFX, i32, T, int)                                         \
  BICGSTAB_PRODUCT(SFX, i64, T, long long)                                   \
  extern "C" int bicgstab_half_##SFX(const void* inv, const void* d,         \
                                     const void* v, void* q, void* qhat,     \
                                     const void* sums, void* s, long long n, \
                                     int nblk, void* stream) {               \
    return bicgstab::half<T>(inv, d, v, q, qhat, sums, s, n, nblk, stream);  \
  }                                                                          \
  extern "C" int bicgstab_update_##SFX(                                      \
      const void* phat, const void* qhat, const void* q, const void* t,      \
      const void* dhat, void* x, void* d, void* w, void* w2,                 \
      const void* sums, void* parts, void* iparts, void* s, long long n,     \
      int nblk, void* stream) {                                              \
    return bicgstab::update<T>(phat, qhat, q, t, dhat, x, d, w, w2, sums,    \
                               parts, iparts, s, n, nblk, stream);           \
  }                                                                          \
  extern "C" int bicgstab_finish_##SFX(                                      \
      const void* sums, const void* parts, const void* iparts, int nparts,   \
      void* s, void* flags, const void* lim, double dvclose, double rclose,  \
      int icnvgopt, int iiter0, void* stream) {                              \
    return bicgstab::finish<T>(sums, parts, iparts, nparts, s, flags, lim,   \
                               dvclose, rclose, icnvgopt, iiter0, stream);   \
  }

BICGSTAB_ENTRY_POINTS(f32, float)
BICGSTAB_ENTRY_POINTS(f64, double)

extern "C" const char* bicgstab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
