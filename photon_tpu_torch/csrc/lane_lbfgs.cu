// L-BFGS for Hopper (sm_90a), plain C interface for ctypes: the lane-batched
// solve of random-effect buckets (lane_lbfgs), and below it the one-lane
// iteration of a fixed effect over many rows (solo_head, solo_search).
//
// Replaces no TPU kernel: the JAX package solves a random-effect bucket as
// one vmapped lax.while_loop (RandomEffectCoordinate._solve_bucket,
// photon_tpu/game/coordinate.py:883-954), which XLA compiles into one
// program. The port's plain version of that solve is a Python loop of
// tensor ops over the lane axis (optimize/lbfgs.py minimize_lbfgs with
// optimize/linesearch.py wolfe_search_phi and the margin-space oracle of
// ops/objective.py), which on the card issues ~50-200 kernels of 1-2 µs
// between host syncs, one sync per iteration and per line-search trial.
// This kernel runs the whole solve of every lane of a bucket in one launch.
//
// Per lane (an entity's independent GLM), with rows r and coefficients β:
//
//   f(β) = Σ_r w_r·loss(x_r·β + o_r, y_r) + ½λ‖β‖²
//
// for the four losses of ops/losses.py, solved by L-BFGS exactly as the
// plain loop decides it: the absolute tolerances from the zero state, the
// initial evaluation, then per iteration the two-loop direction (fallback
// −g when it does not descend), the first step 1/‖g‖ capped at 1 while
// there are no pairs, the strong-Wolfe search on the carried margins
// z + α·z_d with its bracketing and zoom stages, the accepted gradient
// from those margins, the curvature update guarded by sᵀy > 1e-10, the
// convergence check in the reference's order; then one exact
// re-evaluation at the last point. Every OptimizeResult field is written,
// with the plain loop's counts.
//
// What bounds it on this card: latency. A lane's work is a few tens of
// passes over rows·d values (a few KB to tens of KB), and each pass ends
// in a reduction whose result decides the next step, so the time is the
// chain of dependent block reductions, not bytes or operations.
//
// Design:
// - One CTA per lane (blockIdx.x), min(256, rows rounded up to a warp)
//   threads; thread t owns the rows t, t + blockDim, ... in every phase.
// - Shared memory holds the lane's state: labels, weights, the carried
//   margins z and z_d (z_d's buffer also holds w·loss′ for the gradient),
//   the iterate, gradient and direction, the (s, y) history and ρ, and
//   the features themselves when the whole CTA stays under kFeatureSmem
//   (a user lane of 256 × 20 float32 is 21 KB); otherwise the features
//   are read from global memory at each pass. Nothing is allocated in
//   global memory besides the result tensors the wrapper passes.
// - Scalars of the line search and the convergence test are computed by
//   every thread, identically, from block-wide sums broadcast through
//   shared memory; vector steps (the two-loop recursion, the curvature
//   update) run on warp 0 with the lane's d ≤ 64 values two to a thread.
// - Sums in a fixed order and in double: a thread's rows in order, a
//   warp's xor butterfly, then the warps in order; no atomics. So a
//   lane's result depends neither on the number of lanes in the launch
//   nor on the run.
// - Loss values and derivatives, the iterate and the line search's
//   scalars are computed in the lane's type, as the plain loop does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxDim = 64;           // two coefficients per thread of warp 0
constexpr int kMaxCorrections = 32;   // one α per lane of warp 0
constexpr int kMaxRows = 4096;
constexpr int kFeatureSmem = 96 * 1024;  // features in shared memory up to this CTA size
constexpr int kMaxSmem = 227 * 1024;
constexpr int kScalars = 16;
constexpr unsigned kFull = 0xffffffffu;

enum Loss : int { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };
enum Reason : int {
  kNotConverged = 0, kMaxIterations = 1, kFunctionValues = 2, kGradient = 3, kNotImproving = 4
};

__device__ __forceinline__ float ex(float v) { return expf(v); }
__device__ __forceinline__ double ex(double v) { return exp(v); }
__device__ __forceinline__ float lg1p(float v) { return log1pf(v); }
__device__ __forceinline__ double lg1p(double v) { return log1p(v); }
__device__ __forceinline__ float ab(float v) { return fabsf(v); }
__device__ __forceinline__ double ab(double v) { return fabs(v); }
// false for ±inf and NaN (inf − inf and NaN − NaN are NaN)
template <typename T> __device__ __forceinline__ bool is_finite(T v) { return v - v == T(0); }

// torch.clamp / minimum / maximum propagate NaN; these do too
template <typename T> __device__ __forceinline__ T at_least(T v, T lo) { return v < lo ? lo : v; }
template <typename T> __device__ __forceinline__ T at_most(T v, T hi) { return v > hi ? hi : v; }
template <typename T> __device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a || b != b) ? (a + b) : (a < b ? a : b);
}
template <typename T> __device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || b != b) ? (a + b) : (a > b ? a : b);
}

// log(1 + exp(v)) = max(v, 0) + log1p(exp(-|v|))
template <typename T> __device__ __forceinline__ T log1p_exp(T v) {
  return at_least(v, T(0)) + lg1p(ex(-ab(v)));
}

template <typename T> __device__ __forceinline__ T sigmoid(T v) {
  const T e = ex(-ab(v));
  return v >= T(0) ? T(1) / (T(1) + e) : e / (T(1) + e);
}

// ops/losses.py: the loss and its first margin derivative; "positive" is y > 0.5
template <typename T>
__device__ __forceinline__ void loss_d1(int loss, T z, T y, T& l, T& d1) {
  switch (loss) {
    case kLogistic: {
      const bool pos = y > T(0.5);
      l = pos ? log1p_exp(-z) : log1p_exp(z);
      d1 = pos ? -sigmoid(-z) : sigmoid(z);
      break;
    }
    case kSquared: {
      const T r = z - y;
      l = T(0.5) * r * r;
      d1 = r;
      break;
    }
    case kPoisson: {
      const T e = ex(z);
      l = e - y * z;
      d1 = e - y;
      break;
    }
    default: {  // Rennie's smoothed hinge on t = ±1·z
      const T ys = y > T(0.5) ? T(1) : T(-1);
      const T t = ys * z;
      const T u = T(1) - t;
      l = t <= T(0) ? T(0.5) - t : (t < T(1) ? T(0.5) * (u * u) : T(0));
      const T dt = t <= T(0) ? T(-1) : (t < T(1) ? t - T(1) : T(0));
      d1 = dt * ys;
    }
  }
}

// linesearch.py _interp: safeguarded quadratic interpolation in [a_lo, a_hi]
template <typename T>
__device__ __forceinline__ T interp(T a_lo, T phi_lo, T dphi_lo, T a_hi, T phi_hi) {
  const T d = a_hi - a_lo;
  const T denom = phi_hi - phi_lo - dphi_lo * d;
  const T quad = a_lo - T(0.5) * dphi_lo * d * d / (denom == T(0) ? T(1) : denom);
  const T bisect = a_lo + T(0.5) * d;
  const T lo = nan_min(a_lo, a_hi), hi = nan_max(a_lo, a_hi);
  const T margin = T(0.1) * (hi - lo);
  const bool bad = denom == T(0) || quad < lo + margin || quad > hi - margin || !is_finite(quad);
  return bad ? bisect : quad;
}

// linesearch.py wolfe_search_phi: the strong-Wolfe search's state and its
// transitions, one trial at a time. Every thread that needs the step keeps
// its own copy and advances it on the same sums, so the copies agree.
template <typename T>
struct Wolfe {
  T f0, dphi0, c1, neg_c2;
  T alpha, a_prev, phi_prev, dphi_prev, a_lo, phi_lo, dphi_lo, a_hi, phi_hi;
  T a_star, phi_star, a_best, phi_best;
  bool success, has_best, done, in_zoom;
  int i;  // trials so far

  __device__ Wolfe(T f0_, T dphi0_, T init, T c1_, T neg_c2_)
      : f0(f0_), dphi0(dphi0_), c1(c1_), neg_c2(neg_c2_), alpha(init), a_prev(T(0)),
        phi_prev(f0_), dphi_prev(dphi0_), a_lo(T(0)), phi_lo(f0_), dphi_lo(dphi0_),
        a_hi(T(0)), phi_hi(f0_), a_star(T(0)), phi_star(f0_), a_best(T(0)), phi_best(f0_),
        success(false), has_best(false), done(false), in_zoom(false), i(0) {}

  __device__ bool searching(int ls_max) const { return !done && i < ls_max; }

  // the next trial's step
  __device__ T trial() const {
    return in_zoom ? interp(a_lo, phi_lo, dphi_lo, a_hi, phi_hi) : alpha;
  }

  // the trial at step ``at`` read φ = fv and φ′ = dphi
  __device__ void advance(T at, T fv, T dphi) {
    const bool armijo = fv <= f0 + c1 * at * dphi0;
    const bool curv = ab(dphi) <= neg_c2 * dphi0;
    const bool better = armijo && (!has_best || fv < phi_best);
    // bracketing stage
    const bool br_hi = !armijo || (i > 0 && fv >= phi_prev);
    const bool br_rev = armijo && dphi >= T(0) && !br_hi;
    const bool br_done = armijo && curv && !br_hi;
    const bool enter_zoom = (br_hi || br_rev) && !br_done;
    // zoom stage
    const bool shrink_hi = !armijo || fv >= phi_lo;
    const bool zm_done = !shrink_hi && curv;
    const bool flip = !shrink_hi && !zm_done && dphi * (a_hi - a_lo) >= T(0);
    const bool zm_stuck = ab(a_hi - a_lo) * at_least(ab(dphi0), T(1)) <= T(1e-12);
    const bool star_now = in_zoom ? zm_done : br_done;
    const bool done_now = in_zoom ? (zm_done || zm_stuck) : br_done;
    if (in_zoom) {
      const T n_a_hi = shrink_hi ? at : (flip ? a_lo : a_hi);
      const T n_phi_hi = shrink_hi ? fv : (flip ? phi_lo : phi_hi);
      if (!shrink_hi) {
        a_lo = at;
        phi_lo = fv;
        dphi_lo = dphi;
      }
      a_hi = n_a_hi;
      phi_hi = n_phi_hi;
    } else {
      if (enter_zoom) {
        a_lo = br_hi ? a_prev : at;
        phi_lo = br_hi ? phi_prev : fv;
        dphi_lo = br_hi ? dphi_prev : dphi;
        a_hi = br_hi ? at : a_prev;
        phi_hi = br_hi ? fv : phi_prev;
      }
      a_prev = at;
      phi_prev = fv;
      dphi_prev = dphi;
    }
    alpha = (in_zoom || enter_zoom) ? at : at * T(2);
    in_zoom = in_zoom || enter_zoom;
    done = done || done_now;
    if (star_now) {
      a_star = at;
      phi_star = fv;
    }
    success = success || star_now;
    if (better) {
      a_best = at;
      phi_best = fv;
    }
    has_best = has_best || better;
    ++i;
  }

  // the result: the Wolfe point, else the best Armijo point, else step 0
  __device__ bool use_best() const { return !success && has_best; }
  __device__ T step() const { return success ? a_star : (use_best() ? a_best : T(0)); }
  __device__ T value() const { return success ? phi_star : (use_best() ? phi_best : f0); }
  __device__ bool failed() const { return !(success || use_best()); }
};

// every lane of the warp ends with the same bits: each level adds the same
// two values in either order
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// warp 0's dot of two d-vectors in shared memory (every lane gets it)
template <typename T>
__device__ __forceinline__ double warp_dot(const T* a, const T* b, int d, int lane) {
  double s = 0.0;
  for (int j = lane; j < d; j += 32) s += (double)a[j] * (double)b[j];
  return warp_sum(s);
}

template <typename T>
struct Lane {
  const T* X;  // [rows, ld]: shared memory, or the lane's block in global memory (ld = d)
  int ld;
  const T* o;  // offsets, global
  T* y;        // shared [rows]
  T* w;
  T* z;        // carried margins
  T* u;        // z_d during a line search, w·loss′ for a gradient
  T* x;        // shared [d]: iterate, gradient, direction, new gradient
  T* g;
  T* dir;
  T* gn;
  T* sh;       // [m, d]
  T* yh;
  T* rho;      // [m]
  T* bc;       // broadcast scalars
  double* red; // 2 × kMaxWarps × 2
  int rows, d;
};

// Σ over the block of K per-thread partials, broadcast to every thread with
// the same bits: a warp's xor butterfly, then the warps in order. Two
// buffers of ``stride`` doubles (at least warps × K) in turn: a buffer is
// rewritten only after the next call's barrier, which every thread reaches
// after reading it.
template <int K>
__device__ __forceinline__ void block_sum(double (&v)[K], double* red, int stride, int& parity) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  double* buf = red + parity * stride;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const double s = warp_sum(v[k]);
    if (lane == 0) buf[warp * K + k] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double s = 0.0;
    for (int i = 0; i < nw; ++i) s += buf[i * K + k];
    v[k] = s;
  }
  parity ^= 1;
}

// out_j = Σ_r X[r, j]·u_r + λ·(x_j + step·dir_j), one warp per column in
// turn; u must be complete (a barrier before), out is complete after
template <typename T>
__device__ __forceinline__ void column_sums(const Lane<T>& L, T* out, T l2, T step, bool stepped) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int j = warp; j < L.d; j += nw) {
    double s = 0.0;
    for (int r = lane; r < L.rows; r += 32) s += (double)L.X[(size_t)r * L.ld + j] * (double)L.u[r];
    s = warp_sum(s);
    if (lane == 0) {
      const T coef = stepped ? L.x[j] + step * L.dir[j] : L.x[j];
      out[j] = T(s) + l2 * coef;
    }
  }
  __syncthreads();
}

// the plain loop's oracle.full at L.x: margins z = X·x + o carried, the
// value returned to every thread, the gradient into out
template <typename T>
__device__ T full_eval(const Lane<T>& L, int loss, T half_l2, T l2, T* out, int& parity) {
  double acc[1] = {0.0};
  for (int r = threadIdx.x; r < L.rows; r += blockDim.x) {
    const T* xr = L.X + (size_t)r * L.ld;
    double s = 0.0;
    for (int j = 0; j < L.d; ++j) s += (double)xr[j] * (double)L.x[j];
    const T z = T(s) + L.o[r];
    L.z[r] = z;
    T l, d1;
    loss_d1(loss, z, L.y[r], l, d1);
    acc[0] += (double)(L.w[r] * l);
    L.u[r] = L.w[r] * d1;
  }
  block_sum<1>(acc, L.red, kMaxWarps * 2, parity);
  column_sums(L, out, l2, T(0), false);
  double xx = 0.0;  // every thread, the same order
  for (int j = 0; j < L.d; ++j) xx += (double)L.x[j] * (double)L.x[j];
  return T(acc[0]) + half_l2 * T(xx);
}

// ‖v‖ of a shared d-vector, every thread the same order
template <typename T>
__device__ __forceinline__ T norm(const T* v, int d) {
  double s = 0.0;
  for (int j = 0; j < d; ++j) s += (double)v[j] * (double)v[j];
  return T(sqrt(s));
}

struct Params {
  const void* features;
  const void* labels;
  const void* offsets;
  const void* weights;
  const void* x0;
  void* x;
  void* value;
  void* gradient;
  void* loss_hist;
  void* gnorm_hist;
  int* iterations;
  int* reason;
  int* n_evals;
  int* n_hvp;
  int* n_passes;
  int rows, dim, m, max_iter, ls_max, loss, feats_in_smem, ld;
  double tol, c1, c2, l2;
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) lane_lbfgs_kernel(Params p) {
  const long long lane_id = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int rows = p.rows, d = p.dim, m = p.m, t_max = p.max_iter;

  extern __shared__ double smem[];
  Lane<T> L;
  L.rows = rows;
  L.d = d;
  L.red = smem;
  T* s = reinterpret_cast<T*>(smem + 2 * kMaxWarps * 2);
  L.bc = s;           s += kScalars;
  L.x = s;            s += d;
  L.g = s;            s += d;
  L.dir = s;          s += d;
  L.gn = s;           s += d;
  L.sh = s;           s += (size_t)m * d;
  L.yh = s;           s += (size_t)m * d;
  L.rho = s;          s += m;
  L.y = s;            s += rows;
  L.w = s;            s += rows;
  L.z = s;            s += rows;
  L.u = s;            s += rows;

  const size_t row0 = (size_t)lane_id * rows;
  const T* gx = static_cast<const T*>(p.features) + row0 * d;
  const T* gy = static_cast<const T*>(p.labels) + row0;
  const T* gw = static_cast<const T*>(p.weights) + row0;
  L.o = static_cast<const T*>(p.offsets) + row0;
  if (p.feats_in_smem) {
    T* xs = s;
    for (int i = tid; i < rows * d; i += nt) xs[(i / d) * p.ld + i % d] = gx[i];
    L.X = xs;
    L.ld = p.ld;
  } else {
    L.X = gx;
    L.ld = d;
  }
  for (int r = tid; r < rows; r += nt) {
    L.y[r] = gy[r];
    L.w[r] = gw[r];
  }
  for (int j = tid; j < m * d; j += nt) {
    L.sh[j] = T(0);
    L.yh[j] = T(0);
  }
  for (int j = tid; j < m; j += nt) L.rho[j] = T(0);
  for (int j = tid; j < d; j += nt) L.x[j] = T(0);
  __syncthreads();

  const T l2 = T(p.l2), half_l2 = T(0.5 * p.l2), tol = T(p.tol);
  const T c1 = T(p.c1), neg_c2 = T(-p.c2);
  int parity = 0;

  // absolute tolerances from the zero state
  const T f_zero = full_eval(L, p.loss, half_l2, l2, L.g, parity);
  const T loss_tol = ab(f_zero) * tol;
  const T grad_tol = norm(L.g, d) * tol;
  __syncthreads();  // every thread has read g before x0 replaces the zero state
  const T* gx0 = static_cast<const T*>(p.x0) + (size_t)lane_id * d;
  for (int j = tid; j < d; j += nt) L.x[j] = gx0[j];
  __syncthreads();

  // the initial point
  T f = full_eval(L, p.loss, half_l2, l2, L.g, parity);
  T* lh = static_cast<T*>(p.loss_hist) + (size_t)lane_id * (t_max + 1);
  T* gh = static_cast<T*>(p.gnorm_hist) + (size_t)lane_id * (t_max + 1);
  if (tid == 0) {
    lh[0] = f;
    gh[0] = norm(L.g, d);
  }
  int it = 0, reason = kNotConverged, n_evals = 2, n_passes = 4;
  int pos = 0, npairs = 0;  // meaningful on warp 0

  for (int k = 0; k < t_max && reason == kNotConverged; ++k) {
    // -- direction, on warp 0 ------------------------------------------------
    if (warp == 0) {
      T q[2], r[2], alpha_mine = T(0);
      for (int c = 0; c < 2; ++c) {
        const int j = lane + 32 * c;
        q[c] = j < d ? L.g[j] : T(0);
      }
      const int nv = npairs < m ? npairs : m;
      for (int j = 0; j < nv; ++j) {
        const int idx = ((pos - 1 - j) % m + m) % m;
        double sq = 0.0;
        for (int c = 0; c < 2; ++c) {
          const int jj = lane + 32 * c;
          if (jj < d) sq += (double)L.sh[idx * d + jj] * (double)q[c];
        }
        const T a = L.rho[idx] * T(warp_sum(sq));
        if (lane == j) alpha_mine = a;
        for (int c = 0; c < 2; ++c) {
          const int jj = lane + 32 * c;
          if (jj < d) q[c] = q[c] - a * L.yh[idx * d + jj];
        }
      }
      const int newest = ((pos - 1) % m + m) % m;
      const T sy = T(warp_dot(L.sh + newest * d, L.yh + newest * d, d, lane));
      const T yy = T(warp_dot(L.yh + newest * d, L.yh + newest * d, d, lane));
      const T gamma = (nv > 0 && yy > T(0)) ? sy / yy : T(1);
      for (int c = 0; c < 2; ++c) r[c] = gamma * q[c];
      for (int j = nv - 1; j >= 0; --j) {
        const int idx = ((pos - 1 - j) % m + m) % m;
        double yr = 0.0;
        for (int c = 0; c < 2; ++c) {
          const int jj = lane + 32 * c;
          if (jj < d) yr += (double)L.yh[idx * d + jj] * (double)r[c];
        }
        const T beta = L.rho[idx] * T(warp_sum(yr));
        const T a = __shfl_sync(kFull, alpha_mine, j);
        for (int c = 0; c < 2; ++c) {
          const int jj = lane + 32 * c;
          if (jj < d) r[c] = r[c] + L.sh[idx * d + jj] * (a - beta);
        }
      }
      double dg = 0.0;
      for (int c = 0; c < 2; ++c) {
        const int jj = lane + 32 * c;
        if (jj < d) dg += (double)(-r[c]) * (double)L.g[jj];
      }
      const bool descent = T(warp_sum(dg)) < T(0);
      for (int c = 0; c < 2; ++c) {
        const int jj = lane + 32 * c;
        if (jj < d) L.dir[jj] = descent ? -r[c] : -L.g[jj];
      }
      __syncwarp();
      const T dphi0 = T(warp_dot(L.g, L.dir, d, lane));
      const T gnorm = T(sqrt(warp_dot(L.g, L.g, d, lane)));
      const T init = npairs == 0 ? at_most(T(1) / at_least(gnorm, T(1e-12)), T(1)) : T(1);
      const T xd = T(warp_dot(L.x, L.dir, d, lane));
      const T dd = T(warp_dot(L.dir, L.dir, d, lane));
      const T xx = T(warp_dot(L.x, L.x, d, lane));
      if (lane == 0) {
        L.bc[0] = dphi0;
        L.bc[1] = init;
        L.bc[2] = xd;
        L.bc[3] = dd;
        L.bc[4] = xx;
      }
    }
    __syncthreads();
    const T dphi0 = L.bc[0], init = L.bc[1], xd = L.bc[2], dd = L.bc[3], xx = L.bc[4];

    // -- z_d = X·dir on the carried margins' rows ---------------------------
    for (int r = tid; r < rows; r += nt) {
      const T* xr = L.X + (size_t)r * L.ld;
      double sd = 0.0;
      for (int j = 0; j < d; ++j) sd += (double)xr[j] * (double)L.dir[j];
      L.u[r] = T(sd);
    }

    // -- the strong-Wolfe search in margin space (linesearch.py) ------------
    Wolfe<T> ws(f, dphi0, init, c1, neg_c2);
    while (ws.searching(p.ls_max)) {
      const T at = ws.trial();
      double acc[2] = {0.0, 0.0};
      for (int r = tid; r < rows; r += nt) {
        const T zd = L.u[r];
        T l, d1;
        loss_d1(p.loss, L.z[r] + at * zd, L.y[r], l, d1);
        acc[0] += (double)(L.w[r] * l);
        acc[1] += (double)(L.w[r] * d1 * zd);
      }
      block_sum<2>(acc, L.red, kMaxWarps * 2, parity);
      const T fv = T(acc[0]) + half_l2 * (xx + T(2) * at * xd + at * at * dd);
      const T dphi = T(acc[1]) + l2 * (xd + at * dd);
      ws.advance(at, fv, dphi);
    }
    const T step = ws.step();
    const T f_new = ws.value();
    const bool step_failed = ws.failed();

    // -- the accepted point's gradient from the carried margins -------------
    for (int r = tid; r < rows; r += nt) {
      const T z = L.z[r] + step * L.u[r];
      L.z[r] = z;
      T l, d1;
      loss_d1(p.loss, z, L.y[r], l, d1);
      L.u[r] = L.w[r] * d1;
    }
    __syncthreads();
    column_sums(L, L.gn, l2, step, true);

    // -- the curvature pair and the move, on warp 0 -------------------------
    if (warp == 0) {
      T sv[2], yv[2];
      double sy = 0.0;
      for (int c = 0; c < 2; ++c) {
        const int jj = lane + 32 * c;
        if (jj < d) {
          const T xn = L.x[jj] + step * L.dir[jj];
          sv[c] = xn - L.x[jj];
          yv[c] = L.gn[jj] - L.g[jj];
          sy += (double)sv[c] * (double)yv[c];
          L.x[jj] = xn;
        }
      }
      const T syt = T(warp_sum(sy));
      const bool ok = syt > T(1e-10);
      if (ok) {
        for (int c = 0; c < 2; ++c) {
          const int jj = lane + 32 * c;
          if (jj < d) {
            L.sh[pos * d + jj] = sv[c];
            L.yh[pos * d + jj] = yv[c];
          }
        }
        if (lane == 0) L.rho[pos] = T(1) / syt;
        pos = (pos + 1) % m;
        npairs += 1;
      }
      for (int c = 0; c < 2; ++c) {
        const int jj = lane + 32 * c;
        if (jj < d) L.g[jj] = L.gn[jj];
      }
      __syncwarp();
      const T gnorm_new = T(sqrt(warp_dot(L.g, L.g, d, lane)));
      if (lane == 0) L.bc[5] = gnorm_new;
    }
    __syncthreads();
    const T gnorm_new = L.bc[5];

    // -- convergence (common.py convergence_check, in its order) ------------
    it += 1;
    if (it >= t_max) {
      reason = kMaxIterations;
    } else if (step_failed) {
      reason = kNotImproving;
    } else if (ab(f_new - f) <= loss_tol) {
      reason = kFunctionValues;
    } else if (gnorm_new <= grad_tol) {
      reason = kGradient;
    }
    if (tid == 0) {
      lh[it] = f_new;
      gh[it] = gnorm_new;
    }
    f = f_new;
    n_evals += ws.i;
    n_passes += 2;
  }

  // one exact re-evaluation at the final point (the carried margins drift)
  f = full_eval(L, p.loss, half_l2, l2, L.g, parity);
  n_evals += 1;
  n_passes += 2;
  const T gnorm = norm(L.g, d);
  if (tid == 0) {
    for (int k = it; k <= t_max; ++k) {
      lh[k] = f;
      gh[k] = gnorm;
    }
    static_cast<T*>(p.value)[lane_id] = f;
    p.iterations[lane_id] = it;
    p.reason[lane_id] = reason;
    p.n_evals[lane_id] = n_evals;
    p.n_hvp[lane_id] = 0;
    p.n_passes[lane_id] = n_passes;
  }
  T* ox = static_cast<T*>(p.x) + (size_t)lane_id * d;
  T* og = static_cast<T*>(p.gradient) + (size_t)lane_id * d;
  for (int j = tid; j < d; j += nt) {
    ox[j] = L.x[j];
    og[j] = L.g[j];
  }
}

// threads, shared-memory bytes, features in shared memory, their row stride
struct Shape {
  int threads, smem, feats_in_smem, ld;
};

Shape shape_of(int f64, int rows, int dim, int m) {
  const int item = f64 ? 8 : 4;
  Shape s;
  int t = ((rows + 31) / 32) * 32;
  s.threads = t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
  const long long base = 2LL * kMaxWarps * 2 * 8 +
      (long long)item * (kScalars + 4LL * dim + 2LL * m * dim + m + 4LL * rows);
  s.ld = (dim % 2) ? dim : dim + 1;  // an odd stride: a warp's column reads hit 32 banks
  const long long with_x = base + (long long)item * rows * s.ld;
  s.feats_in_smem = with_x <= kFeatureSmem;
  s.smem = (int)(s.feats_in_smem ? with_x : base);
  if (!s.feats_in_smem) s.ld = dim;
  return s;
}

// ---------------------------------------------------------------------------
// One problem over many rows: the fixed effect's L-BFGS iteration.
//
// Replaces no TPU kernel either: the JAX package runs a fixed-effect solve
// as one lax.while_loop (photon_tpu/optimize/lbfgs.py) that XLA compiles
// into one program. The port's plain version is the same Python loop as
// above on one lane, over all N rows of the fixed effect, which on the
// card issues ~800 kernels an iteration, nearly all of them [1]- and
// [D]-shaped: the two-loop recursion over the pairs, the line search's
// scalar state machine, the pair update and the convergence test.
// optimize/solo_lbfgs.py keeps the two passes over the features on their
// own kernels (z_d = X·d by the ELL gather, Xᵀr by the windowed kernel)
// and runs everything between them in two launches an iteration:
//
// - solo_head_kernel, one CTA of 1024 threads: the accepted step's point
//   x + α·d and its gradient Xᵀr + λ·x, the curvature pair (sᵀy > 1e-10),
//   the convergence test and the histories in the plain loop's order; then,
//   while the solve is active, the two-loop direction over the [m, D]
//   history (fallback −g), the first step, φ′(0) and x·x, x·d, d·d. What
//   bounds it: the chain of 2m + 4 dependent block sums over D values,
//   ~1.7 MB of history from L2 at the cell's D = 20,742 and m = 10.
// - solo_search_kernel, one cooperative launch of every co-resident CTA:
//   the strong-Wolfe search on the carried margins. Each trial, every CTA
//   sums Σw·loss(z + α·z_d) and Σw·loss′·z_d over its rows in float64 into
//   its partial, the grid syncs, and every CTA sums the partials in the
//   same order and advances its own copy of the same Wolfe state, so all
//   agree with no second sync. At its end each CTA writes its rows of the
//   accepted margins and of w·loss′ (the row vector of Xᵀr). What bounds
//   it: bytes, z, z_d, labels and weights read once a trial (16·N at
//   float32), and one grid sync a trial.
//
// State between launches lives on the card and each launch updates it in
// place: a thread writes only the coordinates and rows it read itself, and
// the head reads its scalars before its first barrier, thread 0 writing
// them back at its end. The host reads one int an iteration: whether the
// solve is active.

constexpr int kHeadThreads = 1024;
constexpr int kHeadWarps = kHeadThreads / 32;
constexpr int kSearchThreads = 256;
constexpr int kSearchWarps = kSearchThreads / 32;
constexpr int kSumsMax = 5;  // the widest block_sum of the two kernels

// a state slot: double[kSlots] (values of the solve's type) and int[kISlots]
// (optimize/solo_lbfgs.py names the same indices)
enum Slot : int {
  kF = 0, kLossTol = 1, kGradTol = 2, kDphi0 = 3, kInit = 4, kXX = 5, kXD = 6, kDD = 7,
  kStep = 8, kFNew = 9, kSlots = 16
};
enum ISlot : int {
  kIt = 0, kReason = 1, kPos = 2, kPairs = 3, kEvals = 4, kPasses = 5, kTrials = 6,
  kStepOk = 7, kISlots = 8
};

struct HeadParams {
  const void* xtr;     // Xᵀ(w·loss′) at the accepted point, without λ·x
  void* x;             // [dim]: the iterate, its gradient, the direction
  void* g;
  void* d;
  void* s_hist;        // [m, dim]
  void* y_hist;
  void* rho;           // [m]
  void* loss_hist;     // [max_iter + 1]
  void* gnorm_hist;
  const void* f_init;  // first launch: f(x0) and the tolerances, 0-d tensors
  const void* loss_tol;
  const void* grad_tol;
  void* q;             // [dim]: q and then r of the two-loop
  double* sc;          // the state's scalars
  int* si;
  long long dim;
  int m, max_iter, first;
  double l2;
};

// The head's passes over the coordinates a thread owns (j = t, t + blockDim,
// ...: a vector a thread writes, it alone reads again; only the sums cross
// threads). A pass is a chain of L2 reads, so each is a function whose
// __restrict__ pointers let the compiler issue an unrolled group's loads
// together instead of waiting out the latency of each.
template <typename T>
__device__ __forceinline__ double own_dot(const T* __restrict__ a, const T* __restrict__ b,
                                          long long n) {
  double s = 0.0;
#pragma unroll 4
  for (long long j = threadIdx.x; j < n; j += blockDim.x) s += (double)a[j] * (double)b[j];
  return s;
}

// out = out + c·v
template <typename T>
__device__ __forceinline__ void own_axpy(T* __restrict__ out, T c, const T* __restrict__ v,
                                         long long n) {
#pragma unroll 4
  for (long long j = threadIdx.x; j < n; j += blockDim.x) out[j] = out[j] + c * v[j];
}

template <typename T>
__device__ __forceinline__ void own_copy(T* __restrict__ out, const T* __restrict__ in,
                                         long long n) {
#pragma unroll 4
  for (long long j = threadIdx.x; j < n; j += blockDim.x) out[j] = in[j];
}

// out = c·out
template <typename T>
__device__ __forceinline__ void own_scale(T* __restrict__ out, T c, long long n) {
#pragma unroll 4
  for (long long j = threadIdx.x; j < n; j += blockDim.x) out[j] = c * out[j];
}

// the accepted point x + step·d and its gradient Xᵀr + λ·x: own_accept sums
// s·y and g·g, own_move moves x and g there and writes (ok) the pair
template <typename T>
__device__ __forceinline__ void own_accept(const T* __restrict__ xi, const T* __restrict__ gi,
                                           const T* __restrict__ di, const T* __restrict__ xtr,
                                           T step, T l2, long long n, double (&acc)[2]) {
#pragma unroll 4
  for (long long j = threadIdx.x; j < n; j += blockDim.x) {
    const T xn = xi[j] + step * di[j];
    const T gn = xtr[j] + l2 * xn;
    acc[0] += (double)(xn - xi[j]) * (double)(gn - gi[j]);
    acc[1] += (double)gn * (double)gn;
  }
}

template <typename T>
__device__ __forceinline__ void own_move(T* __restrict__ x, T* __restrict__ g,
                                         const T* __restrict__ d, const T* __restrict__ xtr,
                                         T* __restrict__ s_slot, T* __restrict__ y_slot, T step,
                                         T l2, bool ok, long long n) {
#pragma unroll 4
  for (long long j = threadIdx.x; j < n; j += blockDim.x) {
    const T xj = x[j], xn = xj + step * d[j];
    const T gn = xtr[j] + l2 * xn;
    if (ok) {
      s_slot[j] = xn - xj;
      y_slot[j] = gn - g[j];
    }
    x[j] = xn;
    g[j] = gn;
  }
}

// d = −r where it descends, else −g, and the search's sums g·d, g·g, x·d,
// d·d, x·x
template <typename T>
__device__ __forceinline__ void own_direction(T* __restrict__ dir, const T* __restrict__ r,
                                              const T* __restrict__ g, const T* __restrict__ x,
                                              bool descent, long long n, double (&v)[5]) {
#pragma unroll 4
  for (long long j = threadIdx.x; j < n; j += blockDim.x) {
    const T dj = descent ? -r[j] : -g[j];
    dir[j] = dj;
    v[0] += (double)g[j] * (double)dj;
    v[1] += (double)g[j] * (double)g[j];
    v[2] += (double)x[j] * (double)dj;
    v[3] += (double)dj * (double)dj;
    v[4] += (double)x[j] * (double)x[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kHeadThreads) solo_head_kernel(HeadParams p) {
  __shared__ double red[2 * kHeadWarps * kSumsMax];
  const int tid = threadIdx.x, m = p.m;
  const long long D = p.dim;
  T* x = static_cast<T*>(p.x);
  T* g = static_cast<T*>(p.g);
  T* dir = static_cast<T*>(p.d);
  T* sh = static_cast<T*>(p.s_hist);
  T* yh = static_cast<T*>(p.y_hist);
  T* rho = static_cast<T*>(p.rho);
  T* lh = static_cast<T*>(p.loss_hist);
  T* gh = static_cast<T*>(p.gnorm_hist);
  const T l2 = T(p.l2);
  int parity = 0;

  T f, loss_tol, grad_tol;
  int it, reason, pos, npairs, n_evals, n_passes;
  if (p.first) {
    f = *static_cast<const T*>(p.f_init);
    loss_tol = *static_cast<const T*>(p.loss_tol);
    grad_tol = *static_cast<const T*>(p.grad_tol);
    it = 0;
    reason = kNotConverged;
    pos = 0;
    npairs = 0;
    n_evals = 2;   // the zero state and the initial point
    n_passes = 4;  // 2 full evaluations × 2 passes
  } else {
    const double* sc = p.sc;
    const int* si = p.si;
    f = T(sc[kF]);
    loss_tol = T(sc[kLossTol]);
    grad_tol = T(sc[kGradTol]);
    it = si[kIt];
    reason = si[kReason];
    pos = si[kPos];
    npairs = si[kPairs];
    n_evals = si[kEvals];
    n_passes = si[kPasses];
    const int trials = si[kTrials];
    const T step = T(sc[kStep]), f_new = T(sc[kFNew]);
    const bool step_failed = si[kStepOk] == 0;
    const T* xtr = static_cast<const T*>(p.xtr);

    // -- the accepted point, its gradient and the curvature pair ------------
    double acc[2] = {0.0, 0.0};
    own_accept(x, g, dir, xtr, step, l2, D, acc);
    block_sum<2>(acc, red, kHeadWarps * kSumsMax, parity);
    const T sy = T(acc[0]);
    const bool ok = sy > T(1e-10);
    const T gnorm_new = T(sqrt(acc[1]));
    own_move(x, g, dir, xtr, sh + (size_t)pos * D, yh + (size_t)pos * D, step, l2, ok, D);
    if (ok) {
      if (tid == 0) rho[pos] = T(1) / sy;
      pos = (pos + 1) % m;
      npairs += 1;
    }

    // -- convergence (common.py convergence_check, in its order) ------------
    it += 1;
    if (it >= p.max_iter) {
      reason = kMaxIterations;
    } else if (step_failed) {
      reason = kNotImproving;
    } else if (ab(f_new - f) <= loss_tol) {
      reason = kFunctionValues;
    } else if (gnorm_new <= grad_tol) {
      reason = kGradient;
    }
    if (tid == 0 && it <= p.max_iter) {
      lh[it] = f_new;
      gh[it] = gnorm_new;
    }
    f = f_new;
    n_evals += trials;
    n_passes += 2;  // the direction's margins and the accepted gradient
  }

  T dphi0 = T(0), init = T(0), xx = T(0), xd = T(0), dd = T(0);
  if (reason == kNotConverged) {
    __syncthreads();  // rho[pos − 1], written by thread 0 above, is read below
    // -- the two-loop direction (lbfgs.py two_loop_direction): q and then r
    // in the scratch vector q ------------------------------------------------
    T* q = static_cast<T*>(p.q);
    T al[kMaxCorrections];
    const int nv = npairs < m ? npairs : m;
    own_copy(q, g, D);
    for (int k = 0; k < nv; ++k) {
      const int idx = ((pos - 1 - k) % m + m) % m;
      double a[1] = {own_dot(sh + (size_t)idx * D, q, D)};
      block_sum<1>(a, red, kHeadWarps * kSumsMax, parity);
      al[k] = rho[idx] * T(a[0]);
      own_axpy(q, -al[k], yh + (size_t)idx * D, D);  // q − α·y
    }
    T gamma = T(1);
    if (nv > 0) {
      const int newest = ((pos - 1) % m + m) % m;
      const T* y = yh + (size_t)newest * D;
      double c[2] = {own_dot(sh + (size_t)newest * D, y, D), own_dot(y, y, D)};
      block_sum<2>(c, red, kHeadWarps * kSumsMax, parity);
      const T sy_n = T(c[0]), yy = T(c[1]);
      if (yy > T(0)) gamma = sy_n / yy;
    }
    own_scale(q, gamma, D);
    for (int k = nv - 1; k >= 0; --k) {
      const int idx = ((pos - 1 - k) % m + m) % m;
      double b[1] = {own_dot(yh + (size_t)idx * D, q, D)};
      block_sum<1>(b, red, kHeadWarps * kSumsMax, parity);
      const T beta = rho[idx] * T(b[0]);
      own_axpy(q, al[k] - beta, sh + (size_t)idx * D, D);  // r + s·(α − β)
    }
    // −r where it descends (Σ (−r)·g < 0), else −g
    double rg[1] = {own_dot(q, g, D)};
    block_sum<1>(rg, red, kHeadWarps * kSumsMax, parity);
    const bool descent = T(-rg[0]) < T(0);

    // -- what the search needs: φ′(0), the first step, x·x, x·d, d·d ---------
    double v[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
    own_direction(dir, q, g, x, descent, D, v);
    block_sum<5>(v, red, kHeadWarps * kSumsMax, parity);
    const T gnorm = T(sqrt(v[1]));
    dphi0 = T(v[0]);
    init = npairs == 0 ? at_most(T(1) / at_least(gnorm, T(1e-12)), T(1)) : T(1);
    xd = T(v[2]);
    dd = T(v[3]);
    xx = T(v[4]);
    if (tid == 0 && p.first) {
      lh[0] = f;
      gh[0] = gnorm;
    }
  }
  if (tid == 0) {
    double* sc = p.sc;
    int* si = p.si;
    sc[kF] = f;
    sc[kLossTol] = loss_tol;
    sc[kGradTol] = grad_tol;
    sc[kDphi0] = dphi0;
    sc[kInit] = init;
    sc[kXX] = xx;
    sc[kXD] = xd;
    sc[kDD] = dd;
    sc[kStep] = 0.0;
    sc[kFNew] = f;
    si[kIt] = it;
    si[kReason] = reason;
    si[kPos] = pos;
    si[kPairs] = npairs;
    si[kEvals] = n_evals;
    si[kPasses] = n_passes;
    si[kTrials] = 0;
    si[kStepOk] = 0;
  }
}

struct SearchParams {
  void* z;            // the carried margins, then the accepted ones
  const void* zd;     // X·d
  const void* labels;
  const void* weights;
  void* u;            // w·loss′ at the accepted margins
  double* partials;   // [2][gridDim][2]
  double* sc;         // the state: reads kF..kDD, writes kStep, kFNew
  int* si;            // writes kTrials, kStepOk
  long long rows;
  int ls_max, loss;
  double c1, c2, l2;
};

// the search's end over a thread's rows: the margins moved to the accepted
// z + step·z_d, and w·loss′ at them
template <typename T>
__device__ __forceinline__ void rows_accept(T* __restrict__ z, const T* __restrict__ zd,
                                            const T* __restrict__ y, const T* __restrict__ w,
                                            T* __restrict__ u, T step, int loss, long long row0,
                                            long long rows, long long stride) {
#pragma unroll 4
  for (long long r = row0; r < rows; r += stride) {
    const T zn = z[r] + step * zd[r];
    T l, d1;
    loss_d1(loss, zn, y[r], l, d1);
    z[r] = zn;
    u[r] = w[r] * d1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSearchThreads) solo_search_kernel(SearchParams p) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ double red[2 * kSearchWarps * kSumsMax];
  __shared__ double tot[2];
  T* z = static_cast<T*>(p.z);
  const T* zd = static_cast<const T*>(p.zd);
  const T* y = static_cast<const T*>(p.labels);
  const T* w = static_cast<const T*>(p.weights);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long row0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const T xx = T(p.sc[kXX]), xd = T(p.sc[kXD]), dd = T(p.sc[kDD]);
  const T l2 = T(p.l2), half_l2 = T(0.5 * p.l2);
  Wolfe<T> ws(T(p.sc[kF]), T(p.sc[kDphi0]), T(p.sc[kInit]), T(p.c1), T(-p.c2));
  int parity = 0, turn = 0;
  while (ws.searching(p.ls_max)) {
    const T at = ws.trial();
    double acc[2] = {0.0, 0.0};
#pragma unroll 4
    for (long long r = row0; r < p.rows; r += stride) {
      const T zdr = zd[r];
      T l, d1;
      loss_d1(p.loss, z[r] + at * zdr, y[r], l, d1);
      acc[0] += (double)(w[r] * l);
      acc[1] += (double)(w[r] * d1 * zdr);
    }
    block_sum<2>(acc, red, kSearchWarps * kSumsMax, parity);
    // the partials of two trials in turn: a CTA rewrites a turn's buffer
    // only past the next grid sync, which every CTA reaches after reading it
    double* part = p.partials + (size_t)turn * gridDim.x * 2;
    if (threadIdx.x == 0) {
      __stcg(part + 2 * blockIdx.x, acc[0]);
      __stcg(part + 2 * blockIdx.x + 1, acc[1]);
    }
    grid.sync();
    if (warp == 0) {
      double s0 = 0.0, s1 = 0.0;
      for (unsigned b = lane; b < gridDim.x; b += 32) {
        s0 += __ldcg(part + 2 * b);
        s1 += __ldcg(part + 2 * b + 1);
      }
      s0 = warp_sum(s0);
      s1 = warp_sum(s1);
      if (lane == 0) {
        tot[0] = s0;
        tot[1] = s1;
      }
    }
    __syncthreads();
    const T fv = T(tot[0]) + half_l2 * (xx + T(2) * at * xd + at * at * dd);
    const T dphi = T(tot[1]) + l2 * (xd + at * dd);
    ws.advance(at, fv, dphi);
    turn ^= 1;
  }
  const T step = ws.step();
  rows_accept(z, zd, y, w, static_cast<T*>(p.u), step, p.loss, row0, p.rows, stride);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    p.sc[kStep] = step;
    p.sc[kFNew] = ws.value();
    p.si[kTrials] = ws.i;
    p.si[kStepOk] = ws.failed() ? 0 : 1;
  }
}

template <typename T>
int search_grid(long long rows) {
  int dev, sms, coop, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, solo_search_kernel<T>,
                                                        kSearchThreads, 0);
  if (err != cudaSuccess) return -(int)err;
  if (!coop || per_sm < 1) return -(int)cudaErrorNotSupported;
  long long need = (rows + kSearchThreads - 1) / kSearchThreads;
  if (need < 1) need = 1;
  const long long co_resident = (long long)sms * per_sm;
  return (int)(need < co_resident ? need : co_resident);
}

}  // namespace

extern "C" {

// One launch: every lane of [lanes, rows, dim] solved by its own CTA on
// ``stream``; the outputs in OptimizeResult's order. Returns the launch's
// cudaError (0 on success; cudaErrorInvalidValue for a lane outside the
// kernel's caps).
int lane_lbfgs(int f64, const void* features, const void* labels, const void* offsets,
               const void* weights, const void* x0, void* x, void* value, void* gradient,
               int* iterations, int* reason, void* loss_hist, void* gnorm_hist, int* n_evals,
               int* n_hvp, int* n_passes, long long lanes, int rows, int dim, int m,
               int max_iter, int ls_max, int loss, double tol, double c1, double c2, double l2,
               void* stream) {
  if (lanes < 1 || lanes > 0x7fffffffLL || max_iter < 0 || ls_max < 0 || loss < 0 ||
      loss > 3 || rows < 0 || rows > kMaxRows || dim < 1 || dim > kMaxDim || m < 1 ||
      m > kMaxCorrections)
    return cudaErrorInvalidValue;
  const Shape s = shape_of(f64, rows, dim, m);
  if (s.smem > kMaxSmem) return cudaErrorInvalidValue;
  Params p;
  p.features = features;
  p.labels = labels;
  p.offsets = offsets;
  p.weights = weights;
  p.x0 = x0;
  p.x = x;
  p.value = value;
  p.gradient = gradient;
  p.loss_hist = loss_hist;
  p.gnorm_hist = gnorm_hist;
  p.iterations = iterations;
  p.reason = reason;
  p.n_evals = n_evals;
  p.n_hvp = n_hvp;
  p.n_passes = n_passes;
  p.rows = rows;
  p.dim = dim;
  p.m = m;
  p.max_iter = max_iter;
  p.ls_max = ls_max;
  p.loss = loss;
  p.feats_in_smem = s.feats_in_smem;
  p.ld = s.ld;
  p.tol = tol;
  p.c1 = c1;
  p.c2 = c2;
  p.l2 = l2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)lanes), block(s.threads);
  cudaError_t err;
  if (f64) {
    if (s.smem > 48 * 1024) {
      err = cudaFuncSetAttribute(lane_lbfgs_kernel<double>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem);
      if (err != cudaSuccess) return err;
    }
    lane_lbfgs_kernel<double><<<grid, block, s.smem, st>>>(p);
  } else {
    if (s.smem > 48 * 1024) {
      err = cudaFuncSetAttribute(lane_lbfgs_kernel<float>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem);
      if (err != cudaSuccess) return err;
    }
    lane_lbfgs_kernel<float><<<grid, block, s.smem, st>>>(p);
  }
  return cudaGetLastError();
}

// The head of one iteration of a one-lane solve (solo_head_kernel): one
// CTA on ``stream``, updating x, g, d, the histories and the scalars sc / si
// in place; ``first`` starts the solve at x and g (x0 and its gradient) with
// the 0-d f_init / loss_tol / grad_tol (xtr, d, sc and si unread). ``q``
// ([dim]) is the two-loop's scratch. Returns the launch's cudaError.
int solo_head(int f64, const void* xtr, void* x, void* g, void* d, void* s_hist, void* y_hist,
              void* rho, void* loss_hist, void* gnorm_hist, const void* f_init,
              const void* loss_tol, const void* grad_tol, void* q, double* sc, int* si,
              long long dim, int m, int max_iter, int first, double l2, void* stream) {
  if (dim < 1 || m < 1 || m > kMaxCorrections || max_iter < 0) return cudaErrorInvalidValue;
  HeadParams p;
  p.xtr = xtr;
  p.x = x;
  p.g = g;
  p.d = d;
  p.s_hist = s_hist;
  p.y_hist = y_hist;
  p.rho = rho;
  p.loss_hist = loss_hist;
  p.gnorm_hist = gnorm_hist;
  p.f_init = f_init;
  p.loss_tol = loss_tol;
  p.grad_tol = grad_tol;
  p.q = q;
  p.sc = sc;
  p.si = si;
  p.dim = dim;
  p.m = m;
  p.max_iter = max_iter;
  p.first = first;
  p.l2 = l2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f64)
    solo_head_kernel<double><<<1, kHeadThreads, 0, st>>>(p);
  else
    solo_head_kernel<float><<<1, kHeadThreads, 0, st>>>(p);
  return cudaGetLastError();
}

// The grid of solo_search over ``rows`` rows on the current device: every
// co-resident CTA, at most one a block of rows. Negative: −cudaError.
int solo_search_grid(int f64, long long rows) {
  return f64 ? search_grid<double>(rows) : search_grid<float>(rows);
}

// The margin search of one iteration (solo_search_kernel), a cooperative
// launch of ``grid`` CTAs (solo_search_grid) on ``stream``: the margins z
// move to the accepted step in place; ``partials`` holds 4·grid doubles.
// Returns the launch's cudaError.
int solo_search(int f64, void* z, const void* zd, const void* labels, const void* weights,
                void* u, double* partials, int grid, double* sc, int* si, long long rows,
                int ls_max, int loss, double c1, double c2, double l2, void* stream) {
  if (rows < 0 || grid < 1 || ls_max < 0 || loss < 0 || loss > 3) return cudaErrorInvalidValue;
  SearchParams p;
  p.z = z;
  p.zd = zd;
  p.labels = labels;
  p.weights = weights;
  p.u = u;
  p.partials = partials;
  p.sc = sc;
  p.si = si;
  p.rows = rows;
  p.ls_max = ls_max;
  p.loss = loss;
  p.c1 = c1;
  p.c2 = c2;
  p.l2 = l2;
  void* args[] = {&p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* fn = f64 ? (const void*)solo_search_kernel<double>
                       : (const void*)solo_search_kernel<float>;
  const cudaError_t err =
      cudaLaunchCooperativeKernel(fn, dim3((unsigned)grid), dim3(kSearchThreads), args, 0, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // extern "C"
