// Lane-batched L-BFGS for Hopper (sm_90a), plain C interface for ctypes.
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

// Σ over the block of K per-thread partials, broadcast to every thread.
// Two buffers in turn: a buffer is rewritten only after the next call's
// barrier, which every thread reaches after reading it.
template <int K, typename T>
__device__ __forceinline__ void block_sum(const Lane<T>& L, double (&v)[K], int& parity) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  double* buf = L.red + parity * (kMaxWarps * 2);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const double s = warp_sum(v[k]);
    if (lane == 0) buf[warp * 2 + k] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double s = 0.0;
    for (int i = 0; i < nw; ++i) s += buf[i * 2 + k];
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
  block_sum<1>(L, acc, parity);
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
    const T f0 = f;
    T alpha = init, a_prev = T(0), phi_prev = f0, dphi_prev = dphi0;
    T a_lo = T(0), phi_lo = f0, dphi_lo = dphi0, a_hi = T(0), phi_hi = f0;
    T a_star = T(0), phi_star = f0, a_best = T(0), phi_best = f0;
    bool success = false, has_best = false, done = false, in_zoom = false;
    int i = 0;
    while (!done && i < p.ls_max) {
      const T at = in_zoom ? interp(a_lo, phi_lo, dphi_lo, a_hi, phi_hi) : alpha;
      double acc[2] = {0.0, 0.0};
      for (int r = tid; r < rows; r += nt) {
        const T zd = L.u[r];
        T l, d1;
        loss_d1(p.loss, L.z[r] + at * zd, L.y[r], l, d1);
        acc[0] += (double)(L.w[r] * l);
        acc[1] += (double)(L.w[r] * d1 * zd);
      }
      block_sum<2>(L, acc, parity);
      const T fv = T(acc[0]) + half_l2 * (xx + T(2) * at * xd + at * at * dd);
      const T dphi = T(acc[1]) + l2 * (xd + at * dd);

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
    const bool use_best = !success && has_best;
    const T step = success ? a_star : (use_best ? a_best : T(0));
    const T f_new = success ? phi_star : (use_best ? phi_best : f0);
    const bool step_failed = !(success || use_best);

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
    n_evals += i;
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

}  // extern "C"
