// Windowed sparse Xᵀr for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel rmatvec_windows_pallas
// (photon_tpu/ops/sparse_windows.py:418, body _pallas_kernel_factory and
// its _combine segment sum). Over the column-window layout
// (ops/sparse_windows.py) it computes
//
//   out_inst[i, c] = Σ_{j : lcols[i, j] = c} vals[i, j] · r[rows[i, j]]
//   out[win·w + c] = Σ_{i : inst2win[i] = win} out_inst[i, c]   (c < dim)
//
// Bound on the card: the work is a stream of (row, lcol, val) triples,
// about one multiply-add per 12 bytes, so it is memory-bound. The least
// the function must move is each nonzero triple, the window ids and r
// read once and the output written once:
//   bytes = nnz·12 + W_inst·4 + N·4 + dim·4,   time ≥ bytes / 3.35 TB/s
// This kernel moves more: the layout's padding slots (W_inst·L·12 bytes
// of triples in all) and its [W_inst, w] partials, written and read
// back (W_inst·w·4·2). The r[rows] gather is ≤ 8 MB and stays in L2.
// What the design does about it: the TPU kernel built a [chunk, w]
// one-hot only to feed the MXU; here each slot is read exactly once, with
// the r gather fused into the same pass, and the per-column sums come
// from a segmented scan over runs of equal local columns (they are
// non-decreasing within an instance by construction), so shared memory
// takes one write per run, not per slot. There are no global atomics:
// every sum has a fixed order, so a result is bit-identical run to run.
//
// Kernel A (instance_partials): one CTA per instance. The instance is
//   walked in tiles of kBlock·kItems slots; each thread owns kItems
//   consecutive slots, a block-wide segmented scan joins the runs, and a
//   run that reaches the end of a tile is carried into the next one.
//   Per-instance CTAs spread a hot column's long spill chain (the
//   intercept: n/L instances of window 0) over all SMs.
// Kernel B (window_combine): one CTA per window sums that window's
//   contiguous instance rows in instance order.
// A simple, correct kernel: no cp.async/TMA staging yet.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kItems = 4;
constexpr int kWarps = kBlock / 32;
constexpr int kTile = kBlock * kItems;
constexpr int kSentinel = INT_MAX;  // key of slots past the instance end
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kBlock)
instance_partials(const int* __restrict__ rows, const int* __restrict__ lcols,
                  const float* __restrict__ vals, const float* __restrict__ r,
                  float* __restrict__ out_inst, long long length, int w) {
  extern __shared__ float acc[];  // [w] per-column sums of this instance
  __shared__ int s_first[kBlock];
  __shared__ int s_last[kBlock];
  __shared__ int warp_f[kWarps];
  __shared__ float warp_v[kWarps];
  __shared__ int carry_key;
  __shared__ float carry_val;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long off = static_cast<long long>(blockIdx.x) * length;

  for (int c = tid; c < w; c += kBlock) acc[c] = 0.f;
  if (tid == 0) {
    carry_key = kSentinel;
    carry_val = 0.f;
  }
  __syncthreads();

  for (long long tile = 0; tile < length; tile += kTile) {
    int key[kItems];
    float val[kItems];
    const long long first = tile + static_cast<long long>(tid) * kItems;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long j = first + k;
      if (j < length) {
        key[k] = __ldg(lcols + off + j);
        val[k] = __ldg(vals + off + j) * __ldg(r + __ldg(rows + off + j));
      } else {
        key[k] = kSentinel;
        val[k] = 0.f;
      }
    }
    s_first[tid] = key[0];
    s_last[tid] = key[kItems - 1];
    __syncthreads();

    const int prev_key = tid == 0 ? carry_key : s_last[tid - 1];
    const int next_key = tid == kBlock - 1 ? kSentinel : s_first[tid + 1];

    // thread aggregate of the segmented sum: f = a run starts in my
    // slots, v = sum since my last run start (or of all my slots)
    int f = 0;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool head = key[k] != (k == 0 ? prev_key : key[k - 1]);
      v = head ? val[k] : v + val[k];
      f |= head;
    }
    // inclusive warp scan of (f, v) under (fp, vp) ⊕ (f, v) =
    // (fp | f, f ? v : vp + v)
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int fo = __shfl_up_sync(kFull, f, o);
      const float vo = __shfl_up_sync(kFull, v, o);
      if (lane >= o) {
        v = f ? v : vo + v;
        f |= fo;
      }
    }
    if (lane == 31) {
      warp_f[warp] = f;
      warp_v[warp] = v;
    }
    int fe = __shfl_up_sync(kFull, f, 1);
    float ve = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) {
      fe = 0;
      ve = 0.f;
    }
    __syncthreads();

    // exclusive prefix: the carried run, then the earlier warps, in order
    float vw = carry_val;
    for (int q = 0; q < warp; ++q) vw = warp_f[q] ? warp_v[q] : vw + warp_v[q];
    float run = fe ? ve : vw + ve;

    if (tid == 0 && key[0] != carry_key && carry_key < w) {
      acc[carry_key] = carry_val;  // the carried run ended at the tile edge
    }
    int last_key = kSentinel;
    float last_run = 0.f;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool head = key[k] != (k == 0 ? prev_key : key[k - 1]);
      run = head ? val[k] : run + val[k];
      const bool tile_end = tid == kBlock - 1 && k == kItems - 1;
      const int nk = k < kItems - 1 ? key[k + 1] : next_key;
      if (tile_end) {
        last_key = key[k];
        last_run = run;
      } else if (nk != key[k] && key[k] < w) {
        acc[key[k]] = run;  // last slot of its run: one write per run
      }
    }
    __syncthreads();
    if (tid == kBlock - 1) {
      carry_key = last_key;
      carry_val = last_run;
    }
  }
  __syncthreads();
  if (tid == 0 && carry_key < w) acc[carry_key] = carry_val;
  __syncthreads();
  float* dst = out_inst + static_cast<long long>(blockIdx.x) * w;
  for (int c = tid; c < w; c += kBlock) dst[c] = acc[c];
}

__device__ long long lower_bound(const int* __restrict__ a, long long n,
                                 long long x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (static_cast<long long>(a[mid]) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void window_combine(const float* __restrict__ out_inst,
                               const int* __restrict__ inst2win,
                               float* __restrict__ out, long long w_inst,
                               int w, long long dim) {
  __shared__ long long lo, hi;
  const long long win = blockIdx.x;
  if (threadIdx.x == 0) {
    lo = lower_bound(inst2win, w_inst, win);
    hi = lower_bound(inst2win, w_inst, win + 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    const long long col = win * w + c;
    if (col >= dim) break;
    float s = 0.f;
    for (long long i = lo; i < hi; ++i) s += out_inst[i * w + c];
    out[col] = s;
  }
}

}  // namespace

// Returns 0 or the cudaError_t of the first failed launch. Launches on
// `stream`, does not synchronise and allocates nothing: out_inst
// ([w_inst, w]) and out ([dim]) come from the caller.
extern "C" int windowed_rmatvec_f32(const void* rows, const void* lcols,
                                    const void* vals, const void* inst2win,
                                    const void* r, void* out_inst, void* out,
                                    long long w_inst, long long length, int w,
                                    long long num_windows, long long dim,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  instance_partials<<<static_cast<unsigned>(w_inst), kBlock,
                      static_cast<size_t>(w) * sizeof(float), s>>>(
      static_cast<const int*>(rows), static_cast<const int*>(lcols),
      static_cast<const float*>(vals), static_cast<const float*>(r),
      static_cast<float*>(out_inst), length, w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  window_combine<<<static_cast<unsigned>(num_windows), 128, 0, s>>>(
      static_cast<const float*>(out_inst), static_cast<const int*>(inst2win),
      static_cast<float*>(out), w_inst, w, dim);
  e = cudaGetLastError();
  return static_cast<int>(e);
}
