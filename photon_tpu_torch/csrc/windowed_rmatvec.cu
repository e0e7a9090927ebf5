// Windowed sparse Xᵀr for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel rmatvec_windows_pallas
// (photon_tpu/ops/sparse_windows.py:418, body _pallas_kernel_factory and
// its _combine segment sum). Over the column-window layout
// (ops/sparse_windows.py) it computes, in float32 or float64 (sums in the
// values' own type),
//
//   out[win·w + c] = Σ_{i : inst2win[i] = win} Σ_{j : lcols[i, j] = c}
//                        vals[i, j] · r[rows[i, j]]          (win·w + c < dim)
//
// What bounds it on the card: bytes, twice over. A slot is one multiply-add
// for 12 bytes of triples (16 in float64): W_inst·L triples stream from
// HBM. And every slot reads r[rows] at a random row: r (4 MB at 2²⁰ rows)
// stays in the 50 MB L2, but each read moves a 32-byte sector out of L2
// for 4 useful bytes. Timed on an H100 at the config-5 layout (PERF.md,
// windowed_rmatvec_probe below), the r reads alone take about twice the
// triple stream alone, and the whole kernel runs within ~10% of the r
// reads: it is bound by L2 sector reads, which no order of the work over
// this layout removes, more than by HBM.
//
// Design:
// - Persistent grid over tiles. A tile is blockDim·8 slots of one instance
//   (2048 at 256 threads; L = 4096 gives two). As many CTAs as the card
//   holds at once (occupancy × SMs); CTA b walks the contiguous tiles
//   [b·Q/G, (b+1)·Q/G) of the Q = W_inst·⌈L/tile⌉ tiles. Tiles are equal
//   work, so there is no partial last wave, and a hot window's run of
//   spill instances (the intercept's ~256) is spread over the CTAs whose
//   ranges cover it.
// - Staging. One thread bulk-copies (TMA, cp.async.bulk) each tile's rows,
//   lcols and vals into a two-stage shared-memory ring, completing on an
//   mbarrier; the copy of tile t+1 is in flight while tile t gathers and
//   scans, and stage t is refilled with tile t+2 after the tile's one
//   barrier, when every thread has read it. Each thread owns 8 consecutive
//   slots, read back as 16-byte vectors, and issues its 8 independent
//   r[rows] reads together.
// - Sums. Local columns are non-decreasing within an instance, so a tile
//   is a sequence of runs of equal columns: a block-wide segmented scan
//   (thread-sequential, warp shuffles, warps in order) sums each run, and
//   the run's last slot adds it to the CTA's shared acc[w]; a run cut by a
//   tile edge adds its parts in tile order. A CTA's consecutive tiles of
//   one window add into the same acc[w], written once per (CTA, window):
//   straight to out when the window lies inside the CTA's range, else to
//   scratch[b][0] (the CTA's first window) or scratch[b][1] (its last).
// - Fix-up. A second small kernel sums each split window's partials in CTA
//   order. It is launched as a programmatic dependent of the first, so its
//   CTAs find their windows while the first kernel drains and wait only
//   for its memory (griddepcontrol). A last-arriving-CTA ticket would fuse
//   it into one launch, but its counters must read zero at every call: a
//   memset per call, or state shared by every call on every stream.
// No atomics anywhere: every sum has a fixed order, so a result is
// bit-identical run to run on one card (the order follows the grid, so
// another card model may round differently). ops/sparse_windows.py
// states the partition and the fix-up plan in plain functions
// (work_partition, fixup_plan) that the CPU tests hold to.
//
// windowed_rmatvec_probe runs the first kernel with part of its work left
// out (the stream alone; the stream and the r reads without the scan; the
// r reads alone at uniformly random rows), to time each on the card.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kItems = 8;            // consecutive slots per thread
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kStages = 2;           // depth of the TMA ring
constexpr int kFixupThreads = 256;
constexpr int kNone = -1;            // key after a tile's last slot
constexpr int kPast = INT_MAX;       // key of slots past the instance end
constexpr unsigned kFull = 0xffffffffu;

enum Mode : int { kFullWork = 0, kStreamOnly = 1, kStreamGather = 2, kGatherOnly = 3 };

template <typename T> struct Vec16;  // 16-byte vector of T
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

// CTA b of a grid of G takes tiles [range_lo(b), range_lo(b + 1)) of Q.
__host__ __device__ inline long long range_lo(long long b, long long q, long long grid) {
  return b * q / grid;
}

inline int block_threads(long long length) {
  long long t = (length + kItems - 1) / kItems;
  t = (t + 31) / 32 * 32;
  return static_cast<int>(t < kMaxThreads ? t : kMaxThreads);
}

template <typename T>
size_t smem_bytes(int block, int w) {
  return static_cast<size_t>(kStages) * block * kItems * (2 * sizeof(int) + sizeof(T)) +
         static_cast<size_t>(w) * sizeof(T);
}

__device__ inline unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ inline void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ inline void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from global to shared memory, completing on `bar`.
__device__ inline void bulk_copy(void* dst, const void* src, unsigned bytes,
                                 unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kMaxThreads, 2)
windowed_partials(const int* __restrict__ rows, const int* __restrict__ lcols,
                  const T* __restrict__ vals, const int* __restrict__ inst2win,
                  const T* __restrict__ r, T* __restrict__ scratch, T* __restrict__ out,
                  long long w_inst, long long length, int w, long long dim, long long n_rows) {
  using V16 = typename Vec16<T>::type;
  constexpr int kV = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) unsigned long long full[kStages];
  __shared__ int warp_f[2][kMaxWarps];  // double-buffered by tile parity
  __shared__ T warp_v[2][kMaxWarps];
  __shared__ int warp_first[2][kMaxWarps];
  __shared__ int warp_last[2][kMaxWarps];

  // let the fix-up kernel launch and find its windows while this one runs
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int block = blockDim.x;
  const int nwarps = block >> 5;
  const int tile_slots = block * kItems;
  T* s_vals = reinterpret_cast<T*>(smem);  // [kStages][tile_slots] each
  int* s_rows = reinterpret_cast<int*>(s_vals + kStages * tile_slots);
  int* s_lcols = s_rows + kStages * tile_slots;
  T* acc = reinterpret_cast<T*>(s_lcols + kStages * tile_slots);  // [w]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long grid = gridDim.x;
  const long long tiles_per_inst = (length + tile_slots - 1) / tile_slots;
  const long long n_tiles = w_inst * tiles_per_inst;
  const long long lo = range_lo(blockIdx.x, n_tiles, grid);
  const long long hi = range_lo(blockIdx.x + 1, n_tiles, grid);

  // where this CTA's window sums go (fixup_plan in ops/sparse_windows.py)
  auto win_of = [&](long long q) { return __ldg(inst2win + q / tiles_per_inst); };
  const int first_win = win_of(lo);
  const int last_win = win_of(hi - 1);
  const bool cont_before = lo > 0 && win_of(lo - 1) == first_win;
  const bool cont_after = hi < n_tiles && win_of(hi) == last_win;

  for (int c = tid; c < w; c += block) acc[c] = T(0);

  // one thread: bulk-copy tile q's triples into stage s
  auto issue = [&](long long q, int s) {
    const long long inst = q / tiles_per_inst;
    const long long t0 = (q - inst * tiles_per_inst) * tile_slots;
    const long long left = length - t0;
    const unsigned n = static_cast<unsigned>(left < tile_slots ? left : tile_slots);
    const long long src = inst * length + t0;
    mbar_expect_tx(&full[s], n * static_cast<unsigned>(2 * sizeof(int) + sizeof(T)));
    bulk_copy(s_rows + s * tile_slots, rows + src, n * sizeof(int), &full[s]);
    bulk_copy(s_lcols + s * tile_slots, lcols + src, n * sizeof(int), &full[s]);
    bulk_copy(s_vals + s * tile_slots, vals + src, n * sizeof(T), &full[s]);
  };
  auto flush = [&](int win) {
    T* dst = out + static_cast<long long>(win) * w;
    long long limit = dim - static_cast<long long>(win) * w;
    if (win == first_win && (cont_before || (first_win == last_win && cont_after))) {
      dst = scratch + (2ll * blockIdx.x) * w;
      limit = w;
    } else if (win == last_win && cont_after) {
      dst = scratch + (2ll * blockIdx.x + 1) * w;
      limit = w;
    }
    for (int c = tid; c < w; c += block) {
      if (c < limit) dst[c] = acc[c];
      acc[c] = T(0);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (kMode != kGatherOnly && tid == 0) {
    for (int s = 0; s < kStages && lo + s < hi; ++s) issue(lo + s, s);
  }

  T sink = T(0);  // keeps the probes' loads alive
  int cur = first_win;
  int s = 0;
  unsigned phase = 0;
  long long inst = lo / tiles_per_inst;
  long long t0 = (lo - inst * tiles_per_inst) * tile_slots;
  for (long long q = lo; q < hi; ++q) {
    const int win = __ldg(inst2win + inst);
    if (win != cur) {
      __syncthreads();
      flush(cur);
      __syncthreads();
      cur = win;
    }
    const long long left = length - t0 - static_cast<long long>(tid) * kItems;
    const int n_valid = left <= 0 ? 0 : (left >= kItems ? kItems : static_cast<int>(left));

    __align__(16) int rr[kItems];
    __align__(16) int kk[kItems];
    __align__(16) T vv[kItems];
    if (kMode == kGatherOnly) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const unsigned h = static_cast<unsigned>((inst * length + t0 + tid * kItems + k) *
                                                 2654435761ull);
        rr[k] = static_cast<int>(__umulhi(h, static_cast<unsigned>(n_rows)));
        kk[k] = 0;
        vv[k] = T(1);
      }
    } else {
      mbar_wait(&full[s], phase);
      const int off = s * tile_slots + tid * kItems;
#pragma unroll
      for (int g = 0; g < kItems / 4; ++g) {
        reinterpret_cast<int4*>(rr)[g] = reinterpret_cast<const int4*>(s_rows + off)[g];
        reinterpret_cast<int4*>(kk)[g] = reinterpret_cast<const int4*>(s_lcols + off)[g];
      }
#pragma unroll
      for (int g = 0; g < kItems / kV; ++g) {
        reinterpret_cast<V16*>(vv)[g] = reinterpret_cast<const V16*>(s_vals + off)[g];
      }
    }
    int key[kItems];
    T val[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool in = k < n_valid;
      key[k] = in ? kk[k] : kPast;
      if (kMode == kStreamOnly) {
        val[k] = in ? vv[k] + T(rr[k]) : T(0);
      } else {
        val[k] = in ? vv[k] * __ldg(r + rr[k]) : T(0);
      }
    }

    const int par = static_cast<int>(q & 1);
    T run = T(0);
    int prev_key = 0, next_key = 0;
    if (kMode == kFullWork) {
      // Thread aggregate of the segmented sum: f = a run starts in my
      // slots, v = sum since my last run start (or of all my slots). Lane
      // 0's first slot counts as a continuation here; whether it really
      // continues the previous warp's run is settled after the barrier.
      const int up = __shfl_up_sync(kFull, key[kItems - 1], 1);
      prev_key = lane == 0 ? key[0] : up;
      int f = 0;
      T v = T(0);
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const bool head = key[k] != (k == 0 ? prev_key : key[k - 1]);
        v = head ? val[k] : v + val[k];
        f |= head;
      }
      // inclusive warp scan of (f, v) under (fp, vp) ⊕ (f, v) = (fp | f, f ? v : vp + v)
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int fo = __shfl_up_sync(kFull, f, o);
        const T vo = __shfl_up_sync(kFull, v, o);
        if (lane >= o) {
          v = f ? v : vo + v;
          f |= fo;
        }
      }
      if (lane == 31) {
        warp_f[par][warp] = f;
        warp_v[par][warp] = v;
        warp_last[par][warp] = key[kItems - 1];
      }
      if (lane == 0) warp_first[par][warp] = key[0];
      int fe = __shfl_up_sync(kFull, f, 1);
      T ve = __shfl_up_sync(kFull, v, 1);
      const int down = __shfl_down_sync(kFull, key[0], 1);
      if (lane == 0) {
        fe = 0;
        ve = T(0);
      }
      __syncthreads();
      // the run open at the end of the earlier warps, folded in warp order
      T vw = T(0);
      for (int p = 0; p < warp; ++p) {
        const bool brk = p == 0 || warp_first[par][p] != warp_last[par][p - 1];
        vw = (warp_f[par][p] || brk) ? warp_v[par][p] : vw + warp_v[par][p];
      }
      const bool warp_head = warp == 0 || warp_first[par][warp] != warp_last[par][warp - 1];
      run = fe ? ve : (warp_head ? T(0) : vw) + ve;
      next_key = lane < 31 ? down : (warp + 1 < nwarps ? warp_first[par][warp + 1] : kNone);
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k) sink += val[k] + T(key[k] & 1);
      __syncthreads();
    }
    // every thread has read stage s: refill it
    if (kMode != kGatherOnly && tid == 0 && q + kStages < hi) issue(q + kStages, s);
    if (++s == kStages) {
      s = 0;
      phase ^= 1u;
    }
    t0 += tile_slots;
    if (t0 >= length) {
      t0 = 0;
      ++inst;
    }
    if (kMode != kFullWork) continue;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool head = key[k] != (k == 0 ? prev_key : key[k - 1]);
      run = head ? val[k] : run + val[k];
      const int nk = k < kItems - 1 ? key[k + 1] : next_key;
      if (nk != key[k] && static_cast<unsigned>(key[k]) < static_cast<unsigned>(w)) {
        acc[key[k]] += run;  // last slot of its run in this tile
      }
    }
  }
  if (sink == T(-1.25)) out[0] = sink;
  __syncthreads();
  flush(cur);
  if (blockIdx.x == gridDim.x - 1) {
    // columns past the layout's last window (dim beyond its windows)
    for (long long c = (last_win + 1ll) * w + tid; c < dim; c += block) out[c] = T(0);
  }
}

// CTA b mirrors partials CTA b: if b is the first CTA of a window split
// across CTAs, it sums that window's partials in CTA order into out.
template <typename T>
__global__ void window_fixup(const T* __restrict__ scratch, const int* __restrict__ inst2win,
                             T* __restrict__ out, long long w_inst, long long length, int w,
                             long long dim, int tile_slots) {
  const long long grid = gridDim.x;
  const long long b = blockIdx.x;
  const long long tiles_per_inst = (length + tile_slots - 1) / tile_slots;
  const long long n_tiles = w_inst * tiles_per_inst;
  auto win_of = [&](long long q) { return __ldg(inst2win + q / tiles_per_inst); };
  const long long lo = range_lo(b, n_tiles, grid);
  const long long hi = range_lo(b + 1, n_tiles, grid);
  const int first_win = win_of(lo);
  const int last_win = win_of(hi - 1);
  const bool cont_before = lo > 0 && win_of(lo - 1) == first_win;
  const bool cont_after = hi < n_tiles && win_of(hi) == last_win;
  if (!cont_after || (first_win == last_win && cont_before)) {
    // even with nothing to sum, end only after the partials kernel has, so
    // that work queued behind this grid finds out complete
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    return;
  }
  const int slot = first_win == last_win ? 0 : 1;

  // how many CTAs after b hold part of the window: a warp checks 32 at once
  __shared__ int s_count;
  if (threadIdx.x < 32) {
    int n = 1;
    for (long long p0 = b + 1;; p0 += 32) {
      const long long p = p0 + threadIdx.x;
      const bool part = p < grid && win_of(range_lo(p, n_tiles, grid)) == last_win;
      const unsigned m = __ballot_sync(kFull, part);
      if (m != kFull) {
        n += __ffs(~m) - 1;
        break;
      }
      n += 32;
    }
    if (threadIdx.x == 0) s_count = n;
  }
  // wait for the partials kernel to finish and its writes to be visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __syncthreads();
  const int n = s_count;
  const long long col0 = static_cast<long long>(last_win) * w;
  for (int c = threadIdx.x; c < w; c += blockDim.x) {
    T sum = scratch[(2 * b + slot) * w + c];
    for (int i = 1; i < n; ++i) sum += scratch[2 * (b + i) * w + c];
    if (col0 + c < dim) out[col0 + c] = sum;
  }
}

template <typename T, int kMode>
cudaError_t set_smem(int block, int w) {
  return cudaFuncSetAttribute(windowed_partials<T, kMode>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes<T>(block, w)));
}

template <typename T>
int grid_for(long long w_inst, long long length, int w, int* grid) {
  const int block = block_threads(length);
  cudaError_t e = set_smem<T, kFullWork>(block, w);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, windowed_partials<T, kFullWork>, block, smem_bytes<T>(block, w));
  }
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = w_inst * ((length + block * kItems - 1) / (block * kItems));
  const long long g = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<int>(g < tiles ? g : tiles);
  return 0;
}

template <typename T, int kMode>
int launch_partials(const void* rows, const void* lcols, const void* vals, const void* inst2win,
                    const void* r, void* scratch, void* out, long long w_inst, long long length,
                    int w, long long dim, long long n_rows, int grid, cudaStream_t s) {
  const int block = block_threads(length);
  cudaError_t e = set_smem<T, kMode>(block, w);
  if (e != cudaSuccess) return static_cast<int>(e);
  windowed_partials<T, kMode><<<grid, block, smem_bytes<T>(block, w), s>>>(
      static_cast<const int*>(rows), static_cast<const int*>(lcols), static_cast<const T*>(vals),
      static_cast<const int*>(inst2win), static_cast<const T*>(r), static_cast<T*>(scratch),
      static_cast<T*>(out), w_inst, length, w, dim, n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* rows, const void* lcols, const void* vals, const void* inst2win,
           const void* r, void* scratch, void* out, long long w_inst, long long length, int w,
           long long dim, int grid, cudaStream_t s) {
  int rc = launch_partials<T, kFullWork>(rows, lcols, vals, inst2win, r, scratch, out, w_inst,
                                         length, w, dim, 0, grid, s);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  // whole warps, at least one: the fix-up counts CTAs with a warp ballot
  cfg.blockDim = dim3(w < kFixupThreads ? (w + 31) / 32 * 32 : kFixupThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int tile_slots = block_threads(length) * kItems;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, window_fixup<T>, static_cast<const T*>(scratch),
                                             static_cast<const int*>(inst2win),
                                             static_cast<T*>(out), w_inst, length, w, dim,
                                             tile_slots));
}

template <typename T>
int probe(int mode, const void* rows, const void* lcols, const void* vals, const void* inst2win,
          const void* r, void* scratch, void* out, long long w_inst, long long length, int w,
          long long dim, long long n_rows, int grid, cudaStream_t s) {
  switch (mode) {
    case kStreamOnly:
      return launch_partials<T, kStreamOnly>(rows, lcols, vals, inst2win, r, scratch, out, w_inst,
                                             length, w, dim, n_rows, grid, s);
    case kStreamGather:
      return launch_partials<T, kStreamGather>(rows, lcols, vals, inst2win, r, scratch, out,
                                               w_inst, length, w, dim, n_rows, grid, s);
    case kGatherOnly:
      return launch_partials<T, kGatherOnly>(rows, lcols, vals, inst2win, r, scratch, out, w_inst,
                                             length, w, dim, n_rows, grid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Grid (CTAs) the kernel runs with for this layout on the current device:
// occupancy × SMs, at most the number of tiles. The caller sizes scratch
// as [grid, 2, w]. Returns 0 or a cudaError_t.
extern "C" int windowed_rmatvec_grid(int f64, long long w_inst, long long length, int w,
                                     int* grid) {
  return f64 ? grid_for<double>(w_inst, length, w, grid)
             : grid_for<float>(w_inst, length, w, grid);
}

// Launches the partials kernel and the fix-up on `stream`; does not
// synchronise and allocates nothing: scratch ([grid, 2, w]) and out ([dim])
// come from the caller, in the values' type. Needs L % 4 == 0 and 16-byte
// aligned rows/lcols/vals. Returns 0 or the cudaError_t of the first
// failed launch.
extern "C" int windowed_rmatvec(int f64, const void* rows, const void* lcols, const void* vals,
                                const void* inst2win, const void* r, void* scratch, void* out,
                                long long w_inst, long long length, int w, long long dim,
                                int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(rows, lcols, vals, inst2win, r, scratch, out, w_inst, length, w,
                              dim, grid, s)
             : launch<float>(rows, lcols, vals, inst2win, r, scratch, out, w_inst, length, w,
                             dim, grid, s);
}

// The partials kernel alone with part of its work left out, for timing:
// mode 1 streams the triples only, mode 2 adds the r[rows] reads (no scan),
// mode 3 reads r at uniformly random rows in [0, n_rows) with no stream.
// Its outputs are meaningless.
extern "C" int windowed_rmatvec_probe(int mode, int f64, const void* rows, const void* lcols,
                                      const void* vals, const void* inst2win, const void* r,
                                      void* scratch, void* out, long long w_inst,
                                      long long length, int w, long long dim, long long n_rows,
                                      int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? probe<double>(mode, rows, lcols, vals, inst2win, r, scratch, out, w_inst, length,
                             w, dim, n_rows, grid, s)
             : probe<float>(mode, rows, lcols, vals, inst2win, r, scratch, out, w_inst, length, w,
                            dim, n_rows, grid, s);
}
