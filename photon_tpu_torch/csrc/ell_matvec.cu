// Sparse ELL forward pass z = X·v for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no TPU kernel: JAX's ELL forward pass is an XLA gather and row
// sum (photon_tpu/ops/objective.py:43). Over the padded ELL block that
// data/dataset.py places (indices [N, K] int32, values [N, K]; padding
// slots hold index 0 and value 0) it computes, in v's type T (float32 or
// float64),
//
//   z[r] = Σ_{j < K} T(values[r, j]) · v[indices[r, j]]
//
// with the values widened (or narrowed) to T in registers, as the plain
// version's values.to(v.dtype) does (float32, float64 or bfloat16 values).
// One launch writes z [N] and nothing else: the plain version's [N, K]
// gathered values and products never reach device memory.
//
// What bounds it on the card: bytes. The index and value streams are read
// once (N·K·(4 + item) bytes) and z written once; every slot also reads
// one v[id] at a random column. Where v fits in L1 and L2 (the GAME fixed
// effect's 20,742 columns) the streams are the whole cost. Where it does
// not (a kdda-shaped GLM: 20.2M float32 columns, 81 MB against the H100's
// 50 MB L2, Zipf-popular), the v reads are served from L1 and L2 only as
// far as the streams leave the popular head of v there.
//
// Design:
// - A group of G lanes a row (G a power of two, at most 32; the wrapper
//   picks G = the largest power of two ≤ K / VW, ops/ell_matvec.py's
//   launch_shape). A lane owns chunks of VW consecutive slots: VW = 4
//   (16-byte index loads) when K is a multiple of 4 and the blocks are
//   16-byte aligned, else VW = 1. Lane l of a group takes chunks l, l + G,
//   l + 2G, ... of its row, so neighbouring lanes read neighbouring
//   addresses and a warp's loads cover 32/G consecutive rows.
// - Loads in flight. A lane loads the ids and values of kUnroll chunks,
//   then issues all of their v reads, before it uses any of them (up to 8
//   independent v reads a lane at VW = 4).
// - Cache hints, per instruction only (no stream attribute, no persisting
//   L2 window): the index and value streams are read with
//   ld.global.nc.L1::no_allocate and an L2 evict-first policy, so they
//   neither take L1 from v nor push v's head out of L2; v is read through
//   the read-only path with an L1 evict-last hint, which keeps its popular
//   entries in L1. Timed on an H100 at the kdda-shaped block (K = 40, v
//   81 MB): 1.57 ms a launch against 1.63 with plain read-only loads of v,
//   1.73 with every load plain; an L2 evict-last policy on v gained
//   nothing, and four chunks a lane in flight instead of two gained ~4%
//   there but lost 10% at the GAME fixed effect's K = 8. The value stream
//   alone reads in 0.23 ms: the v reads, served from L1 and L2 at
//   random, are what the kernel waits on.
// - Sums. Each lane sums its slots in slot order (chunk by chunk, one FMA
//   a slot, in T), then the group adds its lanes with a butterfly of
//   shuffles; lane 0 of the group writes z[r]. No atomics and no shared
//   memory: the order is fixed by K alone, so a launch repeats bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // chunks a lane loads before it uses any
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// Streaming loads: not allocated in L1, evicted first from L2.
__device__ __forceinline__ uint4 ld_stream_v4(const void* p, unsigned long long pol) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p), "l"(pol));
  return r;
}

__device__ __forceinline__ uint2 ld_stream_v2(const void* p, unsigned long long pol) {
  uint2 r;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
      : "=r"(r.x), "=r"(r.y)
      : "l"(p), "l"(pol));
  return r;
}

__device__ __forceinline__ unsigned ld_stream_u32(const void* p, unsigned long long pol) {
  unsigned r;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.u32 %0, [%1], %2;"
      : "=r"(r)
      : "l"(p), "l"(pol));
  return r;
}

__device__ __forceinline__ unsigned long long ld_stream_u64(const void* p,
                                                            unsigned long long pol) {
  unsigned long long r;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.u64 %0, [%1], %2;"
      : "=l"(r)
      : "l"(p), "l"(pol));
  return r;
}

__device__ __forceinline__ unsigned short ld_stream_u16(const void* p, unsigned long long pol) {
  unsigned short r;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.u16 %0, [%1], %2;"
      : "=h"(r)
      : "l"(p), "l"(pol));
  return r;
}

// Reads of v: the read-only path, kept in L1 ahead of other lines.
__device__ __forceinline__ float ld_table(const float* p) {
  float r;
  asm("ld.global.nc.L1::evict_last.f32 %0, [%1];" : "=f"(r) : "l"(p));
  return r;
}

__device__ __forceinline__ double ld_table(const double* p) {
  double r;
  asm("ld.global.nc.L1::evict_last.f64 %0, [%1];" : "=d"(r) : "l"(p));
  return r;
}

__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }

__device__ __forceinline__ float bf16_bits_to_float(unsigned bits16) {
  return __uint_as_float(bits16 << 16);
}

// The VW ids of one chunk.
template <int VW>
__device__ __forceinline__ void load_ids(const int* p, unsigned long long pol, int* id) {
  if constexpr (VW == 4) {
    uint4 r = ld_stream_v4(p, pol);
    id[0] = static_cast<int>(r.x);
    id[1] = static_cast<int>(r.y);
    id[2] = static_cast<int>(r.z);
    id[3] = static_cast<int>(r.w);
  } else {
    id[0] = static_cast<int>(ld_stream_u32(p, pol));
  }
}

// The VW values of one chunk, converted to T. V is float, double or
// uint16_t (bfloat16's bits).
template <typename T, typename V, int VW>
__device__ __forceinline__ void load_values(const V* p, unsigned long long pol, T* w) {
  if constexpr (sizeof(V) == 4) {
    if constexpr (VW == 4) {
      uint4 r = ld_stream_v4(p, pol);
      w[0] = static_cast<T>(__uint_as_float(r.x));
      w[1] = static_cast<T>(__uint_as_float(r.y));
      w[2] = static_cast<T>(__uint_as_float(r.z));
      w[3] = static_cast<T>(__uint_as_float(r.w));
    } else {
      w[0] = static_cast<T>(__uint_as_float(ld_stream_u32(p, pol)));
    }
  } else if constexpr (sizeof(V) == 8) {
    if constexpr (VW == 4) {
      uint4 a = ld_stream_v4(p, pol);
      uint4 b = ld_stream_v4(p + 2, pol);
      w[0] = static_cast<T>(__hiloint2double(static_cast<int>(a.y), static_cast<int>(a.x)));
      w[1] = static_cast<T>(__hiloint2double(static_cast<int>(a.w), static_cast<int>(a.z)));
      w[2] = static_cast<T>(__hiloint2double(static_cast<int>(b.y), static_cast<int>(b.x)));
      w[3] = static_cast<T>(__hiloint2double(static_cast<int>(b.w), static_cast<int>(b.z)));
    } else {
      w[0] = static_cast<T>(__longlong_as_double(static_cast<long long>(ld_stream_u64(p, pol))));
    }
  } else {
    if constexpr (VW == 4) {
      uint2 r = ld_stream_v2(p, pol);
      w[0] = static_cast<T>(bf16_bits_to_float(r.x & 0xffffu));
      w[1] = static_cast<T>(bf16_bits_to_float(r.x >> 16));
      w[2] = static_cast<T>(bf16_bits_to_float(r.y & 0xffffu));
      w[3] = static_cast<T>(bf16_bits_to_float(r.y >> 16));
    } else {
      w[0] = static_cast<T>(bf16_bits_to_float(ld_stream_u16(p, pol)));
    }
  }
}

template <typename T, typename V, int VW>
__global__ void __launch_bounds__(kThreads)
    ell_matvec_kernel(const int* __restrict__ idx, const V* __restrict__ val,
                      const T* __restrict__ v, T* __restrict__ out, long long n, int k,
                      int group_log2) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int group = 1 << group_log2;
  const int lane = static_cast<int>(threadIdx.x) & (group - 1);
  const long long row = t >> group_log2;
  const bool live = row < n;
  const int chunks = k / VW;
  const long long base = (live ? row : 0) * static_cast<long long>(k);
  const unsigned long long pol = evict_first_policy();

  T s = T(0);
  // every lane of a warp runs the same rounds (the bound is K's alone), so
  // the shuffles below are reached by the whole warp
  for (int first = 0; first < chunks; first += group * kUnroll) {
    int id[kUnroll][VW];
    T w[kUnroll][VW];
    bool on[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = first + u * group + lane;
      on[u] = live && c < chunks;
      if (on[u]) {
        load_ids<VW>(idx + base + static_cast<long long>(c) * VW, pol, id[u]);
        load_values<T, V, VW>(val + base + static_cast<long long>(c) * VW, pol, w[u]);
      }
    }
    T x[kUnroll][VW];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < VW; ++j) x[u][j] = on[u] ? ld_table(v + id[u][j]) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (on[u]) {
#pragma unroll
        for (int j = 0; j < VW; ++j) s = fmadd(w[u][j], x[u][j], s);
      }
    }
  }
  for (int off = group >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (live && lane == 0) out[row] = s;
}

template <typename T, typename V>
int launch_typed(int vw, int group_log2, const void* idx, const void* val, const void* v,
                 void* out, long long n, int k, cudaStream_t s) {
  const long long threads = n << group_log2;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const int* i = static_cast<const int*>(idx);
  const V* w = static_cast<const V*>(val);
  const T* x = static_cast<const T*>(v);
  T* z = static_cast<T*>(out);
  if (vw == 4) {
    ell_matvec_kernel<T, V, 4><<<blocks, kThreads, 0, s>>>(i, w, x, z, n, k, group_log2);
  } else {
    ell_matvec_kernel<T, V, 1><<<blocks, kThreads, 0, s>>>(i, w, x, z, n, k, group_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_values(int value_code, int vw, int group_log2, const void* idx, const void* val,
                  const void* v, void* out, long long n, int k, cudaStream_t s) {
  switch (value_code) {
    case 0: return launch_typed<T, float>(vw, group_log2, idx, val, v, out, n, k, s);
    case 1: return launch_typed<T, double>(vw, group_log2, idx, val, v, out, n, k, s);
    case 2: return launch_typed<T, uint16_t>(vw, group_log2, idx, val, v, out, n, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// z [n] = X·v over the ELL block (idx [n, k] int32, val [n, k]) on
// `stream`; does not synchronise and allocates nothing (z comes from the
// caller, in v's type). f64: v and z float64 (else float32); value_code:
// 0 float32, 1 float64, 2 bfloat16 values; vw 4 needs k % 4 == 0 and
// 16-byte aligned idx and val (8-byte for bfloat16); 2^group_log2 lanes a
// row, at most 32. Returns 0 or a cudaError_t (cudaErrorInvalidValue for
// arguments it does not take).
extern "C" int ell_matvec(int f64, int value_code, int vw, int group_log2, const void* idx,
                          const void* val, const void* v, void* out, long long n, int k,
                          void* stream) {
  if (n <= 0 || k <= 0 || (vw != 1 && vw != 4) || k % vw != 0 || group_log2 < 0 ||
      group_log2 > 5) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_values<double>(value_code, vw, group_log2, idx, val, v, out, n, k, s)
             : launch_values<float>(value_code, vw, group_log2, idx, val, v, out, n, k, s);
}
