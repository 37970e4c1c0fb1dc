// 2x2 / stride-2 max-pool forward and backward for Hopper (sm_90a), NHWC.
//
// Replaces the TPU kernel pair multimodal_outage_tpu/ops/pool_pallas.py
// max_pool_2x2_pallas (forward pl.pallas_call at :163, backward at :191).
// The TPU kernel moves every value through 0/1 selection matmuls on the
// MXU only because Mosaic rejects stride-2 sublane slices
// (pool_pallas.py:16-22); on the card a thread simply loads the four
// window pixels, so none of that is carried over.
//
// What bounds it on the card: bytes. The forward reads x once and writes
// x/4 (3 compares per output value); the backward reads x and g once and
// writes dx once. Each thread owns one output pixel and one vector of V
// channels (16, 8 or 4 bytes, the widest that divides the pixel and keeps
// every pointer aligned), so a warp's loads of a window row cover whole
// sectors of the two neighbouring input pixels.
//
// Tie routing is the JAX kernel's, not PyTorch's (pool_pallas.py:131-147):
// in each window column the even row wins when x[2i] >= x[2i+1]; between
// the two column maxima the even column wins when >=. The backward writes
// all four dx values of a window (g to the winner, 0 to the other three):
// no atomics, no memset, deterministic. The forward's maximum propagates
// NaN like jnp.maximum (never fmaxf); inputs are finite by contract.
//
// Layouts: x [M, H, W, C] contiguous, y/g [M, H/2, W/2, C], dx like x;
// storage float32 or bfloat16; H and W even.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // exact: v is a bf16 value or 0
}

// NaN-propagating maximum with jnp.maximum's semantics
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : (a >= b ? a : b);
}

template <int BYTES> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = uint32_t; };

// V consecutive channels of one pixel, moved as one BYTES-wide access
template <typename T, int BYTES>
struct alignas(BYTES) Pack {
  static constexpr int V = BYTES / sizeof(T);
  using Vec = typename VecOf<BYTES>::type;
  T e[V];
  __device__ __forceinline__ void load(const T* p) {
    *reinterpret_cast<Vec*>(e) = __ldg(reinterpret_cast<const Vec*>(p));
  }
  __device__ __forceinline__ void store(T* p) const {
    *reinterpret_cast<Vec*>(p) = *reinterpret_cast<const Vec*>(e);
  }
};

// Position of output work item `idx` (one pixel, one channel vector):
// returns the offset of the window's top-left input element and of the
// output element.
struct Where {
  long long in, out;
};

__device__ __forceinline__ Where locate(long long idx, int Ho, int Wo, int C, int V) {
  const int groups = C / V;
  const int cg = static_cast<int>(idx % groups);
  long long p = idx / groups;  // output pixel m*Ho*Wo + i*Wo + j
  const int j = static_cast<int>(p % Wo);
  p /= Wo;
  const int i = static_cast<int>(p % Ho);
  const long long m = p / Ho;
  const int W = 2 * Wo;
  Where w;
  w.in = ((m * (2 * Ho) + 2 * i) * W + 2 * j) * C + cg * V;
  w.out = ((m * Ho + i) * Wo + j) * C + cg * V;
  return w;
}

template <typename T, int BYTES>
__global__ void __launch_bounds__(kThreads)
max_pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, long long items,
                    int Ho, int Wo, int C) {
  using P = Pack<T, BYTES>;
  const long long row = 2LL * Wo * C;  // one input scanline
  for (long long idx = blockIdx.x * (long long)kThreads + threadIdx.x; idx < items;
       idx += (long long)gridDim.x * kThreads) {
    const Where w = locate(idx, Ho, Wo, C, P::V);
    P a, b, c, d, o;  // a b / c d: the window's rows and columns
    a.load(x + w.in);
    b.load(x + w.in + C);
    c.load(x + w.in + row);
    d.load(x + w.in + row + C);
#pragma unroll
    for (int k = 0; k < P::V; ++k) {
      const float col0 = nan_max(to_f(a.e[k]), to_f(c.e[k]));
      const float col1 = nan_max(to_f(b.e[k]), to_f(d.e[k]));
      o.e[k] = from_f<T>(nan_max(col0, col1));
    }
    o.store(y + w.out);
  }
}

template <typename T, int BYTES>
__global__ void __launch_bounds__(kThreads)
max_pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                    long long items, int Ho, int Wo, int C) {
  using P = Pack<T, BYTES>;
  const long long row = 2LL * Wo * C;
  for (long long idx = blockIdx.x * (long long)kThreads + threadIdx.x; idx < items;
       idx += (long long)gridDim.x * kThreads) {
    const Where w = locate(idx, Ho, Wo, C, P::V);
    P a, b, c, d, gg;
    a.load(x + w.in);
    b.load(x + w.in + C);
    c.load(x + w.in + row);
    d.load(x + w.in + row + C);
    gg.load(g + w.out);
    P da, db, dc, dd;
#pragma unroll
    for (int k = 0; k < P::V; ++k) {
      const float xa = to_f(a.e[k]), xb = to_f(b.e[k]);
      const float xc = to_f(c.e[k]), xd = to_f(d.e[k]);
      const bool even_row0 = xa >= xc;  // row winner, window column 0
      const bool even_row1 = xb >= xd;  // row winner, window column 1
      const bool even_col = nan_max(xa, xc) >= nan_max(xb, xd);
      const T gv = gg.e[k];
      const T zero = from_f<T>(0.f);
      da.e[k] = (even_col && even_row0) ? gv : zero;
      dc.e[k] = (even_col && !even_row0) ? gv : zero;
      db.e[k] = (!even_col && even_row1) ? gv : zero;
      dd.e[k] = (!even_col && !even_row1) ? gv : zero;
    }
    da.store(dx + w.in);
    db.store(dx + w.in + C);
    dc.store(dx + w.in + row);
    dd.store(dx + w.in + row + C);
  }
}

int grid_for(long long items) {
  // enough blocks to fill the card several times over; the loop strides
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

template <typename T, int BYTES>
cudaError_t launch(const void* x, const void* g, void* out, long long M, int H, int W, int C,
                   bool backward, cudaStream_t stream) {
  const int Ho = H / 2, Wo = W / 2;
  const long long items = M * Ho * Wo * (C / (BYTES / (int)sizeof(T)));
  const int grid = grid_for(items);
  if (backward) {
    max_pool_bwd_kernel<T, BYTES><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(out), items, Ho, Wo, C);
  } else {
    max_pool_fwd_kernel<T, BYTES><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), items, Ho, Wo, C);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, void* out, long long M, int H, int W, int C,
                     int vec_bytes, bool backward, cudaStream_t stream) {
  switch (vec_bytes) {
    case 16: return launch<T, 16>(x, g, out, M, H, W, C, backward, stream);
    case 8: return launch<T, 8>(x, g, out, M, H, W, C, backward, stream);
    case 4: return launch<T, 4>(x, g, out, M, H, W, C, backward, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(const void* x, const void* g, void* out, long long M, int H, int W, int C,
                int vec_bytes, int dtype, bool backward, void* stream) {
  const int item = dtype == 0 ? 4 : 2;
  if (M <= 0 || H <= 0 || W <= 0 || C <= 0 || H % 2 || W % 2 ||
      (C * item) % vec_bytes || vec_bytes < item)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, g, out, M, H, W, C, vec_bytes, backward, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, g, out, M, H, W, C, vec_bytes, backward, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. vec_bytes: 16, 8 or 4, dividing
// C·itemsize, with every pointer aligned to it (the wrapper picks it).
// Returns a cudaError_t code.
int max_pool_fwd_launch(const void* x, void* y, long long M, int H, int W, int C,
                        int vec_bytes, int dtype, void* stream) {
  return run(x, nullptr, y, M, H, W, C, vec_bytes, dtype, false, stream);
}

int max_pool_bwd_launch(const void* x, const void* g, void* dx, long long M, int H, int W, int C,
                        int vec_bytes, int dtype, void* stream) {
  return run(x, g, dx, M, H, W, C, vec_bytes, dtype, true, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
