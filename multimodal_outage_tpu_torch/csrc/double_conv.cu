// Fused U-Net DoubleConv for Hopper (sm_90a):
//   out = ReLU(conv3x3(ReLU(conv3x3(x, w1) * s1 + b1), w2) * s2 + b2)
// SAME zero padding, no conv bias, eval BatchNorm folded into (s, b).
//
// Replaces the TPU kernel multimodal_outage_tpu/ops/unet_pallas.py
// fused_double_conv (pl.pallas_call at :85). What it keeps from it: the
// intermediate activation never leaves on-chip memory, and it is rounded
// to the storage type after the first ReLU exactly where the TPU kernel
// rounds (unet_pallas.py:70), with float32 accumulation throughout.
//
// What bounds it on the card: bytes. At 1-64 channels a DoubleConv does
// ~18·(Cin·C + C·C) FLOP per output pixel against 2·(Cin + C) bytes of
// bf16 activations, well under the H100's ~295 FLOP/byte line, so the
// least time is the activations' read + write over HBM bandwidth. The
// design therefore reads each input pixel from device memory once (plus a
// 2-pixel halo per tile), writes each output pixel once, and keeps the
// intermediate in shared memory: one block per (image, TH×TW output
// tile); the block stages the input tile with a 2-pixel halo, computes
// conv1 + affine + ReLU over the tile plus a 1-pixel halo into shared
// memory (zero outside the image — the intermediate's own SAME padding,
// not the ReLU of the bias), then conv2 + affine + ReLU for the tile.
// Weights are staged in shared memory and read as warp-wide broadcasts.
// This first version does its FMAs on the CUDA cores; wgmma/TMA are for
// a later change.
//
// Layouts: x [M, H, W, Cin], w1 [3, 3, Cin, C], w2 [3, 3, C, C] (HWIO),
// s1/b1/s2/b2 [C] float32, out [M, H, W, C]; storage float32 or bfloat16.
// C must be a multiple of 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// value rounded to the storage type, kept as float
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// acc[0..COG) += Σ_{3x3 taps, ci} src[tap][ci] · w[tap][ci][co0 + k]
// src: shared tile [rows][row_w][ps] of float, w: shared [9][cin][c] float
template <int COG>
__device__ __forceinline__ void conv3x3_point(const float* src, int row_w, int ps,
                                              const float* w, int cin, int c, int co0,
                                              float (&acc)[COG]) {
#pragma unroll
  for (int k = 0; k < COG; ++k) acc[k] = 0.f;
  for (int dy = 0; dy < 3; ++dy) {
    for (int dx = 0; dx < 3; ++dx) {
      const float* s = src + (dy * row_w + dx) * ps;
      const float* wt = w + ((dy * 3 + dx) * cin) * c + co0;
      for (int ci = 0; ci < cin; ++ci) {
        const float v = s[ci];
        const float4* w4 = reinterpret_cast<const float4*>(wt + ci * c);
#pragma unroll
        for (int k = 0; k < COG / 4; ++k) {
          const float4 q = w4[k];
          acc[4 * k + 0] = fmaf(v, q.x, acc[4 * k + 0]);
          acc[4 * k + 1] = fmaf(v, q.y, acc[4 * k + 1]);
          acc[4 * k + 2] = fmaf(v, q.z, acc[4 * k + 2]);
          acc[4 * k + 3] = fmaf(v, q.w, acc[4 * k + 3]);
        }
      }
    }
  }
}

template <typename T, int COG>
__global__ void __launch_bounds__(kThreads)
double_conv_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const float* __restrict__ s1, const float* __restrict__ b1,
                   const T* __restrict__ w2, const float* __restrict__ s2,
                   const float* __restrict__ b2, T* __restrict__ out,
                   int H, int W, int cin, int c, int th, int tw, int tiles_x) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m = blockIdx.x;
  const int oy = (blockIdx.y / tiles_x) * th;
  const int ox = (blockIdx.y % tiles_x) * tw;
  // odd per-pixel strides keep a warp's pixel-parallel reads bank-free
  const int ps_in = cin | 1, ps_mid = c | 1;
  const int iw = tw + 4, ih = th + 4, mw = tw + 2, mh = th + 2;
  float* wbuf = smem;                                 // [9][cin or c][c]
  float* aff = wbuf + 9 * c * (cin > c ? cin : c);    // s1 b1 s2 b2, [4][c]
  float* tin = aff + 4 * c;                           // [ih][iw][ps_in]
  float* tmid = tin + ih * iw * ps_in;                // [mh][mw][ps_mid]

  for (int i = threadIdx.x; i < 9 * cin * c; i += blockDim.x) wbuf[i] = to_f(w1[i]);
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    aff[i] = s1[i];
    aff[c + i] = b1[i];
    aff[2 * c + i] = s2[i];
    aff[3 * c + i] = b2[i];
  }
  const T* xm = x + (size_t)m * H * W * cin;
  for (int i = threadIdx.x; i < ih * iw * cin; i += blockDim.x) {
    const int ci = i % cin, p = i / cin;
    const int gy = oy + p / iw - 2, gx = ox + p % iw - 2;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = to_f(xm[((size_t)gy * W + gx) * cin + ci]);
    tin[p * ps_in + ci] = v;
  }
  __syncthreads();

  // conv1 + affine + ReLU over the tile and its 1-pixel halo, rounded to
  // the storage type (unet_pallas.py:70); zero outside the image
  const int groups = c / COG;
  for (int item = threadIdx.x; item < mh * mw * groups; item += blockDim.x) {
    const int p = item % (mh * mw), co0 = (item / (mh * mw)) * COG;
    const int my = p / mw, mx = p % mw;
    const int gy = oy + my - 1, gx = ox + mx - 1;
    float* dst = tmid + p * ps_mid + co0;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
#pragma unroll
      for (int k = 0; k < COG; ++k) dst[k] = 0.f;
      continue;
    }
    float acc[COG];
    conv3x3_point<COG>(tin + (my * iw + mx) * ps_in, iw, ps_in, wbuf, cin, c, co0, acc);
#pragma unroll
    for (int k = 0; k < COG; ++k)
      dst[k] = rnd<T>(fmaxf(acc[k] * aff[co0 + k] + aff[c + co0 + k], 0.f));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 9 * c * c; i += blockDim.x) wbuf[i] = to_f(w2[i]);
  __syncthreads();

  // conv2 + affine + ReLU over the tile
  T* om = out + (size_t)m * H * W * c;
  for (int item = threadIdx.x; item < th * tw * groups; item += blockDim.x) {
    const int p = item % (th * tw), co0 = (item / (th * tw)) * COG;
    const int ty = p / tw, tx = p % tw;
    const int gy = oy + ty, gx = ox + tx;
    if (gy >= H || gx >= W) continue;
    float acc[COG];
    conv3x3_point<COG>(tmid + (ty * mw + tx) * ps_mid, mw, ps_mid, wbuf, c, c, co0, acc);
    T* dst = om + ((size_t)gy * W + gx) * c + co0;
#pragma unroll
    for (int k = 0; k < COG; ++k)
      dst[k] = from_f<T>(fmaxf(acc[k] * aff[2 * c + co0 + k] + aff[3 * c + co0 + k], 0.f));
  }
}

template <typename T, int COG>
cudaError_t launch(const void* x, const void* w1, const float* s1, const float* b1,
                   const void* w2, const float* s2, const float* b2, void* out,
                   int M, int H, int W, int cin, int c, int th, int tw, int smem,
                   cudaStream_t stream) {
  auto kern = double_conv_kernel<T, COG>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + tw - 1) / tw, tiles_y = (H + th - 1) / th;
  dim3 grid(M, tiles_x * tiles_y);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), s1, b1,
      static_cast<const T*>(w2), s2, b2, static_cast<T*>(out), H, W, cin, c, th, tw, tiles_x);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w1, const float* s1, const float* b1,
                     const void* w2, const float* s2, const float* b2, void* out,
                     int M, int H, int W, int cin, int c, int th, int tw, int smem,
                     cudaStream_t stream) {
  if (c % 16 == 0)
    return launch<T, 16>(x, w1, s1, b1, w2, s2, b2, out, M, H, W, cin, c, th, tw, smem, stream);
  if (c % 8 == 0)
    return launch<T, 8>(x, w1, s1, b1, w2, s2, b2, out, M, H, W, cin, c, th, tw, smem, stream);
  return launch<T, 4>(x, w1, s1, b1, w2, s2, b2, out, M, H, W, cin, c, th, tw, smem, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. smem: dynamic shared bytes, computed
// by the caller for the (th, tw) tile. Returns a cudaError_t code.
int double_conv_launch(const void* x, const void* w1, const void* s1, const void* b1,
                       const void* w2, const void* s2, const void* b2, void* out,
                       int M, int H, int W, int cin, int c, int th, int tw, int smem,
                       int dtype, void* stream) {
  if (M <= 0 || H <= 0 || W <= 0 || cin <= 0 || c <= 0 || c % 4 != 0 || th <= 0 || tw <= 0)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* f1 = static_cast<const float*>(s1);
  const auto* g1 = static_cast<const float*>(b1);
  const auto* f2 = static_cast<const float*>(s2);
  const auto* g2 = static_cast<const float*>(b2);
  if (dtype == 0)
    return dispatch<float>(x, w1, f1, g1, w2, f2, g2, out, M, H, W, cin, c, th, tw, smem, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w1, f1, g1, w2, f2, g2, out, M, H, W, cin, c, th, tw, smem, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
