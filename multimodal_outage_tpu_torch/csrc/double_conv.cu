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
// Two bodies, chosen by the storage type:
//
// bfloat16 (serving): double_conv_kernel_bf16_mma, a tensor-core implicit
// GEMM on mma.sync.aligned.m16n8k16 (bf16 in, float32 accumulate). What
// bounds it: at 128² and 64² (1-16 channels) bytes — the activations'
// read and write over HBM; at 8² 32→64 and 16² 64→32 the work reaches
// the H100's ~295 FLOP/byte line, where only tensor cores get near the
// bound. At 1-8 channels the cost that remains is instructions per pixel
// (addressing, epilogues), which the design keeps few. The design:
//  - Blocks are persistent (grid = min(work items, SMs × occupancy)) and
//    walk over (image, TH×TW output tile) items in image-major order, so
//    neighbouring blocks share the halo's L2 lines. Each block stages w1
//    and w2 ONCE, as bf16, pre-arranged in the m16n8k16 B-fragment order
//    (one 8-byte shared load per lane per n-tile), and keeps both resident,
//    with tables of each GEMM row's source address and pixel, so the loop
//    over items does no integer division.
//  - The next item's input tile (2-pixel halo, zero outside the image)
//    arrives by cp.async (16 bytes where Cin % 8 == 0, 8 where Cin % 4 ==
//    0) into the other of two buffers while the current one computes;
//    otherwise (Cin = 1, 3, ...) each thread holds its share in registers
//    through the current item and stores it after.
//  - Conv1 is a GEMM with rows = the tile's pixels plus a 1-pixel halo,
//    K = taps × Cin, N = C; its epilogue (affine + ReLU in float32,
//    rounded to bf16) writes the intermediate to shared memory, zero
//    outside the image. Conv2 is the same GEMM over the intermediate, and
//    its epilogue writes 4-byte channel pairs of the NHWC output: the
//    eight lanes of a fragment row-group cover consecutive pixels, so a
//    warp's stores fill whole 32-byte sectors at C ≤ 8 and pairs of
//    half-sectors, merged in L2, above.
//  - K index k = tap·Cp + ci with channels padded to Cp = 2, 4, 8 or a
//    multiple of 16: below 16 channels the taps fold into K (Cin = 1 needs
//    2 K-chunks of 16 instead of 9), at 16 and above a chunk is one tap's
//    16 channels. A lane builds its A fragment from four 4-byte shared
//    loads at (row's first tap) + (a per-chunk offset from a table), so a
//    tap's shift and the tile's ragged rows are address arithmetic only.
//    N is padded to 8 × a power of two; at C = 4 a GEMM row is instead
//    two neighbouring pixels (N = 2 × 4, taps over a 3 × 4 window), which
//    halves the rows. Padded weights are zero; padded channels are never
//    stored.
//  - Per-pixel strides of Cp + 8 bf16 (Cp ≥ 16) make the eight rows of a
//    fragment fall in distinct banks; at Cp < 16 neighbouring rows
//    overlap or broadcast.
//  - Narrow N (≤ 4 n-tiles): a warp takes two m16 tiles at once, sharing
//    offset and B loads, and the registers are capped so that 2-3 blocks
//    stay resident (min_blocks).
// The shared-memory layout is bf16_layout below; ops/double_conv.py
// plan_bf16 mirrors it and picks the tile (up to 32×32), and the launcher
// refuses a byte count that differs.
//
// float32: double_conv_kernel, CUDA-core FMAs (TF32 would break the 1e-4
// float32 bar). One block per (image, TH×TW output tile) stages the input
// tile with a 2-pixel halo, computes conv1 + affine + ReLU over the tile
// plus a 1-pixel halo into shared memory (zero outside the image — the
// intermediate's own SAME padding, not the ReLU of the bias), then conv2
// + affine + ReLU for the tile. Weights are staged in shared memory as
// float32 and read as warp-wide broadcasts.
//
// Layouts: x [M, H, W, Cin], w1 [3, 3, Cin, C], w2 [3, 3, C, C] (HWIO),
// s1/b1/s2/b2 [C] float32, out [M, H, W, C]; storage float32 or bfloat16.
// C must be a multiple of 4 (and at most 128 in bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// bfloat16: tensor-core implicit GEMM, persistent blocks

using bf16 = __nv_bfloat16;
using port::mma_bf16;
using port::pack_bf16;
using port::smem_addr;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNTiles = 16;  // C ≤ 128

// channels padded for the K index k = tap·Cp + ci
__host__ __device__ inline int k_pad(int ch) {
  return ch <= 2 ? 2 : ch <= 4 ? 4 : ch <= 8 ? 8 : (ch + 15) / 16 * 16;
}
// bf16 per pixel in a shared tile
__host__ __device__ inline int pix_stride(int cp) { return cp < 16 ? cp : cp + 8; }
// n-tiles of 8 columns, rounded up to a power of two
__host__ __device__ inline int n_tiles(int c) {
  int p = 1;
  while (8 * p < c) p *= 2;
  return p;
}
__host__ __device__ inline int up16(int b) { return (b + 15) / 16 * 16; }

struct Bf16Layout {
  int cp1, cp2, s1, s2, nt, kc1, kc2, ih, iw, mh, mw;
  // pixels per GEMM row: 2 where C = 4 and the tile is even-wide, so that a
  // row's N = 8 columns are two neighbouring pixels × 4 channels and the
  // taps span a 3 × (2 + px) window; else 1 (3 × 3 taps)
  int px, win;
  int rows1, rows2;  // GEMM rows of conv1 and conv2, rounded up to 32 (two m16 tiles)
  // byte offsets in dynamic shared memory, and the total
  int wb1, wb2, aff, off1, off2, pix, row1, row2, in0, in1, mid, bytes;
};

__host__ __device__ inline Bf16Layout bf16_layout(int cin, int c, int th, int tw) {
  Bf16Layout L;
  L.cp1 = k_pad(cin);
  L.cp2 = k_pad(c);
  L.s1 = pix_stride(L.cp1);
  L.s2 = pix_stride(L.cp2);
  L.nt = n_tiles(c);
  L.px = c == 4 && tw % 2 == 0 ? 2 : 1;
  L.win = 2 + L.px;
  L.kc1 = (3 * L.win * L.cp1 + 15) / 16;
  L.kc2 = (3 * L.win * L.cp2 + 15) / 16;
  L.ih = th + 4; L.iw = tw + 4; L.mh = th + 2; L.mw = tw + 2;
  L.rows1 = (L.mh * L.mw / L.px + 31) / 32 * 32;
  L.rows2 = (th * tw / L.px + 31) / 32 * 32;
  int o = 0;
  L.wb1 = o; o += L.kc1 * L.nt * 256;  // packed B fragments of w1
  L.wb2 = o; o += L.kc2 * L.nt * 256;  // and of w2
  L.aff = o; o += 4 * 8 * L.nt * 4;    // s1 b1 s2 b2, float32, zero-padded
  L.off1 = o; o += 32 * L.kc1;         // A offsets per K pair, int32
  L.off2 = o; o += 32 * L.kc2;
  L.pix = o; o += up16(4 * L.ih * L.iw);  // input-tile pixel → (y << 16) | x
  L.row1 = o; o += 8 * L.rows1;           // GEMM row → {source word, (y << 16) | x}
  L.row2 = o; o += 8 * L.rows2;
  L.in0 = o; o += up16(L.ih * L.iw * L.s1 * 2);  // input tile, two buffers
  L.in1 = o; o += up16(L.ih * L.iw * L.s1 * 2);
  L.mid = o; o += up16(L.mh * L.mw * L.s2 * 2);  // intermediate + 1-pixel halo
  L.bytes = o;
  return L;
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// src_bytes = 0 fills the destination with zeros (outside the image)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// B[k][n] with k = tap·cp + ci over a 3 × win tap window and n = p·c +
// co for the row's pixel p < px: w[dy][wx − p][ci][co], zero outside the
// 3 × 3 kernel, where ci ≥ cin or n ≥ px·c; stored so that lane L (g = L/4, t = L%4) of n-tile
// nt in K-chunk j finds its m16n8k16 fragment {B[16j+2t][8nt+g],
// B[16j+2t+1][..], B[16j+2t+8][..], B[16j+2t+9][..]} at uint2
// (j·NT + nt)·32 + L.
__device__ __forceinline__ bf16 weight_at(const bf16* w, int k, int n, int cin, int c, int cp,
                                          int px, int win) {
  const int tap = k / cp, ci = k % cp, p = n / c, co = n % c;
  const int dy = tap / win, dx = tap % win - p;
  if (dy >= 3 || dx < 0 || dx > 2 || ci >= cin || p >= px) return __float2bfloat16_rn(0.f);
  return w[((dy * 3 + dx) * cin + ci) * c + co];
}
__device__ void stage_weights(const bf16* __restrict__ w, int cin, int c, int cp, int kc, int nt,
                              int px, int win, uint2* dst) {
  for (int i = threadIdx.x; i < kc * nt * 32; i += blockDim.x) {
    const int lane = i & 31, tile = i >> 5;
    const int j = tile / nt, n = (tile % nt) * 8 + (lane >> 2), k = 16 * j + 2 * (lane & 3);
    auto wv = [&](int kk) { return weight_at(w, kk, n, cin, c, cp, px, win); };
    dst[i] = make_uint2(pack_bf16(wv(k), wv(k + 1)), pack_bf16(wv(k + 8), wv(k + 9)));
  }
}

// word offset of K pair q (k = 2q, 2q+1) from a GEMM row's first tap, in
// a tile of row width rw pixels and s bf16 per pixel, over a 3 × win tap
// window; K pairs past the window point at the first tap (finite data
// against zero weights)
__device__ void stage_offsets(int cp, int kc, int win, int rw, int s, int* off) {
  for (int q = threadIdx.x; q < 8 * kc; q += blockDim.x) {
    const int tap = 2 * q / cp, ci = 2 * q % cp;
    off[q] = tap < 3 * win ? ((tap / win) * rw + tap % win) * (s / 2) + ci / 2 : 0;
  }
}

// GEMM row r of a tile region `width` pixels wide, px pixels per row,
// whose first pixel (y, x) = (r / (width/px), px·(r % (width/px))) has its
// taps start at the same pixel of a source tile src_w pixels wide with sw
// words per pixel: {word offset of that pixel, (y << 16) | x}. Rows past
// `rows` repeat the last (their results are dropped).
__device__ void stage_rows(int rows, int padded, int width, int px, int src_w, int sw,
                           int2* dst) {
  const int per_row = width / px;
  for (int r = threadIdx.x; r < padded; r += blockDim.x) {
    const int q = min(r, rows - 1), y = q / per_row, x = px * (q % per_row);
    dst[r] = make_int2((y * src_w + x) * sw, (y << 16) | x);
  }
}

// One implicit GEMM over a shared tile: rows from the row table, K = kc
// chunks of 16, N = 8·NT. Each warp takes MI m16 tiles at a time (two
// independent accumulator chains sharing the offset and B loads where N
// is narrow); epi(r0, yx0, yx1, acc) gets each m16 tile's lane rows r0
// and r0 + 8 with their (y << 16) | x.
template <int NT, typename Epi>
__device__ __forceinline__ void conv_gemm(const uint32_t* src, const int2* rowt, int rows,
                                          const int* off, int kc, const uint2* wb, Epi epi) {
  constexpr int MI = NT <= 4 ? 2 : 1;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int groups = (rows + 16 * MI - 1) / (16 * MI);
  for (int grp = threadIdx.x >> 5; grp < groups; grp += kWarps) {
    const int r0 = grp * 16 * MI + g;
    int p[MI][2], yx[MI][2];  // the lane's rows: first-tap word in src, (y << 16) | x
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int2 e = rowt[r0 + 16 * i + 8 * h];
        p[i][h] = e.x;
        yx[i][h] = e.y;
      }
    }
    float acc[MI][NT][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
    const uint2* b = wb + lane;
#pragma unroll 2
    for (int j = 0; j < kc; ++j, b += NT * 32) {
      const int lo = off[8 * j + t], hi = off[8 * j + t + 4];
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        a[i][0] = src[p[i][0] + lo]; a[i][1] = src[p[i][1] + lo];
        a[i][2] = src[p[i][0] + hi]; a[i][3] = src[p[i][1] + hi];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint2 bb = b[n * 32];
#pragma unroll
        for (int i = 0; i < MI; ++i) mma_bf16(acc[i][n], a[i][0], a[i][1], a[i][2], a[i][3], bb.x, bb.y);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) epi(r0 + 16 * i, yx[i][0], yx[i][1], acc[i]);
  }
}

// input words a thread holds in registers for the next tile when Cin % 4
// != 0 (no cp.async); plan_bf16 keeps (th+4)·(tw+4)·cp1/2 ≤ kPre·kThreads
constexpr int kPre = 4;

// blocks per SM the registers must allow: the narrow shapes are small in
// shared memory and hide latency with more resident blocks
template <int NT> constexpr int min_blocks() { return NT <= 2 ? 3 : NT <= 4 ? 2 : 1; }

template <int NT>
__global__ void __launch_bounds__(kThreads, min_blocks<NT>())
double_conv_kernel_bf16_mma(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                            const float* __restrict__ s1, const float* __restrict__ b1,
                            const bf16* __restrict__ w2, const float* __restrict__ s2,
                            const float* __restrict__ b2, bf16* __restrict__ out, int M, int H,
                            int W, int cin, int c, int th, int tw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Bf16Layout L = bf16_layout(cin, c, th, tw);
  const uint2* wb1 = reinterpret_cast<const uint2*>(smem + L.wb1);
  const uint2* wb2 = reinterpret_cast<const uint2*>(smem + L.wb2);
  float* aff = reinterpret_cast<float*>(smem + L.aff);  // [4][8·NT]
  const int* off1 = reinterpret_cast<const int*>(smem + L.off1);
  const int* off2 = reinterpret_cast<const int*>(smem + L.off2);
  int* pix = reinterpret_cast<int*>(smem + L.pix);
  const int2* row1 = reinterpret_cast<const int2*>(smem + L.row1);
  const int2* row2 = reinterpret_cast<const int2*>(smem + L.row2);
  // input tile buffer b (0 or 1); arithmetic, not an array, keeps it off the stack
  auto tin = [&](int b) { return reinterpret_cast<bf16*>(smem + (b ? L.in1 : L.in0)); };
  uint32_t* mid = reinterpret_cast<uint32_t*>(smem + L.mid);
  constexpr int NP = 8 * NT;

  const int tiles_x = (W + tw - 1) / tw, tiles = tiles_x * ((H + th - 1) / th);
  const int items = M * tiles;
  const int vec = cin % 8 == 0 ? 8 : cin % 4 == 0 ? 4 : 0;  // cp.async width, channels
  const int npix = L.ih * L.iw;
  // per input pixel: cp.async pieces (vec) or words (register path)
  const int per_pix = vec ? cin / vec : L.cp1 / 2;
  const int per_shift = __ffs(per_pix) - 1;
  const bool per_pow2 = (per_pix & (per_pix - 1)) == 0;

  auto origin = [&](int item, int& m, int& oy, int& ox) {
    m = item / tiles;
    const int tile = item % tiles;
    oy = (tile / tiles_x) * th;
    ox = (tile % tiles_x) * tw;
  };
  // element i of a tile's staging → input-tile pixel p, its piece k, and
  // whether its image pixel (gy, gx) lies inside the image
  auto locate = [&](int i, int oy, int ox, int& p, int& k, int& gy, int& gx) {
    p = per_pow2 ? i >> per_shift : i / per_pix;
    k = i - p * per_pix;
    const int yx = pix[p];
    gy = oy - 2 + (yx >> 16);
    gx = ox - 2 + (yx & 0xffff);
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  };
  // cp.async the item's input tile; zero-fill outside the image
  auto stage_async = [&](int item, bf16* buf) {
    int m, oy, ox;
    origin(item, m, oy, ox);
    const bf16* xm = x + (size_t)m * H * W * cin;
    for (int i = threadIdx.x; i < npix * per_pix; i += blockDim.x) {
      int p, k, gy, gx;
      const bool in = locate(i, oy, ox, p, k, gy, gx);
      const bf16* src = in ? xm + ((size_t)gy * W + gx) * cin + k * vec : x;
      if (vec == 8) cp_async16(buf + p * L.s1 + k * 8, src, in ? 16 : 0);
      else cp_async8(buf + p * L.s1 + k * 4, src, in ? 8 : 0);
    }
  };
  // register path (Cin % 4 != 0): load the item's channel pairs into
  // registers now, store them (pad channels as 0) after the current item
  // computes, so the loads' latency hides behind it
  bf16 pre_lo[kPre], pre_hi[kPre];
  auto load_regs = [&](int item) {
    int m, oy, ox;
    origin(item, m, oy, ox);
    const bf16* xm = x + (size_t)m * H * W * cin;
    const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int e = 0; e < kPre; ++e) {
      const int i = threadIdx.x + e * kThreads;
      pre_lo[e] = pre_hi[e] = zero;
      int p, k, gy, gx;
      if (i < npix * per_pix && locate(i, oy, ox, p, k, gy, gx)) {
        const int ci = 2 * k;
        const bf16* px = xm + ((size_t)gy * W + gx) * cin + ci;
        if (ci < cin) pre_lo[e] = px[0];
        if (ci + 1 < cin) pre_hi[e] = px[1];
      }
    }
  };
  auto store_regs = [&](bf16* buf) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(buf);
#pragma unroll
    for (int e = 0; e < kPre; ++e) {
      const int i = threadIdx.x + e * kThreads;
      if (i < npix * per_pix) {
        const int p = per_pow2 ? i >> per_shift : i / per_pix;
        dst[p * (L.s1 / 2) + i - p * per_pix] = pack_bf16(pre_lo[e], pre_hi[e]);
      }
    }
  };

  // once per block: the pixel and row tables, weights, affine, offsets
  for (int q = threadIdx.x; q < npix; q += blockDim.x) pix[q] = ((q / L.iw) << 16) | (q % L.iw);
  __syncthreads();  // the first tile's staging reads pix
  int item = blockIdx.x;
  if (item < items) {  // the first tile's loads overlap the weight staging
    if (vec) stage_async(item, tin(0));
    else load_regs(item);
  }
  cp_async_commit();
  const int mrows = L.mh * L.mw / L.px, orows = th * tw / L.px;  // GEMM rows
  stage_rows(mrows, L.rows1, L.mw, L.px, L.iw, L.s1 / 2, reinterpret_cast<int2*>(smem + L.row1));
  stage_rows(orows, L.rows2, tw, L.px, L.mw, L.s2 / 2, reinterpret_cast<int2*>(smem + L.row2));
  stage_weights(w1, cin, c, L.cp1, L.kc1, NT, L.px, L.win, reinterpret_cast<uint2*>(smem + L.wb1));
  stage_weights(w2, c, c, L.cp2, L.kc2, NT, L.px, L.win, reinterpret_cast<uint2*>(smem + L.wb2));
  for (int i = threadIdx.x; i < NP; i += blockDim.x) {
    const bool real = i < c;
    aff[i] = real ? s1[i] : 0.f;
    aff[NP + i] = real ? b1[i] : 0.f;
    aff[2 * NP + i] = real ? s2[i] : 0.f;
    aff[3 * NP + i] = real ? b2[i] : 0.f;
  }
  stage_offsets(L.cp1, L.kc1, L.win, L.iw, L.s1, reinterpret_cast<int*>(smem + L.off1));
  stage_offsets(L.cp2, L.kc2, L.win, L.mw, L.s2, reinterpret_cast<int*>(smem + L.off2));
  if (vec && cin < L.cp1) {  // pad channels: cp.async never writes them
    const int padc = L.cp1 - cin;
    for (int i = threadIdx.x; i < 2 * npix * padc; i += blockDim.x) {
      const int b = i / (npix * padc), r = i % (npix * padc);
      tin(b)[(r / padc) * L.s1 + cin + r % padc] = __float2bfloat16_rn(0.f);
    }
  }
  if (!vec && item < items) store_regs(tin(0));

  const int t = threadIdx.x & 3;
  for (int it = 0; item < items; ++it, item += gridDim.x) {
    const int next = item + gridDim.x;
    if (vec) {
      if (next < items) stage_async(next, tin((it + 1) & 1));
      cp_async_commit();
      cp_async_wait<1>();  // this item's group has landed; the next may fly
    } else if (next < items) {
      load_regs(next);  // in flight through both convolutions
    }
    __syncthreads();
    int m, oy, ox;
    origin(item, m, oy, ox);

    // conv1 + affine + ReLU over the tile and its 1-pixel halo, rounded
    // to bf16 (unet_pallas.py:70); zero outside the image and in the pad
    // channels [C, Cp2)
    conv_gemm<NT>(reinterpret_cast<const uint32_t*>(tin(it & 1)), row1, mrows, off1, L.kc1, wb1,
                  [&](int r0, int yx0, int yx1, float (&acc)[NT][4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, yx = h ? yx1 : yx0;
        if (r >= mrows) continue;
        const int my = yx >> 16, mx = yx & 0xffff, gy = oy - 1 + my;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          // this lane's column pair: pixel p of the row, channels co, co+1
          const int col = n * 8 + 2 * t, p = L.px == 2 ? col >> 2 : 0, co = col - p * c;
          if (co >= L.cp2) continue;
          const int gx = ox - 1 + mx + p;
          float v0 = 0.f, v1 = 0.f;
          if (gy >= 0 && gy < H && gx >= 0 && gx < W && co < c) {
            const float2 sc = *reinterpret_cast<const float2*>(aff + co);
            const float2 bi = *reinterpret_cast<const float2*>(aff + NP + co);
            v0 = fmaxf(acc[n][2 * h] * sc.x + bi.x, 0.f);
            v1 = fmaxf(acc[n][2 * h + 1] * sc.y + bi.y, 0.f);
          }
          mid[(my * L.mw + mx + p) * (L.s2 / 2) + co / 2] = pack_f32(v0, v1);
        }
      }
    });
    __syncthreads();

    // conv2 + affine + ReLU over the tile, channel pairs to device memory
    bf16* om = out + (size_t)m * H * W * c;
    conv_gemm<NT>(mid, row2, orows, off2, L.kc2, wb2,
                  [&](int r0, int yx0, int yx1, float (&acc)[NT][4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, yx = h ? yx1 : yx0;
        const int gy = oy + (yx >> 16);
        if (r >= orows || gy >= H) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = n * 8 + 2 * t, p = L.px == 2 ? col >> 2 : 0, co = col - p * c;
          const int gx = ox + (yx & 0xffff) + p;
          if (co >= c || gx >= W) continue;
          const float2 sc = *reinterpret_cast<const float2*>(aff + 2 * NP + co);
          const float2 bi = *reinterpret_cast<const float2*>(aff + 3 * NP + co);
          *reinterpret_cast<uint32_t*>(om + ((size_t)gy * W + gx) * c + co) =
              pack_f32(fmaxf(acc[n][2 * h] * sc.x + bi.x, 0.f),
                       fmaxf(acc[n][2 * h + 1] * sc.y + bi.y, 0.f));
        }
      }
    });
    if (!vec && next < items) store_regs(tin((it + 1) & 1));
    __syncthreads();  // mid and the buffers are rewritten next
  }
  cp_async_wait<0>();
}

template <int NT>
cudaError_t bf16_attr(int smem) {
  return cudaFuncSetAttribute(double_conv_kernel_bf16_mma<NT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int NT>
cudaError_t bf16_occupancy(int smem, int* per_sm) {
  cudaError_t err = bf16_attr<NT>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, double_conv_kernel_bf16_mma<NT>,
                                                       kThreads, smem);
}

template <int NT>
cudaError_t launch_bf16(const void* x, const void* w1, const float* s1, const float* b1,
                        const void* w2, const float* s2, const float* b2, void* out, int M,
                        int H, int W, int cin, int c, int th, int tw, int smem, int blocks,
                        cudaStream_t stream) {
  cudaError_t err = bf16_attr<NT>(smem);
  if (err != cudaSuccess) return err;
  double_conv_kernel_bf16_mma<NT><<<blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), s1, b1,
      static_cast<const bf16*>(w2), s2, b2, static_cast<bf16*>(out), M, H, W, cin, c, th, tw);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* x, const void* w1, const float* s1, const float* b1,
                         const void* w2, const float* s2, const float* b2, void* out,
                         int M, int H, int W, int cin, int c, int th, int tw, int smem,
                         cudaStream_t stream) {
  if (c % 16 == 0)
    return launch<float, 16>(x, w1, s1, b1, w2, s2, b2, out, M, H, W, cin, c, th, tw, smem, stream);
  if (c % 8 == 0)
    return launch<float, 8>(x, w1, s1, b1, w2, s2, b2, out, M, H, W, cin, c, th, tw, smem, stream);
  return launch<float, 4>(x, w1, s1, b1, w2, s2, b2, out, M, H, W, cin, c, th, tw, smem, stream);
}

cudaError_t dispatch_bf16(const void* x, const void* w1, const float* s1, const float* b1,
                          const void* w2, const float* s2, const float* b2, void* out,
                          int M, int H, int W, int cin, int c, int th, int tw, int smem,
                          int blocks, cudaStream_t stream) {
#define DC_LAUNCH(NT)                                                                   \
  case NT:                                                                              \
    return launch_bf16<NT>(x, w1, s1, b1, w2, s2, b2, out, M, H, W, cin, c, th, tw, smem, \
                           blocks, stream);
  switch (n_tiles(c)) {
    DC_LAUNCH(1) DC_LAUNCH(2) DC_LAUNCH(4) DC_LAUNCH(8) DC_LAUNCH(16)
    default: return cudaErrorInvalidValue;
  }
#undef DC_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. smem: dynamic shared bytes, computed
// by the caller for the (th, tw) tile (bf16: must equal bf16_layout's).
// blocks: the bf16 kernel's persistent grid (float32 launches one block
// per (image, tile) and ignores it).
// Returns a cudaError_t code.
int double_conv_launch(const void* x, const void* w1, const void* s1, const void* b1,
                       const void* w2, const void* s2, const void* b2, void* out,
                       int M, int H, int W, int cin, int c, int th, int tw, int smem,
                       int blocks, int dtype, void* stream) {
  if (M <= 0 || H <= 0 || W <= 0 || cin <= 0 || c <= 0 || c % 4 != 0 || th <= 0 || tw <= 0)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* f1 = static_cast<const float*>(s1);
  const auto* g1 = static_cast<const float*>(b1);
  const auto* f2 = static_cast<const float*>(s2);
  const auto* g2 = static_cast<const float*>(b2);
  if (dtype == 0)
    return dispatch_f32(x, w1, f1, g1, w2, f2, g2, out, M, H, W, cin, c, th, tw, smem, st);
  if (dtype == 1) {
    if (blocks <= 0 || n_tiles(c) > kMaxNTiles || bf16_layout(cin, c, th, tw).bytes != smem)
      return cudaErrorInvalidValue;
    return dispatch_bf16(x, w1, f1, g1, w2, f2, g2, out, M, H, W, cin, c, th, tw, smem,
                         blocks, st);
  }
  return cudaErrorInvalidValue;
}

// Blocks of the bf16 kernel for C output channels and `smem` dynamic
// shared bytes that one SM holds at once (cudaOccupancyMaxActiveBlocks-
// PerMultiprocessor), or minus a cudaError_t code.
int double_conv_bf16_blocks_per_sm(int c, int smem) {
  int per_sm = 0;
  cudaError_t err = cudaErrorInvalidValue;
  switch (n_tiles(c)) {
    case 1: err = bf16_occupancy<1>(smem, &per_sm); break;
    case 2: err = bf16_occupancy<2>(smem, &per_sm); break;
    case 4: err = bf16_occupancy<4>(smem, &per_sm); break;
    case 8: err = bf16_occupancy<8>(smem, &per_sm); break;
    case 16: err = bf16_occupancy<16>(smem, &per_sm); break;
  }
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
