// One gated-TCN + diffusion Graph WaveNet layer (kernel_size 1) for Hopper
// (sm_90a):
//   g = tanh(x·Wf + bf) ⊙ σ(x·Wg + bg)
//   s = g·Ws + bs
//   h = [g, A₀ᵀg, (A₀ᵀ)²g, A₁ᵀg, …]·Wc + bc     (order-K diffusion, S supports)
// returning (h, s). The residual, dropout and BatchNorm stay outside.
//
// Replaces the TPU kernel multimodal_outage_tpu/ops/gwnet_pallas.py
// fused_gwnet_layer (pl.pallas_call at :139). It rounds to the storage type
// where that kernel rounds: g after filt·gate (:76), s once (:78-80), each
// diffusion term after its A-product (:93-95, :102-104), h once (:110);
// biases arrive in the storage type (:152-159) and every sum is float32.
// The backward is not a kernel: the wrapper's autograd.Function takes the
// VJP of the plain version, as the TPU kernel's custom_vjp does.
//
// What bounds it on the card: launch latency. A (b, t) position is ~3.2
// MFLOP (67×32×64 gate/filter, 67×32×256 skip, S·K products of 67×67×32,
// 67×160×32 diffusion mix); a B=8 train step's layer is ~0.18 GFLOP and
// ~2.4 MB, under a microsecond at the card's rates. So the kernel is one
// simple wave: one block per (b, t) position reads its 67 strided node
// rows of x straight from global memory, keeps the gate pre-activations,
// the diffusion terms (g is term 0) and the transposed supports in shared
// memory, writes s straight from registers, and accumulates h in float32
// over the terms with Wc's row-slices; weights (~25 KB) come from L2.
// Not carried over from the TPU kernel: its 67→128 lane padding and its
// [B·T, N, C] staging copies (Mosaic workarounds).
//
// Layouts (row-major): x [B, N, T, C]; supports [S, N, N]; wf, wg [C, Cd];
// ws [Cd, Cs]; wc [(S·K+1)·Cd, C]; biases [cols]; h [B, N, T, C];
// s [B, N, T, Cs]. Everything in the storage type.

#include "common.cuh"

namespace {

using namespace port;

constexpr int kThreads = 256;

struct Params {
  const void *x, *sup, *wf, *bf, *wg, *bg, *ws, *bs, *wc, *bc;
  void *h, *s;
  int N, T, C, Cd, Cs, S, order;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) gwnet_layer_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x / p.T, t = blockIdx.x % p.T;
  const int N = p.N, C = p.C, Cd = p.Cd, Cs = p.Cs;
  const int ldt = (p.S * p.order + 1) * Cd;
  float* terms = smem;             // [N][ldt], g is term 0
  float* pre = terms + N * ldt;    // [N][2·Cd] filter | gate pre-activations
  float* at = pre + N * 2 * Cd;    // [S][N][N], at[s][w][v] = A_s[v][w]

  const T* sup = static_cast<const T*>(p.sup);
  for (int i = threadIdx.x; i < p.S * N * N; i += blockDim.x) {
    const int s = i / (N * N), w = (i / N) % N, v = i % N;
    at[i] = to_f(sup[((size_t)s * N + v) * N + w]);
  }

  // filter and gate pre-activations, straight from the strided rows of x
  const size_t row0 = (size_t)b * N * p.T + t, ldx = (size_t)p.T;
  const T* x = static_cast<const T*>(p.x) + row0 * C;
  const T* bf = static_cast<const T*>(p.bf);
  const T* bg = static_cast<const T*>(p.bg);
  matmul<4>(x, p.T * C, static_cast<const T*>(p.wf), Cd, N, C, Cd,
            [&](int r, int c, float a) { pre[r * 2 * Cd + c] = a + to_f(bf[c]); });
  matmul<4>(x, p.T * C, static_cast<const T*>(p.wg), Cd, N, C, Cd,
            [&](int r, int c, float a) { pre[r * 2 * Cd + Cd + c] = a + to_f(bg[c]); });
  __syncthreads();
  for (int i = threadIdx.x; i < N * Cd; i += blockDim.x) {
    const int r = i / Cd, c = i % Cd;
    const float f = tanhf(pre[r * 2 * Cd + c]);
    terms[r * ldt + c] = rnd<T>(f * sigmoidf(pre[r * 2 * Cd + Cd + c]));
  }
  __syncthreads();

  // skip projection, written from registers; it reads only term 0, as the
  // first diffusion product does, so no barrier between them
  const T* bs = static_cast<const T*>(p.bs);
  T* s_out = static_cast<T*>(p.s) + row0 * Cs;
  matmul<4>(terms, ldt, static_cast<const T*>(p.ws), Cs, N, Cd, Cs,
            [&](int r, int c, float a) { s_out[r * ldx * Cs + c] = from_f<T>(a + to_f(bs[c])); });

  // order-K diffusion over each support: term j = Aᵀ · term (j−1 or 0)
  int j = 1;
  for (int s = 0; s < p.S; ++s) {
    int prev = 0;
    for (int k = 0; k < p.order; ++k, ++j) {
      float* dst = terms + j * Cd;
      matmul<2>(at + (size_t)s * N * N, N, terms + prev * Cd, ldt, N, N, Cd,
                [&](int r, int c, float a) { dst[r * ldt + c] = rnd<T>(a); });
      __syncthreads();
      prev = j;
    }
  }

  // graph-conv projection over all terms at once, + bias, rounded once
  const T* bc = static_cast<const T*>(p.bc);
  T* h_out = static_cast<T*>(p.h) + row0 * C;
  matmul<4>(terms, ldt, static_cast<const T*>(p.wc), C, N, ldt, C,
            [&](int r, int c, float a) { h_out[r * ldx * C + c] = from_f<T>(a + to_f(bc[c])); });
}

template <typename T>
int launch(const Params& p, int B, int smem, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      gwnet_layer_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gwnet_layer_kernel<T><<<B * p.T, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, the kernel needs for these sizes.
int gwnet_layer_smem_bytes(int N, int Cd, int S, int order) {
  return 4 * (N * (S * order + 1) * Cd + N * 2 * Cd + S * N * N);
}

// dtype: 0 = float32, 1 = bfloat16. One block per (b, t). Returns a
// cudaError_t code.
int gwnet_layer_launch(const void* x, const void* sup, const void* wf, const void* bf,
                       const void* wg, const void* bg, const void* ws, const void* bs,
                       const void* wc, const void* bc, void* h, void* s, int B, int N,
                       int T, int C, int Cd, int Cs, int S, int order, int dtype,
                       void* stream) {
  if (B <= 0 || N <= 0 || T <= 0 || S <= 0 || order <= 0 || C % 4 || Cd % 4 || Cs % 4)
    return cudaErrorInvalidValue;
  const Params p{x, sup, wf, bf, wg, bg, ws, bs, wc, bc, h, s, N, T, C, Cd, Cs, S, order};
  const int smem = gwnet_layer_smem_bytes(N, Cd, S, order);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, smem, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, smem, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
