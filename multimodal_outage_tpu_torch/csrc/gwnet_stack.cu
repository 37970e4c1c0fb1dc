// Whole-stack eval-mode Graph WaveNet forward in one kernel for Hopper
// (sm_90a):
//   h = x·Ws + bs
//   L × { g = tanh(h·Wf + bf) ⊙ σ(h·Wg + bg)
//         skip += g·Wskip + bskip
//         terms = [g, A₀ᵀg, (A₀ᵀ)²g, A₁ᵀg, …]     (order-K diffusion, S supports)
//         h = ((terms·Wc + bc) + h) ⊙ aa + ab }   (gconv + residual + folded BN)
//   y = ReLU(ReLU(skip)·E1 + e1b)·E2 + e2b
//
// Replaces the TPU kernel multimodal_outage_tpu/ops/gwnet_stack_pallas.py
// gwnet_stack_forward (pl.pallas_call at :253). It rounds to the storage
// type where that kernel rounds (gwnet_stack_pallas.py:90,100,116,126,128,
// 131) and accumulates in float32; the skip sum stays float32.
//
// What bounds it on the card: latency, not FLOPs or bytes. The work is
// ~0.45 GFLOP per B=1 request in a serial chain of ~70 small matrix
// products (67 rows, 32-512 columns); run op by op it would be ~70+
// launches each too small to fill the card. So the whole stack is one
// launch: one block per (b, t) position keeps its 67 node rows of h, the
// diffusion terms (g is term 0), the float32 skip accumulator and the
// transposed supports in shared memory for all layers, streams each
// layer's weights from global memory (~0.8 MB in bf16, resident in L2
// after the first block touches them) and runs the end convolutions 16
// node rows at a time. The adjacency product is out[w] = Σ_v A[v,w]·g[v],
// i.e. by Aᵀ (gwnet_pallas.py:128); the block stores Aᵀ once.
// Not carried over from the TPU kernel: its 67→128 lane padding and its
// positions-major ↔ node-major staging copies (a Mosaic workaround).
// Products run on the CUDA cores; wgmma is for a later change.
//
// Layouts (row-major): x [B, N, T, Cin]; supports [S, N, N]; start_w
// [Cin, C]; wfg [L, C, 2·Cd] (filter | gate); ws [L, Cd, Cs]; wc
// [L, (S·K+1)·Cd, C]; e1w [Cs, Ce]; e2w [Ce, Cout]; biases [.., cols]. All
// in the storage type except bc, aa, ab (float32). y [B, N, T, Cout].

#include "common.cuh"

namespace {

using namespace port;

constexpr int kThreads = 512;
constexpr int kEndRows = 16;  // node rows per end-convolution chunk

struct Params {
  const void *x, *sup, *start_w, *start_b, *wfg, *bfg, *ws, *bs, *wc;
  const float *bc, *aa, *ab;
  const void *e1w, *e1b, *e2w, *e2b;
  void* y;
  int N, T, cin, C, Cd, Cs, Ce, cout, S, order, L;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) gwnet_stack_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x / p.T, t = blockIdx.x % p.T;
  const int N = p.N, C = p.C, Cd = p.Cd, Cs = p.Cs, Ce = p.Ce;
  const int nt = p.S * p.order + 1, ldt = nt * Cd;
  const int tmp_n = max(N * 2 * Cd, kEndRows * Ce);
  float* h = smem;                    // [N][C]
  float* terms = h + N * C;           // [N][nt·Cd], g is term 0
  float* skip = terms + N * ldt;      // [N][Cs] float32 accumulator
  float* tmp = skip + N * Cs;         // gate pre-activations / end chunk
  float* at = tmp + tmp_n;            // [S][N][N], at[s][w][v] = A_s[v][w]

  const T* sup = static_cast<const T*>(p.sup);
  for (int i = threadIdx.x; i < p.S * N * N; i += blockDim.x) {
    const int s = i / (N * N), w = (i / N) % N, v = i % N;
    at[i] = to_f(sup[((size_t)s * N + v) * N + w]);
  }
  for (int i = threadIdx.x; i < N * Cs; i += blockDim.x) skip[i] = 0.f;

  // start projection, straight from the strided input rows of position (b, t)
  const T* x = static_cast<const T*>(p.x) + ((size_t)b * N * p.T + t) * p.cin;
  const T* sb = static_cast<const T*>(p.start_b);
  matmul<4>(x, p.T * p.cin, static_cast<const T*>(p.start_w), C, N, p.cin, C,
            [&](int r, int c, float a) { h[r * C + c] = rnd<T>(a + to_f(sb[c])); });
  __syncthreads();

  for (int l = 0; l < p.L; ++l) {
    const T* wfg = static_cast<const T*>(p.wfg) + (size_t)l * C * 2 * Cd;
    const T* bfg = static_cast<const T*>(p.bfg) + (size_t)l * 2 * Cd;
    const T* ws = static_cast<const T*>(p.ws) + (size_t)l * Cd * Cs;
    const T* bs = static_cast<const T*>(p.bs) + (size_t)l * Cs;
    const T* wc = static_cast<const T*>(p.wc) + (size_t)l * ldt * C;
    const float* bc = p.bc + (size_t)l * C;
    const float* aa = p.aa + (size_t)l * C;
    const float* ab = p.ab + (size_t)l * C;

    // gated unit: filter and gate pre-activations in one product
    matmul<4>(h, C, wfg, 2 * Cd, N, C, 2 * Cd,
              [&](int r, int c, float a) { tmp[r * 2 * Cd + c] = a + to_f(bfg[c]); });
    __syncthreads();
    for (int i = threadIdx.x; i < N * Cd; i += blockDim.x) {
      const int r = i / Cd, c = i % Cd;
      const float f = tanhf(tmp[r * 2 * Cd + c]);
      const float g = 1.f / (1.f + expf(-tmp[r * 2 * Cd + Cd + c]));
      terms[r * ldt + c] = rnd<T>(f * g);
    }
    __syncthreads();

    // skip projection (float32 accumulator); independent of the diffusion
    // below, which only reads term 0, so no barrier between them
    matmul<4>(terms, ldt, ws, Cs, N, Cd, Cs,
              [&](int r, int c, float a) { skip[r * Cs + c] += a + to_f(bs[c]); });

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

    // graph-conv projection + bias + residual, then the folded BatchNorm
    matmul<4>(terms, ldt, wc, C, N, ldt, C, [&](int r, int c, float a) {
      h[r * C + c] = rnd<T>((a + bc[c] + h[r * C + c]) * aa[c] + ab[c]);
    });
    __syncthreads();
  }

  for (int i = threadIdx.x; i < N * Cs; i += blockDim.x) skip[i] = rnd<T>(fmaxf(skip[i], 0.f));
  __syncthreads();

  const T* e1b = static_cast<const T*>(p.e1b);
  const T* e2b = static_cast<const T*>(p.e2b);
  T* y = static_cast<T*>(p.y) + ((size_t)b * N * p.T + t) * p.cout;
  const size_t ldy = (size_t)p.T * p.cout;
  for (int r0 = 0; r0 < N; r0 += kEndRows) {
    const int rows = min(kEndRows, N - r0);
    matmul<4>(skip + r0 * Cs, Cs, static_cast<const T*>(p.e1w), Ce, rows, Cs, Ce,
              [&](int r, int c, float a) { tmp[r * Ce + c] = rnd<T>(fmaxf(a + to_f(e1b[c]), 0.f)); });
    __syncthreads();
    matmul<4>(tmp, Ce, static_cast<const T*>(p.e2w), p.cout, rows, Ce, p.cout,
              [&](int r, int c, float a) { y[(r0 + r) * ldy + c] = from_f<T>(a + to_f(e2b[c])); });
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, the kernel needs for these sizes.
int gwnet_stack_smem_bytes(int N, int C, int Cd, int Cs, int Ce, int S, int order) {
  const int nt = S * order + 1;
  const int tmp_n = N * 2 * Cd > kEndRows * Ce ? N * 2 * Cd : kEndRows * Ce;
  return 4 * (N * C + N * nt * Cd + N * Cs + tmp_n + S * N * N);
}

// dtype: 0 = float32, 1 = bfloat16. One block per (b, t). Returns a
// cudaError_t code.
int gwnet_stack_launch(const void* x, const void* sup, const void* start_w,
                       const void* start_b, const void* wfg, const void* bfg,
                       const void* ws, const void* bs, const void* wc, const void* bc,
                       const void* aa, const void* ab, const void* e1w, const void* e1b,
                       const void* e2w, const void* e2b, void* y, int B, int N, int T,
                       int cin, int C, int Cd, int Cs, int Ce, int cout, int S, int order,
                       int L, int dtype, void* stream) {
  if (B <= 0 || N <= 0 || T <= 0 || S <= 0 || order <= 0 || L <= 0 || C % 4 || Cd % 4 ||
      Cs % 4 || Ce % 4 || cout % 4)
    return cudaErrorInvalidValue;
  Params p{x, sup, start_w, start_b, wfg, bfg, ws, bs, wc,
           static_cast<const float*>(bc), static_cast<const float*>(aa),
           static_cast<const float*>(ab), e1w, e1b, e2w, e2b, y,
           N, T, cin, C, Cd, Cs, Ce, cout, S, order, L};
  const int smem = gwnet_stack_smem_bytes(N, C, Cd, Cs, Ce, S, order);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(gwnet_stack_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    gwnet_stack_kernel<float><<<B * T, kThreads, smem, st>>>(p);
  } else if (dtype == 1) {
    err = cudaFuncSetAttribute(gwnet_stack_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    gwnet_stack_kernel<__nv_bfloat16><<<B * T, kThreads, smem, st>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
