// Whole eval-mode DCRNN seq2seq in one kernel for Hopper (sm_90a): T
// encoder steps and `horizon` decoder steps through L stacked DCGRU cells,
//   ru = σ(Σ_j Tj(x)·Gx_j + Σ_j Tj(h)·Gh_j + gb)          r, u = split(ru)
//   c  = tanh(Σ_j Tj(x)·Cx_j + Σ_j Tj(r⊙h)·Ch_j + cb)
//   h  = u⊙h + (1−u)⊙c
// with the Chebyshev diffusion terms Tj(v) = [v, A_s v, 2A_s(A_s v) − v, …]
// over every support s, the decoder fed from a zero GO symbol and then its
// own projected output y_t = h_top·P + pb.
//
// Replaces the TPU kernel multimodal_outage_tpu/ops/dcrnn_stack_pallas.py
// dcrnn_stack_forward (pl.pallas_call at :207). Like it, it never builds
// the input concat or the term concat: each projection kernel arrives
// split per term × (x part, h part) (ops/dcrnn_stack.py
// dcrnn_stack_params), and the gates' x-part chains are reused for the
// candidate (:96-102). It rounds to the storage type where that kernel
// rounds: each A-product (:72), each Chebyshev step (:81-83), r (:100),
// r⊙h, the new state (:104) and each output (:119-121); sums are float32.
//
// What bounds it on the card: the serial chain. A sample is ~1.2 GFLOP
// (most of it layer 0's projection of 5 terms × (320 + 64) inputs onto
// 192 gate/candidate columns) and ~2.4 MB, ~1.2 µs at the bf16 tensor
// peak; but its 14 steps × L cells × (chains + projections) are dependent.
// So one block per sample runs the whole recurrence with the states,
// the transposed supports, the float32 gate/candidate accumulators and
// three term buffers in shared memory; the ~1 MB of weights per step
// stream from global memory and stay in L2 after the first touch. The
// x part is taken in chunks of kChunk input columns (diffusion is
// column-wise, projection sums over columns), and each term is projected
// as soon as it exists, so only the chain's two previous terms are live:
// the 5 terms of a 320-wide input would not fit one block's 227 KB. The
// decoder reads its previous output back from y. Products run on the CUDA
// cores, one sample per SM: splitting a sample over a cluster and moving
// the projections to tensor cores is later work.
//
// Layouts (row-major): x [B, N, T, Dx0]; supports [S, N, N]; per cell
// (encoder cells then decoder cells) gx [nt, Dx, 2U], gh [nt, U, 2U],
// gb [1, 2U], cx [nt, Dx, U], ch [nt, U, U], cb [1, U] with nt = S·K + 1;
// proj_w [U, Dout]; proj_b [1, Dout]; y [B, N, horizon, Dout]. Everything
// in the storage type.

#include "common.cuh"

namespace {

using namespace port;

constexpr int kThreads = 512;
constexpr int kMaxLayers = 4;
constexpr int kChunk = 64;  // input columns per x-part chain pass

struct Cell {
  const void *gx, *gh, *gb, *cx, *ch, *cb;
};

struct Params {
  const void *x, *sup;
  Cell cells[2 * kMaxLayers];
  const void *proj_w, *proj_b;
  void* y;
  int N, T, horizon, L, S, K, Dx0, Dout, U;
};

// byte offsets of the shared-memory regions, each 16-byte aligned
struct Layout {
  int at, ru, cacc, states, buf0, bufA, bufB, total, bw;
  __host__ __device__ static int take(int& o, int bytes) {
    const int r = o;
    o += (bytes + 15) & ~15;
    return r;
  }
  __host__ __device__ Layout(int N, int U, int L, int S, int tsize) {
    bw = U > kChunk ? U : kChunk;
    int o = 0;
    at = take(o, 4 * S * N * N);      // float [S][N][N], at[s][w][v] = A_s[v][w]
    ru = take(o, 4 * N * 2 * U);      // float [N][2U] gate accumulator, then σ
    cacc = take(o, 4 * N * U);        // float [N][U] candidate accumulator
    states = take(o, tsize * L * N * U);  // T [L][N][U]
    buf0 = take(o, tsize * N * bw);   // T [N][bw] chain term 0 (x chunk, r⊙h)
    bufA = take(o, tsize * N * bw);   // T [N][bw] chain terms
    bufB = take(o, tsize * N * bw);
    total = o;
  }
};

template <typename T>
struct Block {
  const float* at;
  float *ru, *cacc;
  T *buf0, *bufA, *bufB;
  int N, U, S, K, bw;

  // Projects term 0 = v [N, w] (row stride ldv) and each Chebyshev term of
  // v as it is produced: project(term, ld, j). The caller synchronises
  // before reading what project wrote.
  template <typename Proj>
  __device__ void chains(const T* v, int ldv, int w, Proj project) const {
    project(v, ldv, 0);
    int j = 1;
    for (int s = 0; s < S; ++s) {
      __syncthreads();  // earlier readers of bufA / bufB are done
      const float* a = at + (size_t)s * N * N;
      T* cur = bufA;
      matmul<2>(a, N, v, ldv, N, N, w,
                [&](int r, int c, float acc) { cur[r * bw + c] = from_f<T>(acc); });
      __syncthreads();
      project(cur, bw, j++);
      const T* prev = v;
      int ldp = ldv;
      for (int k = 2; k <= K; ++k) {
        // T_k = 2A·T_{k−1} − T_{k−2}; it overwrites T_{k−2} in place (each
        // element is read and written by one thread) unless that is v
        T* dst = prev == v ? bufB : const_cast<T*>(prev);
        matmul<2>(a, N, cur, bw, N, N, w, [&](int r, int c, float acc) {
          dst[r * bw + c] = from_f<T>(2.f * rnd<T>(acc) - to_f(prev[r * ldp + c]));
        });
        __syncthreads();
        project(dst, bw, j++);
        prev = cur;
        ldp = bw;
        cur = dst;
      }
    }
  }

  // One DCGRU cell: h (shared, [N][U]) ← cell(h, input). The input has dx
  // columns: from global memory with row stride ldx (x, or y's previous
  // step) when global, else the shared state of the layer below; zero
  // (the GO symbol) when xin is null.
  __device__ void dcgru(const Cell& w, int dx, const T* xin, size_t ldx, bool from_global,
                        T* h) const {
    const int U2 = 2 * U;
    const T* gb = static_cast<const T*>(w.gb);
    const T* cb = static_cast<const T*>(w.cb);
    __syncthreads();  // the previous cell is done with ru, cacc and buf0
    for (int i = threadIdx.x; i < N * U2; i += blockDim.x) ru[i] = to_f(gb[i % U2]);
    for (int i = threadIdx.x; i < N * U; i += blockDim.x) cacc[i] = to_f(cb[i % U]);
    __syncthreads();

    // x part of the gates and the candidate: one set of chains for both
    for (int d0 = 0; xin != nullptr && d0 < dx; d0 += bw) {
      const int wd = min(bw, dx - d0);
      const T* v = xin + d0;
      int ldv = (int)ldx;
      if (from_global) {
        __syncthreads();  // buf0's previous readers are done
        for (int i = threadIdx.x; i < N * wd; i += blockDim.x) {
          const int r = i / wd, c = i % wd;
          buf0[r * bw + c] = xin[r * ldx + d0 + c];
        }
        __syncthreads();
        v = buf0;
        ldv = bw;
      }
      const T* gx = static_cast<const T*>(w.gx) + (size_t)d0 * U2;
      const T* cx = static_cast<const T*>(w.cx) + (size_t)d0 * U;
      chains(v, ldv, wd, [&](const T* term, int ld, int j) {
        matmul<4>(term, ld, gx + (size_t)j * dx * U2, U2, N, wd, U2,
                  [&](int r, int c, float a) { ru[r * U2 + c] += a; });
        matmul<4>(term, ld, cx + (size_t)j * dx * U, U, N, wd, U,
                  [&](int r, int c, float a) { cacc[r * U + c] += a; });
      });
    }

    // h part of the gates
    const T* gh = static_cast<const T*>(w.gh);
    chains(h, U, U, [&](const T* term, int ld, int j) {
      matmul<4>(term, ld, gh + (size_t)j * U * U2, U2, N, U, U2,
                [&](int r, int c, float a) { ru[r * U2 + c] += a; });
    });
    __syncthreads();
    for (int i = threadIdx.x; i < N * U2; i += blockDim.x) ru[i] = sigmoidf(ru[i]);
    __syncthreads();
    for (int i = threadIdx.x; i < N * U; i += blockDim.x) {
      const int r = i / U, c = i % U;
      buf0[r * bw + c] = from_f<T>(rnd<T>(ru[r * U2 + c]) * to_f(h[i]));
    }
    __syncthreads();

    // (r ⊙ h) part of the candidate
    const T* ch = static_cast<const T*>(w.ch);
    chains(buf0, bw, U, [&](const T* term, int ld, int j) {
      matmul<4>(term, ld, ch + (size_t)j * U * U, U, N, U, U,
                [&](int r, int c, float a) { cacc[r * U + c] += a; });
    });
    __syncthreads();
    for (int i = threadIdx.x; i < N * U; i += blockDim.x) {
      const float u = ru[(i / U) * U2 + U + i % U];
      h[i] = from_f<T>(u * to_f(h[i]) + (1.f - u) * tanhf(cacc[i]));
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) dcrnn_stack_kernel(Params p) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const Layout lay(p.N, p.U, p.L, p.S, sizeof(T));
  const int b = blockIdx.x, N = p.N, U = p.U, L = p.L;
  Block<T> blk{reinterpret_cast<const float*>(base + lay.at),
               reinterpret_cast<float*>(base + lay.ru),
               reinterpret_cast<float*>(base + lay.cacc),
               reinterpret_cast<T*>(base + lay.buf0),
               reinterpret_cast<T*>(base + lay.bufA),
               reinterpret_cast<T*>(base + lay.bufB),
               N, U, p.S, p.K, lay.bw};
  T* states = reinterpret_cast<T*>(base + lay.states);
  float* at = reinterpret_cast<float*>(base + lay.at);

  const T* sup = static_cast<const T*>(p.sup);
  for (int i = threadIdx.x; i < p.S * N * N; i += blockDim.x) {
    const int s = i / (N * N), w = (i / N) % N, v = i % N;
    at[i] = to_f(sup[((size_t)s * N + v) * N + w]);
  }
  for (int i = threadIdx.x; i < L * N * U; i += blockDim.x) states[i] = from_f<T>(0.f);

  // encoder
  const T* x = static_cast<const T*>(p.x) + (size_t)b * N * p.T * p.Dx0;
  for (int t = 0; t < p.T; ++t) {
    blk.dcgru(p.cells[0], p.Dx0, x + (size_t)t * p.Dx0, (size_t)p.T * p.Dx0, true, states);
    for (int l = 1; l < L; ++l)
      blk.dcgru(p.cells[l], U, states + (l - 1) * N * U, U, false, states + l * N * U);
  }

  // decoder: GO = zeros, then each step's own output
  T* y = static_cast<T*>(p.y) + (size_t)b * N * p.horizon * p.Dout;
  const size_t ldy = (size_t)p.horizon * p.Dout;
  const T* pw = static_cast<const T*>(p.proj_w);
  const T* pb = static_cast<const T*>(p.proj_b);
  for (int t = 0; t < p.horizon; ++t) {
    blk.dcgru(p.cells[L], p.Dout, t == 0 ? nullptr : y + (size_t)(t - 1) * p.Dout, ldy, true,
              states);
    for (int l = 1; l < L; ++l)
      blk.dcgru(p.cells[L + l], U, states + (l - 1) * N * U, U, false, states + l * N * U);
    __syncthreads();
    T* yt = y + (size_t)t * p.Dout;
    matmul<4>(states + (L - 1) * N * U, U, pw, p.Dout, N, U, p.Dout,
              [&](int r, int c, float a) { yt[r * ldy + c] = from_f<T>(a + to_f(pb[c])); });
    __syncthreads();  // y_t is the next step's input
  }
}

template <typename T>
int launch(const Params& p, int B, cudaStream_t st) {
  const int smem = Layout(p.N, p.U, p.L, p.S, sizeof(T)).total;
  const cudaError_t err = cudaFuncSetAttribute(
      dcrnn_stack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dcrnn_stack_kernel<T><<<B, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, the kernel needs for these sizes.
int dcrnn_stack_smem_bytes(int N, int U, int L, int S, int dtype) {
  return Layout(N, U, L, S, dtype == 0 ? 4 : 2).total;
}

// cells: 6·2L pointers, (gx, gh, gb, cx, ch, cb) per cell, encoder cells
// first. dtype: 0 = float32, 1 = bfloat16. One block per sample. Returns a
// cudaError_t code.
int dcrnn_stack_launch(const void* x, const void* sup, const void* const* cells,
                       const void* proj_w, const void* proj_b, void* y, int B, int N,
                       int T, int horizon, int L, int S, int K, int Dx0, int Dout, int U,
                       int dtype, void* stream) {
  if (B <= 0 || N <= 0 || T <= 0 || horizon <= 0 || L <= 0 || L > kMaxLayers || S <= 0 ||
      K <= 0 || Dx0 % 4 || Dout % 4 || U % 4 || Dx0 <= 0 || Dout <= 0 || U <= 0)
    return cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.sup = sup;
  for (int c = 0; c < 2 * L; ++c) {
    const void* const* w = cells + 6 * c;
    p.cells[c] = Cell{w[0], w[1], w[2], w[3], w[4], w[5]};
  }
  p.proj_w = proj_w;
  p.proj_b = proj_b;
  p.y = y;
  p.N = N; p.T = T; p.horizon = horizon; p.L = L; p.S = S; p.K = K;
  p.Dx0 = Dx0; p.Dout = Dout; p.U = U;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, B, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, st);
  return cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
