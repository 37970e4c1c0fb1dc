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
// peak; but its 14 steps × L cells × (chains, projections, gating) are
// dependent, so one block per sample runs the whole recurrence with the
// states, the transposed supports, the float32 accumulators and the term
// buffers in shared memory. Next after the chain: the weights, ~1 MB per
// step and ~13 MB per sample, stream from L2 (they stay there after the
// first sample touches them).
//
// Two bodies, chosen by the storage type:
//
// - bfloat16 (serving): every product on the tensor cores, mma.sync
//   m16n8k16 with float32 accumulation. The 67 node rows are padded to
//   80 (5 m-tiles, one pass of kPassMT) with zero rows. The x part is
//   taken in chunks of kChunk input columns (diffusion is column-wise,
//   projection sums over columns). Per chunk, and for h and r⊙h, one
//   phase computes one Chebyshev order for all S supports, all nt terms
//   are kept, and one projection sums over them (K = nt × chunk). So a
//   cell at full width is 13-29 barrier-separated phases, ~560 per
//   sample, where one pair per term took ~1,300. The projection weights
//   arrive in B-fragment order (ops/dcrnn_stack.py stack_fragments, once
//   at engine build): a fragment is one 8-byte load per lane; a warp owns
//   an n8 column tile across the m-tiles, so each fragment is read from
//   L2 once per block and step and used 5 times; kPrefetch k-steps of
//   fragments are loaded ahead of their mma's. The gate and candidate
//   accumulators stay float32 in shared memory (acc), added to once per
//   projection. A operands come from shared memory by ldmatrix; the
//   chains' A is the transposed supports, staged once as bf16.
// - float32: the same recurrence on the CUDA cores (port::matmul), each
//   term projected as soon as it exists so only the chain's two previous
//   terms are live; TF32 would break the 1e-4 float32 bar.
//
// Layouts (row-major): x [B, N, T, Dx0]; supports [S, N, N]; y [B, N,
// horizon, Dout]; biases gb [1, 2U], cb [1, U], proj_b [1, Dout], all in
// the storage type. float32 cells: gx [nt, Dx, 2U], gh [nt, U, 2U], cx
// [nt, Dx, U], ch [nt, U, U] with nt = S·K + 1; proj_w [U, Dout]. bf16
// cells: wx [nt, ⌈Dx/16⌉, (G8 + C8)/8, 32 lanes, 4], the gates' and the
// candidate's x parts side by side (G8 = 8⌈2U/8⌉, C8 = 8⌈U/8⌉); wh [nt,
// ⌈U/16⌉, G8/8, 32, 4]; wr [nt, ⌈U/16⌉, C8/8, 32, 4]; proj [1, ⌈U/16⌉,
// ⌈Dout/8⌉, 32, 4].

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace port;

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 4;
constexpr int kChunk = 64;   // input columns per x-part chain pass
constexpr int kPassMT = 5;   // bf16: m-tiles per pass, the accumulators a lane holds
constexpr int kPrefetch = 2; // bf16: B-fragment k-steps loaded ahead

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

// ---------------------------------------------------------------- bf16

struct CellB {
  const uint2 *wx, *wh, *wr;  // packed B fragments
  const bf16 *gb, *cb;
};

struct ParamsB {
  const bf16 *x, *sup;
  CellB cells[2 * kMaxLayers];
  const uint2* proj;
  const bf16* proj_b;
  bf16* y;
  int N, T, horizon, L, S, K, Dx0, Dout, U;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared memory of the bf16 body. Row strides are 8 bf16 (or floats)
// past a multiple of 16 bytes, so the 8 rows of an ldmatrix or of an
// accumulator fragment fall in distinct banks.
struct LayoutB {
  int Np, MT, Up, G8, C8, nt, ld_at, ld_acc, ld_s, ld_t;
  int at, acc, states, terms, total;
  __host__ __device__ LayoutB(int N, int U, int L, int S, int K) {
    Np = round_up(N, 16);
    MT = Np / 16;
    Up = round_up(U, 16);
    G8 = round_up(2 * U, 8);
    C8 = round_up(U, 8);
    nt = S * K + 1;
    ld_at = Np + 8;
    ld_acc = round_up(G8 + C8, 32) + 8;
    ld_s = Up + 8;
    ld_t = (Up > kChunk ? Up : kChunk) + 8;
    int o = 0;
    at = Layout::take(o, 2 * S * Np * ld_at);      // bf16 [S][Np][ld_at], A_s transposed
    acc = Layout::take(o, 4 * Np * ld_acc);        // float [Np][ld_acc]: gates | candidate
    states = Layout::take(o, 2 * L * Np * ld_s);   // bf16 [L][Np][ld_s]
    terms = Layout::take(o, 2 * nt * Np * ld_t);   // bf16 [nt][Np][ld_t]
    total = o;
  }
};

struct BlockB {
  const bf16* at;
  float* acc;
  bf16* terms;
  LayoutB lay;
  int N, U, S, K;

  __device__ bf16* term(int j) const { return terms + (size_t)j * lay.Np * lay.ld_t; }

  // term 0 ← columns [d0, d0 + w) of the N rows of src (row stride ld),
  // zero from column `valid` on; w % 4 == 0
  __device__ void load_term0(const bf16* src, size_t ld, int d0, int w, int valid) const {
    const int q = w / 4;
    for (int i = threadIdx.x; i < N * q; i += blockDim.x) {
      const int r = i / q, c = 4 * (i % q);
      uint2 v = make_uint2(0u, 0u);
      if (d0 + c < valid) v = *reinterpret_cast<const uint2*>(src + r * ld + d0 + c);
      *reinterpret_cast<uint2*>(terms + r * lay.ld_t + c) = v;
    }
  }

  // Chebyshev terms 1 … nt−1 of term 0 over its first w columns, term
  // 1 + s·K + k − 1 = T_k over support s. Phase k computes T_k of every
  // support: T_1 = A_s·T_0, T_k = 2·A_s·T_{k−1} − T_{k−2}, rounded to bf16
  // after the product and after the step, as the TPU kernel does. A warp
  // takes one (support, n8 tile, pass of m-tiles) at a time. Pad rows
  // stay zero: the supports' pad rows and columns are zero.
  __device__ void chains(int w) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int nq = w / 8, passes = (lay.MT + kPassMT - 1) / kPassMT;
    for (int k = 1; k <= K; ++k) {
      for (int item = warp; item < S * nq * passes; item += kWarps) {
        const int s = item / (nq * passes), n0 = 8 * (item % nq);
        const int m0 = kPassMT * (item / nq % passes), j = s * K + k;
        const bf16* src = term(k == 1 ? 0 : j - 1);
        const bf16* a = at + ((size_t)s * lay.Np + 16 * m0 + (lane & 15)) * lay.ld_at +
                        8 * (lane >> 4);
        float d[kPassMT][4] = {};
        for (int ks = 0; ks < lay.MT; ++ks) {
          uint32_t b[2];
          ldmatrix_x2_trans(b, src + (16 * ks + (lane & 15)) * lay.ld_t + n0);
#pragma unroll
          for (int i = 0; i < kPassMT; ++i) {
            if (m0 + i < lay.MT) {
              uint32_t f[4];
              ldmatrix_x4(f, a + 16 * i * lay.ld_at + 16 * ks);
              mma_bf16(d[i], f[0], f[1], f[2], f[3], b[0], b[1]);
            }
          }
        }
        bf16* dst = term(j);
        const bf16* prev = term(k == 2 ? 0 : j - 2);
#pragma unroll
        for (int i = 0; i < kPassMT; ++i) {
          if (m0 + i < lay.MT) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int off = (16 * (m0 + i) + g + 8 * hh) * lay.ld_t + n0 + 2 * t;
              float v0 = d[i][2 * hh], v1 = d[i][2 * hh + 1];
              if (k >= 2) {
                const float2 p =
                    __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(prev + off));
                v0 = 2.f * rnd<bf16>(v0) - p.x;
                v1 = 2.f * rnd<bf16>(v1) - p.y;
              }
              *reinterpret_cast<__nv_bfloat162*>(dst + off) = __floats2bfloat162_rn(v0, v1);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // Σ over nterms terms (A: Np rows of stride ld, terms tstride apart) ×
  // kpt k-steps of term × weights, the weights' fragments from k-step ks0
  // of each packed term of KS k-steps and nq n-tiles. Warp w owns n-tiles
  // w, w + 16, … across the m-tiles of a pass (all of them up to 80 rows),
  // so each B fragment is loaded once per pass and used up to kPassMT
  // times, kPrefetch k-steps ahead of its mma's. epi(q, m0, sums) gets
  // n-tile q's float32 sums over m-tiles m0 ….
  template <typename Epi>
  __device__ __forceinline__ void project(const bf16* A, int tstride, int ld, int nterms, int kpt,
                                          const uint2* frags, int KS, int ks0, int nq,
                                          Epi epi) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int total = nterms * kpt;
    const bf16* a_lane = A + (lane & 15) * ld + 8 * (lane >> 4);
    const int passes = (lay.MT + kPassMT - 1) / kPassMT;
    for (int item = warp; item < nq * passes; item += kWarps) {
      const int q = item % nq, m0 = kPassMT * (item / nq);
      auto frag = [&](int i) {
        i = min(i, total - 1);
        const int j = i / kpt;
        return __ldg(frags + ((size_t)(j * KS + ks0 + i - j * kpt) * nq + q) * 32 + lane);
      };
      uint2 ring[kPrefetch];
#pragma unroll
      for (int i = 0; i < kPrefetch; ++i) ring[i] = frag(i);
      float d[kPassMT][4] = {};
      for (int i = 0; i < total; ++i) {
        const uint2 b = ring[0];
#pragma unroll
        for (int r = 0; r + 1 < kPrefetch; ++r) ring[r] = ring[r + 1];
        ring[kPrefetch - 1] = frag(i + kPrefetch);
        const int j = i / kpt;
        const bf16* a = a_lane + (size_t)j * tstride + 16 * (i - j * kpt);
#pragma unroll
        for (int mi = 0; mi < kPassMT; ++mi) {
          if (m0 + mi < lay.MT) {
            uint32_t f[4];
            ldmatrix_x4(f, a + 16 * (m0 + mi) * ld);
            mma_bf16(d[mi], f[0], f[1], f[2], f[3], b.x, b.y);
          }
        }
      }
      epi(q, m0, d);
    }
  }

  // acc[:, col0 + 8q …] += sums, over all Np rows (pad rows only ever
  // see zero terms)
  __device__ __forceinline__ void add_to_acc(int col0, int q, int m0,
                                             const float (&d)[kPassMT][4]) const {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int i = 0; i < kPassMT; ++i) {
      if (m0 + i < lay.MT) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float2* p = reinterpret_cast<float2*>(acc + (16 * (m0 + i) + g + 8 * hh) * lay.ld_acc +
                                                col0 + 8 * q + 2 * t);
          float2 v = *p;
          v.x += d[i][2 * hh];
          v.y += d[i][2 * hh + 1];
          *p = v;
        }
      }
    }
  }

  // One DCGRU cell: h (shared, [Np][ld_s]) ← cell(h, input). The input
  // has dx columns of row stride ldx (x or y's previous step in global
  // memory, or the shared state of the layer below); none (the zero GO
  // symbol) when xin is null.
  __device__ void dcgru(const CellB& w, int dx, const bf16* xin, size_t ldx, bf16* h) const {
    const int U2 = 2 * U, G8 = lay.G8, ldc = lay.ld_acc, ts = lay.Np * lay.ld_t, k16 = lay.Up / 16;
    auto to_gates = [&](int q, int m0, const float (&d)[kPassMT][4]) { add_to_acc(0, q, m0, d); };
    __syncthreads();  // the previous cell is done with acc and the terms
    for (int i = threadIdx.x; i < lay.Np * ldc; i += blockDim.x) {
      const int c = i % ldc;
      acc[i] = c < U2 ? to_f(w.gb[c]) : c >= G8 && c < G8 + U ? to_f(w.cb[c - G8]) : 0.f;
    }

    // x part of the gates and the candidate: one set of chains for both
    const int dxp = round_up(dx, 16);
    for (int d0 = 0; xin != nullptr && d0 < dxp; d0 += kChunk) {
      const int wd = min(kChunk, dxp - d0);
      if (d0) __syncthreads();  // the previous chunk's projection is done with the terms
      load_term0(xin, ldx, d0, wd, dx);
      __syncthreads();
      chains(wd);
      project(terms, ts, lay.ld_t, lay.nt, wd / 16, w.wx, dxp / 16, d0 / 16, (G8 + lay.C8) / 8,
              to_gates);
    }
    __syncthreads();

    // h part of the gates
    load_term0(h, lay.ld_s, 0, lay.Up, lay.Up);
    __syncthreads();
    chains(lay.Up);
    project(terms, ts, lay.ld_t, lay.nt, k16, w.wh, k16, 0, G8 / 8, to_gates);
    __syncthreads();

    // σ; term 0 ← r ⊙ h (its columns past U still hold h's zero padding)
    for (int i = threadIdx.x; i < N * U2; i += blockDim.x) {
      const int r = i / U2, c = i % U2;
      float* a = acc + r * ldc + c;
      const float v = sigmoidf(*a);
      if (c < U)
        terms[r * lay.ld_t + c] = from_f<bf16>(rnd<bf16>(v) * to_f(h[r * lay.ld_s + c]));
      else
        *a = v;
    }
    __syncthreads();

    // (r ⊙ h) part of the candidate
    chains(lay.Up);
    project(terms, ts, lay.ld_t, lay.nt, k16, w.wr, k16, 0, lay.C8 / 8,
            [&](int q, int m0, const float (&d)[kPassMT][4]) { add_to_acc(G8, q, m0, d); });
    __syncthreads();
    for (int i = threadIdx.x; i < N * U; i += blockDim.x) {
      const int r = i / U, c = i % U;
      const float u = acc[r * ldc + U + c];
      bf16* hp = h + r * lay.ld_s + c;
      *hp = from_f<bf16>(u * to_f(*hp) + (1.f - u) * tanhf(acc[r * ldc + G8 + c]));
    }
  }
};

__global__ void __launch_bounds__(kThreads) dcrnn_stack_kernel_bf16(ParamsB p) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const LayoutB lay(p.N, p.U, p.L, p.S, p.K);
  const int b = blockIdx.x, N = p.N, U = p.U, L = p.L;
  for (int i = threadIdx.x; i < lay.total / 16; i += blockDim.x)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);  // every pad row and column stays zero
  __syncthreads();
  bf16* at = reinterpret_cast<bf16*>(base + lay.at);
  for (int i = threadIdx.x; i < p.S * N * N; i += blockDim.x) {
    const int s = i / (N * N), w = (i / N) % N, v = i % N;
    at[((size_t)s * lay.Np + w) * lay.ld_at + v] = p.sup[((size_t)s * N + v) * N + w];
  }
  const BlockB blk{at, reinterpret_cast<float*>(base + lay.acc),
                   reinterpret_cast<bf16*>(base + lay.terms), lay, N, U, p.S, p.K};
  bf16* states = reinterpret_cast<bf16*>(base + lay.states);
  const int sstride = lay.Np * lay.ld_s;

  // encoder
  const bf16* x = p.x + (size_t)b * N * p.T * p.Dx0;
  for (int t = 0; t < p.T; ++t) {
    blk.dcgru(p.cells[0], p.Dx0, x + (size_t)t * p.Dx0, (size_t)p.T * p.Dx0, states);
    for (int l = 1; l < L; ++l)
      blk.dcgru(p.cells[l], U, states + (l - 1) * sstride, lay.ld_s, states + l * sstride);
  }

  // decoder: GO = zeros, then each step's own output
  bf16* y = p.y + (size_t)b * N * p.horizon * p.Dout;
  const size_t ldy = (size_t)p.horizon * p.Dout;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4, k16 = lay.Up / 16;
  for (int t = 0; t < p.horizon; ++t) {
    blk.dcgru(p.cells[L], p.Dout, t == 0 ? nullptr : y + (size_t)(t - 1) * p.Dout, ldy, states);
    for (int l = 1; l < L; ++l)
      blk.dcgru(p.cells[L + l], U, states + (l - 1) * sstride, lay.ld_s, states + l * sstride);
    __syncthreads();
    bf16* yt = y + (size_t)t * p.Dout;
    blk.project(states + (L - 1) * sstride, 0, lay.ld_s, 1, k16, p.proj, k16, 0,
                round_up(p.Dout, 8) / 8, [&](int q, int m0, const float (&d)[kPassMT][4]) {
                  const int c = 8 * q + 2 * tq;
                  if (c >= p.Dout) return;
                  const float b0 = to_f(p.proj_b[c]), b1 = to_f(p.proj_b[c + 1]);
#pragma unroll
                  for (int i = 0; i < kPassMT; ++i) {
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                      const int r = 16 * (m0 + i) + g + 8 * hh;
                      if (r < N)
                        *reinterpret_cast<__nv_bfloat162*>(yt + r * ldy + c) =
                            __floats2bfloat162_rn(d[i][2 * hh] + b0, d[i][2 * hh + 1] + b1);
                    }
                  }
                });
    __syncthreads();  // y_t is the next step's input
  }
}

// ---------------------------------------------------------------- launch

int launch_f32(const Params& p, int B, cudaStream_t st) {
  const int smem = Layout(p.N, p.U, p.L, p.S, sizeof(float)).total;
  const cudaError_t err = cudaFuncSetAttribute(
      dcrnn_stack_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dcrnn_stack_kernel<float><<<B, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

int launch_bf16(const ParamsB& p, int B, cudaStream_t st) {
  const int smem = LayoutB(p.N, p.U, p.L, p.S, p.K).total;
  const cudaError_t err = cudaFuncSetAttribute(
      dcrnn_stack_kernel_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dcrnn_stack_kernel_bf16<<<B, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

bool bad_dims(int B, int N, int T, int horizon, int L, int S, int K, int Dx0, int Dout, int U) {
  return B <= 0 || N <= 0 || T <= 0 || horizon <= 0 || L <= 0 || L > kMaxLayers || S <= 0 ||
         K <= 0 || Dx0 % 4 || Dout % 4 || U % 4 || Dx0 <= 0 || Dout <= 0 || U <= 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, the kernel needs for these sizes:
// the float32 body (is_bf16 = 0) or the bf16 body (is_bf16 = 1).
int dcrnn_stack_smem_bytes(int N, int U, int L, int S, int K, int is_bf16) {
  return is_bf16 ? LayoutB(N, U, L, S, K).total : Layout(N, U, L, S, 4).total;
}

// float32. cells: 6·2L pointers, (gx, gh, gb, cx, ch, cb) per cell,
// encoder cells first. One block per sample. Returns a cudaError_t code.
int dcrnn_stack_launch_f32(const void* x, const void* sup, const void* const* cells,
                           const void* proj_w, const void* proj_b, void* y, int B, int N, int T,
                           int horizon, int L, int S, int K, int Dx0, int Dout, int U,
                           void* stream) {
  if (bad_dims(B, N, T, horizon, L, S, K, Dx0, Dout, U)) return cudaErrorInvalidValue;
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
  return launch_f32(p, B, static_cast<cudaStream_t>(stream));
}

// bfloat16. cells: 5·2L pointers, (wx, wh, wr, gb, cb) per cell, encoder
// cells first, the weights in fragment order; proj likewise.
int dcrnn_stack_launch_bf16(const void* x, const void* sup, const void* const* cells,
                            const void* proj, const void* proj_b, void* y, int B, int N, int T,
                            int horizon, int L, int S, int K, int Dx0, int Dout, int U,
                            void* stream) {
  if (bad_dims(B, N, T, horizon, L, S, K, Dx0, Dout, U)) return cudaErrorInvalidValue;
  ParamsB p{};
  p.x = static_cast<const bf16*>(x);
  p.sup = static_cast<const bf16*>(sup);
  for (int c = 0; c < 2 * L; ++c) {
    const void* const* w = cells + 5 * c;
    p.cells[c] = CellB{static_cast<const uint2*>(w[0]), static_cast<const uint2*>(w[1]),
                       static_cast<const uint2*>(w[2]), static_cast<const bf16*>(w[3]),
                       static_cast<const bf16*>(w[4])};
  }
  p.proj = static_cast<const uint2*>(proj);
  p.proj_b = static_cast<const bf16*>(proj_b);
  p.y = static_cast<bf16*>(y);
  p.N = N; p.T = T; p.horizon = horizon; p.L = L; p.S = S; p.K = K;
  p.Dx0 = Dx0; p.Dout = Dout; p.U = U;
  return launch_bf16(p, B, static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
