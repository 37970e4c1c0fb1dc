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
// What bounds it on the card: latency, not FLOPs or bytes. A (b, t)
// position is ~62 MFLOP (56% of it the two end convolutions) in a serial
// chain of ~70 small products (67 rows, 32-512 columns); a B=1 request is
// ~0.45 GFLOP and ~1 MB, under a microsecond at the card's peaks. Run op
// by op it would be ~70+ launches each too small to fill the card. So the
// whole stack is one launch: one block per (b, t) position keeps its 67
// node rows of h, the diffusion terms (g is term 0), the float32 skip
// accumulator and the transposed supports in shared memory for all
// layers, and streams each layer's weights from global memory (~0.8 MB in
// bf16, resident in L2 after the first block touches them). The adjacency
// product is out[w] = Σ_v A[v,w]·g[v], i.e. by Aᵀ (gwnet_pallas.py:128);
// the block stores Aᵀ once. Not carried over from the TPU kernel: its
// 67→128 lane padding and its positions-major ↔ node-major staging copies
// (a Mosaic workaround).
//
// Two bodies, chosen by the storage type:
//
// - bfloat16 (serving): gwnet_stack_kernel_bf16, every product on the
//   tensor cores, mma.sync m16n8k16 with float32 accumulation. What is
//   left once the products are off the CUDA cores is the chain itself:
//   per layer 3 + (order − 1) barrier-separated phases,
//     1. h·[Wf | Wg] with the gated unit in the epilogue → term 0 (g);
//     2. g·Wskip into the float32 skip accumulator, together with the
//        first diffusion order of every support (both read only g);
//     3. each further order, term j = Aᵀ_s · term j−1;
//     4. terms·Wc with bias, residual and folded BN in the epilogue → h.
//   Node rows are padded to 16 (67 → 80, 5 m-tiles), K to 16 and N to 8
//   with zeros. The block zeroes its shared memory once and every later
//   write touches real rows and columns only, so the pads stay zero
//   through all layers and the K = 80 diffusion products never meet
//   garbage. The weights arrive in B-fragment order (ops/gwnet_stack.py
//   stack_fragments, once at engine build): a fragment is one 8-byte load
//   per lane, kPrefetch k-steps ahead of its mma's. Each block asks L2
//   for all of them at its start (a serving forward finds them evicted by
//   the U-Net), and the next layer's Wf|Wg, Wskip and Wc fragments are
//   copied into shared memory by cp.async while the current layer runs
//   (two buffers, where they fit; else the phases read them from L2).
//   On an H100 a layer's four phases take ~10 µs and the rest (set-up,
//   start projection, end convolutions) ~50 µs: the chain's latency, far
//   above the time of its mma's or its bytes. [Wf | Wg] is
//   interleaved in blocks of 8 columns (filter n-tile 2q, gate n-tile
//   2q + 1), so a lane holds a filter column and its gate column in the
//   same slot of two accumulator fragments and computes g in registers.
//   A operands come from shared memory by ldmatrix; the diffusion's B
//   operand is the row-major term buffer read by ldmatrix.trans, its A
//   the transposed supports in bf16. A warp's item is one (n-tile,
//   m-tile) of the narrow products, so 16 warps share 20-72 items a
//   phase, and one n-tile over up to kPassMT m-tiles of the wide ones
//   (skip, end convolutions), so each fragment of Wskip, E1 and E2 is read
//   once per block and used 5 times. The start projection's input rows
//   arrive by cp.async. The end convolutions run over the whole 80-row
//   tile (in chunks where shared memory is short), relu(skip) in the bytes
//   of the supports and terms, E1's output in those of the skip sum.
// - float32: gwnet_stack_kernel<float>, the same chain on the CUDA cores
//   (port::matmul), the end convolutions 16 node rows at a time. TF32
//   would break the 1e-4 float32 bar.
//
// Layouts (row-major): x [B, N, T, Cin]; supports [S, N, N]; y [B, N, T,
// Cout]; biases [.., cols], in the storage type except bc, aa, ab
// (float32). float32 weights: start_w [Cin, C]; wfg [L, C, 2·Cd] (filter
// | gate); ws [L, Cd, Cs]; wc [L, (S·K+1)·Cd, C]; e1w [Cs, Ce]; e2w [Ce,
// Cout]. bf16 weights in fragment order, each [terms, K/16, N/8, 32 lanes,
// 4] with K padded to 16 and N to 8 (ops/fragments.py pack_fragments):
// start [1, Cin, C]; wfg [L, C, 2·Cd8] interleaved (Cd8 = 8⌈Cd/8⌉); ws
// [L, Cd, Cs]; wc [L, nt·Cd16, C], each term's rows padded to Cd16 =
// 16⌈Cd/16⌉; e1 [1, Cs, Ce]; e2 [1, Ce, Cout].

#include "block_mma.cuh"
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


// ---------------------------------------------------------------- bf16

constexpr int kWarps = kThreads / 32;
constexpr int kPassMT = 5;        // m-tiles of a wide product's item: the accumulators a lane holds
constexpr int kPrefetch = 4;      // B-fragment k-steps loaded ahead
constexpr int kMaxSmem = 232448;  // dynamic shared memory one block may have

struct ParamsB {
  const bf16 *x, *sup;
  const uint2 *start, *wfg, *ws, *wc, *e1, *e2;  // packed B fragments
  const bf16 *start_b, *bfg, *bs, *e1b, *e2b;
  const float *bc, *aa, *ab;
  bf16* y;
  int N, T, cin, C, Cd, Cs, Ce, cout, S, order, L;
};


// Shared memory of the bf16 body: byte offsets (16-byte aligned), padded
// widths and row strides. bf16 strides are 8 past a multiple of 16
// elements, so the 8 rows of an ldmatrix fall in distinct banks; the
// float32 skip stride is 8 past a multiple of 32.
struct LayoutB {
  int Np, MT, Cinp, Cp, C8, Cdp, Cd8, Csp, Cs8, Cep, Ce8, cout8, nt, emt;
  int ld_x, ld_at, ld_h, ld_t, ld_k, ld_r, ld_e;
  int fg_n, ws_n, wc_n;  // one layer's wfg, ws and wc fragments, in uint2
  int at, h, terms, skip, x, r, e, e_bytes, w, w_bytes, total;
  bool staged;
  __host__ __device__ LayoutB(int N, int cin, int C, int Cd, int Cs, int Ce, int cout, int S,
                              int K) {
    Np = round_up(N, 16);
    MT = Np / 16;
    Cinp = round_up(cin, 16);
    Cp = round_up(C, 16);
    C8 = round_up(C, 8);
    Cdp = round_up(Cd, 16);
    Cd8 = round_up(Cd, 8);
    Csp = round_up(Cs, 16);
    Cs8 = round_up(Cs, 8);
    Cep = round_up(Ce, 16);
    Ce8 = round_up(Ce, 8);
    cout8 = round_up(cout, 8);
    nt = S * K + 1;
    ld_x = Cinp + 8;
    ld_at = Np + 8;
    ld_h = Cp + 8;
    ld_t = nt * Cdp + 8;
    ld_k = round_up(Cs8, 32) + 8;
    ld_r = Csp + 8;
    ld_e = Cep + 8;
    // Through the layers: at, h, terms and skip. Once they are done,
    // relu(skip) (r) takes the bytes of at, h and terms; the start's input
    // rows (x) and E1's output (e) take skip's, before and after it.
    at = 0;
    h = at + align16(2 * S * Np * ld_at);
    terms = h + align16(2 * Np * ld_h);
    r = 0;
    skip = x = e = imax(terms + align16(2 * Np * ld_t), align16(2 * Np * ld_r));
    const int rest = imax(4 * Np * ld_k, 2 * Np * ld_x);
    emt = MT < kPassMT ? MT : kPassMT;  // m-tiles per end-convolution chunk
    while (emt > 1 && skip + imax(rest, 32 * emt * ld_e) > kMaxSmem) --emt;
    e_bytes = 32 * emt * ld_e;
    total = skip + align16(imax(rest, e_bytes));
    // Two buffers for one layer's wfg | ws | wc fragments each (cp.async,
    // a layer ahead), where they fit; else the phases read them from L2.
    fg_n = 32 * (Cp / 16) * 2 * (Cd8 / 8);
    ws_n = 32 * (Cdp / 16) * (Cs8 / 8);
    wc_n = 32 * nt * (Cdp / 16) * (C8 / 8);
    w = total;
    w_bytes = 8 * (fg_n + ws_n + wc_n);
    staged = total + 2 * w_bytes <= kMaxSmem;
    if (staged) total += 2 * w_bytes;
  }
};

// d[i][j] = Σ_k A[16(m0 + i) + row, k] · W[k, 8(q0 + j) + col] over KS
// k-steps, for i < mc. A: row-major bf16 in shared memory (row stride
// lda, K from column 0), by ldmatrix. W: packed B fragments in global or
// shared memory, NQ n-tiles per k-step (ops/fragments.py pack_fragments),
// one 8-byte load per lane, kPrefetch k-steps ahead of their mma's.
template <int MPT, int NT>
__device__ __forceinline__ void mma_frags(float (&d)[MPT][NT][4], const bf16* A, int lda, int m0,
                                          int mc, const uint2* W, int KS, int NQ, int q0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < MPT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;
  const bf16* a = A + (size_t)(16 * m0 + (lane & 15)) * lda + 8 * (lane >> 4);
  const uint2* w = W + (size_t)q0 * 32 + lane;
  const auto frag = [&](int ks, int j) { return w[((size_t)min(ks, KS - 1) * NQ + j) * 32]; };
  uint2 ring[kPrefetch][NT];
#pragma unroll
  for (int s = 0; s < kPrefetch; ++s)
#pragma unroll
    for (int j = 0; j < NT; ++j) ring[s][j] = frag(s, j);
  for (int ks = 0; ks < KS; ++ks) {
    uint2 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      b[j] = ring[0][j];
#pragma unroll
      for (int s = 0; s + 1 < kPrefetch; ++s) ring[s][j] = ring[s + 1][j];
      ring[kPrefetch - 1][j] = frag(ks + kPrefetch, j);
    }
#pragma unroll
    for (int i = 0; i < MPT; ++i) {
      if (i < mc) {
        uint32_t f[4];
        ldmatrix_x4(f, a + 16 * i * lda + 16 * ks);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(d[i][j], f[0], f[1], f[2], f[3], b[j].x, b[j].y);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) gwnet_stack_kernel_bf16(ParamsB p) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const LayoutB lay(p.N, p.cin, p.C, p.Cd, p.Cs, p.Ce, p.cout, p.S, p.order);
  const int b = blockIdx.x / p.T, t = blockIdx.x % p.T;
  const int N = p.N, C = p.C, Cd = p.Cd, Cs = p.Cs, MT = lay.MT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane % 4;
  bf16* at = reinterpret_cast<bf16*>(base + lay.at);
  bf16* h = reinterpret_cast<bf16*>(base + lay.h);
  bf16* terms = reinterpret_cast<bf16*>(base + lay.terms);
  float* skip = reinterpret_cast<float*>(base + lay.skip);
  bf16* xs = reinterpret_cast<bf16*>(base + lay.x);

  // Weights cold in L2 (evicted by the U-Net's activations in a serving
  // forward) would put an HBM round trip in each phase's chain; all of
  // them are asked for up front instead.
  const int nqc = lay.C8 / 8, nqd = lay.Cd8 / 8, nqs = lay.Cs8 / 8;
  const int ksc = lay.Cp / 16, ksd = lay.Cdp / 16, kst = lay.nt * ksd;
  prefetch_l2(p.start, (size_t)256 * (lay.Cinp / 16) * nqc);
  prefetch_l2(p.wfg, (size_t)8 * p.L * lay.fg_n);
  prefetch_l2(p.ws, (size_t)8 * p.L * lay.ws_n);
  prefetch_l2(p.wc, (size_t)8 * p.L * lay.wc_n);
  prefetch_l2(p.e1, (size_t)256 * (lay.Csp / 16) * (lay.Ce8 / 8));
  prefetch_l2(p.e2, (size_t)256 * (lay.Cep / 16) * (lay.cout8 / 8));
  for (int i = threadIdx.x; i < lay.w / 16; i += blockDim.x)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);  // every pad row and column stays zero
  __syncthreads();

  // layer l's wfg | ws | wc fragments: staged in buffer l % 2, or in L2
  const auto layer_frags = [&](int l) -> const uint2* {
    return lay.staged ? reinterpret_cast<const uint2*>(base + lay.w + (l & 1) * lay.w_bytes)
                      : nullptr;
  };
  const auto stage = [&](int l) {  // cp.async, one commit group
    const uint2* src[3] = {p.wfg + (size_t)l * lay.fg_n, p.ws + (size_t)l * lay.ws_n,
                           p.wc + (size_t)l * lay.wc_n};
    const int n[3] = {lay.fg_n, lay.ws_n, lay.wc_n};
    uint2* dst = const_cast<uint2*>(layer_frags(l));
    for (int a = 0; a < 3; dst += n[a], ++a)
      for (int i = threadIdx.x; i < n[a] / 2; i += blockDim.x) cp_async16(dst + 2 * i, src[a] + 2 * i);
    cp_async_commit();
  };
  if (lay.staged) stage(0);
  // the transposed supports, at[s][w][v] = A_s[v][w], read in order
#pragma unroll 4
  for (int i = threadIdx.x; i < p.S * N * N; i += blockDim.x) {
    const int s = i / (N * N), v = (i / N) % N, w = i % N;
    at[((size_t)s * lay.Np + w) * lay.ld_at + v] = p.sup[i];
  }
  // the start projection's input: row r of position (b, t) is x[b, r, t, :]
  const bf16* x = p.x + ((size_t)b * N * p.T + t) * p.cin;
  const size_t ldx = (size_t)p.T * p.cin;
  if (p.cin % 8 == 0) {
    const int q = p.cin / 8;
    for (int i = threadIdx.x; i < N * q; i += blockDim.x) {
      const int r = i / q, c = 8 * (i % q);
      cp_async16(xs + r * lay.ld_x + c, x + r * ldx + c);
    }
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < N * p.cin; i += blockDim.x) {
      const int r = i / p.cin, c = i % p.cin;
      xs[r * lay.ld_x + c] = x[r * ldx + c];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // start projection: h = x·Ws + bs
  for (int item = warp; item < nqc * MT; item += kWarps) {
    const int q = item % nqc, m = item / nqc, c0 = 8 * q + 2 * tq;
    const float b0 = c0 < C ? to_f(p.start_b[c0]) : 0.f, b1 = c0 < C ? to_f(p.start_b[c0 + 1]) : 0.f;
    float d[1][1][4];
    mma_frags<1, 1>(d, xs, lay.ld_x, m, 1, p.start, lay.Cinp / 16, nqc, q);
    for_pairs(d, m, 1, 8 * q, [&](int r, int c, float v0, float v1) {
      if (r < N && c < C) store2(h + r * lay.ld_h + c, v0 + b0, v1 + b1);
    });
  }
  __syncthreads();
  // the skip sum takes the input rows' bytes; layer 0's first phase does
  // not touch it, and its barrier orders this before the first add
  for (int i = threadIdx.x; i < lay.Np * lay.ld_k / 4; i += blockDim.x)
    reinterpret_cast<float4*>(skip)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int passes = (MT + kPassMT - 1) / kPassMT;
  const int n_skip = nqs * passes, n_diff = p.S * nqd * MT;
  // item (support s, m-tile, n-tile) of diffusion order k: term j =
  // Aᵀ_s · (term 0 at k = 1, else term j − 1)
  const auto diffuse = [&](int item, int k) {
    const int s = item / (nqd * MT), q = item % nqd, m = item / nqd % MT;
    const int j = 1 + s * p.order + k - 1, src = k == 1 ? 0 : j - 1;
    float d[1][1][4];
    mma_diffuse(d, at + (size_t)s * lay.Np * lay.ld_at, lay.ld_at, m, terms + src * lay.Cdp,
                lay.ld_t, 8 * q, MT);
    for_pairs(d, m, 1, 8 * q, [&](int r, int c, float v0, float v1) {
      if (r < N && c < Cd) store2(terms + r * lay.ld_t + j * lay.Cdp + c, v0, v1);
    });
  };

  for (int l = 0; l < p.L; ++l) {
    if (lay.staged && l + 1 < p.L) stage(l + 1);  // its buffer's last readers were layer l − 1's
    const uint2* wfg = lay.staged ? layer_frags(l) : p.wfg + (size_t)l * lay.fg_n;
    const uint2* ws = lay.staged ? wfg + lay.fg_n : p.ws + (size_t)l * lay.ws_n;
    const uint2* wc = lay.staged ? ws + lay.ws_n : p.wc + (size_t)l * lay.wc_n;
    const bf16* bfg = p.bfg + (size_t)l * 2 * Cd;
    const bf16* bs = p.bs + (size_t)l * Cs;
    const float* bc = p.bc + (size_t)l * C;
    const float* aa = p.aa + (size_t)l * C;
    const float* ab = p.ab + (size_t)l * C;

    // 1. filter | gate, the gated unit in registers → term 0
    for (int item = warp; item < nqd * MT; item += kWarps) {
      const int q = item % nqd, m = item / nqd, c = 8 * q + 2 * tq;
      float bias[2][2] = {};  // [filter, gate][column c, c + 1]
      if (c < Cd) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bias[0][e] = to_f(bfg[c + e]);
          bias[1][e] = to_f(bfg[Cd + c + e]);
        }
      }
      float d[1][2][4];
      mma_frags<1, 2>(d, h, lay.ld_h, m, 1, wfg, ksc, 2 * nqd, 2 * q);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * m + lane / 4 + 8 * hh;
        if (r < N && c < Cd) {
          float g[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            g[e] = tanhf(d[0][0][2 * hh + e] + bias[0][e]) * sigmoidf(d[0][1][2 * hh + e] + bias[1][e]);
          store2(terms + r * lay.ld_t + c, g[0], g[1]);
        }
      }
    }
    __syncthreads();

    // 2. skip += g·Wskip + bskip (float32), and the first diffusion order
    // of every support; both read only term 0
    for (int item = warp; item < n_skip + n_diff; item += kWarps) {
      if (item >= n_skip) {
        diffuse(item - n_skip, 1);
        continue;
      }
      const int q = item % nqs, m0 = kPassMT * (item / nqs), mc = min(kPassMT, MT - m0);
      const int c0 = 8 * q + 2 * tq;
      const float b0 = c0 < Cs ? to_f(bs[c0]) : 0.f, b1 = c0 < Cs ? to_f(bs[c0 + 1]) : 0.f;
      float d[kPassMT][1][4];
      mma_frags<kPassMT, 1>(d, terms, lay.ld_t, m0, mc, ws, ksd, nqs, q);
      for_pairs(d, m0, mc, 8 * q, [&](int r, int c, float v0, float v1) {
        if (r < N && c < Cs) {
          float2* sp = reinterpret_cast<float2*>(skip + r * lay.ld_k + c);
          float2 v = *sp;
          v.x += v0 + b0;
          v.y += v1 + b1;
          *sp = v;
        }
      });
    }
    __syncthreads();

    // 3. the further diffusion orders
    for (int k = 2; k <= p.order; ++k) {
      for (int item = warp; item < n_diff; item += kWarps) diffuse(item, k);
      __syncthreads();
    }

    // 4. graph-conv projection + bias + residual, then the folded BatchNorm
    for (int item = warp; item < nqc * MT; item += kWarps) {
      const int q = item % nqc, m = item / nqc, c0 = 8 * q + 2 * tq;
      float ep[3][2] = {};  // bc, aa, ab at columns c0, c0 + 1
      if (c0 < C) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ep[0][e] = bc[c0 + e];
          ep[1][e] = aa[c0 + e];
          ep[2][e] = ab[c0 + e];
        }
      }
      float d[1][1][4];
      mma_frags<1, 1>(d, terms, lay.ld_t, m, 1, wc, kst, nqc, q);
      for_pairs(d, m, 1, 8 * q, [&](int r, int c, float v0, float v1) {
        if (r < N && c < C) {
          __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(h + r * lay.ld_h + c);
          const float2 hv = __bfloat1622float2(*hp);
          *hp = __floats2bfloat162_rn((v0 + ep[0][0] + hv.x) * ep[1][0] + ep[2][0],
                                      (v1 + ep[0][1] + hv.y) * ep[1][1] + ep[2][1]);
        }
      });
    }
    cp_async_wait_all();  // layer l + 1's fragments, for the barrier to publish
    __syncthreads();
  }

  // relu(skip) in bf16, in the bytes of the supports, h and the terms;
  // every element written, pads zero
  bf16* rs = reinterpret_cast<bf16*>(base + lay.r);
  for (int i = threadIdx.x; i < lay.Np * lay.Csp; i += blockDim.x) {
    const int r = i / lay.Csp, c = i % lay.Csp;
    rs[r * lay.ld_r + c] =
        __float2bfloat16_rn(r < N && c < Cs ? fmaxf(skip[r * lay.ld_k + c], 0.f) : 0.f);
  }
  __syncthreads();
  // E1's output takes the skip sum's bytes: zeroed, so its pad columns are
  for (int i = threadIdx.x; i < lay.e_bytes / 16; i += blockDim.x)
    reinterpret_cast<float4*>(base + lay.e)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  bf16* es = reinterpret_cast<bf16*>(base + lay.e);
  const int Ce = p.Ce, cout = p.cout, nq1 = lay.Ce8 / 8, nq2 = lay.cout8 / 8;
  bf16* y = p.y + ((size_t)b * N * p.T + t) * cout;
  const size_t ldy = (size_t)p.T * cout;
  for (int m0 = 0; m0 < MT; m0 += lay.emt) {
    const int mc = min(lay.emt, MT - m0);
    for (int q = warp; q < nq1; q += kWarps) {
      const int c0 = 8 * q + 2 * tq;
      const float b0 = c0 < Ce ? to_f(p.e1b[c0]) : 0.f, b1 = c0 < Ce ? to_f(p.e1b[c0 + 1]) : 0.f;
      float d[kPassMT][1][4];
      mma_frags<kPassMT, 1>(d, rs, lay.ld_r, m0, mc, p.e1, lay.Csp / 16, nq1, q);
      for_pairs(d, m0, mc, 8 * q, [&](int r, int c, float v0, float v1) {
        if (r < N && c < Ce)
          store2(es + (r - 16 * m0) * lay.ld_e + c, fmaxf(v0 + b0, 0.f), fmaxf(v1 + b1, 0.f));
      });
    }
    __syncthreads();
    for (int q = warp; q < nq2; q += kWarps) {
      const int c0 = 8 * q + 2 * tq;
      const float b0 = c0 < cout ? to_f(p.e2b[c0]) : 0.f;
      const float b1 = c0 < cout ? to_f(p.e2b[c0 + 1]) : 0.f;
      float d[kPassMT][1][4];
      mma_frags<kPassMT, 1>(d, es, lay.ld_e, 0, mc, p.e2, lay.Cep / 16, nq2, q);
      for_pairs(d, m0, mc, 8 * q, [&](int r, int c, float v0, float v1) {
        if (r < N && c < cout) store2(y + r * ldy + c, v0 + b0, v1 + b1);
      });
    }
    __syncthreads();  // the next chunk overwrites es
  }
}

int smem_f32(int N, int C, int Cd, int Cs, int Ce, int S, int order) {
  const int nt = S * order + 1;
  const int tmp_n = N * 2 * Cd > kEndRows * Ce ? N * 2 * Cd : kEndRows * Ce;
  return 4 * (N * C + N * nt * Cd + N * Cs + tmp_n + S * N * N);
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, the kernel needs for these sizes: the
// float32 body (is_bf16 = 0) or the bf16 body (is_bf16 = 1).
int gwnet_stack_smem_bytes(int N, int cin, int C, int Cd, int Cs, int Ce, int cout, int S,
                           int order, int is_bf16) {
  return is_bf16 ? LayoutB(N, cin, C, Cd, Cs, Ce, cout, S, order).total
                 : smem_f32(N, C, Cd, Cs, Ce, S, order);
}

// dtype: 0 = float32, 1 = bfloat16. In bfloat16 start_w, wfg, ws, wc, e1w
// and e2w are the packed B fragments (the layouts in the header). One
// block per (b, t). Returns a cudaError_t code.
int gwnet_stack_launch(const void* x, const void* sup, const void* start_w,
                       const void* start_b, const void* wfg, const void* bfg,
                       const void* ws, const void* bs, const void* wc, const void* bc,
                       const void* aa, const void* ab, const void* e1w, const void* e1b,
                       const void* e2w, const void* e2b, void* y, int B, int N, int T,
                       int cin, int C, int Cd, int Cs, int Ce, int cout, int S, int order,
                       int L, int dtype, void* stream) {
  if (B <= 0 || N <= 0 || T <= 0 || cin <= 0 || S <= 0 || order <= 0 || L <= 0 || C % 4 ||
      Cd % 4 || Cs % 4 || Ce % 4 || cout % 4)
    return cudaErrorInvalidValue;
  const auto f = [](const void* v) { return static_cast<const float*>(v); };
  const auto h = [](const void* v) { return static_cast<const bf16*>(v); };
  const auto w = [](const void* v) { return static_cast<const uint2*>(v); };
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    Params p{x, sup, start_w, start_b, wfg, bfg, ws, bs, wc, f(bc), f(aa), f(ab),
             e1w, e1b, e2w, e2b, y, N, T, cin, C, Cd, Cs, Ce, cout, S, order, L};
    const int smem = smem_f32(N, C, Cd, Cs, Ce, S, order);
    err = cudaFuncSetAttribute(gwnet_stack_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    gwnet_stack_kernel<float><<<B * T, kThreads, smem, st>>>(p);
  } else if (dtype == 1) {
    ParamsB p{h(x), h(sup), w(start_w), w(wfg), w(ws), w(wc), w(e1w), w(e2w),
              h(start_b), h(bfg), h(bs), h(e1b), h(e2b), f(bc), f(aa), f(ab),
              static_cast<bf16*>(y), N, T, cin, C, Cd, Cs, Ce, cout, S, order, L};
    const int smem = LayoutB(N, cin, C, Cd, Cs, Ce, cout, S, order).total;
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(gwnet_stack_kernel_bf16,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    gwnet_stack_kernel_bf16<<<B * T, kThreads, smem, st>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
