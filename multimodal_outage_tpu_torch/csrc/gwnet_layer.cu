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
// What bounds it on the card: latency, not FLOPs or bytes. A (b, t)
// position is ~3.2 MFLOP (67×32×64 gate/filter, 67×32×256 skip, S·K
// products of 67×67×32, 67×160×32 diffusion mix) in a chain of four
// dependent products; a B=8 train step's layer is ~0.18 GFLOP and ~2.4 MB,
// under a microsecond at the card's peaks. So the kernel is one wave of
// one block per (b, t) position, and its time is the chain's latency. On
// an H100 (80GB HBM3, 700 W) the bf16 body takes ~0.018 ms of device time
// per call at B = 1, 8 and 16, the same with L2 flushed (launch and
// zeroing ~0.0016 ms of it), where the CUDA-core body took ~0.064 ms; the
// float32 body ~0.07 ms (tools/time_gwnet_layer.py, PERF.md).
//
// Two bodies, chosen by the storage type:
//
// - bfloat16 (training with use_pallas, the gwnet_pallas serving engine):
//   gwnet_layer_kernel_bf16, every product on the tensor cores, mma.sync
//   m16n8k16 with float32 accumulation, in four barrier-separated phases
//   after one staging step:
//     0. x's strided node rows, the row-major weights, the biases and the
//        supports (as one flat run) are copied into shared memory by
//        cp.async, 16-byte chunks where the widths allow, else 8;
//     1. x·[Wf | Wg] with the gated unit in registers → term 0 (g), while
//        the supports are transposed in shared memory;
//     2. s = g·Ws + bs, stored from the accumulators straight to global,
//        together with the first diffusion order of every support (both
//        read only term 0);
//     3. each further order, term j = Aᵀ_s · term j−1, all supports at once;
//     4. h = terms·Wc + bc, stored straight to global.
//   Weights arrive fresh at every training step (models/gwnet.py casts
//   them per layer), so they are staged row-major as they come and read as
//   B fragments by ldmatrix.trans, like the diffusion's term buffer (the
//   stack kernel, gwnet_stack.cu, packs its weights once at engine build
//   instead). [Wf | Wg] is interleaved in blocks of 8 columns while staging
//   (filter n-tile 2q, gate n-tile 2q + 1), so a lane holds a filter column
//   and its gate column in the same slot and computes g in registers. Wc's
//   rows are padded per term to Cd16 = 16⌈Cd/16⌉, to match a term buffer
//   whose terms start at multiples of 16 columns. Node rows are padded to
//   16 (67 → 80, 5 m-tiles), K to 16 and N to 8 with zeros: the block
//   zeroes its shared memory once and every epilogue writes real rows and
//   columns only. That matters for g, whose pad rows would be tanh(bf)·σ(bg)
//   ≠ 0: they are never written, and Aᵀ's pad columns are zero. Row
//   strides are 8 past a multiple of 16 elements, so the 8 rows of an
//   ldmatrix fall in distinct banks (ops/gwnet_layer.py bf16_layout mirrors
//   the layout). 16 warps share each phase's items: an item is one
//   (n-tile pair, m-tile) of the gated unit, one n-tile of Ws over up to
//   kPassMT m-tiles, one (support, n-tile, m-tile) of a diffusion order, or
//   one (n-tile, m-tile) of Wc.
// - float32: gwnet_layer_kernel, the same chain on the CUDA cores
//   (port::matmul), the weights read from L2. TF32 would break the 1e-4
//   float32 bar.
//
// Layouts (row-major): x [B, N, T, C]; supports [S, N, N]; wf, wg [C, Cd];
// ws [Cd, Cs]; wc [(S·K+1)·Cd, C]; biases [cols]; h [B, N, T, C];
// s [B, N, T, Cs]. Everything in the storage type.

#include "block_mma.cuh"
#include "common.cuh"

namespace {

using namespace port;

constexpr int kThreads = 256;

struct Params {
  const void *x, *sup, *wf, *bf, *wg, *bg, *ws, *bs, *wc, *bc;
  void *h, *s;
  int N, T, C, Cd, Cs, S, order;
};

__global__ void __launch_bounds__(kThreads) gwnet_layer_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.x / p.T, t = blockIdx.x % p.T;
  const int N = p.N, C = p.C, Cd = p.Cd, Cs = p.Cs;
  const int ldt = (p.S * p.order + 1) * Cd;
  float* terms = smem;             // [N][ldt], g is term 0
  float* pre = terms + N * ldt;    // [N][2·Cd] filter | gate pre-activations
  float* at = pre + N * 2 * Cd;    // [S][N][N], at[s][w][v] = A_s[v][w]

  const float* sup = static_cast<const float*>(p.sup);
  for (int i = threadIdx.x; i < p.S * N * N; i += blockDim.x) {
    const int s = i / (N * N), w = (i / N) % N, v = i % N;
    at[i] = sup[((size_t)s * N + v) * N + w];
  }

  // filter and gate pre-activations, straight from the strided rows of x
  const size_t row0 = (size_t)b * N * p.T + t, ldx = (size_t)p.T;
  const float* x = static_cast<const float*>(p.x) + row0 * C;
  const float* bf = static_cast<const float*>(p.bf);
  const float* bg = static_cast<const float*>(p.bg);
  matmul<4>(x, p.T * C, static_cast<const float*>(p.wf), Cd, N, C, Cd,
            [&](int r, int c, float a) { pre[r * 2 * Cd + c] = a + bf[c]; });
  matmul<4>(x, p.T * C, static_cast<const float*>(p.wg), Cd, N, C, Cd,
            [&](int r, int c, float a) { pre[r * 2 * Cd + Cd + c] = a + bg[c]; });
  __syncthreads();
  for (int i = threadIdx.x; i < N * Cd; i += blockDim.x) {
    const int r = i / Cd, c = i % Cd;
    const float f = tanhf(pre[r * 2 * Cd + c]);
    terms[r * ldt + c] = f * sigmoidf(pre[r * 2 * Cd + Cd + c]);
  }
  __syncthreads();

  // skip projection, written from registers; it reads only term 0, as the
  // first diffusion product does, so no barrier between them
  const float* bs = static_cast<const float*>(p.bs);
  float* s_out = static_cast<float*>(p.s) + row0 * Cs;
  matmul<4>(terms, ldt, static_cast<const float*>(p.ws), Cs, N, Cd, Cs,
            [&](int r, int c, float a) { s_out[r * ldx * Cs + c] = a + bs[c]; });

  // order-K diffusion over each support: term j = Aᵀ · term (j−1 or 0)
  int j = 1;
  for (int s = 0; s < p.S; ++s) {
    int prev = 0;
    for (int k = 0; k < p.order; ++k, ++j) {
      float* dst = terms + j * Cd;
      matmul<2>(at + (size_t)s * N * N, N, terms + prev * Cd, ldt, N, N, Cd,
                [&](int r, int c, float a) { dst[r * ldt + c] = a; });
      __syncthreads();
      prev = j;
    }
  }

  // graph-conv projection over all terms at once, + bias
  const float* bc = static_cast<const float*>(p.bc);
  float* h_out = static_cast<float*>(p.h) + row0 * C;
  matmul<4>(terms, ldt, static_cast<const float*>(p.wc), C, N, ldt, C,
            [&](int r, int c, float a) { h_out[r * ldx * C + c] = a + bc[c]; });
}

// ---------------------------------------------------------------- bf16

constexpr int kThreadsB = 512;
constexpr int kWarps = kThreadsB / 32;
constexpr int kPassMT = 5;        // m-tiles of a Ws item: the accumulators a lane holds
constexpr int kMaxSmem = 232448;  // dynamic shared memory one block may have

// Shared memory of the bf16 body: byte offsets (16-byte aligned), padded
// widths and row strides in elements, each 8 past a multiple of 16.
// ops/gwnet_layer.py bf16_layout is its mirror.
struct LayoutB {
  int Np, MT, Cp, C8, Cdp, Cd8, Cs8, nt;
  int ld_x, ld_at, ld_t, ld_fg, ld_s, ld_c;
  int x, at, terms, wfg, ws, wc, bias, sup, total;
  __host__ __device__ LayoutB(int N, int C, int Cd, int Cs, int S, int K) {
    Np = round_up(N, 16);
    MT = Np / 16;
    Cp = round_up(C, 16);
    C8 = round_up(C, 8);
    Cdp = round_up(Cd, 16);
    Cd8 = round_up(Cd, 8);
    Cs8 = round_up(Cs, 8);
    nt = S * K + 1;
    ld_x = Cp + 8;                   // x rows [Np][Cp]
    ld_at = Np + 8;                  // Aᵀ [S][Np][Np]
    ld_t = nt * Cdp + 8;             // terms [Np][nt·Cdp], g is term 0
    ld_fg = 2 * Cd8 + 8;             // [Wf | Wg] interleaved [Cp][2·Cd8]
    ld_s = round_up(Cs8, 16) + 8;    // Ws [Cdp][Cs8]
    ld_c = round_up(C8, 16) + 8;     // Wc [nt·Cdp][C8], term j from row j·Cdp
    x = 0;
    at = x + align16(2 * Np * ld_x);
    terms = at + align16(2 * S * Np * ld_at);
    wfg = terms + align16(2 * Np * ld_t);
    ws = wfg + align16(2 * Cp * ld_fg);
    wc = ws + align16(2 * Cdp * ld_s);
    bias = wc + align16(2 * nt * Cdp * ld_c);  // [bf | bg] interleaved, bs, bc
    sup = bias + align16(2 * (2 * Cd8 + Cs8 + C8));  // the supports as they come [S·N·N]
    total = sup + align16(2 * S * N * N);
  }
};

// [Wf | Wg] column of filter (gate = 0) or gate (gate = 1) column c
__device__ __forceinline__ int fg_col(int c, int gate) { return 16 * (c >> 3) + 8 * gate + (c & 7); }

// Copies the rows × cols bf16 matrix at src (row stride lds) into shared
// memory, source (r, c) to dst[rmap(r)·ldd + cmap(c)], by cp.async in
// chunks of 8 columns where the rows are 16-byte multiples and src is
// 16-byte aligned, else of 4 (cols and lds multiples of 4, src 8-byte
// aligned). cmap must keep a chunk contiguous.
template <typename RowMap, typename ColMap>
__device__ __forceinline__ void stage(bf16* dst, int ldd, const bf16* src, size_t lds, int rows,
                                      int cols, RowMap rmap, ColMap cmap) {
  const bool wide = cols % 8 == 0 && lds % 8 == 0 && (reinterpret_cast<size_t>(src) & 15) == 0;
  const int w = wide ? 8 : 4, q = cols / w;
  for (int i = threadIdx.x; i < rows * q; i += blockDim.x) {
    const int r = i / q, c = w * (i % q);
    bf16* d = dst + rmap(r) * ldd + cmap(c);
    const bf16* s = src + r * lds + c;
    if (wide) cp_async16(d, s);
    else cp_async8(d, s);
  }
}

// d[i][j] = Σ_k A[16(m0 + i) + row, k] · B[k, n0 + 8j + col] over KS
// k-steps, for i < mc: A and B row-major bf16 in shared memory, A by
// ldmatrix, B by ldmatrix.trans.
template <int MPT, int NT>
__device__ __forceinline__ void mma_rows(float (&d)[MPT][NT][4], const bf16* A, int lda, int m0,
                                         int mc, const bf16* B, int ldb, int n0, int KS) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < MPT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[i][j][e] = 0.f;
  const bf16* a = A + (size_t)(16 * m0 + (lane & 15)) * lda + 8 * (lane >> 4);
  const bf16* bp = B + (size_t)(lane & 15) * ldb + n0;
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t b[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) ldmatrix_x2_trans(b[j], bp + (size_t)16 * ks * ldb + 8 * j);
#pragma unroll
    for (int i = 0; i < MPT; ++i) {
      if (i < mc) {
        uint32_t f[4];
        ldmatrix_x4(f, a + (size_t)16 * i * lda + 16 * ks);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(d[i][j], f[0], f[1], f[2], f[3], b[j][0], b[j][1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreadsB, 1) gwnet_layer_kernel_bf16(Params p) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const LayoutB lay(p.N, p.C, p.Cd, p.Cs, p.S, p.order);
  const int b = blockIdx.x / p.T, t = blockIdx.x % p.T;
  const int N = p.N, C = p.C, Cd = p.Cd, Cs = p.Cs, MT = lay.MT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane % 4;
  bf16* xs = reinterpret_cast<bf16*>(base + lay.x);
  bf16* at = reinterpret_cast<bf16*>(base + lay.at);
  bf16* terms = reinterpret_cast<bf16*>(base + lay.terms);
  bf16* wfg = reinterpret_cast<bf16*>(base + lay.wfg);
  bf16* ws = reinterpret_cast<bf16*>(base + lay.ws);
  bf16* wc = reinterpret_cast<bf16*>(base + lay.wc);
  bf16* bfg = reinterpret_cast<bf16*>(base + lay.bias);  // [2·Cd8] interleaved
  bf16* bs = bfg + 2 * lay.Cd8;                            // [Cs8]
  bf16* bc = bs + lay.Cs8;                                 // [C8]

  for (int i = threadIdx.x; i < lay.total / 16; i += blockDim.x)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);  // every pad row and column stays zero
  __syncthreads();

  // 0. staging: row r of position (b, t) is x[b, r, t, :]
  const size_t row0 = (size_t)b * N * p.T + t, ldx = (size_t)p.T;
  const auto id = [](int v) { return v; };
  const auto fcol = [](int c) { return fg_col(c, 0); };
  const auto gcol = [](int c) { return fg_col(c, 1); };
  stage(xs, lay.ld_x, static_cast<const bf16*>(p.x) + row0 * C, ldx * C, N, C, id, id);
  stage(wfg, lay.ld_fg, static_cast<const bf16*>(p.wf), Cd, C, Cd, id, fcol);
  stage(wfg, lay.ld_fg, static_cast<const bf16*>(p.wg), Cd, C, Cd, id, gcol);
  stage(ws, lay.ld_s, static_cast<const bf16*>(p.ws), Cs, Cd, Cs, id, id);
  const int Cdp = lay.Cdp;
  stage(wc, lay.ld_c, static_cast<const bf16*>(p.wc), C, lay.nt * Cd, C,
        [&](int r) { return r / Cd * Cdp + r % Cd; }, id);
  stage(bfg, 0, static_cast<const bf16*>(p.bf), Cd, 1, Cd, id, fcol);
  stage(bfg, 0, static_cast<const bf16*>(p.bg), Cd, 1, Cd, id, gcol);
  stage(bs, 0, static_cast<const bf16*>(p.bs), Cs, 1, Cs, id, id);
  stage(bc, 0, static_cast<const bf16*>(p.bc), C, 1, C, id, id);
  // the supports as one flat run (their rows, 2N bytes, are not 16-byte
  // aligned): 16-byte chunks, then the last few elements by plain loads
  bf16* sup = reinterpret_cast<bf16*>(base + lay.sup);
  const int n_sup = p.S * N * N;
  stage(sup, 0, static_cast<const bf16*>(p.sup), n_sup / 8 * 8, 1, n_sup / 8 * 8, id, id);
  for (int i = n_sup / 8 * 8 + threadIdx.x; i < n_sup; i += blockDim.x)
    sup[i] = static_cast<const bf16*>(p.sup)[i];
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // the transposed supports, at[s][w][v] = A_s[v][w], one warp per row of
  // A_s; first read in phase 2, so no barrier of their own
  for (int row = warp; row < p.S * N; row += kWarps) {
    const int s = row / N, v = row % N;
    bf16* dst = at + (size_t)s * lay.Np * lay.ld_at + v;
    for (int w = lane; w < N; w += 32) dst[w * lay.ld_at] = sup[row * N + w];
  }

  // 1. filter | gate, the gated unit in registers → term 0
  const int nqd = lay.Cd8 / 8;
  for (int item = warp; item < nqd * MT; item += kWarps) {
    const int q = item % nqd, m = item / nqd, c = 8 * q + 2 * tq;
    float d[1][2][4];
    mma_rows<1, 2>(d, xs, lay.ld_x, m, 1, wfg, lay.ld_fg, 16 * q, lay.Cp / 16);
    if (c < Cd) {
      const float2 bf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bfg + 16 * q + 2 * tq));
      const float2 bg = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bfg + 16 * q + 8 + 2 * tq));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * m + lane / 4 + 8 * hh;
        if (r < N)
          store2(terms + r * lay.ld_t + c,
                 tanhf(d[0][0][2 * hh] + bf.x) * sigmoidf(d[0][1][2 * hh] + bg.x),
                 tanhf(d[0][0][2 * hh + 1] + bf.y) * sigmoidf(d[0][1][2 * hh + 1] + bg.y));
      }
    }
  }
  __syncthreads();

  // item (support s, n-tile, m-tile) of diffusion order k: term j =
  // Aᵀ_s · (term 0 at k = 1, else term j − 1)
  const auto diffuse = [&](int item, int k) {
    const int s = item / (nqd * MT), q = item % nqd, m = item / nqd % MT;
    const int j = 1 + s * p.order + k - 1, src = k == 1 ? 0 : j - 1;
    float d[1][1][4];
    mma_diffuse(d, at + (size_t)s * lay.Np * lay.ld_at, lay.ld_at, m, terms + src * Cdp,
                lay.ld_t, 8 * q, MT);
    for_pairs(d, m, 1, 8 * q, [&](int r, int c, float v0, float v1) {
      if (r < N && c < Cd) store2(terms + r * lay.ld_t + j * Cdp + c, v0, v1);
    });
  };

  // 2. s = g·Ws + bs to global, and the first diffusion order of every
  // support; both read only term 0
  const int nqs = lay.Cs8 / 8, passes = (MT + kPassMT - 1) / kPassMT;
  const int n_skip = nqs * passes, n_diff = p.S * nqd * MT;
  bf16* s_out = static_cast<bf16*>(p.s) + row0 * Cs;
  for (int item = warp; item < n_skip + n_diff; item += kWarps) {
    if (item >= n_skip) {
      diffuse(item - n_skip, 1);
      continue;
    }
    const int q = item % nqs, m0 = kPassMT * (item / nqs), mc = min(kPassMT, MT - m0);
    const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bs + 8 * q + 2 * tq));
    float d[kPassMT][1][4];
    mma_rows<kPassMT, 1>(d, terms, lay.ld_t, m0, mc, ws, lay.ld_s, 8 * q, Cdp / 16);
    for_pairs(d, m0, mc, 8 * q, [&](int r, int c, float v0, float v1) {
      if (r < N && c < Cs) store2(s_out + r * ldx * Cs + c, v0 + bias.x, v1 + bias.y);
    });
  }
  __syncthreads();

  // 3. the further diffusion orders
  for (int k = 2; k <= p.order; ++k) {
    for (int item = warp; item < n_diff; item += kWarps) diffuse(item, k);
    __syncthreads();
  }

  // 4. graph-conv projection over all terms at once, + bias, rounded once
  const int nqc = lay.C8 / 8;
  bf16* h_out = static_cast<bf16*>(p.h) + row0 * C;
  for (int item = warp; item < nqc * MT; item += kWarps) {
    const int q = item % nqc, m = item / nqc;
    const float2 bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bc + 8 * q + 2 * tq));
    float d[1][1][4];
    mma_rows<1, 1>(d, terms, lay.ld_t, m, 1, wc, lay.ld_c, 8 * q, lay.nt * Cdp / 16);
    for_pairs(d, m, 1, 8 * q, [&](int r, int c, float v0, float v1) {
      if (r < N && c < C) store2(h_out + r * ldx * C + c, v0 + bias.x, v1 + bias.y);
    });
  }
}

int smem_f32(int N, int Cd, int S, int order) {
  return 4 * (N * (S * order + 1) * Cd + N * 2 * Cd + S * N * N);
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, the kernel needs for these sizes: the
// float32 body (is_bf16 = 0) or the bf16 body (is_bf16 = 1).
int gwnet_layer_smem_bytes(int N, int C, int Cd, int Cs, int S, int order, int is_bf16) {
  return is_bf16 ? LayoutB(N, C, Cd, Cs, S, order).total : smem_f32(N, Cd, S, order);
}

// The bf16 body's LayoutB for these sizes, its 23 fields in declaration
// order (Np … nt, ld_x … ld_c, x … total) into out, so that the Python
// mirror can be held to it field by field.
void gwnet_layer_bf16_layout(int N, int C, int Cd, int Cs, int S, int order, int* out) {
  const LayoutB l(N, C, Cd, Cs, S, order);
  const int v[] = {l.Np,  l.MT,    l.Cp,    l.C8,    l.Cdp,   l.Cd8, l.Cs8, l.nt,
                   l.ld_x, l.ld_at, l.ld_t, l.ld_fg, l.ld_s, l.ld_c, l.x,   l.at,
                   l.terms, l.wfg,  l.ws,    l.wc,    l.bias,  l.sup, l.total};
  for (int i = 0; i < 23; ++i) out[i] = v[i];
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
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    const int smem = smem_f32(N, Cd, S, order);
    err = cudaFuncSetAttribute(gwnet_layer_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    gwnet_layer_kernel<<<B * T, kThreads, smem, st>>>(p);
  } else if (dtype == 1) {
    const int smem = LayoutB(N, C, Cd, Cs, S, order).total;
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(gwnet_layer_kernel_bf16,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    gwnet_layer_kernel_bf16<<<B * T, kThreadsB, smem, st>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
