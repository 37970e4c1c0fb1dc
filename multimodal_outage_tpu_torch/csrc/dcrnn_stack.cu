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
// and ~2.4 MB, ~1.2 µs at the bf16 tensor peak; but its 14 steps × L
// cells × (chains, projections, gating) are dependent, so the time is the
// chain's length: how many dependent phases a cell takes and how long each
// lasts. On the H100 a phase of mma.sync work is latency-bound: one warp's
// ldmatrix + 8 dependent mma's take ~135 cycles even alone on an SM, so a
// Chebyshev phase (400 mma's over 10 warps) lasts ~1.7 µs, and each of a
// cell's two cluster barriers and DSMEM exchanges ~1 µs (H100 80GB HBM3,
// 700 W).
//
// Two bodies, chosen by the storage type:
//
// - bfloat16 (serving): one thread-block cluster of C CTAs per sample, on
//   C SMs, every product on the tensor cores (mma.sync m16n8k16, float32
//   accumulation; 67 node rows padded to 80, 5 m-tiles).
//   * Partition: CTA i owns U/(4C) unit quads (4 units each): their r, u
//     and c columns of every cell, and ⌈Dout/4C⌉ quads of the decoder's
//     output columns. A quad is half an mma n-tile (B-fragment lanes 0-15
//     or 16-31), so a CTA's slice of a packed projection (the global
//     fragment order of ops/dcrnn_stack.py stack_fragments) is a set of
//     half tiles: a gate tile pairs an own quad's r and u columns, a
//     candidate tile two own quads.
//   * Each CTA keeps its slices of the cells' projection weights in shared
//     memory for the whole kernel (cp.async'd once, under the prepass;
//     76,800 B at C = 16), as far as the plan fits them; the rest it reads
//     from L2. Each projection onto the few own tiles splits its k-steps
//     over the 16 warps, whose partial sums are added in a fixed order.
//   * The states are whole in every CTA. Each CTA computes the Chebyshev
//     chains of the narrow inputs (h, r⊙h, the layer below's state; of the
//     decoder's previous output, recomputed from h_top in every CTA) itself,
//     a warp to a (support, m-tile, 8 n-tiles), then projects onto its own
//     columns; after the gates it writes its r⊙h columns, after the update
//     its h columns, into every other CTA's shared memory (DSMEM), each
//     followed by a cluster barrier (barrier.cluster arrive/wait): two a
//     cell.
//   * The encoder's layer-0 x part takes no state, so it leaves the chain: a
//     prepass spreads the T × (chunks of 64 input columns) chains and their
//     projections onto all gate and candidate columns over the cluster,
//     into float32 scratch (`part`) that each encoder step adds, chunk by
//     chunk in order, to its accumulators.
//   * C comes from ops/dcrnn_stack.py stack_plan, with the shared-memory
//     layout: among 16, 8, 4, 2, 1 (dividing the U/4 unit quads, the layout
//     fitting one block), the fewest waves of B clusters for what the card
//     runs at once (cudaOccupancyMaxActiveClusters), then the largest C. On
//     the H100 at full width: C = 16 at B = 1 (0.84 ms against one block's
//     2.27), C = 4 at B = 16 (1.37 ms; 16 clusters of 8 took 1.88, two
//     waves of 16 2.45), at 700 W.
// - float32: one block per sample, the same recurrence on the CUDA cores
//   (port::matmul), each term projected as soon as it exists so only the
//   chain's two previous terms are live; TF32 would break the 1e-4 float32
//   bar.
//
// Layouts (row-major): x [B, N, T, Dx0]; supports [S, N, N]; y [B, N,
// horizon, Dout]; biases gb [1, 2U], cb [1, U], proj_b [1, Dout], all in
// the storage type. float32 cells: gx [nt, Dx, 2U], gh [nt, U, 2U], cx
// [nt, Dx, U], ch [nt, U, U] with nt = S·K + 1; proj_w [U, Dout]. bf16
// cells: wx [nt, ⌈Dx/16⌉, (G8 + C8)/8, 32 lanes, 4], the gates' and the
// candidate's x parts side by side (G8 = 8⌈2U/8⌉, C8 = 8⌈U/8⌉); wh [nt,
// ⌈U/16⌉, G8/8, 32, 4]; wr [nt, ⌈U/16⌉, C8/8, 32, 4]; proj [1, ⌈U/16⌉,
// ⌈Dout/8⌉, 32, 4].

#include <cooperative_groups.h>


#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace port;

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 4;
constexpr int kChunk = 64;   // input columns per x-part chain pass
constexpr int kPassMT = 5;   // bf16: m-tiles per pass, the accumulators a lane holds

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

enum Kind { kX = 0, kH = 1, kR = 2 };  // a cell's x part, h part, (r ⊙ h) part

// One packed projection matrix: its fragments in device memory [nt][KS][nq][32 lanes] (uint2),
// and where this CTA keeps its own slice in shared memory
struct Mat {
  const uint2* g;
  int nq;   // packed n-tiles
  int ks;   // nt · KS, the k-steps of all terms
  int res;  // byte offset of the resident slice, or −1: read from device memory
};

struct CellC {
  Mat m[3];  // wx, wh, wr
  const bf16 *gb, *cb;
};

struct ParamsC {
  const bf16 *x, *sup;
  CellC cells[2 * kMaxLayers];
  const uint2* proj;
  const bf16* proj_b;
  bf16* y;
  float* part;  // [B][T][nch][Np][G8 + C8]: the encoder's layer-0 x part, per chunk of x
  int N, T, horizon, L, S, K, Dx0, Dout, U;
  // the plan (ops/dcrnn_stack.py stack_plan): CTAs per sample, row strides and byte offsets
  int C, ld_at, ld_t, ld_acc, o_at, o_states, o_rh, o_terms, o_acc, o_slots, o_bias, o_w;
};

// The 16 lanes' B fragments of a quad (4 columns, half an n-tile): k-index
// i at element i·stride + lane % 16 of a slice in shared memory (byte
// address sa) or in device memory (g); neither: zero.
struct Src {
  const uint2* g;
  uint32_t sa;
  int stride;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The B fragments of two adjacent n-tiles of a row-major 16 (k) × 16 (n)
// bf16 tile in shared memory: lane L passes the address of row L % 16,
// column 8·(L / 16); r[0], r[1] serve n-tile 0, r[2], r[3] n-tile 1.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint2 lds_u2(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

// the same shared-memory address in CTA `rank` of the cluster
template <typename T>
__device__ __forceinline__ T* peer(T* ptr, int rank) {
  return cg::this_cluster().map_shared_rank(ptr, rank);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct Cta {
  const ParamsC& p;
  char* base;
  const bf16* at;
  bf16 *states, *rh, *terms;
  float *acc, *slots;
  int rank, b, N, U, K, Np, MT, Up, G8, C8, nt, ld_t, ld_acc;
  int nQ, nCv, q0;  // unit quads per CTA, candidate n-tiles, first own quad
  int oq0, oq1;     // own output quads

  __device__ Cta(const ParamsC& p_, char* base_)
      : p(p_), base(base_) {
    rank = (int)cg::this_cluster().block_rank();
    b = blockIdx.x / p.C;
    N = p.N; U = p.U; K = p.K;
    Np = round_up(N, 16); MT = Np / 16; Up = round_up(U, 16);
    G8 = round_up(2 * U, 8); C8 = round_up(U, 8);
    nt = p.S * K + 1;
    ld_t = p.ld_t; ld_acc = p.ld_acc;
    at = reinterpret_cast<const bf16*>(base + p.o_at);
    states = reinterpret_cast<bf16*>(base + p.o_states);
    rh = reinterpret_cast<bf16*>(base + p.o_rh);
    terms = reinterpret_cast<bf16*>(base + p.o_terms);
    acc = reinterpret_cast<float*>(base + p.o_acc);
    slots = reinterpret_cast<float*>(base + p.o_slots);
    nQ = U / 4 / p.C; nCv = (nQ + 1) / 2; q0 = rank * nQ;
    const int oq = p.Dout / 4, per = (oq + p.C - 1) / p.C;
    oq0 = min(rank * per, oq); oq1 = min(oq0 + per, oq);
  }

  __device__ bf16* term(int j) const { return terms + (size_t)j * Np * ld_t; }
  __device__ bf16* state(int l) const { return states + (size_t)l * Np * ld_t; }

  // ---- this CTA's slice of a matrix: its own quads, as halves of n-tiles.
  // kX: the gates' r and u quads of each own unit quad (2·nQ halves), then
  // the candidate's (nQ); kH: the gates' (2·nQ); kR: the candidate's (nQ).
  __device__ int halves(int k) const { return k == kX ? 3 * nQ : k == kH ? 2 * nQ : nQ; }

  // packed quad (column / 4) of own half idx
  __device__ int own_quad(int k, int idx) const {
    if (k == kH || (k == kX && idx < 2 * nQ)) return (idx & 1 ? U / 4 : 0) + q0 + (idx >> 1);
    return (k == kX ? G8 / 4 - 2 * nQ : 0) + q0 + idx;
  }

  __device__ Src half_src(const Mat& M, int k, int idx) const {
    if (M.res >= 0) return {nullptr, smem_addr(base + M.res) + (uint32_t)idx * M.ks * 128, 16};
    const int gq = own_quad(k, idx);
    return {M.g + (gq >> 1) * 32 + 16 * (gq & 1), 0u, M.nq * 32};
  }

  // Virtual n-tiles the CTA projects onto: a gate tile holds one own unit
  // quad's r columns (lanes 0-15 of B, accumulator columns 0-3) and u
  // columns (4-7); a candidate tile two own quads, the second absent when
  // nQ is odd. kX: nQ gate tiles then nCv candidate tiles; kH: nQ; kR: nCv.
  __device__ int vtiles(int k) const { return k == kX ? nQ + nCv : k == kH ? nQ : nCv; }

  __device__ Src vtile_src(const Mat& M, int k, int v, int hi) const {
    int idx;
    if (k == kH || (k == kX && v < nQ)) {
      idx = 2 * v + hi;
    } else {
      const int c = 2 * (k == kX ? v - nQ : v) + hi;  // own candidate quad
      if (c >= nQ) return {nullptr, 0u, 0};
      idx = (k == kX ? 2 * nQ : 0) + c;
    }
    return half_src(M, k, idx);
  }

  // starts copying the CTA's slice of M into shared memory, if M is
  // resident: 16-byte cp.async's, waited for by cp.async.wait_all
  __device__ void stage(const Mat& M, int k) const {
    if (M.res < 0) return;
    const uint32_t dst = smem_addr(base + M.res);
    const int n = halves(k) * M.ks * 8;  // 16-byte pieces: 8 to a half's k-step
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int l2 = i % 8, kidx = i / 8 % M.ks, gq = own_quad(k, i / (8 * M.ks));
      const uint2* src = M.g + ((size_t)kidx * M.nq + (gq >> 1)) * 32 + 16 * (gq & 1) + 2 * l2;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst + 16 * i), "l"(src));
    }
  }

  // term 0 ← columns [d0, d0 + w) of the N rows of src (row stride ld),
  // zero from column `valid` on; w % 4 == 0
  __device__ void load_term0(const bf16* src, size_t ld, int d0, int w, int valid) const {
    const int q = w / 4;
    bf16* t0 = term(0);
    for (int i = threadIdx.x; i < N * q; i += blockDim.x) {
      const int r = i / q, c = 4 * (i % q);
      uint2 v = make_uint2(0u, 0u);
      if (d0 + c < valid) v = *reinterpret_cast<const uint2*>(src + r * ld + d0 + c);
      *reinterpret_cast<uint2*>(t0 + r * ld_t + c) = v;
    }
  }

  // Chebyshev terms 1 … nt−1 of t0 (row stride ld_t) over its first w
  // columns (w % 16 == 0) into term(1 …), term 1 + s·K + k − 1 = T_k over
  // support s. Phase k computes T_k of every support: T_1 = A_s·T_0, T_k =
  // 2·A_s·T_{k−1} − T_{k−2}, rounded to bf16 after the product and after the
  // step, as the TPU kernel does. A warp takes one (support, m-tile, 8
  // n-tiles) at a time: one A fragment a k-step serves 8 mma's, so shared
  // memory reads stay well under what the 16 warps' mma's need. Pad rows
  // stay zero: the supports' pad rows and columns are zero. The caller has
  // made t0 visible to the block.
  __device__ void chains(const bf16* t0, int w) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int ng = (w + 63) / 64, items = p.S * MT * ng;
    for (int k = 1; k <= K; ++k) {
      for (int item = warp; item < items; item += kWarps) {
        const int s = item / (MT * ng), m = item / ng % MT, n0 = 64 * (item % ng);
        const int j = s * K + k;
        const bf16* a = at + ((size_t)s * Np + 16 * m + (lane & 15)) * p.ld_at + 8 * (lane >> 4);
        // columns past w: the last 16 again, their sums unused
        const bf16* src[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          src[q] = (k == 1 ? t0 : term(j - 1)) + (lane & 15) * ld_t + min(n0 + 16 * q, w - 16) +
                   8 * (lane >> 4);
        float d[8][4] = {};
        for (int ks = 0; ks < MT; ++ks) {
          uint32_t af[4], bf[4][4];
          ldmatrix_x4(af, a + 16 * ks);
#pragma unroll
          for (int q = 0; q < 4; ++q) ldmatrix_x4_trans(bf[q], src[q] + 16 * ks * ld_t);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            mma_bf16(d[2 * q], af[0], af[1], af[2], af[3], bf[q][0], bf[q][1]);
            mma_bf16(d[2 * q + 1], af[0], af[1], af[2], af[3], bf[q][2], bf[q][3]);
          }
        }
        bf16* dst = term(j);
        const bf16* prev = k == 2 ? t0 : term(j - 2);
        const int row0 = (16 * m + g) * ld_t + n0 + 2 * t;
        float2 pv[8][2];  // T_{k−2}, all loaded before the first store
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            pv[q][hh] = k >= 2 && n0 + 8 * q < w
                            ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                  prev + row0 + 8 * hh * ld_t + 8 * q))
                            : make_float2(0.f, 0.f);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (n0 + 8 * q < w) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              float v0 = d[q][2 * hh], v1 = d[q][2 * hh + 1];
              if (k >= 2) {
                v0 = 2.f * rnd<bf16>(v0) - pv[q][hh].x;
                v1 = 2.f * rnd<bf16>(v1) - pv[q][hh].y;
              }
              *reinterpret_cast<__nv_bfloat162*>(dst + row0 + 8 * hh * ld_t + 8 * q) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // shared-memory address of term j ≥ 1
  __device__ uint32_t term_addr(int j) const { return smem_addr(term(j)); }

  // Σ over nterms terms (term 0 at shared address t0, term j ≥ 1 = term(j),
  // row stride ld_t) × kpt k-steps of each (k-step i at column 16i) × the
  // weights of k-steps ks0 … of each of the matrix's terms (KS k-steps a
  // term), onto nv virtual n-tiles whose fragments srcf(v, lane / 16) gives,
  // from shared memory where SH, else from device memory.
  // epi(v, row, col, s0, s1) takes the float32 sums of columns col, col + 1
  // (col even, < 8) of tile v at row (< Np), once each. A warp item is one
  // tile × MPT m-tiles × a range of k-steps: with MPT = 1 and fewer tiles ×
  // m-tiles than warps, the k-steps split into P ranges whose partial sums
  // meet in `slots` and are added in a fixed order. B fragments are loaded
  // DEPTH k-steps ahead of their mma's; with MPT = 1, two accumulator sets
  // take the k-steps in turn. Ends with the block synchronised.
  template <int MPT, int DEPTH, bool SH, typename SrcF, typename Epi>
  __device__ void project(uint32_t t0, int nterms, int kpt, int KS, int ks0, int nv, SrcF srcf,
                          Epi epi) const {
    constexpr int NA = MPT == 1 ? 2 : 1;
    static_assert(DEPTH % NA == 0, "the accumulator sets take whole turns of the ring");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
    const int total = nterms * kpt, groups = (MT + MPT - 1) / MPT;
    const int P = MPT == 1 ? max(1, min(total, kWarps / (nv * groups))) : 1;
    for (int item = warp; item < nv * groups * P; item += kWarps) {
      const int part = item % P, m0 = MPT * (item / P % groups), v = item / (P * groups);
      const int i0 = part * total / P, i1 = (part + 1) * total / P;
      const Src s = srcf(v, lane >> 4);
      const bool on = SH ? s.sa != 0u : s.g != nullptr;
      uint32_t arow[MPT];  // past MT the last m-tile again, its sums unused
#pragma unroll
      for (int mi = 0; mi < MPT; ++mi)
        arow[mi] = 2 * ((16 * min(m0 + mi, MT - 1) + (lane & 15)) * ld_t + 8 * (lane >> 4));
      // the fragment cursor: element fo, term-relative k-step fk, k-steps left
      int fk = i0 % kpt, left = i1 - i0;
      int fo = ((i0 / kpt) * KS + ks0 + fk) * s.stride + (lane & 15);
      const int jump = (KS - kpt + 1) * s.stride;
      auto next_frag = [&]() {
        uint2 r = make_uint2(0u, 0u);
        if (on && left > 0) r = SH ? lds_u2(s.sa + 8u * fo) : __ldg(s.g + fo);
        --left;
        if (++fk == kpt) fk = 0, fo += jump;
        else fo += s.stride;
        return r;
      };
      uint2 ring[DEPTH];
#pragma unroll
      for (int r = 0; r < DEPTH; ++r) ring[r] = next_frag();
      int aj = i0 / kpt, ak = i0 % kpt;
      uint32_t ab = (aj == 0 ? t0 : term_addr(aj)) + 32 * ak;
      float d[NA][MPT][4] = {};
      for (int i = i0; i < i1; i += DEPTH) {
#pragma unroll
        for (int u = 0; u < DEPTH; ++u) {
          if (i + u >= i1) break;
          const uint2 bb = ring[u];
          ring[u] = next_frag();
          uint32_t f[MPT][4];
#pragma unroll
          for (int mi = 0; mi < MPT; ++mi) ldsm_x4(f[mi], ab + arow[mi]);
#pragma unroll
          for (int mi = 0; mi < MPT; ++mi)
            mma_bf16(d[u % NA][mi], f[mi][0], f[mi][1], f[mi][2], f[mi][3], bb.x, bb.y);
          if (++ak == kpt) ak = 0, ab = term_addr(++aj);
          else ab += 32;
        }
      }
#pragma unroll
      for (int u = 1; u < NA; ++u)
#pragma unroll
        for (int mi = 0; mi < MPT; ++mi)
#pragma unroll
          for (int c = 0; c < 4; ++c) d[0][mi][c] += d[u][mi][c];
      if (P == 1) {
#pragma unroll
        for (int mi = 0; mi < MPT; ++mi)
          if (m0 + mi < MT)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              epi(v, 16 * (m0 + mi) + g + 8 * hh, 2 * tq, d[0][mi][2 * hh], d[0][mi][2 * hh + 1]);
      } else {
        *reinterpret_cast<float4*>(slots + (item * 32 + lane) * 4) =
            make_float4(d[0][0][0], d[0][0][1], d[0][0][2], d[0][0][3]);
      }
    }
    if (P > 1) {
      __syncthreads();
      for (int e = threadIdx.x; e < nv * groups * 64; e += blockDim.x) {
        const int hh = e & 1, ln = (e >> 1) & 31, vm = e >> 6;  // vm = v · MT + m-tile
        float s0 = 0.f, s1 = 0.f;
        for (int q = 0; q < P; ++q) {
          const float2 sl =
              *reinterpret_cast<const float2*>(slots + ((vm * P + q) * 32 + ln) * 4 + 2 * hh);
          s0 += sl.x;
          s1 += sl.y;
        }
        epi(vm / groups, 16 * (vm % groups) + ln / 4 + 8 * hh, 2 * (ln % 4), s0, s1);
      }
    }
    __syncthreads();
  }

  // acc columns 8·(v0 + v) … of own tile v += the sums
  __device__ auto to_acc(int v0) const {
    return [this, v0](int v, int row, int col, float s0, float s1) {
      float2* a = reinterpret_cast<float2*>(acc + row * ld_acc + 8 * (v0 + v) + col);
      float2 o = *a;
      o.x += s0;
      o.y += s1;
      *a = o;
    };
  }

  // Σ_j T_j(t0) · W_j onto the own tiles of kind k, of k-steps ks0 … ks0 +
  // kpt of each term of M
  __device__ void project_own(const bf16* t0, int kpt, int ks0, const Mat& M, int k) const {
    const auto srcf = [&](int v, int hi) { return vtile_src(M, k, v, hi); };
    if (M.res >= 0)
      project<1, 2, true>(smem_addr(t0), nt, kpt, M.ks / nt, ks0, vtiles(k), srcf,
                          to_acc(k == kR ? nQ : 0));
    else
      project<1, 4, false>(smem_addr(t0), nt, kpt, M.ks / nt, ks0, vtiles(k), srcf,
                           to_acc(k == kR ? nQ : 0));
  }

  // y_t, packed output tiles [tile0, tile0 + ntiles): rnd(h_top · P + pb),
  // to dst (row stride ld_t, zero past Dout and in pad rows) if given, and
  // the CTA's own output columns to y
  __device__ void outputs(int t, int tile0, int ntiles, bf16* dst) const {
    const int nqo = (p.Dout + 7) / 8, k16 = Up / 16;
    const size_t ldy = (size_t)p.horizon * p.Dout;
    bf16* yt = p.y + ((size_t)b * N * p.horizon + t) * p.Dout;
    const int c0 = 4 * oq0, c1 = 4 * oq1;
    project<kPassMT, 4, false>(
        smem_addr(state(p.L - 1)), 1, k16, k16, 0, ntiles,
        [&](int v, int hi) {
          return tile0 + v < nqo ? Src{p.proj + (tile0 + v) * 32 + 16 * hi, 0u, nqo * 32}
                                 : Src{nullptr, 0u, 0};
        },
        [&](int v, int row, int col, float s0, float s1) {
          const int c = 8 * (tile0 + v) + col;  // c < Dout ⇔ c + 1 < Dout (Dout % 4 == 0)
          __nv_bfloat162 o = __floats2bfloat162_rn(0.f, 0.f);
          if (c < p.Dout && row < N)
            o = __floats2bfloat162_rn(s0 + to_f(p.proj_b[c]), s1 + to_f(p.proj_b[c + 1]));
          if (dst != nullptr)
            *reinterpret_cast<__nv_bfloat162*>(dst + row * ld_t + 8 * v + col) = o;
          if (c >= c0 && c < c1 && row < N)
            *reinterpret_cast<__nv_bfloat162*>(yt + row * ldy + c) = o;
        });
  }

  // The encoder's layer-0 x part, which no state enters, for all T steps at
  // once: the cluster's CTAs take the (step, chunk of kChunk input columns)
  // items in turn, each the chains of that chunk and their projection onto
  // every gate and candidate column, stored in p.part.
  __device__ void prepass() const {
    const Mat& M = p.cells[0].m[kX];
    const int dxp = round_up(p.Dx0, 16), nch = (dxp + kChunk - 1) / kChunk, ncol = G8 + C8;
    const bf16* x = p.x + (size_t)b * N * p.T * p.Dx0;
    for (int it = rank; it < p.T * nch; it += p.C) {
      const int t = it / nch, ch = it % nch, d0 = ch * kChunk, wd = min(kChunk, dxp - d0);
      load_term0(x + (size_t)t * p.Dx0, (size_t)p.T * p.Dx0, d0, wd, p.Dx0);
      __syncthreads();
      chains(term(0), wd);
      float* out = p.part + ((size_t)(b * p.T + t) * nch + ch) * Np * ncol;
      project<kPassMT, 4, false>(
          smem_addr(term(0)), nt, wd / 16, dxp / 16, d0 / 16, ncol / 8,
          [&](int v, int hi) { return Src{M.g + v * 32 + 16 * hi, 0u, M.nq * 32}; },
          [&](int v, int row, int col, float s0, float s1) {
            *reinterpret_cast<float2*>(out + row * ncol + 8 * v + col) = make_float2(s0, s1);
          });
    }
  }

  // Copies the own unit columns of the N rows of v (row stride ld_t) to the
  // same place in every other CTA of the cluster, then waits at the
  // cluster barrier, after which v is whole in every CTA.
  __device__ void broadcast(bf16* v) const {
    __syncthreads();
    const int n = N * nQ;
    for (int i = threadIdx.x; i < (p.C - 1) * n; i += blockDim.x) {
      const int q = (rank + 1 + i / n) % p.C, r = i % n / nQ, col = 4 * (q0 + i % nQ);
      uint2* src = reinterpret_cast<uint2*>(v + r * ld_t + col);
      *peer(src, q) = *src;
    }
    cg::this_cluster().sync();
  }

  // One DCGRU cell of layer l on the CTA's units; the state of layer l is
  // whole in every CTA of the cluster. x part: xk 0 none (the GO symbol),
  // 1 the prepass's sums for encoder step t, 2 the state of layer l − 1,
  // 3 the decoder's output of step t − 1.
  __device__ void cell(int ci, int l, int xk, int t) const {
    const CellC& w = p.cells[ci];
    const int gq = 8 * nQ, cq = gq + 4 * nQ;  // acc: gate tiles | candidate quads | pad
    const int dxp = round_up(p.Dout, 16), nch = (round_up(p.Dx0, 16) + kChunk - 1) / kChunk;
    const float* bias = reinterpret_cast<const float*>(base + p.o_bias) + ci * (G8 + C8);
    for (int i = threadIdx.x; i < Np * cq; i += blockDim.x) {
      const int row = i / cq, c = i % cq;
      // column in the packed gates | candidate layout
      const int pc = c < gq ? (c & 4 ? U : 0) + 4 * (q0 + c / 8) + c % 4 : G8 + 4 * q0 + c - gq;
      float v = bias[pc];
      if (xk == 1) {
        const float* s = p.part + ((size_t)(b * p.T + t) * nch * Np + row) * (G8 + C8) + pc;
        float x[8];
#pragma unroll
        for (int ch = 0; ch < 8; ++ch) x[ch] = ch < nch ? __ldcg(s + (size_t)ch * Np * (G8 + C8)) : 0.f;
        for (int ch = 0; ch < nch; ++ch) v += ch < 8 ? x[ch] : __ldcg(s + (size_t)ch * Np * (G8 + C8));
      }
      acc[row * ld_acc + c] = v;
    }
    __syncthreads();

    // x part of the gates and the candidate: one set of chains for both
    if (xk == 2) {
      chains(state(l - 1), Up);
      project_own(state(l - 1), Up / 16, 0, w.m[kX], kX);
    }
    for (int d0 = 0; xk == 3 && d0 < dxp; d0 += kChunk) {
      const int wd = min(kChunk, dxp - d0);
      outputs(t - 1, d0 / 8, wd / 8, term(0));
      chains(term(0), wd);
      project_own(term(0), wd / 16, d0 / 16, w.m[kX], kX);
    }

    // h part of the gates
    bf16* h = state(l);
    chains(h, Up);
    project_own(h, Up / 16, 0, w.m[kH], kH);

    // σ; r ⊙ h of the own units into rh, then to every other CTA's
    for (int i = threadIdx.x; i < N * nQ; i += blockDim.x) {
      const int r = i / nQ, v = i % nQ, col = 4 * (q0 + v);
      float* a = acc + r * ld_acc + 8 * v;
      float hv[4];
      load4(h + r * ld_t + col, hv);
      __nv_bfloat162 o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float r0 = sigmoidf(a[2 * e]), r1 = sigmoidf(a[2 * e + 1]);
        a[4 + 2 * e] = sigmoidf(a[4 + 2 * e]);
        a[5 + 2 * e] = sigmoidf(a[5 + 2 * e]);
        o[e] = __floats2bfloat162_rn(rnd<bf16>(r0) * hv[2 * e], rnd<bf16>(r1) * hv[2 * e + 1]);
      }
      *reinterpret_cast<uint2*>(rh + r * ld_t + col) = make_uint2(bits(o[0]), bits(o[1]));
    }
    broadcast(rh);

    // (r ⊙ h) part of the candidate
    chains(rh, Up);
    project_own(rh, Up / 16, 0, w.m[kR], kR);

    // the own units' new state, in place, then to every other CTA
    for (int i = threadIdx.x; i < N * nQ; i += blockDim.x) {
      const int r = i / nQ, v = i % nQ, col = 4 * (q0 + v);
      const float* a = acc + r * ld_acc;
      float hv[4];
      load4(h + r * ld_t + col, hv);
      __nv_bfloat162 o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float n2[2];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int x = 2 * e + f;
          const float u = a[8 * v + 4 + x];
          n2[f] = u * hv[x] + (1.f - u) * tanhf(a[gq + 4 * v + x]);
        }
        o[e] = __floats2bfloat162_rn(n2[0], n2[1]);
      }
      *reinterpret_cast<uint2*>(h + r * ld_t + col) = make_uint2(bits(o[0]), bits(o[1]));
    }
    broadcast(h);
  }
};

// One cluster of p.C CTAs per sample; see the header.
__global__ void __launch_bounds__(kThreads)
    dcrnn_stack_kernel_bf16(const __grid_constant__ ParamsC p) {
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  for (int i = threadIdx.x; i < p.o_w / 16; i += blockDim.x)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);  // every pad row and column stays zero
  __syncthreads();
  const Cta cta(p, base);
  const int N = p.N, L = p.L, Np = cta.Np;
  bf16* at = reinterpret_cast<bf16*>(base + p.o_at);
  for (int i = threadIdx.x; i < p.S * N * N; i += blockDim.x) {
    const int s = i / (N * N), w = (i / N) % N, v = i % N;
    at[((size_t)s * Np + w) * p.ld_at + v] = p.sup[((size_t)s * N + v) * N + w];
  }
  float* bias = reinterpret_cast<float*>(base + p.o_bias);
  const int ncol = cta.G8 + cta.C8;
  for (int i = threadIdx.x; i < 2 * L * ncol; i += blockDim.x) {
    const int c = i / ncol, pc = i % ncol;
    const CellC& w = p.cells[c];
    bias[i] = pc < 2 * p.U ? to_f(w.gb[pc]) : pc >= cta.G8 && pc < cta.G8 + p.U ? to_f(w.cb[pc - cta.G8]) : 0.f;
  }
  for (int c = 0; c < 2 * L; ++c)
    for (int k = 0; k < 3; ++k) cta.stage(p.cells[c].m[k], k);
  cg::this_cluster().sync();  // every CTA has started and zeroed what its peers write into
  cta.prepass();               // while the weight slices arrive
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  cg::this_cluster().sync();  // the prepass's sums and the weight slices are visible

  for (int t = 0; t < p.T; ++t)
    for (int l = 0; l < L; ++l) cta.cell(l, l, l == 0 ? 1 : 2, t);
  for (int t = 0; t < p.horizon; ++t)
    for (int l = 0; l < L; ++l) cta.cell(L + l, l, l > 0 ? 2 : t > 0 ? 3 : 0, t);
  if (cta.oq1 > cta.oq0)
    cta.outputs(p.horizon - 1, cta.oq0 / 2, (cta.oq1 - 1) / 2 - cta.oq0 / 2 + 1, nullptr);
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

cudaError_t set_bf16_attributes(int smem) {
  cudaError_t err = cudaFuncSetAttribute(dcrnn_stack_kernel_bf16,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dcrnn_stack_kernel_bf16,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return err;
}

cudaLaunchConfig_t cluster_config(int blocks, int C, int smem, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool bad_dims(int B, int N, int T, int horizon, int L, int S, int K, int Dx0, int Dout, int U) {
  return B <= 0 || N <= 0 || T <= 0 || horizon <= 0 || L <= 0 || L > kMaxLayers || S <= 0 ||
         K <= 0 || Dx0 % 4 || Dout % 4 || U % 4 || Dx0 <= 0 || Dout <= 0 || U <= 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory, in bytes, the float32 body needs for these sizes
// (the bf16 body's comes from its plan).
int dcrnn_stack_smem_bytes_f32(int N, int U, int L, int S) {
  return Layout(N, U, L, S, 4).total;
}

// How many clusters of C CTAs with smem bytes of shared memory each the
// card can run at once (cudaOccupancyMaxActiveClusters) into *out.
// Returns a cudaError_t code.
int dcrnn_stack_max_clusters(int C, int smem, int* out) {
  cudaError_t err = set_bf16_attributes(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(C, C, smem, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(out, (void*)dcrnn_stack_kernel_bf16, &cfg);
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
// cells first, the weights in fragment order; proj likewise. part: float32
// scratch of B·T·nch·Np·(G8 + C8) values. plan: C, ld_at, ld_t, ld_acc and
// the byte offsets at, states, rh, terms, acc, slots, bias, weights, total, then
// per cell the resident slices' offsets of wx, wh, wr (−1: not resident),
// as ops/dcrnn_stack.py stack_plan lays them out. B·C CTAs in clusters of
// C. Returns a cudaError_t code.
int dcrnn_stack_launch_bf16(const void* x, const void* sup, const void* const* cells,
                            const void* proj, const void* proj_b, void* y, void* part, int B,
                            int N, int T, int horizon, int L, int S, int K, int Dx0, int Dout,
                            int U, const int* plan, void* stream) {
  if (bad_dims(B, N, T, horizon, L, S, K, Dx0, Dout, U)) return cudaErrorInvalidValue;
  const int C = plan[0];
  if (C <= 0 || (U / 4) % C) return cudaErrorInvalidValue;
  ParamsC p{};
  p.x = static_cast<const bf16*>(x);
  p.sup = static_cast<const bf16*>(sup);
  const int nt = S * K + 1, G8 = round_up(2 * U, 8), C8 = round_up(U, 8), k16 = round_up(U, 16) / 16;
  for (int c = 0; c < 2 * L; ++c) {
    const void* const* w = cells + 5 * c;
    const int dx = c % L ? U : c ? Dout : Dx0;
    const int* res = plan + 13 + 3 * c;
    p.cells[c].m[kX] = Mat{static_cast<const uint2*>(w[0]), (G8 + C8) / 8,
                           nt * round_up(dx, 16) / 16, res[0]};
    p.cells[c].m[kH] = Mat{static_cast<const uint2*>(w[1]), G8 / 8, nt * k16, res[1]};
    p.cells[c].m[kR] = Mat{static_cast<const uint2*>(w[2]), C8 / 8, nt * k16, res[2]};
    p.cells[c].gb = static_cast<const bf16*>(w[3]);
    p.cells[c].cb = static_cast<const bf16*>(w[4]);
  }
  p.proj = static_cast<const uint2*>(proj);
  p.proj_b = static_cast<const bf16*>(proj_b);
  p.y = static_cast<bf16*>(y);
  p.part = static_cast<float*>(part);
  p.N = N; p.T = T; p.horizon = horizon; p.L = L; p.S = S; p.K = K;
  p.Dx0 = Dx0; p.Dout = Dout; p.U = U;
  p.C = C; p.ld_at = plan[1]; p.ld_t = plan[2]; p.ld_acc = plan[3];
  p.o_at = plan[4]; p.o_states = plan[5]; p.o_rh = plan[6]; p.o_terms = plan[7];
  p.o_acc = plan[8]; p.o_slots = plan[9]; p.o_bias = plan[10]; p.o_w = plan[11];
  const int smem = plan[12];
  cudaError_t err = set_bf16_attributes(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(B * C, C, smem, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, dcrnn_stack_kernel_bf16, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
