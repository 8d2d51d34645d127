// Full-sequence self-attention backward (kernel K3b): two kernels, dK/dV and dQ.
//
// Replaces the custom VJP of the bundled Pallas flash attention that
// audiocraft_tpu/ops/attention_pallas.py:fused_attention differentiates on
// the TPU: _flash_attention_bwd_dkv and _flash_attention_bwd_dq of
// jax/experimental/pallas/ops/tpu/flash_attention.py, one pallas_call each.
// For q, k, v, dO in [B, T, H, D] (the JAX package's layout, read by
// strides), the forward's fp32 lse = m + log(l) and di = rowsum(dO * O), both
// [B, H, T] fp32, every tile recomputes
//     s  = round(q * scale) . k^T      (fp32, q * scale rounded to the input
//                                       dtype, as the forward kernel does)
//     P  = exp(s - lse)
//     dV = P^T dO                       dP = dO V^T
//     dS = P * (dP - di)
//     dQ = scale * dS K                 dK = dS^T round(q * scale)
// so the [T, T] probabilities never reach device memory.  dK uses the same
// rounded q * scale as s: that is the derivative of what the forward and the
// plain version compute, and equals scale * dS^T q up to that rounding.
// Keys at index >= T and, when causal, keys after the query are masked (P is
// 0 there); queries at index >= T contribute nothing; nothing is padded.
// Tiles wholly above the diagonal are skipped, as the Pallas kernel's
// below_or_on_diag does.  Gradients are written in the input dtype.  The two
// kernels share no state and use no atomics, so the result is deterministic,
// as the two pallas_calls are.
//
// Bound on an H100: five products of 2*B*H*T^2*D operations, halved when
// causal (46 GFLOP at the training shape B = 4, H = 16, T = 1501, D = 64),
// against about 87 MB of q, k, v, dO, dq, dk, dv in bf16, so the operations
// set the bound: 0.047 ms for the five products at the bf16 tensor-core rate,
// 0.065 ms for the seven that the two kernels run (s and dP are recomputed in
// both).
//
// bf16 (the training path) runs on the tensor cores.  The first version ran
// fp32 FMA for both dtypes: 1.713 + 1.373 = 3.086 ms at the shape above on an
// NVIDIA H100 80GB HBM3 at 700 W, against 0.238 ms for SDPA's backward.  It
// was held to the fp32 rate (a 0.96 ms ceiling for the 7 products), issued one
// shared-memory load per two FMAs, sent P and dS through shared memory with
// three barriers a tile, loaded element by element with nothing in flight
// during the products, and launched the longest causal blocks last.  Now
// (0.18 + 0.13 ms on the same card, chip_smoke.py phase 2):
// - Products: mma.sync m16n8k16 bf16 with fp32 accumulators.  mma.sync and
//   not wgmma, because each accumulator fragment of s and dP becomes the A
//   fragment of the next product in registers (as K3f's P.V does), and
//   ldmatrix gives both B layouts from one tile; wgmma wants 64-row warpgroup
//   tiles and swizzled shared-memory operands, with TMA and a producer warp,
//   and is left for a later PR, as is a persistent grid.
// - dK/dV: a block of WARPS warps owns 16 * WARPS keys of one (batch, head).
//   Warp w keeps the K and V A-fragments of its 16 keys in registers for the
//   whole loop, and its dK, dV sums (16 x D fp32).  Query tiles of 64 rows
//   (q, dO, lse, di) stream through a two-stage ring of cp.async copies.  For
//   each 16 queries, S^T = K qs^T and dP^T = V dO^T take their B fragments
//   from the rows of the qs and dO tiles (ldmatrix); P^T and dS^T are formed
//   on the accumulator fragments and feed dV += P^T dO and dK += dS^T qs as A
//   fragments, whose B fragments come from the same tiles by ldmatrix.trans.
// - dQ: a block of WARPS warps owns 16 * WARPS queries; warp w keeps the qs
//   and dO A-fragments of its 16 rows and their lse and di; 64-row tiles of K
//   and V stream through the ring.  For each 16 keys, S = qs K^T and
//   dP = dO V^T (ldmatrix), dS in registers, dQ += dS K (ldmatrix.trans).
// - WARPS is fixed per kernel by timing 4 against 8 at the training shape
//   (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3 at 700 W; PERF.md, PR 5):
//   4 for dK/dV (168 registers a thread at D = 64, 37,888 B shared, 3 blocks
//   an SM; 8 warps fit one block an SM and ran 12 % slower), 8 for dQ (128
//   registers, 73,728 B shared, 2 blocks an SM; 2 % faster than 4).
// - q * scale is rounded to bf16 in shared memory by the thread that copied
//   each 16-byte piece, once its copy has landed and before the barrier that
//   hands the tile to the other warps.
// - Tile rows are padded to D + 8 bf16, so the eight 16-byte rows that one
//   ldmatrix phase reads fall in distinct banks, in both forms.  When the
//   block's own tile has 64 rows, the ring stage that is free at the start
//   holds it (K and V, or q and dO) until its fragments are in registers.
// - P and dS are rounded once to bf16 to enter the tensor cores (SDPA's
//   backward does the same); the plain version rounds them at the same points
//   for bf16 inputs.
// - Causal: besides the tiles above the diagonal, the 16-row chunks of the
//   diagonal tiles that are wholly masked are skipped; the grid runs
//   (tile, batch * head) with batch * head fastest and the longest tiles
//   first, so the causal tail is short.
// - 16-byte copies need D a multiple of 8 and rows that start on 16 bytes;
//   the wrapper (ops/attention.py) copies a view that does not.
// Left for later: wgmma with TMA and a producer warp, a deeper ring, and a
// persistent grid; D = 128 spills a few registers at 4 warps (no model here
// uses it).
// fp32 (the parity path, held to 1e-4 of the plain version, which TF32 would
// break) keeps the FMA kernels: 256 threads, thread (ty, tx) owns rows
// 4 ty .. 4 ty + 3 of its tile, columns tx + 16 j of the streamed tile and
// features tx + 16 c; P and dS go through shared memory.
#include <math.h>

#include "attention_common.cuh"

namespace {

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;  // [B, H, T]
  void *dq, *dk, *dv;     // contiguous [B, T, H, D]
  int batch, seq, heads, dim;
  Strides qs, ks, vs, dos;
  float scale;
  int causal;
  cudaStream_t stream;
};

// ================================================================ bf16, mma.sync

constexpr int kStages = 2;  // depth of the cp.async ring
constexpr int kWarpsDkv = 4;  // warps per dK/dV block, 16 keys each
constexpr int kWarpsDq = 8;   // warps per dQ block, 16 queries each

// Shared memory of a bf16 kernel whose block owns 16 * WARPS rows: a ring of
// kStages stages, each two streamed 64-row tiles (qs and dO, or K and V),
// then the block's own two tiles unless they fit in the last stage (64 rows),
// where they wait until their fragments are in registers; then, for dK/dV,
// lse and di of each stage.
template <int DP, int WARPS>
__host__ __device__ constexpr int own_elems() {
  return 16 * WARPS == kRows ? 0 : 2 * 16 * WARPS * (DP + 8);
}

template <int DP, int WARPS>
constexpr size_t smem_bf16(bool dkv) {
  return sizeof(bf16) * (2 * kStages * tile_elems<DP>() + own_elems<DP, WARPS>()) +
         (dkv ? sizeof(float) * 2 * kStages * kRows : 0);
}

// ---------------------------------------------------------------- dK, dV (bf16)

template <int DP, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, Strides qs_, Strides ks_,
                          Strides vs_, Strides dos_, int batch, int seq, int heads, int dim,
                          float scale, int causal) {
  constexpr int LD = DP + 8, KS = DP / 16, NT = DP / 8, ROWS = 16 * WARPS, THREADS = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);  // stage s: qs at 2s, dO at 2s + 1
  auto qs_at = [&](int s) { return tiles + 2 * s * tile_elems<DP>(); };
  auto do_at = [&](int s) { return tiles + (2 * s + 1) * tile_elems<DP>(); };
  bf16* own_k = ROWS == kRows ? qs_at(kStages - 1) : qs_at(kStages);
  bf16* own_v = own_k + ROWS * LD;
  float* stats = reinterpret_cast<float*>(qs_at(kStages) + own_elems<DP, WARPS>());
  auto lse_at = [&](int s) { return stats + 2 * s * kRows; };
  auto di_at = [&](int s) { return stats + (2 * s + 1) * kRows; };

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, g = lane / 4, tig = lane % 4;
  const Lanes L(lane);
  const int bh = blockIdx.x % (batch * heads), tile = blockIdx.x / (batch * heads);
  const int b = bh / heads, h = bh % heads;
  const int k0 = tile * ROWS;  // key tile 0, the longest when causal, runs first
  const int n_tiles = (seq + kRows - 1) / kRows;
  const int first = causal ? k0 / kRows : 0;  // query tiles before the diagonal see nothing
  const int count = n_tiles - first;
  const bf16* qb = q + b * qs_.b + h * qs_.h;
  const bf16* dob = dout + b * dos_.b + h * dos_.h;
  const float* lse_b = lse + ((size_t)b * heads + h) * seq;
  const float* di_b = di + ((size_t)b * heads + h) * seq;

  auto load_queries = [&](int s, int i) {  // query tile first + i into stage s
    const int q0 = (first + i) * kRows;
    load_tile<DP, kRows, THREADS>(qs_at(s), qb, qs_.t, q0, seq, dim);
    load_tile<DP, kRows, THREADS>(do_at(s), dob, dos_.t, q0, seq, dim);
    if (tid < 2 * kRows) {
      const int r = tid % kRows, t = q0 + r;
      const float* src = tid < kRows ? lse_b : di_b;
      cp_async4((tid < kRows ? lse_at(s) : di_at(s)) + r, t < seq ? src + t : src, t < seq);
    }
  };

  load_tile<DP, ROWS, THREADS>(own_k, k + b * ks_.b + h * ks_.h, ks_.t, k0, seq, dim);
  load_tile<DP, ROWS, THREADS>(own_v, v + b * vs_.b + h * vs_.h, vs_.t, k0, seq, dim);
  cp_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < count) load_queries(s, s);
    cp_commit();
  }
  cp_wait<kStages - 1>();
  __syncthreads();
  uint32_t ka[KS][4], va[KS][4];  // A fragments of the warp's 16 keys
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldsm(ka[kk], own_k + (16 * w + L.ra) * LD + 16 * kk + L.ca);
    ldsm(va[kk], own_v + (16 * w + L.ra) * LD + 16 * kk + L.ca);
  }

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int i = 0; i < count; ++i) {
    const int s = i % kStages;
    cp_wait<kStages - 2>();
    scale_tile<DP, kRows, THREADS>(qs_at(s), scale);
    __syncthreads();  // tile i is in; every warp is done with the stage refilled next
    if (i + kStages - 1 < count) load_queries((i + kStages - 1) % kStages, i + kStages - 1);
    cp_commit();

    const int q0 = (first + i) * kRows;
    const bool diag = causal && q0 < k0 + ROWS;  // the tile crosses the diagonal
    const bool edge = diag || q0 + kRows > seq;
    const bf16* qt = qs_at(s);
    const bf16* dt = do_at(s);
    const float* lse_s = lse_at(s);
    const float* di_s = di_at(s);
#pragma unroll
    for (int c = 0; c < kRows / 16; ++c) {  // 16 queries at a time
      // every key of the warp after these queries: nothing to add
      if (diag && k0 + 16 * w > q0 + 16 * c + 15) continue;
      float st[2][4] = {}, dpt[2][4] = {};  // S^T, dP^T: [key][query]
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t f[4];
        ldsm(f, qt + (16 * c + L.rb) * LD + 16 * kk + L.cb);
        mma(st[0], ka[kk], f[0], f[1]);
        mma(st[1], ka[kk], f[2], f[3]);
        ldsm(f, dt + (16 * c + L.rb) * LD + 16 * kk + L.cb);
        mma(dpt[0], va[kk], f[0], f[1]);
        mma(dpt[1], va[kk], f[2], f[3]);
      }
      uint32_t pa[4], dsa[4];  // P^T and dS^T as A fragments: depth = query
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = 16 * c + 8 * j + 2 * tig;  // query of elements 0 and 2; +1 for 1 and 3
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + r);
        const float2 d2 = *reinterpret_cast<const float2*>(di_s + r);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = exp2f((st[j][e] - (e & 1 ? l2.y : l2.x)) * kLog2e);
          if (edge) {
            const int query = q0 + r + (e & 1), key = k0 + 16 * w + g + 8 * (e >> 1);
            if (query >= seq || (causal && key > query)) x = 0.f;
          }
          p[e] = x;
          ds[e] = x * (dpt[j][e] - (e & 1 ? d2.y : d2.x));
        }
        pa[2 * j] = pack(p[0], p[1]);
        pa[2 * j + 1] = pack(p[2], p[3]);
        dsa[2 * j] = pack(ds[0], ds[1]);
        dsa[2 * j + 1] = pack(ds[2], ds[3]);
      }
#pragma unroll
      for (int n = 0; n < NT / 2; ++n) {  // 16 features at a time
        uint32_t f[4];
        ldsm_t(f, dt + (16 * c + L.ra) * LD + 16 * n + L.ca);
        mma(dv_acc[2 * n], pa, f[0], f[1]);
        mma(dv_acc[2 * n + 1], pa, f[2], f[3]);
        ldsm_t(f, qt + (16 * c + L.ra) * LD + 16 * n + L.ca);
        mma(dk_acc[2 * n], dsa, f[0], f[1]);
        mma(dk_acc[2 * n + 1], dsa, f[2], f[3]);
      }
    }
  }
  cp_wait<0>();

  store_rows<DP>(dk, dk_acc, k0 + 16 * w, g, tig, b, h, seq, heads, dim, 1.f);
  store_rows<DP>(dv, dv_acc, k0 + 16 * w, g, tig, b, h, seq, heads, dim, 1.f);
}

// ---------------------------------------------------------------- dQ (bf16)

template <int DP, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         bf16* __restrict__ dq, Strides qs_, Strides ks_, Strides vs_,
                         Strides dos_, int batch, int seq, int heads, int dim, float scale,
                         int causal) {
  constexpr int LD = DP + 8, KS = DP / 16, NT = DP / 8, ROWS = 16 * WARPS, THREADS = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);  // stage s: K at 2s, V at 2s + 1
  auto k_at = [&](int s) { return tiles + 2 * s * tile_elems<DP>(); };
  auto v_at = [&](int s) { return tiles + (2 * s + 1) * tile_elems<DP>(); };
  bf16* own_q = ROWS == kRows ? k_at(kStages - 1) : k_at(kStages);
  bf16* own_do = own_q + ROWS * LD;

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, g = lane / 4, tig = lane % 4;
  const Lanes L(lane);
  const int bh = blockIdx.x % (batch * heads), rank = blockIdx.x / (batch * heads);
  const int b = bh / heads, h = bh % heads;
  const int n_tiles = (seq + kRows - 1) / kRows;
  // causal: the last query tile, which sees every key tile, runs first
  const int q0 = (causal ? (seq + ROWS - 1) / ROWS - 1 - rank : rank) * ROWS;
  // key tiles up to the diagonal
  const int count = causal ? min(n_tiles, (q0 + ROWS) / kRows) : n_tiles;
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs_.b + h * vs_.h;

  auto load_keys = [&](int s, int i) {
    load_tile<DP, kRows, THREADS>(k_at(s), kb, ks_.t, i * kRows, seq, dim);
    load_tile<DP, kRows, THREADS>(v_at(s), vb, vs_.t, i * kRows, seq, dim);
  };

  load_tile<DP, ROWS, THREADS>(own_q, q + b * qs_.b + h * qs_.h, qs_.t, q0, seq, dim);
  load_tile<DP, ROWS, THREADS>(own_do, dout + b * dos_.b + h * dos_.h, dos_.t, q0, seq, dim);
  cp_commit();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < count) load_keys(s, s);
    cp_commit();
  }
  float row_lse[2], row_di[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = q0 + 16 * w + g + 8 * half;
    const size_t at = ((size_t)b * heads + h) * seq + t;
    row_lse[half] = t < seq ? lse[at] : 0.f;
    row_di[half] = t < seq ? di[at] : 0.f;
  }
  cp_wait<kStages - 1>();
  scale_tile<DP, ROWS, THREADS>(own_q, scale);
  __syncthreads();
  uint32_t qa[KS][4], da[KS][4];  // A fragments of the warp's 16 queries
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldsm(qa[kk], own_q + (16 * w + L.ra) * LD + 16 * kk + L.ca);
    ldsm(da[kk], own_do + (16 * w + L.ra) * LD + 16 * kk + L.ca);
  }

  float dq_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int i = 0; i < count; ++i) {
    const int s = i % kStages;
    cp_wait<kStages - 2>();
    __syncthreads();  // tile i is in; every warp is done with the stage refilled next
    if (i + kStages - 1 < count) load_keys((i + kStages - 1) % kStages, i + kStages - 1);
    cp_commit();

    const int k0 = i * kRows;
    const bool diag = causal && k0 + kRows > q0;  // the tile crosses the diagonal
    const bool edge = diag || k0 + kRows > seq;
    const bf16* kt = k_at(s);
    const bf16* vt = v_at(s);
#pragma unroll
    for (int c = 0; c < kRows / 16; ++c) {  // 16 keys at a time
      // every one of these keys after the warp's queries: nothing to add
      if (diag && k0 + 16 * c > q0 + 16 * w + 15) continue;
      float sc[2][4] = {}, dp[2][4] = {};   // S, dP: [query][key]
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t f[4];
        ldsm(f, kt + (16 * c + L.rb) * LD + 16 * kk + L.cb);
        mma(sc[0], qa[kk], f[0], f[1]);
        mma(sc[1], qa[kk], f[2], f[3]);
        ldsm(f, vt + (16 * c + L.rb) * LD + 16 * kk + L.cb);
        mma(dp[0], da[kk], f[0], f[1]);
        mma(dp[1], da[kk], f[2], f[3]);
      }
      uint32_t dsa[4];  // dS as an A fragment: depth = key
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = exp2f((sc[j][e] - row_lse[e >> 1]) * kLog2e);
          if (edge) {
            const int key = k0 + 16 * c + 8 * j + 2 * tig + (e & 1);
            const int query = q0 + 16 * w + g + 8 * (e >> 1);
            if (key >= seq || (causal && key > query)) x = 0.f;
          }
          ds[e] = x * (dp[j][e] - row_di[e >> 1]);
        }
        dsa[2 * j] = pack(ds[0], ds[1]);
        dsa[2 * j + 1] = pack(ds[2], ds[3]);
      }
#pragma unroll
      for (int n = 0; n < NT / 2; ++n) {  // 16 features at a time
        uint32_t f[4];
        ldsm_t(f, kt + (16 * c + L.ra) * LD + 16 * n + L.ca);
        mma(dq_acc[2 * n], dsa, f[0], f[1]);
        mma(dq_acc[2 * n + 1], dsa, f[2], f[3]);
      }
    }
  }
  cp_wait<0>();

  store_rows<DP>(dq, dq_acc, q0 + 16 * w, g, tig, b, h, seq, heads, dim, scale);
}

// ================================================================ fp32, FMA

constexpr int kThreadsF32 = 256;  // 16 x 16
constexpr int kLP = kRows + 1;    // padded row of a P or dS tile

// Rows r0 .. r0 + 63 of x (one batch and head) into tile[r][d], rows and
// features past the end as zeros, times `scale`.
template <int DP>
__device__ __forceinline__ void load_tile_f32(float* tile, const float* x, Strides st, int r0,
                                              int seq, int dim, float scale) {
  constexpr int LD = DP + 1;
  for (int e = threadIdx.x; e < kRows * DP; e += kThreadsF32) {
    const int r = e / DP, d = e % DP, t = r0 + r;
    tile[r * LD + d] = t < seq && d < dim ? x[t * st.t + d] * scale : 0.f;
  }
}

template <int DP>
constexpr size_t smem_dkv_f32() {  // K, V, q * scale, dO tiles; P^T and dS^T; lse, di
  return sizeof(float) * (4 * kRows * (DP + 1) + 2 * kRows * kLP + 2 * kRows);
}

template <int DP>
constexpr size_t smem_dq_f32() {   // q * scale, dO, K, V tiles; dS
  return sizeof(float) * (4 * kRows * (DP + 1) + kRows * kLP);
}

// s and dP of a 4 x 4 patch: rows of a and b (4 ty + i) against rows of c and
// e (tx + 16 j), over DP features.
template <int DP>
__device__ __forceinline__ void two_products(const float* a, const float* c, const float* b,
                                             const float* e, int ty, int tx, float (&s)[4][4],
                                             float (&p)[4][4]) {
  constexpr int LD = DP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = p[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float ra[4], rb[4], rc[4], re[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ra[i] = a[(4 * ty + i) * LD + d];
      rb[i] = b[(4 * ty + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rc[j] = c[(tx + 16 * j) * LD + d];
      re[j] = e[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(ra[i], rc[j], s[i][j]);
        p[i][j] = fmaf(rb[i], re[j], p[i][j]);
      }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         float* __restrict__ dk, float* __restrict__ dv, Strides qs_,
                         Strides ks_, Strides vs_, Strides dos_, int seq, int heads, int dim,
                         float scale, int causal) {
  constexpr int LD = DP + 1;
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  float* ks = smem;                 // [kRows][LD]  this block's keys
  float* vs = ks + kRows * LD;      // [kRows][LD]  and values
  float* qs = vs + kRows * LD;      // [kRows][LD]  streamed q * scale
  float* dos = qs + kRows * LD;     // [kRows][LD]  streamed dO
  float* pt = dos + kRows * LD;     // [kRows][kLP] P^T: [key][query]
  float* dst = pt + kRows * kLP;    // [kRows][kLP] dS^T
  float* lse_s = dst + kRows * kLP; // [kRows]
  float* di_s = lse_s + kRows;      // [kRows]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qb = q + b * qs_.b + h * qs_.h;
  const float* dob = dout + b * dos_.b + h * dos_.h;
  const float* lse_b = lse + ((size_t)b * heads + h) * seq;
  const float* di_b = di + ((size_t)b * heads + h) * seq;

  load_tile_f32<DP>(ks, k + b * ks_.b + h * ks_.h, ks_, k0, seq, dim, 1.f);
  load_tile_f32<DP>(vs, v + b * vs_.b + h * vs_.h, vs_, k0, seq, dim, 1.f);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: query tiles that end before this key tile sees nothing of it
  for (int q0 = causal ? k0 : 0; q0 < seq; q0 += kRows) {
    __syncthreads();  // the previous tile's products are done with qs, dos, pt, dst
    load_tile_f32<DP>(qs, qb, qs_, q0, seq, dim, scale);
    load_tile_f32<DP>(dos, dob, dos_, q0, seq, dim, 1.f);
    if (tid < kRows) {
      const int t = q0 + tid;
      lse_s[tid] = t < seq ? lse_b[t] : 0.f;
      di_s[tid] = t < seq ? di_b[t] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];  // [key 4 ty + i][query tx + 16 j]
    two_products<DP>(ks, qs, vs, dos, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + 4 * ty + i, r = tx + 16 * j, query = q0 + r;
        const bool in = key < seq && query < seq && !(causal && key > query);
        const float p = in ? expf(s[i][j] - lse_s[r]) : 0.f;
        pt[(4 * ty + i) * kLP + r] = p;
        dst[(4 * ty + i) * kLP + r] = p * (dp[i][j] - di_s[r]);
      }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      float p[4], ds[4], o[NC], x[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = pt[(4 * ty + i) * kLP + r];
        ds[i] = dst[(4 * ty + i) * kLP + r];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        o[c] = dos[r * LD + tx + 16 * c];
        x[c] = qs[r * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv_acc[i][c] = fmaf(p[i], o[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds[i], x[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= seq) continue;
    const size_t row = (((size_t)b * seq + key) * heads + h) * dim;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < dim) {
        dk[row + d] = dk_acc[i][c];
        dv[row + d] = dv_acc[i][c];
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        float* __restrict__ dq, Strides qs_, Strides ks_, Strides vs_,
                        Strides dos_, int seq, int heads, int dim, float scale, int causal) {
  constexpr int LD = DP + 1;
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [kRows][LD]  this block's q * scale
  float* dos = qs + kRows * LD;  // [kRows][LD]  and dO
  float* ks = dos + kRows * LD;  // [kRows][LD]  streamed keys
  float* vs = ks + kRows * LD;   // [kRows][LD]  and values
  float* dss = vs + kRows * LD;  // [kRows][kLP] dS: [query][key]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* kb = k + b * ks_.b + h * ks_.h;
  const float* vb = v + b * vs_.b + h * vs_.h;
  const float* lse_b = lse + ((size_t)b * heads + h) * seq;
  const float* di_b = di + ((size_t)b * heads + h) * seq;

  load_tile_f32<DP>(qs, q + b * qs_.b + h * qs_.h, qs_, q0, seq, dim, scale);
  load_tile_f32<DP>(dos, dout + b * dos_.b + h * dos_.h, dos_, q0, seq, dim, 1.f);
  float row_lse[4], row_di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    row_lse[i] = t < seq ? lse_b[t] : 0.f;
    row_di[i] = t < seq ? di_b[t] : 0.f;
  }

  float dq_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[i][c] = 0.f;

  // causal: key tiles that start after this query tile's last row are skipped
  const int k_end = causal ? min(seq, q0 + kRows) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kRows) {
    __syncthreads();  // the previous tile's product is done with ks and dss
    load_tile_f32<DP>(ks, kb, ks_, k0, seq, dim, 1.f);
    load_tile_f32<DP>(vs, vb, vs_, k0, seq, dim, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];  // [query 4 ty + i][key tx + 16 j]
    two_products<DP>(qs, ks, dos, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int query = q0 + 4 * ty + i, c = tx + 16 * j, key = k0 + c;
        const bool in = key < seq && query < seq && !(causal && key > query);
        const float p = in ? expf(s[i][j] - row_lse[i]) : 0.f;
        dss[(4 * ty + i) * kLP + c] = p * (dp[i][j] - row_di[i]);
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kRows; ++c) {
      float ds[4], x[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(4 * ty + i) * kLP + c];
#pragma unroll
      for (int f = 0; f < NC; ++f) x[f] = ks[c * LD + tx + 16 * f];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int f = 0; f < NC; ++f) dq_acc[i][f] = fmaf(ds[i], x[f], dq_acc[i][f]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= seq) continue;
    const size_t row = (((size_t)b * seq + t) * heads + h) * dim;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < dim) dq[row + d] = scale * dq_acc[i][c];
    }
  }
}

// ---------------------------------------------------------------- launch

template <int DP>
auto dkv_bf16() {
  return make_launch(flash_bwd_dkv_bf16_kernel<DP, kWarpsDkv>, 32 * kWarpsDkv,
                     smem_bf16<DP, kWarpsDkv>(true));
}
template <int DP>
auto dq_bf16() {
  return make_launch(flash_bwd_dq_bf16_kernel<DP, kWarpsDq>, 32 * kWarpsDq,
                     smem_bf16<DP, kWarpsDq>(false));
}
template <int DP>
auto dkv_f32() { return make_launch(flash_bwd_dkv_f32_kernel<DP>, kThreadsF32, smem_dkv_f32<DP>()); }
template <int DP>
auto dq_f32() { return make_launch(flash_bwd_dq_f32_kernel<DP>, kThreadsF32, smem_dq_f32<DP>()); }

template <int DP>
int launch_bf16(const Args& a, bool dkv) {
  if (a.dim % 8 != 0 || !rows_aligned(a.q, a.qs) || !rows_aligned(a.k, a.ks) ||
      !rows_aligned(a.v, a.vs) || !rows_aligned(a.dout, a.dos))
    return (int)cudaErrorMisalignedAddress;
  // one block per (tile of 16 * warps rows, batch, head), batch * head fastest
  const int rows = 16 * (dkv ? kWarpsDkv : kWarpsDq);
  const long long blocks = (long long)((a.seq + rows - 1) / rows) * a.batch * a.heads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto q = static_cast<const bf16*>(a.q), k = static_cast<const bf16*>(a.k),
             v = static_cast<const bf16*>(a.v), dout = static_cast<const bf16*>(a.dout);
  if (dkv) {
    const auto l = dkv_bf16<DP>();
    const cudaError_t err = l.prepare();
    if (err != cudaSuccess) return (int)err;
    l.kernel<<<(unsigned)blocks, l.threads, l.smem, a.stream>>>(
        q, k, v, dout, a.lse, a.di, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.qs,
        a.ks, a.vs, a.dos, a.batch, a.seq, a.heads, a.dim, a.scale, a.causal);
  } else {
    const auto l = dq_bf16<DP>();
    const cudaError_t err = l.prepare();
    if (err != cudaSuccess) return (int)err;
    l.kernel<<<(unsigned)blocks, l.threads, l.smem, a.stream>>>(
        q, k, v, dout, a.lse, a.di, static_cast<bf16*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.batch,
        a.seq, a.heads, a.dim, a.scale, a.causal);
  }
  return (int)cudaGetLastError();
}

template <int DP>
int launch_f32(const Args& a, bool dkv) {
  if (a.heads > 65535 || a.batch > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.seq + kRows - 1) / kRows, a.heads, a.batch);
  const auto q = static_cast<const float*>(a.q), k = static_cast<const float*>(a.k),
             v = static_cast<const float*>(a.v), dout = static_cast<const float*>(a.dout);
  if (dkv) {
    const auto l = dkv_f32<DP>();
    const cudaError_t err = l.prepare();
    if (err != cudaSuccess) return (int)err;
    l.kernel<<<grid, l.threads, l.smem, a.stream>>>(
        q, k, v, dout, a.lse, a.di, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.qs,
        a.ks, a.vs, a.dos, a.seq, a.heads, a.dim, a.scale, a.causal);
  } else {
    const auto l = dq_f32<DP>();
    const cudaError_t err = l.prepare();
    if (err != cudaSuccess) return (int)err;
    l.kernel<<<grid, l.threads, l.smem, a.stream>>>(
        q, k, v, dout, a.lse, a.di, static_cast<float*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.seq,
        a.heads, a.dim, a.scale, a.causal);
  }
  return (int)cudaGetLastError();
}

int run(const Args& a, int is_bf16, bool dkv) {
  if (a.batch <= 0 || a.seq <= 0 || a.heads <= 0) return (int)cudaErrorInvalidValue;
  return by_width(a.dim, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return is_bf16 ? launch_bf16<DP>(a, dkv) : launch_f32<DP>(a, dkv);
  });
}

}  // namespace

// q, k, v, dout: [B, T, H, D] views with contiguous D and the given element
// strides (batch, time, head), one dtype (bf16 when is_bf16, else fp32); in
// bf16, D a multiple of 8 and every row on 16 bytes (else
// cudaErrorMisalignedAddress); lse, di: contiguous fp32 [B, H, T]; dk, dv:
// contiguous [B, T, H, D] in the input dtype.
extern "C" int acx_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const float* lse, const float* di,
                                     void* dk, void* dv, int batch, int seq, int heads, int dim,
                                     long long q_sb, long long q_st, long long q_sh,
                                     long long k_sb, long long k_st, long long k_sh,
                                     long long v_sb, long long v_st, long long v_sh,
                                     long long do_sb, long long do_st, long long do_sh,
                                     float scale, int causal, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, lse, di, nullptr, dk, dv, batch, seq, heads, dim,
               {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh},
               {do_sb, do_st, do_sh}, scale, causal, (cudaStream_t)stream};
  return run(a, is_bf16, true);
}

// The same inputs; dq: contiguous [B, T, H, D] in the input dtype.
extern "C" int acx_attention_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse, const float* di,
                                    void* dq, int batch, int seq, int heads, int dim,
                                    long long q_sb, long long q_st, long long q_sh,
                                    long long k_sb, long long k_st, long long k_sh,
                                    long long v_sb, long long v_st, long long v_sh,
                                    long long do_sb, long long do_st, long long do_sh,
                                    float scale, int causal, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, lse, di, dq, nullptr, nullptr, batch, seq, heads, dim,
               {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {v_sb, v_st, v_sh},
               {do_sb, do_st, do_sh}, scale, causal, (cudaStream_t)stream};
  return run(a, is_bf16, false);
}

// What the kernel for (dkv or dq, head width dim, dtype) uses, into out[5]:
// registers per thread, shared memory per block (bytes), blocks resident per
// SM, threads per block, local (spilled) bytes per thread.
extern "C" int acx_attention_bwd_info(int dkv, int dim, int is_bf16, int* out) {
  return by_width(dim, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    if (!is_bf16) return dkv ? describe(dkv_f32<DP>(), out) : describe(dq_f32<DP>(), out);
    return dkv ? describe(dkv_bf16<DP>(), out) : describe(dq_bf16<DP>(), out);
  });
}
