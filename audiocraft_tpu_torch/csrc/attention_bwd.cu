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
//
// fp32 (the parity path, and the training CLI's default dtype): fp32 FMA
// outside the tensor cores (TF32 would round the products past the 1e-4 that
// the plain version is held to), so its ceiling is the fp32 rate: 4 products
// for dK/dV and 3 for dQ, 0.551 + 0.414 ms at the training shape above.  The
// first kernels (256 threads, 4 x 4 register tiles fed by scalar shared
// loads, two FMAs a load; tiles copied element by element behind three block
// barriers a tile, P^T and dS^T through block-shared memory, expf, dQ's
// causal tiles shortest first, 100 KB of shared memory a dK/dV block: 1.688
// + 1.349 ms at that shape on an NVIDIA H100 80GB HBM3 at 700 W, against
// 1.751 for SDPA's fp32 backward) are replaced by two kernels built as K3f's
// fp32 forward (attention.cu) is:
// - dQ: a block of 4 warps owns 64 query rows; (q * scale)^T and dO^T lie
//   feature-major in shared memory, loaded once, and each lane keeps its 4
//   rows' lse and di in registers.  dK/dV, its mirror image: a block of 4
//   warps owns 64 keys, K^T and V^T loaded once.
// - 32-row tiles of the streamed operands (K and V; or q, dO, lse and di)
//   come through a 2-stage ring of 16-byte cp.async copies, rows as they are
//   in memory with their pieces swizzled (swz), one block barrier a tile;
//   the dK/dV kernel's thread scales the q pieces it copied, once landed, so
//   that S^T and dK read q * scale, the plain version's operand (no log2(e)
//   in it: P takes exp2(s * log2(e) - lse * log2(e)), one FMA).
// - A lane holds a 4-row x 4-column tile of S and of dP (or S^T and dP^T),
//   fed by 128-bit shared loads: 128 FMAs per 16 loads (per 4 features, one
//   load of each of its 4 columns' rows and of each feature's 4 rows).
// - P on ex2.approx.ftz; dS (and P^T) formed in registers, then written once
//   into the warp's own rows (a __syncwarp, not a block barrier); dQ += dS K,
//   dV += P^T dO and dK += dS^T (q * scale) take 4 rows x DP / 8 features a
//   lane, the warp's rows as broadcasts against 128-bit loads of the tile's
//   rows.  dK/dV writes P^T and then dS^T into one buffer, so that a block
//   takes 74 KB and three blocks (12 warps) share an SM, at 168 registers.
// - Causal: dQ runs the longest query tiles first and skips the key tiles
//   after the diagonal; dK/dV starts each key tile at its diagonal and key
//   tile 0 runs first; a warp skips the tiles wholly masked for its rows.
// - Each gradient is written by one thread, in a fixed order: two runs give
//   the same bits.  The order of the sums is not cuBLAS's, so the gradients
//   differ from the plain version's by rounding (held to 1e-4 of each
//   gradient's max-abs by chip_smoke.py).
// Rows must lie on 16 bytes and D be a multiple of 4: the wrapper
// (ops/attention.py) copies a view that does not, and pads D.
// After, on the same card (apps/time_fp32_kernels, PERF.md): 1.091-1.119 +
// 0.847-0.867 ms at the training shape, about 50 % and 48 % of the bound,
// against 1.751-1.885 ms for SDPA's fp32 backward, so the pair is still 8-12 %
// slower than SDPA; 0.113-0.148 + 0.086-0.116 ms at [2, 501, 16, 64].  Tried
// and slower: 8 warps a dK/dV block (128 registers, 104 bytes spilled:
// 1.286 ms), and 8 rows a lane in both kernels (32 rows a warp, 2.7 to 4
// times the FMAs a load, but 250-255 registers and 6-8 warps an SM: 1.215-
// 1.222 + 0.949-0.959 ms).  What holds the kernels near half the fp32 rate
// is not separated yet: the bytes the shared loads deliver (2 FMAs a float
// in the products) would allow about 55 %.
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

constexpr int kTileF32 = 32;      // rows of a streamed tile: keys (dQ) or queries (dK/dV)
constexpr int kWarpsDqF32 = 4;    // dQ: warps a block, 16 query rows each
constexpr int kWarpsDkvF32 = 4;   // dK/dV: warps a block, 16 keys each

// Shared floats of the dQ block: (q * scale)^T and dO^T [DP][64], a ring of
// 2 stages of K [32][DP] and V [32][DP], each warp's dS^T [32 keys][16 rows]
// (ops/attention.py:bwd_f32_geometry computes the same).  73,728 bytes at
// DP = 64: three blocks an SM.
template <int DP>
constexpr size_t smem_floats_dq_f32() {
  return (size_t)2 * DP * 16 * kWarpsDqF32 + 2 * 2 * kTileF32 * DP + kWarpsDqF32 * kTileF32 * 16;
}

// Shared floats of the dK/dV block: K^T and V^T [DP][64], a ring of 2 stages
// of q * scale [32][DP], dO [32][DP], lse [32] and di [32], each warp's P^T,
// then dS^T, [32 queries][16 keys].  74,240 bytes at DP = 64: three blocks an
// SM.
template <int DP>
constexpr size_t smem_floats_dkv_f32() {
  return (size_t)2 * DP * 16 * kWarpsDkvF32 + 2 * (2 * kTileF32 * DP + 2 * kTileF32) +
         kWarpsDkvF32 * kTileF32 * 16;
}

// Blocks an SM the launch bounds ask for: three (168 registers a thread) up
// to DP = 64, where shared memory holds three; one at DP = 128
template <int DP>
constexpr int min_blocks_f32() { return DP > 64 ? 1 : 3; }

// Rows r0 .. r0 + 31 of x (one batch and head, row stride st) into
// tile[32][DP] by THREADS threads, 16-byte cp.async copies, each row's pieces
// swizzled (swz); rows >= seq and features >= dim zero.  A thread always
// copies the same pieces, which scale_rows relies on.
template <int DP, int THREADS>
__device__ __forceinline__ void load_rows(float* tile, const float* x, long long st, int r0,
                                          int seq, int dim) {
  constexpr int PIECES = kTileF32 * DP / 4;
  static_assert(PIECES % THREADS == 0, "a tile is a whole number of copies per thread");
#pragma unroll
  for (int e0 = 0; e0 < PIECES; e0 += THREADS) {
    const int e = e0 + threadIdx.x, r = e / (DP / 4), c4 = e % (DP / 4), t = r0 + r;
    const bool in = t < seq && 4 * c4 < dim;
    cp_async16(tile + r * DP + swz(r, c4), in ? x + t * st + 4 * c4 : x, in);
  }
}

// The pieces this thread copied with load_rows, once landed: x -> x * scale
template <int DP, int THREADS>
__device__ __forceinline__ void scale_rows(float* tile, float scale) {
  constexpr int PIECES = kTileF32 * DP / 4;
#pragma unroll
  for (int e0 = 0; e0 < PIECES; e0 += THREADS) {
    const int e = e0 + threadIdx.x, r = e / (DP / 4), c4 = e % (DP / 4);
    float4* p = reinterpret_cast<float4*>(tile + r * DP + swz(r, c4));
    float4 x = *p;
    x.x *= scale, x.y *= scale, x.z *= scale, x.w *= scale;
    *p = x;
  }
}

// Rows r0 .. r0 + ROWS - 1 of x into xt[DP][ROWS] (feature-major) times mul,
// by THREADS = 2 ROWS threads with 16-byte loads; rows >= seq and features
// >= dim zero.  A warp's stores fall on 32 consecutive floats.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_transposed(float* xt, const float* x, long long st, int r0,
                                                int seq, int dim, float mul) {
  static_assert(THREADS == 2 * ROWS, "two threads a row");
  const int r = threadIdx.x % ROWS, t = r0 + r;
#pragma unroll 4
  for (int c = 4 * (threadIdx.x / ROWS); c < DP; c += 8) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < seq && c < dim) v = *reinterpret_cast<const float4*>(x + t * st + c);
    xt[(c + 0) * ROWS + r] = v.x * mul;
    xt[(c + 1) * ROWS + r] = v.y * mul;
    xt[(c + 2) * ROWS + r] = v.z * mul;
    xt[(c + 3) * ROWS + r] = v.w * mul;
  }
}

// acc[i][4 u + e] += p[i] * row[32 u + 4 g + e] for the 32 rows of a streamed
// tile: p (4 values a row) from the warp's own buffer buf[32][16] at 4 rg (a
// broadcast), the tile's rows by 128-bit loads of their swizzled pieces
// 8 u + g (8 lanes read 128 consecutive bytes of one row)
template <int DP>
__device__ __forceinline__ void rows_product(float (&acc)[4][DP / 8], const float* buf,
                                             const float* tile, int rg, int g) {
#pragma unroll 8
  for (int r = 0; r < kTileF32; ++r) {
    const float4 x = *reinterpret_cast<const float4*>(buf + r * 16 + 4 * rg);
    const float p[4] = {x.x, x.y, x.z, x.w};
    float y[DP / 8];
#pragma unroll
    for (int u = 0; u < DP / 32; ++u) {
      const float4 z = *reinterpret_cast<const float4*>(tile + r * DP + swz(r, 8 * u + g));
      y[4 * u] = z.x, y[4 * u + 1] = z.y, y[4 * u + 2] = z.z, y[4 * u + 3] = z.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int f = 0; f < DP / 8; ++f) acc[i][f] = fmaf(p[i], y[f], acc[i][f]);
  }
}

// Two products of a 4 x 4 patch over DP features: a[i][j] += at[., ra + i] .
// rows[j] and b[i][j] += bt[., ra + i] . rows2[j], the columns ra .. ra + 3
// of the feature-major at, bt [DP][LD] against rows g + 8 j of the
// row-major, swizzled tiles [32][DP]: for 4 features at a time, one 128-bit
// load of each of the 8 rows and of each of the 8 feature columns, 128 FMAs.
template <int DP, int LD>
__device__ __forceinline__ void pair_products(float (&a)[4][4], float (&b)[4][4],
                                              const float* at, const float* bt,
                                              const float* rows, const float* rows2, int ra,
                                              int g) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = b[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; c += 4) {
    float x[4][4], y[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 u = *reinterpret_cast<const float4*>(rows + (g + 8 * j) * DP + swz(g, c / 4));
      const float4 v = *reinterpret_cast<const float4*>(rows2 + (g + 8 * j) * DP + swz(g, c / 4));
      x[j][0] = u.x, x[j][1] = u.y, x[j][2] = u.z, x[j][3] = u.w;
      y[j][0] = v.x, y[j][1] = v.y, y[j][2] = v.z, y[j][3] = v.w;
    }
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float4 u = *reinterpret_cast<const float4*>(at + (c + dd) * LD + ra);
      const float4 v = *reinterpret_cast<const float4*>(bt + (c + dd) * LD + ra);
      const float pa[4] = {u.x, u.y, u.z, u.w}, pb[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[i][j] = fmaf(pa[i], x[j][dd], a[i][j]);
          b[i][j] = fmaf(pb[i], y[j][dd], b[i][j]);
        }
    }
  }
}

// 4 rows (or keys) x 4 columns as a 128-bit store a column into the warp's
// buf[32][16]: column g + 8 j, rows 4 rg .. 4 rg + 3 (the 8 lanes of a row
// group on distinct bank groups)
__device__ __forceinline__ void store_transposed(float* buf, const float (&x)[4][4], int rg,
                                                 int g) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(buf + (g + 8 * j) * 16 + 4 * rg) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
}

// Rows row0 .. row0 + 3 of a [B, T, H, D] fp32 output: acc[i][4 u + e] * mul
// at features 32 u + 4 g + e, as 16-byte stores where row < seq, d < dim
template <int DP>
__device__ __forceinline__ void store_rows_f32(float* out, const float (&acc)[4][DP / 8],
                                               int row0, int g, int b, int h, int seq,
                                               int heads, int dim, float mul) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = row0 + i;
    if (t >= seq) continue;
    float* row = out + (((size_t)b * seq + t) * heads + h) * dim;
#pragma unroll
    for (int u = 0; u < DP / 32; ++u) {
      const int d = 32 * u + 4 * g;
      if (d < dim)
        *reinterpret_cast<float4*>(row + d) =
            make_float4(acc[i][4 * u] * mul, acc[i][4 * u + 1] * mul, acc[i][4 * u + 2] * mul,
                        acc[i][4 * u + 3] * mul);
    }
  }
}

// ---------------------------------------------------------------- dQ (fp32)

// Lane l of warp w owns query rows 16 w + 4 (l / 8) .. + 3 of the block, keys
// l % 8 + 8 j (j < 4) of each 32-key tile for S and dP, and features
// 4 (l % 8) + 32 u .. + 3 (u < DP / 32) of dQ.
template <int DP>
__global__ void __launch_bounds__(32 * kWarpsDqF32, min_blocks_f32<DP>())
flash_bwd_dq_f32_tiled(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        float* __restrict__ dq, Strides qs_, Strides ks_, Strides vs_,
                        Strides dos_, int batch, int seq, int heads, int dim, float scale,
                        int causal) {
  constexpr int ROWS = 16 * kWarpsDqF32, THREADS = 32 * kWarpsDqF32;
  constexpr int STAGE = 2 * kTileF32 * DP;  // K then V
  extern __shared__ __align__(16) float smem_f32[];
  float* qt = smem_f32;                     // [DP][64]: q * scale
  float* ot = qt + DP * ROWS;               // [DP][64]: dO
  float* ring = ot + DP * ROWS;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, kg = lane % 8, rg = lane / 8;
  float* dst = ring + 2 * STAGE + w * kTileF32 * 16;  // this warp's dS^T [key][row]
  const int bh = blockIdx.x % (batch * heads), rank = blockIdx.x / (batch * heads);
  const int b = bh / heads, h = bh % heads;
  const int tiles_q = (seq + ROWS - 1) / ROWS;
  // causal: the last query tile, which sees every key tile, runs first
  const int q0 = (causal ? tiles_q - 1 - rank : rank) * ROWS;
  const int row0 = 16 * w + 4 * rg;         // the lane's first row in the block
  const int n_tiles = (seq + kTileF32 - 1) / kTileF32;
  const int count = causal ? min(n_tiles, (q0 + ROWS) / kTileF32) : n_tiles;  // key tiles
  const float* kb = k + b * ks_.b + h * ks_.h;
  const float* vb = v + b * vs_.b + h * vs_.h;

  auto load_kv = [&](int s, int i) {
    float* kt = ring + s * STAGE;
    load_rows<DP, THREADS>(kt, kb, ks_.t, i * kTileF32, seq, dim);
    load_rows<DP, THREADS>(kt + kTileF32 * DP, vb, vs_.t, i * kTileF32, seq, dim);
  };
  if (count > 0) load_kv(0, 0);
  cp_commit();
  load_transposed<DP, ROWS, THREADS>(qt, q + b * qs_.b + h * qs_.h, qs_.t, q0, seq, dim, scale);
  load_transposed<DP, ROWS, THREADS>(ot, dout + b * dos_.b + h * dos_.h, dos_.t, q0, seq, dim,
                                     1.f);
  // the lane's rows: lse in base 2, di
  float lse2[4], drow[4], acc[4][DP / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + row0 + i;
    const size_t at = ((size_t)b * heads + h) * seq + t;
    lse2[i] = t < seq ? lse[at] * kLog2e : 0.f;
    drow[i] = t < seq ? di[at] : 0.f;
#pragma unroll
    for (int f = 0; f < DP / 8; ++f) acc[i][f] = 0.f;
  }

  for (int i = 0; i < count; ++i) {
    cp_wait<0>();
    __syncthreads();   // tile i is in; every warp is done with the stage refilled next
    if (i + 1 < count) load_kv((i + 1) & 1, i + 1);
    cp_commit();

    const int k0 = i * kTileF32;
    // every key of the tile after the warp's rows: nothing to add
    if (causal && k0 > q0 + 16 * w + 15) continue;
    const float* kt = ring + (i & 1) * STAGE;
    const float* vt = kt + kTileF32 * DP;
    float s[4][4], dp[4][4];   // [row 4 rg + i][key kg + 8 j]
    pair_products<DP, ROWS>(s, dp, qt, ot, kt, vt, row0, kg);
    const bool edge = k0 + kTileF32 > seq || (causal && k0 + kTileF32 - 1 > q0 + row0);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = exp2_ftz(fmaf(s[r][j], kLog2e, -lse2[r]));
        if (edge) {
          const int key = k0 + kg + 8 * j;
          if (key >= seq || (causal && key > q0 + row0 + r)) p = 0.f;
        }
        s[r][j] = p * (dp[r][j] - drow[r]);   // dS
      }
    store_transposed(dst, s, rg, kg);
    __syncwarp();
    rows_product<DP>(acc, dst, kt, rg, kg);   // dQ += dS K
    __syncwarp();   // dS^T is read before the next tile's overwrites it
  }
  cp_wait<0>();
  store_rows_f32<DP>(dq, acc, q0 + row0, kg, b, h, seq, heads, dim, scale);
}

// ---------------------------------------------------------------- dK, dV (fp32)

// Lane l of warp w owns keys 16 w + 4 (l / 8) .. + 3 of the block, queries
// l % 8 + 8 j (j < 4) of each 32-query tile for S^T and dP^T, and features
// 4 (l % 8) + 32 u .. + 3 (u < DP / 32) of dK and dV.
template <int DP>
__global__ void __launch_bounds__(32 * kWarpsDkvF32, min_blocks_f32<DP>())
flash_bwd_dkv_f32_tiled(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         float* __restrict__ dk, float* __restrict__ dv, Strides qs_,
                         Strides ks_, Strides vs_, Strides dos_, int batch, int seq, int heads,
                         int dim, float scale, int causal) {
  constexpr int KEYS = 16 * kWarpsDkvF32, THREADS = 32 * kWarpsDkvF32;
  constexpr int TILE = kTileF32 * DP;              // one streamed q * scale or dO tile
  constexpr int STAGE = 2 * TILE + 2 * kTileF32;   // q * scale, dO, lse, di
  extern __shared__ __align__(16) float smem_f32[];
  float* kt = smem_f32;                            // [DP][KEYS]: K^T
  float* vt = kt + DP * KEYS;                      // [DP][KEYS]: V^T
  float* ring = vt + DP * KEYS;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, qg = lane % 8, rg = lane / 8;
  float* pt = ring + 2 * STAGE + w * kTileF32 * 16;  // this warp's P^T, then dS^T [query][key]
  const int bh = blockIdx.x % (batch * heads), tile = blockIdx.x / (batch * heads);
  const int b = bh / heads, h = bh % heads;
  const int k0 = tile * KEYS;   // key tile 0, the longest when causal, runs first
  const int key0 = 16 * w + 4 * rg;   // the lane's first key in the block
  const int n_tiles = (seq + kTileF32 - 1) / kTileF32;
  const int first = causal ? k0 / kTileF32 : 0;   // query tiles before the diagonal see nothing
  const int count = n_tiles - first;
  const float* qb = q + b * qs_.b + h * qs_.h;
  const float* dob = dout + b * dos_.b + h * dos_.h;
  const float* lse_b = lse + ((size_t)b * heads + h) * seq;
  const float* di_b = di + ((size_t)b * heads + h) * seq;

  auto load_queries = [&](int s, int i) {   // query tile first + i into stage s
    float* st = ring + s * STAGE;
    const int q0 = (first + i) * kTileF32;
    load_rows<DP, THREADS>(st, qb, qs_.t, q0, seq, dim);
    load_rows<DP, THREADS>(st + TILE, dob, dos_.t, q0, seq, dim);
    if (tid < 2 * kTileF32) {   // lse at 2 TILE, di at 2 TILE + 32
      const int t = q0 + tid % kTileF32;
      const float* src = tid < kTileF32 ? lse_b : di_b;
      cp_async4(st + 2 * TILE + tid, t < seq ? src + t : src, t < seq);
    }
  };
  if (count > 0) load_queries(0, 0);
  cp_commit();
  load_transposed<DP, KEYS, THREADS>(kt, k + b * ks_.b + h * ks_.h, ks_.t, k0, seq, dim, 1.f);
  load_transposed<DP, KEYS, THREADS>(vt, v + b * vs_.b + h * vs_.h, vs_.t, k0, seq, dim, 1.f);

  float dk_acc[4][DP / 8], dv_acc[4][DP / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int f = 0; f < DP / 8; ++f) dk_acc[i][f] = dv_acc[i][f] = 0.f;

  for (int i = 0; i < count; ++i) {
    float* st = ring + (i & 1) * STAGE;
    cp_wait<0>();
    scale_rows<DP, THREADS>(st, scale);   // the pieces of q this thread copied: q * scale
    __syncthreads();   // tile i is in and scaled; every warp is done with the stage refilled next
    if (i + 1 < count) load_queries((i + 1) & 1, i + 1);
    cp_commit();

    const int q0 = (first + i) * kTileF32;
    // every key of the warp after every query of the tile: nothing to add
    if (causal && k0 + 16 * w > q0 + kTileF32 - 1) continue;
    const float* qt = st;                 // q * scale [32][DP], swizzled
    const float* ot = st + TILE;          // dO [32][DP], swizzled
    const float* lse_s = st + 2 * TILE;
    const float* di_s = lse_s + kTileF32;
    float s[4][4], dp[4][4];   // S^T, dP^T: [key 4 rg + i][query qg + 8 j]
    pair_products<DP, KEYS>(s, dp, kt, vt, qt, ot, key0, qg);
    const bool edge = q0 + kTileF32 > seq || (causal && k0 + 16 * w + 15 > q0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float l2 = lse_s[qg + 8 * j] * kLog2e, dj = di_s[qg + 8 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = exp2_ftz(fmaf(s[r][j], kLog2e, -l2));
        if (edge) {
          const int query = q0 + qg + 8 * j;
          if (query >= seq || (causal && k0 + key0 + r > query)) p = 0.f;
        }
        s[r][j] = p;                          // P^T
        dp[r][j] = p * (dp[r][j] - dj);       // dS^T
      }
    }
    store_transposed(pt, s, rg, qg);
    __syncwarp();
    rows_product<DP>(dv_acc, pt, ot, rg, qg);   // dV += P^T dO
    __syncwarp();
    store_transposed(pt, dp, rg, qg);
    __syncwarp();
    rows_product<DP>(dk_acc, pt, qt, rg, qg);   // dK += dS^T (q * scale)
    __syncwarp();   // dS^T is read before the next tile's P^T overwrites it
  }
  cp_wait<0>();
  store_rows_f32<DP>(dk, dk_acc, k0 + key0, qg, b, h, seq, heads, dim, 1.f);
  store_rows_f32<DP>(dv, dv_acc, k0 + key0, qg, b, h, seq, heads, dim, 1.f);
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
auto dkv_f32() {
  return make_launch(flash_bwd_dkv_f32_tiled<DP>, 32 * kWarpsDkvF32,
                     sizeof(float) * smem_floats_dkv_f32<DP>());
}
template <int DP>
auto dq_f32() {
  return make_launch(flash_bwd_dq_f32_tiled<DP>, 32 * kWarpsDqF32,
                     sizeof(float) * smem_floats_dq_f32<DP>());
}

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
  if (a.dim % 4 != 0 || !rows_aligned(a.q, a.qs, 4) || !rows_aligned(a.k, a.ks, 4) ||
      !rows_aligned(a.v, a.vs, 4) || !rows_aligned(a.dout, a.dos, 4) ||
      (reinterpret_cast<uintptr_t>(a.dq) | reinterpret_cast<uintptr_t>(a.dk) |
       reinterpret_cast<uintptr_t>(a.dv)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  // one block per (tile of rows, batch, head), batch * head fastest
  const int rows = 16 * (dkv ? kWarpsDkvF32 : kWarpsDqF32);
  const long long blocks = (long long)((a.seq + rows - 1) / rows) * a.batch * a.heads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto q = static_cast<const float*>(a.q), k = static_cast<const float*>(a.k),
             v = static_cast<const float*>(a.v), dout = static_cast<const float*>(a.dout);
  if (dkv) {
    const auto l = dkv_f32<DP>();
    const cudaError_t err = l.prepare();
    if (err != cudaSuccess) return (int)err;
    l.kernel<<<(unsigned)blocks, l.threads, l.smem, a.stream>>>(
        q, k, v, dout, a.lse, a.di, static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.qs,
        a.ks, a.vs, a.dos, a.batch, a.seq, a.heads, a.dim, a.scale, a.causal);
  } else {
    const auto l = dq_f32<DP>();
    const cudaError_t err = l.prepare();
    if (err != cudaSuccess) return (int)err;
    l.kernel<<<(unsigned)blocks, l.threads, l.smem, a.stream>>>(
        q, k, v, dout, a.lse, a.di, static_cast<float*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.batch,
        a.seq, a.heads, a.dim, a.scale, a.causal);
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
