// Full-sequence self-attention forward with an online softmax (kernel K3f).
//
// Replaces the bundled Pallas flash_attention forward that
// audiocraft_tpu/ops/attention_pallas.py:fused_attention calls on the TPU
// (_flash_attention_kernel of jax/experimental/pallas/ops/tpu/
// flash_attention.py, one pallas_call).  For q, k, v in [B, T, H, D] (the JAX
// package's layout, read by strides):
//     o[b, t, h] = sum_s softmax_s((q[b, t, h] * scale) . k[b, s, h]) v[b, s, h]
// over keys s < T (and s <= t when causal).  Scores, the running max, the
// running sum and the output accumulator are fp32; the [T, T] scores never
// reach device memory.  Keys at index >= T and, when causal, keys after the
// query score -inf; nothing is padded.  A row whose keys so far are all
// masked keeps max -inf; its exponentials are taken against 0 instead, so no
// inf - inf turns into NaN.  q * scale is rounded to the input dtype before
// the products, as the plain version computes it.  When asked, the kernel
// also writes each row's fp32 log-sum-exp in natural units, lse[b, h, t] =
// m + log(l) of the scores it normalised (the JAX forward saves l and m,
// which carry the same), for the backward kernels in attention_bwd.cu to
// recompute P = exp(s - lse).
//
// Bound on an H100: 4*B*H*T^2*D operations (73.7 GFLOP at B = 8, H = 16,
// T = 1500, D = 64; half of that when causal) against about 98 MB of q, k, v
// and o in bf16, so the operations set the bound (0.075 ms at the bf16
// tensor-core rate).
//
// bf16 (the serving and training path) runs on the tensor cores, built from
// the machinery of attention_bwd.cu's dQ kernel, which has a forward's loop
// shape.  The first version (1.289 ms at the shape above on an NVIDIA H100
// 80GB HBM3 at 700 W, against 0.227 ms for SDPA) loaded each K and V tile
// element by element with two barriers a tile and nothing in flight during
// the products, built V's B fragments from scalar shared loads, read q from
// global memory element by element, took expf, and launched the longest
// causal blocks last.  Now:
// - A block of kWarpsFwd warps owns 16 * kWarpsFwd query rows of one
//   (batch, head).  Its q rows arrive by 16-byte cp.async copies; each
//   thread rounds the pieces it copied to bf16(q * scale) in shared memory;
//   warp w takes the A fragments of its 16 rows by ldmatrix and keeps them
//   for the whole loop.
// - 64-row K and V tiles stream through a ring of kStagesFwd stages of
//   cp.async.cg copies, rows padded to D + 8 bf16.  The copy of tile
//   i + kStagesFwd - 1 is issued right after the one barrier of tile i,
//   before its products.
// - For each 16 keys, S = qs K^T takes K's B fragments by ldmatrix from the
//   tile's rows; the online softmax runs on the accumulator fragments (row
//   max and sum over the 4 threads of a row by shuffles) in base 2:
//   ex2.approx.ftz of s * log2(e) - m * log2(e), one FMA and one MUFU
//   instruction an exponential; P feeds P.V as the A fragment without
//   leaving registers, V's B fragments by ldmatrix.trans.
// - P is split into a bf16 high part and a bf16 remainder, two products with
//   the same V fragments, so P keeps about 16 bits, as the plain version's
//   fp32 P does in effect: one bf16 P alone would add a relative error of
//   2^-9, a whole bf16 step of the output, which at outputs of magnitude 2 or
//   more nears the 2e-2 check.  Products of bf16 values are exact in the fp32
//   accumulator.  The split makes P.V twice the products of S, so the tensor
//   work is 1.5x that of a kernel that rounds P once (as SDPA does).
// - Causal: only the tiles that cross the diagonal are masked, the 16-key
//   chunks of those wholly after a warp's rows are skipped, and tiles above
//   the diagonal are never loaded.  The grid runs (query tile, batch * head)
//   with batch * head fastest and the longest causal tiles first.
// - 8 warps and 2 stages were chosen by timing 4 or 8 warps with 2 or 3
//   stages on the card at MAGNeT's and the training shape (PERF.md holds
//   the times).  Up to D = 64 the launch bounds hold a thread to
//   128 registers, so that 16 warps share an SM: a warp's products wait on
//   its softmax and on each other, and more warps hide that wait.
// - 16-byte copies need D a multiple of 8 and rows that start on 16 bytes;
//   the wrapper (ops/attention.py) copies a view that does not.
// Left for later: wgmma with TMA and a producer warp, and a persistent grid.
//
// fp32 (the parity path): fp32 FMA outside the tensor cores (TF32 would
// round the products), so its ceiling is the fp32 rate: 1.1 ms at the shape
// above, 0.046 ms at JASCO's U-net [6, 500, 8, 64].  The first version (256
// threads, a 4 x 4 register tile fed by scalar shared loads, about 2 FMAs a
// load; K and V copied element by element behind three barriers a tile;
// expf; 0.1417 ms at JASCO's shape against 0.1142 for SDPA in fp32 on an
// NVIDIA H100 80GB HBM3 at 700 W, PERF.md) is replaced by:
// - a block of 4 warps owns 64 query rows, so that JASCO's 384 blocks fill
//   the card in one wave; q is scaled once, by scale and log2(e), into q^T
//   (feature-major) in shared memory;
// - 32-key K and V tiles stream through a 2-stage ring of 16-byte cp.async
//   copies, rows as they are in memory (K's pieces swizzled), one barrier a
//   tile; 56 KiB a block at D = 64, so four blocks (16 warps) share an SM;
// - each thread holds a 4-row x 4-key tile of S and a 4-row x DP / 8
//   feature tile of O, fed by 128-bit shared loads (S: 64 FMAs per 8 loads;
//   P.V: 4 DP / 8 FMAs per 1 + DP / 32 loads).  Against 8-row tiles on 2
//   warps a block, this halves the reuse of each load and doubles the warps
//   that hide each other's latency, which at JASCO's 2.9 blocks an SM is
//   what limits;
// - the online softmax in base 2 (ex2.approx.ftz, the row max and sum over
//   the 8 lanes of a row by shuffles), lse written in natural units;
// - P leaves registers once, into the warp's own P^T rows (a __syncwarp,
//   not a block barrier), and P.V reads it back as broadcasts.
// Rows must lie on 16 bytes: the wrapper (ops/attention.py) copies a view
// that does not, and pads D to a multiple of 4.  After, on the same card:
// 0.1014 ms at JASCO's shape (SDPA 0.1102), 2.118 ms at the shape above
// (SDPA 2.296); 8-row tiles on 2 warps a block took 0.121-0.128 and 2.07-2.16.
#include <math.h>

#include "attention_common.cuh"

namespace {

// ---------------------------------------------------------------- bf16, mma.sync

// (x, y) as a bf16 pair hi and the bf16 pair of what hi leaves out, lo
__device__ __forceinline__ void split(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h2);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack(x - f.x, y - f.y);
}

constexpr int kWarpsFwd = 8;   // warps per block, 16 queries each
constexpr int kStagesFwd = 2;  // stages of the K/V ring

// Shared memory of a block: a ring of kStagesFwd stages of K and V tiles,
// then the block's q tile
template <int DP>
constexpr size_t smem_fwd_bf16() {
  return sizeof(bf16) * (2 * kStagesFwd * tile_elems<DP>() + 16 * kWarpsFwd * (DP + 8));
}

// Blocks an SM asks of the register allocator: 16 warps an SM up to D = 64,
// so at most 128 registers a thread (left to itself it takes more, which
// leaves 12 warps an SM; at 128 a few bytes spill, as phase 2 of
// chip_smoke.py prints); D = 128 needs about 230.
template <int DP>
constexpr int min_blocks() { return DP <= 64 ? 16 / kWarpsFwd : 1; }

template <int DP>
__global__ void __launch_bounds__(32 * kWarpsFwd, min_blocks<DP>())
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, Strides qs_, Strides ks_, Strides vs_, int batch,
                      int seq, int heads, int dim, float scale, int causal) {
  constexpr int LD = DP + 8, KS = DP / 16, NT = DP / 8, STAGES = kStagesFwd;
  constexpr int ROWS = 16 * kWarpsFwd, THREADS = 32 * kWarpsFwd;
  static_assert(STAGES >= 2, "the ring refills the stage read one tile before");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);  // stage s: K at 2s, V at 2s + 1
  auto k_at = [&](int s) { return tiles + 2 * s * tile_elems<DP>(); };
  auto v_at = [&](int s) { return tiles + (2 * s + 1) * tile_elems<DP>(); };
  bf16* own_q = k_at(STAGES);

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, g = lane / 4, tig = lane % 4;
  const Lanes L(lane);
  const int bh = blockIdx.x % (batch * heads), rank = blockIdx.x / (batch * heads);
  const int b = bh / heads, h = bh % heads;
  // causal: the last query tile, which sees every key tile, runs first
  const int q0 = (causal ? (seq + ROWS - 1) / ROWS - 1 - rank : rank) * ROWS;
  const int row0 = q0 + 16 * w;  // the warp's rows: row0 + g and row0 + g + 8
  const int n_tiles = (seq + kRows - 1) / kRows;
  const int count = causal ? min(n_tiles, (q0 + ROWS) / kRows) : n_tiles;  // key tiles
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs_.b + h * vs_.h;

  auto load_keys = [&](int s, int i) {
    load_tile<DP, kRows, THREADS>(k_at(s), kb, ks_.t, i * kRows, seq, dim);
    load_tile<DP, kRows, THREADS>(v_at(s), vb, vs_.t, i * kRows, seq, dim);
  };

  load_tile<DP, ROWS, THREADS>(own_q, q + b * qs_.b + h * qs_.h, qs_.t, q0, seq, dim);
  cp_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < count) load_keys(s, s);
    cp_commit();
  }
  cp_wait<STAGES - 1>();
  scale_tile<DP, ROWS, THREADS>(own_q, scale);
  __syncthreads();
  uint32_t qa[KS][4];  // A fragments of the warp's 16 scaled queries
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm(qa[kk], own_q + (16 * w + L.ra) * LD + 16 * kk + L.ca);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < count; ++i) {
    const int s = i % STAGES;
    cp_wait<STAGES - 2>();
    __syncthreads();  // tile i is in; every warp is done with the stage refilled next
    if (i + STAGES - 1 < count) load_keys((i + STAGES - 1) % STAGES, i + STAGES - 1);
    cp_commit();

    const int k0 = i * kRows;
    const bool diag = causal && k0 + kRows > q0;  // the tile crosses the diagonal
    // every key of the tile after the warp's rows: nothing to add
    if (diag && k0 > row0 + 15) continue;
    const bool edge = diag || k0 + kRows > seq;
    const bf16* kt = k_at(s);
    const bf16* vt = v_at(s);
    // chunk c (keys k0 + 16 c ..) lies wholly after the warp's rows: P is 0 there
    auto after = [&](int c) { return diag && k0 + 16 * c > row0 + 15; };

    float sc[kRows / 8][4];  // S: [query][key], 8 keys per fragment
#pragma unroll
    for (int c = 0; c < kRows / 16; ++c) {  // 16 keys at a time
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[2 * c][e] = sc[2 * c + 1][e] = 0.f;
      if (after(c)) continue;  // masked below
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t f[4];
        ldsm(f, kt + (16 * c + L.rb) * LD + 16 * kk + L.cb);
        mma(sc[2 * c], qa[kk], f[0], f[1]);
        mma(sc[2 * c + 1], qa[kk], f[2], f[3]);
      }
    }
    if (edge) {
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * tig + (e & 1), query = row0 + g + 8 * (e >> 1);
          if (key >= seq || (causal && key > query)) sc[j][e] = -INFINITY;
        }
    }

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // accumulator elements 2r, 2r + 1 are row r
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float mb = (m_new == -INFINITY ? 0.f : m_new) * kLog2e;
      alpha[r] = exp2_ftz(fmaf(m[r], kLog2e, -mb));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = sc[j][2 * r + c];
          x = exp2_ftz(fmaf(x, kLog2e, -mb));
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

#pragma unroll
    for (int c = 0; c < kRows / 16; ++c) {  // 16 keys at a time
      if (after(c)) continue;
      // the score fragments of keys 16 c .. 16 c + 15 are the A fragment;
      // P = hi + lo in two bf16 parts keeps about 16 bits of each probability
      uint32_t hi[4], lo[4];
      split(sc[2 * c][0], sc[2 * c][1], hi[0], lo[0]);
      split(sc[2 * c][2], sc[2 * c][3], hi[1], lo[1]);
      split(sc[2 * c + 1][0], sc[2 * c + 1][1], hi[2], lo[2]);
      split(sc[2 * c + 1][2], sc[2 * c + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int n = 0; n < NT / 2; ++n) {  // 16 features at a time
        uint32_t f[4];
        ldsm_t(f, vt + (16 * c + L.ra) * LD + 16 * n + L.ca);
        mma(acc[2 * n], hi, f[0], f[1]);
        mma(acc[2 * n + 1], hi, f[2], f[3]);
        mma(acc[2 * n], lo, f[0], f[1]);
        mma(acc[2 * n + 1], lo, f[2], f[3]);
      }
    }
  }
  cp_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    const int t = row0 + g + 8 * r;
    if (lse != nullptr && tig == 0 && t < seq)
      lse[((size_t)b * heads + h) * seq + t] = l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] *= inv[0];
    acc[n][1] *= inv[0];
    acc[n][2] *= inv[1];
    acc[n][3] *= inv[1];
  }
  store_rows<DP>(o, acc, row0, g, tig, b, h, seq, heads, dim, 1.f);
}

// ---------------------------------------------------------------- fp32, FMA

constexpr int kRowsF32 = 64;      // query rows of a block: 4 warps of 16
constexpr int kKeysF32 = 32;      // keys of a streamed K / V tile
constexpr int kThreadsF32 = 128;
constexpr int kWarpsF32 = kThreadsF32 / 32;

// Shared floats of a block: q^T [DP][64], a ring of 2 stages of K [32][DP]
// and V [32][DP], each warp's P^T [32 keys][16 rows] (ops/attention.py:
// fwd_f32_geometry computes the same).  57,344 bytes at DP = 64: four
// blocks (16 warps) an SM.
template <int DP>
constexpr size_t smem_floats_f32() {
  return (size_t)DP * kRowsF32 + 2 * kKeysF32 * 2 * DP + kWarpsF32 * kKeysF32 * 16;
}

// Lane l of warp w owns query rows 16 w + 4 (l / 8) .. + 3 of the block, keys
// l % 8 + 8 j (j < 4) of each tile for S = q K^T, and features 4 (l % 8) +
// 32 u .. + 3 (u < DP / 32) for P.V.  S takes, for 4 features at a time, one
// 128-bit load of each of its 4 keys (K rows swizzled, so that the 8 keys a
// warp's load reads lie on distinct banks) and one of q^T for each feature:
// 64 FMAs per 8 loads.  The probabilities leave registers once, into the
// warp's P^T rows (a 128-bit store a key, the 8 lanes of a key group on
// distinct banks); P.V takes, per key, one 128-bit load of P^T (a broadcast)
// and DP / 32 of V: 4 DP / 8 FMAs per 1 + DP / 32 loads.
template <int DP>
__global__ void __launch_bounds__(kThreadsF32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strides qs_, Strides ks_, Strides vs_, int batch,
                     int seq, int heads, int dim, float scale, int causal) {
  constexpr int TD = DP / 8, NU = DP / 32;
  constexpr int STAGE = 2 * kKeysF32 * DP;         // K then V
  constexpr int PIECES = kKeysF32 * DP / 4;        // 16-byte copies of one K (or V) tile
  extern __shared__ __align__(16) float smem_f32[];
  float* qt = smem_f32;                            // [DP][64]: q * scale * log2(e)
  float* ring = qt + DP * kRowsF32;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, kg = lane % 8, rg = lane / 8;
  float* pt = ring + 2 * STAGE + w * kKeysF32 * 16;     // this warp's P^T [key][row]
  const int bh = blockIdx.x % (batch * heads), rank = blockIdx.x / (batch * heads);
  const int b = bh / heads, h = bh % heads;
  const int tiles_q = (seq + kRowsF32 - 1) / kRowsF32;
  // causal: the last query tile, which sees every key tile, runs first
  const int q0 = (causal ? tiles_q - 1 - rank : rank) * kRowsF32;
  const int row0 = 16 * w + 4 * rg;                // the lane's first row in the block
  const int n_tiles = (seq + kKeysF32 - 1) / kKeysF32;
  const int count = causal ? min(n_tiles, (q0 + kRowsF32) / kKeysF32) : n_tiles;
  const float* kb = k + b * ks_.b + h * ks_.h;
  const float* vb = v + b * vs_.b + h * vs_.h;

  // key tile i into stage s: 16-byte copies, rows past seq and features past dim zero
  auto load_kv = [&](int s, int i) {
    float* kt = ring + s * STAGE;
    float* vt = kt + kKeysF32 * DP;
#pragma unroll
    for (int e0 = 0; e0 < PIECES; e0 += kThreadsF32) {
      const int e = e0 + tid, r = e / (DP / 4), c = 4 * (e % (DP / 4)), t = i * kKeysF32 + r;
      const bool in = t < seq && c < dim;
      cp_async16(kt + r * DP + swz(r, c / 4), in ? kb + t * ks_.t + c : kb, in);
      cp_async16(vt + r * DP + c, in ? vb + t * vs_.t + c : vb, in);
    }
  };
  if (count > 0) load_kv(0, 0);
  cp_commit();

  // q^T, scaled once: thread tid takes block row tid % 64, half of its features
  {
    const int r = tid % kRowsF32, t = q0 + r;
    const float* qrow = q + b * qs_.b + t * qs_.t + h * qs_.h;
#pragma unroll 4
    for (int c = 4 * (tid / kRowsF32); c < DP; c += 8) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < seq && c < dim) x = *reinterpret_cast<const float4*>(qrow + c);
      qt[(c + 0) * kRowsF32 + r] = (x.x * scale) * kLog2e;
      qt[(c + 1) * kRowsF32 + r] = (x.y * scale) * kLog2e;
      qt[(c + 2) * kRowsF32 + r] = (x.z * scale) * kLog2e;
      qt[(c + 3) * kRowsF32 + r] = (x.w * scale) * kLog2e;
    }
  }

  // running max (base 2) and sum of each of the lane's 4 rows, its outputs
  float m[4], l[4], acc[4][TD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int f = 0; f < TD; ++f) acc[i][f] = 0.f;
  }

  for (int i = 0; i < count; ++i) {
    cp_wait<0>();
    __syncthreads();   // tile i is in; every warp is done with the stage refilled next
    if (i + 1 < count) load_kv((i + 1) & 1, i + 1);
    cp_commit();

    const int k0 = i * kKeysF32;
    // every key of the tile after the warp's rows: nothing to add
    if (causal && k0 > q0 + 16 * w + 15) continue;
    const float* kt = ring + (i & 1) * STAGE;
    const float* vt = kt + kKeysF32 * DP;

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      float kk[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(kt + (kg + 8 * j) * DP + swz(kg, c / 4));
        kk[j][0] = x.x, kk[j][1] = x.y, kk[j][2] = x.z, kk[j][3] = x.w;
      }
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const float4 x = *reinterpret_cast<const float4*>(qt + (c + dd) * kRowsF32 + row0);
        const float a[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[r][j] = fmaf(a[r], kk[j][dd], s[r][j]);
      }
    }
    if (k0 + kKeysF32 > seq || (causal && k0 + kKeysF32 - 1 > q0 + row0)) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + kg + 8 * j;
          if (key >= seq || (causal && key > q0 + row0 + r)) s[r][j] = -INFINITY;
        }
    }

    // online softmax in base 2 (the scores carry log2(e)); a row whose keys
    // so far are all masked keeps max -inf and takes its exponentials
    // against 0
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      const float mb = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2_ftz(m[r] - mb);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = exp2_ftz(s[r][j] - mb);
        sum += s[r][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int f = 0; f < TD; ++f) acc[r][f] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (kg + 8 * j) * 16 + 4 * rg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();

#pragma unroll 8
    for (int key = 0; key < kKeysF32; ++key) {
      const float4 x = *reinterpret_cast<const float4*>(pt + key * 16 + 4 * rg);
      const float p[4] = {x.x, x.y, x.z, x.w};
      float vv[TD];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float4 y = *reinterpret_cast<const float4*>(vt + key * DP + 32 * u + 4 * kg);
        vv[4 * u] = y.x, vv[4 * u + 1] = y.y, vv[4 * u + 2] = y.z, vv[4 * u + 3] = y.w;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int f = 0; f < TD; ++f) acc[r][f] = fmaf(p[r], vv[f], acc[r][f]);
    }
    __syncwarp();   // P^T is read before the next tile's scores overwrite it
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + row0 + r;
    if (t >= seq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    if (lse != nullptr && kg == 0)   // natural units: (m + log2 l) ln 2
      lse[((size_t)b * heads + h) * seq + t] =
          l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f : -INFINITY;
    float* row = o + (((size_t)b * seq + t) * heads + h) * dim;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int d = 32 * u + 4 * kg;
      if (d < dim)
        *reinterpret_cast<float4*>(row + d) = make_float4(
            acc[r][4 * u] * inv, acc[r][4 * u + 1] * inv, acc[r][4 * u + 2] * inv,
            acc[r][4 * u + 3] * inv);
    }
  }
}

// ---------------------------------------------------------------- launch

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;  // [B, H, T] or null
  int batch, seq, heads, dim;
  Strides qs, ks, vs;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int DP>
auto fwd_bf16() {
  return make_launch(flash_fwd_bf16_kernel<DP>, 32 * kWarpsFwd, smem_fwd_bf16<DP>());
}

template <int DP>
int launch_bf16(const Args& a) {
  if (a.dim % 8 != 0 || !rows_aligned(a.q, a.qs) || !rows_aligned(a.k, a.ks) ||
      !rows_aligned(a.v, a.vs))
    return (int)cudaErrorMisalignedAddress;
  // one block per (tile of query rows, batch, head), batch * head fastest
  constexpr int rows = 16 * kWarpsFwd;
  const long long blocks = (long long)((a.seq + rows - 1) / rows) * a.batch * a.heads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto l = fwd_bf16<DP>();
  const cudaError_t err = l.prepare();
  if (err != cudaSuccess) return (int)err;
  l.kernel<<<(unsigned)blocks, l.threads, l.smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.qs, a.ks, a.vs,
      a.batch, a.seq, a.heads, a.dim, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <int DP>
auto fwd_f32() {
  return make_launch(flash_fwd_f32_kernel<DP>, kThreadsF32, sizeof(float) * smem_floats_f32<DP>());
}

template <int DP>
int launch_f32(const Args& a) {
  if (a.dim % 4 != 0 || !rows_aligned(a.q, a.qs, 4) || !rows_aligned(a.k, a.ks, 4) ||
      !rows_aligned(a.v, a.vs, 4) || reinterpret_cast<uintptr_t>(a.o) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  // one block per (tile of query rows, batch, head), batch * head fastest
  const long long blocks =
      (long long)((a.seq + kRowsF32 - 1) / kRowsF32) * a.batch * a.heads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto l = fwd_f32<DP>();
  const cudaError_t err = l.prepare();
  if (err != cudaSuccess) return (int)err;
  l.kernel<<<(unsigned)blocks, l.threads, l.smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.qs, a.ks, a.vs,
      a.batch, a.seq, a.heads, a.dim, a.scale, a.causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int acx_attention_max_dim() { return kMaxDim; }

// q, k, v: [B, T, H, D] views with contiguous D and the given element strides
// (batch, time, head); o: contiguous [B, T, H, D].  All four in one dtype (bf16
// when is_bf16, else fp32); in bf16, D a multiple of 8 and every row on 16
// bytes (else cudaErrorMisalignedAddress).  Scores use q * scale; causal
// masks keys after the query.  lse: contiguous fp32 [B, H, T] for each row's log-sum-exp, or null.
extern "C" int acx_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                 float* lse, int batch, int seq, int heads, int dim,
                                 long long q_sb, long long q_st, long long q_sh,
                                 long long k_sb, long long k_st, long long k_sh,
                                 long long v_sb, long long v_st, long long v_sh,
                                 float scale, int causal, int is_bf16, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || heads > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, batch, seq, heads, dim, {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh},
               {v_sb, v_st, v_sh}, scale, causal, (cudaStream_t)stream};
  return by_width(dim, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return is_bf16 ? launch_bf16<DP>(a) : launch_f32<DP>(a);
  });
}

// What the forward kernel for (head width dim, dtype) uses, into out[5]:
// registers per thread, shared memory per block (bytes), blocks resident per
// SM, threads per block, local (spilled) bytes per thread.
extern "C" int acx_attention_fwd_info(int dim, int is_bf16, int* out) {
  return by_width(dim, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return is_bf16 ? describe(fwd_bf16<DP>(), out) : describe(fwd_f32<DP>(), out);
  });
}
