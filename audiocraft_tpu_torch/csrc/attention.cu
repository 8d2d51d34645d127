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
// fp32 (the parity path): fp32 FMA outside the tensor cores, so its ceiling
// is the fp32 rate (1.1 ms at the shape above).  256 threads: thread
// (ty, tx) owns query rows 4 ty .. 4 ty + 3, key columns tx + 16 j of a
// tile and output features tx + 16 c; probabilities go through shared
// memory into P.V.
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

// 2^x, with a result below 2^-126 flushed to 0: exp2f's care for such
// results (about three more instructions an exponential) buys nothing here,
// where every exponential is taken against the row's running max, whose own
// weight of 1 is in the same fp32 sum.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

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

constexpr int kRowsQ = kRows;  // query rows per block
constexpr int kRowsK = kRows;  // key and value rows per streamed tile
constexpr int kThreadsF32 = 256;  // 16 x 16 threads: 4 query rows x 4 keys each

template <int DP>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * (3 * kRowsQ * (DP + 1) + kRowsQ * (kRowsK + 1));
}

template <int DP>
__global__ void __launch_bounds__(kThreadsF32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strides qs_,
                     Strides ks_, Strides vs_, int seq, int heads, int dim, float scale,
                     int causal) {
  constexpr int LD = DP + 1;  // padded rows: the 16 key rows a half-warp reads hit 16 banks
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;                  // [kRowsQ][LD], pre-scaled
  float* ks = qs + kRowsQ * LD;      // [kRowsK][LD]
  float* vs = ks + kRowsK * LD;      // [kRowsK][LD]
  float* ps = vs + kRowsK * LD;      // [kRowsQ][kRowsK + 1]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int tx = lane % 16;
  const int ty = (tid / 32) * 2 + lane / 16;
  const int q0 = blockIdx.x * kRowsQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * qs_.b + h * qs_.h;
  const float* kb = k + b * ks_.b + h * ks_.h;
  const float* vb = v + b * vs_.b + h * vs_.h;

  for (int e = tid; e < kRowsQ * DP; e += kThreadsF32) {
    const int r = e / DP, d = e % DP, t = q0 + r;
    qs[r * LD + d] = (t < seq && d < dim) ? qb[t * qs_.t + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(seq, q0 + kRowsQ) : seq;
  for (int k0 = 0; k0 < k_end; k0 += kRowsK) {
    __syncthreads();  // the previous tile's P.V is done with ks, vs and ps
    for (int e = tid; e < kRowsK * DP; e += kThreadsF32) {
      const int r = e / DP, d = e % DP, s = k0 + r;
      const bool in = s < seq && d < dim;
      ks[r * LD + d] = in ? kb[s * ks_.t + d] : 0.f;
      vs[r * LD + d] = in ? vb[s * vs_.t + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(4 * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = k0 + tx + 16 * j;
        if (s >= seq || (causal && s > t)) sc[i][j] = -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_use);
        ps[(4 * ty + i) * (kRowsK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int s = 0; s < kRowsK; ++s) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(4 * ty + i) * (kRowsK + 1) + s];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[s * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + 4 * ty + i;
    if (t >= seq) continue;
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * heads + h) * seq + t] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    float* row = o + (((size_t)b * seq + t) * heads + h) * dim;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < dim) row[d] = l[i] > 0.f ? acc[i][c] / l[i] : 0.f;
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
  return make_launch(flash_fwd_f32_kernel<DP>, kThreadsF32, smem_bytes_f32<DP>());
}

template <int DP>
int launch_f32(const Args& a) {
  const auto l = fwd_f32<DP>();
  const cudaError_t err = l.prepare();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.seq + kRowsQ - 1) / kRowsQ, a.heads, a.batch);
  l.kernel<<<grid, l.threads, l.smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.qs, a.ks, a.vs, a.seq,
      a.heads, a.dim, a.scale, a.causal);
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
