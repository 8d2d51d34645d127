// One LSTM layer's recurrence, all T steps in one persistent cooperative
// launch (kernel K2).
//
// Replaces audiocraft_tpu/ops/lstm_pallas.py:_lstm_kernel, which runs all T
// steps of a layer in one TPU program with W_hh^T resident in VMEM.  For
// t = 0 .. T-1:
//     gates = gx[t] + h[t-1] . W_hh^T      (gate order i, f, g, o; h[-1] = 0)
//     c     = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h[t]  = sigmoid(o) * tanh(c)
// Gates and c are fp32; h is stored in the compute dtype (fp32 or bf16) in
// out[t], and step t + 1 reads that rounded value back, as the TPU kernel does.
//
// Bound on an H100: the step product is 2*B*H*4H operations (537 GFLOP a
// layer at T = 500, B = 128, H = 1024, 0.54 ms at the bf16 tensor-core rate),
// but the steps are sequential and each needs all of h[t-1], which every
// block wrote a slice of: what bounds a step is moving h (B*H in the dtype,
// 256 KB at B = 128) from L2 into every block, and the grid-wide barrier
// between steps (at B = 4 nearly all of a step).
//
// Design.  W_hh^T does not fit one SM (8 MB in bf16 at H = 1024), so it is
// split across the card: the grid has at most one block per SM, and each
// block owns U hidden units j0 .. j0+U-1 and all four of their gate rows of
// W_hh (4U x H), for one group of batch rows.  The block keeps that slice in
// shared memory for the whole launch (64 KB in bf16 at U = 8, H = 1024,
// 128 KB at U = 16 or in fp32 at U = 8), so W_hh is read from device memory
// once per layer, and the cell update of its units needs nothing from
// another block.  The plan doubles U while the slice stays resident and the
// freed SMs split the batch into groups of at least 16 rows: a block then
// reads only its rows of h each step, which is what bounds a step at large
// B (at B = 128, H = 1024 in bf16: 64 unit groups of 16 x 2 batch groups of
// 64 rows, against 128 x 8 units for all 128 rows).  c of the block's
// (b, j) pairs stays in shared memory for the whole launch: there is no c
// buffer in device memory.  Each step, each block:
//   1. streams its rows of h[t-1] (out[t-1], [B, H]) through a ring of up
//      to kMaxStages shared-memory stages, K-chunks of kc features for nb
//      batch rows each, with cp.async.cg: the copies bypass L1, since
//      another SM wrote h;
//   2. forms the [4U, nb] gate pre-activations of each batch tile of nb rows
//      (below) and adds gx[t];
//   3. updates c and writes its slice of h[t] into out[t];
//   4. arrives at a grid-wide barrier (after a block barrier, one thread's
//      red.release.gpu on a counter), starts an asynchronous copy of its
//      gx[t+1] slice (its rows x 4U, read-only) into shared memory, which lands
//      while the other blocks arrive, and waits for the count (one thread's
//      ld.acquire.gpu spin, then a block barrier) before step t + 1.
// The launch is cooperative (cudaLaunchCooperativeKernel), so the runtime
// guarantees that all blocks are resident at once or refuses the launch;
// a refusal is an error code that the wrapper raises.  The counter is a
// fresh zero from the wrapper and only grows: step t waits for (t+1) * grid.
// A spin that lasts longer than kSpinLimitNs traps, so that a fault shows as
// a launch error and not as a hung card.
//
// The product, per batch tile: M = the 4U gate rows (row g*U + u of the
// slice is gate g of unit j0 + u), N = the batch (nb a power of two times 8),
// K = H.  Gate rows on M and the batch on N, because U is fixed by H and the
// SM count while B runs from 2 to 128: an m16n8k16 tile wastes at most 4 of
// 8 columns at B = 4, where batch rows on M would waste 12 of 16.  The 8
// warps split the (m16, n8) tiles and, when there are fewer than 8 n-tiles
// (B <= 32), split K too.  Up to U = 16 a warp holds all U/4 m-tiles, so
// each lane's accumulators hold all four gates of its units (at U = 4 after
// one shuffle) and the cell update runs on them in registers; split-K
// partials are summed into the K-split-0 warp through shared memory in a
// fixed order.  Above U = 16 the warps split the m-tiles too and the
// pre-activations go through shared memory to a thread per (b, j) pair.
// The kernel is instantiated for each warp tile shape (MI m-tiles x NI
// n-tiles, MI * NI <= 4), so the fragment loops unroll and each lane's
// shared-memory fragment addresses are computed once per launch.
//   - bf16: mma.sync m16n8k16, bf16 in and fp32 accumulate, A fragments by
//     ldmatrix from the resident W rows, B fragments by ldmatrix from the h
//     rows (both row-major in K).  A product of two bf16 values is exact in
//     fp32, so the result differs from the plain version's fp32 product only
//     in the order of the sums.
//   - fp32: fp32 FMA on the same tiles and fragment layout, 16-byte
//     shared-memory reads; no TF32 and no bf16 split (TF32 changes tokens).
// Rows are padded by 16 bytes in shared memory, so the eight rows that one
// ldmatrix phase or one quarter-warp reads fall in distinct banks.
//
// Where the resident slice does not fit beside the ring (fp32 at H >= 2048),
// the plan streams W's slice through the same ring stages with h, chunk by
// chunk, every step: still one launch and one barrier a step.  The launch
// plan (U, batch groups, grid, nb, kc, ring depth, resident, shared-memory
// bytes) is computed by ops/lstm.py:lstm_plan; the kernel recomputes the
// bytes and refuses a plan that disagrees.  Ragged units (H not a multiple
// of U) and batch rows are masked here: their weights and h rows are
// zero-filled, their outputs not written.  16-byte copies need H * sizeof(dtype) to be a
// multiple of 16; other H take element copies through the same ring.
//
// What holds it back (chip_smoke.py phase 2 times a step at B = 4 to 128):
// at B = 4 a step is a few microseconds of latency (the h load from L2, the
// product, the cell update, the barrier's round trips); from B = 32 up the
// step grows with B, as the bytes of h that a block reads from L2 do, and
// every warp re-reads its W fragments from shared memory at every K step.
// A cluster multicast of h (TMA or DSMEM), which would cut the L2 traffic,
// is left for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 4;  // deepest cp.async ring
constexpr int kMaxTiles = 4;   // (m16, n8) accumulator tiles a warp holds
constexpr int kAlign = 128;    // byte alignment of each shared-memory region
constexpr long long kSpinLimitNs = 10000000000LL;  // 10 s at one barrier

__host__ __device__ constexpr int pad_of(int elt) { return 16 / elt; }
__host__ __device__ constexpr long long align_up(long long x) {
  return (x + kAlign - 1) / kAlign * kAlign;
}

// The launch plan as the kernel reads it; see ops/lstm.py:lstm_plan.
struct Plan {
  int units, grid, nb, kc, resident, stages;
  int ugroups;       // blocks over the units: block k owns units (k % ugroups) * U ..
  int brows;         // batch rows a block owns: rows (k / ugroups) * brows ..
  int kp;            // H rounded up to 16
  int wm, wn, ks;    // warps over m-tiles, over n-tiles, over K
  int ld_w, ld_h;    // shared row strides, in elements
  int ld_pre;        // row stride of the fp32 partials
  long long off_ring, off_pre, off_gx, off_c, bytes;
  long long stage_elems;  // elements of one ring stage (h rows, then W rows when streamed)
};

// ops/lstm.py:_smem_bytes computes the same shared-memory bytes for the plan,
// and launch() refuses a plan whose bytes differ: change the two together
// (tests/test_torch_lstm_plan.py pins the bytes of the plans chip_smoke.py
// launches).
__host__ __device__ inline Plan make_plan(int batch, int hidden, int elt, int units, int nb,
                                          int kc, int resident, int stages, int bgroups) {
  Plan p;
  p.units = units;
  p.ugroups = (hidden + units - 1) / units;
  p.brows = (batch + bgroups - 1) / bgroups;
  p.grid = p.ugroups * bgroups;
  p.nb = nb;
  p.kc = kc;
  p.resident = resident;
  p.kp = (hidden + 15) / 16 * 16;
  const int mt = units / 4, nt = nb / 8;
  p.wm = mt <= 4 ? 1 : (mt < kWarps ? mt : kWarps);  // 1: a warp holds all gates of its units
  p.wn = nt < kWarps / p.wm ? nt : kWarps / p.wm;
  p.ks = kWarps / (p.wm * p.wn);
  const int pad = pad_of(elt), rows = 4 * units;
  p.ld_w = (resident ? p.kp : kc) + pad;
  p.ld_h = kc + pad;
  const int chunks = (p.kp + kc - 1) / kc;
  p.stages = chunks < stages ? chunks : stages;
  p.stage_elems = (long long)nb * p.ld_h + (resident ? 0 : (long long)rows * p.ld_w);
  const long long w_bytes = resident ? align_up((long long)rows * p.ld_w * elt) : 0;
  p.off_ring = w_bytes;
  p.off_pre = p.off_ring + align_up((long long)p.stages * p.stage_elems * elt);
  p.ld_pre = nb + 4;
  // partials: split-K warps' fragments when a warp holds all gates, else
  // every K split's pre-activations, [ks][4U][nb + 4]
  const long long pre_floats = p.wm == 1 ? (long long)(p.ks - 1) * p.wn * (mt / p.wm) *
                                               (nt / p.wn) * 128
                                         : (long long)p.ks * rows * p.ld_pre;
  p.off_gx = p.off_pre + align_up(pre_floats * 4);
  p.off_c = p.off_gx + align_up((long long)p.brows * rows * elt);
  p.bytes = p.off_c + align_up((long long)p.brows * units * 4);
  return p;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global (L2 only) to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 8 bytes from global to shared memory (through L1: read-only input)
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// This thread's copies but the newest n groups have landed (n < kMaxStages)
__device__ __forceinline__ void cp_wait_n(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    default: cp_wait<3>(); break;
  }
}

// Element copy for H that 16-byte copies do not fit; bypasses L1 too.
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ bf16 ld_cg(const bf16* p) {
  const unsigned short v = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return *reinterpret_cast<const bf16*>(&v);
}

// rows x [k0, k0 + kc) of a row-major [*, H] global matrix into dst (row
// stride ld), row r taken from global row row_of(r), or zeros where the row
// is invalid (row_of < 0) or k >= H.
template <typename T, typename RowOf>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int rows, int k0, int kc,
                                          int hidden, bool vec, RowOf row_of) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = kc / V;
    for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
      const int r = e / per_row, k = k0 + (e % per_row) * V;
      const long long g = row_of(r);
      const bool ok = g >= 0 && k < hidden;
      cp_async16(dst + (long long)r * ld + (k - k0), ok ? src + g * hidden + k : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * kc; e += kThreads) {
      const int r = e / kc, k = k0 + e % kc;
      const long long g = row_of(r);
      dst[(long long)r * ld + (k - k0)] =
          (g >= 0 && k < hidden) ? ld_cg(src + g * hidden + k) : T(0.f);
    }
  }
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices; lane i gives the address of row i % 8 of matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// Byte offsets of this lane's fragment rows: A (W rows) of m-tile m, B (h
// rows) of n-tile n, in the mma layout.  bf16: ldmatrix addresses (lane l:
// row l % 16 of A at column (l / 16) * 8; row l % 8 of B at column
// ((l / 8) % 2) * 8).  fp32: the rows the lane's accumulators need (A row
// l / 4, the second 8 rows below; B rows 2 (l % 4) and the next).
template <typename T>
__device__ __forceinline__ uint32_t a_offset(int m, int ld_w) {
  const int lane = threadIdx.x % 32;
  if constexpr (sizeof(T) == 2)
    return ((m * 16 + lane % 16) * ld_w + (lane / 16) * 8) * 2;
  else
    return (m * 16 + lane / 4) * ld_w * 4;
}

template <typename T>
__device__ __forceinline__ uint32_t b_offset(int n, int ld_h) {
  const int lane = threadIdx.x % 32;
  if constexpr (sizeof(T) == 2)
    return ((n * 8 + lane % 8) * ld_h + ((lane / 8) % 2) * 8) * 2;
  else
    return (n * 8 + 2 * (lane % 4)) * ld_h * 4;
}

// The warp's K steps s0, s0 + ks, ... < steps of one chunk: acc[i][j] +=
// W rows of m-tile i . h rows of n-tile j, from shared addresses w and h at
// the chunk's first feature.  acc[i][j] is an m16n8 accumulator in the mma
// layout: lane l holds rows l/4 and l/4 + 8, columns 2(l%4) and 2(l%4) + 1.
template <typename T, int MI, int NI>
__device__ __forceinline__ void chunk_product(float (&acc)[MI][NI][4], uint32_t w, int ld_w,
                                              uint32_t h, int ld_h, const uint32_t (&ao)[MI],
                                              const uint32_t (&bo)[NI], int s0, int steps,
                                              int ks) {
  for (int s = s0; s < steps; s += ks) {
    if constexpr (sizeof(T) == 2) {
      const uint32_t k = s * 32;  // 16 bf16
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldsm_x4(a[i], w + ao[i] + k);
#pragma unroll
      for (int j = 0; j < NI; ++j) ldsm_x2(b[j], h + bo[j] + k);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma(acc[i][j], a[i], b[j][0], b[j][1]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // 4 features at a time
        const uint32_t k = s * 64 + q * 16;
        float4 a[MI][2], b[NI][2];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          a[i][0] = lds128(w + ao[i] + k);
          a[i][1] = lds128(w + ao[i] + 8 * ld_w * 4 + k);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          b[j][0] = lds128(h + bo[j] + k);
          b[j][1] = lds128(h + bo[j] + ld_h * 4 + k);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j) {
            const float av[2][4] = {{a[i][0].x, a[i][0].y, a[i][0].z, a[i][0].w},
                                    {a[i][1].x, a[i][1].y, a[i][1].z, a[i][1].w}};
            const float hv[2][4] = {{b[j][0].x, b[j][0].y, b[j][0].z, b[j][0].w},
                                    {b[j][1].x, b[j][1].y, b[j][1].z, b[j][1].w}};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              acc[i][j][0] = fmaf(av[0][kk], hv[0][kk], acc[i][j][0]);
              acc[i][j][1] = fmaf(av[0][kk], hv[1][kk], acc[i][j][1]);
              acc[i][j][2] = fmaf(av[1][kk], hv[0][kk], acc[i][j][2]);
              acc[i][j][3] = fmaf(av[1][kk], hv[1][kk], acc[i][j][3]);
            }
          }
      }
    }
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// gx[t]'s slice of this block, rows bs .. bs + nbr - 1 of [B, 4U] in the
// dtype, into shared memory:
// asynchronous copies of 16 bytes, or 8 where a gate's U units are 8 bytes
// (4 bf16), when H fits 16-byte copies; else element loads.
template <typename T>
__device__ __forceinline__ void load_gx(T* gxs, const T* gx, int t, int batch, int bs, int nbr,
                                        int hidden, int units, int j0, bool vec) {
  const int rows = 4 * units;
  const T* src = gx + ((long long)t * batch + bs) * 4 * hidden;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int piece = units < V ? units : V;  // elements a copy moves
    const int per_row = rows / piece;
    for (int e = threadIdx.x; e < nbr * per_row; e += kThreads) {
      const int b = e / per_row, r = (e % per_row) * piece, g = r / units, u = r % units;
      const bool ok = j0 + u < hidden;
      const T* from = ok ? src + (long long)b * 4 * hidden + (long long)g * hidden + j0 + u : gx;
      if (piece == V)
        cp_async16(gxs + (long long)b * rows + r, from, ok);
      else
        cp_async8(gxs + (long long)b * rows + r, from, ok);
    }
  } else {
    for (int e = threadIdx.x; e < nbr * rows; e += kThreads) {
      const int b = e / rows, r = e % rows, g = r / units, u = r % units;
      gxs[e] = j0 + u < hidden ? src[(long long)b * 4 * hidden + (long long)g * hidden + j0 + u]
                               : T(0.f);
    }
  }
}

// The cell update of one (b, j) pair from its four fp32 pre-activations
// (gx + product): c in shared memory, h into out when the unit exists.
template <typename T>
__device__ __forceinline__ void cell(const float (&g4)[4], float* c, T* h, bool valid) {
  const float ig = sigmoid(g4[0]), fg = sigmoid(g4[1]), gg = tanhf(g4[2]), og = sigmoid(g4[3]);
  const float cn = fg * *c + ig * gg;
  *c = cn;
  if (valid) store(h, og * tanhf(cn));
}

// The cell update straight from a warp's accumulators, when the warp holds
// all 4U gate rows (MI = U / 4 m-tiles of gate-major rows g*U + u): lane l's
// rows 16 i + l/4 (+ 8) are, at U = 8, gates 2i and 2i + 1 of unit l/4; at
// U = 16, gate i of units l/4 and l/4 + 8; at U = 4 (one tile) gates i, g of
// unit l/4 on lanes l < 16 and f, o on lanes l + 16, exchanged by a shuffle.
// Columns: the lane's 2 (l % 4) and the next of each of its n-tiles.
template <typename T, int MI, int NI>
__device__ __forceinline__ void cell_update_regs(const float (&acc)[MI][NI][4], const T* gxs,
                                                 float* cs, T* h_out, int wn, int WN, int b0,
                                                 int bs, int be, int hidden, int units, int j0) {
  const int lane = threadIdx.x % 32, q = lane / 4, rows = 4 * units;
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int col = 0; col < 2; ++col) {
      const int b = b0 + (wn + WN * j) * 8 + 2 * (lane % 4) + col;
      constexpr int NU = MI == 4 ? 2 : 1;  // units a lane holds
      float g[NU][4];
      int unit[NU];
      if constexpr (MI == 1) {
        const float lo = acc[0][j][col], hi = acc[0][j][2 + col];
        const float lo2 = __shfl_xor_sync(0xffffffffu, lo, 16);
        const float hi2 = __shfl_xor_sync(0xffffffffu, hi, 16);
        g[0][0] = lo; g[0][1] = lo2; g[0][2] = hi; g[0][3] = hi2;
        unit[0] = q;
        if (q >= 4) continue;
      } else if constexpr (MI == 2) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          g[0][2 * i] = acc[i][j][col];
          g[0][2 * i + 1] = acc[i][j][2 + col];
        }
        unit[0] = q;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          g[0][i] = acc[i][j][col];
          g[1][i] = acc[i][j][2 + col];
        }
        unit[0] = q;
        unit[1] = q + 8;
      }
      if (b >= be) continue;
#pragma unroll
      for (int n = 0; n < NU; ++n) {
        const int u = unit[n];
        float g4[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) g4[k] = to_f32(gxs[(b - bs) * rows + k * units + u]) + g[n][k];
        cell(g4, cs + (b - bs) * units + u, h_out + (long long)b * hidden + j0 + u,
             j0 + u < hidden);
      }
    }
}

template <typename T, int MI, int NI>
__global__ void __launch_bounds__(kThreads, 1)
lstm_layer_kernel(const T* __restrict__ gx, const T* __restrict__ w_hh, T* out,
                  unsigned* barrier, int steps, int batch, int hidden, int units, int nb,
                  int kc, int resident, int stages, int bgroups) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan P = make_plan(batch, hidden, (int)sizeof(T), units, nb, kc, resident, stages,
                           bgroups);
  T* w_res = reinterpret_cast<T*>(smem);
  T* ring = reinterpret_cast<T*>(smem + P.off_ring);
  float* pre = reinterpret_cast<float*>(smem + P.off_pre);
  T* gxs = reinterpret_cast<T*>(smem + P.off_gx);
  float* cs = reinterpret_cast<float*>(smem + P.off_c);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = 4 * units, ushift = 31 - __clz(units);
  const int j0 = (blockIdx.x % P.ugroups) * units;
  const int bs = (blockIdx.x / P.ugroups) * P.brows;   // the block's batch rows bs .. be - 1
  const int be = min(batch, bs + P.brows), nbr = max(be - bs, 0);
  const bool vec = (hidden * (int)sizeof(T)) % 16 == 0;
  const int chunks = (P.kp + kc - 1) / kc;
  // W row of slice row r (gate r / U of unit j0 + r % U), or -1 past H
  auto w_row = [=](int r) -> long long {
    const int u = r & (units - 1);
    return j0 + u < hidden ? (long long)(r >> ushift) * hidden + j0 + u : -1;
  };

  // this warp's tiles: m-tiles wm + WM*i, n-tiles wn + WN*j, K steps wk + KS*s
  const int wm = warp % P.wm, wn = (warp / P.wm) % P.wn, wk = warp / (P.wm * P.wn);
  uint32_t ao[MI], bo[NI];
#pragma unroll
  for (int i = 0; i < MI; ++i) ao[i] = a_offset<T>(wm + P.wm * i, P.ld_w);
#pragma unroll
  for (int j = 0; j < NI; ++j) bo[j] = b_offset<T>(wn + P.wn * j, P.ld_h);
  const uint32_t ring_addr = smem_addr(ring), w_addr = smem_addr(w_res);
  const int stage_bytes = (int)(P.stage_elems * sizeof(T));

  if (resident) load_rows(w_res, P.ld_w, w_hh, rows, 0, P.kp, hidden, vec, w_row);
  load_gx(gxs, gx, 0, batch, bs, nbr, hidden, units, j0, vec);
  cp_commit();
  for (int e = tid; e < nbr * units; e += kThreads) cs[e] = 0.f;
  cp_wait<0>();
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const T* h_prev = out + (long long)(t - 1) * batch * hidden;
    for (int b0 = bs; b0 < be; b0 += nb) {
      if (t > 0) {  // h[-1] = 0: the product vanishes at t = 0
        float acc[MI][NI][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NI; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
        auto load_chunk = [&](int c) {
          T* st = ring + (long long)(c % P.stages) * P.stage_elems;
          const int k0 = c * kc;
          load_rows(st, P.ld_h, h_prev, nb, k0, kc, hidden, vec,
                    [=](int r) -> long long { return b0 + r < be ? b0 + r : -1; });
          if (!resident) load_rows(st + (long long)nb * P.ld_h, P.ld_w, w_hh, rows, k0, kc, hidden,
                                   vec, w_row);
        };
        // the groups before chunk c's, gx[t]'s among them, are complete
        // once chunk c's is
        for (int c = 0; c < P.stages - 1; ++c) {
          if (c < chunks) load_chunk(c);
          cp_commit();
        }
        for (int c = 0; c < chunks; ++c) {
          if (c + P.stages - 1 < chunks) load_chunk(c + P.stages - 1);
          cp_commit();
          cp_wait_n(P.stages - 1);
          __syncthreads();  // chunk c has landed, from every thread's copies
          const uint32_t h = ring_addr + (c % P.stages) * stage_bytes;
          const uint32_t w = resident ? w_addr + c * kc * (int)sizeof(T)
                                      : h + nb * P.ld_h * (int)sizeof(T);
          chunk_product<T, MI, NI>(acc, w, P.ld_w, h, P.ld_h, ao, bo, wk,
                                   min(kc, P.kp - c * kc) / 16, P.ks);
          __syncthreads();  // stage c % stages is free for chunk c + stages
        }
        if (P.wm == 1) {
          if (P.ks > 1) {  // split K: warps wk > 0 hand their partials to warp wk = 0
            const int slot = warp % P.wn;
            if (wk > 0) {
#pragma unroll
              for (int i = 0; i < MI; ++i)
#pragma unroll
                for (int j = 0; j < NI; ++j)
#pragma unroll
                  for (int q = 0; q < 4; ++q)
                    pre[((((wk - 1) * P.wn + slot) * MI + i) * NI + j) * 128 + q * 32 + lane] =
                        acc[i][j][q];
            }
            __syncthreads();
            if (wk == 0)
              for (int k = 1; k < P.ks; ++k)
#pragma unroll
                for (int i = 0; i < MI; ++i)
#pragma unroll
                  for (int j = 0; j < NI; ++j)
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                      acc[i][j][q] += pre[((((k - 1) * P.wn + slot) * MI + i) * NI + j) * 128 +
                                          q * 32 + lane];
          }
          if (wk == 0)
            cell_update_regs<T, MI, NI>(acc, gxs, cs, out + (long long)t * batch * hidden, wn,
                                        P.wn, b0, bs, be, hidden, units, j0);
        } else {
          // partials of K split wk: pre[wk][row][col], rows padded to nb + 4
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NI; ++j) {
              const int r = (wm + P.wm * i) * 16 + lane / 4;
              const int col = (wn + P.wn * j) * 8 + 2 * (lane % 4);
              float* d = pre + (wk * rows + r) * P.ld_pre + col;
              d[0] = acc[i][j][0];
              d[1] = acc[i][j][1];
              d[8 * P.ld_pre] = acc[i][j][2];
              d[8 * P.ld_pre + 1] = acc[i][j][3];
            }
          __syncthreads();
        }
      }
      if (t == 0 || P.wm > 1) {
        // cell update from shared memory of the tile's (b, j) pairs, unit fastest
        const int nbv = min(nb, be - b0);
        T* h_out = out + (long long)t * batch * hidden;
        for (int e = tid; e < (nbv << ushift); e += kThreads) {
          const int u = e & (units - 1), bb = e >> ushift, b = b0 + bb;
          float g4[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const int r = g * units + u;
            float s = 0.f;
            if (t > 0)
              for (int k = 0; k < P.ks; ++k) s += pre[(k * rows + r) * P.ld_pre + bb];
            g4[g] = to_f32(gxs[(b - bs) * rows + r]) + s;
          }
          cell(g4, cs + (b - bs) * units + u, h_out + (long long)b * hidden + j0 + u,
               j0 + u < hidden);
        }
      }
    }
    if (t + 1 == steps) break;
    // grid barrier: arrive, start the copy of gx[t+1] (it lands during the
    // wait or under step t+1's first chunk), wait
    __syncthreads();  // every h[t] store of the block is issued, gxs is read
    if (tid == 0) red_release(barrier, 1u);
    load_gx(gxs, gx, t + 1, batch, bs, nbr, hidden, units, j0, vec);
    cp_commit();
    if (tid == 0) {
      const unsigned target = (unsigned)(t + 1) * gridDim.x;
      const long long start = global_ns();
      while (ld_acquire(barrier) < target) {
        __nanosleep(32);
        if (global_ns() - start > kSpinLimitNs) __trap();
      }
    }
    __syncthreads();
  }
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, T*, unsigned*, int, int, int, int, int, int, int,
                          int, int);

// The instance for a warp's MI x NI tiles (MI * NI <= kMaxTiles), or null
template <typename T>
KernelFn<T> kernel_for(const Plan& P) {
  const int mi = P.units / 4 / P.wm, ni = P.nb / 8 / P.wn;
  switch (mi * 16 + ni) {
    case 1 * 16 + 1: return lstm_layer_kernel<T, 1, 1>;
    case 1 * 16 + 2: return lstm_layer_kernel<T, 1, 2>;
    case 1 * 16 + 4: return lstm_layer_kernel<T, 1, 4>;
    case 2 * 16 + 1: return lstm_layer_kernel<T, 2, 1>;
    case 2 * 16 + 2: return lstm_layer_kernel<T, 2, 2>;
    case 4 * 16 + 1: return lstm_layer_kernel<T, 4, 1>;
    default: return nullptr;
  }
}

template <typename T>
int launch(const void* gx, const void* w_hh, void* out, unsigned* barrier, int steps, int batch,
           int hidden, int units, int grid, int nb, int kc, int resident, int stages,
           int bgroups, long long smem_bytes, cudaStream_t stream) {
  const Plan P = make_plan(batch, hidden, (int)sizeof(T), units, nb, kc, resident, stages,
                           bgroups);
  const KernelFn<T> kernel = kernel_for<T>(P);
  if (kernel == nullptr || P.grid != grid || P.bytes != smem_bytes ||
      P.ks * P.wm * P.wn != kWarps || (long long)steps * grid >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  const T* g = static_cast<const T*>(gx);
  const T* w = static_cast<const T*>(w_hh);
  T* o = static_cast<T*>(out);
  void* args[] = {&g,     &w,      &o,  &barrier, &steps,    &batch,  &hidden,
                  &units, &nb,     &kc, &resident, &stages, &bgroups};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), args,
                                    (size_t)smem_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int info(int units, int nb, int* out) {
  const Plan P = make_plan(nb, 16 * units, (int)sizeof(T), units, nb, 16, 1, 1, 1);
  const KernelFn<T> kernel = kernel_for<T>(P);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace

// gx [T, B, 4H], w_hh [4H, H] and out [T, B, H] in one dtype (bf16 when
// is_bf16, else fp32), all contiguous; barrier one zeroed uint32.  Computes
// out[0 .. T-1] in one cooperative launch with the plan of ops/lstm.py.
extern "C" int acx_lstm_layer(const void* gx, const void* w_hh, void* out, void* barrier,
                              int steps, int batch, int hidden, int is_bf16, int units, int grid,
                              int nb, int kc, int resident, int stages, int bgroups,
                              long long smem_bytes, void* stream) {
  if (steps <= 0 || batch <= 0 || hidden <= 0 || units < 4 || (units & (units - 1)) ||
      nb < 8 || (nb & (nb - 1)) || kc < 16 || kc % 16 || stages < 1 || stages > kMaxStages ||
      bgroups < 1 || bgroups > batch)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned* bar = static_cast<unsigned*>(barrier);
  return is_bf16 ? launch<bf16>(gx, w_hh, out, bar, steps, batch, hidden, units, grid, nb, kc,
                                resident, stages, bgroups, smem_bytes, s)
                 : launch<float>(gx, w_hh, out, bar, steps, batch, hidden, units, grid, nb, kc,
                                 resident, stages, bgroups, smem_bytes, s);
}

// What the plan reads of the current device: SMs and the opt-in shared
// memory a block may use.
extern "C" int acx_lstm_device(int* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  return (int)cudaDeviceGetAttribute(out + 1, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Registers per thread, static shared bytes, threads per block and spilled
// bytes per thread of the kernel instance that a plan of `units` units and a
// batch tile of `nb` rows runs, for a dtype (cudaFuncGetAttributes).
extern "C" int acx_lstm_info(int is_bf16, int units, int nb, int* out) {
  return is_bf16 ? info<bf16>(units, nb, out) : info<float>(units, nb, out);
}
