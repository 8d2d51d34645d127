// SEANet encoder kernels: one fused encoder stage (K4) and the mono input
// conv (K5 on a padded signal, K6 with the reflect pad built in).
//
// K4 replaces audiocraft_tpu/ops/seanet_pallas.py:_stage_kernel.  For one
// batch row and a tile of `tile` output frames it computes
//     z = ELU(conv3(ELU(a)) + b1)             conv3: k = 3, reflect pad 1
//     r = a + conv1(z) + b2                   conv1: k = 1
//     y = conv_down(ELU(r)) + bd              k = 2s, stride s, reflect pad
//                                             left = s - s/2, right = s/2
// with a [B, C, L] read once (its tile plus a halo) and y [B, C_out, L/s]
// written once; ELU(a), z, r and ELU(r) live only in shared memory.  The
// reflect pads are rebuilt at the sequence edges: a row -1 is a[1], a row L
// is a[L-2]; ELU(r) row -i is row i, row L+i is row L-2-i (the reflection of
// ELU(r), not of a).  Rounding follows the TPU kernel: ELU(a), z and ELU(r)
// are stored in the input dtype; every product sums in fp32, biases arrive
// rounded to the input dtype and add in fp32; y is rounded once.
//
// Bound on an H100 at 32 kHz, b128 x 10 s, bf16: stage 0 ([128, 64, 320000]
// -> [128, 128, 80000]) moves 7.9 GB (2.35 ms at 3.35 TB/s) for 2.0 TFLOP;
// stage 1 ([128, 128, 80000] -> [128, 256, 20000]) does 2.0 TFLOP (2.04 ms at
// the bf16 tensor-core rate) on 3.9 GB.
//
// The bf16 variant, stage_mma_kernel, is built for the fused stages of the
// 32 kHz and 24 kHz codecs (C, H, C_out, s = 64, 32, 128, 4; 128, 64, 256, 4;
// 32, 16, 64, 2).  What the per-phase cycle counter (acx_seanet_stage_clocks)
// showed on the first version, one mma.sync block per 64 or 32 frames, two
// blocks an SM (NVIDIA H100 80GB HBM3 at 700 W, b128 x 10 s, PERF.md): stage
// 0 24.8 ms = input 26 %, conv3 27 %, conv1 21 %, downsample 20 %, output 6 %;
// stage 1 19.7 ms = input 17 %, conv3 30 %, conv1 15 %, downsample 34 %.  Each
// block read all its weights from L2 (24 and 47 GB a launch), loaded its
// input synchronously and left warps idle on ragged m-tiles; and mma.sync fed
// by 1 KB of shared loads per two products ran at about 110 TFLOP/s.  So:
// - one persistent block of 16 warps per SM walks over items of 128 r rows
//   (s * (tile + 1): 31 frames at s = 4), two m64 blocks of the products;
// - conv3 and conv1 run on wgmma with A (ELU(a) rows q .. q + 2, z rows) by
//   ldmatrix into registers, four loads in flight, and B (w1, w2) from
//   shared memory by descriptor (ops/seanet.py:pack_b_tiles, packed once per
//   encoder);
// - the downsample runs as y^T = wd^T . ELU(r)^T with both operands in shared
//   memory: ELU(r) is stored by phase (r row s*j + p in phase p, frame j) in
//   wgmma's canonical 8 x 8 core matrices, so taps k < s read phase k and
//   taps s + p read phase p one frame later; those sum into a second
//   accumulator that is added one column over (through shared memory where
//   two warpgroup pairs split the taps, by lane shuffles where one warpgroup
//   takes both), and no im2col copy is made;
// - wd stays resident where it fits (stage 0: 144 KiB with w1 and w2); where
//   it does not (stage 1: 512 KiB) each warpgroup streams its rows of wd^T
//   through a ring of 8 k-chunks by bulk copies on mbarriers, refilled a
//   batch of 4 behind the products;
// - the input tile arrives by one tensor-map copy an item, into a second
//   buffer where shared memory allows (stage 0), else into the one buffer as
//   soon as conv1 has read it; ELU(a) is built from it in one branch-free
//   pass with packed stores;
// - the output tile goes through shared memory and out as bf16 pairs.
// After (the same counter): stage 0 12.6 ms = input wait 5 %, ELU(a) 16 %,
// conv3 18 %, conv1 17 %, downsample 26 %, output 15 %; stage 1 17.0 ms, its
// downsample 73 %.  Both scale with the SMs a launch is given, so neither is
// bound by L2; stage 1's ring waits, batch by batch, for the products that
// read a slot before it refills it (a deeper ring, w1 streamed beside wd,
// ran slower).
// fp32 (the parity path) runs stage_tiled_kernel, register-tiled fp32 FMA
// (its notes below), at the stages it is built for (those above and the
// debug codecs' C = 4, s = 16 and 8, in either dtype); any other stage runs
// stage_kernel, the first version's phases on fp32 FMA, one block a tile.
// Offsets into the activations are 64-bit: stage 0 at b128 holds 2.6e9
// elements.
//
// K5 and K6 replace _banded_conv_kernel and _mono_conv_kernel of the same
// file: y[b, c, t] = sum_d w[c, d] x[b, t + d] + bias[c] for C_in = 1, a
// memory-bound conv (5.3 GB and 37 GFLOP at b128 x 10 s in bf16: 1.59 ms at
// 3.35 TB/s; y.fill_(0) on the same output takes 1.598 ms on an NVIDIA H100
// 80GB HBM3 at 700 W).  The first version (a block per 1024 outputs of a
// row, 40,064 blocks, each reloading the weights into shared memory behind
// a barrier, a runtime channel loop re-reading 7 weights and a bias from
// shared memory per output, one 2-byte store per output) took 5.797 ms
// there, 0.90 TB/s of output (PERF.md).  Now:
// - a persistent grid (two blocks of 256 threads an SM) walks over items of
//   1024 outputs of one row; the next item's input is copied into the
//   second of two shared buffers by 4-byte cp.async while this one is
//   computed (element by element where K6 reflects at a row's edges);
// - warp w takes units (group of 8 channels, 256 outputs) w, w + 8, ...;
//   at the codec's 64 channels each warp keeps one group, its 56 weights
//   and 8 biases in registers, loaded once per block;
// - each lane computes 8 consecutive outputs of each channel from a window
//   of 8 + 6 samples in registers, sums in fp32 as before (the bias added in
//   fp32, K6's rounded to x's dtype first; y rounded once), and stores the 8
//   as one 16-byte vector with the streaming hint (st.global.cs): a warp
//   writes 512 contiguous bytes per store.  Ragged ends and rows that are
//   not 16-byte aligned store element by element.
// Widths other than 7 taps run a generic instance (up to 15 taps, 4
// channels a thread).  After, on the same card: 1.899 ms, 2.76 TB/s of
// output, 1.19x fill_'s time (PERF.md).
#include <cuda.h>   // CUtensorMap; the encoder comes from the driver entry point at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "phase_clock.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;  // the dynamic shared memory a block may use
constexpr int kVecBatch = 4;        // 16-byte input loads a thread keeps in flight
constexpr int kRing = 8;            // k-chunks of wd in a warpgroup's streaming ring
constexpr int kBatch = kRing / 2;   // chunks a warpgroup multiplies between two refills

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// ELU(alpha = 1) as the TPU kernel writes it, exp(min(v, 0)) - 1 with the
// exponential as ex2.approx (a few fp32 steps of relative error, far below
// both dtypes' checks; results under 2^-126 flush to 0 and vanish in the - 1)
__device__ __forceinline__ float elu(float v) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(fminf(v, 0.f) * kLog2e));
  return v > 0.f ? v : e - 1.f;
}

// element i of a 16-byte load, as T
__device__ __forceinline__ uint32_t word(const uint4& q, int w) {
  return w == 0 ? q.x : w == 1 ? q.y : w == 2 ? q.z : q.w;
}
template <typename T> __device__ __forceinline__ T element(const uint4& q, int i);
template <> __device__ __forceinline__ float element<float>(const uint4& q, int i) {
  return __uint_as_float(word(q, i));
}
template <> __device__ __forceinline__ bf16 element<bf16>(const uint4& q, int i) {
  const uint32_t w = word(q, i >> 1);
  return __ushort_as_bfloat16((unsigned short)((i & 1) ? w >> 16 : w & 0xffffu));
}

// ------------------------------------------------------- K4, fp32 FMA variant

// The A operand of one product, read in place from shared memory:
// A[m][tap * width + c] = buf[(m * rowstep + tap + rowoff) * rs + c].
template <typename T>
struct RowView {
  const T* buf;
  int rs, rowstep, rowoff, taps, width;
};

// fp32 FMA product over the view: epi(m, n, sum) for m < M, n < N, with the
// weights w [taps * width, N] row-major.
template <typename T, class Epi>
__device__ void simt_product(int M, int N, RowView<T> av, const T* __restrict__ w, Epi epi) {
  for (int e = threadIdx.x; e < M * N; e += kThreads) {
    const int m = e / N, n = e % N;
    float acc = 0.f;
    for (int tap = 0; tap < av.taps; ++tap) {
      const T* arow = av.buf + (size_t)(m * av.rowstep + tap + av.rowoff) * av.rs;
      const T* wcol = w + (size_t)tap * av.width * N + n;
      for (int c = 0; c < av.width; ++c) acc = fmaf(to_f32(arow[c]), to_f32(wcol[(size_t)c * N]), acc);
    }
    epi(m, n, acc);
  }
}

struct Stage {
  int batch, c, h, c_out, len, stride, frames, tile, left, right;
  int na, nr;        // a rows and r rows of a tile
  int rs_a, rs_z;    // shared-memory row strides of the a / ELU(a) buffers and of z
  int rs_e;          // row stride of ELU(r), which takes the ELU(a) buffer's place
  int stage_elems;   // elements of the first buffer (a rows, then the output tile)
  int out_rs;        // row stride of the output tile in that buffer
  int bias_offset;   // byte offset of the fp32 biases
};

// One fused encoder stage (K4) on fp32 FMA.  grid (tiles of frames, batch).
template <typename T, bool kClocks>
__global__ void __launch_bounds__(kThreads)
stage_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
             const T* __restrict__ w2, const T* __restrict__ b2,
             const T* __restrict__ wd, const T* __restrict__ bd, T* __restrict__ y, Stage g,
             unsigned long long* clocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  PhaseClock<kClocks> laps(clocks);
  T* sa = reinterpret_cast<T*>(smem);      // a rows r0-1 .. ; later the output tile
  T* se = sa + g.stage_elems;              // ELU(a) rows; later ELU(r), r row q at row q+1
  T* sz = se + (size_t)g.na * max(g.rs_a, g.rs_e);   // z rows
  float* sb1 = reinterpret_cast<float*>(smem + g.bias_offset);   // the biases in fp32
  float* sb2 = sb1 + g.h;
  float* sbd = sb2 + g.c;
  constexpr int kVec = 16 / sizeof(T);   // elements of one 16-byte load
  const int tile = g.tile;
  const int b = blockIdx.y;
  const int u0 = blockIdx.x * tile;
  const int r0 = u0 * g.stride - g.left;   // global r row of local row 0
  const T* xb = x + (size_t)b * g.c * g.len;

  // the biases, once, as fp32
  for (int i = threadIdx.x; i < g.h; i += kThreads) sb1[i] = to_f32(b1[i]);
  for (int i = threadIdx.x; i < g.c; i += kThreads) sb2[i] = to_f32(b2[i]);
  for (int i = threadIdx.x; i < g.c_out; i += kThreads) sbd[i] = to_f32(bd[i]);
  // a rows r0 - 1 .. r0 + nr (reflected at the edges; rows that only feed
  // r rows outside the sequence are clamped, and those r rows are rebuilt
  // below), stored row-major [row][channel] with ELU(a) beside them
  auto put = [&](int p, int ch, T v) {
    if (p >= 0 && p < g.na) {
      sa[p * g.rs_a + ch] = v;
      se[p * g.rs_a + ch] = from_f32<T>(elu(to_f32(v)));
    }
  };
  const int t_lo = r0 - 1;   // the global row of local row 0
  if (t_lo >= 0 && t_lo + g.na <= g.len && g.len % kVec == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    // an interior tile: 16-byte loads from the aligned rows around it; the
    // lanes of a warp take consecutive channels, so that their stores into
    // a shared row fall on distinct banks
    const int a0 = t_lo / kVec * kVec;
    const int nvec = (t_lo + g.na - a0 + kVec - 1) / kVec;
    const int n_ld = nvec * g.c;
    for (int e0 = threadIdx.x; e0 < n_ld; e0 += kThreads * kVecBatch) {
      uint4 q[kVecBatch];
#pragma unroll
      for (int j = 0; j < kVecBatch; ++j) {
        const int e = e0 + j * kThreads;
        if (e < n_ld) {
          const int v = e / g.c, ch = e - v * g.c;
          q[j] = *reinterpret_cast<const uint4*>(xb + (size_t)ch * g.len + a0 + v * kVec);
        }
      }
#pragma unroll
      for (int j = 0; j < kVecBatch; ++j) {
        const int e = e0 + j * kThreads;
        if (e < n_ld) {
          const int v = e / g.c, ch = e - v * g.c;
#pragma unroll
          for (int i = 0; i < kVec; ++i) put(a0 + v * kVec + i - t_lo, ch, element<T>(q[j], i));
        }
      }
    }
  } else {
    // an edge tile: rows through reflected indices, a warp on one channel
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int ch = warp; ch < g.c; ch += kWarps) {
      const T* xrow = xb + (size_t)ch * g.len;
      for (int p = lane; p < g.na; p += 32) {
        int t = t_lo + p;
        t = t < 0 ? -t : t;
        t = t >= g.len ? 2 * g.len - 2 - t : t;
        put(p, ch, xrow[min(max(t, 0), g.len - 1)]);
      }
    }
  }
  __syncthreads();
  laps.lap(0);

  // z = ELU(conv3(ELU(a)) + b1) for r rows 0 .. nr-1 (r row q reads a rows q-1 .. q+1)
  simt_product(g.nr, g.h, RowView<T>{se, g.rs_a, 1, 0, 3, g.c}, w1, [&](int m, int n, float v) {
    sz[m * g.rs_z + n] = from_f32<T>(elu(v + sb1[n]));
  });
  __syncthreads();
  laps.lap(1);

  // ELU(r), r = a + conv1(z) + b2, in place of the ELU(a) rows (no longer
  // read), r row q at row q + 1 with row stride rs_e
  simt_product(g.nr, g.c, RowView<T>{sz, g.rs_z, 1, 0, 1, g.h}, w2, [&](int m, int n, float v) {
    se[(m + 1) * g.rs_e + n] = from_f32<T>(elu(to_f32(sa[(m + 1) * g.rs_a + n]) + v + sb2[n]));
  });
  __syncthreads();
  laps.lap(2);

  // the downsample's reflect pad at the sequence edges: ELU(r) row -i := row i,
  // row L+i := row L-2-i (sources and destinations never overlap)
  if (r0 < 0) {
    for (int e = threadIdx.x; e < g.left * g.c; e += kThreads) {
      const int i = e / g.c + 1, ch = e % g.c;
      se[(-i - r0 + 1) * g.rs_e + ch] = se[(i - r0 + 1) * g.rs_e + ch];
    }
  }
  if (u0 + tile >= g.frames) {
    for (int e = threadIdx.x; e < g.right * g.c; e += kThreads) {
      const int i = e / g.c, ch = e % g.c;
      se[(g.len + i - r0 + 1) * g.rs_e + ch] = se[(g.len - 2 - i - r0 + 1) * g.rs_e + ch];
    }
  }
  __syncthreads();
  laps.lap(3);

  // downsample: frame m reads ELU(r) rows s*m .. s*m + 2s - 1; the output
  // tile goes through shared memory so that the stores run along T
  const int frames = min(tile, g.frames - u0);
  simt_product(frames, g.c_out, RowView<T>{se, g.rs_e, g.stride, 1, 2 * g.stride, g.c}, wd,
               [&](int m, int n, float v) { sa[n * g.out_rs + m] = from_f32<T>(v + sbd[n]); });
  __syncthreads();
  laps.lap(4);
  T* yb = y + (size_t)b * g.c_out * g.frames + u0;
  for (int e = threadIdx.x; e < g.c_out * tile; e += kThreads) {
    const int n = e / tile, m = e - n * tile;
    if (m < frames) yb[(size_t)n * g.frames + m] = sa[n * g.out_rs + m];
  }
  if constexpr (kClocks) {
    __syncthreads();
    laps.lap(5);
  }
  laps.flush();
}

// The geometry of a tile of `tile` frames, and its shared-memory bytes.
size_t stage_geometry(Stage& g, int tile, int elem) {
  g.tile = tile;
  g.nr = g.stride * (tile + 1);   // r rows s*u0 - left .. s*(u0 + tile) + s - left - 1
  g.na = g.nr + 2;
  g.rs_a = g.c;
  g.rs_z = g.h;
  g.rs_e = g.c;
  g.out_rs = tile;
  int stage = g.na * g.rs_a;
  if (g.c_out * g.out_rs > stage) stage = g.c_out * g.out_rs;
  g.stage_elems = (stage + 7) / 8 * 8;
  const size_t elems = (size_t)g.stage_elems + (size_t)g.na * g.rs_e + (size_t)g.nr * g.rs_z;
  g.bias_offset = (int)((elems * elem + 15) / 16 * 16);
  return g.bias_offset + sizeof(float) * ((size_t)g.h + g.c + g.c_out);
}

int choose_tile(int c, int h, int c_out, int stride, int is_bf16) {
  Stage g{};
  g.c = c, g.h = h, g.c_out = c_out, g.stride = stride;
  const int elem = is_bf16 ? 2 : 4;
  const int tiles[] = {64, 32, 16, 8};
  // two blocks per SM where a tile of 32 frames or more allows it (measured
  // faster than one block of a larger tile), else the largest that fits
  const int blocks_per_sm[] = {2, 1};
  for (int blocks : blocks_per_sm) {
    for (int tile : tiles) {
      if (blocks == 2 && tile < 32) break;
      if (stage_geometry(g, tile, elem) * blocks <= (size_t)kSmemLimit) return tile;
    }
  }
  return 0;
}

// ------------------------------------------------- mbarriers, bulk copies

// cycles (about 10 s) a wait on an mbarrier may spin before it traps, so that
// a fault ends the launch with an error instead of hanging the card
constexpr unsigned long long kSpinLimit = 20000000000ull;

// mbarriers and bulk copies (sm_90)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Arrive, and expect `bytes` of copies to complete on the barrier's phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}
// Arrive (no bytes expected)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
// Wait until the barrier's phase of `parity` has completed; trap after kSpinLimit cycles
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long start = cycles();
  while (!mbar_try_wait(bar, parity))
    if (cycles() - start > kSpinLimit) __trap();
}
// `bytes` (a multiple of 16, both ends on 16 bytes) from global to shared
// memory by the copy engine, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// ------------------------------------------- K4, fp32 FMA, register-tiled

// The fp32 parity path's stage kernel at the stages it is instantiated for
// (ops/seanet.py:tiled_plan; any other stage keeps stage_kernel above).
// Its products run on the CUDA cores in fp32 FMA: the tensor cores' TF32
// would round the products and move codes.  Bound: 2 operations a multiply-
// add at the fp32 rate (67 TFLOP/s): [16, 64, 320000] -> [16, 128, 80000]
// does 252 GFLOP (3.76 ms), as does stage 1 at the same batch.
//
// stage_kernel above computes one output a thread, reads a weight from
// global memory for every FMA and launches a block per tile of frames that
// re-reads every weight.  Here:
// - one persistent block an SM walks over items of one batch row and kTile =
//   kFrames - 1 output frames (kRows = S * kFrames r rows: 256 where shared
//   memory allows, else 128); 8 warps compute, a ninth streams the weights;
// - every product is a register tile: a thread owns 8 consecutive r rows
//   (or frames) x TN output channels (2, 4 or 8) and takes each operand row by
//   128-bit shared loads, the activations stored channel-major ([channel]
//   [row]) so that 8 rows are contiguous.  conv3 loads 12 rows of ELU(a) a
//   channel once for its three taps; the downsample loads 12 frames of one
//   phase of ELU(r) once for its two taps (k and k + S), ELU(r) being stored
//   by phase (r row S j + p at phase p, frame j);
// - w1, w2 and wd stream through a ring of kFmaStages slots of k-chunks, the
//   chunk sequence running on over the block's items: one lane of the
//   weight warp refills a slot by bulk copies completing on its full
//   mbarrier as soon as the 8 warps have arrived on its empty one, so no
//   block-wide barrier falls between chunks (the first design's one barrier
//   a chunk cost 13 % of stage 0's cycles and 22 % of stage 1's).  None
//   stays resident: at 256 r rows the activations of stage 0 leave no room
//   for w1 and w2 (33 KiB);
// - the next item's input tile is copied (16-byte cp.async) into the input
//   buffer once conv1 has read it, under the downsample; tiles at a row's
//   edges are gathered through reflected indices by the threads;
// - the output tile goes through shared memory and out along T.
// Rounding as stage_kernel: ELU(a), z and ELU(r) are stored rounded to the
// input dtype (kept as fp32 values in shared memory), every product and bias
// sums in fp32, y is rounded once.  Weights and biases arrive in fp32 (exact
// copies of bf16 ones).  The per-phase counter's phases: TiledPhase.  Nine
// warps put three on one SM sub-partition, which caps a thread at 168
// registers (stage 1 spills 64 bytes); the weight warp bought more than the
// 181 registers of 8 warps did.
// After (NVIDIA H100 80GB HBM3 at 700 W, PERF.md): 7.01 + 6.91 ms at B = 16
// x 10 s (35.9 and 36.4 TFLOP/s; the first design 206.1 + 427.7, cuDNN's
// module stack 20.2 + 11.7); stage 0's split: downsample 50 %, conv3 19 %,
// conv1 14 %, ELU(a) 6 %, output 4 %, chunk waits 4 %.

constexpr int kFmaWorkers = 256;                 // 8 warps compute
constexpr int kFmaThreads = kFmaWorkers + 32;    // and one warp streams the weights
constexpr int kFmaStages = 3;     // weight chunks in the ring
constexpr int kFmaSlot = 4096;    // floats a ring slot holds at most (16 KiB)

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cround(int v, int m) { return (v + m - 1) / m * m; }
// the largest power of two dividing n whose chunk (d rows of `per` weight
// rows of `width` floats) fits a slot
__host__ __device__ constexpr int chunk_rows(int n, int per, int width) {
  int d = n & -n;
  while (d > 1 && d * per * width > kFmaSlot) d /= 2;
  return d;
}
// output channels of a thread's register tile for an M x N product: as many
// as keep the 256 computing threads busy, 2 to 8
__host__ __device__ constexpr int tile_cols(int m, int n) {
  const int t = m / 8 * n / kFmaWorkers;
  return t >= 8 ? 8 : t >= 4 ? 4 : 2;
}

// Shared floats of an item of `rows` r rows: the input tile, ELU(a) (then
// ELU(r) by phase), z (then the output tile), the ring, the biases, the
// ring's full and empty mbarriers.  ops/seanet.py:_tiled_floats computes the
// same.
__host__ __device__ constexpr int tiled_floats(int c, int h, int co, int s, int rows) {
  const int rs = rows + 8, es = rows / s + 4;
  const int slot = cmax(cmax(3 * chunk_rows(c, 3, h) * h, chunk_rows(h, 1, c) * c),
                        2 * chunk_rows(c, 2, co) * co);
  return c * rs + cmax(c * rs, s * c * es) + cmax(h * rows, co * es) + kFmaStages * slot +
         cround(h + c + co, 4) + 4 * kFmaStages;
}

template <int C, int H, int CO, int S>
struct Tiled {
  static constexpr int kRows = 4 * tiled_floats(C, H, CO, S, 256) <= kSmemLimit ? 256 : 128;
  static constexpr int kFrames = kRows / S, kTile = kFrames - 1, kNa = kRows + 2;
  static constexpr int kRs = kRows + 8;        // input tile and ELU(a) rows: 12-row loads past kRows
  static constexpr int kEs = kFrames + 4;      // ELU(r) phase rows and output tile rows
  static constexpr int kC3 = chunk_rows(C, 3, H), kC1 = chunk_rows(H, 1, C), kCd = chunk_rows(C, 2, CO);
  static constexpr int kN3 = C / kC3, kN1 = H / kC1, kNd = S * (C / kCd);
  static constexpr int kChunks = kN3 + kN1 + kNd;
  static constexpr int kSlot = cmax(cmax(3 * kC3 * H, kC1 * C), 2 * kCd * CO);
  static constexpr int kE = C * kRs, kZ = kE + cmax(C * kRs, S * C * kEs);
  static constexpr int kRing = kZ + cmax(H * kRows, CO * kEs);
  static constexpr int kBias = kRing + kFmaStages * kSlot;
  static constexpr int kBar = kBias + cround(H + C + CO, 4);   // 8-byte aligned
  static constexpr int kBytes = 4 * tiled_floats(C, H, CO, S, kRows);
  static constexpr int kT3 = tile_cols(kRows, H), kT1 = tile_cols(kRows, C), kTd = tile_cols(kFrames, CO);
  static_assert(kBytes <= kSmemLimit && kFrames % 8 == 0, "an item fits");
  static_assert(kNd >= 2, "the next input lands before the next item's first chunk");
  static_assert((kC3 * H) % 4 == 0 && (kC1 * C) % 4 == 0 && CO % 4 == 0, "16-byte chunks");
};

// How the 256 threads cover an M x N product in 8 x TN register tiles: a
// warp spans WM row groups x WN column groups, so that its operand loads
// are broadcasts along one axis and distinct 16-byte pieces along the other.
template <int M, int N, int TN>
struct Tiling {
  static constexpr int MG = M / 8, NG = N / TN, WN = NG < 8 ? NG : 8, WM = 32 / WN;
  static constexpr int WARPS_N = NG / WN, WARPS_M = (MG + WM - 1) / WM;
  static_assert(N % TN == 0 && (TN != 8 || N % 8 == 0), "whole tiles");
  static_assert(WARPS_N * WARPS_M * 32 <= kFmaWorkers, "one tile a thread");
  int mi, ni;
  bool valid;
  __device__ explicit Tiling(int tid) {
    const int lane = tid & 31, w = tid >> 5;
    mi = (w / WARPS_N) * WM + lane / WN;
    ni = (w % WARPS_N) * WN + lane % WN;
    valid = w < WARPS_N * WARPS_M && mi < MG;
  }
  // the output column of element j of the tile: TN = 8 takes two groups of
  // 4 (4 ni .., N / 2 + 4 ni ..), so that a warp's 128-bit loads of a row are
  // contiguous
  __device__ static int col(int ni, int j) {
    return TN == 8 ? (j < 4 ? 4 * ni + j : N / 2 + 4 * ni + j - 4) : TN * ni + j;
  }
};

// Element j < TN of a weight row's tile columns, by 128-bit (or 64-bit) loads
template <int TN, int N>
__device__ __forceinline__ void load_cols(float (&b)[TN], const float* row, int ni) {
  if constexpr (TN == 8) {
    const float4 lo = *reinterpret_cast<const float4*>(row + 4 * ni);
    const float4 hi = *reinterpret_cast<const float4*>(row + N / 2 + 4 * ni);
    b[0] = lo.x, b[1] = lo.y, b[2] = lo.z, b[3] = lo.w, b[4] = hi.x, b[5] = hi.y, b[6] = hi.z, b[7] = hi.w;
  } else if constexpr (TN == 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + 4 * ni);
    b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(row + 2 * ni);
    b[0] = v.x, b[1] = v.y;
  }
}

// N floats from a 16-byte-aligned shared address
template <int N>
__device__ __forceinline__ void load_rows(float (&a)[N], const float* p) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    a[i] = v.x, a[i + 1] = v.y, a[i + 2] = v.z, a[i + 3] = v.w;
  }
}

template <typename T> __device__ __forceinline__ float rounded(float v) { return to_f32(from_f32<T>(v)); }

// Phases of the register-tiled variant's cycle counter (ops/seanet.py:TILED_PHASES)
enum TiledPhase { kTIn, kTElu, kTConv3, kTConv1, kTReflect, kTDown, kTOut, kTWait };

// The 256 threads of warps 0-7 meet (named barrier 1; the weight warp never does)
__device__ __forceinline__ void workers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kFmaWorkers) : "memory");
}

// grid: one persistent block an SM; block b takes items b, b + grid, ...
// Warps 0-7 compute; warp 8 (one lane) streams the weight chunks by bulk
// copies, each completing on its slot's full barrier, a slot refilled once
// the 8 warps have arrived on its empty barrier.
template <typename T, int C, int H, int CO, int S, bool kClocks>
__global__ void __launch_bounds__(kFmaThreads, 1)
stage_tiled_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ wd,
                   const float* __restrict__ bd, T* __restrict__ y, int len, int frames,
                   int tiles, int items, int vec, unsigned long long* clocks) {
  using G = Tiled<C, H, CO, S>;
  constexpr int ROWS = G::kRows, NF = G::kFrames, TILE = G::kTile, NA = G::kNa;
  constexpr int RS = G::kRs, ES = G::kEs, SLOT = G::kSlot, STAGES = kFmaStages;
  constexpr int LEFT = S - S / 2, RIGHT = S / 2;
  extern __shared__ __align__(16) float fsmem[];
  float* raw = fsmem;                 // [C][RS]: the input tile, a row t_lo + p at column p + roff
  float* ea = fsmem + G::kE;          // [C][RS]: ELU(a), a row t_lo + p at column p
  float* er = ea;                     // [S][C][ES]: ELU(r) by phase, after conv3
  float* zs = fsmem + G::kZ;          // [H][ROWS]: z; then the output tile [CO][ES]
  float* ring = fsmem + G::kRing;     // [STAGES][SLOT]
  float* sb1 = fsmem + G::kBias;
  float* sb2 = sb1 + H;
  float* sbd = sb2 + C;
  const int tid = threadIdx.x;
  PhaseClock<kClocks> laps(clocks);
  const int iters = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  auto item_of = [&](int n) { return n * (int)gridDim.x + (int)blockIdx.x; };
  auto first_row = [&](int item) { return (item % tiles) * TILE * S - LEFT - 1; };   // a row of local 0
  // an interior tile of an fp32 input comes by 16-byte copies from the
  // aligned column at or before its first row
  auto interior = [&](int t_lo) {
    return sizeof(T) == 4 && vec && t_lo >= 0 && (t_lo & ~3) + RS <= len;
  };

  // the input tile of `item` into raw: cp.async copies (committed by the
  // next issue) or, at a row's edges, reflected rows by the threads
  auto prefetch = [&](int item) {
    const int t_lo = first_row(item);
    const T* xb = x + (size_t)(item / tiles) * C * len;
    if (interior(t_lo)) {
      const T* src = xb + (t_lo & ~3);
      for (int e = tid; e < C * (RS / 4); e += kFmaWorkers) {
        const int c = e / (RS / 4), v = e - c * (RS / 4);
        cp_async16(raw + c * RS + 4 * v, src + (size_t)c * len + 4 * v, true);
      }
    } else {
      for (int e = tid; e < C * NA; e += kFmaWorkers) {
        const int c = e / NA, p = e - c * NA;
        int t = t_lo + p;
        t = t < 0 ? -t : t;
        t = t >= len ? 2 * len - 2 - t : t;
        raw[c * RS + p] = to_f32(xb[(size_t)c * len + min(max(t, 0), len - 1)]);
      }
    }
  };

  uint64_t* full = reinterpret_cast<uint64_t*>(fsmem + G::kBar);   // a chunk has landed in the slot
  uint64_t* empty = full + STAGES;                                  // the 8 warps are done with it
  for (int i = tid; i < H; i += kFmaThreads) sb1[i] = b1[i];
  for (int i = tid; i < C; i += kFmaThreads) sb2[i] = b2[i];
  for (int i = tid; i < CO; i += kFmaThreads) sbd[i] = bd[i];
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(full + i, 1), mbar_init(empty + i, kFmaWorkers / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the weight chunk sequence: per item kN3 chunks of w1 (kC3 channels, 3
  // taps: [tap][c][H]), kN1 of w2 (kC1 rows: [h][C]) and kNd of wd (phase p,
  // kCd channels, taps p and p + S: [2][c][CO]); chunk q in slot q % STAGES
  const int total = iters * G::kChunks;
  if (tid >= kFmaWorkers) {
    if (tid == kFmaWorkers) {
      for (int q = 0; q < total; ++q) {
        const int slot = q % STAGES;
        mbar_wait(empty + slot, ((q / STAGES) & 1) ^ 1);   // its last chunk has been read
        float* dst = ring + slot * SLOT;
        uint64_t* bar = full + slot;
        int k = q % G::kChunks;
        if (k < G::kN3) {
          mbar_expect_tx(bar, 4 * 3 * G::kC3 * H);
          for (int t = 0; t < 3; ++t)
            bulk_copy(dst + t * G::kC3 * H, w1 + (size_t)(t * C + k * G::kC3) * H, 4 * G::kC3 * H, bar);
        } else if ((k -= G::kN3) < G::kN1) {
          mbar_expect_tx(bar, 4 * G::kC1 * C);
          bulk_copy(dst, w2 + (size_t)k * G::kC1 * C, 4 * G::kC1 * C, bar);
        } else {
          k -= G::kN1;
          const int p = k / (C / G::kCd), c0 = (k % (C / G::kCd)) * G::kCd;
          mbar_expect_tx(bar, 4 * 2 * G::kCd * CO);
          bulk_copy(dst, wd + (size_t)(p * C + c0) * CO, 4 * G::kCd * CO, bar);
          bulk_copy(dst + G::kCd * CO, wd + (size_t)((p + S) * C + c0) * CO, 4 * G::kCd * CO, bar);
        }
      }
    }
    return;
  }
  // chunk q has landed (the wait's cycles counted apart); done with chunk q
  auto wait_chunk = [&](int q, int phase) {
    laps.lap(phase);
    mbar_wait(full + q % STAGES, (q / STAGES) & 1);
    laps.lap(kTWait);
  };
  auto release = [&](int q) {
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty + q % STAGES);
  };

  prefetch(item_of(0));
  cp_commit();

  const Tiling<ROWS, H, G::kT3> t3(tid);
  const Tiling<ROWS, C, G::kT1> t1(tid);
  const Tiling<NF, CO, G::kTd> td(tid);
  int q = 0;   // the chunk being multiplied
  for (int n = 0; n < iters; ++n) {
    const int item = item_of(n);
    const int t_lo = first_row(item), roff = interior(t_lo) ? t_lo & 3 : 0;
    const int r0 = t_lo + 1, u0 = (r0 + LEFT) / S;   // global r row of local 0, first frame
    laps.lap(kTOut);
    cp_wait<0>();      // this item's input has landed (copied under the last downsample)
    workers_sync();
    laps.lap(kTWait);

#pragma unroll 4
    for (int e = tid; e < C * NA; e += kFmaWorkers) {
      const int c = e / NA, p = e - c * NA;
      ea[c * RS + p] = rounded<T>(elu(raw[c * RS + p + roff]));
    }
    workers_sync();
    laps.lap(kTElu);

    // z = ELU(conv3(ELU(a)) + b1): r row m reads ELU(a) columns m .. m + 2
    {
      constexpr int TN = G::kT3;
      float acc[8][TN] = {};
      const int m0 = 8 * t3.mi;
      for (int k = 0; k < G::kN3; ++k, ++q) {
        wait_chunk(q, kTConv3);
        const float* slot = ring + (q % STAGES) * SLOT;
        if (t3.valid) {
#pragma unroll 4
          for (int cc = 0; cc < G::kC3; ++cc) {
            float a[12];
            load_rows(a, ea + (k * G::kC3 + cc) * RS + m0);
#pragma unroll
            for (int tap = 0; tap < 3; ++tap) {
              float b[TN];
              load_cols<TN, H>(b, slot + (tap * G::kC3 + cc) * H, t3.ni);
#pragma unroll
              for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i + tap], b[j], acc[i][j]);
            }
          }
        }
        release(q);
      }
      if (t3.valid) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int h = t3.col(t3.ni, j);
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = rounded<T>(elu(acc[i][j] + sb1[h]));
          *reinterpret_cast<float4*>(zs + h * ROWS + m0) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(zs + h * ROWS + m0 + 4) = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
    }
    workers_sync();   // z is whole

    // ELU(r), r = a + conv1(z) + b2, by phase over ELU(a) (no longer read)
    {
      constexpr int TN = G::kT1;
      float acc[8][TN] = {};
      const int m0 = 8 * t1.mi;
      for (int k = 0; k < G::kN1; ++k, ++q) {
        wait_chunk(q, k == 0 ? kTConv3 : kTConv1);
        const float* slot = ring + (q % STAGES) * SLOT;
        if (t1.valid) {
#pragma unroll 4
          for (int hh = 0; hh < G::kC1; ++hh) {
            float a[8], b[TN];
            load_rows(a, zs + (k * G::kC1 + hh) * ROWS + m0);
            load_cols<TN, C>(b, slot + hh * C, t1.ni);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
        }
        release(q);
      }
      if (t1.valid) {
        // the thread's 8 r rows m0 + i (r row m is a row m + 1) hold V
        // consecutive frames of each phase where S divides 8: one vector store a phase
        constexpr int V = S <= 8 ? 8 / S : 1;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = t1.col(t1.ni, j);
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v[i] = rounded<T>(elu(raw[c * RS + m0 + i + 1 + roff] + acc[i][j] + sb2[c]));
          if constexpr (V == 2 || V == 4) {
#pragma unroll
            for (int p = 0; p < S; ++p) {
              float* dst = er + (p * C + c) * ES + m0 / S;
              if constexpr (V == 2)
                *reinterpret_cast<float2*>(dst) = make_float2(v[p], v[p + S]);
              else
                *reinterpret_cast<float4*>(dst) = make_float4(v[p], v[p + 2], v[p + 4], v[p + 6]);
            }
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) er[(((m0 + i) % S) * C + c) * ES + (m0 + i) / S] = v[i];
          }
        }
      }
    }
    workers_sync();   // ELU(r) is whole; the input tile is free
    laps.lap(kTConv1);
    if (n + 1 < iters) prefetch(item_of(n + 1));
    cp_commit();
    laps.lap(kTIn);

    // the downsample's reflect pad at the sequence edges: ELU(r) row -i :=
    // row i, row L+i := row L-2-i (sources and destinations never overlap)
    auto er_at = [&](int r, int c) -> float& { return er[((r % S) * C + c) * ES + r / S]; };
    if (r0 < 0 || u0 + TILE >= frames) {
      if (r0 < 0)
        for (int e = tid; e < LEFT * C; e += kFmaWorkers)
          er_at(-(e / C + 1) - r0, e % C) = er_at(e / C + 1 - r0, e % C);
      if (u0 + TILE >= frames)
        for (int e = tid; e < RIGHT * C; e += kFmaWorkers)
          er_at(len + e / C - r0, e % C) = er_at(len - 2 - e / C - r0, e % C);
      workers_sync();
    }
    laps.lap(kTReflect);

    // downsample: frame m = sum over phases p and channels c of ELU(r)_p[c][m] .
    // wd[p][c] + ELU(r)_p[c][m + 1] . wd[p + S][c]
    {
      constexpr int TN = G::kTd;
      float acc[8][TN] = {};
      const int m0 = 8 * td.mi;
      for (int k = 0; k < G::kNd; ++k, ++q) {
        wait_chunk(q, kTDown);
        const float* slot = ring + (q % STAGES) * SLOT;
        const int p = k / (C / G::kCd), c0 = (k % (C / G::kCd)) * G::kCd;
        if (td.valid) {
#pragma unroll 4
          for (int cc = 0; cc < G::kCd; ++cc) {
            float a[12], b0[TN], b1v[TN];
            load_rows(a, er + (p * C + c0 + cc) * ES + m0);
            load_cols<TN, CO>(b0, slot + cc * CO, td.ni);
            load_cols<TN, CO>(b1v, slot + (G::kCd + cc) * CO, td.ni);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j)
                acc[i][j] = fmaf(a[i + 1], b1v[j], fmaf(a[i], b0[j], acc[i][j]));
          }
        }
        release(q);
      }
      if (td.valid) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int co = td.col(td.ni, j);
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = acc[i][j] + sbd[co];
          *reinterpret_cast<float4*>(zs + co * ES + m0) = make_float4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<float4*>(zs + co * ES + m0 + 4) = make_float4(v[4], v[5], v[6], v[7]);
        }
      }
    }
    laps.lap(kTDown);
    workers_sync();
    const int fr = min(TILE, frames - u0);
    T* yb = y + (size_t)(item / tiles) * CO * frames + u0;
#pragma unroll 4
    for (int e = tid; e < CO * TILE; e += kFmaWorkers) {
      const int co = e / TILE, m = e - co * TILE;
      if (m < fr) yb[(size_t)co * frames + m] = from_f32<T>(zs[co * ES + m]);
    }
  }
  if constexpr (kClocks) {
    workers_sync();
    laps.lap(kTOut);
  }
  laps.flush();
}

// ------------------------------------------------- K4, bf16 on tensor cores

constexpr int kMmaThreads = 512;   // 16 warps: one block an SM, and enough warps to hide latency
constexpr int kMmaWarps = kMmaThreads / 32;
// A box of a 2D tensor map (coordinates: column, row) to shared memory by the
// copy engine, completing on `bar`; columns past the tensor arrive as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int col, int row,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
         "r"(smem_addr(bar))
      : "memory");
}

// The launch plan (ops/seanet.py:stage_plan) and the geometry it implies
struct MmaStage {
  int batch, len, frames, left, right;
  int tiles;      // items along T a batch row
  int items;      // batch * tiles
  int in_bufs;    // input tiles in shared memory: 2 lets the next copy start an item early
  int ring;       // 0: wd resident; else kRing, the k-chunks of wd in each warpgroup's ring
  int vec;        // len % 8 == 0 and x on 16 bytes: interior tiles copy in bulk
  int off_w2, off_wd, off_raw, off_e, off_z, off_bias, off_bar;   // shared byte offsets
};

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The item geometry of an instance: stride S, tile frames an item, 128 r
// rows (two m64 blocks), an input tile [C][raw_rs] (an aligned copy starts
// up to 7 rows early; an odd number of 16-byte units a row), ELU(r) by
// phase in wgmma's canonical layout (phase_bytes apart, padded so that the
// 8 r rows of one mma row group fall on distinct banks), the output tile
// [C_out][out_rs].
template <int C, int H, int CO, int S>
struct Geometry {
  static constexpr int kTile = 128 / S - 1, kFrames = kTile + 1, kRows = 128, kNa = kRows + 2;
  static constexpr int kChunks = ((kNa + 14) / 8) | 1;
  static constexpr int kRawRs = 8 * kChunks;
  static constexpr int kPhaseBytes = kFrames / 8 * C * 16 + 128 / S;
  // ELU(a) takes kNa rows and a spare one that out-of-range stores go to
  static constexpr int kEBytes =
      (kNa + 1) * (C + 8) * 2 > S * kPhaseBytes ? (kNa + 1) * (C + 8) * 2 : S * kPhaseBytes;
  static constexpr int kOutRs = kFrames + 8;
  static constexpr int kZBytes = 2 * (kRows * (H + 8) > CO * kOutRs ? kRows * (H + 8) : CO * kOutRs);
};

// Shared bytes of the plan (ops/seanet.py:_mma_smem_bytes computes the same):
// w1, w2, wd or the warpgroups' rings, the input tiles, ELU(a) / ELU(r),
// z / the output tile, the fp32 biases, the mbarriers (one an input tile,
// one a ring slot of each of the 4 warpgroups).
template <int C, int H, int CO, int S>
int mma_geometry(MmaStage& g) {
  using G = Geometry<C, H, CO, S>;
  int off = 2 * 3 * C * H;
  g.off_w2 = off;
  off += 2 * H * C;
  g.off_wd = off;
  off += g.ring ? g.ring * 16 * CO * 2 : 2 * 2 * S * C * CO;
  g.off_raw = off;
  off += g.in_bufs * C * G::kRawRs * 2;
  g.off_e = off;
  off += G::kEBytes;
  g.off_z = off;
  off += G::kZBytes;
  g.off_bias = off;
  off += round_up(4 * (H + C + CO), 16);
  g.off_bar = off;
  return off + 8 * (2 + 4 * g.ring);
}

// wgmma (sm_90a): D[64 x N] (+)= A[64 x 16] . B[16 x N] for one warpgroup, A in
// registers (warp w of the group holds rows 16w .. 16w + 15 as mma.m16n8k16's
// A fragment), B in shared memory by descriptor, D in registers (warp w's
// rows, each 8-column group as mma.m16n8k16's D fragment), fp32 sums.
template <int N> struct Wgmma;
template <> struct Wgmma<8> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
        : "memory");
  }
};

template <> struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
        : "memory");
  }
};

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
        : "memory");
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
        : "memory");
  }
};

// B by descriptor: no swizzle, K-major core matrices of 8 columns x 16 bytes
// (ops/seanet.py:pack_wgmma_b): the two halves of a 16-deep chunk 128 bytes
// apart, 8-column groups 256 bytes apart
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3ffff) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}
__device__ __forceinline__ void shared_to_async() {   // generic writes before wgmma reads them
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving or reusing registers a wgmma still reads or writes
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ void pin(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}
// The 128 threads of warpgroup `wg` meet (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");
}

// wgmma with A in shared memory too, by descriptor
template <int N> struct WgmmaSS;
template <> struct WgmmaSS<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a_desc, uint64_t b_desc,
                                             int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a_desc), "l"(b_desc), "r"(accumulate)
        : "memory");
  }
};

template <> struct WgmmaSS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a_desc, uint64_t b_desc,
                                             int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a_desc), "l"(b_desc), "r"(accumulate)
        : "memory");
  }
};

// A descriptor of a K-major operand with 8-row groups `sbo` bytes apart
__device__ __forceinline__ uint64_t kmajor_desc(const void* p, uint32_t sbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3ffff) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// A chain of K wgmma over one warpgroup: acc = sum_k A_k . B_k, A_k by
// ldmatrix from a_at(k) (this lane's row address), B_k at b_at(k); four A
// buffers, so the loads of A_k overlap the products of A_{k-3} .. A_{k-1}.
template <int N, class AAt, class BAt>
__device__ __forceinline__ void wg_chain(float (&acc)[N / 2], int K, AAt a_at, BAt b_at) {
  uint32_t a[4][4];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  pin(acc);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    if (k >= 4) {
      wg_wait<3>();   // the product that read this A buffer is done
      pin(a[k & 3]);
    }
    ldsm(a[k & 3], a_at(k));
    wg_fence();
    Wgmma<N>::run(acc, a[k & 3], b_desc(b_at(k)), k > 0);
    wg_commit();
  }
  wg_wait<0>();
  pin(acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) pin(a[i]);
}

// One fused encoder stage (K4) in bf16 on the tensor cores, persistent: block
// b takes items b, b + grid, ...  Its 16 warps are 4 warpgroups.  conv3 and
// conv1 take A (ELU(a) rows q .. q + 2, z rows) by ldmatrix into registers
// and B (w1, w2) from shared memory: warpgroup g the 64 r rows 64 (g % 2) ..
// and half the columns.  The downsample runs as y^T = wd^T . ELU(r)^T with
// both operands in shared memory: warpgroup g the output channels 64 g ..,
// all the frames; taps s .. 2s - 1 read each phase of ELU(r) one frame
// later, so they sum into a second accumulator that is added one column
// over (by lane shuffles) in the epilogue.  Where wd streams, each
// warpgroup copies its rows of wd^T into its own ring, refilling a slot
// once the product that read it has completed.
template <int C, int H, int CO, int S, bool kClocks>
__global__ void __launch_bounds__(kMmaThreads, 1)
stage_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1g,
                 const bf16* __restrict__ b1, const bf16* __restrict__ w2g,
                 const bf16* __restrict__ b2, const bf16* __restrict__ wdg,
                 const bf16* __restrict__ bd, bf16* __restrict__ y, MmaStage g,
                 unsigned long long* clocks, const __grid_constant__ CUtensorMap xmap) {
  using G = Geometry<C, H, CO, S>;
  constexpr int TILE = G::kTile, NF = G::kFrames, ROWS = G::kRows, NA = G::kNa;
  constexpr int RS = C + 8, ZS = H + 8;   // row strides of ELU(a) and of z
  constexpr int N3 = H / 2, N1 = C / 2;   // columns a warpgroup takes in conv3, conv1
  constexpr int MB = CO / 64;             // warpgroups in the downsample
  constexpr int SLOT = 64 * 32;           // bytes of a warpgroup's rows of one wd k-chunk
  constexpr int KCH = 2 * S * C / 16, KHALF = S * C / 16;   // k-chunks; those of taps < S
  static_assert(C % 16 == 0 && H % 16 == 0 && CO % 64 == 0 && MB <= 4 && NF % 8 == 0, "widths");
  static_assert(KCH % kBatch == 0, "whole batches of ring chunks");
  // where two warpgroup pairs split the downsample, d1 passes through an input tile
  static_assert(MB != 2 || CO * (NF + 4) * 4 <= C * G::kRawRs * 2, "the hand-over fits");
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned char* w1s = smem;
  const unsigned char* w2s = smem + g.off_w2;
  unsigned char* wds = smem + g.off_wd;
  bf16* raw0 = reinterpret_cast<bf16*>(smem + g.off_raw);
  unsigned char* eb = smem + g.off_e;     // ELU(a) rows, then ELU(r) by phase
  bf16* se = reinterpret_cast<bf16*>(eb);
  bf16* sz = reinterpret_cast<bf16*>(smem + g.off_z);
  float* sb1 = reinterpret_cast<float*>(smem + g.off_bias);
  float* sb2 = sb1 + H;
  float* sbd = sb2 + C;
  uint64_t* in_full = reinterpret_cast<uint64_t*>(smem + g.off_bar);   // an input tile landed
  uint64_t* ring_full = in_full + 2;   // [warpgroup][slot]: a ring chunk landed
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int wg = warp >> 2, wl = warp & 3;   // warpgroup, warp within it
  const Lanes ln(lane);
  PhaseClock<kClocks> laps(clocks);
  const int iters = blockIdx.x < g.items ? (g.items - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  auto item_of = [&](int n) { return n * (int)gridDim.x + (int)blockIdx.x; };
  auto first_row = [&](int item) {   // the global a row of local row 0
    return (item % g.tiles) * TILE * S - g.left - 1;
  };
  auto vec_tile = [&](int t_lo) { return g.vec && t_lo >= 0 && t_lo + NA <= g.len; };
  // ELU(r) row q = S j + p, channel c: phase p, 8-frame group j / 8, channel
  // group c / 8, one 16-byte row of an 8 x 8 core matrix (bytes)
  auto e_at = [&](int q, int c) {
    const int j = q / S;
    return (q % S) * G::kPhaseBytes + (j / 8) * C * 16 + (c / 8) * 128 + (j % 8) * 16 + (c % 8) * 2;
  };

  // the input tile of an item into buffer `buf`: rows t_lo .. t_lo + NA - 1
  // of every channel, [C][raw_rs]; interior tiles by one tensor copy (x as
  // [B C, L], a box of C rows by raw_rs columns from column t_lo & ~7),
  // completing on in_full[buf]; edge tiles through reflected indices from
  // row t_lo, by the threads themselves
  auto load_input = [&](int buf, int item) {
    bf16* raw = raw0 + buf * C * G::kRawRs;
    const int t_lo = first_row(item);
    const bf16* xb = x + (size_t)(item / g.tiles) * C * g.len;
    if (vec_tile(t_lo)) {
      if (tid == 0) {
        mbar_expect_tx(in_full + buf, C * G::kRawRs * 2);
        tma_load_2d(raw, &xmap, t_lo & ~7, (item / g.tiles) * C, in_full + buf);
      }
    } else {
      for (int c = warp; c < C; c += kMmaWarps) {
        for (int p = lane; p < NA; p += 32) {
          int t = t_lo + p;
          t = t < 0 ? -t : t;
          t = t >= g.len ? 2 * g.len - 2 - t : t;
          raw[c * G::kRawRs + p] = xb[(size_t)c * g.len + min(max(t, 0), g.len - 1)];
        }
      }
      // these generic writes come before the bulk copies that later reuse the buffer
      shared_to_async();
      if (tid == 0) mbar_expect_tx(in_full + buf, 0);
    }
  };

  // where wd streams, this warpgroup's ring: chunk q (counted over the
  // block's items) in slot q % kRing, one bulk copy of the warpgroup's rows
  // of wd^T by its first thread, completing on the slot's barrier
  const int total = g.ring ? iters * KCH : 0;
  unsigned char* ring = wds + wg * kRing * SLOT;
  uint64_t* full = ring_full + wg * kRing;
  auto fetch = [&](int q) {
    if (wl == 0 && lane == 0 && q < total) {
      mbar_expect_tx(full + q % kRing, SLOT);
      bulk_copy(ring + (q % kRing) * SLOT,
                reinterpret_cast<const unsigned char*>(wdg) + (size_t)(q % KCH) * CO * 32 + wg * SLOT,
                SLOT, full + q % kRing);
    }
  };

  // the weights (wd too where it is resident) and the biases, once a block
  for (int i = tid; i < 3 * C * H / 8; i += kMmaThreads) cp_async16((void*)(w1s + 16 * i), w1g + 8 * i, true);
  for (int i = tid; i < H * C / 8; i += kMmaThreads) cp_async16((void*)(w2s + 16 * i), w2g + 8 * i, true);
  if (!g.ring)
    for (int i = tid; i < 2 * S * C * CO / 8; i += kMmaThreads) cp_async16(wds + 16 * i, wdg + 8 * i, true);
  cp_commit();
  for (int i = tid; i < H; i += kMmaThreads) sb1[i] = to_f32(b1[i]);
  for (int i = tid; i < C; i += kMmaThreads) sb2[i] = to_f32(b2[i]);
  for (int i = tid; i < CO; i += kMmaThreads) sbd[i] = to_f32(bd[i]);
  if (tid == 0) {
    for (int i = 0; i < 2 + 4 * g.ring; ++i) mbar_init(in_full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_wait<0>();
  shared_to_async();   // the weights, copied by the threads, are read by the tensor cores
  __syncthreads();
  if (iters > 0) load_input(0, item_of(0));
  if (wg < MB && g.ring)
    for (int q = 0; q < kRing; ++q) fetch(q);

  int chunk = 0;   // ring chunks this warpgroup has consumed
  for (int n = 0; n < iters; ++n) {
    const int item = item_of(n);
    bf16* raw = raw0 + (n % g.in_bufs) * C * G::kRawRs;
    mbar_wait(in_full + n % g.in_bufs, (n / g.in_bufs) & 1);   // this item's input has landed
    laps.work(0);
    __syncthreads();
    laps.lap(0);
    const int t_lo = first_row(item);
    const int r0 = t_lo + 1, u0 = (r0 + g.left) / S;
    const int roff = vec_tile(t_lo) ? t_lo & 7 : 0;   // local row p is raw column p + roff

    // ELU(a) rows [NA][RS] from the input tile, two channels a thread, packed stores
    const int nch = (roff + NA + 7) / 8;
    for (int e = tid; e < (C / 2) * nch; e += kMmaThreads) {
      const int c = 2 * (e % (C / 2)), v = e / (C / 2);
      const uint4 lo = *reinterpret_cast<const uint4*>(raw + c * G::kRawRs + 8 * v);
      const uint4 hi = *reinterpret_cast<const uint4*>(raw + (c + 1) * G::kRawRs + 8 * v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = 8 * v + i - roff;
        const int row = (unsigned)p < (unsigned)NA ? p : NA;   // rows outside go to the spare row
        *reinterpret_cast<uint32_t*>(se + row * RS + c) =
            pack(elu(to_f32(element<bf16>(lo, i))), elu(to_f32(element<bf16>(hi, i))));
      }
    }
    laps.work(1);
    __syncthreads();
    laps.lap(1);

    // this warp's rows of the resnet products: r rows 64 (wg % 2) + 16 wl ..
    const int q_warp = 64 * (wg & 1) + 16 * wl;
    const int q_lane = q_warp + ln.ra;

    // z = ELU(conv3(ELU(a)) + b1): r row q reads ELU(a) rows q .. q + 2
    {
      float acc[N3 / 2];
      const int n0 = (wg >> 1) * N3;
      wg_chain<N3>(acc, 3 * C / 16,
                   [&](int k) { return se + (q_lane + k / (C / 16)) * RS + 16 * (k % (C / 16)) + ln.ca; },
                   [&](int k) { return w1s + k * H * 32 + (n0 / 8) * 256; });
#pragma unroll
      for (int j = 0; j < N3 / 8; ++j) {
        const int nn = n0 + 8 * j + 2 * tq;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = q_warp + gq + 8 * hh;
          *reinterpret_cast<uint32_t*>(sz + q * ZS + nn) =
              pack(elu(acc[4 * j + 2 * hh] + sb1[nn]), elu(acc[4 * j + 2 * hh + 1] + sb1[nn + 1]));
        }
      }
    }
    laps.work(2);
    __syncthreads();
    laps.lap(2);
    // the other input buffer was last read by the item before: the next item's copy starts here
    if (g.in_bufs == 2 && n + 1 < iters) load_input((n + 1) % 2, item_of(n + 1));

    // ELU(r), r = a + conv1(z) + b2, over the ELU(a) rows (no longer read),
    // by phase in the canonical layout the downsample's products read
    {
      float acc[N1 / 2];
      const int n0 = (wg >> 1) * N1;
      wg_chain<N1>(acc, H / 16, [&](int k) { return sz + q_lane * ZS + 16 * k + ln.ca; },
                   [&](int k) { return w2s + k * C * 32 + (n0 / 8) * 256; });
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int q = q_warp + gq + 8 * hh;
        const int col = q + 1 + roff;   // a row q + 1 in the input tile
        const int erow = e_at(q, 0);
#pragma unroll
        for (int j = 0; j < N1 / 8; ++j) {
          const int nn = n0 + 8 * j + 2 * tq;
          const float a0 = to_f32(raw[nn * G::kRawRs + col]);
          const float a1 = to_f32(raw[(nn + 1) * G::kRawRs + col]);
          *reinterpret_cast<uint32_t*>(eb + erow + (nn / 8) * 128 + (nn % 8) * 2) =
              pack(elu(a0 + acc[4 * j + 2 * hh] + sb2[nn]), elu(a1 + acc[4 * j + 2 * hh + 1] + sb2[nn + 1]));
        }
      }
    }
    laps.work(3);
    __syncthreads();
    laps.lap(3);
    // the one input buffer is free: the next item's copy runs under the downsample
    if (g.in_bufs == 1 && n + 1 < iters) load_input(0, item_of(n + 1));

    // the downsample's reflect pad at the sequence edges: ELU(r) row -i :=
    // row i, row L+i := row L-2-i (sources and destinations never overlap)
    if (r0 < 0 || u0 + TILE >= g.frames) {
      auto copy = [&](int dst, int src, int ch) {
        *reinterpret_cast<bf16*>(eb + e_at(dst, ch)) = *reinterpret_cast<const bf16*>(eb + e_at(src, ch));
      };
      if (r0 < 0)
        for (int e = tid; e < g.left * C; e += kMmaThreads) copy(-(e / C + 1) - r0, e / C + 1 - r0, e % C);
      if (u0 + TILE >= g.frames)
        for (int e = tid; e < g.right * C; e += kMmaThreads)
          copy(g.len + e / C - r0, g.len - 2 - e / C - r0, e % C);
      __syncthreads();
    }
    shared_to_async();   // ELU(r), written by the threads, is read by the tensor cores
    laps.work(4);
    __syncthreads();
    laps.lap(4);

    // downsample: out^T[co][m] = sum over taps k < S of wd_k^T ELU(r)_{phase k}[m]
    // plus, one frame later, taps S + p on phase p; chunk kk = tap * C/16 + cc
    auto product = [&](float (&d)[NF / 2], int kk, const unsigned char* a, int first) {
      const int k = kk / (C / 16), cc = kk % (C / 16);
      WgmmaSS<NF>::run(d, b_desc(a), kmajor_desc(eb + (k % S) * G::kPhaseBytes + cc * 256, C * 16),
                       kk != first);
    };
    if (MB == 2) {
      // two blocks of output channels: warpgroup g % 2's block, taps < S in
      // warpgroups 0 and 1 (d0), taps S .. 2S - 1 in 2 and 3 (d1, handed
      // over in fp32 through this item's input buffer, no longer read)
      float d[NF / 2];
      const int mb = wg & 1, first = wg < 2 ? 0 : KHALF;
      float* d1s = reinterpret_cast<float*>(raw);   // [128 channels][NF + 4]
#pragma unroll
      for (int i = 0; i < NF / 2; ++i) d[i] = 0.f;
      pin(d);
      wg_fence();
      for (int kk = first; kk < first + KHALF; ++kk) product(d, kk, wds + kk * CO * 32 + mb * SLOT, first);
      wg_commit();
      wg_wait<0>();
      pin(d);
      if (wg >= 2) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int co = 64 * mb + 16 * wl + gq + 8 * hh;
#pragma unroll
          for (int jb = 0; jb < NF / 8; ++jb)
            *reinterpret_cast<float2*>(d1s + co * (NF + 4) + 8 * jb + 2 * tq) =
                make_float2(d[4 * jb + 2 * hh], d[4 * jb + 2 * hh + 1]);
        }
        shared_to_async();   // the buffer's next writer is a bulk copy
      }
      __syncthreads();
      if (wg < 2) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int co = 64 * mb + 16 * wl + gq + 8 * hh;
#pragma unroll
          for (int jb = 0; jb < NF / 8; ++jb) {
            const int m = 8 * jb + 2 * tq;
            const float* next = d1s + co * (NF + 4) + m + 1;
            const float v0 = d[4 * jb + 2 * hh] + next[0] + sbd[co];
            const float v1 = d[4 * jb + 2 * hh + 1] + (m + 2 < NF ? next[1] : 0.f) + sbd[co];
            if (m + 1 < TILE)
              *reinterpret_cast<uint32_t*>(sz + co * G::kOutRs + m) = pack(v0, v1);
            else if (m < TILE)
              sz[co * G::kOutRs + m] = __float2bfloat16_rn(v0);
          }
        }
      }
    } else if (wg < MB) {
      float d0[NF / 2], d1[NF / 2];
#pragma unroll
      for (int i = 0; i < NF / 2; ++i) d0[i] = d1[i] = 0.f;
      pin(d0);
      pin(d1);
      wg_fence();
      auto both = [&](int kk, const unsigned char* a) {
        if (kk < KHALF) product(d0, kk, a, 0); else product(d1, kk, a, KHALF);
      };
      if (g.ring) {
        // a batch of chunks at a time: wait for them, multiply, and once the
        // batch before has completed in all four warps, refill its slots
        for (int kb = 0; kb < KCH; kb += kBatch) {
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int q = chunk + i;
            mbar_wait(full + q % kRing, (q / kRing) & 1);
            both(kb + i, ring + (q % kRing) * SLOT);
          }
          wg_commit();
          if (kb > 0) {
            wg_wait<1>();
            wg_sync(wg);
            for (int i = 0; i < kBatch; ++i) fetch(chunk - kBatch + i + kRing);
          }
          chunk += kBatch;
        }
        wg_wait<0>();
        wg_sync(wg);
        for (int i = 0; i < kBatch; ++i) fetch(chunk - kBatch + i + kRing);
      } else {
        for (int kk = 0; kk < KCH; ++kk) both(kk, wds + kk * CO * 32 + wg * SLOT);
        wg_commit();
        wg_wait<0>();
      }
      pin(d0);
      pin(d1);
      // out[co][m] = d0[m] + d1[m + 1] + bd: column m + 1 of d1 is this lane's
      // second value, column m + 2 the next lane's first (the next group's for tq = 3)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int co = 64 * wg + 16 * wl + gq + 8 * hh;
#pragma unroll
        for (int jb = 0; jb < NF / 8; ++jb) {
          const float next_in = __shfl_sync(0xffffffffu, d1[4 * jb + 2 * hh], (lane & ~3) | ((tq + 1) & 3));
          const float next_grp = __shfl_sync(0xffffffffu, jb + 1 < NF / 8 ? d1[4 * (jb + 1) + 2 * hh] : 0.f,
                                             lane & ~3);
          const int m = 8 * jb + 2 * tq;
          const float v0 = d0[4 * jb + 2 * hh] + d1[4 * jb + 2 * hh + 1] + sbd[co];
          const float v1 = d0[4 * jb + 2 * hh + 1] + (tq < 3 ? next_in : next_grp) + sbd[co];
          if (m + 1 < TILE)
            *reinterpret_cast<uint32_t*>(sz + co * G::kOutRs + m) = pack(v0, v1);
          else if (m < TILE)
            sz[co * G::kOutRs + m] = __float2bfloat16_rn(v0);
        }
      }
    }
    laps.work(5);
    __syncthreads();
    laps.lap(5);

    // the output tile, half a warp a channel row, the lanes along T storing
    // pairs of frames on 4-byte boundaries (a leading odd frame alone)
    const int fr = min(TILE, g.frames - u0);
    const size_t y0 = (size_t)(item / g.tiles) * CO * g.frames + u0;
    for (int nn = 2 * warp + (lane >> 4); nn < CO; nn += 2 * kMmaWarps) {
      const size_t at = y0 + (size_t)nn * g.frames;   // element index of frame 0
      const bf16* src = sz + nn * G::kOutRs;
      const int odd = (int)(at & 1);
      for (int m = odd + 2 * (lane & 15); m < fr; m += 32) {
        if (m + 1 < fr) {
          const __nv_bfloat162 v = __halves2bfloat162(src[m], src[m + 1]);
          *reinterpret_cast<__nv_bfloat162*>(y + at + m) = v;
        } else {
          y[at + m] = src[m];
        }
      }
      if (odd && (lane & 15) == 0) y[at] = src[0];
    }
    if constexpr (kClocks) {
      laps.work(6);
      __syncthreads();
      laps.lap(6);
    }
  }
  laps.flush();
}

// Launches the instance, or with info != nullptr only describes it: info[0..6]
// = registers per thread, shared bytes per block, blocks per SM, threads per
// block, local (spilled) bytes per thread, frames per tile, blocks launched.
template <typename K, typename... Args>
int launch_or_describe(K kernel, dim3 grid, int threads, size_t smem, int tile,
                       cudaStream_t stream, int* info, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (info) {
    cudaFuncAttributes fa;
    int blocks = 0;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
    info[0] = fa.numRegs, info[1] = (int)(fa.sharedSizeBytes + smem), info[2] = blocks;
    info[3] = threads, info[4] = (int)fa.localSizeBytes, info[5] = tile;
    info[6] = (int)(grid.x * grid.y);
    return 0;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// x as a 2D bf16 tensor [rows, len] with boxes of `box_rows` rows by
// `box_cols` columns, no swizzle, zeros past the edges; the encoder is the
// driver's cuTensorMapEncodeTiled, looked up once through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
cudaError_t input_map(CUtensorMap* map, const void* x, unsigned long long rows, int len,
                      int box_rows, int box_cols) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !fn) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)len, rows};
  const cuuint64_t strides[1] = {(cuuint64_t)len * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int C, int H, int CO, int S, bool kClocks>
int launch_mma(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               const void* wd, const void* bd, void* y, MmaStage g, int smem, cudaStream_t stream,
               unsigned long long* clocks, int* info, int max_blocks) {
  auto kernel = stage_mma_kernel<C, H, CO, S, kClocks>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // the persistent grid: as many blocks as are resident at once
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kMmaThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int resident = max_blocks > 0 ? min(max_blocks, per_sm * sms) : per_sm * sms;
  const dim3 grid(min(g.items, resident));
  CUtensorMap xmap{};
  if (g.vec && !info) {
    err = input_map(&xmap, x, (unsigned long long)g.batch * C, g.len, C, Geometry<C, H, CO, S>::kRawRs);
    if (err != cudaSuccess) return (int)err;
  }
  return launch_or_describe(kernel, grid, kMmaThreads, smem, Geometry<C, H, CO, S>::kTile, stream,
                            info, static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                            static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
                            static_cast<const bf16*>(b2), static_cast<const bf16*>(wd),
                            static_cast<const bf16*>(bd), static_cast<bf16*>(y), g, clocks, xmap);
}

// The register-tiled fp32 FMA variant: plan = {tile, rows, ring stages, slot
// floats, conv3 / conv1 / downsample chunk rows, shared bytes}, recomputed
// here and compared (ops/seanet.py:TiledPlan).
template <typename T, int C, int H, int CO, int S, bool kClocks>
int launch_tiled(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 const void* wd, const void* bd, void* y, int batch, int len, const int* plan,
                 cudaStream_t stream, unsigned long long* clocks, int* info, int max_blocks) {
  using G = Tiled<C, H, CO, S>;
  const int own[8] = {G::kTile, G::kRows, kFmaStages, G::kSlot, G::kC3, G::kC1, G::kCd, G::kBytes};
  for (int i = 0; i < 8; ++i)
    if (plan[i] != own[i]) return (int)cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2) |
                          reinterpret_cast<uintptr_t>(wd);
  if (align % 16) return (int)cudaErrorMisalignedAddress;
  const int frames = len / S, tiles = (frames + G::kTile - 1) / G::kTile;
  if ((long long)batch * tiles > (1 << 30)) return (int)cudaErrorInvalidValue;
  auto kernel = stage_tiled_kernel<T, C, H, CO, S, kClocks>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kBytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFmaThreads, G::kBytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int items = batch * tiles;
  const int resident = max_blocks > 0 ? min(max_blocks, per_sm * sms) : per_sm * sms;
  const int vec = len % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return launch_or_describe(kernel, dim3(min(items, resident)), kFmaThreads, G::kBytes, G::kTile,
                            stream, info, static_cast<const T*>(x), static_cast<const float*>(w1),
                            static_cast<const float*>(b1), static_cast<const float*>(w2),
                            static_cast<const float*>(b2), static_cast<const float*>(wd),
                            static_cast<const float*>(bd), static_cast<T*>(y), len, frames, tiles,
                            items, vec, clocks);
}

template <typename T, bool kClocks>
int launch_stage(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 const void* wd, const void* bd, void* y, Stage g, size_t smem,
                 cudaStream_t stream, unsigned long long* clocks, int* info) {
  const dim3 grid((g.frames + g.tile - 1) / g.tile, g.batch);
  return launch_or_describe(stage_kernel<T, kClocks>, grid, kThreads, smem, g.tile, stream, info,
                            static_cast<const T*>(x), static_cast<const T*>(w1),
                            static_cast<const T*>(b1), static_cast<const T*>(w2),
                            static_cast<const T*>(b2), static_cast<const T*>(wd),
                            static_cast<const T*>(bd), static_cast<T*>(y), g, clocks);
}

// ----------------------------------------------------------------- K5, K6

constexpr int kMaxTaps = 15;                    // taps of the generic instance
constexpr int kConvOuts = 8;                    // consecutive outputs a thread stores as 16 bytes
constexpr int kSegment = 32 * kConvOuts;        // outputs of one warp's segment
constexpr int kConvTile = 1024;                 // outputs of one item along T
constexpr int kSegments = kConvTile / kSegment;

struct Mono {
  int batch, t_in, t_out, c_out, taps, half;   // half < 0: K5 (x padded); else K6 (reflect)
  int tiles, items, groups;                     // T-tiles a row, batch * tiles, channel groups
  int vec_in;                                   // x 4-byte aligned: the interior copies by cp.async
  int vec_out;                                  // rows of y on 16 bytes: vector stores
};

// bytes of one input buffer, in 16-byte units: a tile, its taps - 1 halo
// and a leading half-word shift for bf16 (TAPS >= taps)
template <typename T, int TAPS>
__host__ __device__ constexpr int conv_buffer_bytes() {
  return (int)((kConvTile + TAPS + 1) * sizeof(T) + 15) / 16 * 16;
}

// Where item `item` reads: batch row b, first output t0, outputs len, input
// elements [e0, e0 + n) of the (reflected) row; interior items copy the
// 4-byte words that hold them by cp.async, `shift` elements into the first.
struct ConvItem {
  int b, t0, len, e0, n, shift;
  bool interior;
};

template <typename T>
__device__ __forceinline__ ConvItem conv_item(const Mono& g, int item) {
  ConvItem it;
  it.b = item / g.tiles;
  it.t0 = (item - it.b * g.tiles) * kConvTile;
  it.len = min(kConvTile, g.t_out - it.t0);
  it.n = it.len + g.taps - 1;
  it.e0 = it.t0 - (g.half >= 0 ? g.half : 0);
  const long long gi = (long long)it.b * g.t_in + it.e0;   // element index into x
  it.shift = sizeof(T) == 2 ? (int)(gi & 1) : 0;
  // the words must lie inside the row's reach and inside the tensor
  const int covered = ((it.n + it.shift) * (int)sizeof(T) + 3) / 4 * 4 / (int)sizeof(T);
  it.interior = g.vec_in && it.e0 >= 0 && it.e0 + it.n <= g.t_in &&
                gi - it.shift + covered <= (long long)g.batch * g.t_in;
  if (!it.interior) it.shift = 0;
  return it;
}

// The input of `item` into buf: by cp.async where interior, else element by
// element through reflected (K6) or plain (K5) indices
template <typename T>
__device__ __forceinline__ void conv_stage(const T* __restrict__ x, const Mono& g, int item,
                                           unsigned char* buf) {
  const ConvItem it = conv_item<T>(g, item);
  const T* row = x + (size_t)it.b * g.t_in;
  if (it.interior) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(row + it.e0 - it.shift);
    const int words = (int)(((it.n + it.shift) * sizeof(T) + 3) / 4);
    for (int w = threadIdx.x; w < words; w += kThreads) cp_async4(buf + 4 * w, src + w, true);
  } else {
    T* dst = reinterpret_cast<T*>(buf);
    for (int i = threadIdx.x; i < it.n; i += kThreads) {
      int t = it.e0 + i;
      t = t < 0 ? -t : t;
      t = t >= g.t_in ? 2 * g.t_in - 2 - t : t;
      dst[i] = row[min(max(t, 0), g.t_in - 1)];
    }
  }
}

// 8 outputs from 8 = 16 bytes of bf16 or 2 x 16 of fp32, streaming (evict first)
__device__ __forceinline__ void store8(float* dst, const float (&v)[kConvOuts]) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(dst) + 1, make_float4(v[4], v[5], v[6], v[7]));
}
__device__ __forceinline__ void store8(bf16* dst, const float (&v)[kConvOuts]) {
  __stcs(reinterpret_cast<uint4*>(dst),
         make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7])));
}

// y[b, c, t] = sum_d w[c, d] xin[b, t + d] + bias[c]; with half >= 0, xin is x
// reflect-padded by `half` on each side.  A persistent grid of blocks walks
// over items of kConvTile outputs of one batch row, the next item's input
// copied in while this one is computed.  In an item, warp w takes units
// (channel group, segment of 256 outputs) w, w + 8, ...: each lane computes 8
// consecutive outputs of CPT channels from a window of 8 + TAPS - 1 samples,
// with the group's weights and biases in registers (loaded when the group
// changes: never at the codec's 64 channels), and stores each channel's 8 as
// one 16-byte vector.  TAPS is the instance's; a generic instance takes any
// taps <= TAPS.
template <typename T, int TAPS, int CPT, bool kExactTaps>
__global__ void __launch_bounds__(kThreads, 2)
mono_conv_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
                 T* __restrict__ y, Mono g) {
  constexpr int BUF = conv_buffer_bytes<T, TAPS>();
  constexpr int WIN = kConvOuts + TAPS - 1;
  extern __shared__ __align__(16) unsigned char conv_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int taps = kExactTaps ? TAPS : g.taps;
  float wr[CPT][TAPS], br[CPT];
  int group = -1;

  int item = blockIdx.x;
  if (item < g.items) conv_stage(x, g, item, conv_smem);
  cp_commit();
  for (int i = 0; item < g.items; item += gridDim.x, ++i) {
    cp_wait<0>();
    __syncthreads();   // this item's input has landed; the other buffer is free
    const int next = item + gridDim.x;
    if (next < g.items) conv_stage(x, g, next, conv_smem + ((i + 1) & 1) * BUF);
    cp_commit();

    const ConvItem it = conv_item<T>(g, item);
    const T* xs = reinterpret_cast<const T*>(conv_smem + (i & 1) * BUF) + it.shift;
    for (int u = warp; u < g.groups * kSegments; u += kWarps) {
      const int gr = u % g.groups, o0 = (u / g.groups) * kSegment + lane * kConvOuts;
      if (gr != group) {   // the group's weights and biases into registers
        group = gr;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int ch = gr * CPT + c;
#pragma unroll
          for (int d = 0; d < TAPS; ++d)
            wr[c][d] = ch < g.c_out && d < taps ? to_f32(w[ch * taps + d]) : 0.f;
          br[c] = ch < g.c_out ? bias[ch] : 0.f;
        }
      }
      if (o0 >= it.len) continue;
      float win[WIN];
#pragma unroll
      for (int j = 0; j < WIN; ++j) win[j] = to_f32(xs[o0 + j]);
      const bool whole = g.vec_out && o0 + kConvOuts <= it.len;
      T* dst = y + ((size_t)it.b * g.c_out + gr * CPT) * g.t_out + it.t0 + o0;
#pragma unroll
      for (int c = 0; c < CPT; ++c, dst += g.t_out) {
        if (gr * CPT + c >= g.c_out) break;
        float v[kConvOuts];
#pragma unroll
        for (int o = 0; o < kConvOuts; ++o) {
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < TAPS; ++d)
            if (kExactTaps || d < taps) acc = fmaf(win[o + d], wr[c][d], acc);
          v[o] = acc + br[c];
        }
        if (whole) {
          store8(dst, v);
        } else {
#pragma unroll
          for (int o = 0; o < kConvOuts; ++o)
            if (o0 + o < it.len) dst[o] = from_f32<T>(v[o]);
        }
      }
    }
  }
}

// The mono conv's plan for c_out channels of `taps` taps: {taps of the
// instance, channels a thread, outputs a thread, outputs an item, shared
// bytes}; ops/seanet.py:mono_conv_plan computes the same.
template <typename T>
void mono_plan(int taps, int* plan) {
  const bool codec = taps == 7;
  plan[0] = codec ? 7 : kMaxTaps;
  plan[1] = codec ? 8 : 4;
  plan[2] = kConvOuts;
  plan[3] = kConvTile;
  plan[4] = 2 * (codec ? conv_buffer_bytes<T, 7>() : conv_buffer_bytes<T, kMaxTaps>());
}

template <typename T, int TAPS, int CPT, bool kExactTaps>
int launch_mono(const void* x, const void* w, const float* bias, void* y, Mono g, int smem,
                cudaStream_t stream) {
  auto kernel = mono_conv_kernel<T, TAPS, CPT, kExactTaps>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  g.groups = (g.c_out + CPT - 1) / CPT;
  kernel<<<min(g.items, per_sm * sms), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, static_cast<T*>(y), g);
  return (int)cudaGetLastError();
}

template <typename T>
int run_mono(const void* x, const void* w, const float* bias, void* y, Mono g, const int* plan,
             cudaStream_t stream) {
  int own[5];
  mono_plan<T>(g.taps, own);
  for (int i = 0; i < 5; ++i)
    if (own[i] != plan[i]) return (int)cudaErrorInvalidValue;
  g.vec_in = reinterpret_cast<uintptr_t>(x) % 4 == 0;
  g.vec_out = reinterpret_cast<uintptr_t>(y) % 16 == 0 && g.t_out * sizeof(T) % 16 == 0;
  return own[0] == 7 ? launch_mono<T, 7, 8, true>(x, w, bias, y, g, own[4], stream)
                     : launch_mono<T, kMaxTaps, 4, false>(x, w, bias, y, g, own[4], stream);
}

// The variants of K4 (ops/seanet.py:stage_route)
enum Variant { kSimt = 0, kTiledFma = 1, kTensorCores = 2 };

// K4 by variant: kSimt, stage_kernel (no plan; its tile chosen here);
// kTiledFma, plan as launch_tiled takes it; kTensorCores, plan = {tile,
// in_bufs, ring, shared bytes}, whose shared bytes are recomputed and must
// agree.
template <bool kClocks>
int run_stage(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
              const void* wd, const void* bd, void* y, int batch, int c, int h, int c_out,
              int len, int stride, int is_bf16, int variant, const int* plan, void* stream,
              unsigned long long* clocks, int* info, int max_blocks = 0) {
  if (batch <= 0 || c <= 0 || h <= 0 || c_out <= 0 || stride <= 0 || len < 2 ||
      len % stride != 0)
    return (int)cudaErrorInvalidValue;
  if ((variant == kSimt) != (plan == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int right = stride / 2, left = stride - right, frames = len / stride;
  if (variant == kTiledFma) {
#define ACX_TILED(C, H, CO, S)                                                                 \
  if (c == C && h == H && c_out == CO && stride == S)                                          \
    return is_bf16 ? launch_tiled<bf16, C, H, CO, S, kClocks>(x, w1, b1, w2, b2, wd, bd, y,    \
                                                             batch, len, plan, s, clocks,      \
                                                             info, max_blocks)                 \
                   : launch_tiled<float, C, H, CO, S, kClocks>(x, w1, b1, w2, b2, wd, bd, y,   \
                                                              batch, len, plan, s, clocks,     \
                                                              info, max_blocks);
    ACX_TILED(64, 32, 128, 4)
    ACX_TILED(128, 64, 256, 4)
    ACX_TILED(32, 16, 64, 2)
    ACX_TILED(4, 2, 8, 16)
    ACX_TILED(4, 2, 8, 8)
#undef ACX_TILED
    return (int)cudaErrorInvalidValue;
  }
  if (variant == kTensorCores) {
    MmaStage g{};
    g.batch = batch, g.len = len, g.frames = frames, g.left = left, g.right = right;
    g.in_bufs = plan[1], g.ring = plan[2];
    if (!is_bf16 || g.in_bufs < 1 || g.in_bufs > 2 || (g.ring != 0 && g.ring != kRing))
      return (int)cudaErrorInvalidValue;
    g.vec = len % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
#define ACX_MMA(C, H, CO, S)                                                                 \
  if (c == C && h == H && c_out == CO && stride == S) {                                      \
    using G = Geometry<C, H, CO, S>;                                                         \
    if (plan[0] != G::kTile || (g.ring && CO != 256) || (CO == 128 && g.in_bufs != 2))      \
      return (int)cudaErrorInvalidValue;                                                     \
    g.tiles = (frames + G::kTile - 1) / G::kTile;                                            \
    if ((long long)batch * g.tiles > (1 << 30)) return (int)cudaErrorInvalidValue;           \
    g.items = batch * g.tiles;                                                               \
    const int smem = mma_geometry<C, H, CO, S>(g);                                           \
    if (smem != plan[3] || smem > kSmemLimit || g.off_raw % 128 ||                           \
        (C * G::kRawRs * 2) % 128)                                                           \
      return (int)cudaErrorInvalidValue;                                                     \
    return launch_mma<C, H, CO, S, kClocks>(x, w1, b1, w2, b2, wd, bd, y, g, smem, s, clocks, info, \
                                            max_blocks);                                     \
  }
    ACX_MMA(32, 16, 64, 2)
    ACX_MMA(64, 32, 128, 4)
    ACX_MMA(128, 64, 256, 4)
#undef ACX_MMA
    return (int)cudaErrorInvalidValue;
  }
  if (variant != kSimt) return (int)cudaErrorInvalidValue;
  const int tile = choose_tile(c, h, c_out, stride, is_bf16);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  Stage g{};
  g.batch = batch, g.c = c, g.h = h, g.c_out = c_out, g.len = len, g.stride = stride;
  g.frames = frames, g.right = right, g.left = left;
  const size_t smem = stage_geometry(g, tile, is_bf16 ? 2 : 4);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  return is_bf16 ? launch_stage<bf16, kClocks>(x, w1, b1, w2, b2, wd, bd, y, g, smem, s, clocks, info)
                 : launch_stage<float, kClocks>(x, w1, b1, w2, b2, wd, bd, y, g, smem, s, clocks,
                                                info);
}

}  // namespace

// One fused encoder stage (K4): x [B, C, L] -> y [B, C_out, L / stride], x
// and y in one dtype (bf16 when is_bf16, else fp32).  Weights are K-major:
// w1 [3C, H], w2 [H, C], wd [2 stride C, C_out]: in x's dtype for kSimt, in
// fp32 (biases too) for kTiledFma, in the order of
// ops/seanet.py:pack_b_tiles for kTensorCores (bf16, at the widths
// instantiated above).  Returns cudaErrorInvalidValue for widths, lengths,
// variants or plans the kernels do not take.
extern "C" int acx_seanet_stage(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* wd, const void* bd, void* y,
                                int batch, int c, int h, int c_out, int len, int stride,
                                int is_bf16, int variant, const int* plan, void* stream) {
  return run_stage<false>(x, w1, b1, w2, b2, wd, bd, y, batch, c, h, c_out, len, stride,
                          is_bf16, variant, plan, stream, nullptr, nullptr);
}

// The same launch with the per-phase cycle counter on: clocks[2 * kPhases]
// (zeroed by the caller) collects each phase's cycles summed over blocks, then
// each phase's work cycles summed over the warps (tensor-core variant); with
// max_blocks > 0 a persistent grid takes at most that many blocks (how its
// time scales with the SMs it is given).  A measurement: no model path
// calls it.
extern "C" int acx_seanet_stage_clocks(const void* x, const void* w1, const void* b1,
                                       const void* w2, const void* b2, const void* wd,
                                       const void* bd, void* y, int batch, int c, int h,
                                       int c_out, int len, int stride, int is_bf16, int variant,
                                       const int* plan, void* clocks, int max_blocks,
                                       void* stream) {
  return run_stage<true>(x, w1, b1, w2, b2, wd, bd, y, batch, c, h, c_out, len, stride,
                         is_bf16, variant, plan, stream, static_cast<unsigned long long*>(clocks),
                         nullptr, max_blocks);
}

// What the production instance for this launch uses, into out[7] (see
// launch_or_describe); nothing is launched.
extern "C" int acx_seanet_stage_info(int batch, int c, int h, int c_out, int len, int stride,
                                     int is_bf16, int variant, const int* plan, int* out) {
  return run_stage<false>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, batch, c, h, c_out, len, stride, is_bf16, variant, plan,
                          nullptr, nullptr, out);
}

// The mono input conv: K5 (half < 0: x [B, 1, t_out + taps - 1] already
// padded) or K6 (half = (taps - 1) / 2: x [B, 1, t_in], t_in = t_out,
// reflect-padded inside).  w [c_out, taps] in x's dtype, bias fp32 [c_out];
// plan[5] as mono_plan gives it, or cudaErrorInvalidValue.
extern "C" int acx_mono_conv(const void* x, const void* w, const float* bias, void* y, int batch,
                             int t_in, int t_out, int c_out, int taps, int half, int is_bf16,
                             const int* plan, void* stream) {
  if (batch <= 0 || t_in <= 0 || t_out <= 0 || c_out <= 0 || taps <= 0 || taps > kMaxTaps ||
      !plan)
    return (int)cudaErrorInvalidValue;
  if (half >= 0 && (t_in != t_out || t_in <= half)) return (int)cudaErrorInvalidValue;
  if (half < 0 && t_in != t_out + taps - 1) return (int)cudaErrorInvalidValue;
  const int tiles = (t_out + kConvTile - 1) / kConvTile;
  if ((long long)batch * tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Mono g{batch, t_in, t_out, c_out, taps, half, tiles, batch * tiles, 0, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? run_mono<bf16>(x, w, bias, y, g, plan, s)
                 : run_mono<float>(x, w, bias, y, g, plan, s);
}
