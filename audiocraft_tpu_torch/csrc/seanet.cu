// SEANet encoder kernels: one fused encoder stage (K4) and the mono input
// conv (K5 on a padded signal, K6 with the reflect pad built in).
//
// K4 replaces audiocraft_tpu/ops/seanet_pallas.py:_stage_kernel.  For one
// batch row and a tile of `tile` output frames, a block computes
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
// the bf16 tensor-core rate) on 3.9 GB.  So bf16 runs the three products on
// tensor cores (mma.sync m16n8k16, fp32 accumulation: the variant for widths
// of whole 16 x 8 tiles).  Each product reads its A operand straight from
// the shared-memory rows: for conv3 row q the depth index d*C + c is row
// q + d, channel c; for the downsample frame m it is row s*m + k, channel c,
// so no im2col copy is made.  The weights (the stage-1 downsample alone is
// 0.5 MB in bf16, more than an SM's shared memory) are read from L2 in the
// order the B fragments take them (ops/seanet.py:pack_mma_fragments), a
// warp's fragment being 256 contiguous bytes, kDepthB chunks ahead of their
// products; each warp owns a group of output columns of a product, so each
// weight fragment is read once per block.  fp32 (the parity path) and
// widths off the tiles run the same phases with fp32 FMA outside the tensor
// cores.  Offsets into the activations are 64-bit: stage 0 at b128 holds
// 2.6e9 elements.
//
// What the first version measured, and what the design does about it (per
// phase clock counts on the card): the kernel was bound by issued
// instructions and memory requests, not by the tensor cores.  So interior
// tiles load the input with 16-byte loads, the lanes of a warp on
// consecutive channels (their transposing stores hit distinct banks); the
// biases sit in shared memory as fp32; the k-loop advances its tap and
// channel without a division; bf16 epilogues store packed pairs; ELU(r) takes
// a row stride of its own, chosen so that the downsample's rows, `stride`
// apart, fall on distinct banks; and the tile is the largest that lets two
// blocks share an SM (64 frames at stage 0, 32 at stage 1).
//
// K5 and K6 replace _banded_conv_kernel and _mono_conv_kernel of the same
// file: y[b, c, t] = sum_d w[c, d] x[b, t + d] + bias[c] for C_in = 1, a
// memory-bound conv (5.3 GB and 37 GFLOP at b128 x 10 s in bf16: 1.59 ms).
// A block loads a tile of 1024 samples and its halo once into shared memory
// and writes all C_out channels of the tile, each warp's stores consecutive
// along T; the sums are fp32.  K6 reads its input through reflected indices
// instead of a padded copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;  // the dynamic shared memory a block may use
constexpr int kPadMma = 8;          // row padding: fragment reads hit distinct banks
constexpr int kVecBatch = 4;        // 16-byte input loads a thread keeps in flight
constexpr int kDepthB = 4;          // k-chunks of B fragments loaded ahead

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// ELU(alpha = 1) as the TPU kernel writes it; __expf's relative error (a few
// fp32 steps) is far below both dtypes' checks
__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : __expf(fminf(v, 0.f)) - 1.f; }

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// d += a . b for a 16x16 bf16 A (row), a 16x8 bf16 B (col), fp32 16x8 D
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// Lane `lane`'s B fragment (k-chunk kc, n-tile nt) of the packed weights;
// zeros past the last chunk or tile.
__device__ __forceinline__ uint2 b_fragment(const uint2* __restrict__ wf, int kc, int nt,
                                            int kchunks, int ntiles, int lane) {
  if (kc >= kchunks || nt >= ntiles) return make_uint2(0u, 0u);
  return __ldg(wf + ((size_t)kc * ntiles + nt) * 32 + lane);
}

// Tensor-core product over the view: warps take items of MT 16-row tiles by
// NG 8-column tiles; wf holds the B fragments (k-chunk, n-tile, lane, 4).
// Rows past M are read clamped and dropped.  epi(m, n, v[n], v[n + 1]).
template <int MT, int NG, class Epi>
__device__ void mma_product(int M, int ntiles, RowView<bf16> av, const uint2* __restrict__ wf,
                            Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int kchunks = av.taps * av.width / 16;
  const int mtiles = (M + 15) / 16;
  const int mblocks = (mtiles + MT - 1) / MT, ngroups = (ntiles + NG - 1) / NG;
  for (int item = warp; item < mblocks * ngroups; item += kWarps) {
    const int mb = item / ngroups, ng = item % ngroups;
    float acc[MT][NG][4];
    int rows[MT][2];   // element offsets of this lane's two A rows of each m-tile
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min((mb * MT + i) * 16 + gq + 8 * h, M - 1);
        rows[i][h] = (m * av.rowstep + av.rowoff) * av.rs + 2 * tq;
      }
    }
    int tap_ofs = 0, ch = 0;   // the chunk's tap (as a row offset) and first channel
    // B fragments come from L2 kDepthB chunks ahead of their products, in a
    // ring of registers, so that the products do not wait on each load
    uint2 ring[kDepthB][NG];
#pragma unroll
    for (int d = 0; d < kDepthB; ++d)
#pragma unroll
      for (int j = 0; j < NG; ++j) ring[d][j] = b_fragment(wf, d, ng * NG + j, kchunks, ntiles, lane);
    for (int kc0 = 0; kc0 < kchunks; kc0 += kDepthB) {
#pragma unroll
      for (int d = 0; d < kDepthB; ++d) {
        const int kc = kc0 + d;
        if (kc >= kchunks) break;
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const bf16* p0 = av.buf + rows[i][0] + tap_ofs + ch;
          const bf16* p1 = av.buf + rows[i][1] + tap_ofs + ch;
          a[i][0] = *reinterpret_cast<const uint32_t*>(p0);
          a[i][1] = *reinterpret_cast<const uint32_t*>(p1);
          a[i][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
          a[i][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
        }
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          if (ng * NG + j < ntiles) {
#pragma unroll
            for (int i = 0; i < MT; ++i) mma(acc[i][j], a[i], ring[d][j].x, ring[d][j].y);
          }
        }
#pragma unroll
        for (int j = 0; j < NG; ++j)
          ring[d][j] = b_fragment(wf, kc + kDepthB, ng * NG + j, kchunks, ntiles, lane);
        ch += 16;
        if (ch == av.width) ch = 0, tap_ofs += av.rs;
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int nt = ng * NG + j;
        if (nt >= ntiles) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (mb * MT + i) * 16 + gq + 8 * h;
          if (m < M) epi(m, nt * 8 + 2 * tq, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
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

// One fused encoder stage (K4).  grid (tiles of frames, batch).
template <typename T, bool kMma, int kTile>
__global__ void __launch_bounds__(kThreads)
stage_kernel(const T* __restrict__ x, const void* __restrict__ w1v, const T* __restrict__ b1,
             const void* __restrict__ w2v, const T* __restrict__ b2,
             const void* __restrict__ wdv, const T* __restrict__ bd, T* __restrict__ y, Stage g) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);      // a rows r0-1 .. ; later the output tile
  T* se = sa + g.stage_elems;              // ELU(a) rows; later ELU(r), r row q at row q+1
  T* sz = se + (size_t)g.na * max(g.rs_a, g.rs_e);   // z rows
  float* sb1 = reinterpret_cast<float*>(smem + g.bias_offset);   // the biases in fp32
  float* sb2 = sb1 + g.h;
  float* sbd = sb2 + g.c;
  constexpr int kVec = 16 / sizeof(T);   // elements of one 16-byte load
  const int tile = kMma ? kTile : g.tile;
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

  // z = ELU(conv3(ELU(a)) + b1) for r rows 0 .. nr-1 (r row q reads a rows q-1 .. q+1)
  auto z_out = [&](int m, int n, float v) {
    sz[m * g.rs_z + n] = from_f32<T>(elu(v + sb1[n]));
  };
  const RowView<T> conv3{se, g.rs_a, 1, 0, 3, g.c};
  if constexpr (kMma) {
    mma_product<2, 4>(g.nr, g.h / 8, conv3, static_cast<const uint2*>(w1v),
                      [&](int m, int n, float v0, float v1) {
      *reinterpret_cast<uint32_t*>(sz + m * g.rs_z + n) =
          pack_bf16(elu(v0 + sb1[n]), elu(v1 + sb1[n + 1]));
    });
  } else {
    simt_product(g.nr, g.h, conv3, static_cast<const T*>(w1v), z_out);
  }
  __syncthreads();

  // ELU(r), r = a + conv1(z) + b2, in place of the ELU(a) rows (no longer
  // read), r row q at row q + 1 with row stride rs_e
  auto e_out = [&](int m, int n, float v) {
    se[(m + 1) * g.rs_e + n] = from_f32<T>(elu(to_f32(sa[(m + 1) * g.rs_a + n]) + v + sb2[n]));
  };
  const RowView<T> conv1{sz, g.rs_z, 1, 0, 1, g.h};
  if constexpr (kMma) {
    mma_product<2, 4>(g.nr, g.c / 8, conv1, static_cast<const uint2*>(w2v),
                      [&](int m, int n, float v0, float v1) {
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(sa + (m + 1) * g.rs_a + n);
      *reinterpret_cast<uint32_t*>(se + (m + 1) * g.rs_e + n) =
          pack_bf16(elu(bf16_lo(a2) + v0 + sb2[n]), elu(bf16_hi(a2) + v1 + sb2[n + 1]));
    });
  } else {
    simt_product(g.nr, g.c, conv1, static_cast<const T*>(w2v), e_out);
  }
  __syncthreads();

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

  // downsample: frame m reads ELU(r) rows s*m .. s*m + 2s - 1; the output
  // tile goes through shared memory so that the stores run along T
  const int frames = min(tile, g.frames - u0);
  auto y_out = [&](int m, int n, float v) {
    sa[n * g.out_rs + m] = from_f32<T>(v + sbd[n]);
  };
  const RowView<T> down{se, g.rs_e, g.stride, 1, 2 * g.stride, g.c};
  if constexpr (kMma) {
    mma_product<kTile / 16, 2>(frames, g.c_out / 8, down, static_cast<const uint2*>(wdv),
                               [&](int m, int n, float v0, float v1) { y_out(m, n, v0); y_out(m, n + 1, v1); });
  } else {
    simt_product(frames, g.c_out, down, static_cast<const T*>(wdv), y_out);
  }
  __syncthreads();
  T* yb = y + (size_t)b * g.c_out * g.frames + u0;
  for (int e = threadIdx.x; e < g.c_out * tile; e += kThreads) {
    const int n = e / tile, m = e - n * tile;
    if (m < frames) yb[(size_t)n * g.frames + m] = sa[n * g.out_rs + m];
  }
}

// The geometry of a tile of `tile` frames, and its shared-memory bytes.
size_t stage_geometry(Stage& g, int tile, int elem, int pad) {
  g.tile = tile;
  g.nr = g.stride * (tile + 1);   // r rows s*u0 - left .. s*(u0 + tile) + s - left - 1
  g.na = g.nr + 2;
  g.rs_a = g.c + pad;
  g.rs_z = g.h + pad;
  g.rs_e = g.c + pad;
  if (pad) {
    // the downsample reads rows `stride` apart: take the row stride whose 8
    // rows x 4 words of a fragment load fall on the fewest shared banks
    int best = 1 << 30;
    for (int rs = g.c; rs <= g.c + 32; rs += 2) {
      int count[32] = {0}, worst = 0;
      for (int r = 0; r < 8; ++r)
        for (int t = 0; t < 4; ++t) {
          const int bank = (r * g.stride * (rs / 2) + t) % 32;
          worst = max(worst, ++count[bank]);
        }
      if (worst < best) best = worst, g.rs_e = rs;
    }
  }
  g.out_rs = tile + pad;
  int stage = g.na * g.rs_a;
  if (g.c_out * g.out_rs > stage) stage = g.c_out * g.out_rs;
  g.stage_elems = (stage + 7) / 8 * 8;
  const int rs_se = max(g.rs_a, g.rs_e);
  const size_t elems = (size_t)g.stage_elems + (size_t)g.na * rs_se + (size_t)g.nr * g.rs_z;
  g.bias_offset = (int)((elems * elem + 15) / 16 * 16);
  return g.bias_offset + sizeof(float) * ((size_t)g.h + g.c + g.c_out);
}

int choose_tile(int c, int h, int c_out, int stride, int is_bf16, int use_mma) {
  Stage g{};
  g.c = c, g.h = h, g.c_out = c_out, g.stride = stride;
  const int elem = is_bf16 ? 2 : 4;
  const int pad = use_mma ? kPadMma : 0;
  const int tiles[] = {64, 32, 16, 8};
  // two blocks per SM where a tile of 32 frames or more allows it (measured
  // faster than one block of a larger tile), else the largest that fits
  const int blocks_per_sm[] = {2, 1};
  for (int blocks : blocks_per_sm) {
    for (int tile : tiles) {
      if ((use_mma || blocks == 2) && tile < 32) break;
      if (stage_geometry(g, tile, elem, pad) * blocks <= (size_t)kSmemLimit) return tile;
    }
  }
  return 0;
}

template <typename T, bool kMma, int kTile>
int launch_stage(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 const void* wd, const void* bd, void* y, Stage g, size_t smem,
                 cudaStream_t stream) {
  auto kernel = stage_kernel<T, kMma, kTile>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.frames + g.tile - 1) / g.tile, g.batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w1, static_cast<const T*>(b1), w2, static_cast<const T*>(b2), wd,
      static_cast<const T*>(bd), static_cast<T*>(y), g);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- K5, K6

constexpr int kMaxTaps = 15;     // taps a thread keeps in registers
constexpr int kConvTile = 1024;  // outputs per block along T

// y[b, c, t] = sum_d w[c, d] xin[b, t + d] + bias[c]; with kReflect, xin is x
// reflect-padded by `half` on each side, read through reflected indices.
template <typename T, bool kReflect>
__global__ void __launch_bounds__(kThreads)
mono_conv_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
                 T* __restrict__ y, int t_in, int t_out, int c_out, int taps, int half) {
  extern __shared__ float fsmem[];
  float* xs = fsmem;                          // kConvTile + taps - 1 samples
  float* ws = xs + kConvTile + kMaxTaps;      // [c_out][taps]
  float* bs = ws + c_out * taps;
  const int b = blockIdx.y, t0 = blockIdx.x * kConvTile;
  const T* xb = x + (size_t)b * t_in;
  for (int i = threadIdx.x; i < kConvTile + taps - 1; i += kThreads) {
    int t = t0 + i;
    float v = 0.f;
    if (kReflect) {
      t -= half;
      t = t < 0 ? -t : t;
      t = t >= t_in ? 2 * t_in - 2 - t : t;
      v = to_f32(xb[min(max(t, 0), t_in - 1)]);
    } else if (t < t_in) {
      v = to_f32(xb[t]);
    }
    xs[i] = v;
  }
  for (int i = threadIdx.x; i < c_out * taps; i += kThreads) ws[i] = to_f32(w[i]);
  for (int i = threadIdx.x; i < c_out; i += kThreads) bs[i] = bias[i];
  __syncthreads();
  for (int j = 0; j < kConvTile / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int t = t0 + i;
    if (t >= t_out) break;
    float win[kMaxTaps];
#pragma unroll
    for (int d = 0; d < kMaxTaps; ++d) win[d] = d < taps ? xs[i + d] : 0.f;
    T* yt = y + (size_t)b * c_out * t_out + t;
    for (int c = 0; c < c_out; ++c) {
      const float* wc = ws + c * taps;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxTaps; ++d)
        if (d < taps) acc = fmaf(win[d], wc[d], acc);
      yt[(size_t)c * t_out] = from_f32<T>(acc + bs[c]);
    }
  }
}

template <typename T, bool kReflect>
int launch_mono(const void* x, const void* w, const float* bias, void* y, int batch, int t_in,
                int t_out, int c_out, int taps, int half, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kConvTile + kMaxTaps + (size_t)c_out * (taps + 1));
  const dim3 grid((t_out + kConvTile - 1) / kConvTile, batch);
  mono_conv_kernel<T, kReflect><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, static_cast<T*>(y), t_in, t_out,
      c_out, taps, half);
  return (int)cudaGetLastError();
}

}  // namespace

// One fused encoder stage (K4): x [B, C, L] -> y [B, C_out, L / stride], all
// in one dtype (bf16 when is_bf16, else fp32).  Weights are K-major: w1
// [3C, H], w2 [H, C], wd [2 stride C, C_out]; with use_mma (bf16, C and H
// multiples of 16, C_out of 8) they come in B-fragment order instead.
// Returns cudaErrorInvalidValue when no tile of these widths fits shared
// memory (the frames per block: the largest of 64, 32, 16, 8 that fits; the
// tensor-core variant takes 64 or 32).
extern "C" int acx_seanet_stage(const void* x, const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* wd, const void* bd, void* y,
                                int batch, int c, int h, int c_out, int len, int stride,
                                int is_bf16, int use_mma, void* stream) {
  if (batch <= 0 || c <= 0 || h <= 0 || c_out <= 0 || stride <= 0 || len < 2 ||
      len % stride != 0)
    return (int)cudaErrorInvalidValue;
  if (use_mma && (!is_bf16 || c % 16 || h % 16 || c_out % 8)) return (int)cudaErrorInvalidValue;
  const int tile = choose_tile(c, h, c_out, stride, is_bf16, use_mma);
  if (tile == 0 || (use_mma && tile != 64 && tile != 32)) return (int)cudaErrorInvalidValue;
  Stage g{};
  g.batch = batch, g.c = c, g.h = h, g.c_out = c_out, g.len = len, g.stride = stride;
  g.frames = len / stride;
  g.right = stride / 2;
  g.left = stride - g.right;
  const size_t smem = stage_geometry(g, tile, is_bf16 ? 2 : 4, use_mma ? kPadMma : 0);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (use_mma) {
    return tile == 64 ? launch_stage<bf16, true, 64>(x, w1, b1, w2, b2, wd, bd, y, g, smem, s)
                      : launch_stage<bf16, true, 32>(x, w1, b1, w2, b2, wd, bd, y, g, smem, s);
  }
  return is_bf16 ? launch_stage<bf16, false, 0>(x, w1, b1, w2, b2, wd, bd, y, g, smem, s)
                 : launch_stage<float, false, 0>(x, w1, b1, w2, b2, wd, bd, y, g, smem, s);
}

// The mono input conv: K5 (half < 0: x [B, 1, t_out + taps - 1] already
// padded) or K6 (half = (taps - 1) / 2: x [B, 1, t_in], t_in = t_out,
// reflect-padded inside).  w [c_out, taps] in x's dtype, bias fp32 [c_out].
extern "C" int acx_mono_conv(const void* x, const void* w, const float* bias, void* y, int batch,
                             int t_in, int t_out, int c_out, int taps, int half, int is_bf16,
                             void* stream) {
  if (batch <= 0 || t_in <= 0 || t_out <= 0 || c_out <= 0 || taps <= 0 || taps > kMaxTaps)
    return (int)cudaErrorInvalidValue;
  if (half >= 0 && (t_in != t_out || t_in <= half)) return (int)cudaErrorInvalidValue;
  if (half < 0 && t_in != t_out + taps - 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (half >= 0) {
    return is_bf16 ? launch_mono<bf16, true>(x, w, bias, y, batch, t_in, t_out, c_out, taps, half, s)
                   : launch_mono<float, true>(x, w, bias, y, batch, t_in, t_out, c_out, taps, half, s);
  }
  return is_bf16 ? launch_mono<bf16, false>(x, w, bias, y, batch, t_in, t_out, c_out, taps, 0, s)
                 : launch_mono<float, false>(x, w, bias, y, batch, t_in, t_out, c_out, taps, 0, s);
}
