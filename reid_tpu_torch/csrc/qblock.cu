// se_basic_block_s8: the whole stride-1 SE basic block in int8, bf16 in and
// bf16 out (the track path's bf16 trunk) or f32 in and f32 out (the
// retrieval path's f32 trunk), as five or six launches on one stream.
//
// Replaces the TPU kernel reid_tpu/ops/qblock.py:se_basic_block_s8
// (_qblock_kernel), which keeps the block's weights and a slab of images
// resident in about 10 MB of VMEM so that the only HBM traffic is one read
// of the block input and one write of its output. An SM has 227 KB of
// shared memory and block42's two int8 weight tensors alone are 4.7 MB, so
// here the block is a short sequence of launches whose three GEMMs (conv1,
// conv2 and the 1x1 down conv) run on the Hopper mainloop that conv3x3_s8
// uses (wgmma_s8.cuh: wgmma s8 fed by TMA, the implicit im2col as a tiled
// TMA box, a persistent grid), each with a fused epilogue that keeps what
// one tile can hold on chip:
//   1. quantize x (and x for the down branch) to int8: one elementwise pass,
//      since TMA loads int8;
//   2. conv1. Plain BN: relu(acc*a1 + c1) requantized to int8 hq. IBN-a
//      where a tile holds whole images (16x8 crops at 128 rows a tile): the
//      epilogue takes the IN statistics of each image from the tile's own
//      rows, applies IN to the channels below Cout/2 and BN to the rest,
//      ReLU and requantizes; y1 never reaches device memory. IBN-a where an
//      image spans tiles (32x16 crops: two 256-row tiles): conv1 writes y1
//      in f32 and each tile's partial sums, and an elementwise pass reads
//      y1 once;
//   3. conv2 with y2 = acc*a2 + c2 and the SE pooling in the epilogue: each
//      tile writes the partial sum of its part of each image, and y2 in
//      f32;
//   4. the SE gate per image from the partials: bf16 fc1, ReLU, bf16 fc2,
//      sigmoid;
//   5. the output relu(y2*gate + branch) in x's type, one pass that reads
//      y2 once: an elementwise pass with x, or the 1x1 down GEMM whose
//      epilogue adds its own acc*ad + cd.
// No f32 intermediate of M x Cout is read more than once. Running conv1
// twice (statistics, then apply) in place of y1's round trip, or conv2
// twice (the gate known) in place of y2's, moves fewer bytes but adds a
// GEMM whose epilogue does not overlap the tensor cores: on an H100 both
// were slower at every site of the trunk.
//
// What bounds it: at B = 2048 the two convs are 0.6-2.5 T int8 operations
// a block, above the 0.5-1 GB that the block must move, so the tensor-core
// rate bounds it; the GEMMs run at the mainloop's rate and the design
// spends its remaining effort on keeping f32 intermediates off device
// memory.
//
// Numerics: every per-image sum is deterministic and in a fixed order, no
// float atomics, because a different summation order moves requantization
// ties. A tile sums each of its images' rows in 8 stripes (stripe s adds
// the image's rows s, s + 8, ... of that tile in turn), then the stripes in
// order; an image that spans tiles adds its tiles' sums in tile order.
// Where an image fits one tile this is the order of the earlier
// chan_mean_kernel, which se_basic_block_s8_plain mirrors; the per-tile
// order of a spanning image is mirrored there too. In the wgmma accumulator
// layout a thread holds rows g and g + 8 of its warp's 16 rows, so the
// epilogue stages a tile's 64-column chunk in shared memory and sums
// columns there. Every float step uses a round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn, rintf), so no multiply-add contracts
// into an FMA.
#include "wgmma_s8.cuh"

namespace reid {
namespace k2 {

using wg::Shape;
using wg::Tile;

constexpr int kMaxSeg = 4;  // images one tile holds at most
constexpr int kStripes = 8;

enum Red : int { kRedNone = 0, kRedSum = 1, kRedSumSq = 2 };
enum Out : int {
  kOutF32 = 0,        // f32 v
  kOutQ8 = 1,         // s8 quant(max(v, 0) * inv_s)
  kOutIbnQ8 = 2,      // s8 quant(max(IN or BN of v, 0) * inv_s), the IN
                      // statistics from the tile's own rows
  kOutDownResid = 3,  // T relu(y2 * gate + v), y2 f32
};

__device__ __forceinline__ int8_t quant_s8(float v, float inv_s) {
  // round half to even (rintf), then clip to +-127: jnp.round semantics
  float q = rintf(__fmul_rn(v, inv_s));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// quant_s8(max(v, 0), inv_s) as an unsigned byte: the product is never
// negative, so round half to even (cvt.rni) and the upper clip suffice.
__device__ __forceinline__ uint32_t quant_relu_u8(float v, float inv_s) {
  return static_cast<uint32_t>(
      min(__float2int_rn(__fmul_rn(fmaxf(v, 0.0f), inv_s)), 127));
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// IN statistics of an image from the sum and the sum of squares of its
// hw rows: (mean, 1 / sqrt(var + eps)).
__device__ __forceinline__ float2 in_stats(float sum, float sumsq, int hw) {
  const float rows = static_cast<float>(hw);
  const float m = __fdiv_rn(sum, rows);
  const float sq = __fdiv_rn(sumsq, rows);
  const float var = fmaxf(__fsub_rn(sq, __fmul_rn(m, m)), 0.0f);
  return make_float2(m, __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f))));
}

// IBN-a of y1 at channel ch: IN with (mean, rstd) below half, else BN.
__device__ __forceinline__ float ibn(float v, int ch, int half, float2 st,
                                     const float* a_bn, const float* c_bn,
                                     const float* in_scale,
                                     const float* in_bias) {
  if (ch < half)
    return __fadd_rn(
        __fmul_rn(__fmul_rn(__fsub_rn(v, st.x), st.y), __ldg(in_scale + ch)),
        __ldg(in_bias + ch));
  return __fadd_rn(__fmul_rn(v, __ldg(a_bn + ch)), __ldg(c_bn + ch));
}

// relu(y2 * g + branch)
__device__ __forceinline__ float resid(float y2, float g, float branch) {
  return fmaxf(__fadd_rn(__fmul_rn(y2, g), branch), 0.0f);
}

// Two values rounded to bf16, as the 32 bits of a __nv_bfloat162.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The epilogue of K2's three GEMMs on the shared mainloop. For each
// 64-column chunk of the tile: v = acc * a (+ c) into a shared-memory
// buffer of BM rows; the per-image stripe sums of v (and v*v) when asked,
// into a per-tile partial in device memory or, for kOutIbnQ8, straight
// into the images' statistics; then the output as 16-byte row segments.
struct BlockEpi {
  struct Params {
    const float* a;  // (Cout,) multiplier
    const float* c;  // (Cout,) offset, or null
    int red, out;
    int f32_io;  // the output of kOutDownResid is f32, else bf16
    // per-tile partial sums (nimg, ntile, Cout), the sums of squares
    // part_n floats after them
    float* part;
    long long part_n;
    const float *a_bn, *c_bn, *in_scale, *in_bias;  // IBN-a
    float inv_s;                                    // requantization
    const float* gate;                              // (nimg, Cout)
    const float* y2;                                // (M, Cout)
    void* dst;                                      // (M, Cout)
  };

  template <int BM, int BN>
  __host__ __device__ static constexpr int bytes() {
    return BM * 64 * 4                 // the chunk of v
           + 2 * kStripes * 64 * 4     // stripe sums and sums of squares
           + 2 * kMaxSeg * 64 * 4      // each image's mean and rstd
           + 2 * 64 * 4                // each column's IBN-a constants
           + BM * 4;                   // each tile row's output row
  }

  // The epilogue's shared memory.
  template <int BM>
  struct Smem {
    float* buf;      // BM x 64: the chunk of v
    float* red;      // kStripes x 64: stripe sums
    float* redq;     // kStripes x 64: stripe sums of squares
    float2* seg_st;  // kMaxSeg x 64: each image's (mean, rstd)
    float2* colk;    // 64: each column's IBN-a (scale, offset)
    int* orow;       // BM: each tile row's output row, -1 for none
    __device__ __forceinline__ explicit Smem(uint8_t* p)
        : buf(reinterpret_cast<float*>(p)),
          red(buf + BM * 64),
          redq(red + kStripes * 64),
          seg_st(reinterpret_cast<float2*>(redq + kStripes * 64)),
          colk(seg_st + kMaxSeg * 64),
          orow(reinterpret_cast<int*>(colk + 64)) {}
  };

  // v at (row r, column c) of the chunk: rows of 64 floats, the column
  // XOR-swizzled by the row so that the fragment stores and the column
  // reads both hit distinct banks.
  static __device__ __forceinline__ int sw(int r, int c) {
    return r * 64 + (c ^ ((r & 7) << 3));
  }

  // Stripe st of the rows [r0, r1) of column c: in turn from 0.
  template <bool SQ>
  static __device__ __forceinline__ float2 chain(const float* buf, int r0,
                                                 int r1, int c) {
    float a = 0.0f, b = 0.0f;
    for (int r = r0; r < r1; r += kStripes) {
      const float v = buf[sw(r, c)];
      a = __fadd_rn(a, v);
      if (SQ) b = __fadd_rn(b, __fmul_rn(v, v));
    }
    return make_float2(a, b);
  }

  // v = acc * a (+ c) of this thread's part of chunk CC into the buffer.
  template <int BM, int BN, int CC>
  static __device__ __forceinline__ void stage(const Params& p,
                                               const int (&acc)[BM / 128][BN / 2],
                                               float* buf, int cbase, int tid) {
    constexpr int MT = BM / 128;
    const int wg = tid >> 7;
    const int warp = tid >> 5;
    const int g = (tid & 31) >> 2;
    const int tig = tid & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = (wg * MT + mt) * 64 + (warp & 3) * 16 + g;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = jj * 8 + 2 * tig;
        const int* d = &acc[mt][4 * (CC * 8 + jj)];
        const float a0 = __ldg(p.a + cbase + c);
        const float a1 = __ldg(p.a + cbase + c + 1);
        float v0 = __fmul_rn(static_cast<float>(d[0]), a0);
        float v1 = __fmul_rn(static_cast<float>(d[1]), a1);
        float v2 = __fmul_rn(static_cast<float>(d[2]), a0);
        float v3 = __fmul_rn(static_cast<float>(d[3]), a1);
        if (p.c != nullptr) {
          const float c0 = __ldg(p.c + cbase + c);
          const float c1 = __ldg(p.c + cbase + c + 1);
          v0 = __fadd_rn(v0, c0);
          v1 = __fadd_rn(v1, c1);
          v2 = __fadd_rn(v2, c0);
          v3 = __fadd_rn(v3, c1);
        }
        *reinterpret_cast<float2*>(buf + sw(r, c)) = make_float2(v0, v1);
        *reinterpret_cast<float2*>(buf + sw(r + 8, c)) = make_float2(v2, v3);
      }
    }
  }

  // stage<CC> for the chunk cc, chosen by compares: the accumulators'
  // indices stay constant, so they stay in registers.
  template <int BM, int BN, int CC>
  static __device__ __forceinline__ void stage_chunk(
      int cc, const Params& p, const int (&acc)[BM / 128][BN / 2], float* buf,
      int cbase, int tid) {
    if constexpr (CC < BN / 64) {
      if (cc == CC)
        stage<BM, BN, CC>(p, acc, buf, cbase, tid);
      else
        stage_chunk<BM, BN, CC + 1>(cc, p, acc, buf, cbase, tid);
    }
  }

  template <int BM, int BN>
  static __device__ __forceinline__ void tile(const Params& p, const Shape& s,
                                              const Tile& t,
                                              int (&acc)[BM / 128][BN / 2],
                                              uint8_t* smem, int tid) {
    const Smem<BM> m(smem);
    const int box = s.bw * s.bh;  // rows of one image's part in the tile
    const int hw = s.h * s.w;
    // the tile's images: nseg of them, image i at rows i*box .. + nv - 1
    const int nseg = min(s.bn, s.nimg - t.n0);
    const int nv = min(s.bh, s.h - t.y0) * min(s.bw, s.w - t.x0);
    const int ntile = s.tiles_x * s.tiles_y;  // tiles an image spans
    const int sub = (t.y0 / s.bh) * s.tiles_x + t.x0 / s.bw;
    if (tid < BM) {
      const int r = tid;
      const int x = t.x0 + r % s.bw;
      const int y = t.y0 + (r / s.bw) % s.bh;
      const int n = t.n0 + r / box;
      m.orow[r] = (r < box * s.bn && x < s.w && y < s.h && n < s.nimg)
                    ? (n * s.h + y) * s.w + x
                    : -1;
    }
    // One copy of the chunk's work, not one a chunk: only the staging
    // reads the accumulators.
#pragma unroll 1
    for (int cc = 0; cc < BN / 64; ++cc) {
      const int cbase = t.nt * BN + cc * 64;
      // 1. v of this thread's accumulators into the chunk, and the
      //    columns' IBN-a constants
      stage_chunk<BM, BN, 0>(cc, p, acc, m.buf, cbase, tid);
      if (p.out == kOutIbnQ8 && tid < 64) {
        const int ch = cbase + tid;
        m.colk[tid] = ch < s.cout / 2
                        ? make_float2(__ldg(p.in_scale + ch), __ldg(p.in_bias + ch))
                        : make_float2(__ldg(p.a_bn + ch), __ldg(p.c_bn + ch));
      }
      wg::consumers_sync();
      finish<BM>(p, s, t, m, tid, cbase, box, hw, nseg, nv, ntile, sub);
      wg::consumers_sync();
    }
  }

  // The gate of image img at columns col .. col + 3.
  static __device__ __forceinline__ float4 gate4(const Params& p,
                                                 const Shape& s, int img,
                                                 int col) {
    return __ldg(reinterpret_cast<const float4*>(
        p.gate + static_cast<long long>(img) * s.cout + col));
  }

  // The four outputs at element e0 from the branch v, the gate and y2.
  static __device__ __forceinline__ void out4(const Params& p, long long e0,
                                              float4 v, float4 g, float4 y) {
    const float r0 = resid(y.x, g.x, v.x);
    const float r1 = resid(y.y, g.y, v.y);
    const float r2 = resid(y.z, g.z, v.z);
    const float r3 = resid(y.w, g.w, v.w);
    if (p.f32_io) {
      *reinterpret_cast<float4*>(static_cast<float*>(p.dst) + e0) =
          make_float4(r0, r1, r2, r3);
    } else {
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.dst) + e0) =
          make_uint2(pack_bf16(r0, r1), pack_bf16(r2, r3));
    }
  }

  // Phases 2-4 of a staged chunk: the reductions, the statistics, the
  // output.
  template <int BM>
  static __device__ __forceinline__ void finish(const Params& p,
                                                const Shape& s, const Tile& t,
                                                const Smem<BM>& m, int tid,
                                                int cbase, int box, int hw,
                                                int nseg, int nv, int ntile,
                                                int sub) {
    const float* buf = m.buf;
    float* red = m.red;
    float* redq = m.redq;
    float2* seg_st = m.seg_st;
    const float2* colk = m.colk;
    const int* orow = m.orow;
    // 2. per-image stripe sums: thread tid adds stripes tid/64 and
    //    tid/64 + 4 of column tid % 64, then 64 threads add the stripes
    if (p.red != kRedNone) {
      const int c = tid & 63;
      const int st = tid >> 6;
      for (int i = 0; i < nseg; ++i) {
        const int r0 = i * box;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int sk = st + 4 * k;
          const float2 v = p.red == kRedSumSq
                               ? chain<true>(buf, r0 + sk, r0 + nv, c)
                               : chain<false>(buf, r0 + sk, r0 + nv, c);
          red[sk * 64 + c] = v.x;
          redq[sk * 64 + c] = v.y;
        }
        wg::consumers_sync();
        if (tid < 64) {
          float ta = 0.0f, tb = 0.0f;
#pragma unroll
          for (int k = 0; k < kStripes; ++k) {
            ta = __fadd_rn(ta, red[k * 64 + tid]);
            tb = __fadd_rn(tb, redq[k * 64 + tid]);
          }
          if (p.out == kOutIbnQ8) {
            seg_st[i * 64 + tid] = in_stats(ta, tb, hw);
          } else {
            const long long o =
                (static_cast<long long>(t.n0 + i) * ntile + sub) * s.cout +
                cbase + tid;
            p.part[o] = ta;
            if (p.red == kRedSumSq) p.part[p.part_n + o] = tb;
          }
        }
        wg::consumers_sync();
      }
    }

    // 3. the output, along each row
    if (p.out == kOutF32) {
      for (int i = tid; i < BM * 16; i += wg::kConsumers) {
        const int r = i >> 4;
        const int q = (i & 15) * 4;
        const int o = orow[r];
        if (o < 0) continue;
        *reinterpret_cast<float4*>(static_cast<float*>(p.dst) +
                                   static_cast<long long>(o) * s.cout + cbase +
                                   q) =
            *reinterpret_cast<const float4*>(buf + sw(r, q));
      }
    } else if (p.out == kOutQ8 || p.out == kOutIbnQ8) {
      // a thread's columns q .. q + 15 are the same in all its rows
      const int q = (tid & 3) * 16;
      const bool in_half = p.out == kOutIbnQ8 && cbase < s.cout / 2;
      const bool bn_half = p.out == kOutIbnQ8 && !in_half;
      for (int i = tid; i < BM * 4; i += wg::kConsumers) {
        const int r = i >> 2;
        const int o = orow[r];
        if (o < 0) continue;
        const float2* st = seg_st + (r / box) * 64;
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 v4 =
              *reinterpret_cast<const float4*>(buf + sw(r, q + 4 * k));
          float v[4] = {v4.x, v4.y, v4.z, v4.w};
          uint32_t packed = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = q + 4 * k + e;
            float h = v[e];
            if (in_half) {
              const float2 m = st[c];
              h = __fadd_rn(
                  __fmul_rn(__fmul_rn(__fsub_rn(h, m.x), m.y), colk[c].x),
                  colk[c].y);
            } else if (bn_half) {
              h = __fadd_rn(__fmul_rn(h, colk[c].x), colk[c].y);
            }
            packed |= quant_relu_u8(h, p.inv_s) << (8 * e);
          }
          w[k] = packed;
        }
        *reinterpret_cast<uint4*>(static_cast<int8_t*>(p.dst) +
                                  static_cast<long long>(o) * s.cout + cbase +
                                  q) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    } else {  // kOutDownResid
      // Four columns a step, 16 steps a row. At BM = 128, four steps at a
      // time with their device-memory loads issued together: eight warps
      // an SM hide little of a load's latency one step at a time. At
      // BM = 256 (Cout % 256 != 0) even two steps spill.
      if constexpr (BM == 128) {
        const int q = (tid & 15) * 4;
#pragma unroll 1
        for (int j0 = 0; j0 < BM * 16 / wg::kConsumers; j0 += 4) {
          int ow[4];
          float4 g4[4], y4[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = (tid >> 4) + 16 * (j0 + u);
            ow[u] = orow[r];
            if (ow[u] < 0) continue;
            g4[u] = gate4(p, s, t.n0 + r / box, cbase + q);
            y4[u] = *reinterpret_cast<const float4*>(
                p.y2 + static_cast<long long>(ow[u]) * s.cout + cbase + q);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (ow[u] < 0) continue;
            const int r = (tid >> 4) + 16 * (j0 + u);
            out4(p, static_cast<long long>(ow[u]) * s.cout + cbase + q,
                 *reinterpret_cast<const float4*>(buf + sw(r, q)), g4[u],
                 y4[u]);
          }
        }
      } else {
        for (int i = tid; i < BM * 16; i += wg::kConsumers) {
          const int r = i >> 4;
          const int q = (i & 15) * 4;
          const int o = orow[r];
          if (o < 0) continue;
          const long long e0 = static_cast<long long>(o) * s.cout + cbase + q;
          out4(p, e0, *reinterpret_cast<const float4*>(buf + sw(r, q)),
               gate4(p, s, t.n0 + r / box, cbase + q),
               *reinterpret_cast<const float4*>(p.y2 + e0));
        }
      }
    }
  }
};

// x (n values of T, bf16 or f32) -> q1 = quant(x*inv1), and
// q2 = quant(x*inv2) when q2 != null, from one read. Eight values a thread.
template <typename T>
__global__ void quant_kernel(const T* __restrict__ x, long long n, float inv1,
                             int8_t* q1, float inv2, int8_t* q2) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 8;
  if (i >= n) return;
  alignas(16) T v[8];
#pragma unroll
  for (int j = 0; j < static_cast<int>(8 * sizeof(T) / 16); ++j)
    reinterpret_cast<uint4*>(v)[j] = reinterpret_cast<const uint4*>(x + i)[j];
  alignas(8) int8_t a[8];
  alignas(8) int8_t b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float f = to_f32(v[j]);
    a[j] = quant_s8(f, inv1);
    b[j] = q2 ? quant_s8(f, inv2) : 0;
  }
  *reinterpret_cast<uint2*>(q1 + i) = *reinterpret_cast<const uint2*>(a);
  if (q2) *reinterpret_cast<uint2*>(q2 + i) = *reinterpret_cast<const uint2*>(b);
}

// IBN-a over y1 written by conv1 where images span tiles: grid
// (nimg, Cout / 64). The block's 64 channels' statistics
// from the tiles' partials, then IN/BN, ReLU and requantize over the
// image's rows, four channels a thread.
__global__ void ibn_apply_kernel(const float* __restrict__ y1,
                                 const float* __restrict__ part,
                                 long long part_n, int ntile, int hw, int c,
                                 const float* a_bn, const float* c_bn,
                                 const float* in_scale, const float* in_bias,
                                 float inv_s, int8_t* __restrict__ hq) {
  __shared__ float2 st[64];
  const int img = blockIdx.x;
  const int c0 = blockIdx.y * 64;
  if (threadIdx.x < 64) {
    const long long o =
        static_cast<long long>(img) * ntile * c + c0 + threadIdx.x;
    float ta = part[o];
    float tb = part[part_n + o];
    for (int k = 1; k < ntile; ++k) {
      ta = __fadd_rn(ta, part[o + static_cast<long long>(k) * c]);
      tb = __fadd_rn(tb, part[part_n + o + static_cast<long long>(k) * c]);
    }
    st[threadIdx.x] = in_stats(ta, tb, hw);
  }
  __syncthreads();
  const int cq = (threadIdx.x & 15) * 4;
  for (int r = threadIdx.x >> 4; r < hw; r += 16) {
    const long long e = (static_cast<long long>(img) * hw + r) * c + c0 + cq;
    const float4 v4 = *reinterpret_cast<const float4*>(y1 + e);
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
    alignas(4) int8_t b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      b[k] = quant_s8(fmaxf(ibn(v[k], c0 + cq + k, c / 2, st[cq + k], a_bn,
                                c_bn, in_scale, in_bias),
                            0.0f),
                      inv_s);
    *reinterpret_cast<char4*>(hq + e) = *reinterpret_cast<const char4*>(b);
  }
}

// out = relu(y2 * gate[img, c] + x) in T, eight values a thread.
template <typename T>
__global__ void resid_kernel(const float* __restrict__ y2,
                             const float* __restrict__ gate,
                             const T* __restrict__ x, int hw, int c,
                             long long n, T* __restrict__ out) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 8;
  if (i >= n) return;
  const int ch = static_cast<int>(i % c);
  const long long img = i / (static_cast<long long>(hw) * c);
  alignas(16) float y[8];
  alignas(16) float g[8];
  alignas(16) T xv[8];
  reinterpret_cast<float4*>(y)[0] = reinterpret_cast<const float4*>(y2 + i)[0];
  reinterpret_cast<float4*>(y)[1] = reinterpret_cast<const float4*>(y2 + i)[1];
  reinterpret_cast<float4*>(g)[0] =
      __ldg(reinterpret_cast<const float4*>(gate + img * c + ch));
  reinterpret_cast<float4*>(g)[1] =
      __ldg(reinterpret_cast<const float4*>(gate + img * c + ch) + 1);
#pragma unroll
  for (int j = 0; j < static_cast<int>(8 * sizeof(T) / 16); ++j)
    reinterpret_cast<uint4*>(xv)[j] = reinterpret_cast<const uint4*>(x + i)[j];
  alignas(16) T o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float v = resid(y[j], g[j], to_f32(xv[j]));
    if constexpr (sizeof(T) == 4) {
      o[j] = v;
    } else {
      o[j] = __float2bfloat16_rn(v);
    }
  }
#pragma unroll
  for (int j = 0; j < static_cast<int>(8 * sizeof(T) / 16); ++j)
    reinterpret_cast<uint4*>(out + i)[j] = reinterpret_cast<const uint4*>(o)[j];
}

// SE gate for one image a block: the pooled means from the tiles' partial
// sums (added in tile order) -> bf16 -> fc1 (c x mip, f32 sums) -> bf16 ->
// relu -> fc2 (mip x c, f32 sums) -> sigmoid.
__global__ void se_gate_kernel(const float* __restrict__ part, int ntile,
                               int hw, const __nv_bfloat16* __restrict__ wfc1,
                               const __nv_bfloat16* __restrict__ wfc2, int c,
                               int mip, float* __restrict__ gate) {
  extern __shared__ float sm[];
  float* s_in = sm;       // c
  float* s_mid = sm + c;  // mip
  const float* pin = part + static_cast<long long>(blockIdx.x) * ntile * c;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    float sum = pin[i];
    for (int k = 1; k < ntile; ++k)
      sum = __fadd_rn(sum, pin[static_cast<long long>(k) * c + i]);
    const float mean = __fdiv_rn(sum, static_cast<float>(hw));
    s_in[i] = __bfloat162float(__float2bfloat16_rn(mean));
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int j = warp; j < mip; j += nwarps) {
    float acc = 0.0f;
    for (int i = lane; i < c; i += 32)
      acc = __fadd_rn(acc, __fmul_rn(s_in[i], __bfloat162float(wfc1[i * mip + j])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (lane == 0) {
      const float r = __bfloat162float(__float2bfloat16_rn(acc));
      s_mid[j] = fmaxf(r, 0.0f);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < mip; ++j)
      acc = __fadd_rn(acc, __fmul_rn(s_mid[j], __bfloat162float(wfc2[j * c + i])));
    gate[static_cast<long long>(blockIdx.x) * c + i] =
        __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-acc)));
  }
}

inline unsigned blocks_for(long long n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

// One GEMM of the block on the shared mainloop: its maps and shape, made
// once and launched with its epilogue. The tile is 128 x 256 where
// Cout % 256 == 0, else 256 x 128, as conv3x3_s8's; K steps of 128
// channels where Cin % 128 == 0, else 64. So the three GEMMs of a block
// share one tiling of the output.
struct Gemm {
  wg::Maps maps;
  Shape s;
  int cfg;
};

template <int BM, int BN, int BK>
cudaError_t prepare_as(Gemm* g, int cfg, const void* x, const void* w,
                       int nimg, int h, int w_, int cin, int cout, int taps) {
  g->cfg = cfg;
  g->s = wg::make_shape<BM, BN, BK>(nimg, h, w_, cin, cout, taps, kMaxSeg);
  return wg::make_maps<BN, BK>(x, w, g->s, &g->maps);
}

cudaError_t prepare(Gemm* g, const void* x, const void* w, int nimg, int h,
                    int w_, int cin, int cout, int taps) {
  if (cout % 256 == 0)
    return cin % 128 == 0
               ? prepare_as<128, 256, 128>(g, 0, x, w, nimg, h, w_, cin, cout,
                                           taps)
               : prepare_as<128, 256, 64>(g, 1, x, w, nimg, h, w_, cin, cout,
                                          taps);
  return cin % 128 == 0
             ? prepare_as<256, 128, 128>(g, 2, x, w, nimg, h, w_, cin, cout,
                                         taps)
             : prepare_as<256, 128, 64>(g, 3, x, w, nimg, h, w_, cin, cout,
                                        taps);
}

cudaError_t run(const Gemm& g, const BlockEpi::Params& ep, cudaStream_t st) {
  switch (g.cfg) {
    case 0:
      return wg::launch<128, 256, 128, BlockEpi>(g.maps, g.s, ep, st);
    case 1:
      return wg::launch<128, 256, 64, BlockEpi>(g.maps, g.s, ep, st);
    case 2:
      return wg::launch<256, 128, 128, BlockEpi>(g.maps, g.s, ep, st);
    default:
      return wg::launch<256, 128, 64, BlockEpi>(g.maps, g.s, ep, st);
  }
}

// Tiles an image spans under the block's tiling (1 where a tile holds
// whole images).
inline int tiles_per_image(int h, int w, int cout) {
  const int bm = cout % 256 == 0 ? 128 : 256;
  const int bw = w < bm ? w : bm;
  const int bh = h < bm / bw ? h : bm / bw;
  return ((w + bw - 1) / bw) * ((h + bh - 1) / bh);
}

// The scratch of one call inside the caller's workspace, 256-byte aligned
// offsets (0 size where a region is unused).
struct Layout {
  size_t xq, xqd, hq, f32, stats, pool, gate, total;
};

inline Layout layout(int nimg, int h, int w, int cin, int cout, int ibn,
                     int down) {
  const size_t m = static_cast<size_t>(nimg) * h * w;
  const size_t ntile = tiles_per_image(h, w, cout);
  const bool span_ibn = ibn && ntile > 1;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += (bytes + 255) & ~static_cast<size_t>(255);
    return at;
  };
  Layout L;
  L.xq = take(m * cin);
  L.xqd = take(down ? m * cin : 0);
  L.hq = take(m * cout);
  L.f32 = take(m * cout * 4);  // y1 (IBN across tiles), then y2
  L.stats = take(span_ibn ? 2 * nimg * ntile * cout * 4 : 0);
  L.pool = take(static_cast<size_t>(nimg) * ntile * cout * 4);
  L.gate = take(static_cast<size_t>(nimg) * cout * 4);
  L.total = off;
  return L;
}

}  // namespace k2
}  // namespace reid

#define REID_CHECK(expr)                                \
  do {                                                  \
    cudaError_t e_ = (expr);                            \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

// Bytes of the workspace that reid_se_basic_block_s8 takes for this shape.
extern "C" int reid_se_basic_block_s8_workspace(int nimg, int h, int w,
                                                int cin, int cout, int ibn,
                                                int down, long long* bytes) {
  *bytes = static_cast<long long>(
      reid::k2::layout(nimg, h, w, cin, cout, ibn, down).total);
  return 0;
}

// One call runs the whole block. w1 (cout, 9*cin), w2 (cout, 9*cout),
// wd (cout, cin): int8, K ordered (tap, cin). wfc1 (cout, mip),
// wfc2 (mip, cout): bf16. x and out are bf16, or f32 when f32_io != 0.
// `work` holds reid_se_basic_block_s8_workspace bytes.
extern "C" int reid_se_basic_block_s8(
    const void* x, const void* w1, const void* w2, const void* a1,
    const void* c1, const void* a2, const void* c2, float inv_sx1,
    float inv_sx2, const void* wfc1, const void* wfc2, const void* wd,
    const void* ad, const void* cd, float inv_sxd, const void* dq1,
    const void* in_scale, const void* in_bias, void* work, void* out,
    int nimg, int h, int w, int cin, int cout, int mip, int ibn, int f32_io,
    void* stream_ptr) {
  using namespace reid::k2;
  if (cin % 64 != 0 || cout % 128 != 0 || nimg < 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nimg == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool down = wd != nullptr;
  const int hw = h * w;
  const long long m = static_cast<long long>(nimg) * hw;
  const int ntile = tiles_per_image(h, w, cout);
  const Layout L = layout(nimg, h, w, cin, cout, ibn, down);
  uint8_t* ws = static_cast<uint8_t*>(work);
  int8_t* xq = reinterpret_cast<int8_t*>(ws + L.xq);
  int8_t* xqd = down ? reinterpret_cast<int8_t*>(ws + L.xqd) : nullptr;
  int8_t* hq = reinterpret_cast<int8_t*>(ws + L.hq);
  float* f32 = reinterpret_cast<float*>(ws + L.f32);
  float* stats = reinterpret_cast<float*>(ws + L.stats);
  float* pool = reinterpret_cast<float*>(ws + L.pool);
  float* gate = reinterpret_cast<float*>(ws + L.gate);

  // 1. quantize x (and x for the down branch) from one read
  const long long n_in = m * cin;
  if (f32_io)
    quant_kernel<float><<<blocks_for(n_in / 8, 256), 256, 0, stream>>>(
        static_cast<const float*>(x), n_in, inv_sx1, xq, inv_sxd, xqd);
  else
    quant_kernel<__nv_bfloat16><<<blocks_for(n_in / 8, 256), 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), n_in, inv_sx1, xq, inv_sxd,
        xqd);
  REID_CHECK(cudaGetLastError());

  // 2. conv1 + (BN | IBN-a) + ReLU + requantize into hq
  Gemm g1;
  REID_CHECK(prepare(&g1, xq, w1, nimg, h, w, cin, cout, 9));
  BlockEpi::Params e{};
  e.inv_s = inv_sx2;
  e.dst = hq;
  if (!ibn) {
    e.a = static_cast<const float*>(a1);
    e.c = static_cast<const float*>(c1);
    e.out = kOutQ8;
    REID_CHECK(run(g1, e, stream));
  } else {
    e.a = static_cast<const float*>(dq1);
    e.a_bn = static_cast<const float*>(a1);
    e.c_bn = static_cast<const float*>(c1);
    e.in_scale = static_cast<const float*>(in_scale);
    e.in_bias = static_cast<const float*>(in_bias);
    e.part = stats;
    e.part_n = static_cast<long long>(nimg) * ntile * cout;
    e.red = kRedSumSq;
    if (ntile == 1) {
      e.out = kOutIbnQ8;
      REID_CHECK(run(g1, e, stream));
    } else {
      e.out = kOutF32;
      e.dst = f32;  // y1
      REID_CHECK(run(g1, e, stream));
      ibn_apply_kernel<<<dim3(nimg, cout / 64), 256, 0, stream>>>(
          f32, stats, e.part_n, ntile, hw, cout, e.a_bn, e.c_bn, e.in_scale,
          e.in_bias, inv_sx2, hq);
      REID_CHECK(cudaGetLastError());
    }
  }

  // 3. conv2 + BN2: y2 and the SE pooling's partial sums
  Gemm g2;
  REID_CHECK(prepare(&g2, hq, w2, nimg, h, w, cout, cout, 9));
  BlockEpi::Params e2{};
  e2.a = static_cast<const float*>(a2);
  e2.c = static_cast<const float*>(c2);
  e2.red = kRedSum;
  e2.part = pool;
  e2.out = kOutF32;
  e2.dst = f32;  // y2
  REID_CHECK(run(g2, e2, stream));

  // 4. SE excite: the gate per image
  se_gate_kernel<<<nimg, 256, (cout + mip) * sizeof(float), stream>>>(
      pool, ntile, hw, static_cast<const __nv_bfloat16*>(wfc1),
      static_cast<const __nv_bfloat16*>(wfc2), cout, mip, gate);
  REID_CHECK(cudaGetLastError());

  // 5. out = relu(y2 * gate + branch) in x's type, y2 read once
  if (down) {
    Gemm gd;
    REID_CHECK(prepare(&gd, xqd, wd, nimg, h, w, cin, cout, 1));
    BlockEpi::Params eo{};
    eo.a = static_cast<const float*>(ad);
    eo.c = static_cast<const float*>(cd);
    eo.f32_io = f32_io;
    eo.out = kOutDownResid;
    eo.gate = gate;
    eo.y2 = f32;
    eo.dst = out;
    REID_CHECK(run(gd, eo, stream));
  } else {
    const long long n_out = m * cout;
    if (f32_io)
      resid_kernel<float><<<blocks_for(n_out / 8, 256), 256, 0, stream>>>(
          f32, gate, static_cast<const float*>(x), hw, cout, n_out,
          static_cast<float*>(out));
    else
      resid_kernel<__nv_bfloat16>
          <<<blocks_for(n_out / 8, 256), 256, 0, stream>>>(
              f32, gate, static_cast<const __nv_bfloat16*>(x), hw, cout,
              n_out, static_cast<__nv_bfloat16*>(out));
    REID_CHECK(cudaGetLastError());
  }
  return 0;
}
