// conv3x3_s8: 3x3 stride-1 SAME int8 convolution, NHWC, s8 x s8 -> s32,
// epilogue acc * scale[c] written as bf16 or f32.
//
// Replaces the TPU kernel reid_tpu/ops/qconv.py:conv3x3_s8
// (_qconv_kernel), which holds a slab of images and all nine tap weights in
// VMEM and rolls the s32 tap products along the flattened row axis.
//
// What bounds it on an H100: at the main path's shapes (B = 2048 crops,
// block21/conv2 32x16x128->128 and block31/conv2 16x8x256->256) the GEMM is
// M = B*H*W = 1,048,576 or 262,144 output pixels, N = Cout, K = 9*Cin:
// 309 G int8 operations, 0.156 ms at the card's 1,979 TOP/s. The bytes come
// close behind: the input once, the weights and the output (268 MB of bf16
// at block21), about 0.40 GB, 0.12 ms at 3.35 TB/s. So the kernel has to
// reach the tensor cores' Hopper rate and keep the output stores and the
// operand loads off the critical path at the same time.
//
// The design: the mainloop is the shared Hopper one of wgmma_s8.cuh
// (wgmma s8 from two consumer warpgroups fed by TMA through an mbarrier
// ring, the implicit im2col as a 4-D tiled TMA box whose out-of-bounds zero
// fill is the SAME halo, a persistent grid). This file adds the epilogue and
// the choice of tile:
//   * A tile is 128 pixels x 256 channels where Cout allows, else 256 x 128;
//     both load 384 rows of operands a K step for 128 x 256 products. A
//     first version with 128 x 128 tiles (256 rows a step for half as many
//     products) and 64-channel steps ran block21 at B = 2048 in 0.49 ms on
//     an H100 SXM at 700 W, a third of the int8 rate; these tiles with
//     128-channel steps run it in 0.28 ms. K steps are 128 channels where
//     Cin % 128 == 0, else 64 (Cin = 64 is in the contract).
//   * Epilogue: the same per-element arithmetic as igemm_s8.cuh's store2
//     (int to f32, __fmul_rn by the scale, __float2bfloat16_rn), so the
//     result equals conv3x3_s8_plain bit for bit (integer sums are exact in
//     any order). Each warp stages 16 rows, 64 columns at a time, in
//     shared memory and writes them as 16-byte row segments.
#include "wgmma_s8.cuh"

namespace reid {
namespace k1 {

using wg::Shape;
using wg::Tile;

// out = acc * scale[c] in bf16 or f32, staged a warp's 16 rows x 64
// columns at a time and written as 16-byte row segments.
template <bool F32>
struct ScaleEpi {
  struct Params {
    const float* scale;
    void* out;
  };
  static constexpr int kEsize = F32 ? 4 : 2;
  // staging row of one warp: 64 output columns, padded so the fragment
  // stores of a half-warp (f32) or a warp (bf16) hit distinct banks
  static constexpr int kRowBytes = 64 * kEsize + (F32 ? 32 : 16);
  template <int BM, int BN>
  __host__ __device__ static constexpr int bytes() {
    return 8 * 16 * kRowBytes;
  }

  template <int BM, int BN>
  static __device__ __forceinline__ void tile(const Params& p, const Shape& s,
                                              const Tile& tile,
                                              int (&acc)[BM / 128][BN / 2],
                                              uint8_t* smem, int tid) {
    constexpr int MT = BM / 128;
    const int wg = tid >> 7;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    uint8_t* stg = smem + warp * 16 * kRowBytes;
    const int col0 = tile.nt * BN;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // Lane l < 16 holds the output row of this warp's tile row
      // row0 + l, -1 where the row lies outside the box or the tensor.
      const int row0 = (wg * MT + mt) * 64 + (warp & 3) * 16;
      long long orow = -1;
      if (lane < 16) {
        const int r = row0 + lane;
        const int x = tile.x0 + r % s.bw;
        const int y = tile.y0 + (r / s.bw) % s.bh;
        const int n = tile.n0 + r / (s.bw * s.bh);
        if (r < s.bw * s.bh * s.bn && x < s.w && y < s.h && n < s.nimg)
          orow = (static_cast<long long>(n) * s.h + y) * s.w + x;
      }
#pragma unroll
      for (int cc = 0; cc < BN / 64; ++cc) {
        // accumulator j*4 + {0,1,2,3} holds rows g, g, g+8, g+8 and
        // columns 8j + 2*tig, +1, +0, +1 of the warp's 16 x BN block
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = cc * 8 + jj;
          const int c = jj * 8 + 2 * tig;
          const float s0 = __ldg(p.scale + col0 + cc * 64 + c);
          const float s1 = __ldg(p.scale + col0 + cc * 64 + c + 1);
          const int* d = &acc[mt][4 * j];
          const float v0 = __fmul_rn(static_cast<float>(d[0]), s0);
          const float v1 = __fmul_rn(static_cast<float>(d[1]), s1);
          const float v2 = __fmul_rn(static_cast<float>(d[2]), s0);
          const float v3 = __fmul_rn(static_cast<float>(d[3]), s1);
          uint8_t* p0 = stg + g * kRowBytes + c * kEsize;
          uint8_t* p1 = p0 + 8 * kRowBytes;
          if constexpr (F32) {
            *reinterpret_cast<float2*>(p0) = make_float2(v0, v1);
            *reinterpret_cast<float2*>(p1) = make_float2(v2, v3);
          } else {
            __nv_bfloat162 r0, r1;
            r0.x = __float2bfloat16_rn(v0);
            r0.y = __float2bfloat16_rn(v1);
            r1.x = __float2bfloat16_rn(v2);
            r1.y = __float2bfloat16_rn(v3);
            *reinterpret_cast<__nv_bfloat162*>(p0) = r0;
            *reinterpret_cast<__nv_bfloat162*>(p1) = r1;
          }
        }
        __syncwarp();
        constexpr int kChunks = 64 * kEsize / 16;  // 16-byte chunks a row
#pragma unroll
        for (int i = 0; i < 16 * kChunks / 32; ++i) {
          const int idx = lane + 32 * i;
          const int r = idx / kChunks;
          const int q = idx % kChunks;
          const long long o = __shfl_sync(0xffffffffu, orow, r);
          if (o >= 0) {
            const uint4 v =
                *reinterpret_cast<const uint4*>(stg + r * kRowBytes + q * 16);
            *reinterpret_cast<uint4*>(static_cast<uint8_t*>(p.out) +
                                      (o * s.cout + col0 + cc * 64) * kEsize +
                                      q * 16) = v;
          }
        }
        __syncwarp();
      }
    }
  }
};

template <int BM, int BN, int BK, bool F32>
cudaError_t launch(const void* x, const void* w, const float* scale, void* out,
                   int nimg, int h, int w_, int cin, int cout,
                   cudaStream_t stream) {
  const Shape s =
      wg::make_shape<BM, BN, BK>(nimg, h, w_, cin, cout, 9, BM);
  wg::Maps maps;
  const cudaError_t e = wg::make_maps<BN, BK>(x, w, s, &maps);
  if (e != cudaSuccess) return e;
  return wg::launch<BM, BN, BK, ScaleEpi<F32>>(maps, s, {scale, out}, stream);
}

// N = 256 where Cout allows (a 128 x 256 tile), else a 256 x 128 tile: 128
// accumulators a consumer thread either way. K steps of 128 channels in
// the 128-byte swizzle where Cin allows, else of 64 in the 64-byte one.
template <bool F32>
cudaError_t dispatch(const void* x, const void* w, const float* scale,
                     void* out, int nimg, int h, int w_, int cin, int cout,
                     cudaStream_t st) {
  if (cout % 256 == 0) {
    return cin % 128 == 0
               ? launch<128, 256, 128, F32>(x, w, scale, out, nimg, h, w_, cin,
                                            cout, st)
               : launch<128, 256, 64, F32>(x, w, scale, out, nimg, h, w_, cin,
                                           cout, st);
  }
  return cin % 128 == 0
             ? launch<256, 128, 128, F32>(x, w, scale, out, nimg, h, w_, cin,
                                          cout, st)
             : launch<256, 128, 64, F32>(x, w, scale, out, nimg, h, w_, cin,
                                         cout, st);
}

}  // namespace k1
}  // namespace reid

extern "C" int reid_conv3x3_s8(const void* x, const void* w, const void* scale,
                               void* out, int nimg, int h, int w_, int cin,
                               int cout, int out_f32, void* stream) {
  using namespace reid::k1;
  if (cin % 64 != 0 || cout % 128 != 0 || nimg < 0 || h <= 0 || w_ <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nimg == 0) return 0;
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      out_f32 ? dispatch<true>(x, w, sc, out, nimg, h, w_, cin, cout, st)
              : dispatch<false>(x, w, sc, out, nimg, h, w_, cin, cout, st);
  return static_cast<int>(e);
}
