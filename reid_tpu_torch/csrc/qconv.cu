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
// fill is the SAME halo, a persistent grid, the scale epilogue). This file
// adds the choice of tile:
//   * A tile is 128 pixels x 256 channels where Cout allows, else 256 x 128;
//     both load 384 rows of operands a K step for 128 x 256 products. A
//     first version with 128 x 128 tiles (256 rows a step for half as many
//     products) and 64-channel steps ran block21 at B = 2048 in 0.49 ms on
//     an H100 SXM at 700 W, a third of the int8 rate; these tiles with
//     128-channel steps run it in 0.28 ms. K steps are 128 channels where
//     Cin % 128 == 0, else 64 (Cin = 64 is in the contract).
//   * Epilogue (wg::ScaleEpi, shared with the DMA-im2col form): int to
//     f32, __fmul_rn by the scale, __float2bfloat16_rn, so the result
//     equals conv3x3_s8_plain bit for bit (integer sums are exact in any
//     order). Each warp stages 16 rows, 64 columns at a time, in shared
//     memory and writes them as 16-byte row segments.
#include "wgmma_s8.cuh"

namespace reid {
namespace k1 {

using wg::ScaleEpi;
using wg::Shape;

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
