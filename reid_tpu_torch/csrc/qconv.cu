// conv3x3_s8: 3x3 stride-1 SAME int8 convolution, NHWC, s8 x s8 -> s32,
// epilogue acc * scale[c] written as bf16 or f32.
//
// Replaces the TPU kernel reid_tpu/ops/qconv.py:conv3x3_s8
// (_qconv_kernel), which holds a slab of images and all nine tap weights in
// VMEM and rolls the s32 tap products along the flattened row axis.
//
// What bounds it on an H100: at the main path's shapes (B = 2048 crops,
// block21/conv2 32x16x128->128 and block31/conv2 16x8x256->256) the GEMM is
// M = 1,048,576 or 262,144, N = 128 or 256, K = 1152 or 2304: about 310 G
// int8 operations against some 0.4 GB of traffic, so the int8 tensor-core
// rate bounds it, not memory. The design therefore keeps every operand byte
// on chip once loaded (implicit im2col from shared memory, no im2col buffer
// in device memory) and feeds mma.sync int8 tensor-core instructions. It is
// the simple form: mma.sync rather than wgmma, and a two-stage cp.async
// pipeline rather than TMA with warp specialisation.
#include "igemm_s8.cuh"

extern "C" int reid_conv3x3_s8(const void* x, const void* w, const void* scale,
                               void* out, int nimg, int h, int w_, int cin,
                               int cout, int out_f32, void* stream) {
  reid::ConvArgs p;
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(w);
  p.a = static_cast<const float*>(scale);
  p.c = nullptr;
  p.inv_s = 0.0f;
  p.out = out;
  p.nimg = nimg;
  p.h = h;
  p.w = w_;
  p.cin = cin;
  p.cout = cout;
  p.taps = 9;
  return static_cast<int>(reid::launch_igemm_s8(
      p, out_f32 ? reid::kScaleF32 : reid::kScaleBf16,
      static_cast<cudaStream_t>(stream)));
}
