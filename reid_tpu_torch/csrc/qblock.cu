// se_basic_block_s8: the whole stride-1 SE basic block in int8, bf16 in and
// bf16 out (the track path's bf16 trunk) or f32 in and f32 out (the
// retrieval path's f32 trunk), as a short sequence of launches on one
// stream.
//
// Replaces the TPU kernel reid_tpu/ops/qblock.py:se_basic_block_s8
// (_qblock_kernel), which keeps the block's weights and a slab of images
// resident in about 10 MB of VMEM so that only the block input and output
// touch HBM. An SM has 227 KB of shared memory and block42's two int8 weight
// tensors alone are 4.7 MB, so here the intermediates go through device
// memory and the 50 MB L2:
//   1. quantize x (and x for the down branch) to int8;
//   2. conv1 on the implicit-GEMM core (igemm_s8.cuh) with a fused epilogue:
//      plain BN folds into relu(acc*a1 + c1) requantized to int8; IBN-a
//      writes y1 = acc*dq1 in f32, then a per-image statistics pass and an
//      elementwise IN/BN + ReLU + requantize pass;
//   3. conv2 with the epilogue y2 = acc*a2 + c2 in f32;
//   4. per-image channel means of y2 (the SE squeeze);
//   5. the SE gate per image: bf16 fc1, ReLU, bf16 fc2, sigmoid;
//   6. the residual: x itself, or the int8 1x1 down conv on the GEMM core
//      (epilogue acc*ad + cd), and out = relu(y2*gate + branch) in x's
//      type.
//
// What bounds it: at B = 2048 the two convs are 0.6-2.5 T int8 operations
// per block, far above the ~1 GB of f32 intermediates, so the tensor-core
// rate bounds the whole block; the design spends its effort on the GEMM
// core and keeps the side passes simple and coalesced. Every per-image
// reduction is deterministic: one block per (image, 32-channel tile), a
// fixed per-thread row order and a fixed tree, no float atomics, because a
// different summation order moves requantization ties.
#include "igemm_s8.cuh"

namespace reid {

constexpr int kRedThreads = 256;
constexpr int kRedChans = 32;
constexpr int kRedStripes = kRedThreads / kRedChans;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store_rn(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_rn(float* p, float v) { *p = v; }

// x (n values of T, bf16 or f32) -> q1 = quant(x*inv1), and
// q2 = quant(x*inv2) when q2 != null. Eight values per thread.
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

// Per-image channel means of y (nimg, hw, c): mean = sum/hw and, when
// sqmean != null, sqmean = sum(y*y)/hw. grid (nimg, c/32).
__global__ void chan_mean_kernel(const float* __restrict__ y, int hw, int c,
                                 float* mean, float* sqmean) {
  __shared__ float s1[kRedStripes][kRedChans];
  __shared__ float s2[kRedStripes][kRedChans];
  const int ch = blockIdx.y * kRedChans + (threadIdx.x % kRedChans);
  const int stripe = threadIdx.x / kRedChans;
  const float* base = y + static_cast<long long>(blockIdx.x) * hw * c + ch;
  float a = 0.0f, b = 0.0f;
  for (int r = stripe; r < hw; r += kRedStripes) {
    const float v = base[static_cast<long long>(r) * c];
    a = __fadd_rn(a, v);
    b = __fadd_rn(b, __fmul_rn(v, v));
  }
  s1[stripe][threadIdx.x % kRedChans] = a;
  s2[stripe][threadIdx.x % kRedChans] = b;
  __syncthreads();
  if (stripe == 0) {
    float ta = 0.0f, tb = 0.0f;
#pragma unroll
    for (int s = 0; s < kRedStripes; ++s) {
      ta = __fadd_rn(ta, s1[s][threadIdx.x]);
      tb = __fadd_rn(tb, s2[s][threadIdx.x]);
    }
    const float rows = static_cast<float>(hw);
    mean[blockIdx.x * c + ch] = __fdiv_rn(ta, rows);
    if (sqmean) sqmean[blockIdx.x * c + ch] = __fdiv_rn(tb, rows);
  }
}

// IBN-a after conv1: IN on channels < half (per-image stats), BN affine on
// the rest, ReLU, requantize with inv_s. Elementwise over (nimg, hw, c).
__global__ void ibn_relu_quant_kernel(
    const float* __restrict__ y1, const float* __restrict__ mean,
    const float* __restrict__ sqmean, const float* __restrict__ a1,
    const float* __restrict__ c1, const float* __restrict__ in_scale,
    const float* __restrict__ in_bias, int hw, int c, int half, float inv_s,
    long long n, int8_t* __restrict__ hq) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int ch = static_cast<int>(i % c);
  const int img = static_cast<int>(i / (static_cast<long long>(hw) * c));
  const float v = y1[i];
  float h;
  if (ch < half) {
    const float m = mean[img * c + ch];
    const float var = fmaxf(__fsub_rn(sqmean[img * c + ch], __fmul_rn(m, m)), 0.0f);
    const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
    h = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, m), rstd), in_scale[ch]),
                  in_bias[ch]);
  } else {
    h = __fadd_rn(__fmul_rn(v, a1[ch]), c1[ch]);
  }
  hq[i] = quant_s8(fmaxf(h, 0.0f), inv_s);
}

// SE gate for one image per block: pooled (c) -> bf16 -> fc1 (c x mip,
// f32 sums) -> bf16 -> relu -> fc2 (mip x c, f32 sums) -> sigmoid.
__global__ void se_gate_kernel(const float* __restrict__ pooled,
                               const __nv_bfloat16* __restrict__ wfc1,
                               const __nv_bfloat16* __restrict__ wfc2, int c,
                               int mip, float* __restrict__ gate) {
  extern __shared__ float sm[];
  float* s_in = sm;       // c
  float* s_mid = sm + c;  // mip
  const float* pin = pooled + static_cast<long long>(blockIdx.x) * c;
  for (int i = threadIdx.x; i < c; i += blockDim.x)
    s_in[i] = __bfloat162float(__float2bfloat16_rn(pin[i]));
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

// out = relu(y2 * gate[img, c] + branch) in T, where branch is the f32
// down-conv output when given, else the block input x (also T).
template <typename T>
__global__ void se_residual_kernel(const float* __restrict__ y2,
                                   const float* __restrict__ gate,
                                   const float* __restrict__ branch_f32,
                                   const T* __restrict__ x, int hw, int c,
                                   long long n, T* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int ch = static_cast<int>(i % c);
  const int img = static_cast<int>(i / (static_cast<long long>(hw) * c));
  const float br = branch_f32 ? branch_f32[i] : to_f32(x[i]);
  const float v = __fadd_rn(__fmul_rn(y2[i], gate[img * c + ch]), br);
  store_rn(out + i, fmaxf(v, 0.0f));
}

inline unsigned blocks_for(long long n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace reid

#define REID_CHECK(expr)                        \
  do {                                          \
    cudaError_t e_ = (expr);                    \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

// One call runs the whole block. Scratch buffers come from the caller:
//   xq (M*cin s8), xqd (M*cin s8, down only), y1 (M*cout f32, ibn only),
//   hq (M*cout s8), y2 (M*cout f32), stats (2*nimg*cout f32, ibn only),
//   pooled (nimg*cout f32), gate (nimg*cout f32), branch (M*cout f32, down).
// w1 (cout, 9*cin), w2 (cout, 9*cout), wd (cout, cin): int8, K ordered
// (tap, cin). wfc1 (cout, mip), wfc2 (mip, cout): bf16. x and out are bf16,
// or f32 when f32_io != 0.
extern "C" int reid_se_basic_block_s8(
    const void* x, const void* w1, const void* w2, const void* a1,
    const void* c1, const void* a2, const void* c2, float inv_sx1,
    float inv_sx2, const void* wfc1, const void* wfc2, const void* wd,
    const void* ad, const void* cd, float inv_sxd, const void* dq1,
    const void* in_scale, const void* in_bias, void* xq, void* xqd, void* y1,
    void* hq, void* y2, void* stats, void* pooled, void* gate, void* branch,
    void* out, int nimg, int h, int w, int cin, int cout, int mip, int ibn,
    int f32_io, void* stream_ptr) {
  using namespace reid;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool down = wd != nullptr;
  const int hw = h * w;
  const long long m = static_cast<long long>(nimg) * hw;
  const long long n_in = m * cin;
  const long long n_out = m * cout;

  // 1. quantize x (and x for the down branch)
  int8_t* qd = down ? static_cast<int8_t*>(xqd) : nullptr;
  if (f32_io)
    quant_kernel<float><<<blocks_for(n_in / 8, 256), 256, 0, stream>>>(
        static_cast<const float*>(x), n_in, inv_sx1, static_cast<int8_t*>(xq),
        inv_sxd, qd);
  else
    quant_kernel<__nv_bfloat16><<<blocks_for(n_in / 8, 256), 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), n_in, inv_sx1,
        static_cast<int8_t*>(xq), inv_sxd, qd);
  REID_CHECK(cudaGetLastError());

  // 2. conv1 + (BN | IBN-a) + ReLU + requantize
  ConvArgs p;
  p.nimg = nimg;
  p.h = h;
  p.w = w;
  p.taps = 9;
  p.x = static_cast<const int8_t*>(xq);
  p.wt = static_cast<const int8_t*>(w1);
  p.cin = cin;
  p.cout = cout;
  if (ibn) {
    p.a = static_cast<const float*>(dq1);
    p.c = nullptr;
    p.inv_s = 0.0f;
    p.out = y1;
    REID_CHECK(launch_igemm_s8(p, kScaleF32, stream));
    float* mean = static_cast<float*>(stats);
    float* sqmean = mean + static_cast<long long>(nimg) * cout;
    chan_mean_kernel<<<dim3(nimg, cout / kRedChans), kRedThreads, 0, stream>>>(
        static_cast<const float*>(y1), hw, cout, mean, sqmean);
    REID_CHECK(cudaGetLastError());
    ibn_relu_quant_kernel<<<blocks_for(n_out, 256), 256, 0, stream>>>(
        static_cast<const float*>(y1), mean, sqmean,
        static_cast<const float*>(a1), static_cast<const float*>(c1),
        static_cast<const float*>(in_scale), static_cast<const float*>(in_bias),
        hw, cout, cout / 2, inv_sx2, n_out, static_cast<int8_t*>(hq));
    REID_CHECK(cudaGetLastError());
  } else {
    p.a = static_cast<const float*>(a1);
    p.c = static_cast<const float*>(c1);
    p.inv_s = inv_sx2;
    p.out = hq;
    REID_CHECK(launch_igemm_s8(p, kAffineReluQ8, stream));
  }

  // 3. conv2 + BN
  p.x = static_cast<const int8_t*>(hq);
  p.wt = static_cast<const int8_t*>(w2);
  p.cin = cout;
  p.a = static_cast<const float*>(a2);
  p.c = static_cast<const float*>(c2);
  p.inv_s = 0.0f;
  p.out = y2;
  REID_CHECK(launch_igemm_s8(p, kAffineF32, stream));

  // 4. SE squeeze: per-image channel means of y2
  chan_mean_kernel<<<dim3(nimg, cout / kRedChans), kRedThreads, 0, stream>>>(
      static_cast<const float*>(y2), hw, cout, static_cast<float*>(pooled),
      nullptr);
  REID_CHECK(cudaGetLastError());

  // 5. SE excite: the gate per image
  se_gate_kernel<<<nimg, 256, (cout + mip) * sizeof(float), stream>>>(
      static_cast<const float*>(pooled),
      static_cast<const __nv_bfloat16*>(wfc1),
      static_cast<const __nv_bfloat16*>(wfc2), cout, mip,
      static_cast<float*>(gate));
  REID_CHECK(cudaGetLastError());

  // 6. residual branch and output
  if (down) {
    ConvArgs d;
    d.nimg = nimg;
    d.h = h;
    d.w = w;
    d.taps = 1;
    d.x = static_cast<const int8_t*>(xqd);
    d.wt = static_cast<const int8_t*>(wd);
    d.cin = cin;
    d.cout = cout;
    d.a = static_cast<const float*>(ad);
    d.c = static_cast<const float*>(cd);
    d.inv_s = 0.0f;
    d.out = branch;
    REID_CHECK(launch_igemm_s8(d, kAffineF32, stream));
  }
  const float* br = down ? static_cast<const float*>(branch) : nullptr;
  if (f32_io)
    se_residual_kernel<float><<<blocks_for(n_out, 256), 256, 0, stream>>>(
        static_cast<const float*>(y2), static_cast<const float*>(gate), br,
        static_cast<const float*>(x), hw, cout, n_out,
        static_cast<float*>(out));
  else
    se_residual_kernel<__nv_bfloat16><<<blocks_for(n_out, 256), 256, 0,
                                        stream>>>(
        static_cast<const float*>(y2), static_cast<const float*>(gate), br,
        static_cast<const __nv_bfloat16*>(x), hw, cout, n_out,
        static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
