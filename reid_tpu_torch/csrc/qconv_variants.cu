// Three more forms of the int8 3x3 stride-1 SAME convolution, each with the
// contract of conv3x3_s8 (qconv.cu): x (B, H, W, Cin) int8 NHWC, s8 x s8 ->
// s32, epilogue acc * scale[c] written as bf16 or f32. Integer sums are
// exact in any order, so each equals conv3x3_s8 bit for bit.
//
// conv3x3_s8_ncat replaces reid_tpu/ops/qconv.py:conv3x3_s8_ncat
// (_qconv_ncat_kernel): ONE dot of the activation rows against the weights
// N-concatenated to (Cin, 9*Cout), then the nine s32 column slices of the
// product P are rolled along the flat row axis, masked and summed. Here:
// launch one is a dense GEMM on the implicit-GEMM core (taps = 1, K = Cin,
// N = 9*Cout) with the raw s32 epilogue writing P to device memory; launch
// two (ncat_tapsum_kernel) sums out[r, c] = scale[c] * sum_t mask_t(r) *
// P[r + off_t, t*Cout + c]. What bounds it is P: 9*Cout s32 a row written
// and read back, 36x the bytes of the int8 input at Cin = Cout (1.21 GB at
// B = 512, 32x16, c128), against an operation bound 18x smaller. The TPU
// kernel keeps P in VMEM; 228 KB of shared memory per SM cannot hold it
// for a tile worth a GEMM, so the port keeps the formulation and pays the
// traffic, bounding the buffer by running the batch in image blocks.
//
// conv3x3_s8_dma replaces reid_tpu/ops/qconv.py:conv3x3_s8_dma
// (_qconv_dma_kernel): the nine shifted row windows are copied into a
// (rows, 9*Cin) int8 im2col buffer, masked, and contracted in ONE dot with
// K = 9*Cin. Here: launch one (im2col_s8_kernel) writes the buffer in
// 16-byte vectors, masked rows as zeros; launch two is the GEMM core with
// taps = 1 and K = 9*Cin. What bounds it: the buffer, 9x the input bytes
// written and read (0.30 GB at B = 512, 32x16, c128), on top of K1's
// operation bound. Hopper's TMA has an im2col mode (cuTensorMapEncodeIm2col)
// that stages such windows straight into shared memory and would remove the
// buffer; that is for a later version.
//
// conv3x3_s8_bitshift replaces reid_tpu/ops/qconv.py:conv3x3_s8_bitshift
// (_qconv_bitshift_kernel), which builds the im2col in registers from one
// loaded copy of the rows (shifts of the u32 view of four packed int8
// rows) and contracts it in one dot. Here (bitshift_kernel): per 128 x 128
// output tile and per 64-channel chunk, the tile's 128 rows plus a halo of
// W + 1 rows on each side are staged into shared memory once (cp.async,
// zero-filled past the tensor), and the mma.sync A fragments of all nine
// taps are read from that slab at the tap's row offset, the fragment
// registers of masked rows set to zero. Each activation byte is read from
// device memory once per tile; conv3x3_s8 reads it once per tap (up to nine
// times, mostly from L2). The operation bound is K1's; the design is the
// one a later K1 redesign (wgmma, TMA) can grow from.
#include "igemm_s8.cuh"

namespace reid {

__device__ __forceinline__ bool tap_ok(int y, int x, int t, int h, int w) {
  const int yy = y + t / 3 - 1;
  const int xx = x + t % 3 - 1;
  return yy >= 0 && yy < h && xx >= 0 && xx < w;
}

// ---- conv3x3_s8_ncat, launch two ------------------------------------------
// One thread per 4 output channels of one row of an image block.
template <bool F32>
__global__ void ncat_tapsum_kernel(const int* __restrict__ prod,
                                   const float* __restrict__ scale, void* out,
                                   long long rows, int h, int w, int cout) {
  const int cq = cout / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= rows * cq) return;
  const long long r = i / cq;
  const int c = static_cast<int>(i - r * cq) * 4;
  const int x = static_cast<int>(r % w);
  const int y = static_cast<int>((r / w) % h);
  int4 acc = make_int4(0, 0, 0, 0);
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    if (!tap_ok(y, x, t, h, w)) continue;
    const long long src = r + (t / 3 - 1) * w + (t % 3 - 1);
    const int4 v = *reinterpret_cast<const int4*>(
        prod + src * 9 * cout + t * cout + c);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  const float v0 = __fmul_rn(static_cast<float>(acc.x), scale[c]);
  const float v1 = __fmul_rn(static_cast<float>(acc.y), scale[c + 1]);
  const float v2 = __fmul_rn(static_cast<float>(acc.z), scale[c + 2]);
  const float v3 = __fmul_rn(static_cast<float>(acc.w), scale[c + 3]);
  const long long o = r * cout + c;
  if (F32) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
        make_float4(v0, v1, v2, v3);
  } else {
    __nv_bfloat162 lo, hi;
    lo.x = __float2bfloat16_rn(v0);
    lo.y = __float2bfloat16_rn(v1);
    hi.x = __float2bfloat16_rn(v2);
    hi.y = __float2bfloat16_rn(v3);
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o);
    dst[0] = lo;
    dst[1] = hi;
  }
}

// ---- conv3x3_s8_dma, launch one -------------------------------------------
// One thread per 16-byte vector of the (rows, 9*Cin) im2col buffer, whose
// columns are ordered (tap, cin) like the packed weight's K.
__global__ void im2col_s8_kernel(const int8_t* __restrict__ x,
                                 int8_t* __restrict__ cols, long long rows,
                                 int h, int w, int cin) {
  const int cv = cin / 16;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= rows * 9 * cv) return;
  const long long r = i / (9 * cv);
  const int rem = static_cast<int>(i - r * 9 * cv);
  const int t = rem / cv;
  const int j = rem - t * cv;
  const int xi = static_cast<int>(r % w);
  const int yi = static_cast<int>((r / w) % h);
  int4 v = make_int4(0, 0, 0, 0);
  if (tap_ok(yi, xi, t, h, w)) {
    const long long src = r + (t / 3 - 1) * w + (t % 3 - 1);
    v = *reinterpret_cast<const int4*>(x + src * cin + j * 16);
  }
  *reinterpret_cast<int4*>(cols + r * 9 * cin + t * cin + j * 16) = v;
}

// ---- conv3x3_s8_bitshift ----------------------------------------------------
// grid: (ceil(M / kBM), Cout / kBN); block: kThreads; dynamic shared memory
// bitshift_smem_bytes(w). K loop: 64-channel chunks outer, the nine taps
// inner, so the slab of a chunk serves all nine taps. The slab is double
// buffered by chunk (the next chunk's slab is requested with the last
// tap's B tile), the B tile by step.
__host__ __device__ inline int bitshift_slab_rows(int w) {
  return kBM + 2 * (w + 1);
}

inline int bitshift_smem_bytes(int w) {
  return (2 * bitshift_slab_rows(w) + 2 * kBN) * kSRow;
}

template <int EPI>
__global__ void __launch_bounds__(kThreads)
    bitshift_kernel(const ConvArgs p) {
  extern __shared__ __align__(16) int8_t smem[];
  const int halo = p.w + 1;
  const int slab_rows = bitshift_slab_rows(p.w);
  int8_t* slab0 = smem;
  int8_t* b0 = smem + 2 * slab_rows * kSRow;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int warp_m = warp & 1;
  const int warp_n = warp >> 1;

  const int hw = p.h * p.w;
  const long long m_total = static_cast<long long>(p.nimg) * hw;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int k_total = 9 * p.cin;
  const int k_tiles = 9 * (p.cin / kBK);

  // bit t of okmask[mt][half]: tap t reaches inside the image for this
  // thread's fragment row warp_m*64 + mt*16 + g + 8*half (0 past the end)
  uint32_t okmask[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + warp_m * 64 + mt * 16 + g + 8 * half;
      uint32_t bits = 0;
      if (m < m_total) {
        const int rem = static_cast<int>(m % hw);
        const int y = rem / p.w;
        const int x = rem - y * p.w;
#pragma unroll
        for (int t = 0; t < 9; ++t) bits |= tap_ok(y, x, t, p.h, p.w) << t;
      }
      okmask[mt][half] = bits;
    }

  auto load_slab = [&](int chunk, int buf) {
    int8_t* dst = slab0 + buf * slab_rows * kSRow;
    for (int q = tid; q < slab_rows * 4; q += kThreads) {
      const int row = q >> 2;
      const int col = (q & 3) * 16;
      const long long m = m0 - halo + row;
      const bool ok = m >= 0 && m < m_total;
      const int8_t* src =
          ok ? p.x + m * p.cin + chunk * kBK + col : p.x;
      cp_async16(dst + row * kSRow + col, src, ok ? 16 : 0);
    }
  };
  auto load_b = [&](int kt, int buf) {
    const int chunk = kt / 9;
    const int tap = kt - chunk * 9;
    const int k0 = tap * p.cin + chunk * kBK;
    int8_t* dst = b0 + buf * kBN * kSRow;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * kThreads;
      const int row = q >> 2;
      const int col = (q & 3) * 16;
      cp_async16(dst + row * kSRow + col,
                 p.wt + static_cast<long long>(n0 + row) * k_total + k0 + col,
                 16);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  load_slab(0, 0);
  load_b(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int chunk = kt / 9;
    const int tap = kt - chunk * 9;
    if (kt + 1 < k_tiles) {
      load_b(kt + 1, (kt + 1) & 1);
      if ((kt + 1) % 9 == 0) load_slab(chunk + 1, (chunk + 1) & 1);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    // row i of the tap's shifted view is slab row i + halo + dy*W + dx
    const int8_t* sa = slab0 + (chunk & 1) * slab_rows * kSRow +
                       (halo + (tap / 3 - 1) * p.w + (tap % 3 - 1)) * kSRow;
    const int8_t* sb = b0 + (kt & 1) * kBN * kSRow;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = warp_m * 64 + mt * 16 + g;
        const int8_t* p0 = sa + r * kSRow + ks + tig * 4;
        const int8_t* p1 = p0 + 8 * kSRow;
        const uint32_t k0 = ((okmask[mt][0] >> tap) & 1u) ? 0xffffffffu : 0u;
        const uint32_t k1 = ((okmask[mt][1] >> tap) & 1u) ? 0xffffffffu : 0u;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p0) & k0;
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p1) & k1;
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p0 + 16) & k0;
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p1 + 16) & k1;
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int r = warp_n * 32 + nt * 8 + g;
        const int8_t* q0 = sb + r * kSRow + ks + tig * 4;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(q0);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(q0 + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const long long r0 = m0 + warp_m * 64 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + warp_n * 32 + nt * 8 + tig * 2;
      if (r0 < m_total) store2<EPI>(p, r0, col, acc[mt][nt][0], acc[mt][nt][1]);
      if (r0 + 8 < m_total)
        store2<EPI>(p, r0 + 8, col, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

template <int EPI>
cudaError_t launch_bitshift(const ConvArgs& p, cudaStream_t stream) {
  const int smem = bitshift_smem_bytes(p.w);
  cudaError_t err = cudaFuncSetAttribute(
      bitshift_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long m_total = static_cast<long long>(p.nimg) * p.h * p.w;
  dim3 grid(static_cast<unsigned>((m_total + kBM - 1) / kBM),
            static_cast<unsigned>(p.cout / kBN));
  bitshift_kernel<EPI><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

ConvArgs conv_args(const void* x, const void* w, const void* scale, void* out,
                   int nimg, int h, int w_, int cin, int cout, int taps) {
  ConvArgs p;
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(w);
  p.a = static_cast<const float*>(scale);
  p.out = out;
  p.nimg = nimg;
  p.h = h;
  p.w = w_;
  p.cin = cin;
  p.cout = cout;
  p.taps = taps;
  return p;
}

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace reid

extern "C" int reid_conv3x3_s8_bitshift(const void* x, const void* w,
                                        const void* scale, void* out, int nimg,
                                        int h, int w_, int cin, int cout,
                                        int out_f32, void* stream) {
  const reid::ConvArgs p =
      reid::conv_args(x, w, scale, out, nimg, h, w_, cin, cout, 9);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_f32 ? reid::launch_bitshift<reid::kScaleF32>(p, s)
                                  : reid::launch_bitshift<reid::kScaleBf16>(p, s));
}

// wn (9*Cout, Cin) tap-major along N; prod (img_block*H*W, 9*Cout) s32
// scratch. Runs the batch in blocks of img_block images, two launches each.
extern "C" int reid_conv3x3_s8_ncat(const void* x, const void* wn,
                                    const void* scale, void* out, void* prod,
                                    int nimg, int h, int w_, int cin, int cout,
                                    int img_block, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long hw = static_cast<long long>(h) * w_;
  const int esize = out_f32 ? 4 : 2;
  for (int i0 = 0; i0 < nimg; i0 += img_block) {
    const int nb = nimg - i0 < img_block ? nimg - i0 : img_block;
    const long long rows = nb * hw;
    const reid::ConvArgs p = reid::conv_args(
        static_cast<const int8_t*>(x) + i0 * hw * cin, wn, nullptr, prod, nb,
        h, w_, cin, 9 * cout, 1);
    cudaError_t err = reid::launch_igemm_s8(p, reid::kRawS32, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* o = static_cast<char*>(out) + i0 * hw * cout * esize;
    const unsigned grid = reid::blocks_for(rows * (cout / 4));
    if (out_f32) {
      reid::ncat_tapsum_kernel<true><<<grid, reid::kThreads, 0, s>>>(
          static_cast<const int*>(prod), static_cast<const float*>(scale), o,
          rows, h, w_, cout);
    } else {
      reid::ncat_tapsum_kernel<false><<<grid, reid::kThreads, 0, s>>>(
          static_cast<const int*>(prod), static_cast<const float*>(scale), o,
          rows, h, w_, cout);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// wt (Cout, 9*Cin) as for conv3x3_s8; cols (img_block*H*W, 9*Cin) int8
// scratch. Runs the batch in blocks of img_block images, two launches each.
extern "C" int reid_conv3x3_s8_dma(const void* x, const void* wt,
                                   const void* scale, void* out, void* cols,
                                   int nimg, int h, int w_, int cin, int cout,
                                   int img_block, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long hw = static_cast<long long>(h) * w_;
  const int esize = out_f32 ? 4 : 2;
  for (int i0 = 0; i0 < nimg; i0 += img_block) {
    const int nb = nimg - i0 < img_block ? nimg - i0 : img_block;
    const long long rows = nb * hw;
    reid::im2col_s8_kernel<<<reid::blocks_for(rows * 9 * (cin / 16)),
                             reid::kThreads, 0, s>>>(
        static_cast<const int8_t*>(x) + i0 * hw * cin,
        static_cast<int8_t*>(cols), rows, h, w_, cin);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // the buffer as one image of rows x 1 pixels with 9*Cin channels
    const reid::ConvArgs p = reid::conv_args(
        cols, wt, scale, static_cast<char*>(out) + i0 * hw * cout * esize, 1,
        static_cast<int>(rows), 1, 9 * cin, cout, 1);
    err = reid::launch_igemm_s8(p, out_f32 ? reid::kScaleF32 : reid::kScaleBf16,
                                s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
