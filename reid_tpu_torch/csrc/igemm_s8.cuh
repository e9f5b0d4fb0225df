// Implicit-GEMM int8 convolution core shared by the conv3x3_s8 kernel
// (qconv.cu) and the fused SE block (qblock.cu).
//
// The convolution is one GEMM with M = B*H*W output pixels, N = Cout and
// K = taps*Cin, computed as s8 x s8 -> s32 on the int8 tensor cores with
// mma.sync.m16n8k32. The A operand (the im2col of the NHWC activation) is
// never materialized: each K tile of 64 lies inside one tap (Cin is a
// multiple of 64), so a tile row is 64 contiguous bytes of one input pixel,
// shifted by the tap's (dy, dx) and zero-filled where (h+dy, w+dx) leaves the
// image. Those are the same masked rows as the TPU kernel's roll+mask
// formulation (reid_tpu/ops/qconv.py:_row_masks), reached by bounds checks
// instead of rolls. Weights are pre-laid out once as (Cout, taps*Cin) with K
// ordered (tap, cin), so the B tile is 64 contiguous bytes per output
// channel.
//
// Tiles: 128 x 128 x 64 per block of 8 warps (each warp 64 x 32), operands
// double-buffered in shared memory by cp.async (zero-fill for the halo),
// accumulators in registers. The epilogue is fused: a per-channel scale or
// affine in f32, written as bf16, f32 or a requantized int8. Every float
// step uses explicit round-to-nearest intrinsics (__fmul_rn, __fadd_rn), so
// no multiply-add is contracted into an FMA and each value equals the plain
// PyTorch version's elementwise arithmetic bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace reid {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
// Shared-memory row stride in bytes: 16-byte aligned for cp.async, and 20
// words apart so the eight row groups of a fragment load hit distinct banks.
constexpr int kSRow = kBK + 16;
constexpr int kThreads = 256;

enum Epilogue : int {
  kScaleBf16 = 0,      // out bf16 = acc * a[c]
  kScaleF32 = 1,       // out f32  = acc * a[c]
  kAffineF32 = 2,      // out f32  = acc * a[c] + c[c]
  kAffineReluQ8 = 3,   // out s8   = quant(max(acc * a[c] + c[c], 0) * inv_s)
};

struct ConvArgs {
  const int8_t* x;     // (B, H, W, Cin) int8, NHWC
  const int8_t* wt;    // (Cout, taps*Cin) int8, K ordered (tap, cin)
  const float* a;      // (Cout,) scale or affine multiplier
  const float* c;      // (Cout,) affine offset (affine epilogues only)
  float inv_s;         // requantization multiplier (kAffineReluQ8 only)
  void* out;           // (B, H, W, Cout)
  int nimg, h, w, cin, cout;
  int taps;            // 9: 3x3 stride-1 SAME; 1: 1x1
};

__device__ __forceinline__ int8_t quant_s8(float v, float inv_s) {
  // round half to even (rintf), then clip to +-127: jnp.round semantics
  float q = rintf(__fmul_rn(v, inv_s));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int EPI>
__device__ __forceinline__ void store2(const ConvArgs& p, long long row,
                                       int col, int acc0, int acc1) {
  float v0 = static_cast<float>(acc0);
  float v1 = static_cast<float>(acc1);
  v0 = __fmul_rn(v0, p.a[col]);
  v1 = __fmul_rn(v1, p.a[col + 1]);
  const long long o = row * p.cout + col;
  if (EPI == kScaleBf16) {
    __nv_bfloat162 r;
    r.x = __float2bfloat16_rn(v0);
    r.y = __float2bfloat16_rn(v1);
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o) = r;
  } else if (EPI == kScaleF32) {
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
        make_float2(v0, v1);
  } else {
    v0 = __fadd_rn(v0, p.c[col]);
    v1 = __fadd_rn(v1, p.c[col + 1]);
    if (EPI == kAffineF32) {
      *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
          make_float2(v0, v1);
    } else {
      char2 r;
      r.x = quant_s8(fmaxf(v0, 0.0f), p.inv_s);
      r.y = quant_s8(fmaxf(v1, 0.0f), p.inv_s);
      *reinterpret_cast<char2*>(static_cast<int8_t*>(p.out) + o) = r;
    }
  }
}

// grid: (ceil(M / kBM), Cout / kBN); block: kThreads.
// Requires Cin % 64 == 0, Cout % 128 == 0 and 16-byte aligned x and wt.
template <int EPI>
__global__ void __launch_bounds__(kThreads)
    igemm_s8_kernel(const ConvArgs p) {
  __shared__ __align__(16) int8_t smem_a[2][kBM * kSRow];
  __shared__ __align__(16) int8_t smem_b[2][kBN * kSRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;      // groupID
  const int tig = lane & 3;     // thread in group
  const int warp_m = warp & 1;  // 2 x 64 rows
  const int warp_n = warp >> 1; // 4 x 32 cols

  const int hw = p.h * p.w;
  const long long m_total = static_cast<long long>(p.nimg) * hw;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int k_total = p.taps * p.cin;
  const int k_tiles = k_total / kBK;

  // Each thread copies two 16-byte chunks of A and two of B per K tile:
  // chunk q covers row q / 4, bytes (q % 4) * 16 of the 64-byte tile row.
  int ld_row[2], ld_col[2], a_img[2], a_y[2], a_x[2];
  bool a_in[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = tid + i * kThreads;
    ld_row[i] = q >> 2;
    ld_col[i] = (q & 3) * 16;
    const long long m = m0 + ld_row[i];
    a_in[i] = m < m_total;
    const long long mm = a_in[i] ? m : 0;
    a_img[i] = static_cast<int>(mm / hw);
    const int rem = static_cast<int>(mm - static_cast<long long>(a_img[i]) * hw);
    a_y[i] = rem / p.w;
    a_x[i] = rem - a_y[i] * p.w;
  }

  auto load_tile = [&](int kt, int buf) {
    const int k0 = kt * kBK;
    const int tap = k0 / p.cin;
    const int c0 = k0 - tap * p.cin;
    const int dy = p.taps == 9 ? tap / 3 - 1 : 0;
    const int dx = p.taps == 9 ? tap % 3 - 1 : 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int yy = a_y[i] + dy;
      const int xx = a_x[i] + dx;
      const bool ok = a_in[i] && yy >= 0 && yy < p.h && xx >= 0 && xx < p.w;
      const int8_t* src = p.x;
      if (ok) {
        src = p.x + ((static_cast<long long>(a_img[i]) * p.h + yy) * p.w + xx) *
                        p.cin + c0 + ld_col[i];
      }
      cp_async16(&smem_a[buf][ld_row[i] * kSRow + ld_col[i]], src, ok ? 16 : 0);
      const int n = n0 + ld_row[i];
      const int8_t* wsrc =
          p.wt + static_cast<long long>(n) * k_total + k0 + ld_col[i];
      cp_async16(&smem_b[buf][ld_row[i] * kSRow + ld_col[i]], wsrc, 16);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < k_tiles) load_tile(kt + 1, buf ^ 1);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait1();   // the group of tile kt has landed
    __syncthreads();
    const int8_t* sa = smem_a[buf];
    const int8_t* sb = smem_b[buf];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = warp_m * 64 + mt * 16 + g;
        const int8_t* p0 = sa + r * kSRow + ks + tig * 4;
        const int8_t* p1 = p0 + 8 * kSRow;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p0);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p1);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
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

inline cudaError_t launch_igemm_s8(const ConvArgs& p, int epilogue,
                                   cudaStream_t stream) {
  const long long m_total = static_cast<long long>(p.nimg) * p.h * p.w;
  dim3 grid(static_cast<unsigned>((m_total + kBM - 1) / kBM),
            static_cast<unsigned>(p.cout / kBN));
  switch (epilogue) {
    case kScaleBf16:
      igemm_s8_kernel<kScaleBf16><<<grid, kThreads, 0, stream>>>(p);
      break;
    case kScaleF32:
      igemm_s8_kernel<kScaleF32><<<grid, kThreads, 0, stream>>>(p);
      break;
    case kAffineF32:
      igemm_s8_kernel<kAffineF32><<<grid, kThreads, 0, stream>>>(p);
      break;
    case kAffineReluQ8:
      igemm_s8_kernel<kAffineReluQ8><<<grid, kThreads, 0, stream>>>(p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace reid
