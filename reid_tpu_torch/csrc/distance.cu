// Pairwise distances of f32 rows: squared Euclidean (K6) and L1 (K7).
//
// Replaces the TPU kernels reid_tpu/ops/distance.py:_pallas_sqeuclidean
// (_sqeuclidean_kernel), which pads both operands to its 256 x 512 tiles and
// D to a multiple of 128 and takes the cross term on the MXU, and
// reid_tpu/ops/distance.py:_pallas_l1, which pads D to a multiple of 2048
// and accumulates sum |x - y| in a VMEM output tile across a sequential K
// grid axis.
//
// What bounds them on an H100: both are bound by operations, not bytes.
//   * sqeuclidean, at the retrieval path's query block (M = 1,024 rows
//     against N = 23,100 gallery rows, D = 1,263): 2*M*N*D = 6.0e10 flop
//     against some 0.2 GB of traffic, 0.893 ms of FFMA at 66.9 TFLOP/s. The
//     reference is full f32 and TF32 moves near-tied neighbours, so the
//     cross term is f32 FFMA on the SIMT lanes, not the tensor cores.
//   * l1 has no tensor-core form: each term is a subtract and an add of the
//     absolute value, two f32 instructions that do not pair into an FMA.
//     At the Jaccard min-sum's M = N = D = 23,100 that is 2.5e13
//     instructions against 6.4 GB of traffic.
//
// K6's design (sqeuclidean_kernel): the FFMA pipe has to be the only thing
// the SM is busy with. Both operands are first copied once per call,
// transposed and zero-padded (D to a multiple of 16, rows to whole tiles),
// so that a D chunk of a tile is kSK contiguous rows of 16-byte aligned
// floats: D = 1,263 is odd, rows of x and y are only 4-byte aligned in
// place, and neither cp.async nor TMA can read them there. The copies move
// 0.24 GB, about 0.07 ms at 3.35 TB/s, and count in K6's time. The tile
// kernel then streams the chunks with 16-byte cp.async into a 4-stage ring
// in shared memory, one __syncthreads a chunk. A block of 256 threads owns
// a 128 x 144 output tile; each thread an 8 x 9 sub-tile laid out as 4 x 4
// quads (rows ty*4 and 64 + ty*4, columns tx*4, 64 + tx*4 and 128 + tx),
// so per k it reads its operands with four LDS.128 and one LDS.32 for 72
// FFMA. 144 columns make the query block's grid 161 x 8 = 1,288 tiles,
// 4.88 waves at two blocks on each of the 132 SMs, where 128 x 128 tiles
// would make 5.48 (a tail of half a wave). Each output is one chain of
// fmaf over k ascending from +0, no split-K; the zero padding adds
// fmaf(0, 0, acc) = acc exactly, so the result depends on neither the
// padding nor the tiling. Stores are float4 where the row allows.
//
// K7's design (pairwise_kernel<L1Step>): a plain SIMT tile kernel:
// a block of 256 threads owns a 128 x 128 output tile and walks D in
// chunks of 32, staging both operand chunks in shared memory (transposed,
// one padding column so neither the stores nor the reads conflict); each
// thread keeps an 8 x 8 register sub-tile (rows ty + 16*i, columns
// tx + 16*j) and the next chunk is fetched into registers while the current
// one is consumed. Tails in M, N and D are masked in the kernel, so no
// operand is padded or copied. It is at 65% of its bound and stays as it is.
#include <cuda_runtime.h>
#include <stdint.h>

namespace reid {

constexpr int kDT = 128;              // output tile, rows and columns
constexpr int kDK = 32;               // D chunk staged per step
constexpr int kDThreads = 256;        // 16 x 16 threads
constexpr int kDSub = 8;              // 8 x 8 outputs per thread
constexpr int kDLoads = kDT * kDK / kDThreads;   // 16 elements per operand

struct L1Step {
  __device__ __forceinline__ static float step(float acc, float a, float b) {
    return __fadd_rn(acc, fabsf(__fsub_rn(a, b)));
  }
};

// sum_k v[r, k]^2 for each row r: one warp per row.
__global__ void row_sqnorm_kernel(const float* __restrict__ v, int rows, int d,
                                  float* __restrict__ out) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const float* row = v + static_cast<long long>(warp) * d;
  float acc = 0.0f;
  for (int k = lane; k < d; k += 32) acc = fmaf(row[k], row[k], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (lane == 0) out[warp] = acc;
}

// Loads of one D chunk: thread t reads column k = t % 32 of rows
// t / 32 + 8*i, so a warp reads 32 consecutive floats of one row.
__device__ __forceinline__ void fetch(const float* __restrict__ v, int rows,
                                      int d, int r0, int k0, float* reg) {
  const int k = k0 + (threadIdx.x & (kDK - 1));
  const int r = threadIdx.x / kDK;
#pragma unroll
  for (int i = 0; i < kDLoads; ++i) {
    const int row = r0 + r + i * (kDThreads / kDK);
    reg[i] = (row < rows && k < d)
                 ? __ldg(v + static_cast<long long>(row) * d + k) : 0.0f;
  }
}

__device__ __forceinline__ void stage(float (*s)[kDT + 1], const float* reg) {
  const int k = threadIdx.x & (kDK - 1);
  const int r = threadIdx.x / kDK;
#pragma unroll
  for (int i = 0; i < kDLoads; ++i) s[k][r + i * (kDThreads / kDK)] = reg[i];
}

// out[m, n] = sum_k Step(x[m, k], y[n, k]), then the epilogue: with norms,
// max(xx[m] + yy[n] - 2*acc, 0); without, acc. x (M, D), y (N, D), out
// (M, N), all row-major f32.
template <class Step>
__global__ void __launch_bounds__(kDThreads)
pairwise_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ xx, const float* __restrict__ yy,
                float* __restrict__ out, int m, int n, int d) {
  __shared__ float sx[kDK][kDT + 1];
  __shared__ float sy[kDK][kDT + 1];
  const int m0 = blockIdx.y * kDT;
  const int n0 = blockIdx.x * kDT;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[kDSub][kDSub];
#pragma unroll
  for (int i = 0; i < kDSub; ++i)
#pragma unroll
    for (int j = 0; j < kDSub; ++j) acc[i][j] = 0.0f;

  float rx[kDLoads], ry[kDLoads];
  fetch(x, m, d, m0, 0, rx);
  fetch(y, n, d, n0, 0, ry);
  for (int k0 = 0; k0 < d; k0 += kDK) {
    stage(sx, rx);
    stage(sy, ry);
    __syncthreads();
    if (k0 + kDK < d) {
      fetch(x, m, d, m0, k0 + kDK, rx);
      fetch(y, n, d, n0, k0 + kDK, ry);
    }
    // chunk columns past d are zeros on both sides and add nothing
#pragma unroll 4
    for (int k = 0; k < kDK; ++k) {
      float a[kDSub], b[kDSub];
#pragma unroll
      for (int i = 0; i < kDSub; ++i) a[i] = sx[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kDSub; ++j) b[j] = sy[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kDSub; ++i)
#pragma unroll
        for (int j = 0; j < kDSub; ++j)
          acc[i][j] = Step::step(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kDSub; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
    float* orow = out + static_cast<long long>(row) * n;
#pragma unroll
    for (int j = 0; j < kDSub; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= n) continue;
      float v = acc[i][j];
      if (xx != nullptr)
        v = fmaxf(__fsub_rn(__fadd_rn(xx[row], yy[col]), __fmul_rn(2.0f, v)),
                  0.0f);
      orow[col] = v;
    }
  }
}

inline dim3 tile_grid(int m, int n) {
  return dim3((n + kDT - 1) / kDT, (m + kDT - 1) / kDT);
}

// ---------------------------------------------------------------------------
// K6: the squared-Euclidean tile kernel (see the header).

constexpr int kSM = 128;           // rows of x a tile
constexpr int kSN = 144;           // rows of y a tile
constexpr int kSK = 16;            // D a stage
constexpr int kSStages = 4;
constexpr int kSThreads = 256;     // 16 x 16 threads, 8 x 9 outputs each
constexpr int kSStage = kSK * (kSM + kSN);          // floats a stage
constexpr int kSSmem = kSStages * kSStage * 4;      // 69,632 bytes

// vt[k][r] = v[r][k] for r < rows and k < d, and 0 elsewhere in (dp, rp):
// 32 x 32 tiles through shared memory, both sides coalesced.
__global__ void transpose_pad_kernel(const float* __restrict__ v, int rows,
                                     int d, float* __restrict__ vt, int rp,
                                     int dp) {
  __shared__ float t[32][33];
  const int r0 = blockIdx.x * 32;
  const int k0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i;
    const int k = k0 + tx;
    t[i][tx] = (r < rows && k < d) ? v[static_cast<long long>(r) * d + k] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i;
    const int r = r0 + tx;
    if (k < dp && r < rp) vt[static_cast<long long>(k) * rp + r] = t[tx][i];
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// out[m, n] = max(xx[m] + yy[n] - 2 * sum_k xt[k, m] * yt[k, n], 0) over
// the padded operands; rows m < M and columns n < N are written.
__global__ void __launch_bounds__(kSThreads, 2)
sqeuclidean_kernel(const float* __restrict__ xt, const float* __restrict__ yt,
                   int mp, int np, int dp, const float* __restrict__ xx,
                   const float* __restrict__ yy, float* __restrict__ out,
                   int m, int n) {
  extern __shared__ __align__(16) float sm[];
  const int m0 = blockIdx.y * kSM;
  const int n0 = blockIdx.x * kSN;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nk = dp / kSK;

  // One stage: kSK rows of kSM floats of x (512 16-byte chunks, two a
  // thread), then kSK rows of kSN floats of y (576 chunks).
  auto load = [&](int kc, int st) {
    float* sx = sm + st * kSStage;
    float* sy = sx + kSK * kSM;
    const long long k0 = static_cast<long long>(kc) * kSK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * kSThreads;
      const int kr = q / (kSM / 4);
      const int c = (q % (kSM / 4)) * 4;
      cp_async16(sx + kr * kSM + c, xt + (k0 + kr) * mp + m0 + c);
    }
    for (int q = tid; q < kSK * kSN / 4; q += kSThreads) {
      const int kr = q / (kSN / 4);
      const int c = (q % (kSN / 4)) * 4;
      cp_async16(sy + kr * kSN + c, yt + (k0 + kr) * np + n0 + c);
    }
  };

  float acc[8][9];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 9; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int st = 0; st < kSStages - 1; ++st) {
    if (st < nk) load(st, st);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kc = 0; kc < nk; ++kc) {
    // chunk kc has landed for every thread, and every thread is done with
    // chunk kc - 1, whose buffer the next load reuses
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kSStages - 2));
    __syncthreads();
    const int next = kc + kSStages - 1;
    if (next < nk) load(next, next % kSStages);
    asm volatile("cp.async.commit_group;\n" ::);
    const float* sx = sm + (kc % kSStages) * kSStage;
    const float* sy = sx + kSK * kSM;
#pragma unroll
    for (int k = 0; k < kSK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(sx + k * kSM + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(sx + k * kSM + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sy + k * kSN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(sy + k * kSN + 64 + tx * 4);
      const float b2 = sy[k * kSN + 128 + tx];
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[9] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w, b2};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 9; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  const bool vec = (n & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= m) continue;
    const float xr = xx[row];
    float* orow = out + static_cast<long long>(row) * n;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = n0 + q * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = col + e < n
                   ? fmaxf(__fsub_rn(__fadd_rn(xr, yy[col + e]),
                                     __fmul_rn(2.0f, acc[i][q * 4 + e])),
                           0.0f)
                   : 0.0f;
      if (vec && col + 3 < n) {
        *reinterpret_cast<float4*>(orow + col) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < n) orow[col + e] = v[e];
      }
    }
    const int col = n0 + 128 + tx;
    if (col < n)
      orow[col] = fmaxf(__fsub_rn(__fadd_rn(xr, yy[col]),
                                  __fmul_rn(2.0f, acc[i][8])),
                        0.0f);
  }
}

}  // namespace reid

// K6: out = max(|x|^2 + |y|^2 - 2 x.y, 0). xx (M) and yy (N) are scratch
// for the row norms, xt (dp, mp) and yt (dp, np) for the transposed,
// zero-padded operands: mp a multiple of kSM, np of kSN, dp of kSK.
extern "C" int reid_sqeuclidean(const void* x, const void* y, void* xt,
                                void* yt, void* xx, void* yy, void* out, int m,
                                int n, int d, int mp, int np, int dp,
                                void* stream_ptr) {
  using namespace reid;
  if (mp < m || np < n || dp < d || mp % kSM || np % kSN || dp % kSK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* xtf = static_cast<float*>(xt);
  float* ytf = static_cast<float*>(yt);
  float* xxf = static_cast<float*>(xx);
  float* yyf = static_cast<float*>(yy);
  row_sqnorm_kernel<<<(m + 7) / 8, 256, 0, stream>>>(xf, m, d, xxf);
  row_sqnorm_kernel<<<(n + 7) / 8, 256, 0, stream>>>(yf, n, d, yyf);
  transpose_pad_kernel<<<dim3((mp + 31) / 32, dp / 32 + (dp % 32 != 0)), 256,
                         0, stream>>>(xf, m, d, xtf, mp, dp);
  transpose_pad_kernel<<<dim3((np + 31) / 32, dp / 32 + (dp % 32 != 0)), 256,
                         0, stream>>>(yf, n, d, ytf, np, dp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool attr_set = false;
  if (!attr_set) {
    e = cudaFuncSetAttribute(sqeuclidean_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  sqeuclidean_kernel<<<dim3(np / kSN, mp / kSM), kSThreads, kSSmem, stream>>>(
      xtf, ytf, mp, np, dp, xxf, yyf, static_cast<float*>(out), m, n);
  return static_cast<int>(cudaGetLastError());
}

// K7: out = sum_k |x - y|.
extern "C" int reid_l1(const void* x, const void* y, void* out, int m, int n,
                       int d, void* stream_ptr) {
  using namespace reid;
  pairwise_kernel<L1Step><<<tile_grid(m, n), kDThreads, 0,
                            static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), nullptr,
      nullptr, static_cast<float*>(out), m, n, d);
  return static_cast<int>(cudaGetLastError());
}
