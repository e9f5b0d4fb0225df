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
//     against some 0.2 GB of traffic. The reference is full f32 and TF32
//     moves near-tied neighbours, so the cross term is f32 FFMA on the SIMT
//     lanes, not the tensor cores.
//   * l1 has no tensor-core form: each term is a subtract and an add of the
//     absolute value, two f32 instructions that do not pair into an FMA.
//     At the Jaccard min-sum's M = N = D = 23,100 that is 2.5e13
//     instructions against 6.4 GB of traffic.
// So the design is a plain SIMT tile GEMM shared by both: a block of 256
// threads owns a 128 x 128 output tile and walks D in chunks of 32, staging
// both operand chunks in shared memory (transposed, one padding column so
// neither the stores nor the reads conflict); each thread keeps an 8 x 8
// register sub-tile (rows ty + 16*i, columns tx + 16*j) and the next chunk
// is fetched into registers while the current one is consumed. Tails in M,
// N and D are masked in the kernel, so no operand is padded or copied.
// The squared-Euclidean epilogue adds the row norms (a one-warp-per-row
// pass before the tile kernel) and clamps at 0. It is the simple form:
// no cp.async/TMA pipeline and no warp specialisation.
#include <cuda_runtime.h>

namespace reid {

constexpr int kDT = 128;              // output tile, rows and columns
constexpr int kDK = 32;               // D chunk staged per step
constexpr int kDThreads = 256;        // 16 x 16 threads
constexpr int kDSub = 8;              // 8 x 8 outputs per thread
constexpr int kDLoads = kDT * kDK / kDThreads;   // 16 elements per operand

struct DotStep {
  __device__ __forceinline__ static float step(float acc, float a, float b) {
    return fmaf(a, b, acc);
  }
};

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

}  // namespace reid

// K6: out = max(|x|^2 + |y|^2 - 2 x.y, 0). xx (M) and yy (N) are scratch
// for the row norms.
extern "C" int reid_sqeuclidean(const void* x, const void* y, void* xx,
                                void* yy, void* out, int m, int n, int d,
                                void* stream_ptr) {
  using namespace reid;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* xxf = static_cast<float*>(xx);
  float* yyf = static_cast<float*>(yy);
  row_sqnorm_kernel<<<(m + 7) / 8, 256, 0, stream>>>(xf, m, d, xxf);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  row_sqnorm_kernel<<<(n + 7) / 8, 256, 0, stream>>>(yf, n, d, yyf);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  pairwise_kernel<DotStep><<<tile_grid(m, n), kDThreads, 0, stream>>>(
      xf, yf, xxf, yyf, static_cast<float*>(out), m, n, d);
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
