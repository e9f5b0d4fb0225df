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
// The design:
//   * Math: wgmma.mma_async m64nNk32 s8 x s8 -> s32, the only instruction
//     that reaches the int8 rate. A block has two consumer warpgroups and
//     one producer warpgroup; setmaxnreg gives the consumers 232 registers
//     and the producer 40. A tile is 128 pixels x 256 channels where Cout
//     allows (each consumer 64 rows, one m64n256 a k32 step), else 256 x
//     128 (each consumer 128 rows, two m64n128): 128 s32 accumulators a
//     consumer thread either way, in registers. Both shapes load 384 rows
//     of operands a K step for 128 x 256 products. A first version with
//     128 x 128 tiles (256 rows a step for half as many products) and
//     64-channel steps ran block21 at B = 2048 in 0.49 ms on an H100 SXM
//     at 700 W, a third of the int8 rate; these tiles with 128-channel
//     steps run it in 0.28 ms.
//   * Operands by TMA into a ring of 3-6 stages (as many as fit) gated by
//     mbarriers, started by one producer thread. A K step is one tap and BK
//     input channels: 128 where Cin % 128 == 0, in the 128-byte swizzle,
//     else 64 (Cin = 64 is in the contract) in the 64-byte swizzle; the
//     wgmma descriptors name the same swizzle.
//   * B, the packed weight (Cout, 9*Cin) K-major: a 2-D tiled TMA box of
//     BK bytes x N rows.
//   * A, the implicit im2col: a 4-D tiled TMA box over the NHWC activation,
//     BK channels x bw x bh x bn pixels, at the output tile's origin
//     shifted by the tap's (dx, dy). Coordinates outside the tensor are
//     zero-filled by the hardware, which gives exactly the SAME halo (the
//     masked rows of reid_tpu's _row_masks), and the box never wraps from
//     one image row or image into the next. This was chosen over TMA's
//     im2col mode because the tiled box needs no corner arithmetic and is
//     checked the same way at every shape; over cp.async zero-fill loads
//     because the producer then sends two instructions a stage instead of
//     hundreds of copies. Its cost: an output tile is a box of whole
//     pixels, bw = min(W, BM) wide, bh rows of an image and, when it holds
//     whole images, bn of them, so a tile uses bw*bh*bn <= BM of its rows.
//     Every shape of the trunk (32x16, 16x8, 8x4) fills them all; a ragged
//     shape computes the unused rows and stores none of them.
//   * Persistent grid: one block per SM walks the output tiles, so the
//     producer loads the next tile's stages while the consumers run the
//     epilogue of the last.
//   * Epilogue: the same per-element arithmetic as igemm_s8.cuh's store2
//     (int to f32, __fmul_rn by the scale, __float2bfloat16_rn), so the
//     result equals conv3x3_s8_plain bit for bit (integer sums are exact in
//     any order). Each warp stages 16 rows, 64 columns at a time, in
//     shared memory and writes them as 16-byte row segments.
//   * TMA descriptors are made on the host with cuTensorMapEncodeTiled,
//     reached through cudaGetDriverEntryPoint (no -lcuda), and passed as
//     __grid_constant__ kernel parameters.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace reid {
namespace k1 {

constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreads = 384;     // and one producer warpgroup
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take
constexpr int kMaxStages = 6;

// A tile of BM output pixels x BN output channels, K steps of BK bytes
// (one tap, BK channels). Each consumer warpgroup owns BM / 2 rows as
// kMT subtiles of 64 (one wgmma each a k32 step).
template <int BM, int BN, int BK, bool F32>
struct Cfg {
  static constexpr int kMT = BM / 128;
  static constexpr int kEsize = F32 ? 4 : 2;
  static constexpr int kABytes = BM * BK;
  static constexpr int kBBytes = BN * BK;
  // staging row of one warp: 64 output columns, padded so the fragment
  // stores of a half-warp (f32) or a warp (bf16) hit distinct banks
  static constexpr int kRowBytes = 64 * kEsize + (F32 ? 32 : 16);
  static constexpr int kStgBytes = 8 * 16 * kRowBytes;
  // as many stages as fit beside the staging rows, at most kMaxStages
  static constexpr int kFit =
      (kSmemMax - 1024 - kStgBytes - 16 * kMaxStages) / (kABytes + kBBytes);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kAOff = 0;
  static constexpr int kBOff = kAOff + kStages * kABytes;
  static constexpr int kStgOff = kBOff + kStages * kBBytes;
  static constexpr int kBarOff = kStgOff + kStgBytes;
  static constexpr int kSmem = kBarOff + 16 * kStages + 1024;  // + align
  static_assert(kStages >= 3, "the ring needs three stages");
  static_assert(kSmem <= kSmemMax, "shared memory");
};

// The shape of one call and its tiling.
struct Shape {
  int nimg, h, w, cin, cout;
  int bw, bh, bn;                 // output tile box: pixels along W, H, B
  int tiles_x, tiles_y, tiles_m;  // boxes along W, H (and B), all of them
  int tiles_n;                    // Cout / BN
  int k_tiles;                    // 9 * Cin / BK
  int a_bytes;                    // bytes of one A box: BK * bw * bh * bn
};

struct Tile {
  int x0, y0, n0, nt;
};

__device__ __forceinline__ Tile decode(const Shape& s, int t) {
  Tile r;
  r.nt = t % s.tiles_n;
  int mt = t / s.tiles_n;
  r.x0 = (mt % s.tiles_x) * s.bw;
  mt /= s.tiles_x;
  r.y0 = (mt % s.tiles_y) * s.bh;
  r.n0 = (mt / s.tiles_y) * s.bn;
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand whose rows are BK
// bytes (64 or 128) in the swizzle of the same width: groups of 8 rows
// 8 * BK bytes apart (SBO), the leading offset unused for a swizzled
// K-major layout (1), layout type 1 (128-byte) or 2 (64-byte). A k32 step
// inside the row advances the start address by 32 bytes.
template <int BK>
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * BK) >> 4) << 32) |
         (static_cast<uint64_t>(BK == 128 ? 1 : 2) << 62);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n128(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(int* d, uint64_t a, uint64_t b) {
  if constexpr (BN == 256) {
    wgmma_n256(d, a, b);
  } else {
    wgmma_n128(d, a, b);
  }
}

// grid: min(tiles, SMs) persistent blocks of kThreads; dynamic shared
// memory Cfg::kSmem. Requires Cin % BK == 0, Cout % BN == 0, a 16-byte
// aligned x and the maps of make_maps.
template <int BM, int BN, int BK, bool F32>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w,
                         const Shape s, const float* __restrict__ scale,
                         void* __restrict__ out) {
  using C = Cfg<BM, BN, BK, F32>;
  constexpr int kStages = C::kStages;
  constexpr int MT = C::kMT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms aligned
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sa = base + C::kAOff;
  const uint32_t sb = base + C::kBOff;
  const uint32_t full = base + C::kBarOff;        // kStages barriers
  const uint32_t empty = full + 8 * kStages;      // kStages barriers

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);   // the producer's expect_tx arrival
      mbar_init(empty + 8 * i, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int total = s.tiles_m * s.tiles_n;

  if (tid >= kConsumers) {
    // Producer warpgroup: one thread starts both loads of every stage.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Tile tile = decode(s, t);
        for (int kt = 0; kt < s.k_tiles; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, s.a_bytes + C::kBBytes);
          const int k0 = kt * BK;
          const int tap = k0 / s.cin;
          tma_load_4d(sa + stage * C::kABytes, &map_x, bar, k0 - tap * s.cin,
                      tile.x0 + tap % 3 - 1, tile.y0 + tap / 3 - 1, tile.n0);
          tma_load_2d(sb + stage * C::kBBytes, &map_w, bar, k0, tile.nt * BN);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumer warpgroups: rows wg * BM / 2 .. + BM / 2 - 1 of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = tid >> 7;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    uint8_t* stg = smem + C::kStgOff + warp * 16 * C::kRowBytes;
    int stage = 0;
    uint32_t phase = 0;
    int acc[MT][BN / 2];
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const Tile tile = decode(s, t);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0;
      fence_acc<MT * BN / 2>(&acc[0][0]);
      int prev = 0;
      for (int kt = 0; kt < s.k_tiles; ++kt) {
        mbar_wait(full + 8 * stage, phase);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const uint32_t a = sa + stage * C::kABytes + wg * MT * 64 * BK;
        const uint32_t b = sb + stage * C::kBBytes;
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            wgmma<BN>(acc[mt], desc_sw<BK>(a + mt * 64 * BK + ks * 32),
                      desc_sw<BK>(b + ks * 32));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the group of the previous stage has finished reading it
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc<MT * BN / 2>(&acc[0][0]);
      if (lane == 0) mbar_arrive(empty + 8 * prev);

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
            const float s0 = __ldg(scale + col0 + cc * 64 + c);
            const float s1 = __ldg(scale + col0 + cc * 64 + c + 1);
            const int* d = &acc[mt][4 * j];
            const float v0 = __fmul_rn(static_cast<float>(d[0]), s0);
            const float v1 = __fmul_rn(static_cast<float>(d[1]), s1);
            const float v2 = __fmul_rn(static_cast<float>(d[2]), s0);
            const float v3 = __fmul_rn(static_cast<float>(d[3]), s1);
            uint8_t* p0 = stg + g * C::kRowBytes + c * C::kEsize;
            uint8_t* p1 = p0 + 8 * C::kRowBytes;
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
          constexpr int kChunks = 64 * C::kEsize / 16;  // 16-byte chunks a row
#pragma unroll
          for (int i = 0; i < 16 * kChunks / 32; ++i) {
            const int idx = lane + 32 * i;
            const int r = idx / kChunks;
            const int q = idx % kChunks;
            const long long o = __shfl_sync(0xffffffffu, orow, r);
            if (o >= 0) {
              const uint4 v = *reinterpret_cast<const uint4*>(
                  stg + r * C::kRowBytes + q * 16);
              *reinterpret_cast<uint4*>(
                  static_cast<uint8_t*>(out) +
                  (o * s.cout + col0 + cc * 64) * C::kEsize + q * 16) = v;
            }
          }
          __syncwarp();
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the runtime has loaded, so
// this library needs no link against it.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The activation as a 4-D map (C, W, H, B) read in boxes of
// (BK, bw, bh, bn), and the packed weight as a 2-D map (9*Cin, Cout) read
// in boxes of (BK, BN); both in the BK-byte swizzle, out-of-bounds
// zero-filled.
template <int BN, int BK>
cudaError_t make_maps(const void* x, const void* w, const Shape& s,
                      CUtensorMap* map_x, CUtensorMap* map_w) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const CUtensorMapSwizzle swz =
      BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint64_t xdim[4] = {static_cast<cuuint64_t>(s.cin),
                              static_cast<cuuint64_t>(s.w),
                              static_cast<cuuint64_t>(s.h),
                              static_cast<cuuint64_t>(s.nimg)};
  const cuuint64_t xstride[3] = {
      static_cast<cuuint64_t>(s.cin),
      static_cast<cuuint64_t>(s.w) * s.cin,
      static_cast<cuuint64_t>(s.h) * s.w * s.cin};
  const cuuint32_t xbox[4] = {BK, static_cast<cuuint32_t>(s.bw),
                              static_cast<cuuint32_t>(s.bh),
                              static_cast<cuuint32_t>(s.bn)};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (enc(map_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), xdim,
          xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cuuint64_t wdim[2] = {static_cast<cuuint64_t>(9) * s.cin,
                              static_cast<cuuint64_t>(s.cout)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(9) * s.cin};
  const cuuint32_t wbox[2] = {BK, BN};
  if (enc(map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), wdim,
          wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

inline int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

template <int BM, int BN, int BK, bool F32>
cudaError_t launch(const void* x, const void* w, const float* scale, void* out,
                   int nimg, int h, int w_, int cin, int cout,
                   cudaStream_t stream) {
  using C = Cfg<BM, BN, BK, F32>;
  static bool attr_set = false;
  if (!attr_set) {
    // above 48 KB, dynamic shared memory needs the limit raised once
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_wgmma_kernel<BM, BN, BK, F32>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  Shape s;
  s.nimg = nimg;
  s.h = h;
  s.w = w_;
  s.cin = cin;
  s.cout = cout;
  // the output tile box: whole rows of up to BM pixels, and whole images
  // where the box holds every row of its image
  s.bw = w_ < BM ? w_ : BM;
  s.bh = h < BM / s.bw ? h : BM / s.bw;
  s.bn = 1;
  if (s.bh == h) {
    const int per = BM / (s.bw * s.bh);
    s.bn = nimg < per ? nimg : per;
  }
  s.tiles_x = (w_ + s.bw - 1) / s.bw;
  s.tiles_y = (h + s.bh - 1) / s.bh;
  s.tiles_m = s.tiles_x * s.tiles_y * ((nimg + s.bn - 1) / s.bn);
  s.tiles_n = cout / BN;
  s.k_tiles = 9 * cin / BK;
  s.a_bytes = BK * s.bw * s.bh * s.bn;
  CUtensorMap map_x, map_w;
  const cudaError_t e = make_maps<BN, BK>(x, w, s, &map_x, &map_w);
  if (e != cudaSuccess) return e;
  const int total = s.tiles_m * s.tiles_n;
  const int grid = total < num_sms() ? total : num_sms();
  conv3x3_wgmma_kernel<BM, BN, BK, F32><<<grid, kThreads, C::kSmem, stream>>>(
      map_x, map_w, s, scale, out);
  return cudaGetLastError();
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
