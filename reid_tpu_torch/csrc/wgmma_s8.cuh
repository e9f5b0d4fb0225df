// The Hopper int8 convolution mainloop shared by conv3x3_s8 (qconv.cu),
// the fused SE block (qblock.cu) and the DMA-im2col form of the
// convolution (qconv_variants.cu, whose ncat form builds its own
// ping-pong kernel from the pieces here): a 3x3 stride-1 SAME or a 1x1
// convolution, NHWC, as one implicit GEMM with M = B*H*W output pixels,
// N = Cout and K = taps*Cin, s8 x s8 -> s32. What happens to the s32 tile
// is the epilogue's business, a template parameter of the kernel.
//
//   * Math: wgmma.mma_async m64nNk32 s8 x s8 -> s32. A block has two
//     consumer warpgroups and one producer warpgroup; setmaxnreg gives the
//     consumers 232 registers and the producer 40. A tile is 128 pixels x
//     256 channels (each consumer 64 rows, one m64n256 a k32 step)
//     or 256 x 128 (each consumer 128 rows, two m64n128): 128 s32
//     accumulators a consumer thread either way, in registers. (wgmma_n144
//     serves the ncat form's nine taps of 16 channels.)
//   * Operands by TMA into a ring of 3-6 stages (as many as fit beside the
//     epilogue's shared memory) gated by mbarriers, started by one producer
//     thread. A K step is one tap and BK input channels: 128 in the 128-byte
//     swizzle or 64 in the 64-byte swizzle; the wgmma descriptors name the
//     same swizzle.
//   * B, the packed weight (Cout, taps*Cin) K-major: a 2-D tiled TMA box of
//     BK bytes x BN rows.
//   * A, the implicit im2col, in one of two forms.
//     - A 4-D tiled TMA box over the NHWC activation, BK channels x bw x bh
//       x bn pixels, at the output tile's origin shifted by the tap's
//       (dx, dy) (none for a 1x1). Coordinates outside the tensor are
//       zero-filled by the hardware, which is exactly the SAME halo, and
//       the box never wraps from one image row or image into the next. So
//       an output tile is a box of whole pixels: bw = min(W, BM) wide, bh
//       rows of an image and, when it holds every row of an image, bn
//       whole images; it uses bw*bh*bn <= BM of its rows. (The ncat
//       form's box also holds `halo` = 1 image row above and below its
//       output rows, and advances step_y = bh - 2*halo rows.)
//     - An im2col TMA box (`im2col` = 1): BK channels of BM consecutive
//       output pixels in flat NHW order, each read at its tap's offset,
//       out-of-image taps zero-filled; a tile crosses image rows and
//       images freely.
//   * Persistent grid: one block per SM walks the output tiles, so the
//     producer loads the next tile's stages while the consumers run the
//     epilogue of the last.
//   * TMA descriptors are made on the host with cuTensorMapEncodeTiled or
//     cuTensorMapEncodeIm2col, reached through cudaGetDriverEntryPoint (no
//     -lcuda), and passed as __grid_constant__ kernel parameters.
//
// The epilogue type Epi provides
//   struct Params;                                   (a kernel parameter)
//   template <int BM, int BN> __host__ __device__ static constexpr int
//       bytes();                         (its shared memory, a multiple of 16)
//   template <int BM, int BN> static __device__ void tile(const Params&,
//       const Shape&, const Tile&, int (&acc)[BM / 128][BN / 2],
//       uint8_t* smem, int tid);
// `tile` runs on the 256 consumer threads (tid 0..255) once the tile's
// accumulators are complete. Thread tid of warp w = tid / 32, lane l, holds
// in acc[mt][4 * j + {0, 1, 2, 3}] the tile rows row0 + g, row0 + g,
// row0 + g + 8, row0 + g + 8 and the columns 8j + 2t, +1, +0, +1, where
// row0 = ((w / 4) * MT + mt) * 64 + (w % 4) * 16, g = l / 4 and t = l % 4.
// `out_row` maps a tile row to its output pixel.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace reid {
namespace wg {

constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreads = 384;     // and one producer warpgroup
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take
constexpr int kMaxStages = 6;

// A tile of BM output pixels x BN output channels, K steps of BK bytes
// (one tap, BK channels), and EPI bytes of shared memory for the epilogue.
template <int BM, int BN, int BK, int EPI>
struct Cfg {
  static constexpr int kMT = BM / 128;
  static constexpr int kABytes = BM * BK;
  static constexpr int kBBytes = BN * BK;
  // as many stages as fit beside the epilogue's memory, at most kMaxStages
  static constexpr int kFit =
      (kSmemMax - 1024 - EPI - 16 * kMaxStages) / (kABytes + kBBytes);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kAOff = 0;
  static constexpr int kBOff = kAOff + kStages * kABytes;
  static constexpr int kEpiOff = kBOff + kStages * kBBytes;
  static constexpr int kBarOff = kEpiOff + EPI;
  static constexpr int kSmem = kBarOff + 16 * kStages + 1024;  // + align
  static_assert(EPI % 16 == 0, "epilogue memory keeps the barriers aligned");
  static_assert(kStages >= 3, "the ring needs three stages");
  static_assert(kSmem <= kSmemMax, "shared memory");
};

// The shape of one call and its tiling.
struct Shape {
  int nimg, h, w, cin, cout;      // cout: the GEMM's N
  int taps;                       // 9: 3x3 SAME; 1: 1x1
  int bw, bh, bn;                 // A box: pixels along W, H, B
  int halo;                       // box rows above (and below) the output
  int step_y;                     // output rows a box covers: bh - 2*halo
  int im2col;                     // 1: A is an im2col box of flat pixels
  int m_total;                    // B*H*W
  int tiles_x, tiles_y, tiles_m;  // boxes along W, H (and B), all of them
  int tiles_n;                    // N / BN
  int k_tiles;                    // taps * Cin / BK
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
  r.y0 = (mt % s.tiles_y) * s.step_y;
  r.n0 = (mt / s.tiles_y) * s.bn;
  return r;
}

// The output pixel (its flat NHW row) of tile row r, or -1 where the row
// lies outside the box or the tensor. An im2col tile's row r is the pixel
// x0 + r; a box's is (x0 + r % bw, y0 + (r / bw) % bh, n0 + r / (bw * bh)).
__device__ __forceinline__ long long out_row(const Shape& s, const Tile& t,
                                             int r) {
  if (s.im2col) return t.x0 + r < s.m_total ? t.x0 + r : -1;
  const int x = t.x0 + r % s.bw;
  const int y = t.y0 + (r / s.bw) % s.bh;
  const int n = t.n0 + r / (s.bw * s.bh);
  if (r >= s.bw * s.bh * s.bn || x >= s.w || y >= s.h || n >= s.nimg)
    return -1;
  return (static_cast<long long>(n) * s.h + y) * s.w + x;
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

// The 256 consumer threads alone (named barrier 1; the producer warpgroup
// never waits on it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// An im2col box: the pixel walk starts at the window origin (c, w, h, n) of
// the tile's first output pixel and reads each pixel at (off_w, off_h)
// from its origin.
__device__ __forceinline__ void tma_load_im2col(uint32_t dst,
                                                const CUtensorMap* map,
                                                uint32_t bar, int c, int w,
                                                int h, int n, uint16_t off_w,
                                                uint16_t off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h),
      "r"(n), "h"(off_w), "h"(off_h)
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

__device__ __forceinline__ void wgmma_n144(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71}, %72, %73, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(int* d, uint64_t a, uint64_t b) {
  static_assert(BN == 128 || BN == 144 || BN == 256, "wgmma width");
  if constexpr (BN == 256) {
    wgmma_n256(d, a, b);
  } else if constexpr (BN == 144) {
    wgmma_n144(d, a, b);
  } else {
    wgmma_n128(d, a, b);
  }
}

// grid: min(tiles, SMs) persistent blocks of kThreads; dynamic shared
// memory Cfg::kSmem. Requires Cin % BK == 0, N % BN == 0, a 16-byte
// aligned x and maps for shape s (make_maps, or the caller's own).
template <int BM, int BN, int BK, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    conv_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w, const Shape s,
                const typename Epi::Params ep) {
  using C = Cfg<BM, BN, BK, Epi::template bytes<BM, BN>()>;
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
        int px = 0, py = 0, pn = 0;  // an im2col tile's first output pixel
        if (s.im2col) {
          px = tile.x0 % s.w;
          py = (tile.x0 / s.w) % s.h;
          pn = tile.x0 / (s.w * s.h);
        }
        for (int kt = 0; kt < s.k_tiles; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, s.a_bytes + C::kBBytes);
          const int k0 = kt * BK;
          const int tap = k0 / s.cin;
          const int dx = s.taps == 9 ? tap % 3 - 1 : 0;
          const int dy = s.taps == 9 ? tap / 3 - 1 : 0;
          if (s.im2col) {
            // the window origin is the pixel's up-left neighbour; the tap
            // reads at (dx + 1, dy + 1) from it
            tma_load_im2col(sa + stage * C::kABytes, &map_x, bar,
                            k0 - tap * s.cin, px - 1, py - 1, pn,
                            static_cast<uint16_t>(dx + 1),
                            static_cast<uint16_t>(dy + 1));
          } else {
            tma_load_4d(sa + stage * C::kABytes, &map_x, bar,
                        k0 - tap * s.cin, tile.x0 + dx, tile.y0 + dy,
                        tile.n0);
          }
          tma_load_2d(sb + stage * C::kBBytes, &map_w, bar, k0,
                      tile.nt * BN);
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
    const int lane = tid & 31;
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
      Epi::template tile<BM, BN>(ep, s, tile, acc, smem + C::kEpiOff, tid);
    }
  }
}

// out = acc * scale[c] in bf16 or f32 (conv3x3_s8 and the DMA-im2col
// form), staged a warp's 16 rows x 64 columns at a time and written as
// 16-byte row segments. The arithmetic is the plain version's: int to f32,
// one __fmul_rn by the scale, __float2bfloat16_rn.
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
      // row0 + l, -1 where there is none.
      const int row0 = (wg * MT + mt) * 64 + (warp & 3) * 16;
      const long long orow = lane < 16 ? out_row(s, tile, row0 + lane) : -1;
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A driver function from the libcuda that the runtime has loaded, so this
// library needs no link against it; null where there is none.
inline void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q) ==
          cudaSuccess &&
      q == cudaDriverEntryPointSuccess)
    return p;
  return nullptr;
}

// The host functions that keep a static are `static`: each kernel library
// is one translation unit, and the static of an inline function or
// template would be one object for the whole process (a GNU unique
// symbol), shared by every library that includes this header. A second
// library's launch would then skip raising its own kernel's shared memory
// limit.
static inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  return fn;
}

static inline EncodeIm2col encode_im2col() {
  static const EncodeIm2col fn = reinterpret_cast<EncodeIm2col>(
      driver_entry("cuTensorMapEncodeIm2col"));
  return fn;
}

template <int BK>
constexpr CUtensorMapSwizzle swizzle() {
  return BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
}

// The fields of a Shape that every tiling sets alike.
inline Shape base_shape(int nimg, int h, int w, int cin, int cout, int taps) {
  Shape s;
  s.nimg = nimg;
  s.h = h;
  s.w = w;
  s.cin = cin;
  s.cout = cout;
  s.taps = taps;
  s.halo = 0;
  s.im2col = 0;
  s.m_total = nimg * h * w;
  return s;
}

// The shape of a call and its output tile boxes: whole rows of up to BM
// pixels, and whole images, at most bn_max of them, where the box holds
// every row of its image.
template <int BM, int BN, int BK>
Shape make_shape(int nimg, int h, int w, int cin, int cout, int taps,
                 int bn_max) {
  Shape s = base_shape(nimg, h, w, cin, cout, taps);
  s.bw = w < BM ? w : BM;
  s.bh = h < BM / s.bw ? h : BM / s.bw;
  s.bn = 1;
  if (s.bh == h) {
    const int per = BM / (s.bw * s.bh);
    s.bn = nimg < per ? nimg : per;
    if (s.bn > bn_max) s.bn = bn_max;
  }
  s.step_y = s.bh;
  s.tiles_x = (w + s.bw - 1) / s.bw;
  s.tiles_y = (h + s.bh - 1) / s.bh;
  s.tiles_m = s.tiles_x * s.tiles_y * ((nimg + s.bn - 1) / s.bn);
  s.tiles_n = cout / BN;
  s.k_tiles = taps * cin / BK;
  s.a_bytes = BK * s.bw * s.bh * s.bn;
  return s;
}

// The two operand maps of a call.
struct Maps {
  CUtensorMap x, w;
};

// The activation as a 4-D map (C, W, H, B) read in boxes of
// (BK, bw, bh, bn), in the BK-byte swizzle, out-of-bounds zero-filled.
template <int BK>
cudaError_t make_x_map(const void* x, const Shape& s, CUtensorMap* map) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
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
  if (enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), xdim,
          xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle<BK>(),
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The activation map of make_x_map and the packed weight as a 2-D map
// (taps*Cin, Cout) read in boxes of (BK, BN), in the same swizzle.
template <int BN, int BK>
cudaError_t make_maps(const void* x, const void* w, const Shape& s,
                      Maps* maps) {
  const cudaError_t e = make_x_map<BK>(x, s, &maps->x);
  if (e != cudaSuccess) return e;
  const cuuint64_t wdim[2] = {static_cast<cuuint64_t>(s.taps) * s.cin,
                              static_cast<cuuint64_t>(s.cout)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(s.taps) * s.cin};
  const cuuint32_t wbox[2] = {BK, BN};
  const cuuint32_t ones[2] = {1, 1};
  if (encode_tiled()(&maps->w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                     const_cast<void*>(w), wdim, wstride, wbox, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle<BK>(),
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

static inline int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// One launch of the persistent grid on maps made for shape s.
template <int BM, int BN, int BK, class Epi>
static cudaError_t launch(const Maps& maps, const Shape& s,
                          const typename Epi::Params& ep,
                          cudaStream_t stream) {
  using C = Cfg<BM, BN, BK, Epi::template bytes<BM, BN>()>;
  static bool attr_set = false;
  if (!attr_set) {
    // above 48 KB, dynamic shared memory needs the limit raised once
    const cudaError_t e = cudaFuncSetAttribute(
        conv_kernel<BM, BN, BK, Epi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int total = s.tiles_m * s.tiles_n;
  const int grid = total < num_sms() ? total : num_sms();
  conv_kernel<BM, BN, BK, Epi><<<grid, kThreads, C::kSmem, stream>>>(
      maps.x, maps.w, s, ep);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace reid
