// Three more forms of the int8 3x3 stride-1 SAME convolution, each with the
// contract of conv3x3_s8 (qconv.cu): x (B, H, W, Cin) int8 NHWC, s8 x s8 ->
// s32, epilogue acc * scale[c] written as bf16 or f32. Integer sums are
// exact in any order and the scale is one __fmul_rn, so each equals
// conv3x3_s8 and its plain version bit for bit.
//
// What bounds all three on an H100 is K1's work: at block21 (B = 2048,
// 32x16, c128) 309 G int8 operations, 0.156 ms at 1,979 TOP/s, and about
// 0.42 GB of input, weights and bf16 output, 0.13 ms at 3.35 TB/s. Each
// form has to keep its own intermediate off device memory to get near it.
//
// conv3x3_s8_ncat replaces reid_tpu/ops/qconv.py:conv3x3_s8_ncat
// (_qconv_ncat_kernel): ONE s8 product of the activation rows against the
// weight concatenated along N over the nine taps (K = Cin), then the nine
// s32 column slices of the product P are shifted by the tap's row offset,
// masked and summed. P is 9*Cout s32 a pixel, 36x the int8 input at
// Cin = Cout (4.8 GB at block21): the TPU kernel keeps it in VMEM, and so
// does this one, in shared memory (ncat_kernel below). One launch, built
// from the pieces of wgmma_s8.cuh (TMA ring, producer thread, wgmma s8,
// persistent tile walk), with K = Cin and N tiles of 144: all nine taps of
// G = 16 output channels, read straight from the public (9*Cout, Cin)
// weight by a 4-D TMA map (Cin, G, Cout/G, 9). The A box is whole image
// rows plus the image row above and the one below its output rows (TMA
// zero-fills rows outside the image), so every P row an output pixel needs
// is in the tile; where a box holds whole images there is no halo. Each
// consumer warpgroup takes every other tile whole (128 x 144, two m64n144
// a k32 step): its products run while the other warpgroup sums that
// one's P over the taps, along x in registers (shuffles) and along y
// through shared memory (tap_sums). What bounds it: the operations
// (0.156 ms at block21, plus a third for the recomputed halo rows at
// 32x16, none at 16x8 and 8x4) and, above them, the epilogue. P is 144
// s32 values a pixel against 16 outputs, and one warpgroup's epilogue is
// four warps, one per scheduler, whose shuffles, shared-memory round trip
// and stores run longer than the other warpgroup's products at 128
// channels.
//
// conv3x3_s8_dma replaces reid_tpu/ops/qconv.py:conv3x3_s8_dma
// (_qconv_dma_kernel): the nine shifted row windows are copied by a DMA
// engine into on-chip memory, masked by zero fill, and contracted in ONE
// product over K = 9*Cin. Here the DMA engine is TMA in its im2col mode:
// each K step is one tap and BK channels of BM consecutive output pixels
// in flat NHW order (a tile crosses image rows and images freely), loaded
// by one cp.async.bulk.tensor .im2col whose offsets are the tap's
// (dx + 1, dy + 1) from the window origin, out-of-image taps zero-filled
// by the hardware. One launch on the same mainloop and K1's scale
// epilogue; no im2col buffer in device memory. What bounds it: K1's
// operations and bytes; the rows of a flat tile are contiguous, so its
// stores are too.
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
// times, mostly from L2). The operation bound is K1's; it runs on mma.sync,
// a fraction of wgmma's rate.
#include "wgmma_s8.cuh"

namespace reid {

// ---- conv3x3_s8_ncat --------------------------------------------------------
namespace ncat {

using wg::Shape;
using wg::Tile;

constexpr int kBM = 128;
constexpr int kG = 16;        // output channels of an N tile
constexpr int kN = 9 * kG;    // its nine taps: the wgmma width 144
// The epilogue sums a tile's P over the taps in two steps. Along x, in
// registers: the rows r - 1 and r + 1 of row r lie with the neighbouring
// lanes of its warp (shuffles), or, for a warp's first and last rows, with
// the neighbouring warp (the edge rows, traded through shared memory).
// That gives Q_dy[r] = sum over dx of mask_dx * P[r + dx, tap (dy, dx)] for
// the three dy. Along y, through shared memory: out[r] = Q_0[r] +
// mask * Q_-1[r - W] + mask * Q_+1[r + W], so only Q_-1 and Q_+1 are
// staged. Each warpgroup has its own buffers: Q_-1 and Q_+1 (128 rows x
// 16 channels, in 16-byte chunks: chunk q holds channels 2q, 2q + 1,
// 8 + 2q and 9 + 2q, one thread's four values; the stores and reads of a
// quarter-warp fill 128 consecutive bytes) and the edge rows (8 blocks of
// 16 rows x first / last row x 4 lanes x 3 taps x 4 values).
constexpr int kQInts = 2 * kBM * kG;
constexpr int kEdgeInts = 8 * 2 * 4 * 12;
constexpr int kEpiBytes = (kQInts + kEdgeInts) * 4;
// the ring's shape: 128-row A boxes, 144-row B boxes, and beside them the
// two warpgroups' epilogue buffers and their two order barriers
template <int BK>
using Cfg = wg::Cfg<kBM, kN, BK, 2 * kEpiBytes + 16>;

struct Params {
  const float* scale;
  void* out;
  int cout;
};

// The tile-invariant part of a box row r: its pixel's x, its image row
// yb in the box and image nb of the box, and whether it is one of the
// box's output rows. A consumer thread keeps those of its four rows.
struct RowGeom {
  int x, yb, nb;
  bool out;
};

__device__ __forceinline__ RowGeom row_geom(const Shape& s, int r) {
  RowGeom gm;
  const int rw = r / s.bw;  // bw = W: x is the pixel's own
  gm.x = r - rw * s.bw;
  gm.nb = rw / s.bh;
  gm.yb = rw - gm.nb * s.bh;
  gm.out = r < s.bw * s.bh * s.bn && gm.yb >= s.halo &&
           gm.yb < s.bh - s.halo;
  return gm;
}

// A box row in tile t: its flat output row o (-1: not an output row) and
// whether its neighbours left, right, up and down lie in the image.
struct Row {
  long long o;
  bool left, right, up, down;
};

__device__ __forceinline__ Row row_of(const Shape& s, const Tile& t,
                                      const RowGeom& gm) {
  const int y = t.y0 - s.halo + gm.yb;
  const int n = t.n0 + gm.nb;
  Row row;
  row.left = gm.x > 0;
  row.right = gm.x < s.w - 1;
  row.up = y > 0;
  row.down = y < s.h - 1;
  row.o = gm.out && y < s.h && n < s.nimg
              ? (static_cast<long long>(n) * s.h + y) * s.w + gm.x
              : -1;
  return row;
}

// Of m64 block mt, half hf (row g or g + 8) and tap t, the accumulator of
// the thread's value e: channels 2*tig, 2*tig + 1, 8 + 2*tig, 9 + 2*tig.
__device__ __forceinline__ int acc_index(int t, int hf, int e) {
  return 8 * t + 4 * (e >> 1) + 2 * hf + (e & 1);
}

// out[e], out[e + 1] = a0, a1 times sc, the plain version's arithmetic
template <bool F32>
__device__ __forceinline__ void store2(void* out, long long e, int a0,
                                       int a1, float2 sc) {
  const float v0 = __fmul_rn(static_cast<float>(a0), sc.x);
  const float v1 = __fmul_rn(static_cast<float>(a1), sc.y);
  if constexpr (F32) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + e) =
        make_float2(v0, v1);
  } else {
    __nv_bfloat162 r;
    r.x = __float2bfloat16_rn(v0);
    r.y = __float2bfloat16_rn(v1);
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + e) =
        r;
  }
}

// The 128 threads of consumer warpgroup wg alone (named barrier 2 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// The tap sums of one tile by the 128 threads of a warpgroup, from its
// accumulators (thread (g, tig) of warp ww: rows mt*64 + 16*ww + g and + 8
// of the box), into out at the tile's 16 channels.
template <bool F32>
__device__ __forceinline__ void tap_sums(const Params& p, const Shape& s,
                                         const Tile& t,
                                         const int (&acc)[2][kN / 2],
                                         const RowGeom (&geo)[2][2], int* buf,
                                         int wgi, int ltid) {
  const int ww = ltid >> 5;
  const int lane = ltid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  int4* q4 = reinterpret_cast<int4*>(buf);           // [2][kBM][4]
  int4* edge = reinterpret_cast<int4*>(buf + kQInts);  // [8][2][4][3]
  // a warp's first row gives its dx = +1 taps to the warp above, its last
  // row its dx = -1 taps to the warp below (block row br = 4*mt + ww)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int br = 4 * mt + ww;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int* a = acc[mt];
      if (g == 0)
        edge[((br * 2 + 0) * 4 + tig) * 3 + k] = make_int4(
            a[acc_index(3 * k + 2, 0, 0)], a[acc_index(3 * k + 2, 0, 1)],
            a[acc_index(3 * k + 2, 0, 2)], a[acc_index(3 * k + 2, 0, 3)]);
      if (g == 7)
        edge[((br * 2 + 1) * 4 + tig) * 3 + k] = make_int4(
            a[acc_index(3 * k, 1, 0)], a[acc_index(3 * k, 1, 1)],
            a[acc_index(3 * k, 1, 2)], a[acc_index(3 * k, 1, 3)]);
    }
  }
  warpgroup_sync(wgi);
  Row rows[2][2];
  int q0[2][2][4];  // Q_0 of each row, kept in registers
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int br = 4 * mt + ww;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      rows[mt][hf] = row_of(s, t, geo[mt][hf]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {  // dy = k - 1
      // the edge rows this thread's first and last rows may need
      int4 er = make_int4(0, 0, 0, 0), el = er;
      if (g == 7 && br < 7) er = edge[(((br + 1) * 2 + 0) * 4 + tig) * 3 + k];
      if (g == 0 && br > 0) el = edge[(((br - 1) * 2 + 1) * 4 + tig) * 3 + k];
      const int erv[4] = {er.x, er.y, er.z, er.w};
      const int elv[4] = {el.x, el.y, el.z, el.w};
      int qk[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int* a = acc[mt];
        // dx = +1: row r + 1; dx = -1: row r - 1 (lane -/+ 4, wrapping
        // from row 7 to row 8 of the warp)
        const int ra = __shfl_sync(0xffffffffu, a[acc_index(3 * k + 2, 0, e)],
                                   (lane + 4) & 31);
        const int rb = __shfl_sync(0xffffffffu, a[acc_index(3 * k + 2, 1, e)],
                                   (lane + 4) & 31);
        const int la = __shfl_sync(0xffffffffu, a[acc_index(3 * k, 0, e)],
                                   (lane + 28) & 31);
        const int lb = __shfl_sync(0xffffffffu, a[acc_index(3 * k, 1, e)],
                                   (lane + 28) & 31);
        const int right[2] = {g < 7 ? ra : rb, g < 7 ? rb : erv[e]};
        const int left[2] = {g > 0 ? la : elv[e], g > 0 ? lb : la};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          qk[hf][e] = a[acc_index(3 * k + 1, hf, e)] +
                      (rows[mt][hf].right ? right[hf] : 0) +
                      (rows[mt][hf].left ? left[hf] : 0);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = mt * 64 + ww * 16 + g + 8 * hf;
        if (k == 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) q0[mt][hf][e] = qk[hf][e];
        } else {
          q4[((k >> 1) * kBM + r) * 4 + tig] =
              make_int4(qk[hf][0], qk[hf][1], qk[hf][2], qk[hf][3]);
        }
      }
    }
  }
  warpgroup_sync(wgi);
  const int c = t.nt * kG + 2 * tig;
  const float2 sc0 = __ldg(reinterpret_cast<const float2*>(p.scale + c));
  const float2 sc1 = __ldg(reinterpret_cast<const float2*>(p.scale + c + 8));
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const Row& row = rows[mt][hf];
      const int r = mt * 64 + ww * 16 + g + 8 * hf;
      // branch-free: a neighbour outside the image reads the row itself
      // and adds nothing
      int4 up = q4[(0 * kBM + (row.up ? r - s.bw : r)) * 4 + tig];
      int4 dn = q4[(1 * kBM + (row.down ? r + s.bw : r)) * 4 + tig];
      const int mu = row.up ? -1 : 0, md = row.down ? -1 : 0;
      const int o0 = q0[mt][hf][0] + (up.x & mu) + (dn.x & md);
      const int o1 = q0[mt][hf][1] + (up.y & mu) + (dn.y & md);
      const int o2 = q0[mt][hf][2] + (up.z & mu) + (dn.z & md);
      const int o3 = q0[mt][hf][3] + (up.w & mu) + (dn.w & md);
      if (row.o >= 0) {
        store2<F32>(p.out, row.o * p.cout + c, o0, o1, sc0);
        store2<F32>(p.out, row.o * p.cout + c + 8, o2, o3, sc1);
      }
    }
  warpgroup_sync(wgi);  // the buffers are free for the next tile
}

// grid: min(tiles, SMs) persistent blocks of wg::kThreads; dynamic shared
// memory Cfg<BK>::kSmem. The producer thread loads the block's tiles in
// order into the ring; the two consumer warpgroups take them in turn
// (ping-pong), each a whole 128 x 144 tile (two m64n144 a k32 step). Their
// products run in tile order, each warpgroup's after the other's last (an
// mbarrier each), so the ring's stages are consumed in the order they are
// filled; their epilogues (tap_sums) run beside the other's products, each
// in its own buffers.
template <int BK, bool F32>
__global__ void __launch_bounds__(wg::kThreads, 1)
    ncat_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w, const Shape s,
                const Params p) {
  using C = Cfg<BK>;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms aligned
  const uint32_t sa = base + C::kAOff;
  const uint32_t sb = base + C::kBOff;
  const uint32_t full = base + C::kBarOff;    // kStages barriers
  const uint32_t empty = full + 8 * kStages;  // kStages barriers
  // mma_done + 8w completes when warpgroup w's products of a tile are done
  const uint32_t mma_done = base + C::kEpiOff + 2 * kEpiBytes;

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(full + 8 * i, 1);   // the producer's expect_tx arrival
      wg::mbar_init(empty + 8 * i, 4);  // the consuming warpgroup's warps
    }
    wg::mbar_init(mma_done, 4);
    wg::mbar_init(mma_done + 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int total = s.tiles_m * s.tiles_n;

  if (tid >= wg::kConsumers) {
    // Producer warpgroup: one thread loads the A box (its halo rows above
    // and below) and all nine taps of the tile's channel group.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == wg::kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Tile tile = wg::decode(s, t);
        for (int kt = 0; kt < s.k_tiles; ++kt) {
          wg::mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          wg::mbar_expect_tx(bar, s.a_bytes + C::kBBytes);
          wg::tma_load_4d(sa + stage * C::kABytes, &map_x, bar, kt * BK, 0,
                          tile.y0 - s.halo, tile.n0);
          wg::tma_load_4d(sb + stage * C::kBBytes, &map_w, bar, kt * BK, 0,
                          tile.nt, 0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wgi = tid >> 7;    // this warpgroup takes the block's tiles
  const int ltid = tid & 127;  // wgi, wgi + 2, ...
  const int lane = tid & 31;
  int* buf = reinterpret_cast<int*>(smem_raw + (base - raw) + C::kEpiOff +
                                    wgi * kEpiBytes);
  RowGeom geo[2][2];  // this thread's four box rows
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      geo[mt][hf] = row_geom(s, mt * 64 + (ltid >> 5) * 16 + ((lane >> 2) +
                                                              8 * hf));
  int acc[2][kN / 2];
  for (int i = wgi, t = blockIdx.x + wgi * gridDim.x; t < total;
       i += 2, t += 2 * gridDim.x) {
    const Tile tile = wg::decode(s, t);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < kN / 2; ++j) acc[mt][j] = 0;
    wg::fence_acc<kN>(&acc[0][0]);
    // the products of tile i - 1 (the other warpgroup's) are done
    if (i > 0) wg::mbar_wait(mma_done + 8 * (1 - wgi), ((i - 1) >> 1) & 1);
    int prev = 0;
    for (int kt = 0; kt < s.k_tiles; ++kt) {
      // the block's tiles fill the ring in order: tile i's step kt is the
      // ring's (i * k_tiles + kt)-th
      const int q = i * s.k_tiles + kt;
      const int stage = q % kStages;
      wg::mbar_wait(full + 8 * stage, (q / kStages) & 1);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint32_t a = sa + stage * C::kABytes;
      const uint32_t b = sb + stage * C::kBBytes;
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          wg::wgmma<kN>(acc[mt], wg::desc_sw<BK>(a + mt * 64 * BK + ks * 32),
                        wg::desc_sw<BK>(b + ks * 32));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the group of the previous stage has finished reading it
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kt > 0 && lane == 0) wg::mbar_arrive(empty + 8 * prev);
      prev = stage;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg::fence_acc<kN>(&acc[0][0]);
    if (lane == 0) {
      wg::mbar_arrive(empty + 8 * prev);
      wg::mbar_arrive(mma_done + 8 * wgi);
    }
    tap_sums<F32>(p, s, tile, acc, geo, buf, wgi, ltid);
  }
}

// The A box (BK channels x W x bh x bn, whole image rows, `halo` rows of
// it above and below the output rows) as the caller's plan gives it, and
// the weight as a 4-D map (Cin, G, Cout/G, 9) of the (9*Cout, Cin) rows
// t*Cout + o, read in boxes (BK, G, 1, 9): an N tile's row t*G + j is tap
// t of output channel group*G + j.
template <int BK, bool F32>
static cudaError_t launch(const void* x, const void* wn, const float* scale,
                          void* out, int nimg, int h, int w, int cin,
                          int cout, int bh, int bn, int halo,
                          cudaStream_t stream) {
  using C = Cfg<BK>;
  Shape s = wg::base_shape(nimg, h, w, cin, 9 * cout, 1);
  s.bw = w;
  s.bh = bh;
  s.bn = bn;
  s.halo = halo;
  s.step_y = bh - 2 * halo;
  s.tiles_x = 1;
  s.tiles_y = (h + s.step_y - 1) / s.step_y;
  s.tiles_m = s.tiles_y * ((nimg + bn - 1) / bn);
  s.tiles_n = cout / kG;
  s.k_tiles = cin / BK;
  s.a_bytes = BK * w * bh * bn;
  wg::Maps maps;
  cudaError_t e = wg::make_x_map<BK>(x, s, &maps.x);
  if (e != cudaSuccess) return e;
  const cuuint64_t dim[4] = {static_cast<cuuint64_t>(cin), kG,
                             static_cast<cuuint64_t>(cout / kG), 9};
  const cuuint64_t stride[3] = {static_cast<cuuint64_t>(cin),
                                static_cast<cuuint64_t>(kG) * cin,
                                static_cast<cuuint64_t>(cout) * cin};
  const cuuint32_t box[4] = {BK, kG, 1, 9};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (wg::encode_tiled()(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                         const_cast<void*>(wn), dim, stride, box, ones,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, wg::swizzle<BK>(),
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // above 48 KB, dynamic shared memory needs the limit raised, once per
  // instance (`static`: see wgmma_s8.cuh's encode_tiled)
  static bool attr_set = false;
  if (!attr_set) {
    e = cudaFuncSetAttribute(ncat_kernel<BK, F32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int total = s.tiles_m * s.tiles_n;
  const int grid = total < wg::num_sms() ? total : wg::num_sms();
  ncat_kernel<BK, F32><<<grid, wg::kThreads, C::kSmem, stream>>>(
      maps.x, maps.w, s, {scale, out, cout});
  return cudaGetLastError();
}

}  // namespace ncat

// ---- conv3x3_s8_dma ---------------------------------------------------------
namespace dma {

// The CUDA driver's version, read once.
int driver_version() {
  static int version = -1;
  if (version < 0 && cudaDriverGetVersion(&version) != cudaSuccess)
    version = 0;
  return version;
}

// BM flat output pixels x BN channels a tile, K steps of one tap and BK
// channels; the im2col map walks the window origins (x - 1, y - 1) of the
// pixels over the box [-1, W - 2] x [-1, H - 2] of each image and reads
// each at the tap's offset from its origin.
template <int BM, int BN, int BK, bool F32>
cudaError_t launch(const void* x, const void* wt, const float* scale,
                   void* out, int nimg, int h, int w, int cin, int cout,
                   cudaStream_t stream) {
  wg::Shape s = wg::base_shape(nimg, h, w, cin, cout, 9);
  s.im2col = 1;
  s.bw = BM;  // decode: tile t's first pixel x0 = (t / tiles_n) * BM
  s.bh = 1;
  s.bn = 1;
  s.step_y = 1;
  s.tiles_x = (s.m_total + BM - 1) / BM;
  s.tiles_y = 1;
  s.tiles_m = s.tiles_x;
  s.tiles_n = cout / BN;
  s.k_tiles = 9 * cin / BK;
  s.a_bytes = BK * BM;
  wg::Maps maps;
  wg::EncodeIm2col enc = wg::encode_im2col();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dim[4] = {static_cast<cuuint64_t>(cin),
                             static_cast<cuuint64_t>(w),
                             static_cast<cuuint64_t>(h),
                             static_cast<cuuint64_t>(nimg)};
  const cuuint64_t stride[3] = {static_cast<cuuint64_t>(cin),
                                static_cast<cuuint64_t>(w) * cin,
                                static_cast<cuuint64_t>(h) * w * cin};
  // a 3x3 window padded by 1: origins from -1 to W - 2 (H - 2)
  const int lower[2] = {-1, -1};
  const int upper[2] = {-1, -1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (enc(&maps.x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x),
          dim, stride, lower, upper, BK, BM, ones,
          CU_TENSOR_MAP_INTERLEAVE_NONE, wg::swizzle<BK>(),
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // As CUTLASS's make_im2col_tma_copy_desc does: with drivers up to 13.1,
  // an im2col map of a tensor under 128 KiB needs bit 21 of its second
  // word cleared.
  if (driver_version() <= 13010 &&
      static_cast<long long>(s.m_total) * cin < 131072)
    reinterpret_cast<uint64_t*>(&maps.x)[1] &= ~(1ull << 21);
  const cuuint64_t wdim[2] = {static_cast<cuuint64_t>(9) * cin,
                              static_cast<cuuint64_t>(cout)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(9) * cin};
  const cuuint32_t wbox[2] = {BK, BN};
  if (wg::encode_tiled()(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                         const_cast<void*>(wt), wdim, wstride, wbox, ones,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, wg::swizzle<BK>(),
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return wg::launch<BM, BN, BK, wg::ScaleEpi<F32>>(maps, s, {scale, out},
                                                   stream);
}

// K1's tiles: 128 x 256 where Cout allows, else 256 x 128 (`bm`, the
// caller's plan); K steps of 128 channels where Cin allows, else 64.
template <bool F32>
cudaError_t dispatch(const void* x, const void* wt, const float* sc,
                     void* out, int nimg, int h, int w, int cin, int cout,
                     int bm, cudaStream_t st) {
  if (bm == 128) {
    if (cout % 256 != 0) return cudaErrorInvalidValue;
    return cin % 128 == 0
               ? launch<128, 256, 128, F32>(x, wt, sc, out, nimg, h, w, cin,
                                            cout, st)
               : launch<128, 256, 64, F32>(x, wt, sc, out, nimg, h, w, cin,
                                           cout, st);
  }
  if (bm != 256) return cudaErrorInvalidValue;
  return cin % 128 == 0
             ? launch<256, 128, 128, F32>(x, wt, sc, out, nimg, h, w, cin,
                                          cout, st)
             : launch<256, 128, 64, F32>(x, wt, sc, out, nimg, h, w, cin,
                                         cout, st);
}

}  // namespace dma

// ---- conv3x3_s8_bitshift's mma.sync pieces ---------------------------------
namespace k4 {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
// Shared-memory row stride in bytes: 16-byte aligned for cp.async, and 20
// words apart so the eight row groups of a fragment load hit distinct banks.
constexpr int kSRow = kBK + 16;
constexpr int kThreads = 256;

enum Epilogue : int {
  kScaleBf16 = 0,  // out bf16 = acc * a[c]
  kScaleF32 = 1,   // out f32  = acc * a[c]
};

struct ConvArgs {
  const int8_t* x;  // (B, H, W, Cin) int8, NHWC
  const int8_t* wt; // (Cout, 9*Cin) int8, K ordered (tap, cin)
  const float* a;   // (Cout,) scale
  void* out;        // (B, H, W, Cout)
  int nimg, h, w, cin, cout;
};

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

// out[row, col .. col + 1] = acc * scale, the plain version's arithmetic
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
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) +
                                       o) = r;
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
        make_float2(v0, v1);
  }
}

__device__ __forceinline__ bool tap_ok(int y, int x, int t, int h, int w) {
  const int yy = y + t / 3 - 1;
  const int xx = x + t % 3 - 1;
  return yy >= 0 && yy < h && xx >= 0 && xx < w;
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
                   int nimg, int h, int w_, int cin, int cout) {
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
  return p;
}

}  // namespace k4
}  // namespace reid

extern "C" int reid_conv3x3_s8_bitshift(const void* x, const void* w,
                                        const void* scale, void* out, int nimg,
                                        int h, int w_, int cin, int cout,
                                        int out_f32, void* stream) {
  using namespace reid::k4;
  const ConvArgs p = conv_args(x, w, scale, out, nimg, h, w_, cin, cout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_f32 ? launch_bitshift<kScaleF32>(p, s)
                                  : launch_bitshift<kScaleBf16>(p, s));
}

// wn (9*Cout, Cin) tap-major along N, as pack_ncat_weight gives it; the A
// box of the caller's plan: bh image rows (halo of them above and below
// the output rows) of whole width, bn images. One launch.
extern "C" int reid_conv3x3_s8_ncat(const void* x, const void* wn,
                                    const void* scale, void* out, int nimg,
                                    int h, int w_, int cin, int cout, int bh,
                                    int bn, int halo, int out_f32,
                                    void* stream) {
  using namespace reid::ncat;
  if (nimg == 0) return 0;
  if (cin % 64 != 0 || cout % 128 != 0 || nimg < 0 || h <= 0 || w_ <= 0 ||
      (halo != 0 && halo != 1) || bh - 2 * halo < 1 || bn < 1 ||
      w_ * bh * bn > kBM || (halo == 0 && bh != h) || (bn > 1 && bh != h))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (cin % 128 == 0)
    e = out_f32 ? launch<128, true>(x, wn, sc, out, nimg, h, w_, cin, cout,
                                    bh, bn, halo, st)
                : launch<128, false>(x, wn, sc, out, nimg, h, w_, cin, cout,
                                     bh, bn, halo, st);
  else
    e = out_f32 ? launch<64, true>(x, wn, sc, out, nimg, h, w_, cin, cout, bh,
                                   bn, halo, st)
                : launch<64, false>(x, wn, sc, out, nimg, h, w_, cin, cout,
                                    bh, bn, halo, st);
  return static_cast<int>(e);
}

// wt (Cout, 9*Cin) as for conv3x3_s8; tiles of bm flat output pixels
// (128 where Cout % 256 == 0, else 256). One launch.
extern "C" int reid_conv3x3_s8_dma(const void* x, const void* wt,
                                   const void* scale, void* out, int nimg,
                                   int h, int w_, int cin, int cout, int bm,
                                   int out_f32, void* stream) {
  using namespace reid::dma;
  if (nimg == 0) return 0;
  if (cin % 64 != 0 || cout % 128 != 0 || nimg < 0 || h <= 0 || w_ <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      out_f32 ? dispatch<true>(x, wt, sc, out, nimg, h, w_, cin, cout, bm, st)
              : dispatch<false>(x, wt, sc, out, nimg, h, w_, cin, cout, bm,
                                st));
}
