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
// rows) and contracts it in one dot. Here (bitshift_kernel) that copy is
// a slab in shared memory: per tile of BM flat output pixels and chunk of
// BK input channels, the tile's rows and W + 1 halo rows on each side,
// loaded once by one or two 2-D TMA boxes (rows outside the tensor zero-
// filled) and double buffered across chunks. All nine taps read their A
// fragments from it by ldmatrix at the tap's row offset dy * W + dx,
// through TMA's swizzle, and zero in registers the rows whose tap leaves
// the image; wgmma takes A from those registers and B, the tap's weight
// tile, from a TMA ring of its own. What bounds it: K1's operations. Each
// activation byte is read from device memory once per tile and chunk
// (K1's per-tap boxes read it up to nine times, mostly from L2), plus the
// slab's 2 (W + 1) halo rows (13% of a 256-row tile at W = 16), and its
// shared-memory traffic is K1's: a fragment by ldmatrix moves the bytes
// that wgmma moves reading A by descriptor.
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

// ---- conv3x3_s8_bitshift ----------------------------------------------------
namespace bitshift {

using wg::Shape;
using wg::Tile;

// A call's shared memory, from the 1024-aligned base: two slabs (each
// `boxes` TMA boxes of `box_rows` flat rows x BK channels), the B ring of
// `stages` (BN x BK) tiles, the epilogue's staging (f32's size for both
// outputs, so the layout does not depend on the output type) and the
// barriers. ops/qconv.py:bitshift_plan makes the same choices.
constexpr int kEpiBytes = wg::ScaleEpi<true>::bytes<128, 128>();

struct Plan {
  int halo;        // W + 1: slab rows above the tile's first pixel
  int box_rows;    // rows of one box: a multiple of 8, at most 256
  int boxes;       // boxes a slab: 1 or 2
  int stages;      // B tiles in the ring
  int slab_bytes;  // one slab buffer, a multiple of 1024
  int b_off, epi_off, bar_off, smem;
};

static Plan make_plan(int w, int bn, int bk, int box_rows, int boxes,
                      int stages) {
  Plan p;
  p.halo = w + 1;
  p.box_rows = box_rows;
  p.boxes = boxes;
  p.stages = stages;
  p.slab_bytes = (boxes * box_rows * bk + 1023) / 1024 * 1024;
  p.b_off = 2 * p.slab_bytes;
  p.epi_off = p.b_off + stages * bn * bk;
  p.bar_off = p.epi_off + kEpiBytes;
  p.smem = p.bar_off + 8 * (2 * stages + 4) + 1024;  // + align
  return p;
}

// Spin on the barrier's phase `parity` like wg::mbar_wait, but end the
// launch with an error (trap) after about two seconds: a fault in the two
// rings' bookkeeping then fails the call instead of hanging the card.
__device__ __forceinline__ void wait_bar(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (int i = 0;; ++i) {
    asm volatile(
        "{\n.reg .pred P;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (i == 0) t0 = now;
    if (now - t0 > 2000000000ull) __trap();
  }
}

// The s8 A fragment of 16 rows x 32 bytes from shared memory: lanes 8j to
// 8j + 7 give the row addresses of b16 matrix j (rows 0-7 / 8-15, bytes
// 0-15 / 16-31), and register j of lane l receives row l / 4 (+ 8), bytes
// 4 (l % 4) .. + 3 (+ 16) of it, the register-A layout of wgmma k32 s8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr)
      : "memory");
}

// wgmma with A from registers (four .b32 of s8 a thread) and B by
// descriptor. The registers must be written before a wgmma.fence that
// precedes this instruction, and not be written again until a
// wgmma.wait_group has retired it.
__device__ __forceinline__ void wgmma_rs_n128(int* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(int* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_rs(int* d, const uint32_t* a,
                                         uint64_t b) {
  static_assert(BN == 128 || BN == 256, "wgmma width");
  if constexpr (BN == 256) {
    wgmma_rs_n256(d, a, b);
  } else {
    wgmma_rs_n128(d, a, b);
  }
}

// The producer issues a pair's next slab at this tap of the pair's B
// loads (or earlier, with fewer stages): late enough that the consumers
// have released that buffer, early enough that it lands before their
// next pair starts.
constexpr int kSlabTap = 6;

// grid: min(tiles, SMs) persistent blocks of wg::kThreads; dynamic shared
// memory p.smem. A tile is BM flat output pixels (NHW order, crossing
// image rows and images) x BN channels, its K loop chunks of BK input
// channels outer and the nine taps inner. Per (tile, chunk) the producer
// thread loads one slab, the flat rows [m0 - (W + 1), m0 + BM + W + 1) of
// the chunk's channels, by 2-D TMA boxes (rows outside [0, M) zero-
// filled), into one of two slab buffers, and each tap's (BN x BK) weight
// tile into the B ring; the slabs and the ring have barriers and phases of
// their own. Consumer warpgroup wg takes the tile's rows wg * BM / 2 ..,
// in m64 blocks; for each tap and k32 step each warp reads its 16 rows'
// A fragment with one ldmatrix.x4 at slab row (W + 1) + dy * W + dx + i,
// zeroes the registers of rows whose tap leaves the image or the tensor
// and runs wgmma m64nBNk32 with A from registers. The fragments are double
// buffered: a step's ldmatrix runs while the step before is in the tensor
// cores, and wait_group 1 after each step retires the one whose registers
// the next step overwrites.
template <int BM, int BN, int BK, bool F32>
__global__ void __launch_bounds__(wg::kThreads, 1)
    bitshift_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w, const Shape s,
                    const Plan p,
                    const typename wg::ScaleEpi<F32>::Params ep) {
  constexpr int MT = BM / 128;
  constexpr int KS = BK / 32;
  constexpr int kBBytes = BN * BK;
  static_assert(KS % 2 == 0, "a tap's k32 steps alternate the A buffers");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms aligned
  const uint32_t sb = base + p.b_off;
  const uint32_t full = base + p.bar_off;            // p.stages barriers
  const uint32_t empty = full + 8 * p.stages;        // p.stages barriers
  const uint32_t slab_full = empty + 8 * p.stages;   // 2 barriers
  const uint32_t slab_empty = slab_full + 16;        // 2 barriers

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      wg::mbar_init(full + 8 * i, 1);   // the producer's expect_tx arrival
      wg::mbar_init(empty + 8 * i, 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      wg::mbar_init(slab_full + 8 * i, 1);
      wg::mbar_init(slab_empty + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int total = s.tiles_m * s.tiles_n;
  const int chunks = s.cin / BK;

  if (tid >= wg::kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == wg::kConsumers) {
      // The block's walk is a sequence of (tile, chunk) pairs; pair i
      // uses slab buffer i % 2 for the (i / 2)-th time.
      const int pairs = (total - blockIdx.x + gridDim.x - 1) / gridDim.x *
                        chunks;
      const int slab_tap = p.stages < kSlabTap ? p.stages : kSlabTap;
      auto load_slab = [&](int i) {
        const Tile tile = wg::decode(s, blockIdx.x + i / chunks * gridDim.x);
        const int buf = i & 1;
        const uint32_t bar = slab_full + 8 * buf;
        wait_bar(slab_empty + 8 * buf, ((i >> 1) & 1) ^ 1);
        wg::mbar_expect_tx(bar, p.boxes * p.box_rows * BK);
        for (int j = 0; j < p.boxes; ++j)
          wg::tma_load_2d(base + buf * p.slab_bytes + j * p.box_rows * BK,
                          &map_x, bar, i % chunks * BK,
                          tile.x0 - p.halo + j * p.box_rows);
      };
      int stage = 0;
      uint32_t phase = 0;
      load_slab(0);
      for (int i = 0; i < pairs; ++i) {
        const Tile tile = wg::decode(s, blockIdx.x + i / chunks * gridDim.x);
        const int k0 = i % chunks * BK;
        for (int tap = 0; tap < 9; ++tap) {
          if (tap == slab_tap && i + 1 < pairs) load_slab(i + 1);
          wait_bar(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          wg::mbar_expect_tx(bar, kBBytes);
          wg::tma_load_2d(sb + stage * kBBytes, &map_w, bar,
                          tap * s.cin + k0, tile.nt * BN);
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wgi = tid >> 7;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  // this warp's first tile row (of m64 block 0), and the row in its 16
  // and the 16-byte half of a k32 step whose address this lane gives
  const int row0 = wgi * MT * 64 + (warp & 3) * 16;
  const int lrow = (lane & 7) + (lane & 8);
  const int lhi = lane >> 4;
  int stage = 0;
  uint32_t phase = 0;
  int i = 0;  // (tile, chunk) pairs consumed
  int acc[MT][BN / 2];
  uint32_t a[2][MT][4];
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile tile = wg::decode(s, t);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[mt][j] = 0;
    wg::fence_acc<MT * BN / 2>(&acc[0][0]);
    // bit k of ok[mt][hf]: tap k of fragment row row0 + mt * 64 + g + 8 hf
    // lies inside its image (none for a row past the tensor)
    uint32_t ok[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = tile.x0 + row0 + mt * 64 + g + 8 * hf;
        uint32_t bits = 0;
        if (m < s.m_total) {
          const int x = m % s.w;
          const int y = m / s.w % s.h;
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            const int yy = y + k / 3 - 1, xx = x + k % 3 - 1;
            bits |= static_cast<uint32_t>(yy >= 0 && yy < s.h && xx >= 0 &&
                                          xx < s.w)
                    << k;
          }
        }
        ok[mt][hf] = bits;
      }
    bool first = true;
    int prev = 0;
    for (int c = 0; c < chunks; ++c, ++i) {
      const int buf = i & 1;
      wait_bar(slab_full + 8 * buf, (i >> 1) & 1);
      const uint32_t slab = base + buf * p.slab_bytes;
      for (int tap = 0; tap < 9; ++tap) {
        // this lane's slab row at the tap's offset, and the swizzle of its
        // 16-byte chunks (128-byte: chunk ^ row % 8; 64-byte: chunk ^
        // (row / 2) % 4), the same for every m64 block (64 rows on)
        const int r = p.halo + (tap / 3 - 1) * s.w + (tap % 3 - 1) + row0 +
                      lrow;
        const uint32_t ra = slab + r * BK;
        const int sw = BK == 128 ? (r & 7) : ((r >> 1) & 3);
        uint32_t mk[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            mk[mt][hf] = 0u - ((ok[mt][hf] >> tap) & 1u);
        wait_bar(full + 8 * stage, phase);
        const uint32_t bt = sb + stage * kBBytes;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t(&f)[MT][4] = a[ks & 1];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            ldmatrix_x4(f[mt], ra + mt * 64 * BK +
                                   (static_cast<uint32_t>((2 * ks + lhi) ^ sw)
                                    << 4));
            f[mt][0] &= mk[mt][0];
            f[mt][1] &= mk[mt][1];
            f[mt][2] &= mk[mt][0];
            f[mt][3] &= mk[mt][1];
          }
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            wgmma_rs<BN>(acc[mt], f[mt], wg::desc_sw<BK>(bt + ks * 32));
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // retires the step before: its A buffer is the next step's, and
          // at ks = 0 its B tile was the tap before's
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          if (ks == 0 && !first && lane == 0)
            wg::mbar_arrive(empty + 8 * prev);
        }
        first = false;
        prev = stage;
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      // every ldmatrix of the slab has delivered its registers to an
      // issued wgmma, so the slab is free
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(slab_empty + 8 * buf);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg::fence_acc<MT * BN / 2>(&acc[0][0]);
    if (lane == 0) wg::mbar_arrive(empty + 8 * prev);
    wg::ScaleEpi<F32>::template tile<BM, BN>(
        ep, s, tile, acc, smem_raw + (base - raw) + p.epi_off, tid);
  }
}

// The flat activation as a 2-D map (Cin, M) read in boxes of (BK,
// box_rows) and the packed weight as K1's (9*Cin, Cout) map read in boxes
// of (BK, BN), both in the BK-byte swizzle; tiles of BM flat pixels.
template <int BM, int BN, int BK, bool F32>
static cudaError_t launch(const void* x, const void* wt, const float* scale,
                          void* out, int nimg, int h, int w, int cin,
                          int cout, int box_rows, int boxes, int stages,
                          cudaStream_t stream) {
  Shape s = wg::base_shape(nimg, h, w, cin, cout, 9);
  s.im2col = 1;  // wg::out_row: tile row r is the flat pixel x0 + r
  s.bw = BM;     // decode: tile t's first pixel x0 = (t / tiles_n) * BM
  s.bh = 1;
  s.bn = 1;
  s.step_y = 1;
  s.tiles_x = (s.m_total + BM - 1) / BM;
  s.tiles_y = 1;
  s.tiles_m = s.tiles_x;
  s.tiles_n = cout / BN;
  s.k_tiles = 9 * cin / BK;
  s.a_bytes = 0;
  const Plan p = make_plan(w, BN, BK, box_rows, boxes, stages);
  if (box_rows % 8 != 0 || box_rows < 8 || box_rows > 256 || boxes < 1 ||
      boxes > 2 || boxes * box_rows < BM + 2 * (w + 1) || stages < 3 ||
      p.smem > wg::kSmemMax)
    return cudaErrorInvalidValue;
  wg::EncodeTiled enc = wg::encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  wg::Maps maps;
  const cuuint64_t xdim[2] = {static_cast<cuuint64_t>(cin),
                              static_cast<cuuint64_t>(s.m_total)};
  const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(cin)};
  const cuuint32_t xbox[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t ones[2] = {1, 1};
  if (enc(&maps.x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(x),
          xdim, xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
          wg::swizzle<BK>(), CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cuuint64_t wdim[2] = {static_cast<cuuint64_t>(9) * cin,
                              static_cast<cuuint64_t>(cout)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(9) * cin};
  const cuuint32_t wbox[2] = {BK, BN};
  if (enc(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wt),
          wdim, wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
          wg::swizzle<BK>(), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // the largest dynamic shared memory a block may take, raised once per
  // instance (`static`: see wgmma_s8.cuh's encode_tiled)
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        bitshift_kernel<BM, BN, BK, F32>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kSmemMax);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int total = s.tiles_m * s.tiles_n;
  const int grid = total < wg::num_sms() ? total : wg::num_sms();
  bitshift_kernel<BM, BN, BK, F32><<<grid, wg::kThreads, p.smem, stream>>>(
      maps.x, maps.w, s, p, {scale, out});
  return cudaGetLastError();
}

// K1's tiles: 128 x 256 where Cout allows, else 256 x 128 (`bm`, the
// caller's plan); K chunks of 128 channels where Cin allows, else 64.
template <bool F32>
static cudaError_t dispatch(const void* x, const void* wt, const float* sc,
                            void* out, int nimg, int h, int w, int cin,
                            int cout, int bm, int box_rows, int boxes,
                            int stages, cudaStream_t st) {
  if (bm == 128) {
    if (cout % 256 != 0) return cudaErrorInvalidValue;
    return cin % 128 == 0
               ? launch<128, 256, 128, F32>(x, wt, sc, out, nimg, h, w, cin,
                                            cout, box_rows, boxes, stages, st)
               : launch<128, 256, 64, F32>(x, wt, sc, out, nimg, h, w, cin,
                                           cout, box_rows, boxes, stages, st);
  }
  if (bm != 256) return cudaErrorInvalidValue;
  return cin % 128 == 0
             ? launch<256, 128, 128, F32>(x, wt, sc, out, nimg, h, w, cin,
                                          cout, box_rows, boxes, stages, st)
             : launch<256, 128, 64, F32>(x, wt, sc, out, nimg, h, w, cin,
                                         cout, box_rows, boxes, stages, st);
}

}  // namespace bitshift
}  // namespace reid

extern "C" int reid_conv3x3_s8_bitshift(const void* x, const void* wt,
                                        const void* scale, void* out, int nimg,
                                        int h, int w_, int cin, int cout,
                                        int bm, int box_rows, int boxes,
                                        int stages, int out_f32,
                                        void* stream) {
  using namespace reid::bitshift;
  if (nimg == 0) return 0;
  if (cin % 64 != 0 || cout % 128 != 0 || nimg < 0 || h <= 0 || w_ <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      out_f32 ? dispatch<true>(x, wt, sc, out, nimg, h, w_, cin, cout, bm,
                               box_rows, boxes, stages, st)
              : dispatch<false>(x, wt, sc, out, nimg, h, w_, cin, cout, bm,
                                box_rows, boxes, stages, st));
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
