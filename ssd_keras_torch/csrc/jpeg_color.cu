// libjpeg's chroma upsampling and YCbCr -> RGB conversion over a batch of
// decoded JPEG planes, for Hopper (sm_90a).
//
// Not the port of a TPU kernel: it is the colour stage of the JAX package's
// host decoder (ssd_keras_tpu/native/ssd_jpeg.cpp:decode_one, libjpeg's
// jdsample.c and jdcolor.c), moved onto the card. nvJPEG decodes the batch
// to planar Y, Cb, Cr at their own resolutions (NVJPEG_OUTPUT_UNCHANGED);
// its planes differ from libjpeg's integer IDCT by at most one level, but
// its own RGB output upsamples chroma by another rule and converts in
// floating point, tens of levels from PIL at strong chroma edges. This
// kernel computes what libjpeg computes from the planes, in the same
// integer arithmetic, bit for bit what its plain version
// (ssd_keras_torch/ops/jpeg_color.py:ycc_to_rgb) computes:
//
//   - "fancy" upsampling (libjpeg's default, which PIL keeps): for 4:2:2
//     (h2v1) each output sample is (3 nearer + 1 farther + bias) / 4, the
//     bias 1 then 2; for 4:2:0 (h2v2) the column sums 3 nearer row + 1
//     farther row are weighted 3:1 the same way, (.. + 8) >> 4 then
//     (.. + 7) >> 4. Edge samples take their own value as the missing
//     neighbour (libjpeg's replicated context rows and special-cased end
//     columns). A chroma plane two samples wide or less is replicated, as
//     libjpeg does there;
//   - the conversion with libjpeg's 16-bit fixed-point tables
//     (FIX(1.40200), FIX(1.77200), -FIX(0.71414), -FIX(0.34414), rounding
//     by ONE_HALF), clamped to 0..255.
//
// Gray images (one plane) are copied as they are. Other subsamplings
// (4:4:0, 4:1:1, 4:1:0) are not taken: the binding reads those files
// through PIL.
//
// What bounds it on this card: bytes. A pixel reads its Y byte and, for
// 4:2:0, half a chroma byte, and writes three; 32 VOC images (500 x 375,
// 4:2:0) move 27.0 MB, 8.06 us at 3.35 TB/s. The arithmetic (~25 integer
// instructions a pixel even when written tightly, issued at half rate on
// each of the SM's two integer pipes) is under that bound only if the
// kernel spends few instructions on anything else. The kernel this one
// replaced (one thread a pixel) spent them on a 64-bit division a pixel to find its row,
// on both chroma samples rebuilt from ~8 byte loads for every pixel, on
// three one-byte stores a pixel, and on a grid sized for the batch's
// largest image. This design removes each:
//
//   - Tiles, no division. The wrapper (kernels/jpeg_color.py:bands) cuts
//     every image into tiles of whole output rows (an even number) and at
//     most kTileCols columns, about kTilePixels pixels each, and uploads one
//     (image, first row, first column, rows) entry a tile with the layout.
//     One block a tile: a small image launches only its own blocks.
//   - Rows staged by the Tensor Memory Accelerator. One thread a row issues
//     one bulk copy (cp.async.bulk) of the 16-byte aligned span that holds
//     it (Y; 4:4:4's Cb and Cr; the subsampled kinds' chroma rows with
//     their context row above and below and column on each side, clamped
//     to the plane as libjpeg replicates its edges), all completing on one
//     mbarrier: no registers, no per-lane address arithmetic, every copy of
//     the block in flight at once. A span that would reach outside the
//     planes comes a byte at a time at its ragged end.
//   - Chroma once a sample, both planes at once. The subsampled chroma
//     rows become (cb | cr << 16) words, one a column, scaled so that each
//     result lands in byte 1 of its 16-bit lane: a thread makes 8 output
//     columns of two rows (4:2:0) or of one row (4:2:2) from six words a
//     staged row, two aligned shared loads; each 3:1 column sum is formed
//     once for both planes and both output rows' neighbours, and the lanes
//     never carry into each other.
//   - Few instructions a pixel. libjpeg's >> 16 is the high half of each
//     32-bit sum, which one PRMT pairs with the next byte's; Hopper's DPX
//     instruction adds Y to both 16-bit lanes and clamps them to 0..255 in
//     one step; two such pairs make a word of interleaved RGB.
//   - Wide stores. A thread writes its 24 RGB bytes into a staged row with
//     three 8-byte stores; each output row goes out with aligned 16-byte
//     stores (two 16-byte shared loads and funnel shifts each), its head
//     and tail a byte a lane.
//
// Times on 32 VOC-size 4:2:0 files (500 x 375, 6.0 M pixels), from
// jpeg_color_ab.py on an NVIDIA H100 80GB HBM3 at its 700 W power limit,
// both kernels in one process: the replaced kernel 53.0 us of device time
// (its torch.profiler span), this one 15.6 us (16.8 us by CUDA events
// around its calls), against the 8.06 us bound. PERF.md has the steps.
//
// Layout: one row of kLayoutFields int64 an image (ssd_keras_torch/ops/
// jpeg_color.py:LAYOUT_FIELDS): offsets of the Y, Cb and Cr planes in
// `planes` (pitch: the plane's width), the chroma plane's width and
// height, the image's height and width, its kind (0 gray, 1 4:4:4, 2 4:2:2,
// 3 4:2:0) and the offset of its pixels in `out` (H x W gray, or H x W x 3
// interleaved RGB). The wrapper checks every offset against the buffers,
// and plans the tiles (kBandFields int32 a tile) by the constants below.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLayoutFields = 9;
constexpr int kBandFields = 4;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// The tile plan (kernels/jpeg_color.py mirrors these): at most kTileCols
// columns, rows = min(kTileRowsMax, kTilePixels / cols rounded down to even).
constexpr int kTileCols = 512;
constexpr int kTilePixels = 2048;
constexpr int kTileRowsMax = 32;
// Shared staging in bytes, the most a tile of that plan needs at the
// pitches below (tests/test_torch_jpeg.py checks every tile width): a
// full-resolution plane's rows (kPlaneBytes); a stage holds the Y rows,
// then 4:4:4's Cb and Cr rows or both planes' raw subsampled chroma rows
// (kRawBytes); the subsampled chroma's (cb | cr << 16) words (kWordBytes);
// the RGB rows (kRgbBytes).
constexpr int kPlaneBytes = 3360;
constexpr int kRgbBytes = 7200;
constexpr int kRawBytes = 6144;
constexpr int kWordBytes = 4928;
constexpr int kStageBytes = 3 * kPlaneBytes;
constexpr int kOffsets = 3 * kTileRowsMax;  // staged rows a tile has at most
static_assert(kPlaneBytes + kRawBytes <= kStageBytes, "raw chroma rows must fit a stage");

enum Kind { kGray = 0, k444 = 1, k422 = 2, k420 = 3 };

__device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }
// Row pitches of the staged rows of a tile `cols` wide (`groups` = its
// 8-column groups): room for a 15-byte misalignment, for the bulk copies'
// whole 16-byte chunks and for the over-reach of the 8- and 16-byte shared
// loads below.
__device__ __forceinline__ int plane_pitch(int cols) { return round16(cols) + 32; }
__device__ __forceinline__ int rgb_pitch(int cols) { return round16(3 * cols) + 32; }
__device__ __forceinline__ int chroma_pitch(int groups) { return round16(4 * groups + 4) + 48; }

// The bytes of `planes` a kernel may read: [lo, hi).
struct Bounds {
  uintptr_t lo, hi;
};

struct Tile {
  const uint8_t* y;
  const uint8_t* cb;
  const uint8_t* cr;
  uint8_t* out;
  Bounds planes;
  int cw, ch, w, kind, row0, col0, rows, cols;
};

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's barrier for its staged rows: `count` threads each arrive
// once, a thread that stages a row with the bytes its bulk copy brings.
__device__ __forceinline__ void init_barrier(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void wait_barrier(uint32_t bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(0u)
        : "memory");
  } while (!done);
}

// Copies the n bytes at g into shared memory at s (16-byte aligned), byte b
// at s[(g & 15) + b], and arrives on `bar`: the 16-byte aligned span that
// holds the row goes by one bulk copy of the Tensor Memory Accelerator,
// which completes on `bar`, except a ragged end whose 16 bytes would reach
// outside the planes: that end comes a byte at a time. One thread a row.
__device__ __forceinline__ void row_bulk(uint8_t* s, const uint8_t* g, int n, Bounds planes,
                                         uint32_t bar) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g), end = a + n;
  const uintptr_t base = a & ~uintptr_t{15};
  uintptr_t lo = base, hi = (end + 15) & ~uintptr_t{15};
  if (lo < planes.lo) lo = (a + 15) & ~uintptr_t{15};
  if (hi > planes.hi) hi = end & ~uintptr_t{15};
  for (uintptr_t x = a; x < lo && x < end; ++x)
    s[x - base] = __ldg(reinterpret_cast<const uint8_t*>(x));
  for (uintptr_t x = hi > a ? hi : a; x < end; ++x)
    s[x - base] = __ldg(reinterpret_cast<const uint8_t*>(x));
  const uint32_t bytes = hi > lo ? static_cast<uint32_t>(hi - lo) : 0;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  if (bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_address(s + (lo - base))),
        "l"(lo), "r"(bytes), "r"(bar)
        : "memory");
}

// 16 bytes of shared memory from index o, any alignment: two aligned 16-byte
// loads and funnel shifts (the shift is uniform across a row's chunks).
__device__ __forceinline__ uint4 load16(const uint8_t* s, int o) {
  const uint4* p = reinterpret_cast<const uint4*>(s + (o & ~15));
  const uint4 v = p[0], u = p[1];
  uint32_t w0, w1, w2, w3, w4;
  switch ((o >> 2) & 3) {
    case 0: w0 = v.x; w1 = v.y; w2 = v.z; w3 = v.w; w4 = u.x; break;
    case 1: w0 = v.y; w1 = v.z; w2 = v.w; w3 = u.x; w4 = u.y; break;
    case 2: w0 = v.z; w1 = v.w; w2 = u.x; w3 = u.y; w4 = u.z; break;
    default: w0 = v.w; w1 = u.x; w2 = u.y; w3 = u.z; w4 = u.w; break;
  }
  const int sh = 8 * (o & 3);
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// 8 bytes of shared memory from index o, any alignment.
__device__ __forceinline__ uint2 load8(const uint8_t* s, int o) {
  const uint2* p = reinterpret_cast<const uint2*>(s + (o & ~7));
  const uint2 v = p[0], u = p[1];
  const bool hi = o & 4;
  const uint32_t w0 = hi ? v.y : v.x, w1 = hi ? u.x : v.y, w2 = hi ? u.y : u.x;
  const int sh = 8 * (o & 3);
  return make_uint2(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh));
}

// The n bytes at s[src + b] to g[b]: aligned 16-byte stores inside the row,
// the ragged head and tail a byte a lane. One warp a row.
__device__ __forceinline__ void row_out(uint8_t* g, const uint8_t* s, int src, int n, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g), end = a + n;
  const uintptr_t first = (a + 15) & ~uintptr_t{15}, last = end & ~uintptr_t{15};
  const int o = src + static_cast<int>(first - a);
  for (uintptr_t c = first + 16 * lane; c < last; c += 16 * 32)
    *reinterpret_cast<uint4*>(c) = load16(s, o + static_cast<int>(c - first));
  const uintptr_t x = lane < 16 ? a + lane : (last > first ? last : first) + (lane - 16);
  if (x < (lane < 16 ? (first < end ? first : end) : end))
    *reinterpret_cast<uint8_t*>(x) = s[src + static_cast<int>(x - a)];
}

// Byte k of w, zero-extended: one PRMT.
__device__ __forceinline__ int byte_of(uint32_t w, int k) {
  return static_cast<int>(__byte_perm(w, 0, 0x4440 | k));
}

// The high halves of a (lane 0) and b (lane 1): two values' >> 16, as
// 16-bit lanes, in one PRMT.
__device__ __forceinline__ uint32_t high_halves(int a, int b) {
  return __byte_perm(static_cast<uint32_t>(a), static_cast<uint32_t>(b), 0x7632);
}

// Bytes i and j of the 8 Y bytes as two 16-bit lanes (i, j known at
// compile time: one PRMT, and a mask where they lie in different words).
__device__ __forceinline__ uint32_t y_pair(uint2 y, int i, int j) {
  const uint32_t wi = i < 4 ? y.x : y.y;
  if ((i < 4) == (j < 4)) return __byte_perm(wi, 0, 0x4040 | (i & 3) | ((j & 3) << 8));
  return __byte_perm(wi, y.y, 0x4040 | (i & 3) | (((j & 3) + 4) << 8)) & 0x00ff00ffu;
}

// Each lane of y + term clamped to 0..255: one DPX instruction on Hopper.
__device__ __forceinline__ uint32_t add_clamp2(uint32_t y, uint32_t term) {
  return __viaddmin_s16x2_relu(y, term, 0x00ff00ffu);
}

// libjpeg's ycc_rgb_convert of 8 pixels (y: their 8 Y bytes) into 24
// interleaved RGB bytes at d (8-byte aligned shared memory). Its tables'
// -128 offsets and ONE_HALF are folded into the constants (91881 * 128 -
// 32768 = 11728000, 116130 * 128 - 32768 = 14831872, (22554 + 46802) * 128
// + 32768 = 8910336). Each term's >> 16 is the high half of its 32-bit sum,
// which one PRMT puts into a 16-bit lane beside the next byte's term; one
// instruction adds Y to both lanes and clamps them, and two such pairs
// make a word of the output.
__device__ __forceinline__ void convert8(uint2 y, const int cb[8], const int cr[8], uint8_t* d) {
  int sum[24];  // R, G, B of pixel t at 3t, 3t + 1, 3t + 2, before >> 16
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    sum[3 * t] = 91881 * cr[t] - 11728000;
    sum[3 * t + 1] = 8910336 - 22554 * cb[t] - 46802 * cr[t];
    sum[3 * t + 2] = 116130 * cb[t] - 14831872;
  }
  uint32_t word[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int b = 4 * k;  // the word's first byte: channel b % 3 of pixel b / 3
    const uint32_t lo =
        add_clamp2(y_pair(y, b / 3, (b + 1) / 3), high_halves(sum[b], sum[b + 1]));
    const uint32_t hi =
        add_clamp2(y_pair(y, (b + 2) / 3, (b + 3) / 3), high_halves(sum[b + 2], sum[b + 3]));
    word[k] = __byte_perm(lo, hi, 0x6420);
  }
  uint2* o = reinterpret_cast<uint2*>(d);
  o[0] = make_uint2(word[0], word[1]);
  o[1] = make_uint2(word[2], word[3]);
  o[2] = make_uint2(word[4], word[5]);
}

// Fancy upsampling of 8 output columns of Cb and Cr at once, from six
// staged columns v of (cb | cr << 16) << (8 - kShift) (column t's own at
// v[1 + t / 2]): h2v1 (kShift 2, biases 1 and 2) on samples, or h2v2's
// horizontal step (kShift 4, biases 8 and 7) on column sums. That scale
// puts each result's >> kShift in byte 1 of its lane, where one PRMT reads
// it, and keeps every lane under 2^16 (at most 4 * 1022 << 6 or 4 * 4088
// << 4), so the lanes never carry into each other. `plain`: a chroma plane
// two samples wide or less, replicated.
template <int kShift>
__device__ __forceinline__ void upsample8(const uint32_t v[6], bool plain, int cb[8],
                                          int cr[8]) {
  constexpr int kScale = 8 - kShift;
  constexpr uint32_t kEven = ((kShift == 2 ? 1u : 8u) << kScale) * 0x10001u;
  constexpr uint32_t kOdd = ((kShift == 2 ? 2u : 7u) << kScale) * 0x10001u;
#pragma unroll
  for (int j = 1; j <= 4; ++j) {
    const uint32_t near3 = 3 * v[j];
    const uint32_t even = plain ? v[j] << kShift : near3 + v[j - 1] + kEven;
    const uint32_t odd = plain ? v[j] << kShift : near3 + v[j + 1] + kOdd;
    cb[2 * j - 2] = byte_of(even, 1);
    cr[2 * j - 2] = byte_of(even, 3);
    cb[2 * j - 1] = byte_of(odd, 1);
    cr[2 * j - 1] = byte_of(odd, 3);
  }
}

// Staged row k of a tile in stage buffer `stage`: Y rows 0 .. rows - 1,
// then the chroma rows, Cb and Cr in turn (rows + 2 t + plane): 4:4:4's as
// Y's; 4:2:2's (row0 + t) and 4:2:0's (row0 / 2 - 1 + t, clamped to the
// plane as libjpeg replicates its edge rows) from column col0 / 2 - 1, or 0,
// to the tile's last group's, within the plane (raw: Cb's rows, then Cr's).
// `first`: the index in the staged row of its first sample (column col0, or
// col0 / 2 - 1 for subsampled chroma).
struct Staged {
  const uint8_t* src;
  uint8_t* dst;
  int n, first;
};

struct Pitches {
  int groups, yp, op, cp, ip, chroma_rows, staged;
  __device__ __forceinline__ explicit Pitches(const Tile& t)
      : groups((t.cols + 7) >> 3),
        yp(plane_pitch(t.cols)),
        op(rgb_pitch(t.cols)),
        cp(chroma_pitch(groups)),
        ip(4 * groups + 4),
        chroma_rows(t.kind == kGray ? 0 : (t.kind == k420 ? (t.rows + 1) / 2 + 2 : t.rows)),
        staged(t.rows + 2 * chroma_rows) {}
};

template <int kKind>
__device__ __forceinline__ Staged staged_row(const Tile& t, const Pitches& q, int k,
                                             uint8_t* stage) {
  if (k < t.rows || kKind == k444) {
    const int r = k < t.rows ? k : (k - t.rows) >> 1;
    const int plane = k < t.rows ? 0 : 1 + ((k - t.rows) & 1);
    const uint8_t* src = (plane == 0 ? t.y : (plane == 1 ? t.cb : t.cr)) +
                         static_cast<int64_t>(t.row0 + r) * t.w + t.col0;
    return {src, stage + plane * kPlaneBytes + r * q.yp, t.cols,
            static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15)};
  }
  const int r = (k - t.rows) >> 1, cr = (k - t.rows) & 1;
  const int i = min(max((kKind == k420 ? t.row0 / 2 - 1 : t.row0) + r, 0), t.ch - 1);
  const int lo = max(t.col0 / 2 - 1, 0), hi = min(t.col0 / 2 + 4 * q.groups + 3, t.cw);
  const uint8_t* src = (cr ? t.cr : t.cb) + static_cast<int64_t>(i) * t.cw + lo;
  return {src, stage + kPlaneBytes + (cr * q.chroma_rows + r) * q.cp, hi - lo,
          static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15) + t.col0 / 2 - 1 - lo};
}

// Stages a tile's rows into `stage` (one thread a row, its copy completing
// on `bar`) and records where each staged row's first sample lies (off).
// Every thread arrives on `bar` once, the threads without a row with no
// bytes.
template <int kKind>
__device__ __forceinline__ void stage_tile(const Tile& t, uint8_t* stage, int* off, uint32_t bar) {
  const Pitches q(t);
  const int k = threadIdx.x;
  if (k < q.staged) {
    const Staged st = staged_row<kKind>(t, q, k, stage);
    off[k] = st.first;
    row_bulk(st.dst, st.src, st.n, t.planes, bar);
  } else {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
  }
}

// The subsampled chroma rows as (cb | cr << 16) << shift words (shift: 4 for
// 4:2:0, 6 for 4:2:2, see upsample8), one a column, from column col0 / 2 - 1
// on, 4 * groups + 4 of them a row (il, pitch ip words); a column outside
// the plane takes its edge column's samples, as libjpeg's upsampling does.
// One warp a row, a lane four columns at a time: where all four lie in the
// plane, from one 4-byte read of each raw row.
__device__ __forceinline__ void interleave(const Tile& t, const Pitches& q, const uint8_t* raw,
                                           const int* off, uint32_t* il) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first_col = t.col0 / 2 - 1, shift = t.kind == k420 ? 4 : 6;
  for (int r = warp; r < q.chroma_rows; r += kWarps) {
    const uint8_t* cb_row = raw + r * q.cp;
    const uint8_t* cr_row = raw + (q.chroma_rows + r) * q.cp;
    const int cb0 = off[t.rows + 2 * r], cr0 = off[t.rows + 2 * r + 1];
    uint32_t* words = il + r * q.ip;
    for (int g = lane; g <= q.groups; g += 32) {
      const int c = first_col + 4 * g;
      uint4 out;
      if (c >= 0 && c + 3 < t.cw) {
        const uint32_t cbw = load8(cb_row, cb0 + 4 * g).x, crw = load8(cr_row, cr0 + 4 * g).x;
        const uint32_t cb_lo = __byte_perm(cbw, 0, 0x4140), cb_hi = __byte_perm(cbw, 0, 0x4342);
        const uint32_t cr_lo = __byte_perm(crw, 0, 0x4140), cr_hi = __byte_perm(crw, 0, 0x4342);
        out = make_uint4(__byte_perm(cb_lo, cr_lo, 0x5410), __byte_perm(cb_lo, cr_lo, 0x7632),
                         __byte_perm(cb_hi, cr_hi, 0x5410), __byte_perm(cb_hi, cr_hi, 0x7632));
      } else {
        uint32_t v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int at = min(max(c + k, 0), t.cw - 1) - first_col;
          v[k] = cb_row[cb0 + at] | (static_cast<uint32_t>(cr_row[cr0 + at]) << 16);
        }
        out = make_uint4(v[0], v[1], v[2], v[3]);
      }
      out = make_uint4(out.x << shift, out.y << shift, out.z << shift, out.w << shift);
      *reinterpret_cast<uint4*>(words + 4 * g) = out;
    }
  }
}

// floor(u / d) for 0 <= u < 2^16 and 1 <= d < 2^16: a multiply-high by
// ceil(2^32 / d) (exact there: u * (m * d - 2^32) < 2^32).
struct Divider {
  uint32_t m;
  int d;
  __device__ __forceinline__ explicit Divider(int divisor)
      : m(divisor == 1 ? 0u : 0xffffffffu / static_cast<uint32_t>(divisor) + 1), d(divisor) {}
  __device__ __forceinline__ int operator()(int u) const {
    return d == 1 ? u : static_cast<int>(__umulhi(static_cast<uint32_t>(u), m));
  }
};

// Six staged (cb | cr << 16) columns from word index `at` (a multiple of 4).
__device__ __forceinline__ void columns6(const uint32_t* il, int at, uint32_t v[6]) {
  const uint4 a = *reinterpret_cast<const uint4*>(il + at);
  const uint2 b = *reinterpret_cast<const uint2*>(il + at + 4);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
  v[4] = b.x;
  v[5] = b.y;
}

// Converts a tile whose rows have landed in `stage` and writes its pixels.
template <int kKind>
__device__ __forceinline__ void convert_tile(const Tile& t, const uint8_t* stage, const int* off,
                                             uint32_t* il, uint8_t* s_rgb) {
  const Pitches q(t);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint8_t* s_y = stage;
  const bool plain = t.cw <= 2;
  if (kKind == kGray) {
    for (int r = warp; r < t.rows; r += kWarps)
      row_out(t.out + static_cast<int64_t>(t.row0 + r) * t.w + t.col0, s_y + r * q.yp, off[r],
              t.cols, lane);
    return;
  }
  if (kKind == k420 || kKind == k422) {
    interleave(t, q, stage + kPlaneBytes, off, il);
    __syncthreads();
  }

  int cb[8], cr[8];
  if (kKind == k420) {
    // A thread: output rows 2p and 2p + 1 of 8-column group g, from staged
    // chroma rows p (above), p + 1 (their own) and p + 2 (below); each
    // column sum (3 nearer + 1 farther) is formed once for both planes.
    const int pairs = (t.rows + 1) >> 1;
    const Divider by_groups(q.groups);
    for (int u = threadIdx.x; u < pairs * q.groups; u += kThreads) {
      const int p = by_groups(u), g = u - p * q.groups;
      uint32_t above[6], own[6], below[6];
      columns6(il, p * q.ip + 4 * g, above);
      columns6(il, (p + 1) * q.ip + 4 * g, own);
      columns6(il, (p + 2) * q.ip + 4 * g, below);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 2 * p + half;
        uint32_t sums[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) sums[k] = 3 * own[k] + (half ? below[k] : above[k]);
        if (plain)
          upsample8<4>(own, true, cb, cr);
        else
          upsample8<4>(sums, false, cb, cr);
        // (An odd tile's last pair has no second row: it is made from
        // nothing in particular and not written out.)
        convert8(load8(s_y + r * q.yp, (r < t.rows ? off[r] : 0) + 8 * g), cb, cr,
                 s_rgb + r * q.op + 24 * g);
      }
    }
  } else {
    // A thread: 8-column group g of output row r.
    const Divider by_groups(q.groups);
    for (int u = threadIdx.x; u < t.rows * q.groups; u += kThreads) {
      const int r = by_groups(u), g = u - r * q.groups;
      if (kKind == k422) {
        uint32_t own[6];
        columns6(il, r * q.ip + 4 * g, own);
        upsample8<2>(own, plain, cb, cr);
      } else {
        const int c = t.rows + 2 * r;
        const uint2 cb8 = load8(stage + kPlaneBytes + r * q.yp, off[c] + 8 * g);
        const uint2 cr8 = load8(stage + 2 * kPlaneBytes + r * q.yp, off[c + 1] + 8 * g);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          cb[k] = byte_of(k < 4 ? cb8.x : cb8.y, k & 3);
          cr[k] = byte_of(k < 4 ? cr8.x : cr8.y, k & 3);
        }
      }
      convert8(load8(s_y + r * q.yp, off[r] + 8 * g), cb, cr, s_rgb + r * q.op + 24 * g);
    }
  }
  __syncthreads();

  for (int r = warp; r < t.rows; r += kWarps)
    row_out(t.out + (static_cast<int64_t>(t.row0 + r) * t.w + t.col0) * 3, s_rgb + r * q.op, 0,
            3 * t.cols, lane);
}

// Tile `index` of the table: its band entry and its image's layout row.
__device__ __forceinline__ Tile load_tile(const uint8_t* planes, Bounds bounds,
                                          const int64_t* layout, const int* bands, int index,
                                          uint8_t* out) {
  const int* band = bands + static_cast<int64_t>(index) * kBandFields;
  const int64_t* d = layout + static_cast<int64_t>(band[0]) * kLayoutFields;
  Tile t;
  t.y = planes + d[0];
  t.cb = planes + d[1];
  t.cr = planes + d[2];
  t.cw = static_cast<int>(d[3]);
  t.ch = static_cast<int>(d[4]);
  t.w = static_cast<int>(d[6]);
  t.kind = static_cast<int>(d[7]);
  t.out = out + d[8];
  t.planes = bounds;
  t.row0 = band[1];
  t.col0 = band[2];
  t.rows = band[3];
  t.cols = min(kTileCols, t.w - t.col0);
  return t;
}

// One block a tile: it stages the tile's rows, waits for them on its
// barrier, and converts the tile.
__global__ void __launch_bounds__(kThreads)
    ycc_to_rgb(const uint8_t* __restrict__ planes, int64_t planes_bytes,
               const int64_t* __restrict__ layout, const int* __restrict__ bands,
               uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t stage[kStageBytes];
  __shared__ __align__(16) uint32_t il[kWordBytes / 4];
  __shared__ __align__(16) uint8_t s_rgb[kRgbBytes];
  __shared__ int off[kOffsets];
  __shared__ __align__(8) uint64_t staged_rows;
  const uint32_t bar = smem_address(&staged_rows);
  const Bounds bounds{reinterpret_cast<uintptr_t>(planes),
                      reinterpret_cast<uintptr_t>(planes) + static_cast<uintptr_t>(planes_bytes)};
  const Tile t = load_tile(planes, bounds, layout, bands, blockIdx.x, out);
  if (threadIdx.x == 0) init_barrier(bar, kThreads);  // while the tile's entry loads
  __syncthreads();
  switch (t.kind) {
    case kGray: stage_tile<kGray>(t, stage, off, bar); break;
    case k444: stage_tile<k444>(t, stage, off, bar); break;
    case k422: stage_tile<k422>(t, stage, off, bar); break;
    default: stage_tile<k420>(t, stage, off, bar); break;
  }
  wait_barrier(bar);
  switch (t.kind) {
    case kGray: convert_tile<kGray>(t, stage, off, il, s_rgb); break;
    case k444: convert_tile<k444>(t, stage, off, il, s_rgb); break;
    case k422: convert_tile<k422>(t, stage, off, il, s_rgb); break;
    default: convert_tile<k420>(t, stage, off, il, s_rgb); break;
  }
}

}  // namespace

// `bands`: n_bands rows of kBandFields int32 (image, first row, first
// column, rows), `layout` one row an image, both on the card; `planes`
// holds planes_bytes bytes. Returns the launch's cudaError_t.
extern "C" int ssd_jpeg_ycc_to_rgb(const void* planes, long long planes_bytes, const void* layout,
                                   const void* bands, void* out, int n_bands, void* stream) {
  if (n_bands <= 0) return 0;
  ycc_to_rgb<<<n_bands, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), planes_bytes, static_cast<const int64_t*>(layout),
      static_cast<const int*>(bands), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
