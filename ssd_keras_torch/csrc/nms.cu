// Exact greedy NMS keep mask over L independent lanes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_keras_tpu/kernels/nms_pallas.py:_nms_kernel
// (:52) and its wrapper _greedy_nms_mask_batched_local (:124). Same rule,
// over boxes sorted by score descending within each lane:
//
//   keep[i] = valid[i] && !exists j < i: keep[j] && IoU(j, i) > thr
//
// What bounds it on this card. The work is the IoU tests: at most
// K (K - 1) / 2 pairs a lane (12.8 M at L = 160, K = 400), each ~16 f32
// operations and an IEEE division, about 3 us at the card's 67 TFLOP/s of
// f32; the bytes (18 a candidate) take a tenth of that. Around the tests
// is a serial chain: row i is decided only after every earlier kept row
// has applied its suppressions, ceil(bound / 64) chunks of 64 rows here.
// The TPU kernel kept the serial form because its vector unit stepped 128
// lanes at once; on this card a per-row chain of barriers left the SMs
// idle. So the work is split in two passes:
//
//   Pass A, nms_iou_mask (parallel). One 256-thread block per (lane, tile),
//   over the W (W + 1) / 2 tiles of 64 x 64 on or above the diagonal of the
//   lane's K x K pair matrix, W = ceil(K / 64). Tile (rb, cb) sets bit b of
//   word mask[lane][i][cb], i = 64 rb + r, when j = 64 cb + b satisfies
//   i < j < bound and IoU(i, j) > thr. Every pair is tested once and none
//   depends on another. Row r has 4 neighbouring threads, each over every
//   4th column, so a thread's chain of pairs is 16 long and a warp's shared
//   loads hit neighbouring float4s; two shuffles OR the parts. A pair that
//   does not overlap skips the division (its IoU is +-0 either way): the
//   division's range check sends a zero numerator down its slow path, and
//   most pairs do not overlap. A tile whose columns all lie
//   at or past the lane's trip bound (one past its last valid row; each
//   block reads the valid flags from the top down and stops at the first
//   group that holds one, or at its own columns) returns at once, so
//   sparse lanes pay only for the rows they have.
//
//   Pass B, nms_resolve (serial in bit operations only). One warp per lane
//   walks the rows below the bound in 64-row chunks c, two rows a thread.
//   The chunk's candidates are its valid rows (two ballots) not yet in
//   removed[c]. Its kept bits are the fixpoint of
//     kept = cand & ~(OR of the diagonal words mask[lane][r][c], r kept),
//   iterated from kept = cand with two warp OR-reductions a round: a
//   diagonal word has bits only above its row, so after n rounds the
//   chunk's first n rows are right, and a round that changes nothing has
//   reached the one solution (at most 64 rounds; as many as the longest
//   chain of suppressions, a few on real lanes). Then the warp ORs the
//   kept rows' words of each later chunk into removed[], ceil(bound / 64)
//   words in shared memory. The loads of chunk c + 1 (its diagonal and
//   first 8 later words, its valid flags) go out before chunk c resolves:
//   they do not depend on it.
//
//   Pass B reads only words that pass A wrote: rows below the bound, words
//   from the row's own chunk up to the bound's. The scratch is never
//   cleared (the wrapper keeps one per stream across calls), so any other
//   word may hold anything.
//
// Bit-exactness with the plain PyTorch version (ssd_keras_torch/ops/nms.py):
// every operation is the f32 op PyTorch runs, in the same order, with
// explicit round-to-nearest intrinsics (no FMA contraction; the library is
// also built with --fmad=false) and IEEE division; min/max propagate NaN as
// torch.minimum/torch.maximum do (PTX min.NaN/max.NaN, one instruction
// each). Row i, the earlier row, plays "a" in the IoU expression as in the
// plain version. The division stays where the pair overlaps: the test
// inter > thr * union is not the same test.
//
// C entries: ssd_greedy_nms(...) runs both passes, ssd_nms_iou_mask(...)
// pass A alone. Each launches on the given stream, allocates nothing (the
// caller passes the (L, K, W) u64 scratch), does not synchronise, and
// returns cudaGetLastError() after each launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;         // rows and columns of a pass-A tile; bits of a word
constexpr int kSplit = 4;         // pass-A threads a row, each over every 4th column of the tile
constexpr int kThreadsA = kTile * kSplit;
constexpr int kResolveWarps = 2;  // lanes (one warp each) in a pass-B block
constexpr int kMaxWords = 160;    // removed bitmap words: K <= 10240
constexpr int kScan = 8;          // valid flags a thread loads at once in a bound scan
constexpr int kGroup = 8;         // later words of a chunk's rows loaded at once in pass B

// min/max that return NaN when either input is NaN, as torch.minimum and
// torch.maximum do (one sm_80+ instruction each; for other inputs the same
// as fminf/fmaxf). A NaN's payload never reaches a decision.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// clamp_min(v, 0) with NaN passed through, as torch.clamp_min does.
__device__ __forceinline__ float relu_nan(float v) { return nan_max(v, 0.0f); }

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2, float d) {
  return __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), d), __fadd_rn(__fsub_rn(y2, y1), d));
}

// IoU(a, b) > thr in the plain version's op order, a the earlier row. A
// pair that does not overlap (inter = +-0, with union > 0) has IoU +-0,
// which compares with thr as 0 does: it skips the division.
__device__ __forceinline__ bool suppresses(float ax1, float ay1, float ax2, float ay2,
                                           float aarea, float4 b, float barea, float thr,
                                           float d) {
  const float iw = relu_nan(__fadd_rn(__fsub_rn(nan_min(ax2, b.z), nan_max(ax1, b.x)), d));
  const float ih = relu_nan(__fadd_rn(__fsub_rn(nan_min(ay2, b.w), nan_max(ay1, b.y)), d));
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(aarea, barea), inter);
  const float iou = (uni > 0.0f && inter != 0.0f) ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > thr;
}

// (rb, cb) of the tile-th tile on or above the diagonal, row by row.
__device__ __forceinline__ void tile_coords(int tile, int w, int* rb, int* cb) {
  int r = 0;
  while (tile >= w - r) {
    tile -= w - r;
    ++r;
  }
  *rb = r;
  *cb = r + tile;
}

__device__ __forceinline__ uint64_t shfl_xor_u64(uint64_t x, int lane_mask) {
  const uint32_t lo = __shfl_xor_sync(0xffffffffu, static_cast<uint32_t>(x), lane_mask);
  const uint32_t hi = __shfl_xor_sync(0xffffffffu, static_cast<uint32_t>(x >> 32), lane_mask);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

__global__ void __launch_bounds__(kThreadsA)
nms_iou_mask(const float* __restrict__ boxes,    // (L, K, 4)
             const uint8_t* __restrict__ valid,  // (L, K)
             uint64_t* __restrict__ mask,        // (L, K, W)
             int k, int w, float thr, float d) {
  constexpr int kPart = kTile / kSplit;
  __shared__ float4 sbox[kTile];
  __shared__ float sarea[kTile];
  __shared__ int s_bound;

  const int lane = blockIdx.x;
  const int t = threadIdx.x;
  int rb, cb;
  tile_coords(blockIdx.y, w, &rb, &cb);
  const int col0 = cb * kTile;
  const float* b = boxes + static_cast<size_t>(lane) * k * 4;
  const uint8_t* v = valid + static_cast<size_t>(lane) * k;

  // The lane's trip bound, if it lies past this tile's first column: the
  // valid flags from the top down, kScan * kThreadsA at a time, to the
  // first hit.
  if (t == 0) s_bound = 0;
  __syncthreads();
  for (int top = k; top > col0; top -= kScan * kThreadsA) {
    int last = 0;
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int j = top - 1 - t - u * kThreadsA;
      if (j >= col0 && v[j]) last = max(last, j + 1);
    }
    if (last) atomicMax(&s_bound, last);
    if (__syncthreads_or(last)) break;
  }
  const int bound = s_bound;
  if (bound <= col0) return;  // block-uniform

  if (t < kTile && col0 + t < bound) {
    const int j = col0 + t;
    const float4 box = make_float4(b[4 * j], b[4 * j + 1], b[4 * j + 2], b[4 * j + 3]);
    sbox[t] = box;
    sarea[t] = box_area(box.x, box.y, box.z, box.w, d);
  }
  __syncthreads();

  // Row i's kSplit threads are neighbours in a warp; thread `part` takes
  // the columns c = part (mod kSplit), so the warp's shared loads hit
  // neighbouring float4s (no bank conflict) and each thread's chain of
  // pairs is kPart long.
  const int part = t % kSplit;
  const int i = rb * kTile + t / kSplit;
  const int lo = max(col0, i + 1) - col0;
  const int hi = min(col0 + kTile, bound) - col0;
  uint64_t word = 0;
  if (i < k && lo < hi) {
    const float ax1 = b[4 * i], ay1 = b[4 * i + 1], ax2 = b[4 * i + 2], ay2 = b[4 * i + 3];
    const float aarea = box_area(ax1, ay1, ax2, ay2, d);
    if (lo == 0 && hi == kTile) {  // a whole tile: unrolled, the pairs' chains overlap
#pragma unroll
      for (int n = 0; n < kPart; ++n) {
        const int c = part + n * kSplit;
        if (suppresses(ax1, ay1, ax2, ay2, aarea, sbox[c], sarea[c], thr, d)) word |= 1ull << c;
      }
    } else {
      for (int c = lo + ((part - lo) & (kSplit - 1)); c < hi; c += kSplit) {
        if (suppresses(ax1, ay1, ax2, ay2, aarea, sbox[c], sarea[c], thr, d)) word |= 1ull << c;
      }
    }
  }
  static_assert(kSplit == 4, "two shuffle steps OR the parts; & (kSplit - 1) is % kSplit");
  word |= shfl_xor_u64(word, 1);
  word |= shfl_xor_u64(word, 2);
  if (part == 0 && i < k) mask[(static_cast<size_t>(lane) * k + i) * w + cb] = word;
}

__device__ __forceinline__ uint64_t reduce_or_u64(uint64_t x) {
  const uint32_t lo = __reduce_or_sync(0xffffffffu, static_cast<uint32_t>(x));
  const uint32_t hi = __reduce_or_sync(0xffffffffu, static_cast<uint32_t>(x >> 32));
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// What pass B loads for one 64-row chunk: the diagonal words and the next
// kGroup words of its rows r0 = 64 c + t and r1 = r0 + 32, and their valid
// flags; zeros for rows at or past the bound and words past it.
struct ChunkLoads {
  uint64_t diag0, diag1;
  uint64_t later0[kGroup], later1[kGroup];
  bool v0, v1;
};

__device__ __forceinline__ void load_chunk(ChunkLoads& ld, const uint64_t* m, const uint8_t* v,
                                           int c, int t, int w, int words, int bound) {
  const int r0 = c * kTile + t, r1 = r0 + 32;
  const bool in0 = r0 < bound, in1 = r1 < bound;
  const uint64_t* m0 = m + static_cast<size_t>(r0) * w;
  const uint64_t* m1 = m0 + static_cast<size_t>(32) * w;
  ld.diag0 = in0 ? m0[c] : 0;
  ld.diag1 = in1 ? m1[c] : 0;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int x = c + 1 + g;
    ld.later0[g] = (in0 && x < words) ? m0[x] : 0;
    ld.later1[g] = (in1 && x < words) ? m1[x] : 0;
  }
  ld.v0 = in0 && v[r0];
  ld.v1 = in1 && v[r1];
}

__global__ void __launch_bounds__(32 * kResolveWarps)
nms_resolve(const uint8_t* __restrict__ valid,  // (L, K)
            const uint64_t* __restrict__ mask,  // (L, K, W), from nms_iou_mask
            uint8_t* __restrict__ keep,         // (L, K)
            int lanes, int k, int w) {
  __shared__ uint64_t s_removed[kResolveWarps][kMaxWords];

  const int t = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lane = blockIdx.x * kResolveWarps + warp;
  if (lane >= lanes) return;  // warp-uniform; no block barrier below
  const uint8_t* v = valid + static_cast<size_t>(lane) * k;
  const uint64_t* m = mask + static_cast<size_t>(lane) * k * w;
  uint8_t* out = keep + static_cast<size_t>(lane) * k;
  uint64_t* removed = s_removed[warp];

  // Trip bound: one past the last valid row; the valid flags from the top
  // down, kScan * 32 at a time, to the first hit.
  int bound = 0;
  for (int top = k; top > 0 && bound == 0; top -= kScan * 32) {
    int last = 0;
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int j = top - 1 - t - u * 32;
      if (j >= 0 && v[j]) last = max(last, j + 1);
    }
    bound = static_cast<int>(__reduce_max_sync(0xffffffffu, static_cast<unsigned>(last)));
  }
  const int words = (bound + kTile - 1) / kTile;
  for (int i = t; i < words; i += 32) removed[i] = 0;
  __syncwarp();

  // Each chunk's loads go out one chunk ahead: they do not depend on the
  // resolution.
  ChunkLoads cur, next;
  if (words > 0) load_chunk(cur, m, v, 0, t, w, words, bound);
  for (int c = 0; c < words; ++c) {
    if (c + 1 < words) load_chunk(next, m, v, c + 1, t, w, words, bound);
    const uint64_t cand =
        (__ballot_sync(0xffffffffu, cur.v0) |
         (static_cast<uint64_t>(__ballot_sync(0xffffffffu, cur.v1)) << 32)) &
        ~removed[c];

    // The chunk's greedy keep bits as the fixpoint of
    //   kept = cand & ~(OR of the diagonal words of the kept rows),
    // iterated from kept = cand. A diagonal word has bits only above its
    // row, so after n rounds the chunk's first n rows are right: at most 64
    // rounds, and a round that changes nothing has reached the one
    // solution. Each round is two warp OR-reductions.
    uint64_t kept = cand;
    for (;;) {
      const uint64_t hit = reduce_or_u64(((kept >> t) & 1 ? cur.diag0 : 0) |
                                         ((kept >> (t + 32)) & 1 ? cur.diag1 : 0));
      const uint64_t again = cand & ~hit;
      if (again == kept) break;  // warp-uniform
      kept = again;
    }
    const int r0 = c * kTile + t, r1 = r0 + 32;
    if (r0 < k) out[r0] = static_cast<uint8_t>((kept >> t) & 1);
    if (r1 < k) out[r1] = static_cast<uint8_t>((kept >> (t + 32)) & 1);

    // The kept rows' suppressions of every later chunk.
    if (kept) {
      const bool k0 = (kept >> t) & 1, k1 = (kept >> (t + 32)) & 1;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int x = c + 1 + g;
        if (x < words) {  // warp-uniform
          const uint64_t hit = reduce_or_u64((k0 ? cur.later0[g] : 0) | (k1 ? cur.later1[g] : 0));
          if (t == 0) removed[x] |= hit;
        }
      }
      // Words past the first group (K > 64 * (kGroup + 1)): a group's
      // loads at a time.
      const uint64_t* m0 = m + static_cast<size_t>(r0) * w;
      const uint64_t* m1 = m0 + static_cast<size_t>(32) * w;
      for (int x0 = c + 1 + kGroup; x0 < words; x0 += kGroup) {
        uint64_t more[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const int x = x0 + g;
          more[g] = x < words ? (k0 ? m0[x] : 0) | (k1 ? m1[x] : 0) : 0;
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (x0 + g < words) {  // warp-uniform
            const uint64_t hit = reduce_or_u64(more[g]);
            if (t == 0) removed[x0 + g] |= hit;
          }
        }
      }
    }
    __syncwarp();
    if (c + 1 < words) cur = next;
  }
  for (int r = words * kTile + t; r < k; r += 32) out[r] = 0;
}

}  // namespace

extern "C" int ssd_nms_iou_mask(const void* boxes, const void* valid, void* mask,
                                int lanes, int k, float iou_threshold,
                                float border_delta, void* stream) {
  const int w = (k + kTile - 1) / kTile;
  const dim3 grid(lanes, w * (w + 1) / 2);
  nms_iou_mask<<<grid, kThreadsA, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint64_t*>(mask), k, w, iou_threshold, border_delta);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssd_greedy_nms(const void* boxes, const void* valid, void* keep,
                              void* mask, int lanes, int k, float iou_threshold,
                              float border_delta, void* stream) {
  const int status = ssd_nms_iou_mask(boxes, valid, mask, lanes, k, iou_threshold,
                                      border_delta, stream);
  if (status != 0) return status;
  const int w = (k + kTile - 1) / kTile;
  const int blocks = (lanes + kResolveWarps - 1) / kResolveWarps;
  nms_resolve<<<blocks, 32 * kResolveWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(valid), static_cast<const uint64_t*>(mask),
      static_cast<uint8_t*>(keep), lanes, k, w);
  return static_cast<int>(cudaGetLastError());
}
