// Exact greedy NMS keep mask over L independent lanes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_keras_tpu/kernels/nms_pallas.py:_nms_kernel
// (with its wrapper _greedy_nms_mask_batched_local). Same rule, over boxes
// sorted by score descending within each lane:
//
//   keep[i] = valid[i] && !exists j < i: keep[j] && IoU(j, i) > thr
//
// What bounds it on this card: the serial chain of row decisions. Row i can
// only be decided once every earlier kept row has applied its suppressions,
// so a lane costs K dependent steps whatever the bandwidth or FLOP rate; the
// data (K * 20 bytes per lane) is tiny. The design keeps that chain short
// and on chip:
//   * one thread block per lane, so lanes run in parallel across the SMs;
//   * the lane's boxes, areas, valid flags and suppression flags live in
//     shared memory for the whole pass (K * 22 bytes, 8.8 KB at K = 400);
//   * the block reduces its own trip bound (one past its last valid row),
//     which replaces the TPU kernel's scalar-prefetched per-block bound;
//   * a suppressed or invalid row costs one shared-memory read and no
//     barrier: the keep decision is block-uniform, so only a kept row pays
//     for the parallel IoU sweep over later rows and one __syncthreads.
//
// Bit-exactness with the plain PyTorch version (ssd_keras_torch/ops/nms.py):
// every operation is the f32 op PyTorch runs, in the same order, with
// explicit round-to-nearest intrinsics (no FMA contraction; the library is
// also built with --fmad=false) and IEEE division; min/max propagate NaN as
// torch.minimum/torch.maximum do.
//
// C entry: ssd_greedy_nms(...) launches on the given stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// clamp_min(v, 0) with NaN passed through, as torch.clamp_min does.
__device__ __forceinline__ float relu_nan(float v) {
  return (v != v) ? v : fmaxf(v, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float* __restrict__ boxes,     // (L, K, 4)
                  const uint8_t* __restrict__ valid,   // (L, K)
                  uint8_t* __restrict__ keep,          // (L, K)
                  int k, float thr, float d) {
  extern __shared__ float smem[];
  float* sx1 = smem;
  float* sy1 = sx1 + k;
  float* sx2 = sy1 + k;
  float* sy2 = sx2 + k;
  float* sarea = sy2 + k;
  uint8_t* svalid = reinterpret_cast<uint8_t*>(sarea + k);
  uint8_t* ssup = svalid + k;
  __shared__ int s_bound;

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const float* b = boxes + static_cast<size_t>(lane) * k * 4;
  const uint8_t* v = valid + static_cast<size_t>(lane) * k;
  uint8_t* out = keep + static_cast<size_t>(lane) * k;

  if (tid == 0) s_bound = 0;
  __syncthreads();

  int local_bound = 0;
  for (int j = tid; j < k; j += kThreads) {
    const float x1 = b[4 * j], y1 = b[4 * j + 1];
    const float x2 = b[4 * j + 2], y2 = b[4 * j + 3];
    sx1[j] = x1;
    sy1[j] = y1;
    sx2[j] = x2;
    sy2[j] = y2;
    sarea[j] = __fmul_rn(__fadd_rn(__fsub_rn(x2, x1), d),
                         __fadd_rn(__fsub_rn(y2, y1), d));
    svalid[j] = v[j];
    ssup[j] = 0;
    out[j] = 0;
    if (v[j]) local_bound = j + 1;
  }
  atomicMax(&s_bound, local_bound);
  __syncthreads();
  const int bound = s_bound;

  for (int i = 0; i < bound; ++i) {
    // Every thread reads the same flags, final since the last barrier:
    // the branch is uniform across the block.
    if (!svalid[i] || ssup[i]) continue;
    if (tid == 0) out[i] = 1;
    const float ax1 = sx1[i], ay1 = sy1[i], ax2 = sx2[i], ay2 = sy2[i];
    const float aarea = sarea[i];
    for (int j = i + 1 + tid; j < bound; j += kThreads) {
      const float iw = relu_nan(__fadd_rn(
          __fsub_rn(nan_min(ax2, sx2[j]), nan_max(ax1, sx1[j])), d));
      const float ih = relu_nan(__fadd_rn(
          __fsub_rn(nan_min(ay2, sy2[j]), nan_max(ay1, sy1[j])), d));
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(aarea, sarea[j]), inter);
      const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
      if (iou > thr) ssup[j] = 1;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int ssd_greedy_nms(const void* boxes, const void* valid, void* keep,
                              int lanes, int k, float iou_threshold,
                              float border_delta, void* stream) {
  const size_t smem = static_cast<size_t>(k) * (5 * sizeof(float) + 2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  greedy_nms_kernel<<<lanes, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, iou_threshold, border_delta);
  return static_cast<int>(cudaGetLastError());
}
