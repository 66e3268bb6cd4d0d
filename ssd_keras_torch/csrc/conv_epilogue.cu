// The epilogue of every convolution on the port's no-grad path: its bias,
// an optional residual and an optional ReLU in one in-place pass over the
// convolution's output, for Hopper (sm_90a).
//
// It replaces no TPU kernel: in the JAX package XLA fuses the bias add, a
// residual block's add and the ReLU into the convolution's output. Here the
// convolution runs in cuDNN without its bias (F.conv2d(x, w, None)), and
// this kernel does the rest in one pass. Without it PyTorch adds the bias
// in a broadcast add_ of a (1, C, 1, 1) tensor, which TensorIterator runs
// unvectorized, then makes one more full pass over the map for the ReLU and
// one for the residual.
//
// Arithmetic: PyTorch's, step for step, so that the result equals
// y.add_(bias.view(1, C, 1, 1)); y.add_(residual); y.relu_() bit for bit
// (the plain version, ssd_keras_torch/ops/conv_epilogue.py, takes the same
// steps): float32 sums of the working type's values, rounded to the working
// type after the bias and again after the residual (round to nearest even:
// __float2bfloat16 and __float2half, which c10 also calls on sm_80 and
// later); the ReLU last, as torch.relu computes it on the card (clamp_min:
// a NaN passes as it is, any other value becomes fmaxf(v, 0)).
//
// What bounds it on this card: bytes. Each element of the map is read once
// and written once, and the residual's read once: SSD-ResNet34's b8
// 600x600x64 bf16 map after conv1 is 369 MB each way, 0.22 ms at 3.35
// TB/s. The design moves each byte once and keeps enough of them in flight:
// - a thread moves VEC elements at a time, up to 16 bytes (8 bf16): the
//   widest that divides the channels and suits the pointers' alignment,
//   down to one element (C = 3; the heads' 510 channels take two);
// - a channels_last map is a flat run of pixels of C channels; the grid's
//   stride in vectors is a multiple of C / VEC, so a thread stays on the
//   same VEC channels from its first vector to its last and keeps their
//   biases in registers: no index arithmetic per element;
// - at most 8 blocks of 256 threads an SM (2048 threads, two waves where
//   the widest kernels' 62 registers keep 4 blocks resident), each thread
//   looping, four vectors loaded before any is stored.
// A contiguous NCHW map (no caller on the main path) takes the same loop
// one element at a time, each element's channel computed from its index.
//
// The pooled variant (bias_act_pool, C entry ssd_conv_epilogue_pool) is
// for a convolution that feeds only a max pool after its ReLU (SSD300/512's
// pool1-3 and pool5, SSD-ResNet34's stem pool): it reads the bias-less
// output and writes the pooled map, bias and ReLU applied; the full-size
// map is never written and PyTorch's max pool never runs. The models'
// geometries: 2x2 at stride 2, 3x3 at stride 1 or 2, padding under half the
// window; PyTorch's output size, ceil_mode included, comes from the wrapper. Bit-equal to the epilogue
// then F.max_pool2d (max_pool_forward_nhwc: the first of the greatest in
// window order, a NaN taken over anything, padding skipped), though it
// takes the max of each window's rounded sums and the ReLU after it:
// - the ReLU is monotone, so relu(max) is the greatest ReLU'd value; a
//   positive value has one encoding, and any other comes out +0 both ways
//   (fmaxf(-0, +0) is +0 on the card, as torch.relu(-0.0) is);
// - a NaN anywhere gives the canonical NaN both ways: max.NaN returns it,
//   and the epilogue's own arithmetic and conversion leave only it;
// - so the order of the max is free: it runs along each window row, then
//   over the rows' maxima, and an element outside the map reads as -inf.
// Bound: the map read once and the pooled map written once (R34's b8
// stem: 369 MB in, 92 MB out, 0.137 ms at 3.35 TB/s); but a 3x3/2 window
// reads each element 2.25 times, so its arithmetic nears that bound too.
// The design cuts it:
// - the ReLU once an output, not once an element, and one max.NaN a step;
// - where windows overlap down the map (3x3), a thread
//   takes up to kStrip output rows of one column in turn, and carries the
//   maxima of the window rows a row shares with the next: it loads and
//   sums only the rows that are new. The strip shortens where the map
//   would leave less than two waves of the card's threads (pool5's 19x19);
// - two lanes share one packed conversion to the working type;
// - a thread keeps VEC channels of its column and their biases in
//   registers; neighbouring threads take a pixel's vectors, then the next
//   output column, so a warp reads each input row in runs, and the overlap
//   across columns and strips comes from L1 and L2: each input byte leaves
//   HBM about once.
//
// Both launch on the caller's stream and allocate nothing, so a CUDA graph
// can capture them.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 2048 / kThreads;
constexpr int kMaxDevices = 64;

// Dtype codes of the C entry (kernels/conv_epilogue.py:_DTYPES).
enum Dtype { kFloat32 = 0, kFloat16 = 1, kBFloat16 = 2 };

// A working type as its bits, with PyTorch's conversions to and from float.
// round2: two floats rounded to the type and back, in one packed conversion.
struct F32 {
  using Bits = uint32_t;
  static __device__ __forceinline__ float load(Bits b) { return __uint_as_float(b); }
  static __device__ __forceinline__ Bits store(float f) { return __float_as_uint(f); }
  static __device__ __forceinline__ void round2(float&, float&) {}
};
struct F16 {
  using Bits = uint16_t;
  static __device__ __forceinline__ float load(Bits b) {
    return __half2float(__ushort_as_half(b));
  }
  static __device__ __forceinline__ Bits store(float f) {
    return __half_as_ushort(__float2half(f));
  }
  static __device__ __forceinline__ void round2(float& a, float& b) {
    const __half2 h = __floats2half2_rn(a, b);
    a = __low2float(h);
    b = __high2float(h);
  }
};
struct BF16 {
  using Bits = uint16_t;
  static __device__ __forceinline__ float load(Bits b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  static __device__ __forceinline__ Bits store(float f) {
    return __bfloat16_as_ushort(__float2bfloat16(f));
  }
  static __device__ __forceinline__ void round2(float& a, float& b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // .x, the low half, from a
    const uint32_t r = *reinterpret_cast<const uint32_t*>(&h);
    a = __uint_as_float(r << 16);
    b = __uint_as_float(r & 0xffff0000u);
  }
};

template <int Bytes> struct Word;
template <> struct Word<2> { using Type = uint16_t; };
template <> struct Word<4> { using Type = uint32_t; };
template <> struct Word<8> { using Type = uint2; };
template <> struct Word<16> { using Type = uint4; };

// VEC elements, moved as one word.
template <typename E, int VEC>
union Pack {
  using W = typename Word<sizeof(typename E::Bits) * VEC>::Type;
  W word;
  typename E::Bits lane[VEC];
};

template <typename E, int VEC>
__device__ __forceinline__ void apply(Pack<E, VEC>& y, const Pack<E, VEC>& r, const float (&b)[VEC],
                                      bool has_residual, bool relu) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    typename E::Bits t = E::store(E::load(y.lane[k]) + b[k]);
    if (has_residual) t = E::store(E::load(t) + E::load(r.lane[k]));
    if (relu) {
      const float f = E::load(t);
      if (!isnan(f)) t = E::store(fmaxf(f, 0.0f));
    }
    y.lane[k] = t;
  }
}

// Vector v's channel in an NCHW map of `inner` elements a plane.
template <typename E, int VEC>
__device__ __forceinline__ void plane_bias(const typename E::Bits* __restrict__ bias, int64_t v,
                                           int64_t channels, int64_t inner, float (&b)[VEC]) {
  const float value = E::load(bias[(v * VEC / inner) % channels]);
#pragma unroll
  for (int k = 0; k < VEC; ++k) b[k] = value;
}

// `n_vec` vectors of `y` (and of `residual`, or none). PLANAR: NCHW with
// planes of `inner` elements; else channels_last, `channels` a pixel, and
// the grid's stride a multiple of channels / VEC (the launcher sees to it).
template <typename E, int VEC, bool PLANAR>
__global__ void __launch_bounds__(kThreads)
    bias_act(typename E::Bits* __restrict__ y, const typename E::Bits* __restrict__ bias,
             const typename E::Bits* __restrict__ residual, int64_t n_vec, int64_t channels,
             int64_t inner, bool relu) {
  using P = Pack<E, VEC>;
  using W = typename P::W;
  W* yw = reinterpret_cast<W*>(y);
  const W* rw = reinterpret_cast<const W*>(residual);
  const bool has_residual = residual != nullptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  float b[VEC];
  if (!PLANAR) {
    const int64_t c0 = v % (channels / VEC) * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) b[k] = E::load(bias[c0 + k]);
  }
  for (; v + (kUnroll - 1) * stride < n_vec; v += kUnroll * stride) {
    P p[kUnroll], r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      p[u].word = yw[v + u * stride];
      r[u].word = has_residual ? __ldg(rw + v + u * stride) : W{};
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (PLANAR) plane_bias<E, VEC>(bias, v + u * stride, channels, inner, b);
      apply<E, VEC>(p[u], r[u], b, has_residual, relu);
      yw[v + u * stride] = p[u].word;
    }
  }
  for (; v < n_vec; v += stride) {
    P p, r;
    p.word = yw[v];
    r.word = has_residual ? __ldg(rw + v) : W{};
    if (PLANAR) plane_bias<E, VEC>(bias, v, channels, inner, b);
    apply<E, VEC>(p, r, b, has_residual, relu);
    yw[v] = p.word;
  }
}

int64_t gcd(int64_t a, int64_t b) {
  while (b != 0) {
    const int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// kBlocksPerSm blocks on each SM of the current card.
int64_t grid_blocks() {
  static int sms[kMaxDevices] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) return 1024;
  if (sms[device] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    sms[device] = n > 0 ? n : 1;
  }
  return static_cast<int64_t>(sms[device]) * kBlocksPerSm;
}

// Blocks of a grid over `n_vec` vectors, at most grid_blocks(), whose
// threads are a whole number of pixels' `units` vectors: a multiple of q.
int64_t blocks_for(int64_t n_vec, int64_t units) {
  const int64_t q = units / gcd(units, kThreads);
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > grid_blocks()) blocks = grid_blocks();
  blocks = blocks / q * q;
  return blocks < q ? q : blocks;
}

template <typename E, int VEC, bool PLANAR>
int launch(void* y, const void* bias, const void* residual, int64_t numel, int64_t channels,
           int64_t inner, bool relu, cudaStream_t stream) {
  using Bits = typename E::Bits;
  const int64_t n_vec = numel / VEC;
  const int64_t blocks = blocks_for(n_vec, PLANAR ? 1 : channels / VEC);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto* out = static_cast<Bits*>(y);
  auto* b = static_cast<const Bits*>(bias);
  auto* r = static_cast<const Bits*>(residual);
  bias_act<E, VEC, PLANAR><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      out, b, r, n_vec, channels, inner, relu);
  return static_cast<int>(cudaGetLastError());
}

// An NCHW map one element at a time; a channels_last one in the widest
// vector of E that divides the channels and that both maps' addresses are
// aligned to.
template <typename E>
int dispatch(void* y, const void* bias, const void* residual, int64_t numel, int64_t channels,
             int64_t inner, bool relu, cudaStream_t stream) {
  constexpr int kSize = sizeof(typename E::Bits);
  constexpr int kWide = 16 / kSize;
  if (inner > 1)
    return launch<E, 1, true>(y, bias, residual, numel, channels, inner, relu, stream);
  const uintptr_t address =
      reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(residual);
  auto fits = [&](int vec) { return channels % vec == 0 && address % (vec * kSize) == 0; };
  if (fits(kWide))
    return launch<E, kWide, false>(y, bias, residual, numel, channels, inner, relu, stream);
  if (fits(kWide / 2))
    return launch<E, kWide / 2, false>(y, bias, residual, numel, channels, inner, relu, stream);
  if (fits(kWide / 4))
    return launch<E, kWide / 4, false>(y, bias, residual, numel, channels, inner, relu, stream);
  return launch<E, 1, false>(y, bias, residual, numel, channels, inner, relu, stream);
}

// A vector's sums rounded to E, as apply rounds them, in float (each value
// exact in E); -inf for a vector outside the map (it never wins the max, as
// PyTorch skips it).
template <typename E, int VEC>
__device__ __forceinline__ void rounded_sums(const Pack<E, VEC>& y, const float (&b)[VEC],
                                             bool inside, float (&f)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) f[k] = E::load(y.lane[k]) + b[k];
#pragma unroll
  for (int k = 0; k + 1 < VEC; k += 2) E::round2(f[k], f[k + 1]);
  if (VEC % 2) f[VEC - 1] = E::load(E::store(f[VEC - 1]));
  if (!inside) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) f[k] = __uint_as_float(0xff800000u);
  }
}

// m <- max(m, f), the canonical NaN where either is NaN (PTX max.NaN).
template <int VEC>
__device__ __forceinline__ void max_nan(float (&m)[VEC], const float (&f)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) asm("max.NaN.f32 %0, %0, %1;" : "+f"(m[k]) : "f"(f[k]));
}

// Output rows a pooled thread takes in turn where windows overlap down the
// map, when the map has work enough for two waves of the card's threads.
constexpr int kStrip = 8;

// The pooled map of `out_height` x `out_width` pixels from the channels_last
// map `y` of `height` x `width`: each output vector relu(max) of its K x K
// window's rounded sums (stride S, `pad`). The max is taken along each
// window row, then over the rows' maxima. A work item is VEC channels of
// one output column over `strip` output rows; from its second row on, a row
// reuses the maxima of the K - S window rows it shares with the row before.
// `n_items` items; the grid's stride is a multiple of channels / VEC (the
// launcher sees to it), so a thread's channels never change.
template <typename E, int VEC, int K, int S>
__global__ void __launch_bounds__(kThreads)
    bias_act_pool(const typename E::Bits* __restrict__ y, const typename E::Bits* __restrict__ bias,
                  typename E::Bits* __restrict__ out, int64_t n_items, int channels, int height,
                  int width, int out_height, int out_width, int pad, int strip) {
  using P = Pack<E, VEC>;
  using W = typename P::W;
  constexpr int kCarry = K > S ? K - S : 0;
  const W* yw = reinterpret_cast<const W*>(y);
  W* ow = reinterpret_cast<W*>(out);
  const unsigned units = static_cast<unsigned>(channels / VEC);
  const unsigned strips = (static_cast<unsigned>(out_height) + strip - 1) / strip;
  const int64_t grid_stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const unsigned cv = static_cast<unsigned>(v % units);
  float b[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) b[k] = E::load(bias[cv * VEC + k]);
  for (; v < n_items; v += grid_stride) {
    // n_items < 2^31 (launch_pool checks), so an item's index fits 32 bits.
    const unsigned item = static_cast<unsigned>(v) / units;
    const unsigned rest = item / static_cast<unsigned>(out_width);
    const int col = static_cast<int>(item - rest * out_width);
    const int oh0 = static_cast<int>(rest % strips) * strip;
    const int64_t image = rest / strips;
    const W* in = yw + image * height * width * units + cv;
    W* o = ow + (image * out_height + oh0) * out_width * units + col * units + cv;
    const int w0 = col * S - pad;
    const int rows = min(strip, out_height - oh0);
    float carry[kCarry > 0 ? kCarry : 1][VEC];
    for (int t = 0; t < rows; ++t, o += out_width * units) {
      const int h0 = (oh0 + t) * S - pad;
      const int fresh = t == 0 ? 0 : kCarry;  // window rows before it are carried
      float m[VEC];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        float rm[VEC];
        if (i < fresh) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) rm[k] = carry[i][k];
        } else {
          const int h = h0 + i;
          const bool row_in = h >= 0 && h < height;
          P p[K];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const int w = w0 + j;
            if (row_in && w >= 0 && w < width)
              p[j].word = __ldg(in + (static_cast<int64_t>(h) * width + w) * units);
          }
          rounded_sums<E, VEC>(p[0], b, row_in && w0 >= 0 && w0 < width, rm);
#pragma unroll
          for (int j = 1; j < K; ++j) {
            const int w = w0 + j;
            float f[VEC];
            rounded_sums<E, VEC>(p[j], b, row_in && w >= 0 && w < width, f);
            max_nan<VEC>(rm, f);
          }
        }
        if (i == 0) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) m[k] = rm[k];
        } else {
          max_nan<VEC>(m, rm);
        }
        if (kCarry > 0 && i >= S) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) carry[i - S][k] = rm[k];
        }
      }
      P r;
#pragma unroll
      for (int k = 0; k < VEC; ++k) r.lane[k] = E::store(isnan(m[k]) ? m[k] : fmaxf(m[k], 0.0f));
      *o = r.word;
    }
  }
}

// The kernel for the window's K and S (2x2/2, 3x3/2 or 3x3/1), VEC
// elements a thread.
template <typename E, int VEC>
int launch_pool(const void* y, const void* bias, void* out, int64_t batch, int64_t channels,
                int64_t height, int64_t width, int64_t out_height, int64_t out_width, int window,
                int stride, int pad, cudaStream_t stream) {
  using Bits = typename E::Bits;
  const int64_t units = channels / VEC;
  // Strips of output rows where windows overlap down the map, as long as
  // two waves of the card's threads have work.
  int strip = 1;
  if (window > stride) {
    for (strip = kStrip; strip > 1; strip /= 2) {
      const int64_t items = batch * ((out_height + strip - 1) / strip) * out_width * units;
      if (items >= 2 * grid_blocks() * kThreads) break;
    }
  }
  const int64_t n_items = batch * ((out_height + strip - 1) / strip) * out_width * units;
  if (n_items >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = blocks_for(n_items, units);
  auto* kernel = window == 2   ? &bias_act_pool<E, VEC, 2, 2>
                 : stride == 2 ? &bias_act_pool<E, VEC, 3, 2>
                               : &bias_act_pool<E, VEC, 3, 1>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const Bits*>(y), static_cast<const Bits*>(bias), static_cast<Bits*>(out),
      n_items, static_cast<int>(channels), static_cast<int>(height), static_cast<int>(width),
      static_cast<int>(out_height), static_cast<int>(out_width), pad, strip);
  return static_cast<int>(cudaGetLastError());
}

// The widest vector of E that divides the channels and that both maps'
// addresses are aligned to.
template <typename E>
int dispatch_pool(const void* y, const void* bias, void* out, int64_t batch, int64_t channels,
                  int64_t height, int64_t width, int64_t out_height, int64_t out_width, int window,
                  int stride, int pad, cudaStream_t stream) {
  constexpr int kSize = sizeof(typename E::Bits);
  constexpr int kWide = 16 / kSize;
  const uintptr_t address = reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(out);
  auto fits = [&](int vec) { return channels % vec == 0 && address % (vec * kSize) == 0; };
  auto* go = fits(kWide)       ? &launch_pool<E, kWide>
             : fits(kWide / 2) ? &launch_pool<E, kWide / 2>
             : fits(kWide / 4) ? &launch_pool<E, kWide / 4>
                               : &launch_pool<E, 1>;
  return go(y, bias, out, batch, channels, height, width, out_height, out_width, window, stride,
            pad, stream);
}

}  // namespace

// y <- relu?(round(round(y + bias[c]) + residual?)) in place, on `stream`.
// `y` (and `residual`, or NULL) hold `numel` elements of `dtype`
// (Dtype) on the card: channels_last (inner = 1: element i has channel i %
// channels) or NCHW planes of `inner` elements (channel (i / inner) %
// channels). `bias`: `channels` elements of `dtype`. The wrapper
// (kernels/conv_epilogue.py) checks shapes, layouts and devices. Returns
// the launch's cudaError_t.
extern "C" int ssd_conv_epilogue(void* y, const void* bias, const void* residual, int dtype,
                                 long long numel, long long channels, long long inner, int relu,
                                 void* stream) {
  if (numel <= 0) return 0;
  if (channels <= 0 || inner <= 0 || numel % (channels * inner) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch<F32>(y, bias, residual, numel, channels, inner, relu != 0, s);
    case kFloat16:
      return dispatch<F16>(y, bias, residual, numel, channels, inner, relu != 0, s);
    case kBFloat16:
      return dispatch<BF16>(y, bias, residual, numel, channels, inner, relu != 0, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out <- max_pool2d(relu(round(y + bias[c]))) over windows of `window` x
// `window` at `stride`, `pad` (PyTorch's geometry: 2x2/2, 3x3/1 or 3x3/2,
// `pad` under half the window), on `stream`, bit-equal
// to the epilogue then PyTorch's max pool. `y`: a channels_last (batch,
// channels, height, width) map of `dtype` (Dtype); `out`: a channels_last
// (batch, channels, out_height, out_width) map, PyTorch's output size for
// the geometry (the wrapper, kernels/conv_epilogue.py, computes it and
// checks shapes, layouts and devices); `bias`: `channels` elements. `y` is
// not written. Returns the launch's cudaError_t.
extern "C" int ssd_conv_epilogue_pool(const void* y, const void* bias, void* out, int dtype,
                                      long long batch, long long channels, long long height,
                                      long long width, long long out_height, long long out_width,
                                      int window, int stride, int pad, void* stream) {
  if (batch <= 0 || out_height <= 0 || out_width <= 0) return 0;
  // Every window holds at least one element of the map.
  const bool geometry = window == 2 ? stride == 2 : window == 3 && (stride == 1 || stride == 2);
  if (channels <= 0 || height <= 0 || width <= 0 || !geometry || pad < 0 || 2 * pad >= window ||
      (out_height - 1) * stride - pad >= height || (out_width - 1) * stride - pad >= width ||
      height > 0x7fffffff || width > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch_pool<F32>(y, bias, out, batch, channels, height, width, out_height,
                                out_width, window, stride, pad, s);
    case kFloat16:
      return dispatch_pool<F16>(y, bias, out, batch, channels, height, width, out_height,
                                out_width, window, stride, pad, s);
    case kBFloat16:
      return dispatch_pool<BF16>(y, bias, out, batch, channels, height, width, out_height,
                                 out_width, window, stride, pad, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
