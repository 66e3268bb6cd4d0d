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
// It launches on the caller's stream and allocates nothing, so a CUDA graph
// can capture it.

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
struct F32 {
  using Bits = uint32_t;
  static __device__ __forceinline__ float load(Bits b) { return __uint_as_float(b); }
  static __device__ __forceinline__ Bits store(float f) { return __float_as_uint(f); }
};
struct F16 {
  using Bits = uint16_t;
  static __device__ __forceinline__ float load(Bits b) {
    return __half2float(__ushort_as_half(b));
  }
  static __device__ __forceinline__ Bits store(float f) {
    return __half_as_ushort(__float2half(f));
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

template <typename E, int VEC, bool PLANAR>
int launch(void* y, const void* bias, const void* residual, int64_t numel, int64_t channels,
           int64_t inner, bool relu, cudaStream_t stream) {
  using Bits = typename E::Bits;
  const int64_t n_vec = numel / VEC;
  // A channels_last grid's threads must be a whole number of pixels'
  // vectors: `blocks` a multiple of q.
  const int64_t units = PLANAR ? 1 : channels / VEC;
  const int64_t q = units / gcd(units, kThreads);
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > grid_blocks()) blocks = grid_blocks();
  blocks = blocks / q * q;
  if (blocks < q) blocks = q;
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
