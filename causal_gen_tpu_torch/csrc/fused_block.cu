// K2: the body of the "light" residual block in one pass,
//   y = x + conv3x3[b->C](relu(conv3x3[C->b](relu(x)) + b1)) + b2,
// with "SAME" zero padding, float32 accumulation, mid rounded once to x's type
// and y = x + acc rounded once. Null bias pointers give exactly the TPU
// kernel's function.
//
// Replaces the TPU kernel _fused_light_block_kernel (causal_gen_tpu/ops/fused_block.py:51,
// launched by fused_light_block at :190). What it keeps from it: the bottleneck
// tensor mid never goes to device memory. What it drops: the (H, C, W*B)
// batch-on-lanes ring layout, made for the TPU's 128-lane registers. Here the
// tensors are NCHW with OIHW weights, as the port's modules hold them, and the
// storage type is float or bf16 (a template).
//
// Design, simple first: one block of 256 threads per TH x TW output tile of
// one image.
//   1. relu(x) on the tile with a 2-pixel halo, all C channels, goes into
//      shared memory as float (zero outside the image);
//   2. mid on the tile with a 1-pixel halo, all b channels, is computed from
//      there into shared memory: a thread owns one position and up to 8
//      output channels, so each shared-memory read feeds 8 FMAs; mid is zero
//      outside the image (conv2's padding), and stored as relu(round(mid));
//   3. y on the tile from the mid tile, the same way, plus the residual x
//      read back from device memory (the block has just read it; L2).
// Weights are read straight from device memory (uniform across a warp, so a
// broadcast out of L1). The wrapper picks the tile so that the shared memory
// (4 B per element) stays within ~100 KB where it can, and refuses a request
// above the card's 227 KB.
//
// Bound on the H100: bytes at the ukbb192 shapes in bf16 (x read and y
// written once, 4C B a pixel, against 36C*b flops a pixel: 72 flop/B at
// b = C/4, under the card's ~295 flop/B for bf16 tensor cores). This kernel
// runs its FMAs on the CUDA cores in float32, so it is far from that bound;
// tensor cores (mma/wgmma), TMA and a persistent grid are later work.
//
// The multiply-adds are explicit fmaf calls, kept under -fmad=false.
//
// Build (plain C interface, bound with ctypes; see ops/build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // output channels a thread accumulates at once
constexpr int kMaxSmem = 232448;  // 227 KB, the most one block can use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// acc[j] += sum over cin channels and 9 taps of src * w[co0 + j][cin][tap].
// src points at the (0, 0) tap of channel 0 in a tile of row pitch `pitch`
// and channel pitch `plane`; w is OIHW with `cin` input channels.
template <typename T>
__device__ __forceinline__ void conv3x3_acc(float (&acc)[kGroup], const float* src, int plane,
                                            int pitch, const T* __restrict__ w, int cin,
                                            int co0, int nco) {
  for (int ci = 0; ci < cin; ++ci) {
    const float* s = src + ci * plane;
    const T* wp = w + (static_cast<int64_t>(co0) * cin + ci) * 9;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float v = s[(k / 3) * pitch + (k % 3)];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (j < nco) acc[j] = fmaf(v, to_f(wp[static_cast<int64_t>(j) * cin * 9 + k]), acc[j]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_light_block_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                             const T* __restrict__ b1, const T* __restrict__ w2,
                             const T* __restrict__ b2, T* __restrict__ y, int C, int CB, int H,
                             int W, int TH, int TW, int tiles_x) {
  extern __shared__ float smem[];
  const int XH = TH + 4, XW = TW + 4, MH = TH + 2, MW = TW + 2;
  float* xs = smem;                // [C][XH][XW]: relu(x), 2-pixel halo
  float* ms = smem + C * XH * XW;  // [CB][MH][MW]: relu(mid), 1-pixel halo
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int64_t img = static_cast<int64_t>(blockIdx.y) * C * H * W;
  const T* xn = x + img;

  for (int i = threadIdx.x; i < C * XH * XW; i += blockDim.x) {
    const int c = i / (XH * XW);
    const int r = i - c * XH * XW;
    const int gy = ty0 - 2 + r / XW;
    const int gx = tx0 - 2 + r % XW;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = fmaxf(to_f(xn[(static_cast<int64_t>(c) * H + gy) * W + gx]), 0.0f);
    xs[i] = v;
  }
  __syncthreads();

  const int P1 = MH * MW;
  const int G1 = (CB + kGroup - 1) / kGroup;
  for (int it = threadIdx.x; it < G1 * P1; it += blockDim.x) {
    const int g = it / P1;
    const int p = it - g * P1;
    const int my = p / MW, mx = p - (p / MW) * MW;
    const int gy = ty0 - 1 + my, gx = tx0 - 1 + mx;
    const int co0 = g * kGroup;
    const int nco = min(kGroup, CB - co0);
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    float acc[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[j] = 0.0f;
    if (inside) conv3x3_acc(acc, xs + my * XW + mx, XH * XW, XW, w1, C, co0, nco);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < nco) {
        float m = 0.0f;
        if (inside) {
          const float s = b1 != nullptr ? acc[j] + to_f(b1[co0 + j]) : acc[j];
          m = fmaxf(to_f(from_f<T>(s)), 0.0f);
        }
        ms[(co0 + j) * P1 + p] = m;
      }
    }
  }
  __syncthreads();

  const int P2 = TH * TW;
  const int G2 = (C + kGroup - 1) / kGroup;
  for (int it = threadIdx.x; it < G2 * P2; it += blockDim.x) {
    const int g = it / P2;
    const int p = it - g * P2;
    const int oy = p / TW, ox = p - (p / TW) * TW;
    const int gy = ty0 + oy, gx = tx0 + ox;
    if (gy >= H || gx >= W) continue;
    const int co0 = g * kGroup;
    const int nco = min(kGroup, C - co0);
    float acc[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[j] = 0.0f;
    conv3x3_acc(acc, ms + oy * MW + ox, MH * MW, MW, w2, CB, co0, nco);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < nco) {
        const float s = b2 != nullptr ? acc[j] + to_f(b2[co0 + j]) : acc[j];
        const int64_t o = img + (static_cast<int64_t>(co0 + j) * H + gy) * W + gx;
        y[o] = from_f<T>(to_f(x[o]) + s);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* y, int64_t B, int C, int CB, int H, int W, int TH, int TW, int smem,
           cudaStream_t stream) {
  static int smem_set = 48 * 1024;  // the default limit of dynamic shared memory
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_light_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = kMaxSmem;
  }
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const dim3 grid(static_cast<unsigned>(tiles_x * tiles_y), static_cast<unsigned>(B));
  fused_light_block_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(y), C, CB, H, W,
      TH, TW, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): a launch that CUDA refuses never runs, and only this
// return reports it. dtype 0 is float32, 1 is bf16; b1 and b2 may be null.
// smem must be 4 * (C (TH+4)(TW+4) + CB (TH+2)(TW+2)) bytes.
extern "C" int fused_light_block_forward(const void* x, const void* w1, const void* b1,
                                         const void* w2, const void* b2, void* y, int dtype,
                                         int64_t B, int C, int CB, int H, int W, int TH, int TW,
                                         int smem, void* stream) {
  const int64_t need = 4 * (static_cast<int64_t>(C) * (TH + 4) * (TW + 4) +
                            static_cast<int64_t>(CB) * (TH + 2) * (TW + 2));
  if (C <= 0 || CB <= 0 || H <= 0 || W <= 0 || TH <= 0 || TW <= 0 || B > 65535 ||
      smem != need || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w1, b1, w2, b2, y, B, C, CB, H, W, TH, TW, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w1, b1, w2, b2, y, B, C, CB, H, W, TH, TW, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
