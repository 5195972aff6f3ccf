// K4: discretized mixture-of-logistics sampler, one pass per pixel.
//
// Replaces the TPU kernel _dmol_sample_kernel (causal_gen_tpu/ops/pallas_kernels.py:288,
// launched by dmol_sample_pallas at :342, uniforms from _uniform_bits at :280).
// For each pixel of an RGB image with K mixtures, in float32:
//   k*   = first argmax_k  logit_k - log(-log(u_k))           (Gumbel-max pick)
//   ls_c = max(ls_raw_c,k*, -7) + log t,   a_c = tanh(coeff_raw_c,k*)
//   y_c  = mean_c,k* + exp(ls_c) (log v_c - log(1 - v_c))      (logistic inverse CDF)
//   x0 = clip(y0),  x1 = clip(y1 + a0 x0),  x2 = clip(y2 + a1 x0 + a2 x1)   (clip to [-1, 1])
// and writes x and scale = exp(ls). The uniforms u_k and v_c lie in [1e-5, 1 - 1e-5).
// These are the formulas of the plain version (ops/dmol.py::
// sample_from_discretized_mix_logistic) in its order; the source is built with
// -fmad=false, so no multiply-add is contracted and, given the same uniforms,
// the kernel rounds as the plain version does.
//
// Ties: the kernel takes the first of equal perturbed logits, as argmax in the
// plain version does; the Pallas kernel splits the one-hot evenly between them.
// A tie of two perturbed logits has probability zero, so the two agree in law.
//
// Layout: NCHW, as the port's heads produce it. l is (B, 10K, H, W) with the
// JAX package's channel order ([:K] logits, then per RGB channel c the block
// K + 3K c + [means | log_scales | coeffs]); x and scale are (B, 3, H, W).
//
// Random draws. With u_mix (B, K, H, W) and u (B, 3, H, W) given, the kernel
// reads them (the parity mode). With both null it draws them from
// Philox4x32-10 (curand device API, header only): pixel p uses subsequence p
// of stream (seed, offset), draw j (j < K for the pick, K + c for channel c)
// at position offset + j, each turned into a uniform from its low 24 bits as
// _uniform_bits does: 1e-5 + (1 - 2e-5) * (bits & 0xFFFFFF) / 2^24. The TPU
// kernel drew from the TPU's own generator (pallas_kernels.py:299); both are
// held to the law of the plain version by statistics.
//
// Bound on the H100: bytes. A pixel needs its K logits (40 B at K = 10), the
// sectors of the 9 selected planes that its warp's picks touch (at most
// 360 B) and 24 B of output, against ~100 float32 operations and ~20
// transcendentals (plus Philox's integer work). The first version ran one
// thread a pixel: a chain of K draws (curand_init evaluating Philox 2-3 times
// each), K logs, the pick, then 9 gathered loads that wait on it and 3
// channels' math, at one block of 256 threads an SM at (32,100,32,32). Here:
//   1. A block takes 32 consecutive flat pixels (a tile may hold the end of
//      one image and the start of the next) and one warp a mixture k: lane i
//      reads pixel i's logit_k (one coalesced 128-byte row a warp), draws u_k
//      (word offset + k of its pixel's Philox stream, one evaluation, see
//      philox_uniform) or takes the injected one, and stores g_k = logit_k -
//      log(-log u_k) in shared memory; warps K..K+2 (cycling) draw or take
//      channel c's v there too, so no draw waits on the pick.
//   2. After a barrier, warp c < 3 takes channel c of the 32 pixels: each
//      lane picks the first argmax of g in k order (the same comparisons as
//      the first version, so the same pick), gathers its channel's mean,
//      log-scale and coeff at the pick (3 loads in flight, the second trip to
//      device memory) and writes scale; y_c and tanh(coeff) go to shared
//      memory.
//   3. After a second barrier, warp 0 runs the clip chain and writes x.
// At 32 registers a thread 6 blocks of 320 threads fit an SM, so the grid is
// ~1.3 waves. Tried and slower on the card: copying every plane of a tile
// (400 B a pixel) into shared memory by cp.async first, to make one trip of
// the two (the copy alone took longer than the whole kernel); the same with
// plain loads; the pick spread over a tile without the draws moved ahead.
// Every formula is the plain version's in its order, so the outputs are the
// first version's bits (chip_smoke.py::k4_time hashes them). Reached on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, (32,100,32,32) from device
// memory): 8.98 us with Philox, 8.55 us injected; the first version 10.7 and
// 11.1 us in the same call.
//
// Build (plain C interface, bound with ctypes; see ops/build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false -shared -Xcompiler -fPIC

#include <cstdint>
#include <cuda_runtime.h>
#include <curand_kernel.h>

namespace {

constexpr int kTile = 32;  // flat pixels a block: a warp's lanes
constexpr int kMaxWarps = 32;  // a block's warps: one a mixture up to 32, at least 3
constexpr float kLo = static_cast<float>(1e-5);
constexpr float kSpan = static_cast<float>((1.0 - 1e-5) - 1e-5);

__device__ __forceinline__ float uniform24(unsigned int bits) {
  const float u01 = static_cast<float>(bits & 0x00FFFFFFu) * (1.0f / 16777216.0f);
  return kLo + kSpan * u01;
}

// Draw j of pixel p's stream: word offset + j of subsequence p, one
// Philox4x32-10 block. curand_init(seed, p, offset + j) followed by curand()
// returns the same word: it sets the counter's high 64 bits to p and its low
// 64 bits to (offset + j) / 4 (offset < 2^62: no carry) and takes word
// (offset + j) % 4 of the block, but evaluates Philox once more for each
// skip; here the block is evaluated once.
__device__ __forceinline__ float philox_uniform(unsigned long long seed, int64_t p,
                                                unsigned long long offset, int j) {
  const unsigned long long pos = offset + static_cast<unsigned long long>(j);
  const unsigned long long blk = pos >> 2;
  const unsigned long long sub = static_cast<unsigned long long>(p);
  const uint4 ctr =
      make_uint4(static_cast<unsigned int>(blk), static_cast<unsigned int>(blk >> 32),
                 static_cast<unsigned int>(sub), static_cast<unsigned int>(sub >> 32));
  const uint2 key =
      make_uint2(static_cast<unsigned int>(seed), static_cast<unsigned int>(seed >> 32));
  const uint4 out = curand_Philox4x32_10(ctr, key);
  const unsigned int w = pos & 3;
  return uniform24(w == 0 ? out.x : (w == 1 ? out.y : (w == 2 ? out.z : out.w)));
}

// clamp to [-1, 1] and max(v, -7) that keep a NaN, as torch.clamp does
__device__ __forceinline__ float clip1(float v) { return v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v); }
__device__ __forceinline__ float floor7(float v) { return v < -7.0f ? -7.0f : v; }

// shared memory, floats, [...][kTile] each: K perturbed logits, then the 3
// channels' v, y and tanh(coeff)
__global__ void __launch_bounds__(kTile * kMaxWarps) dmol_sample_kernel(
    const float* __restrict__ l, const float* __restrict__ u_mix, const float* __restrict__ u,
    float* __restrict__ x, float* __restrict__ scale, int64_t n_pix, int64_t hw, int nr_mix,
    float log_t, unsigned long long seed, unsigned long long offset) {
  extern __shared__ __align__(16) float sm[];
  const int K = nr_mix;
  float* gs = sm;
  float* vs = gs + K * kTile;
  float* ys = vs + 3 * kTile;
  float* as = ys + 3 * kTile;
  const bool philox = u_mix == nullptr;
  const int lane = threadIdx.x % kTile, warp = threadIdx.x / kTile;
  const int warps = blockDim.x / kTile;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kTile + lane;
  const bool live = p < n_pix;
  const int64_t b = live ? p / hw : 0;
  const int64_t s = live ? p - b * hw : 0;
  const float* lp = l + b * 10 * K * hw + s;
  if (live) {
    for (int k = warp; k < K + 3; k += warps) {
      if (k < K) {
        const float logit = lp[k * hw];
        const float uk =
            philox ? philox_uniform(seed, p, offset, k) : u_mix[(b * K + k) * hw + s];
        gs[k * kTile + lane] = logit - logf(-logf(uk));
      } else {
        vs[(k - K) * kTile + lane] =
            philox ? philox_uniform(seed, p, offset, k) : u[(b * 3 + k - K) * hw + s];
      }
    }
  }
  __syncthreads();
  if (live && warp < 3) {
    int best = 0;
    float best_g = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float g = gs[k * kTile + lane];
      if (k == 0 || g > best_g) {
        best = k;
        best_g = g;
      }
    }
    const int c = warp;
    const float* blk = lp + static_cast<int64_t>(K + 3 * K * c + best) * hw;
    const float mean = blk[0];
    const float lraw = blk[K * hw];
    const float craw = blk[2 * K * hw];
    const float lsc = floor7(lraw) + log_t;
    as[c * kTile + lane] = tanhf(craw);
    const float v = vs[c * kTile + lane];
    const float e = expf(lsc);
    ys[c * kTile + lane] = mean + e * (logf(v) - logf(1.0f - v));
    scale[(b * 3 + c) * hw + s] = e;
  }
  __syncthreads();
  if (live && warp == 0) {
    const float x0 = clip1(ys[lane]);
    const float x1 = clip1(ys[kTile + lane] + as[lane] * x0);
    const float x2 =
        clip1(ys[2 * kTile + lane] + as[kTile + lane] * x0 + as[2 * kTile + lane] * x1);
    x[(b * 3) * hw + s] = x0;
    x[(b * 3 + 1) * hw + s] = x1;
    x[(b * 3 + 2) * hw + s] = x2;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): a launch that CUDA refuses never runs, and only this
// return reports it. u_mix and u are both given (the parity mode) or both null
// (Philox). log_t is 0 for t = 1. One block of `threads` (32 a warp, one warp
// a mixture up to kMaxWarps, at least 3) a tile of kTile flat pixels, and
// `smem` = 4 kTile (K + 9) bytes: ops/dmol_sample.py::plan.
extern "C" int dmol_sample_forward(const float* l, const float* u_mix, const float* u,
                                   float* x, float* scale, int64_t n_pix, int64_t hw,
                                   int nr_mix, float log_t, unsigned long long seed,
                                   unsigned long long offset, int threads, int smem,
                                   void* stream) {
  const int warps = nr_mix < 3 ? 3 : (nr_mix < kMaxWarps ? nr_mix : kMaxWarps);
  if ((u_mix == nullptr) != (u == nullptr) || hw <= 0 || nr_mix <= 0 || n_pix < 0 ||
      n_pix % hw || threads != kTile * warps || smem != 4 * kTile * (nr_mix + 9) ||
      (n_pix + kTile - 1) / kTile > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pix == 0) return static_cast<int>(cudaSuccess);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(dmol_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dmol_sample_kernel<<<static_cast<unsigned>((n_pix + kTile - 1) / kTile), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      l, u_mix, u, x, scale, n_pix, hw, nr_mix, log_t, seed, offset);
  return static_cast<int>(cudaGetLastError());
}
