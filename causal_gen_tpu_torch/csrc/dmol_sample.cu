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
// K + 3K c + [means | log_scales | coeffs]); x and scale are (B, 3, H, W). One
// thread per pixel reads channel ch at l[b, ch, hw]: neighbouring threads read
// neighbouring addresses. After the pick it reads only the selected mixture's
// mean, log-scale and coeff of each channel (9 of the 9K values).
//
// Random draws. With u_mix (B, K, H, W) and u (B, 3, H, W) given, the kernel
// reads them (the parity mode). With both null it draws them from
// Philox4x32-10 (curand device API, header only): pixel p uses subsequence p
// of stream (seed, offset), K draws for the pick and then 3 for the channels,
// each turned into a uniform from its low 24 bits as _uniform_bits does:
// 1e-5 + (1 - 2e-5) * (bits & 0xFFFFFF) / 2^24. The TPU kernel drew from the
// TPU's own generator (pallas_kernels.py:299); both are held to the law of
// the plain version by statistics.
//
// Bound on the H100: bytes. A pixel needs its 10 logits (40 B), the sectors of
// the 9 selected planes that its warp's picks touch (at most 360 B) and 24 B
// of output, against ~100 float32 operations and ~20 transcendentals (plus
// ~300 integer operations of Philox). At 3.35 TB/s that is far below the
// card's arithmetic rates, so the design is the plain one: one thread per
// pixel in a grid-stride loop, no shared memory, nothing staged.
//
// Build (plain C interface, bound with ctypes; see ops/build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false -shared -Xcompiler -fPIC

#include <cstdint>
#include <cuda_runtime.h>
#include <curand_kernel.h>

namespace {

constexpr float kLo = static_cast<float>(1e-5);
constexpr float kSpan = static_cast<float>((1.0 - 1e-5) - 1e-5);

__device__ __forceinline__ float uniform24(unsigned int bits) {
  const float u01 = static_cast<float>(bits & 0x00FFFFFFu) * (1.0f / 16777216.0f);
  return kLo + kSpan * u01;
}

// clamp to [-1, 1] and max(v, -7) that keep a NaN, as torch.clamp does
__device__ __forceinline__ float clip1(float v) { return v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v); }
__device__ __forceinline__ float floor7(float v) { return v < -7.0f ? -7.0f : v; }

__global__ void dmol_sample_kernel(const float* __restrict__ l,
                                   const float* __restrict__ u_mix,
                                   const float* __restrict__ u,
                                   float* __restrict__ x,
                                   float* __restrict__ scale,
                                   int64_t n_pix,
                                   int64_t hw,
                                   int nr_mix,
                                   float log_t,
                                   unsigned long long seed,
                                   unsigned long long offset) {
  const bool philox = u_mix == nullptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < n_pix;
       p += stride) {
    const int64_t b = p / hw;
    const int64_t s = p - b * hw;
    const float* lp = l + b * 10 * nr_mix * hw + s;
    curandStatePhilox4_32_10_t state;
    if (philox) curand_init(seed, static_cast<unsigned long long>(p), offset, &state);

    int best = 0;
    float best_g = 0.0f;
    for (int k = 0; k < nr_mix; ++k) {
      const float uk = philox ? uniform24(curand(&state)) : u_mix[(b * nr_mix + k) * hw + s];
      const float g = lp[k * hw] - logf(-logf(uk));
      if (k == 0 || g > best_g) {
        best = k;
        best_g = g;
      }
    }

    float y[3], a[3];
    for (int c = 0; c < 3; ++c) {
      const float* blk = lp + static_cast<int64_t>(nr_mix + 3 * nr_mix * c) * hw;
      const float mean = blk[best * hw];
      const float ls = floor7(blk[(nr_mix + best) * hw]) + log_t;
      a[c] = tanhf(blk[(2 * nr_mix + best) * hw]);
      const float v = philox ? uniform24(curand(&state)) : u[(b * 3 + c) * hw + s];
      const float e = expf(ls);
      y[c] = mean + e * (logf(v) - logf(1.0f - v));
      scale[(b * 3 + c) * hw + s] = e;
    }
    const float x0 = clip1(y[0]);
    const float x1 = clip1(y[1] + a[0] * x0);
    const float x2 = clip1(y[2] + a[1] * x0 + a[2] * x1);
    x[(b * 3) * hw + s] = x0;
    x[(b * 3 + 1) * hw + s] = x1;
    x[(b * 3 + 2) * hw + s] = x2;
  }
}

// enough blocks for every pixel up to 8 waves of 132 SMs x 8 blocks; the
// grid-stride loop covers the rest
int grid_for(int64_t n, int threads) {
  const int64_t want = (n + threads - 1) / threads;
  return static_cast<int>(want < 132 * 8 * 8 ? want : 132 * 8 * 8);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): a launch that CUDA refuses never runs, and only this
// return reports it. u_mix and u are both given (the parity mode) or both null
// (Philox). log_t is 0 for t = 1.
extern "C" int dmol_sample_forward(const float* l, const float* u_mix, const float* u,
                                   float* x, float* scale, int64_t n_pix, int64_t hw,
                                   int nr_mix, float log_t, unsigned long long seed,
                                   unsigned long long offset, void* stream) {
  if ((u_mix == nullptr) != (u == nullptr) || hw <= 0 || nr_mix <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pix <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  dmol_sample_kernel<<<grid_for(n_pix, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      l, u_mix, u, x, scale, n_pix, hw, nr_mix, log_t, seed, offset);
  return static_cast<int>(cudaGetLastError());
}
