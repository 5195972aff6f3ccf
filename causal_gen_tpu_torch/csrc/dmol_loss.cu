// K3: discretized mixture-of-logistics log-prob per pixel, and its gradient.
//
// Replaces the TPU kernel _dmol_kernel (causal_gen_tpu/ops/pallas_kernels.py:158,
// launched by dmol_loss_pallas at :230) and the backward that the JAX package
// takes by autodiff of the pure op (_dmol_bwd, :262-269).
//
// Forward, for each pixel of an RGB image, x in [-1, 1] and K = 10 mixtures:
//   mean_c,k  = m_c,k, + tanh(a_0,k) x0 (green), + tanh(a_1,k) x0 + tanh(a_2,k) x1 (blue)
//   ls_c,k    = max(ls_raw_c,k, -7), inv = exp(-ls), u = x_c - mean_c,k
//   lp_c,k    = log sigmoid(inv (u + hb))               if x_c < -0.999
//             = -softplus(inv (u - hb))                  if x_c >  0.999
//             = log max(cdf_delta, 1e-12)                if cdf_delta > 1e-5
//             = inv u - ls - 2 softplus(inv u) - log 127.5   otherwise
//   total_k   = sum_c lp_c,k + log_softmax(logits)_k,   out = logsumexp_k total_k
// with hb = 1/255 (1/31 and log 15.5 for low_bit). The per-image mean
// -sum(out) / (H W 3) stays in the wrapper.
//
// Backward, given g = d loss / d loss_b per image, G = -(g / (H W 3)):
//   r_k = exp(total_k - out),  pi_k = softmax(logits)_k
//   d logit_k  = G (r_k - pi_k sum_j r_j)
//   d m_c,k    = -G r_k dlp/du,    d ls_raw_c,k = G r_k dlp/dls [ls_raw >= -7]
//   d a_0,k    = -G r_k dlp_1,k/du x0 (1 - tanh^2),  d a_1,k, d a_2,k likewise
//   through the blue mean with x0 and x1.
// dlp/du and dlp/dls are the derivatives of the selected branch only, as the
// gradient of a `where` is; x is data and gets no gradient.
//
// Layout: NCHW, as the port's heads produce it. l is (B, 10K, H, W) with the
// JAX package's channel order ([:K] logits, then per RGB channel c the block
// K + 3K c + [means | log_scales | coeffs]). One thread per pixel reads
// channel ch at stride H*W, so a warp reads 32 neighbouring floats of one
// channel at a time: coalesced, and no transpose to channels-last.
//
// Bound on the H100: bytes. The forward reads 400 + 12 bytes a pixel and
// writes 4; the backward reads 412 and writes 400. Each needs about 1,000
// float32 operations and ~100-200 transcendentals a pixel, well under the
// card's float32 and SFU rates at 3.35 TB/s. So the design is the plain one:
// one thread per pixel, the K-loops unrolled so that the per-(channel,
// mixture) values stay in registers, nothing in shared memory. Only the
// branch that a pixel selects is evaluated.
//
// Rounding: each formula is written in the order of the plain version
// (ops/dmol.py) and the source is built with -fmad=false, so no multiply-add is
// contracted; sigmoid and softplus are PyTorch's own formulas. The kernel then
// tracks the plain version's one-op-at-a-time rounding, which keeps the branch
// choice at the 1e-5 switch the same on both.
//
// Build (plain C interface, bound with ctypes; see ops/build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false -shared -Xcompiler -fPIC

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K = 10;  // mixtures: DmolNet's num_mixtures

struct Consts {
  float half_bin;
  float tail;
};

__device__ __forceinline__ float sigmoid_(float v) { return 1.0f / (1.0f + expf(-v)); }

// PyTorch's softplus (beta 1, threshold 20)
__device__ __forceinline__ float softplus_(float v) { return v > 20.0f ? v : log1pf(expf(v)); }

// max(v, -7) that keeps a NaN, as torch.clamp does
__device__ __forceinline__ float floor7(float v) { return v < -7.0f ? -7.0f : v; }

// One pixel's terms: lp[c][k] and, when `grads`, dlp/du and dlp/dls of the
// selected branch. lpix[ch * hw] is channel ch of this pixel.
template <bool grads>
__device__ __forceinline__ void pixel_terms(const float* __restrict__ lpix, int64_t hw,
                                            const float xs[3], const Consts cst,
                                            float total[K], float du[3][K], float dls[3][K]) {
  const float lo = static_cast<float>(-0.999);
  const float hi = static_cast<float>(0.999);
  const float switch_at = static_cast<float>(1e-5);
  const float floor12 = static_cast<float>(1e-12);
#pragma unroll
  for (int k = 0; k < K; ++k) total[k] = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float xc = xs[c];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int base = K + 3 * K * c;
      float mean = lpix[(base + k) * hw];
      if (c == 1) {
        mean = mean + tanhf(lpix[(K + 2 * K + k) * hw]) * xs[0];
      } else if (c == 2) {
        mean = (mean + tanhf(lpix[(K + 3 * K + 2 * K + k) * hw]) * xs[0]) +
               tanhf(lpix[(K + 6 * K + 2 * K + k) * hw]) * xs[1];
      }
      const float ls = floor7(lpix[(base + K + k) * hw]);
      const float u = xc - mean;
      const float inv = expf(-ls);
      float lp, d_u = 0.0f, d_ls = 0.0f;
      if (xc < lo) {
        const float p = inv * (u + cst.half_bin);
        lp = p - softplus_(p);
        if constexpr (grads) {
          const float s = 1.0f - sigmoid_(p);
          d_u = s * inv;
          d_ls = -(s * p);
        }
      } else if (xc > hi) {
        const float mn = inv * (u - cst.half_bin);
        lp = -softplus_(mn);
        if constexpr (grads) {
          const float s = sigmoid_(mn);
          d_u = -(s * inv);
          d_ls = s * mn;
        }
      } else {
        const float p = inv * (u + cst.half_bin);
        const float mn = inv * (u - cst.half_bin);
        const float sp = sigmoid_(p);
        const float sm = sigmoid_(mn);
        const float cdf_delta = sp - sm;
        if (cdf_delta > switch_at) {
          lp = logf(cdf_delta > floor12 ? cdf_delta : floor12);
          if constexpr (grads) {
            const float dsp = sp * (1.0f - sp);
            const float dsm = sm * (1.0f - sm);
            d_u = inv * (dsp - dsm) / cdf_delta;
            d_ls = (mn * dsm - p * dsp) / cdf_delta;
          }
        } else {
          const float mid = inv * u;
          lp = ((mid - ls) - 2.0f * softplus_(mid)) - cst.tail;
          if constexpr (grads) {
            const float s = 1.0f - 2.0f * sigmoid_(mid);
            d_u = s * inv;
            d_ls = -(s * mid) - 1.0f;
          }
        }
      }
      total[k] = total[k] + lp;
      if constexpr (grads) {
        du[c][k] = d_u;
        dls[c][k] = d_ls;
      }
    }
  }
}

// log_softmax of the logits into `logsm`, and the softmax into `pi` when asked
template <bool want_pi>
__device__ __forceinline__ void log_softmax_(const float logits[K], float logsm[K], float pi[K]) {
  float m = logits[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = logits[k] > m ? logits[k] : m;
  float e[K];
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    e[k] = expf(logits[k] - m);
    s = s + e[k];
  }
  const float log_s = logf(s);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    logsm[k] = (logits[k] - m) - log_s;
    if constexpr (want_pi) pi[k] = e[k] / s;
  }
}

// logsumexp over K, as torch.logsumexp: log(sum exp(t - max)) + max
__device__ __forceinline__ float logsumexp_(const float t[K]) {
  float m = t[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = t[k] > m ? t[k] : m;
  if (isinf(m)) m = 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) s = s + expf(t[k] - m);
  return logf(s) + m;
}

__global__ void dmol_forward_kernel(const float* __restrict__ x, const float* __restrict__ l,
                                    float* __restrict__ out, int64_t n_pix, int64_t hw,
                                    Consts cst) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_pix;
       i += stride) {
    const int64_t b = i / hw;
    const int64_t p = i - b * hw;
    const float* xpix = x + b * 3 * hw + p;
    const float* lpix = l + b * 10 * K * hw + p;
    const float xs[3] = {xpix[0], xpix[hw], xpix[2 * hw]};
    float total[K];
    pixel_terms<false>(lpix, hw, xs, cst, total, nullptr, nullptr);
    float logits[K], logsm[K];
#pragma unroll
    for (int k = 0; k < K; ++k) logits[k] = lpix[k * hw];
    log_softmax_<false>(logits, logsm, nullptr);
#pragma unroll
    for (int k = 0; k < K; ++k) total[k] = total[k] + logsm[k];
    out[i] = logsumexp_(total);
  }
}

__global__ void dmol_backward_kernel(const float* __restrict__ x, const float* __restrict__ l,
                                     const float* __restrict__ g, float* __restrict__ dl,
                                     int64_t n_pix, int64_t hw, float n_dims, Consts cst) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_pix;
       i += stride) {
    const int64_t b = i / hw;
    const int64_t p = i - b * hw;
    const float* xpix = x + b * 3 * hw + p;
    const float* lpix = l + b * 10 * K * hw + p;
    float* dpix = dl + b * 10 * K * hw + p;
    const float xs[3] = {xpix[0], xpix[hw], xpix[2 * hw]};
    float total[K], du[3][K], dls[3][K];
    pixel_terms<true>(lpix, hw, xs, cst, total, du, dls);
    float logits[K], logsm[K], pi[K];
#pragma unroll
    for (int k = 0; k < K; ++k) logits[k] = lpix[k * hw];
    log_softmax_<true>(logits, logsm, pi);
#pragma unroll
    for (int k = 0; k < K; ++k) total[k] = total[k] + logsm[k];
    const float out = logsumexp_(total);
    const float G = -(g[b] / n_dims);
    float r[K];
    float rsum = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      r[k] = expf(total[k] - out);
      rsum = rsum + r[k];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      dpix[k * hw] = G * (r[k] - pi[k] * rsum);
      const float gr = G * r[k];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int base = K + 3 * K * c;
        const float dmean = -(gr * du[c][k]);  // d/d mean = -d/du
        dpix[(base + k) * hw] = dmean;
        const bool live = !(lpix[(base + K + k) * hw] < -7.0f);
        dpix[(base + K + k) * hw] = live ? gr * dls[c][k] : 0.0f;
      }
      // coefficients: tanh(a_0) shifts green by x0, tanh(a_1) and tanh(a_2)
      // shift blue by x0 and x1
      const float dm1 = -(gr * du[1][k]);
      const float dm2 = -(gr * du[2][k]);
      const float t0 = tanhf(lpix[(K + 2 * K + k) * hw]);
      const float t1 = tanhf(lpix[(K + 3 * K + 2 * K + k) * hw]);
      const float t2 = tanhf(lpix[(K + 6 * K + 2 * K + k) * hw]);
      dpix[(K + 2 * K + k) * hw] = (dm1 * xs[0]) * (1.0f - t0 * t0);
      dpix[(K + 3 * K + 2 * K + k) * hw] = (dm2 * xs[0]) * (1.0f - t1 * t1);
      dpix[(K + 6 * K + 2 * K + k) * hw] = (dm2 * xs[1]) * (1.0f - t2 * t2);
    }
  }
}

Consts consts(int low_bit) {
  // the plain version's Python constants, rounded to float32 as PyTorch does
  return low_bit ? Consts{static_cast<float>(1.0 / 31.0), static_cast<float>(2.740840023925201)}
                 : Consts{static_cast<float>(1.0 / 255.0), static_cast<float>(4.848116364598481)};
}

// enough blocks for every pixel up to 8 waves of 132 SMs x 8 blocks; the
// grid-stride loop covers the rest
int grid_for(int64_t n, int threads) {
  const int64_t want = (n + threads - 1) / threads;
  return static_cast<int>(want < 132 * 8 * 8 ? want : 132 * 8 * 8);
}

}  // namespace

extern "C" int dmol_num_mixtures() { return K; }

// Each entry point launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): a launch that CUDA refuses never runs, and only this
// return reports it. x (B,3,H,W), l (B,10K,H,W), out (B,H,W), g (B), dl like l;
// all float32, contiguous; n_pix = B*H*W, hw = H*W.
extern "C" int dmol_forward(const float* x, const float* l, float* out, int64_t n_pix,
                            int64_t hw, int low_bit, void* stream) {
  if (n_pix <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 128;
  dmol_forward_kernel<<<grid_for(n_pix, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, l, out, n_pix, hw,
                                                             consts(low_bit));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dmol_backward(const float* x, const float* l, const float* g, float* dl,
                             int64_t n_pix, int64_t hw, int low_bit, void* stream) {
  if (n_pix <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 128;
  dmol_backward_kernel<<<grid_for(n_pix, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, l, g, dl, n_pix, hw, static_cast<float>(3 * hw), consts(low_bit));
  return static_cast<int>(cudaGetLastError());
}
