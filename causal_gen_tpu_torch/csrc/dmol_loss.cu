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
// K + 3K c + [means | log_scales | coeffs]).
//
// What bounds it on the H100. The bytes: the forward reads 412 B a pixel and
// writes 4, the backward reads 412 and writes 400 (4.07 and 7.94 us at
// (32,100,32,32) and 3.35 TB/s). The instructions come close: each of the 30
// (channel, mixture) terms takes accurate transcendentals (expf, two
// sigmoids with IEEE division, logf or log1pf, tanhf for the coupled means),
// and -fmad=false keeps every multiply and add apart, so the instruction
// floor (SASS instructions a pixel over 132 SMs x 4 warp instructions a
// clock) is of the same order as the byte bound. The first design put one thread on a pixel: ~8
// warps an SM, each thread a serial chain of 30 terms and 60 live
// derivatives, 35.75 us forward and 48.30 us backward, latency-bound.
//
// This design puts one thread on each (mixture k, pixel j) of a tile of P
// consecutive flat pixels (P = 64 forward, 32 backward; ops/dmol_loss.py::plan
// gives the grid): a block is K P threads, k = thread / P, so a warp is 32
// consecutive pixels at one k and each of its loads and stores is one
// 128-byte access of one channel. A tile may straddle two images: each
// thread derives its image b and position p. Each thread
//   1. starts its 13 loads (x's 3 values, logit_k, and mean, log-scale and
//      coeff for c = 0..2) before any math;
//   2. computes lp_c,k for c = 0, 1, 2 with the formulas above in the order
//      of the plain version, total_k = ((0 + lp_0) + lp_1) + lp_2, and puts
//      total_k and logit_k in shared memory;
// then, after __syncthreads, the first P threads (one a pixel) run the
// per-pixel reduction over the K values in k order, exactly as the
// one-thread-a-pixel kernel did: log_softmax, logsumexp, and for the
// backward r_k and their sum. The backward leaves r_k, e_k (the softmax's
// numerators), their sums in shared memory; after a second __syncthreads
// each (k, j) thread writes its 10 gradient channels, one coalesced store
// each, from the 6 derivatives and 3 tanh values it kept in registers.
// That is 10x the warps and loads in flight of the first design, a tenth of
// its serial chain, and 6 live derivatives a thread instead of 60.
//
// Rounding: no formula and no order of summation differs from the
// one-thread-a-pixel kernel, and pi_k = e_k / s is the same division done by
// another thread, so both give the same bits. Each formula is written in the
// order of the plain version (ops/dmol.py) and the source is built with
// -fmad=false, so no multiply-add is contracted; sigmoid and softplus are
// PyTorch's own formulas. The kernel then tracks the plain version's
// one-op-at-a-time rounding, which keeps the branch choice at the 1e-5
// switch the same on both. No atomics: two calls give the same bits.
//
// Measured (chip_smoke.py phase K3 on an H100 80GB HBM3 at 700 W; PERF.md §6),
// at (32,100,32,32) from device memory: forward 12.4 us, backward 19.0 us,
// against 35.4 and 48.4 us for the one-thread-a-pixel kernels timed in the
// same call, and byte bounds of 4.07 and 7.94 us. Their SASS, every branch
// counted, runs 291 and 454 warp instructions a pixel: at 132 SMs x 4 warp
// instructions a clock and 1980 MHz a floor of 9.1 and 14.2 us. So both now
// run at 73-75% of the instruction floor, and it, not the bytes, bounds
// them. Tried and slower:
// a per-pixel reduction spread over the K threads (more instructions), and
// the tile's 103 rows staged in shared memory by cp.async on a persistent
// grid (the copy and its barriers cost more than the load latency they
// hide). P = 64 forward and 4 blocks an SM backward each timed faster than
// P = 32 and 3 blocks.
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

// One (channel, mixture) term: lp of x_c under the logistic (mean, ls_raw)
// and, when `grads`, dlp/du and dlp/dls of the selected branch.
template <bool grads>
__device__ __forceinline__ float term(float xc, float mean, float ls_raw, const Consts cst,
                                      float& d_u, float& d_ls) {
  const float lo = static_cast<float>(-0.999);
  const float hi = static_cast<float>(0.999);
  const float switch_at = static_cast<float>(1e-5);
  const float floor12 = static_cast<float>(1e-12);
  const float ls = floor7(ls_raw);
  const float u = xc - mean;
  const float inv = expf(-ls);
  float lp;
  d_u = 0.0f;
  d_ls = 0.0f;
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
  return lp;
}

// What thread (k, j) holds after its loads and its three terms (du and dls
// only when it computed the gradients).
struct Mixture {
  float xs[3];
  float logit;
  float total;
  float ls_raw[3], tanh_a[3];  // the backward's live mask and coupling
  float du[3], dls[3];
};

// Thread (k, j)'s loads, all started before the math, and its three terms.
// lpix[ch * hw] is channel ch of this thread's pixel.
template <bool grads>
__device__ __forceinline__ Mixture mixture_terms(const float* __restrict__ xpix,
                                                 const float* __restrict__ lpix, int64_t hw,
                                                 int k, const Consts cst) {
  Mixture m;
  float mean[3], a[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) m.xs[c] = xpix[c * hw];
  m.logit = lpix[k * hw];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int base = K + 3 * K * c;
    mean[c] = lpix[(base + k) * hw];
    m.ls_raw[c] = lpix[(base + K + k) * hw];
    a[c] = lpix[(base + 2 * K + k) * hw];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) m.tanh_a[c] = tanhf(a[c]);
  // coefficients: tanh(a_0) shifts green by x0, tanh(a_1) and tanh(a_2)
  // shift blue by x0 and x1
  mean[1] = mean[1] + m.tanh_a[0] * m.xs[0];
  mean[2] = (mean[2] + m.tanh_a[1] * m.xs[0]) + m.tanh_a[2] * m.xs[1];
  m.total = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float d_u, d_ls;
    m.total = m.total + term<grads>(m.xs[c], mean[c], m.ls_raw[c], cst, d_u, d_ls);
    if constexpr (grads) {
      m.du[c] = d_u;
      m.dls[c] = d_ls;
    }
  }
  return m;
}

// log_softmax of the logits added into `total`; the softmax's numerators
// into `e` and their sum into `s`
__device__ __forceinline__ void add_log_softmax(const float logits[K], float total[K],
                                                float e[K], float& s) {
  float m = logits[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = logits[k] > m ? logits[k] : m;
  s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    e[k] = expf(logits[k] - m);
    s = s + e[k];
  }
  const float log_s = logf(s);
#pragma unroll
  for (int k = 0; k < K; ++k) total[k] = total[k] + ((logits[k] - m) - log_s);
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

// The tiles ops/dmol_loss.py::plan uses, and the backward's register budget:
// at most 48 registers (8 bytes spill), so that 4 blocks of 320 threads fit an
// SM where 59 registers fit 3. The forward takes 32 registers, 3 blocks of 640.
constexpr int FWD_TILE = 64;
constexpr int BWD_TILE = 32;
constexpr int BWD_MIN_BLOCKS = 4;

// Shared memory of a block, in floats: [K][P] totals (then r_k), [K][P]
// logits (then e_k), [P] sums of e, [P] sums of r. ops/dmol_loss.py::plan
// counts the same bytes.
constexpr int smem_floats(int tile) { return (2 * K + 2) * tile; }

// Thread t of a block: mixture k = t / P of flat pixel i = block P + t % P.
// Returns false for a pixel past the end (a ragged last tile).
template <int P>
__device__ __forceinline__ bool locate(int64_t n_pix, int64_t hw, int& k, int& j, int64_t& i,
                                       int64_t& b, int64_t& p) {
  k = threadIdx.x / P;
  j = threadIdx.x - k * P;
  i = static_cast<int64_t>(blockIdx.x) * P + j;
  if (i >= n_pix) return false;
  // n_pix < 2^31 (the wrapper checks): a 32-bit division
  const uint32_t bb = static_cast<uint32_t>(i) / static_cast<uint32_t>(hw);
  b = bb;
  p = i - b * hw;
  return true;
}

template <int P>
__global__ void __launch_bounds__(K * P)
    dmol_forward_kernel(const float* __restrict__ x, const float* __restrict__ l,
                        float* __restrict__ out, int64_t n_pix, int64_t hw, Consts cst) {
  extern __shared__ float smem[];
  float* s_total = smem;
  float* s_logit = smem + K * P;
  int k, j;
  int64_t i, b, p;
  const bool valid = locate<P>(n_pix, hw, k, j, i, b, p);
  if (valid) {
    const Mixture m =
        mixture_terms<false>(x + b * 3 * hw + p, l + b * 10 * K * hw + p, hw, k, cst);
    s_total[k * P + j] = m.total;
    s_logit[k * P + j] = m.logit;
  }
  __syncthreads();
  if (k == 0 && valid) {
    float total[K], logits[K], e[K], s;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      total[kk] = s_total[kk * P + j];
      logits[kk] = s_logit[kk * P + j];
    }
    add_log_softmax(logits, total, e, s);
    out[i] = logsumexp_(total);
  }
}

template <int P>
__global__ void __launch_bounds__(K * P, BWD_MIN_BLOCKS)
    dmol_backward_kernel(const float* __restrict__ x, const float* __restrict__ l,
                         const float* __restrict__ g, float* __restrict__ dl, int64_t n_pix,
                         int64_t hw, float n_dims, Consts cst) {
  extern __shared__ float smem[];
  float* s_r = smem;            // totals, then r_k
  float* s_e = smem + K * P;    // logits, then e_k
  float* s_esum = smem + 2 * K * P;
  float* s_rsum = s_esum + P;
  int k, j;
  int64_t i, b, p;
  const bool valid = locate<P>(n_pix, hw, k, j, i, b, p);
  Mixture m;
  if (valid) {
    m = mixture_terms<true>(x + b * 3 * hw + p, l + b * 10 * K * hw + p, hw, k, cst);
    s_r[k * P + j] = m.total;
    s_e[k * P + j] = m.logit;
  }
  __syncthreads();
  if (k == 0 && valid) {
    float total[K], logits[K], e[K], s;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      total[kk] = s_r[kk * P + j];
      logits[kk] = s_e[kk * P + j];
    }
    add_log_softmax(logits, total, e, s);
    const float out = logsumexp_(total);
    float rsum = 0.0f;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      const float r = expf(total[kk] - out);
      rsum = rsum + r;
      s_r[kk * P + j] = r;
      s_e[kk * P + j] = e[kk];
    }
    s_esum[j] = s;
    s_rsum[j] = rsum;
  }
  __syncthreads();
  if (!valid) return;
  const float r = s_r[k * P + j];
  const float pi = s_e[k * P + j] / s_esum[j];
  const float G = -(g[b] / n_dims);
  float* dpix = dl + b * 10 * K * hw + p;
  dpix[k * hw] = G * (r - pi * s_rsum[j]);
  const float gr = G * r;
  float dmean[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int base = K + 3 * K * c;
    dmean[c] = -(gr * m.du[c]);  // d/d mean = -d/du
    dpix[(base + k) * hw] = dmean[c];
    const bool live = !(m.ls_raw[c] < -7.0f);
    dpix[(base + K + k) * hw] = live ? gr * m.dls[c] : 0.0f;
  }
  const float* t = m.tanh_a;
  dpix[(K + 2 * K + k) * hw] = (dmean[1] * m.xs[0]) * (1.0f - t[0] * t[0]);
  dpix[(K + 3 * K + 2 * K + k) * hw] = (dmean[2] * m.xs[0]) * (1.0f - t[1] * t[1]);
  dpix[(K + 6 * K + 2 * K + k) * hw] = (dmean[2] * m.xs[1]) * (1.0f - t[2] * t[2]);
}

Consts consts(int low_bit) {
  // the plain version's Python constants, rounded to float32 as PyTorch does
  return low_bit ? Consts{static_cast<float>(1.0 / 31.0), static_cast<float>(2.740840023925201)}
                 : Consts{static_cast<float>(1.0 / 255.0), static_cast<float>(4.848116364598481)};
}

// The launch that ops/dmol_loss.py::plan chose, checked against what the
// kernel takes: its tile, blocks that cover n_pix once, the shared bytes of
// smem_floats, fewer than 2^31 pixels.
bool plan_ok(int64_t n_pix, int64_t hw, int want_tile, int tile, int blocks, int smem_bytes) {
  return tile == want_tile && hw > 0 && n_pix < (int64_t{1} << 31) &&
         blocks == (n_pix + tile - 1) / tile &&
         smem_bytes == smem_floats(tile) * static_cast<int>(sizeof(float));
}

}  // namespace

extern "C" int dmol_num_mixtures() { return K; }

// Each entry point launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): a launch that CUDA refuses never runs, and only this
// return reports it. x (B,3,H,W), l (B,10K,H,W), out (B,H,W), g (B), dl like l;
// all float32, contiguous; n_pix = B*H*W, hw = H*W. tile, blocks and
// smem_bytes are ops/dmol_loss.py::plan's; a plan the kernels do not take
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int dmol_forward(const float* x, const float* l, float* out, int64_t n_pix,
                            int64_t hw, int low_bit, int tile, int blocks, int smem_bytes,
                            void* stream) {
  if (n_pix <= 0) return static_cast<int>(cudaSuccess);
  if (!plan_ok(n_pix, hw, FWD_TILE, tile, blocks, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  dmol_forward_kernel<FWD_TILE><<<blocks, K * FWD_TILE, smem_bytes,
                                  static_cast<cudaStream_t>(stream)>>>(x, l, out, n_pix, hw,
                                                                       consts(low_bit));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dmol_backward(const float* x, const float* l, const float* g, float* dl,
                             int64_t n_pix, int64_t hw, int low_bit, int tile, int blocks,
                             int smem_bytes, void* stream) {
  if (n_pix <= 0) return static_cast<int>(cudaSuccess);
  if (!plan_ok(n_pix, hw, BWD_TILE, tile, blocks, smem_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  dmol_backward_kernel<BWD_TILE><<<blocks, K * BWD_TILE, smem_bytes,
                                   static_cast<cudaStream_t>(stream)>>>(
      x, l, g, dl, n_pix, hw, static_cast<float>(3 * hw), consts(low_bit));
  return static_cast<int>(cudaGetLastError());
}
