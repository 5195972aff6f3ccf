// K1: fused reparameterised Gaussian sample + per-element Gaussian KL, and its
// backward.
//
// Replaces the TPU kernel _sample_kl_kernel (causal_gen_tpu/ops/pallas_kernels.py:54,
// launched by fused_sample_kl at :109) and its custom VJP (_fskl_fwd/_fskl_bwd,
// :131-147). Forward, for each element, in float32:
//   z  = q_loc + exp(q_logscale) * eps
//   kl = -1/2 + p_ls - q_ls + 1/2 (exp(q_ls)^2 + (q_loc - p_loc)^2) / exp(p_ls)^2
// Backward, from the saved (q_loc, q_ls, p_loc, p_ls, z) and the cotangents
// (gz, gkl), with s = exp(q_ls)^2, ip = exp(-p_ls)^2, d = q_loc - p_loc:
//   d_qloc = gz + gkl d ip            d_qls = gz (z - q_loc) + gkl (s ip - 1)
//   d_ploc = -gkl d ip                d_pls = gkl (1 - (s + d^2) ip)
// The reparameterisation term gz (z - q_loc) is exp(q_ls) * eps without eps,
// which the Philox path never stores.
//
// Bound on the H100: bytes. The forward reads four inputs (plus eps when it is
// given) and writes two outputs, 24 or 28 bytes against ~20 flops; the backward
// reads six and writes four, 40 bytes against ~20 flops. Both sit far below the
// card's ~20 flop/byte balance for float32. So the design is the plain one: one
// thread per element in a grid-stride loop, coalesced 4-byte loads, no shared
// memory. The spatial KL sum stays outside (hvae.py sums the kl map), so gkl
// reaches the backward as a broadcast of one value per (batch, channel): the
// kernel reads that value as gkl[i / gkl_rep] and never materialises the
// broadcast (gkl_rep = H*W there, 1 for a full map).
//
// eps == nullptr draws eps in the kernel from Philox4x32-10 (curand device API,
// header only): element i uses subsequence i of stream (seed, offset). The TPU
// kernel drew its own in-kernel stream too (pallas_kernels.py:9-13); both paths
// are deterministic per seed and are held against each other by statistics.
//
// The arithmetic uses the _rn intrinsics in the plain version's order so that
// nvcc does not contract it into FMAs: the kernel then rounds as PyTorch's
// elementwise ops do, one operation at a time.
//
// Build (plain C interface, bound with ctypes; see ops/build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

#include <cstdint>
#include <cuda_runtime.h>
#include <curand_kernel.h>

namespace {

__global__ void sample_kl_kernel(const float* __restrict__ q_loc,
                                 const float* __restrict__ q_logscale,
                                 const float* __restrict__ p_loc,
                                 const float* __restrict__ p_logscale,
                                 const float* __restrict__ eps,
                                 float* __restrict__ z,
                                 float* __restrict__ kl,
                                 int64_t n,
                                 unsigned long long seed,
                                 unsigned long long offset) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float e;
    if (eps != nullptr) {
      e = eps[i];
    } else {
      curandStatePhilox4_32_10_t state;
      curand_init(seed, static_cast<unsigned long long>(i), offset, &state);
      e = curand_normal(&state);
    }
    const float ql = q_loc[i];
    const float qs = q_logscale[i];
    const float pl = p_loc[i];
    const float ps = p_logscale[i];
    const float sq = expf(qs);
    z[i] = __fadd_rn(ql, __fmul_rn(sq, e));
    const float d = __fsub_rn(ql, pl);
    const float num = __fadd_rn(__fmul_rn(sq, sq), __fmul_rn(d, d));
    const float sp = expf(ps);
    const float quad = __fdiv_rn(__fmul_rn(0.5f, num), __fmul_rn(sp, sp));
    kl[i] = __fadd_rn(__fsub_rn(__fadd_rn(-0.5f, ps), qs), quad);
  }
}

__global__ void sample_kl_backward_kernel(const float* __restrict__ q_loc,
                                          const float* __restrict__ q_logscale,
                                          const float* __restrict__ p_loc,
                                          const float* __restrict__ p_logscale,
                                          const float* __restrict__ z,
                                          const float* __restrict__ gz,
                                          const float* __restrict__ gkl,
                                          int64_t gkl_rep,
                                          float* __restrict__ d_qloc,
                                          float* __restrict__ d_qls,
                                          float* __restrict__ d_ploc,
                                          float* __restrict__ d_pls,
                                          int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float ql = q_loc[i];
    const float qs = q_logscale[i];
    const float pl = p_loc[i];
    const float ps = p_logscale[i];
    const float g_z = gz != nullptr ? gz[i] : 0.0f;
    const float g_kl = gkl != nullptr ? gkl[i / gkl_rep] : 0.0f;
    const float sq = expf(qs);
    const float s_q2 = __fmul_rn(sq, sq);
    const float ip = expf(-ps);
    const float inv_p2 = __fmul_rn(ip, ip);
    const float diff = __fsub_rn(ql, pl);
    const float gdi = __fmul_rn(__fmul_rn(g_kl, diff), inv_p2);
    d_qloc[i] = __fadd_rn(g_z, gdi);
    d_qls[i] = __fadd_rn(__fmul_rn(g_z, __fsub_rn(z[i], ql)),
                         __fmul_rn(g_kl, __fsub_rn(__fmul_rn(s_q2, inv_p2), 1.0f)));
    d_ploc[i] = -gdi;
    d_pls[i] = __fmul_rn(g_kl, __fsub_rn(1.0f, __fmul_rn(__fadd_rn(s_q2, __fmul_rn(diff, diff)),
                                                         inv_p2)));
  }
}

// enough blocks for every element up to 8 waves of 132 SMs x 8 blocks; the
// grid-stride loop covers the rest
int grid_for(int64_t n, int threads) {
  const int64_t want = (n + threads - 1) / threads;
  return static_cast<int>(want < 132 * 8 * 8 ? want : 132 * 8 * 8);
}

}  // namespace

// Each entry point launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(): a launch that CUDA refuses never runs, and only this
// return reports it.
extern "C" int sample_kl_forward(const float* q_loc, const float* q_logscale,
                                 const float* p_loc, const float* p_logscale,
                                 const float* eps, float* z, float* kl, int64_t n,
                                 unsigned long long seed, unsigned long long offset,
                                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  sample_kl_kernel<<<grid_for(n, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      q_loc, q_logscale, p_loc, p_logscale, eps, z, kl, n, seed, offset);
  return static_cast<int>(cudaGetLastError());
}

// gz or gkl may be null (an output no loss reads): its terms are then zero.
extern "C" int sample_kl_backward(const float* q_loc, const float* q_logscale,
                                  const float* p_loc, const float* p_logscale,
                                  const float* z, const float* gz, const float* gkl,
                                  int64_t gkl_rep, float* d_qloc, float* d_qls,
                                  float* d_ploc, float* d_pls, int64_t n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (gkl_rep <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  sample_kl_backward_kernel<<<grid_for(n, threads), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      q_loc, q_logscale, p_loc, p_logscale, z, gz, gkl, gkl_rep, d_qloc, d_qls, d_ploc,
      d_pls, n);
  return static_cast<int>(cudaGetLastError());
}
