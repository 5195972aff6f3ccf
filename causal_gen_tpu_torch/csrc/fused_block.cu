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
// tensors are NCHW with OIHW weights, as the port's modules hold them.
//
// Two kernels; the storage type alone chooses (ops/fused_block.py):
//
// bf16: fused_light_block_kernel_tc, both convs as implicit GEMMs on the
// tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulate).
//   1. Staging: the block's x region (its output tile plus a 2-pixel halo,
//      cut at the image's edge) of NI images goes into shared memory once,
//      as bf16 with channels innermost, [image][y][x][c], channels zero-padded
//      to Cp (a multiple of 16, the MMA's k) and every row padded by 8
//      elements so that ldmatrix's eight 16-byte rows fall in distinct banks.
//      A tap that reads outside the image reads one shared zero row instead.
//   2. conv1: M = the mid region's positions (tile plus 1-pixel halo, inside
//      the image), N = b padded to 16, K = taps x Cp, one tap at a time (a tap
//      is a shifted view of the x region). A comes from ldmatrix, relu'd in
//      registers; B from ldmatrix on the weights. The epilogue adds b1,
//      rounds to bf16, applies relu and stores mid in shared memory
//      ([image][y][x][b], channels padded to 16, so b = 8, 24, 40 work).
//   3. conv2: M = the output positions, N = C, K = taps x b padded; the
//      epilogue adds b2 and x (read from the staged tile, not from device
//      memory) in float32 and rounds y once.
//   Weights: repacked by the kernel from OIHW into shared memory as
//   [tap][out channel][in channel] (the B-fragment layout ldmatrix wants),
//   each conv's weights in turn into one buffer, read 16 bytes a thread
//   where all 9 taps are wanted. Where a conv's weights fit beside the tile
//   (every ukbb192 shape) they stay for the whole conv ("resident");
//   otherwise one tap of a pass at a time is staged with plain loads (a
//   repack from OIHW cannot be a cp.async copy), between two barriers
//   ("streamed"). A tap whose window lies wholly in the padding (every tap
//   but the centre at 1x1) is neither staged nor multiplied. Where the image
//   is smaller than 16 positions, a block takes NI images, so one staging of
//   the weights serves NI times the rows.
//   A warp takes 2 m16 tiles of positions and a pass of 16 or 32 (conv1) or
//   32 (conv2) output channels; the staged weight rows are zero up to a
//   whole pass, so the MMAs run unpredicated. A block has 256 threads where
//   two fit an SM, else 512: the kernel is bound by the latency of its
//   ldmatrix -> mma chains and needs the warps.
//   Why mma.sync and not wgmma/TMA: at b = C/4 the block does 72 flop a byte
//   of x and y, under the H100's ~295 flop/B for bf16, so bytes bound it at
//   192^2 to 24^2 (45.1, 22.5, 8.5 and 2.9 us at ukbb192's shapes, bs 32; at
//   (32,32,192,192) b=8 the tensor cores' share at peak is 11 us); mma.sync
//   at a fraction of the peak can reach the byte bound there. Flops bound it
//   at 12^2 and 6^2 (1.07 and 0.39 us) and the weights' bytes at 1^2
//   (0.72 us). TMA, wgmma and a persistent grid are later work.
//   Reached on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, bs 32, with
//   biases): 397.6, 204.9, 92.2, 46.6, 46.8, 48.4 and 75.2 us at 192^2, 96^2,
//   48^2, 24^2, 12^2, 6^2 and 1^2; 17.7 ms summed over a ukbb192
//   DSCM.forward's 200 launches, against 28.6 ms for cuDNN's conv pair.
//
// float32: fused_light_block_kernel_f32, both convs as implicit GEMMs on the
// CUDA cores in full float32 (the tensor cores have no full-float32 path, and
// TF32 would not hold float32's 1e-5 check). 36 C b flops a pixel against
// 8 C bytes of x and y: at 67 TFLOP/s flops bound it at every ukbb shape
// but 1^2 (162.3 us at (32,32,192,192) b=8, 18.0 us at each ukbb64 shape to
// 4^2), so the design is a register-tiled SGEMM:
//   1. Canvases: x on the tile with a 2-pixel ring, and mid with a 1-pixel
//      ring, plane-major [channel][row][column] in shared memory, zero
//      outside the image. A whole image may share a block with others (NI),
//      side by side with one zero column between two; at 1x1 the block's
//      images are one row and only the centre tap runs.
//   2. Each conv: a lane holds a segment of 4 positions along a canvas row by
//      NG (8 or 16) output channels in registers. For each input channel and
//      tap row it reads 6 canvas values (16 + 8 bytes), which the row's 3
//      taps share (conv1 applies relu to them), and for each tap NG weights
//      (16-byte reads, one address across the warp): 12-14 fmaf a
//      shared-memory read, no device memory in the loop. Lane-items (groups
//      slowest) fill the block in rounds.
//   3. Chunks: the input channels go through two buffers in chunks of KC,
//      each staged by 4-byte cp.async one chunk ahead: conv1's x canvas and
//      weights, conv2's weights (mid stays whole). The weights are repacked
//      from OIHW into [channel][tap][output] on the way. A conv of one chunk
//      keeps it for all its rounds.
//   4. conv1's epilogue adds b1 and stores relu(mid) (0 outside the image)
//      in the mid canvas; conv2's adds b2 and x (read from device memory,
//      16 bytes a lane where the tile is aligned) and writes y.
//   5. Small images (24^2 and below at the ukbb widths) give a block few
//      positions and all of both convs' weights to stream. There a
//      thread-block cluster of CS blocks takes one tile: block r computes
//      slice r of mid's channels, the blocks copy each other's slices into
//      their own mid canvas through distributed shared memory, and block r
//      computes slice r of y's channels, so each streams 1/CS of the weights.
//   ops/fused_block.py::plan picks the tile, images, chunk, NG and cluster:
//   at the ukbb shapes (bs 32) the fastest measured (F32_TUNED), elsewhere
//   by a count of lane-slots, barriers and staging. Reached on an NVIDIA
//   H100 80GB HBM3 at 700 W (chip_smoke.py, bs 32, with biases): 71.0, 87.1,
//   118.1, 223.0, 351.4 and 127.1 us at ukbb64's 64^2 to 1^2, 44.6 ms over
//   its DSCM.forward's 362 launches (the cuDNN pair 39.4 ms); 579.3 us at
//   (32,32,192,192) b=8 (the pair 1465.9 us). Tried and
//   slower on the card: 8 positions a lane (spills), the channel loop
//   unrolled twice, a lane-item's input channels split across 2 or 4 lanes
//   (their reads no longer broadcast), x resident for all C channels (small
//   tiles at C >= 64), and (the first version's design) one position a lane with weights
//   read from device memory in the loop.
//
// The multiply-adds are explicit fmaf calls or MMAs, kept under -fmad=false.
//
// Build (plain C interface, bound with ctypes; see ops/build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 232448;  // 227 KB, the most one block can use

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernel.

constexpr int kMaxThreads = 512;  // 256 or 512 threads a block: ops/fused_block.py::plan
constexpr int kPad = 8;     // bf16 elements added to every shared-memory row
constexpr int kMtW = 2;     // m16 tiles of a warp's item
constexpr int kUnroll = 4;  // staging: loads a thread issues before it stores

__host__ __device__ __forceinline__ int ceil16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ __forceinline__ int ceil32(int v) { return (v + 31) / 32 * 32; }
// n8 tiles of a conv1 pass: 32 mid channels where b padded to 16 is a
// multiple of 32, else 16; conv2's passes are of 32 output channels
__host__ __device__ __forceinline__ int conv1_nt(int CB) { return ceil16(CB) % 32 ? 2 : 4; }

// Elements of shared memory, by region, as ops/fused_block.py::tc_smem_bytes
// counts them; the byte count is twice the sum.
struct TcLayout {
  int zero, x, mid, w;
  __host__ __device__ TcLayout(int C, int CB, int H, int W, int TH, int TW, int NI,
                               int resident) {
    const int cp = ceil16(C), cbp = ceil16(CB);
    const int xh = TH + 4 < H ? TH + 4 : H, xw = TW + 4 < W ? TW + 4 : W;
    const int mh = TH + 2 < H ? TH + 2 : H, mw = TW + 2 < W ? TW + 2 : W;
    const int taps = (H > 1 ? 3 : 1) * (W > 1 ? 3 : 1);
    zero = (cp > cbp ? cp : cbp) + kPad;
    x = NI * xh * xw * (cp + kPad);
    mid = NI * mh * mw * (cbp + kPad);
    // weight rows staged: every pass's (resident) or one pass's (streamed)
    const int r1 = resident ? cbp : conv1_nt(CB) * 8, r2 = resident ? ceil32(C) : 32;
    const int t = resident ? taps : 1;
    const int w1 = t * r1 * (cp + kPad), w2 = t * r2 * (cbp + kPad);
    w = w1 > w2 ? w1 : w2;
  }
  __host__ __device__ int64_t bytes() const {
    return 2 * (static_cast<int64_t>(zero) + x + mid + w);
  }
};

struct TcArgs {
  const uint16_t* x;  // bf16 bits
  const uint16_t* w1;
  const uint16_t* b1;
  const uint16_t* w2;
  const uint16_t* b2;
  uint16_t* y;
  int B, C, CB, H, W, TH, TW, NI, tiles_x, resident;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// relu of two packed bf16 (a NaN stays NaN, as in F.relu)
__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hmax2_nan(h, __nv_bfloat162(__ushort_as_bfloat16(0), __ushort_as_bfloat16(0)));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_bits_to_f(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ uint16_t f_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// q / d for 0 <= q, d < 2^16 as one multiply-high by m = ceil(2^32 / d)
struct FastDiv {
  int d;
  uint32_t m;
  __device__ explicit FastDiv(int d_)
      : d(d_), m(d_ > 1 ? static_cast<uint32_t>((0x100000000ull + d_ - 1) / d_) : 0u) {}
  __device__ __forceinline__ int div(int q) const {
    return d > 1 ? static_cast<int>(__umulhi(static_cast<uint32_t>(q), m)) : q;
  }
};

// The positions of a region of the block's images, row-major per image, and
// the region of shared memory the taps read them from.
struct Region {
  int h, w, y0, x0;        // the rows' region: size and top-left in the image
  int sh, sw, sy0, sx0;    // the read region: size and top-left in the image
  uint32_t base;           // shared address of the read region's first row
  int pitch;               // bytes a row (position)
};

// Lane's A row m: the read region's row of its centre tap and a bit for each
// of the 9 taps (3 (dy + 1) + dx + 1) whose read lies in the image; none past
// M (the zero row is read and the result dropped).
struct RowPos {
  int srow;
  uint32_t taps;
};

__device__ __forceinline__ RowPos locate(const Region& r, const FastDiv& per,
                                         const FastDiv& wd, int m, int M, int H, int W) {
  RowPos p{0, 0u};
  if (m >= M) return p;
  const int img = per.div(m);
  const int q = m - img * per.d;
  const int yy = wd.div(q);
  const int gy = r.y0 + yy, gx = r.x0 + q - yy * r.w;
  p.srow = (img * r.sh + gy - r.sy0) * r.sw + gx - r.sx0;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx)
      if (gy + dy >= 0 && gy + dy < H && gx + dx >= 0 && gx + dx < W)
        p.taps |= 1u << (3 * (dy + 1) + dx + 1);
  return p;
}

// Stages w (OIHW, n_real x k_real x 3 x 3) rows [n0, n0 + rows) of taps
// [t0, t0 + nt) (indices into the taps the image needs: ky0.. by kx0.., nkx
// wide) into shared memory as [tap][row][kp + kPad], zero past n_real and
// k_real. When the rows of all 9 taps are wanted they are one contiguous run
// of w, read 16 bytes a thread and scattered; otherwise a thread reads 8 in
// channels of one (tap, row), taps fastest. kUnroll loads in flight a thread.
__device__ __forceinline__ void stage_weights(uint16_t* ws, const uint16_t* __restrict__ w,
                                              int n_real, int k_real, int kp, int n0, int rows,
                                              int t0, int nt, int ky0, int kx0, int nkx) {
  const int pitch = kp + kPad;
  const int real_rows = max(0, min(rows, n_real - n0));
  if (nt == 9 && (static_cast<int64_t>(n0) * k_real * 9) % 8 == 0 &&
      reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    const uint16_t* src = w + static_cast<int64_t>(n0) * k_real * 9;
    const int total = real_rows * k_real * 9;  // elements
    const int vecs = total / 8;
    for (int i0 = threadIdx.x; i0 < vecs; i0 += kUnroll * static_cast<int>(blockDim.x)) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * static_cast<int>(blockDim.x);
        if (i < vecs) v[u] = __ldg(reinterpret_cast<const uint4*>(src) + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * static_cast<int>(blockDim.x);
        if (i >= vecs) continue;
        const uint32_t words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        int idx = 8 * i;
        int n = idx / (k_real * 9), rem = idx - n * k_real * 9;
        int k = rem / 9, tap = rem - k * 9;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          ws[(tap * rows + n) * pitch + k] = static_cast<uint16_t>(words[j / 2] >> (16 * (j % 2)));
          if (++tap == 9) {
            tap = 0;
            if (++k == k_real) {
              k = 0;
              ++n;
            }
          }
        }
      }
    }
    for (int i = vecs * 8 + threadIdx.x; i < total; i += blockDim.x) {  // the tail past 8
      const int n = i / (k_real * 9), rem = i - n * k_real * 9;
      ws[((rem % 9) * rows + n) * pitch + rem / 9] = __ldg(src + i);
    }
    // zero the padding: in channels past k_real of the real rows, rows past n_real
    const int zk = kp - k_real;
    for (int i = threadIdx.x; i < 9 * real_rows * zk; i += blockDim.x) {
      const int r = i / zk, tap = r / real_rows;
      ws[(tap * rows + r - tap * real_rows) * pitch + k_real + i % zk] = 0;
    }
    for (int i = threadIdx.x; i < 9 * (rows - real_rows) * kp; i += blockDim.x) {
      const int r = i / kp, tap = r / (rows - real_rows);
      ws[(tap * rows + real_rows + r % (rows - real_rows)) * pitch + i % kp] = 0;
    }
    return;
  }
  const int kq = kp / 8;
  const int total = nt * kq * rows;
  for (int i0 = threadIdx.x; i0 < total; i0 += kUnroll * static_cast<int>(blockDim.x)) {
    uint32_t v[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * static_cast<int>(blockDim.x);
      const int t = i % nt, rest = i / nt;
      const int q = rest % kq, n = n0 + rest / kq;
      const int tap = t0 + t;
      const uint16_t* src = w + (static_cast<int64_t>(n) * k_real + q * 8) * 9 +
                            (ky0 + tap / nkx) * 3 + kx0 + tap % nkx;
      const bool row_ok = i < total && n < n_real;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = q * 8 + 2 * j;
        const uint32_t lo = row_ok && k < k_real ? __ldg(src + 18 * j) : 0u;
        const uint32_t hi = row_ok && k + 1 < k_real ? __ldg(src + 18 * j + 9) : 0u;
        v[u][j] = lo | (hi << 16);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * static_cast<int>(blockDim.x);
      if (i < total) {
        const int t = i % nt, rest = i / nt;
        const int q = rest % kq, nr = rest / kq;
        *reinterpret_cast<uint4*>(ws + (t * rows + nr) * pitch + q * 8) =
            make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
      }
    }
  }
}

// One 3x3 conv of the block as an implicit GEMM: M rows of `rg`, n_out
// output channels (n_real of them in w and bias, the rest zero) in passes of
// NT n8 tiles, K = ntaps x kp. Every pass computes all NT tiles (the staged
// weight rows past n_real are zero), so the MMAs run unpredicated. Resident:
// the weights are in `ws` for all taps and passes, and the warps share out
// every (pass, item) at once.
// Streamed: the passes run in turn, each tap of a pass staged here between
// barriers. epi(row, n, nt_valid, v) takes a row's results plus bias: v[nt]
// at channels n + 8 nt + {0, 1}.
template <bool kRelu, int NT, typename Epi>
__device__ __forceinline__ void conv_gemm(const Region& rg, int M, int n_out, int kp,
                                          uint16_t* ws, bool resident, const uint16_t* w,
                                          const uint16_t* bias, int n_real, int k_real, int ky0,
                                          int nky, int kx0, int nkx, int H, int W,
                                          uint32_t zero_row, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntaps = nky * nkx;
  const int wpitch = (kp + kPad) * 2;
  const int ksteps = kp / 16;
  const int items = ((M + 15) / 16 + kMtW - 1) / kMtW;
  const int passes = (n_out + NT * 8 - 1) / (NT * 8);
  const int work = resident ? items * passes : items;  // of one stage round
  const int warps = blockDim.x / 32;
  const int rounds = (work + warps - 1) / warps;
  const uint32_t ws_addr = smem_u32(ws);
  const FastDiv per(rg.h * rg.w), wd(rg.w);
  // lane's row of an ldmatrix x4 over B (two n8 tiles x k16), and its k half
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) * 16;
  for (int sp = 0; sp < (resident ? 1 : passes); ++sp) {
    for (int round = 0; round < rounds; ++round) {
      const int wi = round * warps + warp;
      const bool has = wi < work;
      const int pass = resident ? wi / items : sp;
      const int item = resident ? wi - pass * items : wi;
      const int n0 = pass * NT * 8;
      const int nt_valid = min(NT, (n_out - n0 + 7) / 8);
      const int w_rows = resident ? passes * NT * 8 : NT * 8;
      const int w_row0 = resident ? n0 : 0;
      RowPos pos[kMtW];
#pragma unroll
      for (int mt = 0; mt < kMtW; ++mt)
        pos[mt] = locate(rg, per, wd, (item * kMtW + mt) * 16 + (lane & 15), M, H, W);
      float acc[kMtW][NT][4];
#pragma unroll
      for (int mt = 0; mt < kMtW; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
      for (int t = 0; t < ntaps; ++t) {
        if (!resident) {
          __syncthreads();  // the previous tap's readers are done
          stage_weights(ws, w, n_real, k_real, kp, n0, w_rows, t, 1, ky0, kx0, nkx);
          __syncthreads();
        }
        if (!has) continue;
        const int dy = ky0 + t / nkx - 1, dx = kx0 + t % nkx - 1;
        const int tap_bit = 3 * (dy + 1) + dx + 1, shift = dy * rg.sw + dx;
        uint32_t a_addr[kMtW];
#pragma unroll
        for (int mt = 0; mt < kMtW; ++mt)
          a_addr[mt] = ((pos[mt].taps >> tap_bit) & 1u
                            ? rg.base + (pos[mt].srow + shift) * rg.pitch
                            : zero_row) +
                       (lane >> 4) * 16;
        const uint32_t b_addr =
            ws_addr + ((resident ? t : 0) * w_rows + w_row0 + b_row) * wpitch + b_k;
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t a[kMtW][4];
#pragma unroll
          for (int mt = 0; mt < kMtW; ++mt) {
            ldsm_x4(a_addr[mt] + ks * 32, a[mt]);
            if (kRelu) {
#pragma unroll
              for (int e = 0; e < 4; ++e) a[mt][e] = relu_bf16x2(a[mt][e]);
            }
          }
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t b[4];
            ldsm_x4(b_addr + np * 16 * wpitch + ks * 32, b);
#pragma unroll
            for (int mt = 0; mt < kMtW; ++mt) {
              mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
              mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
            }
          }
        }
      }
      if (!has) continue;
      // this lane's bias pairs: channels n0 + 8 nt + 2 (lane % 4) + {0, 1}
      const int n = n0 + 2 * (lane % 4);
      float bv[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n + 8 * nt + e;
          bv[nt][e] = bias && nt < nt_valid && c < n_real ? bf16_bits_to_f(__ldg(bias + c)) : 0.0f;
        }
      // accumulator fragment: rows lane/4 and lane/4 + 8, columns 2 (lane%4) + {0, 1}
      // of each n8 tile; epi takes a row's pairs of every tile of the pass
#pragma unroll
      for (int mt = 0; mt < kMtW; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = (item * kMtW + mt) * 16 + lane / 4 + 8 * half;
          float v[NT][2];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[nt][e] = bias ? acc[mt][nt][2 * half + e] + bv[nt][e] : acc[mt][nt][2 * half + e];
          if (row < M) epi(row, n, nt_valid, v);
        }
      }
    }
  }
}

// 256 or 512 threads, at most 128 registers a thread: two blocks of 256 an SM
// where the shared memory allows, else one of 512.
__global__ void __launch_bounds__(kMaxThreads, 1) fused_light_block_kernel_tc(const TcArgs p) {
  extern __shared__ __align__(16) uint16_t tsm[];
  const TcLayout lay(p.C, p.CB, p.H, p.W, p.TH, p.TW, p.NI, p.resident);
  uint16_t* zs = tsm;
  uint16_t* xs = zs + lay.zero;
  uint16_t* ms = xs + lay.x;
  uint16_t* ws = ms + lay.mid;
  const int C = p.C, CB = p.CB, H = p.H, W = p.W;
  const int cp = ceil16(C), cbp = ceil16(CB);
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int ty0 = (blockIdx.x / p.tiles_x) * p.TH, tx0 = (blockIdx.x % p.tiles_x) * p.TW;
  const int b0 = blockIdx.y * p.NI, ni = min(p.NI, p.B - b0);
  const int oh = min(p.TH, H - ty0), ow = min(p.TW, W - tx0);
  // x region: the tile and a 2-pixel halo; mid region: a 1-pixel halo; both
  // cut at the image's edge
  const int sy0 = max(ty0 - 2, 0), sx0 = max(tx0 - 2, 0);
  const int xh = min(ty0 + oh + 2, H) - sy0, xw = min(tx0 + ow + 2, W) - sx0;
  const int my0 = max(ty0 - 1, 0), mx0 = max(tx0 - 1, 0);
  const int mh = min(ty0 + oh + 1, H) - my0, mw = min(tx0 + ow + 1, W) - mx0;
  // taps whose window lies wholly in the padding are skipped
  const int ky0 = H > 1 ? 0 : 1, nky = H > 1 ? 3 : 1;
  const int kx0 = W > 1 ? 0 : 1, nkx = W > 1 ? 3 : 1;
  const int xpitch = cp + kPad, mpitch = cbp + kPad;

  for (int i = threadIdx.x; i < lay.zero / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(zs)[i] = make_uint4(0, 0, 0, 0);
  {  // x region, [image][y][x][c], zero past C: a thread takes a position, all channels
    const int npos = ni * xh * xw;
    const FastDiv per(xh * xw), wd(xw);
    for (int r = threadIdx.x; r < npos; r += blockDim.x) {
      const int img = per.div(r), rr = r - img * xh * xw;
      const int yy = wd.div(rr);
      const uint16_t* src = p.x + static_cast<int64_t>(b0 + img) * C * hw +
                            static_cast<int64_t>(sy0 + yy) * W + sx0 + rr - yy * xw;
      uint16_t* dst = xs + r * xpitch;
#pragma unroll 4
      for (int c0 = 0; c0 < cp; c0 += 8) {
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + 2 * j;
          const uint32_t lo = c < C ? __ldg(src + c * hw) : 0u;
          const uint32_t hi = c + 1 < C ? __ldg(src + (c + 1) * hw) : 0u;
          v[j] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(dst + c0) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
  if (p.resident)
    stage_weights(ws, p.w1, CB, C, cp, 0, cbp, 0, nky * nkx, ky0, kx0, nkx);
  __syncthreads();

  const uint32_t zero_row = smem_u32(zs);
  // conv1: mid = relu(bf16(conv(relu(x), w1) + b1)) at the mid region's positions
  const Region r1{mh, mw, my0, mx0, xh, xw, sy0, sx0, smem_u32(xs), xpitch * 2};
  const auto epi1 = [&](int row, int n, int nt_valid, const auto& v) {
    constexpr int nts = sizeof(v) / sizeof(v[0]);
    uint16_t* mr = ms + row * mpitch + n;
#pragma unroll
    for (int nt = 0; nt < nts; ++nt) {
      if (nt >= nt_valid) break;
      uint32_t pair = 0;  // padded channels stay 0
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (n + 8 * nt + e < CB)
          pair |= static_cast<uint32_t>(
                      f_to_bf16_bits(fmaxf(bf16_bits_to_f(f_to_bf16_bits(v[nt][e])), 0.0f)))
                  << (16 * e);
      }
      *reinterpret_cast<uint32_t*>(mr + 8 * nt) = pair;
    }
  };
  if (conv1_nt(CB) == 4)
    conv_gemm<true, 4>(r1, ni * mh * mw, cbp, cp, ws, p.resident, p.w1, p.b1, CB, C, ky0, nky,
                       kx0, nkx, H, W, zero_row, epi1);
  else
    conv_gemm<true, 2>(r1, ni * mh * mw, cbp, cp, ws, p.resident, p.w1, p.b1, CB, C, ky0, nky,
                       kx0, nkx, H, W, zero_row, epi1);
  __syncthreads();
  if (p.resident) {
    stage_weights(ws, p.w2, C, CB, cbp, 0, ceil32(C), 0, nky * nkx, ky0, kx0, nkx);
    __syncthreads();
  }

  // conv2: y = bf16(x + (conv(mid, w2) + b2)) at the output tile's positions
  const Region r2{oh, ow, ty0, tx0, mh, mw, my0, mx0, smem_u32(ms), mpitch * 2};
  const FastDiv out_per(oh * ow), out_w(ow);
  conv_gemm<false, 4>(
      r2, ni * oh * ow, C, cbp, ws, p.resident, p.w2, p.b2, C, CB, ky0, nky, kx0, nkx, H, W,
      zero_row, [&](int row, int n, int nt_valid, const float (&v)[4][2]) {
        const int img = out_per.div(row);
        const int q = row - img * oh * ow;
        const int yy = out_w.div(q);
        const int gy = ty0 + yy, gx = tx0 + q - yy * ow;
        const uint16_t* xr = xs + ((img * xh + gy - sy0) * xw + gx - sx0) * xpitch + n;
        uint16_t* yo = p.y + (static_cast<int64_t>(b0 + img) * C + n) * hw +
                       static_cast<int64_t>(gy) * W + gx;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= nt_valid) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (n + 8 * nt + e < C)  // the last n8 tile may run past an odd C
              yo[(8 * nt + e) * hw] = f_to_bf16_bits(bf16_bits_to_f(xr[8 * nt + e]) + v[nt][e]);
          }
        }
      });
}

template <typename K>
int allow_smem(K kernel, int smem, bool& set) {
  if (smem > 48 * 1024 && !set) {  // above the default limit of dynamic shared memory
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set = true;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The float32 kernel.

constexpr int kF32Threads = 256;  // threads of a float32 block
constexpr int kSeg = 4;           // positions of a lane's row segment
constexpr int kColSlots = 4;      // canvas columns a lane stages: a pitch of at most 32 kColSlots

__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int up_to(int v, int m) { return (v + m - 1) / m * m; }

// A float32 block's shared memory, in floats, as ops/fused_block.py::f32_layout
// counts it. 9 taps: an x canvas holds x on the tile with a 2-pixel ring for
// KC input channels (a chunk), the mid canvas relu(mid) with a 1-pixel ring,
// both cut 1 pixel outside the image's edge and zero outside the image; with
// NI > 1 (whole images only) the images sit side by side, one zero column
// between two. 1 tap (1x1 images): the NI images' positions side by side in
// one row. Canvases are plane-major, [channel][row][column]; pitches are
// multiples of 4 with room for the last segment's reads. Two x canvases
// where x takes more than one chunk, else one; then two weight buffers of KC
// input channels x taps x the larger conv's slice of output channels: a
// cluster of CS blocks shares each conv's output channels, padded to NG, in
// CS slices (np1s, np2s).
struct F32Layout {
  int taps, xr, xp, mr, mp, s1, s2, np1, np2, np1s, np2s, xc, nxc, mid, w;
  __host__ __device__ F32Layout(int C, int CB, int H, int W, int TH, int TW, int NI, int KC,
                                int ng1, int ng2, int CS) {
    taps = H == 1 && W == 1 ? 1 : 9;
    if (taps == 1) {
      xr = mr = 1;
      s1 = s2 = (NI + kSeg - 1) / kSeg;
      xp = mp = kSeg * s1;
    } else {
      const bool slots = NI > 1;
      const int mcols = slots ? NI * (W + 1) - 1 : imin(TW + 2, W);  // conv1's columns
      const int ocols = slots ? NI * (W + 1) - 1 : TW;                // conv2's columns
      const int cw = slots ? NI * (W + 1) + 1 : imin(TW + 4, W + 2);  // the x canvas's
      xr = imin(TH + 4, H + 2);
      mr = TH + 2;
      s1 = (mcols + kSeg - 1) / kSeg;
      s2 = (ocols + kSeg - 1) / kSeg;
      xp = up_to(imax(cw, kSeg * s1 + 2), 4);
      mp = up_to(imax(kSeg * s2 + 2, kSeg * s1 + 1), 4);
    }
    np1 = up_to(CB, ng1);
    np2 = up_to(C, ng2);
    np1s = np1 / CS;
    np2s = np2 / CS;
    xc = imin(KC, C) * xr * xp;
    nxc = C > KC ? 2 : 1;
    mid = CB * mr * mp;
    w = KC * taps * imax(np1s, np2s);
  }
  __host__ __device__ int64_t bytes() const {
    return 4 * (static_cast<int64_t>(nxc) * xc + mid + 2 * static_cast<int64_t>(w));
  }
};

struct F32Args {
  const float* x;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  float* y;
  int B, C, CB, H, W, TH, TW, NI, KC, CS, tiles_x;
};

// 4 bytes from global to shared memory, asynchronously; zeros where !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the block's rank in its cluster, a barrier of the cluster's threads (what
// each block wrote to its shared memory before it is seen by all after it),
// and a 16-byte read of another block's shared memory at the address of p
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float4 ld_cluster4(const float* p, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// Stages input channels [k0, k0 + kn) of output channels [n0, n0 + np) of
// the OIHW weights w (n_real x k_real x 3 x 3) into buf as [k - k0][tap][n -
// n0] (TAPS 9: every tap; 1: the centre), zero past n_real. Output channels
// run fastest across the threads, so the 4-byte copies land in distinct banks.
template <int TAPS>
__device__ __forceinline__ void stage_w_f32(float* buf, const float* __restrict__ w, int n_real,
                                            int k_real, int n0, int np, int k0, int kn) {
  const int total = kn * TAPS * np;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int q = e / np, n = n0 + e - q * np;  // q = (k - k0) TAPS + tap
    const int kk = q / TAPS, t = q - kk * TAPS;
    const bool ok = n < n_real;
    cp_async4(buf + e,
              ok ? w + (static_cast<int64_t>(n) * k_real + k0 + kk) * 9 + (TAPS == 9 ? t : 4) : w,
              ok);
  }
}

// One conv of the float32 block as an implicit GEMM on the CUDA cores. A
// lane-item is a segment of kSeg positions along a canvas row by NG output
// channels, summed in registers over k_real input channels x TAPS taps: for
// each input channel and tap row it reads kSeg + 2 source values (16- and
// 8-byte reads, shared by the row's 3 taps; relu'd here when RELU), for each
// tap NG weights (16-byte reads, the same address across a warp's lanes),
// and makes kSeg NG fmaf. Item (group g, row r, segment s) reads source rows
// row0 + r + dy and columns kSeg s + dx; items are spread over the threads
// in rounds, groups slowest. The input channels come in chunks of kc:
// src(par, k0) is the source canvas of the chunk from k0 (`plane` floats a
// channel, `pitch` a row) and ws + par wbuf its weights, [channel][tap][np],
// both staged by stage(par, chunk) with cp.async one chunk ahead into the
// other of two buffers; a conv of one chunk keeps it for all its rounds. seq
// counts the chunks, across both convs, and picks the buffer; next(par)
// stages what follows this conv's last chunk. epi(g, r, s, acc) takes an
// item's sums.
template <int NG, int TAPS, bool RELU, typename Src, typename Stage, typename Next, typename Epi>
__device__ __forceinline__ void conv_f32(int plane, int pitch, int row0, int rows, int segs,
                                         int np, int k_real, int kc, const float* ws, int wbuf,
                                         int& seq, Src src, Stage stage, Next next, Epi epi) {
  constexpr int KY = TAPS == 9 ? 3 : 1;
  const int per_g = rows * segs;
  const int total = np / NG * per_g;
  const int nthreads = blockDim.x;
  const int rounds = (total + nthreads - 1) / nthreads;
  const int chunks = (k_real + kc - 1) / kc;
  const bool resident = chunks == 1;
  for (int round = 0; round < rounds; ++round) {
    const int idx = round * nthreads + threadIdx.x;
    const bool has = idx < total;
    const int g = idx / per_g, rem = idx - g * per_g;
    const int r = rem / segs, s = rem - r * segs;
    float acc[kSeg][NG];
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
#pragma unroll
      for (int n = 0; n < NG; ++n) acc[j][n] = 0.0f;
    for (int ch = 0; ch < chunks; ++ch) {
      cp_async_wait_all();
      __syncthreads();  // this chunk has landed; the other buffers' readers are done
      const bool last = ch + 1 == chunks && round + 1 == rounds;
      const int par = seq & 1;
      if (last)
        next(par ^ 1);
      else if (!resident)
        stage(par ^ 1, ch + 1 < chunks ? ch + 1 : 0);
      cp_async_commit();
      const int k0 = ch * kc, kn = imin(kc, k_real - k0);
      const float* xb = src(par, k0) + (row0 + r) * pitch + kSeg * s;
      const float* wb = ws + par * wbuf + g * NG;
      if (has) {
        for (int kk = 0; kk < kn; ++kk) {
          const float* xk = xb + kk * plane;
          const float* wk = wb + kk * TAPS * np;
#pragma unroll
          for (int dy = 0; dy < KY; ++dy) {
            float v[kSeg + 2];
#pragma unroll
            for (int q = 0; q < kSeg / 4; ++q) {
              const float4 a = *reinterpret_cast<const float4*>(xk + dy * pitch + 4 * q);
              v[4 * q] = a.x;
              v[4 * q + 1] = a.y;
              v[4 * q + 2] = a.z;
              v[4 * q + 3] = a.w;
            }
            v[kSeg] = v[kSeg + 1] = 0.0f;
            if (TAPS == 9) {
              const float2 e = *reinterpret_cast<const float2*>(xk + dy * pitch + kSeg);
              v[kSeg] = e.x;
              v[kSeg + 1] = e.y;
            }
            if (RELU) {
#pragma unroll
              for (int i = 0; i < kSeg + 2; ++i) v[i] = fmaxf(v[i], 0.0f);
            }
#pragma unroll
            for (int dx = 0; dx < KY; ++dx) {
              float wv[NG];
#pragma unroll
              for (int q = 0; q < NG / 4; ++q) {
                const float4 t =
                    *reinterpret_cast<const float4*>(wk + (dy * KY + dx) * np + 4 * q);
                wv[4 * q] = t.x;
                wv[4 * q + 1] = t.y;
                wv[4 * q + 2] = t.z;
                wv[4 * q + 3] = t.w;
              }
#pragma unroll
              for (int j = 0; j < kSeg; ++j)
#pragma unroll
                for (int n = 0; n < NG; ++n) acc[j][n] = fmaf(v[j + dx], wv[n], acc[j][n]);
            }
          }
        }
      }
      if (!resident || last) ++seq;
    }
    if (has) epi(g, r, s, acc);
  }
}

// kF32Threads threads, at most 128 registers a thread: two blocks an SM
// where the shared memory allows. NG1 and NG2: the output channels of a
// lane-item in conv1 and conv2; TAPS 1 for 1x1 images. A cluster of CS
// blocks (blockIdx.z) takes one tile: block r computes slice r of mid's
// channels, the cluster's blocks copy each other's slices into their own mid
// canvas through distributed shared memory, and block r computes slice r of
// y's channels; each stages only its slices' weights.
template <int NG1, int NG2, int TAPS>
__global__ void __launch_bounds__(kF32Threads, 2) fused_light_block_kernel_f32(const F32Args p) {
  extern __shared__ __align__(16) float fsm[];
  const F32Layout lay(p.C, p.CB, p.H, p.W, p.TH, p.TW, p.NI, p.KC, NG1, NG2, p.CS);
  const int rank = p.CS > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int n1 = rank * lay.np1s, n2 = rank * lay.np2s;  // the block's first channels
  float* xs = fsm;
  float* ms = xs + lay.nxc * lay.xc;
  float* ws = ms + lay.mid;
  const int C = p.C, CB = p.CB, H = p.H, W = p.W;
  const int64_t hw = static_cast<int64_t>(H) * W;
  const int ty0 = (blockIdx.x / p.tiles_x) * p.TH, tx0 = (blockIdx.x % p.tiles_x) * p.TW;
  const int b0 = blockIdx.y * p.NI, ni = imin(p.NI, p.B - b0);
  const int oh = imin(p.TH, H - ty0), ow = imin(p.TW, W - tx0);
  const bool slots = p.NI > 1;
  const int slot = W + 1;
  // The canvases' row 0 and column 0 lie at image row cy0 and column cx0;
  // conv1 computes mid at image rows my0.. (mrows of them) and canvas
  // columns c_lo.. (mcols), conv2 y at image rows ty0.. and canvas columns
  // o_lo.. (ocols). Mid canvas row 0 is image row ty0 - 1 and its column 0
  // canvas column moff, so that conv2's segments read aligned columns.
  int cy0 = 0, cx0 = 0, xrows = 1, xcols = ni, my0 = 0, mrows = 1, mcols = ni, ocols = ni;
  int c_lo = 0, o_lo = 0;
  if (TAPS == 9) {
    cy0 = imax(ty0 - 2, -1);
    xrows = imin(ty0 + oh + 2, H + 1) - cy0;
    cx0 = imax(tx0 - 2, -1);
    xcols = slots ? ni * slot + 1 : imin(tx0 + ow + 2, W + 1) - cx0;
    my0 = imax(ty0 - 1, 0);
    mrows = imin(ty0 + oh + 1, H) - my0;
    mcols = slots ? ni * slot - 1 : imin(tx0 + ow + 1, W) - imax(tx0 - 1, 0);
    ocols = slots ? ni * slot - 1 : ow;
    c_lo = 1;
    o_lo = tx0 - cx0;
  }
  const int moff = TAPS == 9 ? o_lo - 1 : 0;
  // the image and image column of canvas column k; false outside every image
  const auto locate = [&](int k, int& img, int& gcol) -> bool {
    if (TAPS == 1) {
      img = k;
      gcol = 0;
      return k < ni;
    }
    if (!slots) {
      img = 0;
      gcol = k + cx0;
      return gcol >= 0 && gcol < W;
    }
    img = (k - 1) / slot;
    gcol = k - 1 - img * slot;
    return k >= 1 && img < ni && gcol < W;
  };

  // x's canvas of input channels [k0, k0 + kn) into buf by cp.async, zero
  // outside the images: a warp takes (channel, row) pairs, a lane fixed
  // columns
  const auto stage_x = [&](float* buf, int k0, int kn) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
    int64_t goff[kColSlots];
    bool cok[kColSlots];
#pragma unroll
    for (int m = 0; m < kColSlots; ++m) {
      const int k = lane + 32 * m;
      int img = 0, gcol = 0;
      cok[m] = k < xcols && locate(k, img, gcol);
      goff[m] = cok[m] ? static_cast<int64_t>(b0 + img) * C * hw + gcol : 0;
    }
    for (int pr = warp; pr < kn * lay.xr; pr += warps) {
      const int c = pr / lay.xr, r = pr - c * lay.xr;
      const int gy = cy0 + r;
      const bool rok = r < xrows && gy >= 0 && gy < H;
      const int64_t row = (k0 + c) * hw + static_cast<int64_t>(rok ? gy : 0) * W;
      float* dst = buf + pr * lay.xp;
#pragma unroll
      for (int m = 0; m < kColSlots; ++m) {
        const int k = lane + 32 * m;
        const bool ok = rok && cok[m];
        if (k < lay.xp) cp_async4(dst + k, ok ? p.x + row + goff[m] : p.x, ok);
      }
    }
  };
  // conv1's chunk: its weights and x's canvas
  const auto stage1 = [&](int par, int chunk) {
    const int k0 = chunk * p.KC, kn = imin(p.KC, C - k0);
    stage_w_f32<TAPS>(ws + par * lay.w, p.w1, CB, C, n1, lay.np1s, k0, kn);
    stage_x(xs + par * lay.xc, k0, kn);
  };
  int seq = 0;
  stage1(0, 0);
  cp_async_commit();
  for (int i = threadIdx.x; i < lay.mid / 4; i += blockDim.x)
    reinterpret_cast<float4*>(ms)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // conv1: mid = relu(conv(relu(x), w1) + b1) inside the image, 0 elsewhere
  const float* b1 = p.b1;
  conv_f32<NG1, TAPS, true>(
      lay.xr * lay.xp, lay.xp, TAPS == 9 ? my0 - 1 - cy0 : 0, mrows, (mcols + kSeg - 1) / kSeg,
      lay.np1s, C, p.KC, ws, lay.w, seq, [&](int par, int) { return xs + par * lay.xc; },
      stage1,
      [&](int par) {
        stage_w_f32<TAPS>(ws + par * lay.w, p.w2, C, CB, n2, lay.np2s, 0, imin(p.KC, CB));
      },
      [&](int g, int r, int s, const float(&acc)[kSeg][NG1]) {
        float* mrow = ms + (TAPS == 9 ? my0 + r - (ty0 - 1) : 0) * lay.mp - moff;
#pragma unroll
        for (int j = 0; j < kSeg; ++j) {
          const int k = c_lo + kSeg * s + j;
          int img, gcol;
          const bool ok = kSeg * s + j < mcols && locate(k, img, gcol);
#pragma unroll
          for (int n = 0; n < NG1; ++n) {
            const int c = n1 + g * NG1 + n;
            if (c < CB) {
              float m = 0.0f;
              if (ok) m = fmaxf(b1 != nullptr ? acc[j][n] + __ldg(b1 + c) : acc[j][n], 0.0f);
              mrow[c * lay.mr * lay.mp + k] = m;
            }
          }
        }
      });

  if (p.CS > 1) {  // every block's slice of mid into every block's canvas
    cluster_sync();
    const int plane = lay.mr * lay.mp;
    for (int q = 0; q < p.CS; ++q) {
      if (q == rank) continue;
      const int c0 = q * lay.np1s, c1 = imin(c0 + lay.np1s, CB);
      float* dst = ms + c0 * plane;
      for (int i = threadIdx.x; i < (c1 - c0) * plane / 4; i += blockDim.x)
        reinterpret_cast<float4*>(dst)[i] = ld_cluster4(dst + 4 * i, q);
    }
    cluster_sync();  // no block leaves, or overwrites its canvas, while others read it
  }

  // conv2: y = x + (conv(mid, w2) + b2) at the tile's positions
  const float* b2 = p.b2;
  const bool vec = TAPS == 9 && !slots && W % 4 == 0 && tx0 % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p.y) % 16 == 0;
  conv_f32<NG2, TAPS, false>(
      lay.mr * lay.mp, lay.mp, 0, TAPS == 9 ? oh : 1, (ocols + kSeg - 1) / kSeg, lay.np2s, CB,
      p.KC, ws, lay.w, seq,
      [&](int, int k0) -> const float* { return ms + k0 * lay.mr * lay.mp; },
      [&](int par, int chunk) {
        const int k0 = chunk * p.KC;
        stage_w_f32<TAPS>(ws + par * lay.w, p.w2, C, CB, n2, lay.np2s, k0, imin(p.KC, CB - k0));
      },
      [](int) {},
      [&](int g, int r, int s, const float(&acc)[kSeg][NG2]) {
        const int gy = ty0 + r;
        if (vec && kSeg * (s + 1) <= ow) {  // kSeg positions of one image row: 16-byte accesses
          const int64_t base = static_cast<int64_t>(b0) * C * hw +
                               static_cast<int64_t>(gy) * W + tx0 + kSeg * s;
#pragma unroll
          for (int n = 0; n < NG2; ++n) {
            const int c = n2 + g * NG2 + n;
            if (c < C) {
              const float bc = b2 != nullptr ? __ldg(b2 + c) : 0.0f;
#pragma unroll
              for (int q = 0; q < kSeg / 4; ++q) {
                const int64_t o = base + c * hw + 4 * q;
                const float4 xv = __ldg(reinterpret_cast<const float4*>(p.x + o));
                float4 yv;
                yv.x = xv.x + (b2 != nullptr ? acc[4 * q][n] + bc : acc[4 * q][n]);
                yv.y = xv.y + (b2 != nullptr ? acc[4 * q + 1][n] + bc : acc[4 * q + 1][n]);
                yv.z = xv.z + (b2 != nullptr ? acc[4 * q + 2][n] + bc : acc[4 * q + 2][n]);
                yv.w = xv.w + (b2 != nullptr ? acc[4 * q + 3][n] + bc : acc[4 * q + 3][n]);
                *reinterpret_cast<float4*>(p.y + o) = yv;
              }
            }
          }
          return;
        }
#pragma unroll
        for (int j = 0; j < kSeg; ++j) {
          int img, gcol;
          if (kSeg * s + j >= ocols || !locate(o_lo + kSeg * s + j, img, gcol)) continue;
          const int64_t base = static_cast<int64_t>(b0 + img) * C * hw +
                               static_cast<int64_t>(gy) * W + gcol;
#pragma unroll
          for (int n = 0; n < NG2; ++n) {
            const int c = n2 + g * NG2 + n;
            if (c < C) {
              const int64_t o = base + c * hw;
              p.y[o] = __ldg(p.x + o) + (b2 != nullptr ? acc[j][n] + __ldg(b2 + c) : acc[j][n]);
            }
          }
        }
      });
}

template <int NG1, int NG2, int TAPS>
int launch_f32(const F32Args& a, dim3 grid, int smem, cudaStream_t stream) {
  static bool smem_set = false;
  const int err = allow_smem(fused_light_block_kernel_f32<NG1, NG2, TAPS>, smem, smem_set);
  if (err) return err;
  if (a.CS == 1) {
    fused_light_block_kernel_f32<NG1, NG2, TAPS><<<grid, kF32Threads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kF32Threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(a.CS);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, fused_light_block_kernel_f32<NG1, NG2, TAPS>, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// Both entry points launch on `stream` (PyTorch's current stream) and return
// cudaGetLastError(): a launch that CUDA refuses never runs, and only this
// return reports it. b1 and b2 may be null.

// float32: TH x TW output tiles of NI images (NI > 1 only where the tile is
// the whole image) a cluster of CS blocks (1, 2, 4 or 8; each conv's groups
// of NG output channels split evenly among them) of 256 threads; x and the
// weights staged in chunks of KC input channels; NG1 and NG2 (8 or 16)
// output channels of a lane-item in conv1 and conv2. smem must be
// F32Layout(...).bytes().
extern "C" int fused_light_block_f32_forward(const void* x, const void* w1, const void* b1,
                                             const void* w2, const void* b2, void* y, int64_t B,
                                             int C, int CB, int H, int W, int TH, int TW, int NI,
                                             int KC, int NG1, int NG2, int CS, int smem,
                                             void* stream) {
  if (C <= 0 || CB <= 0 || H <= 0 || W <= 0 || TH <= 0 || TW <= 0 || TH > H || TW > W ||
      NI <= 0 || KC <= 0 || B < 0 || (NG1 != 8 && NG1 != 16) || (NG2 != 8 && NG2 != 16) ||
      (CS != 1 && CS != 2 && CS != 4 && CS != 8) || up_to(CB, NG1) % (NG1 * CS) ||
      up_to(C, NG2) % (NG2 * CS) ||
      (NI > 1 && (TH != H || TW != W)))
    return static_cast<int>(cudaErrorInvalidValue);
  const F32Layout lay(C, CB, H, W, TH, TW, NI, KC, NG1, NG2, CS);
  if ((B + NI - 1) / NI > 65535 || lay.xp > 32 * kColSlots || smem != lay.bytes() ||
      smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  F32Args a;
  a.x = static_cast<const float*>(x);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.y = static_cast<float*>(y);
  a.B = static_cast<int>(B);
  a.C = C;
  a.CB = CB;
  a.H = H;
  a.W = W;
  a.TH = TH;
  a.TW = TW;
  a.NI = NI;
  a.KC = KC;
  a.CS = CS;
  a.tiles_x = (W + TW - 1) / TW;
  const dim3 grid(static_cast<unsigned>(a.tiles_x * ((H + TH - 1) / TH)),
                  static_cast<unsigned>((B + NI - 1) / NI), static_cast<unsigned>(CS));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one = lay.taps == 1;
  if (NG1 == 8 && NG2 == 8)
    return one ? launch_f32<8, 8, 1>(a, grid, smem, s)
               : launch_f32<8, 8, 9>(a, grid, smem, s);
  if (NG1 == 8)
    return one ? launch_f32<8, 16, 1>(a, grid, smem, s)
               : launch_f32<8, 16, 9>(a, grid, smem, s);
  if (NG2 == 8)
    return one ? launch_f32<16, 8, 1>(a, grid, smem, s)
               : launch_f32<16, 8, 9>(a, grid, smem, s);
  return one ? launch_f32<16, 16, 1>(a, grid, smem, s)
             : launch_f32<16, 16, 9>(a, grid, smem, s);
}

// bf16, the tensor-core kernel: TH x TW output tiles of NI images a block of
// `threads` (256 or 512); resident 1 keeps each conv's weights in shared
// memory for the whole conv, 0 streams them a tap at a time. smem must be
// TcLayout(...).bytes().
extern "C" int fused_light_block_bf16_forward(const void* x, const void* w1, const void* b1,
                                              const void* w2, const void* b2, void* y,
                                              int64_t B, int C, int CB, int H, int W, int TH,
                                              int TW, int NI, int resident, int threads,
                                              int smem, void* stream) {
  if (C <= 0 || CB <= 0 || H <= 0 || W <= 0 || TH <= 0 || TW <= 0 || TH > H || TW > W ||
      NI <= 0 || (resident != 0 && resident != 1) || (threads != 256 && threads != 512) || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t groups = (B + NI - 1) / NI;
  // positions a block indexes stay under 2^16 (FastDiv)
  const int64_t positions = static_cast<int64_t>(NI) * (TH + 4) * (TW + 4);
  if (groups > 65535 || positions >= 65536 ||
      smem != TcLayout(C, CB, H, W, TH, TW, NI, resident).bytes() || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  static bool smem_set = false;
  const int err = allow_smem(fused_light_block_kernel_tc, smem, smem_set);
  if (err) return err;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  TcArgs a;
  a.x = static_cast<const uint16_t*>(x);
  a.w1 = static_cast<const uint16_t*>(w1);
  a.b1 = static_cast<const uint16_t*>(b1);
  a.w2 = static_cast<const uint16_t*>(w2);
  a.b2 = static_cast<const uint16_t*>(b2);
  a.y = static_cast<uint16_t*>(y);
  a.B = static_cast<int>(B);
  a.C = C;
  a.CB = CB;
  a.H = H;
  a.W = W;
  a.TH = TH;
  a.TW = TW;
  a.NI = NI;
  a.tiles_x = tiles_x;
  a.resident = resident;
  const dim3 grid(static_cast<unsigned>(tiles_x * tiles_y), static_cast<unsigned>(groups));
  fused_light_block_kernel_tc<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
