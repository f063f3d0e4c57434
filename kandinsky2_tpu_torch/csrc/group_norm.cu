// GroupNorm(+affine)(+FiLM)(+SiLU) for Hopper (sm_90a) in two kernels, K1
// and K2, with the host entries that launch them from a plan computed once
// per shape by ops/group_norm.py.
//
// K1, the statistics and coefficients, replaces the Pallas TPU kernel
// kandinsky2_tpu/ops/group_norm.py (_moments, kernel _moments_kernel)
// together with the XLA glue after it (_coefficients): on the TPU the glue
// fuses into the jitted program, in eager PyTorch it was some twenty small
// launches per call.  Here one launch reads x [B, N, C] (bf16 or fp32) once
// and writes per-(b, c) fp32 a and b such that the norm of x is x * a + b:
//
//   p_g    = x[b, 0, g * C / G]   (the pivot: the group's first element)
//   m_g    = sum_{n, c in g} (x - p_g) / cnt,  cnt = N * C / G
//   mean_g = p_g + m_g
//   var_g  = max(sum (x - p_g)^2 / cnt - m_g^2, 0)
//   a = scale / sqrt(var_g + eps),  b = bias - mean_g * a
//   with FiLM (fs, fb):  a *= 1 + fs,  b = b * (1 + fs) + fb
//
// The sums are shifted by the pivot, a value of the group itself, so the
// variance stays one pass over x without the one-pass formula's loss of
// digits: E[x^2] - mean^2 in fp32 (the JAX package's _moments and
// _coefficients) cancels as (mean / std)^2, about 5e-2 of the norm at a
// mean 1000 standard deviations from zero; the shifted form cancels as
// ((mean - p_g) / std)^2, which a value of the group keeps small.  Every
// block of a batch row shares the pivots, so its partials still add.
//
// Bound on the H100: a few flops per element against one read of x, so it
// is bound by device-memory bytes (B N C x its element size over 3.35 TB/s;
// 4.2 us at the UNet's [2, 9216, 384] bf16, 45 us at the MoVQ's
// [1, 589824, 128]).
//
// Design.
// * Grid (splits, B): each block sums a contiguous range of rows over all C
//   channels.  A thread owns one VEC-wide channel chunk (16-byte loads for
//   bf16 x with C % 8 == 0, or fp32 with C % 4 == 0; narrower for other C)
//   and every TY-th row of the range, with UNROLL loads in flight.  Enough
//   splits are launched to give about two blocks per SM at B = 1 and 2:
//   more blocks would keep no more bytes in flight and would lengthen the
//   finish, which reads every block's partials.
// * The block reduces its threads' sums through shared memory in a fixed
//   order (per channel, then a warp per group with a shuffle tree), to
//   per-group partials [B, splits, G, 2] in device memory.
// * Cross-block finish without a second launch ("last block done"): every
//   block fences its partials (__threadfence) and increments the per-b
//   counter with atomicAdd; the block that arrives last sums the partials
//   of its b (every group at once, blockDim / G threads a group, then their
//   sums in order), computes the group statistics and writes a and b, and
//   resets the counter to 0 for the next launch.  It loads its channels'
//   parameters before it reads the partials, so the two latencies overlap.  Every sum is taken
//   in an order fixed by the shape, so a and b are bitwise repeatable.
// * The counters are allocated once per device by the wrapper, zeroed, and
//   left at zero by every launch.  The kernel assumes that launches that
//   share the counters run on one stream (as the port runs), since two
//   overlapping launches would count into the same counters.
// * scale and bias ([C]) and the FiLM pair ([B, C] with a batch stride) are
//   read as they are stored, bf16 or fp32: no cast launches.
// * A row-sharded GroupNorm (parallel/spatial.py) runs K1 on each shard
//   through k2_group_norm_moments: the same launch, whose finish writes the
//   groups' pivots and shifted sums [B, G, 3] in place of a and b.  The
//   shards' pivots differ, so the caller shifts every shard's sums to one
//   pivot before it adds them (ops/group_norm.py, combine_moments), then
//   hands the coefficients to K2.
//
// K2, the apply kernel, replaces the Pallas TPU kernel
// kandinsky2_tpu/ops/group_norm.py (_apply, kernel _apply_kernel):
//
//   y = x * a + b in fp32; then y * sigmoid(swish * y) where swish != 0
//   (swish == 1, SiLU, as a specialisation); rounded once to x's dtype.
//
// Bound on the H100: a few flops per element against one read of x and one
// write of y, so it is bound by device-memory bytes,
// 2 B N C es + 2 B C 4 over 3.35 TB/s (es: x's element size): 8.5 us at the
// UNet's [2, 9216, 384] bf16, 90 us at the MoVQ's [1, 589824, 128], but
// 1.1 us at the UNet's ds8 [2, 144, 3072], where a launch's ramp and tail,
// not the bandwidth, set the time.
//
// Design.
// * A thread owns one VEC-wide channel chunk (16 bytes, narrowed as K1's
//   for C or the pointer's alignment) and loads that chunk's a and b into
//   registers once.
// * A block is TY rows of a strip of cw chunks, about 256 threads: cw is
//   the widest divisor of C / VEC up to 64 (the whole row where that is
//   under 8), so a block reads a and b for its strip only.  With whole rows
//   a block at the small shapes read 64 bytes of a and b a thread for 16
//   to 32 bytes of x: at ds8 several MB through L2 against 1.8 MB of x.
// * Grid (splits * strips, B), the strips of one row range adjacent: block
//   s of a strip takes rows [s N / splits, (s + 1) N / splits), so the
//   blocks' row counts differ by at most one and no block is a mostly
//   masked tail.  The plan gives a block at most APPLY_UNROLL row groups,
//   so a thread issues all its 16-byte loads before its first store, and
//   at least two blocks an SM wherever there are that many row groups: the
//   UNet's small shapes run in one wave of tall blocks with everything in
//   flight at once (fewer, taller blocks read a and b fewer times than a
//   full wave of occupancy), the large ones in whole waves of short blocks
//   whose ramps and tails overlap.
// * The activation after the loads land is what is left at the small
//   shapes, so it is kept to the MUFU's rate: in bf16 one tanh.approx an
//   element, in fp32 one ex2.approx and one rcp.approx (the exact expf and
//   division cost some 25 instructions an element and left the kernel
//   issue-bound below its bytes).
// * y is stored with the default cache policy: the next convolution reads
//   it from L2.
//
// B1 and B2, the backward, replace no Pallas kernel: the JAX package
// differentiates _xla_reference, the XLA formulation of the same norm, and
// XLA fuses that backward into a few passes over x and gy.  Run eagerly, the
// same autograd is some twenty-five full-size fp32 launches a norm.  Per
// batch row b and group g of cnt = N C / G elements, with f_c = 1 + fs_c (1
// without FiLM), w_c = scale_c f_c, the forward's a_c = r_g w_c and b_c, and
// x^ = (x - mean_g) r_g:
//
//   g^  = gy * d/dy [y sigmoid(swish y)] at the forward's y = a x + b
//         (gy where swish is 0)
//   S_c = sum_n g^,  T_c = sum_n g^ x^ = r_g (sum_n g^ (x - p_g) - m_g S_c)
//   dfb = S_c,  dfs = scale_c T_c + bias_c S_c
//   dscale = sum_b f_c T_c,  dbias = sum_b f_c S_c
//   dx  = r_g (w_c g^ - A_g - x^ B_g),  A_g = sum_{c in g} w_c S_c / cnt,
//         B_g = sum_{c in g} w_c T_c / cnt
//       = a_c g^ + kx_g (x - p_g) + k0_g,  kx = -r^2 B_g,  k0 = r (r B_g m_g - A_g)
//
// x enters every product less the group's pivot p_g (m_g = mean_g - p_g),
// as in K1's sums, and y too, as a_c (x - p_g) + (bias_c - m_g r_g scale_c)
// f_c + fb_c, so no term cancels where a group's mean lies far from zero.
// All arithmetic is fp32; dx is rounded once to x's dtype.
//
// Bound on the H100: a few flops per element against x and gy read twice
// and dx written once, with x read once more for the statistics (K1's
// moments entry): 12 bytes an element in bf16, so bound by device-memory
// bytes.  The bound quoted beside it (chip_smoke.py, kernel_ab.py, PERF.md)
// is x and gy read once and dx written once, 3 B N C es over 3.35 TB/s:
// 0.41 ms at the decoder training step's [32, 9216, 384] bf16.
//
// Design.
// * One foreign call, k2_group_norm_backward: K1's moments entry
//   (k2_group_norm_moments, unchanged, counted as a K1 launch) writes each
//   group's pivot and shifted sums [B, G, 3]; B1 and B2 derive the pivot,
//   m_g and r_g from them exactly as K1's finish does.
// * B1 (group_norm_bwd_reduce_kernel): a block is TY rows of a strip of cw
//   chunks, cw the narrowest divisor of C / VEC from 8 to 64 (a warp reads
//   128-byte rows), so that small batches still make enough blocks without
//   many row splits; the plan launches about four blocks an SM over the
//   batch rows, strips and row splits.  Timed against two, eight and
//   sixteen and against K2's wide strips (H100, whole backward): at batch
//   32 within 2 % of the best at ds2, ds4, ds8 and the fp32 head, and
//   7-8 % behind eight or sixteen with wide strips at ds1 (0.5263 against
//   0.4927 ms for eight); at batch 2, ds1 (LoRA and distillation run batch
//   1 or 2, and so does an FSDP rank), 10 % behind two blocks an SM
//   (0.0546 against 0.0496 ms) and ahead of wide strips (0.0625 ms).  No
//   one count was best at every shape.  The block computes its strip's
//   pivots, a and b once into shared memory; a thread owns one VEC-wide
//   chunk (16-byte loads as K1's), recomputes y and g^ in registers from
//   x and gy (BWD_UNROLL loads of each in flight) and sums S and
//   sum g^ (x - p) for its channels.  The
//   block sums its rows per channel through shared memory in a fixed order
//   into per-channel partials [B, splits, 2, C]; the last block of a batch
//   row (K1's per-b counter) sums them over the splits in order, writes dfb
//   and dfs in the FiLM pair's dtype, the per-b partials f T and f S of
//   dscale and dbias (one sum over b by the caller), the group sums A_g and
//   B_g (a warp a group with a shuffle tree), and B2's per-channel
//   coefficients a, b (about the pivot), kx, k0 and p.  That finish keeps
//   the group statistics and per-channel values in shared memory and
//   issues the loads of FINISH_UNROLL channels at once: it is the tail of
//   the launch.  Splits are capped at 32, since the finish reads every
//   split's partials of its batch row.
// * B2 (group_norm_bwd_apply_kernel): the same blocks, each thread loading
//   its chunk's five coefficients once and streaming its rows with
//   BWD_UNROLL loads of x and gy in flight; it recomputes g^ and writes
//   dx = a g^ + kx (x - p) + k0.
// * No float atomics: every sum is taken in an order fixed by the shape, so
//   the gradients are bitwise repeatable.  Nothing is allocated; where a
//   gradient is not wanted its pointer is null and it is not written (B2
//   is not launched without dx).
// * The activation's derivative uses __expf and __fdividef (ex2.approx,
//   rcp.approx), within a few fp32 ulp of the exact sigmoid.  SiLU takes
//   the general activation's kernels (z = 1 y is y exactly): fourteen B1
//   and fourteen B2 instantiations, not twenty-one of each, which takes
//   nvcc of this file from 28 to 21 s on the card's host at no cost to
//   the kernels (the forward alone: 8 s).

// Host entries.  ops/group_norm.py computes each shape's Plan once (K1's
// splits and rows, K2's splits and strip, both blocks' threads, the parameter
// layout) and passes its address, so a call passes only the data pointers,
// a scratch of its own and the stream.  k2_group_norm launches K1 and then
// K2 on the stream, with the coefficients in that scratch.
//
// ptxas (-Xptxas -v, sm_90a) prints both kernels' registers in
// chip_smoke.py's build phase.  K1: 40 to 64 registers (64 for bf16 with
// 16-byte loads, the pivots included), no spills; 16 bytes of static shared memory beside the
// dynamic (2 TY C + 2 G) floats, 16 KB to 24 KB at the path's shapes.  K2:
// 30 to 58 registers (54 to 58 for bf16 with 16-byte loads), no spills, no
// shared memory.

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef long long ll;

constexpr int UNROLL = 8;          // row loads in flight per thread
constexpr int MAX_THREADS = 1024;  // a block is TY rows x C / VEC chunks

template <int BYTES>
struct Raw;
template <>
struct Raw<16> { typedef uint4 type; };
template <>
struct Raw<8> { typedef uint2 type; };
template <>
struct Raw<4> { typedef unsigned int type; };
template <>
struct Raw<2> { typedef unsigned short type; };

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  typedef typename Raw<VEC * sizeof(T)>::type R;
  R r = __ldg(reinterpret_cast<const R*>(p));
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = to_f(e[i]);
}

// element i of a bf16 or fp32 parameter vector
__device__ __forceinline__ float load_param(const void* p, ll i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// the sums of a and b over the warp's lanes, the same in every lane: a
// butterfly adds the same two values in every lane at every level
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

struct Params {
  const void* scale;  // [C], null where moments is set
  const void* bias;   // [C]
  const void* fs;     // [B, C] with batch stride film_sb, or null
  const void* fb;
  ll film_sb;
  int param_bf16, film_bf16;
  float eps, cnt;
  float* moments;     // [B, G, 3] (pivot, sum, sum of squares) out, or null
};

template <typename T, int VEC>
__global__ void group_norm_stats_kernel(const T* __restrict__ x, int N, int C,
                                        int G, int rows_per_split,
                                        float* __restrict__ part,
                                        unsigned* __restrict__ counter,
                                        const Params p, float* __restrict__ a_out,
                                        float* __restrict__ b_out) {
  extern __shared__ float sm[];  // [2][TY][C] sums (+ 2 G), reused by the finish
  __shared__ bool is_last;
  const int CH = C / VEC;
  const int TY = blockDim.x / CH;
  const int tx = threadIdx.x % CH, ty = threadIdx.x / CH;
  const int b = blockIdx.y, sp = blockIdx.x, splits = gridDim.x;
  const int cs = C / G;
  const int n1 = min(N, (sp + 1) * rows_per_split);

  // 1. this thread's rows of its channel chunk, less its groups' pivots
  const T* x0 = x + static_cast<ll>(b) * N * C;
  float s1[VEC], s2[VEC], pv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s1[i] = s2[i] = 0.f;
    pv[i] = to_f(x0[(tx * VEC + i) / cs * cs]);
  }
  const T* xb = x0 + tx * VEC;
  int n = sp * rows_per_split + ty;
  for (; n + (UNROLL - 1) * TY < n1; n += UNROLL * TY) {
    float v[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      load_vec<T, VEC>(xb + static_cast<ll>(n + u * TY) * C, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = v[u][i] - pv[i];
        s1[i] += d;
        s2[i] = fmaf(d, d, s2[i]);
      }
  }
  for (; n < n1; n += TY) {
    float v[VEC];
    load_vec<T, VEC>(xb + static_cast<ll>(n) * C, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float d = v[i] - pv[i];
      s1[i] += d;
      s2[i] = fmaf(d, d, s2[i]);
    }
  }

  // 2. the block's per-group partials, summed in a fixed order: per channel
  // over the TY row groups, then one warp per group, its lanes over the
  // group's channels and a shuffle tree over the lanes
  float* r1 = sm;
  float* r2 = sm + TY * C;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    r1[ty * C + tx * VEC + i] = s1[i];
    r2[ty * C + tx * VEC + i] = s2[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int y = 0; y < TY; ++y) {
      t1 += r1[y * C + c];
      t2 += r2[y * C + c];
    }
    r1[c] = t1;  // row 0, column c: read above by this thread only
    r2[c] = t2;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;  // whole warps only (blockDim >= 128)
  // partials [B, splits, G, 2]
  float* out = part + (static_cast<ll>(b) * splits + sp) * G * 2;
  for (int g = warp; warp < nwarps && g < G; g += nwarps) {
    float t1 = 0.f, t2 = 0.f;
    for (int c = lane; c < cs; c += 32) {
      t1 += r1[g * cs + c];
      t2 += r2[g * cs + c];
    }
    warp_sum2(t1, t2);
    if (lane == 0) {
      out[2 * g] = t1;
      out[2 * g + 1] = t2;
    }
  }

  // 3. the last block of batch b to finish sums every block's partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&counter[b], 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // this thread's channels' parameters (at most VEC: C <= blockDim VEC),
  // loaded while the partials are read
  float sc[VEC], bi[VEC], f1[VEC], f2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    sc[k] = bi[k] = f1[k] = f2[k] = 0.f;
    if (c < C && p.moments == nullptr) {
      sc[k] = load_param(p.scale, c, p.param_bf16);
      bi[k] = load_param(p.bias, c, p.param_bf16);
      if (p.fs != nullptr) {
        const ll i = static_cast<ll>(b) * p.film_sb + c;
        f1[k] = load_param(p.fs, i, p.film_bf16);
        f2[k] = load_param(p.fb, i, p.film_bf16);
      }
    }
  }
  // P threads per group, all groups at once, each over every P-th split
  // (a warp reads consecutive groups: coalesced), then the P sums in order
  const int P = max(1, static_cast<int>(blockDim.x) / G);
  float* q1 = sm;            // [P][G]
  float* q2 = sm + P * G;    // [P][G]
  float* mean_s = sm + 2 * P * G;
  float* rstd_s = mean_s + G;
  const float* mine = part + static_cast<ll>(b) * splits * G * 2;
  for (int t = threadIdx.x; t < P * G; t += blockDim.x) {
    const int g = t % G, j = t / G;
    float t1 = 0.f, t2 = 0.f;
#pragma unroll 8
    for (int s = j; s < splits; s += P) {
      t1 += __ldcg(mine + (static_cast<ll>(s) * G + g) * 2);
      t2 += __ldcg(mine + (static_cast<ll>(s) * G + g) * 2 + 1);
    }
    q1[j * G + g] = t1;
    q2[j * G + g] = t2;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < P; ++j) {
      t1 += q1[j * G + g];
      t2 += q2[j * G + g];
    }
    if (p.moments != nullptr) {  // the shard's moments, for a sharded norm
      float* mo = p.moments + (static_cast<ll>(b) * G + g) * 3;
      mo[0] = to_f(x0[g * cs]);
      mo[1] = t1;
      mo[2] = t2;
      continue;
    }
    const float m = t1 / p.cnt;  // the mean less the pivot
    const float var = fmaxf(t2 / p.cnt - m * m, 0.f);
    mean_s[g] = to_f(x0[g * cs]) + m;
    rstd_s[g] = 1.f / sqrtf(var + p.eps);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c >= C || p.moments != nullptr) continue;
    const int g = c / cs;
    float a = rstd_s[g] * sc[k];
    float bb = bi[k] - mean_s[g] * a;
    if (p.fs != nullptr) {
      const float m = 1.f + f1[k];
      a *= m;
      bb = bb * m + f2[k];
    }
    a_out[static_cast<ll>(b) * C + c] = a;
    b_out[static_cast<ll>(b) * C + c] = bb;
  }
  if (threadIdx.x == 0) counter[b] = 0u;
}

// ---- K2: y = act(x * a + b) -------------------------------------------------

constexpr int APPLY_UNROLL = 4;  // row loads in flight per thread

__device__ __forceinline__ void from_f(float v, bf16* e) { *e = __float2bfloat16(v); }
__device__ __forceinline__ void from_f(float v, float* e) { *e = v; }

// VEC fp32 coefficients at p (16-byte aligned for VEC >= 4), 16 bytes a load
template <int VEC>
__device__ __forceinline__ void load_coef(const float* p, float* f) {
  constexpr int W = VEC < 4 ? VEC : 4;
  typedef typename Raw<W * 4>::type R;
#pragma unroll
  for (int i = 0; i < VEC; i += W) {
    R r = __ldg(reinterpret_cast<const R*>(p + i));
    const float* e = reinterpret_cast<const float*>(&r);
#pragma unroll
    for (int j = 0; j < W; ++j) f[i + j] = e[j];
  }
}

// MODE 0: none; 1: SiLU; 2: y * sigmoid(swish * y).  For bf16 x,
// y sigmoid(s y) = h + h tanh(s h) with h = y / 2: one tanh.approx (MUFU)
// an element, within 2^-11 of tanh, far below the bf16 rounding that
// follows.  For fp32 x, __expf and __fdividef (ex2.approx and rcp.approx),
// within a few fp32 ulp of expf and '/' at the values a norm gives; where
// 1 + e overflows, __fdividef gives -0, the limit.
__device__ __forceinline__ float tanh_approx(float v) {
  float r;
  asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <typename T, int MODE>
__device__ __forceinline__ float activate(float y, float swish) {
  if (MODE == 0) return y;
  if (sizeof(T) == 2) {
    const float h = 0.5f * y;
    return fmaf(h, tanh_approx(MODE == 1 ? h : swish * h), h);
  }
  return __fdividef(y, 1.f + __expf(MODE == 1 ? -y : -swish * y));
}

// A block is TY rows of a strip of cw chunks; grid.x is (row splits) x
// (strips), the strips of one row range adjacent.
template <typename T, int VEC, int MODE>
__global__ void __launch_bounds__(MAX_THREADS)
group_norm_apply_kernel(const void* __restrict__ xv, const float* __restrict__ a,
                        const float* __restrict__ b, void* __restrict__ yv, int N,
                        int C, int cw, float swish) {
  typedef typename Raw<VEC * sizeof(T)>::type R;
  const int strips = C / VEC / cw;
  const int TY = blockDim.x / cw;
  const int tx = threadIdx.x % cw, ty = threadIdx.x / cw;
  const int strip = blockIdx.x % strips, sp = blockIdx.x / strips;
  const int splits = gridDim.x / strips, bi = blockIdx.y;
  const int c = (strip * cw + tx) * VEC;
  const int r1 = static_cast<int>(static_cast<ll>(sp + 1) * N / splits);
  const ll base = static_cast<ll>(bi) * N * C + c;
  const T* x = static_cast<const T*>(xv) + base;
  T* y = static_cast<T*>(yv) + base;
  float av[VEC], bv[VEC];
  load_coef<VEC>(a + static_cast<ll>(bi) * C + c, av);
  load_coef<VEC>(b + static_cast<ll>(bi) * C + c, bv);
  for (int n = static_cast<int>(static_cast<ll>(sp) * N / splits) + ty; n < r1;
       n += APPLY_UNROLL * TY) {
    R v[APPLY_UNROLL];
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u)
      if (n + u * TY < r1)
        v[u] = __ldg(reinterpret_cast<const R*>(x + static_cast<ll>(n + u * TY) * C));
#pragma unroll
    for (int u = 0; u < APPLY_UNROLL; ++u) {
      if (n + u * TY >= r1) break;
      const T* e = reinterpret_cast<const T*>(&v[u]);
      R o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        from_f(activate<T, MODE>(fmaf(to_f(e[i]), av[i], bv[i]), swish), oe + i);
      *reinterpret_cast<R*>(y + static_cast<ll>(n + u * TY) * C) = o;
    }
  }
}

typedef void (*ApplyKernel)(const void*, const float*, const float*, void*, int, int,
                            int, float);

template <typename T, int VEC>
ApplyKernel apply_kernel_of_mode(int mode) {
  switch (mode) {
    case 0: return group_norm_apply_kernel<T, VEC, 0>;
    case 1: return group_norm_apply_kernel<T, VEC, 1>;
    case 2: return group_norm_apply_kernel<T, VEC, 2>;
  }
  return nullptr;
}

ApplyKernel apply_kernel_of(int x_bf16, int vec, int mode) {
  switch ((x_bf16 ? 100 : 0) + vec) {
    case 108: return apply_kernel_of_mode<bf16, 8>(mode);
    case 104: return apply_kernel_of_mode<bf16, 4>(mode);
    case 102: return apply_kernel_of_mode<bf16, 2>(mode);
    case 101: return apply_kernel_of_mode<bf16, 1>(mode);
    case 4: return apply_kernel_of_mode<float, 4>(mode);
    case 2: return apply_kernel_of_mode<float, 2>(mode);
    case 1: return apply_kernel_of_mode<float, 1>(mode);
  }
  return nullptr;
}

// ---- B1 and B2: the backward ------------------------------------------------

constexpr int BWD_UNROLL = 4;     // row loads of x and of gy in flight per thread
constexpr int BWD_THREADS = 256;  // a block is TY rows of a strip of at most 64 chunks
constexpr int FINISH_UNROLL = 4;  // B1's finish: channels a thread loads at once

struct BwdParams {
  const void* scale;  // [C]
  const void* bias;   // [C]
  const void* fs;     // [B, C] with batch stride film_sb, or null
  const void* fb;
  const float* moments;  // [B, G, 3] from K1's moments entry
  ll film_sb;
  int param_bf16, film_bf16;
  float eps, cnt, swish;
};

__device__ __forceinline__ void store_param(void* p, ll i, float v, int is_bf16) {
  if (is_bf16)
    static_cast<bf16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// a group's pivot, mean less the pivot and 1 / std from its moments, as
// K1's finish computes them
__device__ __forceinline__ void group_stats(const float* mo, float cnt, float eps,
                                            float& pivot, float& m, float& rstd) {
  pivot = mo[0];
  m = mo[1] / cnt;
  const float var = fmaxf(mo[2] / cnt - m * m, 0.f);
  rstd = 1.f / sqrtf(var + eps);
}

// channel c's scale, bias and FiLM pair (fs, fb; 0 without FiLM)
__device__ __forceinline__ void load_affine(const BwdParams& p, int b, int c, float& sc,
                                            float& bi, float& f1, float& f2) {
  sc = load_param(p.scale, c, p.param_bf16);
  bi = load_param(p.bias, c, p.param_bf16);
  f1 = f2 = 0.f;
  if (p.fs != nullptr) {
    const ll i = static_cast<ll>(b) * p.film_sb + c;
    f1 = load_param(p.fs, i, p.film_bf16);
    f2 = load_param(p.fb, i, p.film_bf16);
  }
}

// a channel's a and b about the pivot, folded as K1 folds them: the
// pre-activation is a (x - pivot) + b, with no term of the size of the mean
__device__ __forceinline__ void fold_coef(bool film, float sc, float bi, float f1,
                                          float f2, float m, float rstd, float& a,
                                          float& bb) {
  a = rstd * sc;
  bb = bi - m * a;
  if (film) {
    const float f = 1.f + f1;
    a *= f;
    bb = bb * f + f2;
  }
}

// g times the activation's derivative at the pre-activation y: for
// y sigmoid(z), z = swish y, that is sigmoid(z) (1 + z (1 - sigmoid(z)));
// MODE 0 (no activation) g itself.  __expf and __fdividef, as K2's fp32 path
__device__ __forceinline__ float act_grad_mode(float g, float y, float swish, int mode) {
  if (mode == 0) return g;
  const float z = swish * y;
  const float s = __fdividef(1.f, 1.f + __expf(-z));
  return g * s * fmaf(z, 1.f - s, 1.f);
}

// B1's finish, in the last block of batch row b: it sums the blocks'
// partials of row b over the splits in order and writes dfb, dfs, the
// affine partials and B2's coefficients, then zeroes the row's counter.
// None of it depends on x's dtype, the width or the activation, but out of
// line (compiled once) it cost B1 8 to 12 % of its time for 2 s of nvcc.
__device__ __forceinline__ void bwd_finish(const BwdParams& p, const float* __restrict__ part,
                                        unsigned* __restrict__ counter,
                                        float* __restrict__ coef, void* __restrict__ dfs,
                                        void* __restrict__ dfb, float* __restrict__ dgb,
                                        int b, int B, int C, int G, int splits) {
  extern __shared__ float sm[];
  const int cs = C / G;
  const float* mom = p.moments + static_cast<ll>(b) * G * 3;
  // the finish, in shared memory: per group the pivot, m, r and the sums
  // A_g, B_g; per channel w S, w T (w = scale (1 + fs)) and a, b
  float* ws = sm;
  float* wt = ws + C;
  float* fa = wt + C;
  float* fbb = fa + C;
  float* gp = fbb + C;
  float* gm = gp + G;
  float* gr = gm + G;
  float* ga = gr + G;
  float* gb = ga + G;
  for (int g = threadIdx.x; g < G; g += blockDim.x)
    group_stats(mom + 3 * g, p.cnt, p.eps, gp[g], gm[g], gr[g]);
  __syncthreads();
  // per channel, FINISH_UNROLL channels a thread at a time with all their
  // loads issued first: S_c, T_c = sum g^ x^ = r (U_c - m S_c), the FiLM
  // pair's gradients and the affine pair's partials of b
  const float* mine = part + static_cast<ll>(b) * splits * 2 * C;
  for (int c0 = threadIdx.x; c0 < C; c0 += FINISH_UNROLL * blockDim.x) {
    float S[FINISH_UNROLL], U[FINISH_UNROLL], sc[FINISH_UNROLL], bi[FINISH_UNROLL],
        f1[FINISH_UNROLL], f2[FINISH_UNROLL];
#pragma unroll
    for (int k = 0; k < FINISH_UNROLL; ++k) {
      const int c = c0 + k * blockDim.x;
      S[k] = U[k] = 0.f;
      if (c >= C) continue;
      load_affine(p, b, c, sc[k], bi[k], f1[k], f2[k]);
#pragma unroll 8
      for (int s = 0; s < splits; ++s) {
        S[k] += __ldcg(mine + static_cast<ll>(s) * 2 * C + c);
        U[k] += __ldcg(mine + static_cast<ll>(s) * 2 * C + C + c);
      }
    }
#pragma unroll
    for (int k = 0; k < FINISH_UNROLL; ++k) {
      const int c = c0 + k * blockDim.x;
      if (c >= C) break;
      const int g = c / cs;
      const float Tc = gr[g] * (U[k] - gm[g] * S[k]);
      const float f = p.fs == nullptr ? 1.f : 1.f + f1[k];
      const ll bc = static_cast<ll>(b) * C + c;
      if (dfb != nullptr) store_param(dfb, bc, S[k], p.film_bf16);
      if (dfs != nullptr) store_param(dfs, bc, fmaf(sc[k], Tc, bi[k] * S[k]), p.film_bf16);
      if (dgb != nullptr) {
        dgb[static_cast<ll>(b) * 2 * C + c] = f * Tc;
        dgb[static_cast<ll>(b) * 2 * C + C + c] = f * S[k];
      }
      ws[c] = sc[k] * f * S[k];
      wt[c] = sc[k] * f * Tc;
      fold_coef(p.fs != nullptr, sc[k], bi[k], f1[k], f2[k], gm[g], gr[g], fa[c], fbb[c]);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;  // whole warps only (blockDim >= 128)
  for (int g = warp; warp < nwarps && g < G; g += nwarps) {
    float t1 = 0.f, t2 = 0.f;
    for (int c = lane; c < cs; c += 32) {
      t1 += ws[g * cs + c];
      t2 += wt[g * cs + c];
    }
    warp_sum2(t1, t2);
    if (lane == 0) {
      ga[g] = t1 / p.cnt;
      gb[g] = t2 / p.cnt;
    }
  }
  __syncthreads();
  // B2's coefficients [5][B][C]: dx = a g^ + kx (x - pivot) + k0, with
  // kx = -r^2 B_g and k0 = r (r B_g m - A_g); a and b (about the pivot)
  // recompute g^
  const ll BC = static_cast<ll>(B) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cs;
    float* o = coef + static_cast<ll>(b) * C + c;
    o[0] = fa[c];
    o[BC] = fbb[c];
    o[2 * BC] = -gr[g] * gr[g] * gb[g];
    o[3 * BC] = gr[g] * fmaf(gr[g] * gb[g], gm[g], -ga[g]);
    o[4 * BC] = gp[g];
  }
  if (threadIdx.x == 0) counter[b] = 0u;
}

// B1.  A block is TY rows of a strip of cw chunks over rows
// [sp N / splits, (sp + 1) N / splits); grid.x is (row splits) x (strips),
// grid.y B.  The last block of a batch row sums the blocks' per-channel
// partials [B, splits, 2, C] and writes everything per channel and group.
template <typename T, int VEC, int MODE>
__global__ void __launch_bounds__(BWD_THREADS, 2)
group_norm_bwd_reduce_kernel(const void* __restrict__ xv, const void* __restrict__ gv,
                             int N, int C, int G, int cw, const BwdParams p,
                             float* __restrict__ part, unsigned* __restrict__ counter,
                             float* __restrict__ coef, void* __restrict__ dfs,
                             void* __restrict__ dfb, float* __restrict__ dgb) {
  typedef typename Raw<VEC * sizeof(T)>::type R;
  // [2][TY][W] sums and [3][W] coefficients, then the finish's 4 C + 5 G
  extern __shared__ float sm[];
  __shared__ bool is_last;
  const int strips = C / VEC / cw, W = cw * VEC;
  const int TY = blockDim.x / cw;
  const int tx = threadIdx.x % cw, ty = threadIdx.x / cw;
  const int strip = blockIdx.x % strips, sp = blockIdx.x / strips;
  const int splits = gridDim.x / strips, b = blockIdx.y, B = gridDim.y;
  const int cs = C / G;
  const int c0 = (strip * cw + tx) * VEC;
  const float* mom = p.moments + static_cast<ll>(b) * G * 3;

  // 1. the strip's channels' pivots, a and b, once a block through shared
  // memory (at the small shapes a thread sums only a few rows)
  float* cf = sm + 2 * TY * W;
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    float m, r, sc, bi, f1, f2, a = 0.f, bb = 0.f;
    group_stats(mom + 3 * ((strip * W + k) / cs), p.cnt, p.eps, cf[2 * W + k], m, r);
    if (MODE != 0) {
      load_affine(p, b, strip * W + k, sc, bi, f1, f2);
      fold_coef(p.fs != nullptr, sc, bi, f1, f2, m, r, a, bb);
    }
    cf[k] = a;
    cf[W + k] = bb;
  }
  __syncthreads();
  float av[VEC], bv[VEC], pv[VEC], s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    av[i] = cf[tx * VEC + i];
    bv[i] = cf[W + tx * VEC + i];
    pv[i] = cf[2 * W + tx * VEC + i];
    s1[i] = s2[i] = 0.f;
  }

  // 2. S = sum g^ and U = sum g^ (x - pivot) over this thread's rows, with
  // g^ the output gradient through the activation
  const ll base = static_cast<ll>(b) * N * C + c0;
  const T* x = static_cast<const T*>(xv) + base;
  const T* gy = static_cast<const T*>(gv) + base;
  const int r1 = static_cast<int>(static_cast<ll>(sp + 1) * N / splits);
  for (int n = static_cast<int>(static_cast<ll>(sp) * N / splits) + ty; n < r1;
       n += BWD_UNROLL * TY) {
    R xr[BWD_UNROLL], gr[BWD_UNROLL];
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u)
      if (n + u * TY < r1) {
        const ll o = static_cast<ll>(n + u * TY) * C;
        xr[u] = __ldg(reinterpret_cast<const R*>(x + o));
        gr[u] = __ldg(reinterpret_cast<const R*>(gy + o));
      }
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      if (n + u * TY >= r1) break;
      const T* xe = reinterpret_cast<const T*>(&xr[u]);
      const T* ge = reinterpret_cast<const T*>(&gr[u]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = to_f(xe[i]) - pv[i];
        const float gh = act_grad_mode(to_f(ge[i]), fmaf(d, av[i], bv[i]), p.swish, MODE);
        s1[i] += gh;
        s2[i] = fmaf(gh, d, s2[i]);
      }
    }
  }

  // 3. the block's per-channel partials, over its TY rows in order
  float* q1 = sm;
  float* q2 = sm + TY * W;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    q1[ty * W + tx * VEC + i] = s1[i];
    q2[ty * W + tx * VEC + i] = s2[i];
  }
  __syncthreads();
  float* out = part + (static_cast<ll>(b) * splits + sp) * 2 * C + strip * W;
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int y = 0; y < TY; ++y) {
      t1 += q1[y * W + c];
      t2 += q2[y * W + c];
    }
    out[c] = t1;
    out[C + c] = t2;
  }

  // 4. the last block of batch row b to finish sums every block's partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&counter[b], 1u) == static_cast<unsigned>(gridDim.x - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  bwd_finish(p, part, counter, coef, dfs, dfb, dgb, b, B, C, G, splits);
}

// B2.  The same blocks as B1's over rows [sp N / splits, (sp + 1) N /
// splits), each thread every TY-th row with BWD_UNROLL loads of x and of gy
// in flight.
template <typename T, int VEC, int MODE>
__global__ void __launch_bounds__(BWD_THREADS, 2)
group_norm_bwd_apply_kernel(const void* __restrict__ xv, const void* __restrict__ gv,
                            const float* __restrict__ coef, void* __restrict__ dxv,
                            int N, int C, int cw, float swish) {
  typedef typename Raw<VEC * sizeof(T)>::type R;
  const int strips = C / VEC / cw;
  const int TY = blockDim.x / cw;
  const int tx = threadIdx.x % cw, ty = threadIdx.x / cw;
  const int strip = blockIdx.x % strips, sp = blockIdx.x / strips;
  const int splits = gridDim.x / strips, bi = blockIdx.y;
  const int c = (strip * cw + tx) * VEC;
  const ll BC = static_cast<ll>(gridDim.y) * C;
  const float* co = coef + static_cast<ll>(bi) * C + c;
  float av[VEC], bv[VEC] = {}, kx[VEC], k0[VEC], pv[VEC];
  load_coef<VEC>(co, av);
  if (MODE != 0) load_coef<VEC>(co + BC, bv);
  load_coef<VEC>(co + 2 * BC, kx);
  load_coef<VEC>(co + 3 * BC, k0);
  load_coef<VEC>(co + 4 * BC, pv);
  const ll base = static_cast<ll>(bi) * N * C + c;
  const T* x = static_cast<const T*>(xv) + base;
  const T* gy = static_cast<const T*>(gv) + base;
  T* dx = static_cast<T*>(dxv) + base;
  const int r1 = static_cast<int>(static_cast<ll>(sp + 1) * N / splits);
  for (int n = static_cast<int>(static_cast<ll>(sp) * N / splits) + ty; n < r1;
       n += BWD_UNROLL * TY) {
    R xr[BWD_UNROLL], gr[BWD_UNROLL];
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u)
      if (n + u * TY < r1) {
        const ll o = static_cast<ll>(n + u * TY) * C;
        xr[u] = __ldg(reinterpret_cast<const R*>(x + o));
        gr[u] = __ldg(reinterpret_cast<const R*>(gy + o));
      }
#pragma unroll
    for (int u = 0; u < BWD_UNROLL; ++u) {
      if (n + u * TY >= r1) break;
      const T* xe = reinterpret_cast<const T*>(&xr[u]);
      const T* ge = reinterpret_cast<const T*>(&gr[u]);
      R o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float d = to_f(xe[i]) - pv[i];
        const float gh = act_grad_mode(to_f(ge[i]), fmaf(d, av[i], bv[i]), swish, MODE);
        from_f(fmaf(av[i], gh, fmaf(kx[i], d, k0[i])), oe + i);
      }
      *reinterpret_cast<R*>(dx + static_cast<ll>(n + u * TY) * C) = o;
    }
  }
}

typedef void (*BwdReduceKernel)(const void*, const void*, int, int, int, int,
                                const BwdParams, float*, unsigned*, float*, void*, void*,
                                float*);
typedef void (*BwdApplyKernel)(const void*, const void*, const float*, void*, int, int,
                               int, float);

template <typename T, int VEC>
void bwd_kernels_of_mode(int mode, BwdReduceKernel& reduce, BwdApplyKernel& apply) {
  switch (mode) {
#define K2_BWD(M)                                            \
  case M:                                                    \
    reduce = group_norm_bwd_reduce_kernel<T, VEC, M>;        \
    apply = group_norm_bwd_apply_kernel<T, VEC, M>;          \
    return;
    K2_BWD(0)
    case 1:  // swish 1 takes the general activation: z = 1 * y is y exactly
    K2_BWD(2)
#undef K2_BWD
  }
}

void bwd_kernels_of(int x_bf16, int vec, int mode, BwdReduceKernel& reduce,
                    BwdApplyKernel& apply) {
  reduce = nullptr;
  apply = nullptr;
  switch ((x_bf16 ? 100 : 0) + vec) {
    case 108: return bwd_kernels_of_mode<bf16, 8>(mode, reduce, apply);
    case 104: return bwd_kernels_of_mode<bf16, 4>(mode, reduce, apply);
    case 102: return bwd_kernels_of_mode<bf16, 2>(mode, reduce, apply);
    case 101: return bwd_kernels_of_mode<bf16, 1>(mode, reduce, apply);
    case 4: return bwd_kernels_of_mode<float, 4>(mode, reduce, apply);
    case 2: return bwd_kernels_of_mode<float, 2>(mode, reduce, apply);
    case 1: return bwd_kernels_of_mode<float, 1>(mode, reduce, apply);
  }
}

}  // namespace

// ---- host ------------------------------------------------------------------

// One GroupNorm layout's launch plan, filled once per shape by
// ops/group_norm.py (_Plan there, the same fields in the same order: 64-bit
// fields only, so neither side pads; k2_group_norm_layout lets it check).
struct Plan {
  long long B, N, C, G, vec, x_bf16;
  long long stats_splits, stats_rows, stats_threads;  // K1: grid.x, rows a block, block
  long long apply_splits, apply_cw, apply_threads;   // K2: row splits, strip, block
  long long swish_mode;                               // K2: MODE
  long long param_bf16, film_bf16, film_sb;           // K1's parameter layout
  long long bwd_cw, bwd_threads;                      // B1 and B2: strip, block
  long long bwd_splits, bwd_apply_splits;             // B1's and B2's row splits
  double eps, cnt, swish;
  void* counter;  // K1's per-b counters, zero
};

namespace {

template <typename T, int VEC>
int launch_stats(const Plan& q, const void* x, const Params& p, void* a, void* b,
                 void* part, cudaStream_t stream) {
  const int C = static_cast<int>(q.C), G = static_cast<int>(q.G);
  const int CH = C / VEC, threads = static_cast<int>(q.stats_threads);
  if (C % VEC || CH > MAX_THREADS || C % G || threads % CH || threads > MAX_THREADS)
    return -1;
  const int TY = threads / CH;
  // the block's sums, then the finish's [2][P][G] sums and 2 G statistics
  const size_t smem = (2 * static_cast<size_t>(TY) * C + 2 * G) * sizeof(float);
  auto kern = group_norm_stats_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<dim3(static_cast<unsigned>(q.stats_splits), static_cast<unsigned>(q.B)),
         threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<int>(q.N), C, G,
      static_cast<int>(q.stats_rows), static_cast<float*>(part),
      static_cast<unsigned*>(q.counter), p, static_cast<float*>(a),
      static_cast<float*>(b));
  return static_cast<int>(cudaGetLastError());
}

int stats_of_layout(const Plan* q, const void* x, const Params& p, void* a, void* b,
                    void* part, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K2_GN(KEY, T, V) \
  case KEY:              \
    return launch_stats<T, V>(*q, x, p, a, b, part, s);
  switch ((q->x_bf16 ? 100 : 0) + q->vec) {
    K2_GN(108, bf16, 8)
    K2_GN(104, bf16, 4)
    K2_GN(102, bf16, 2)
    K2_GN(101, bf16, 1)
    K2_GN(4, float, 4)
    K2_GN(2, float, 2)
    K2_GN(1, float, 1)
  }
#undef K2_GN
  return -1;
}

}  // namespace

// K1.  x: contiguous [B, N, C], bf16 (x_bf16 = 1) or fp32, read `vec`
// elements at a time (8, 4, 2 or 1 for bf16; 4, 2 or 1 for fp32; C % vec ==
// 0 and x aligned to vec elements).  The grid is (stats_splits, B), each
// block of stats_threads (TY rows of C / vec chunks) summing rows
// [s * stats_rows, (s + 1) * stats_rows), stats_rows a multiple of TY *
// UNROLL.  scale, bias: [C]; fs, fb: [B, C] with batch stride film_sb, or
// null; each pair bf16 or fp32 as its flag says.  a, b: [B, C] fp32
// outputs; part: the blocks' partials, B * stats_splits * G * 2 floats.
// Returns a cudaError_t (0 on success), or -1 for a shape or vector width
// it does not take.
extern "C" int k2_group_norm_stats(const Plan* q, const void* x, const void* scale,
                                   const void* bias, const void* fs, const void* fb,
                                   void* a, void* b, void* part, void* stream) {
  const Params p{scale, bias, fs, fb, q->film_sb,
                 static_cast<int>(q->param_bf16), static_cast<int>(q->film_bf16),
                 static_cast<float>(q->eps), static_cast<float>(q->cnt), nullptr};
  return stats_of_layout(q, x, p, a, b, part, stream);
}

// K1 on one shard of a row-sharded GroupNorm: the same launch as
// k2_group_norm_stats, whose finish writes each group's pivot and shifted
// sums, moments [B, G, 3] fp32 (pivot, sum (x - pivot), sum (x - pivot)^2),
// in place of a and b; the caller combines the shards' moments and hands
// the coefficients to K2.  Returns as k2_group_norm_stats.
extern "C" int k2_group_norm_moments(const Plan* q, const void* x, void* moments,
                                     void* part, void* stream) {
  const Params p{nullptr, nullptr, nullptr, nullptr, 0, 0, 0,
                 static_cast<float>(q->eps), static_cast<float>(q->cnt),
                 static_cast<float*>(moments)};
  return stats_of_layout(q, x, p, nullptr, nullptr, part, stream);
}

// K2.  x and y: contiguous [B, N, C] of x's dtype, both aligned to vec
// elements; a, b: [B, C] fp32, 16-byte aligned.  The grid is
// (apply_splits * strips, B) of apply_threads, TY rows of a strip of
// apply_cw chunks (strips = C / vec / apply_cw), a block taking any number
// of rows.  Returns a cudaError_t, or -1 for a shape, width or mode it
// does not take.
extern "C" int k2_group_norm_apply(const Plan* q, const void* x, const void* a,
                                   const void* b, void* y, void* stream) {
  const ApplyKernel kern = apply_kernel_of(static_cast<int>(q->x_bf16),
                                           static_cast<int>(q->vec),
                                           static_cast<int>(q->swish_mode));
  const long long CH = q->C / q->vec, cw = q->apply_cw, threads = q->apply_threads;
  if (kern == nullptr || q->C % q->vec || cw < 1 || CH % cw || threads % cw ||
      threads > MAX_THREADS)
    return -1;
  kern<<<dim3(static_cast<unsigned>(q->apply_splits * (CH / cw)),
              static_cast<unsigned>(q->B)),
         static_cast<unsigned>(threads), 0, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const float*>(a), static_cast<const float*>(b), y,
      static_cast<int>(q->N), static_cast<int>(q->C), static_cast<int>(cw),
      static_cast<float>(q->swish));
  return static_cast<int>(cudaGetLastError());
}

// The whole GroupNorm: K1, then K2, on one stream.  scratch: the call's
// own fp32 a and b ([B, C] each, a 16-byte aligned) and then K1's
// partials, 2 B C + B stats_splits G 2 floats.
extern "C" int k2_group_norm(const Plan* q, const void* x, const void* scale,
                             const void* bias, const void* fs, const void* fb,
                             float* scratch, void* y, void* stream) {
  const long long BC = q->B * q->C;
  float *a = scratch, *b = scratch + BC;
  const int err = k2_group_norm_stats(q, x, scale, bias, fs, fb, a, b, scratch + 2 * BC,
                                      stream);
  return err != 0 ? err : k2_group_norm_apply(q, x, a, b, y, stream);
}

// The whole backward: K1's moments, then B1, then B2 (where dx is wanted),
// on one stream.  x and gy: contiguous [B, N, C] of one dtype, aligned to
// vec elements; scale, bias, fs, fb as for K1 (fs, fb null without FiLM).
// scratch: B2's coefficients [5, B, C] (16-byte aligned), the affine
// partials [B, 2, C], the moments [B, G, 3], K1's partials
// (B stats_splits G 2) and B1's ([B, bwd_splits, 2, C]), in that order.
// dx ([B, N, C], x's dtype), dfs and dfb ([B, C], the FiLM pair's dtype) and
// dgb (the affine partials in scratch, summed over b by the caller) may each
// be null where that gradient is not wanted.  Returns a cudaError_t, or -1
// for a shape, width or mode it does not take.
extern "C" int k2_group_norm_backward(const Plan* q, const void* x, const void* gy,
                                      const void* scale, const void* bias, const void* fs,
                                      const void* fb, float* scratch, void* dx, void* dfs,
                                      void* dfb, float* dgb, void* stream) {
  BwdReduceKernel reduce;
  BwdApplyKernel apply;
  bwd_kernels_of(static_cast<int>(q->x_bf16), static_cast<int>(q->vec),
                 static_cast<int>(q->swish_mode), reduce, apply);
  const long long CH = q->C / q->vec, cw = q->bwd_cw, threads = q->bwd_threads;
  if (reduce == nullptr || q->C % q->vec || q->C % q->G || cw < 1 || CH % cw ||
      threads % cw || threads > BWD_THREADS || threads < 128 || q->bwd_splits < 1 ||
      q->bwd_apply_splits < 1)
    return -1;
  const long long BC = q->B * q->C;
  float* moments = scratch + 7 * BC;
  float* kpart = moments + 3 * q->B * q->G;
  float* bpart = kpart + q->B * q->stats_splits * q->G * 2;
  int err = k2_group_norm_moments(q, x, moments, kpart, stream);
  if (err != 0) return err;
  const BwdParams p{scale, bias, fs, fb, moments, q->film_sb,
                    static_cast<int>(q->param_bf16), static_cast<int>(q->film_bf16),
                    static_cast<float>(q->eps), static_cast<float>(q->cnt),
                    static_cast<float>(q->swish)};
  // the block's sums [2][TY][cw vec] and coefficients [3][cw vec], then
  // the finish's 4 C + 5 G floats
  const size_t smem = sizeof(float) * static_cast<size_t>(
      std::max(2 * threads * q->vec + 3 * cw * q->vec, 4 * q->C + 5 * q->G));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        reduce, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1(static_cast<unsigned>(q->bwd_splits * (CH / cw)),
                   static_cast<unsigned>(q->B));
  reduce<<<grid1, static_cast<unsigned>(threads), smem, s>>>(
      x, gy, static_cast<int>(q->N), static_cast<int>(q->C), static_cast<int>(q->G),
      static_cast<int>(cw), p, bpart, static_cast<unsigned*>(q->counter), scratch, dfs,
      dfb, dgb);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || dx == nullptr) return err;
  const dim3 grid2(static_cast<unsigned>(q->bwd_apply_splits * (CH / cw)),
                   static_cast<unsigned>(q->B));
  apply<<<grid2, static_cast<unsigned>(threads), 0, s>>>(
      x, gy, scratch, dx, static_cast<int>(q->N), static_cast<int>(q->C),
      static_cast<int>(cw), static_cast<float>(q->swish));
  return static_cast<int>(cudaGetLastError());
}

// What ops/group_norm.py mirrors: sizeof(Plan), UNROLL, APPLY_UNROLL,
// MAX_THREADS, BWD_UNROLL, BWD_THREADS, then each Plan field's offset in
// declared order.  Writes at
// most n of them to out and returns how many there are.
extern "C" int k2_group_norm_layout(long long* out, int n) {
#define K2_OFF(f) static_cast<long long>(offsetof(Plan, f))
  const long long v[] = {
      sizeof(Plan), UNROLL, APPLY_UNROLL, MAX_THREADS, BWD_UNROLL, BWD_THREADS,
      K2_OFF(B), K2_OFF(N), K2_OFF(C), K2_OFF(G), K2_OFF(vec), K2_OFF(x_bf16),
      K2_OFF(stats_splits), K2_OFF(stats_rows), K2_OFF(stats_threads),
      K2_OFF(apply_splits), K2_OFF(apply_cw), K2_OFF(apply_threads), K2_OFF(swish_mode),
      K2_OFF(param_bf16), K2_OFF(film_bf16), K2_OFF(film_sb),
      K2_OFF(bwd_cw), K2_OFF(bwd_threads), K2_OFF(bwd_splits), K2_OFF(bwd_apply_splits),
      K2_OFF(eps), K2_OFF(cnt), K2_OFF(swish), K2_OFF(counter)};
#undef K2_OFF
  const int count = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < count && i < n; ++i) out[i] = v[i];
  return count;
}
