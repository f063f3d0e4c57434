// GroupNorm statistics and coefficients for Hopper (sm_90a) in one launch
// (K1): per-(b, c) fp32 a and b such that GroupNorm(+affine)(+FiLM) of x is
// x * a + b, which the apply kernel (K2, ops/group_norm.py) then streams.
//
// Replaces the Pallas TPU kernel kandinsky2_tpu/ops/group_norm.py
// (_moments, kernel _moments_kernel) together with the XLA glue after it
// (_coefficients): on the TPU the glue fuses into the jitted program, in
// eager PyTorch it was some twenty small launches per call.  Here one
// launch reads x [B, N, C] (bf16 or fp32) once and writes a, b [B, C]:
//
//   mean_g = sum_{n, c in g} x / cnt,  ex2_g = sum x^2 / cnt,  cnt = N * C / G
//   var_g  = max(ex2_g - mean_g^2, 0)          (one pass, the JAX formula)
//   a = scale / sqrt(var_g + eps),  b = bias - mean_g * a
//   with FiLM (fs, fb):  a *= 1 + fs,  b = b * (1 + fs) + fb
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
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.9), printed by chip_smoke.py's build
// phase: 32 to 71 registers (71 for bf16 with 16-byte loads), no spills;
// 16 bytes of static shared memory beside the dynamic (2 TY C + 2 G)
// floats, 16 KB to 24 KB at the path's shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
  const void* scale;  // [C]
  const void* bias;   // [C]
  const void* fs;     // [B, C] with batch stride film_sb, or null
  const void* fb;
  ll film_sb;
  int param_bf16, film_bf16;
  float eps, cnt;
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

  // 1. this thread's rows of its channel chunk
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s1[i] = s2[i] = 0.f;
  const T* xb = x + static_cast<ll>(b) * N * C + tx * VEC;
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
        s1[i] += v[u][i];
        s2[i] = fmaf(v[u][i], v[u][i], s2[i]);
      }
  }
  for (; n < n1; n += TY) {
    float v[VEC];
    load_vec<T, VEC>(xb + static_cast<ll>(n) * C, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s1[i] += v[i];
      s2[i] = fmaf(v[i], v[i], s2[i]);
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
    if (c < C) {
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
    const float mean = t1 / p.cnt;
    const float var = fmaxf(t2 / p.cnt - mean * mean, 0.f);
    mean_s[g] = mean;
    rstd_s[g] = 1.f / sqrtf(var + p.eps);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c >= C) continue;
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

template <typename T, int VEC>
int launch(const void* x, int B, int N, int C, int G, int splits,
           int rows_per_split, void* part, void* counter, const Params& p,
           void* a, void* b, cudaStream_t stream) {
  const int CH = C / VEC;
  if (C % VEC || CH > MAX_THREADS || C % G) return -1;
  const int TY = CH >= 256 ? 1 : 256 / CH;
  const int threads = TY * CH;
  // the block's sums, then the finish's [2][P][G] sums and 2 G statistics
  const size_t smem = (2 * static_cast<size_t>(TY) * C + 2 * G) * sizeof(float);
  auto kern = group_norm_stats_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<dim3(splits, B), threads, smem, stream>>>(
      static_cast<const T*>(x), N, C, G, rows_per_split,
      static_cast<float*>(part), static_cast<unsigned*>(counter), p,
      static_cast<float*>(a), static_cast<float*>(b));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous [B, N, C], bf16 (x_bf16 = 1) or fp32, read `vec` elements
// at a time (8, 4, 2 or 1 for bf16; 4, 2 or 1 for fp32; C % vec == 0 and x
// aligned to vec elements).  The grid is (splits, B), each block summing
// rows [s * rows_per_split, (s + 1) * rows_per_split) with
// rows_per_split a multiple of TY * UNROLL.  part: fp32 scratch of
// B * splits * G * 2; counter: B unsigned ints, zero.  scale, bias: [C];
// fs, fb: [B, C] with batch stride film_sb, or null; each pair bf16 or fp32
// as its flag says.  a, b: [B, C] fp32 outputs.  Returns a cudaError_t
// (0 on success), or -1 for a shape or vector width it does not take.
extern "C" int k2_group_norm_stats(const void* x, int x_bf16, int vec, int B,
                                   int N, int C, int G, int splits,
                                   int rows_per_split, void* part,
                                   void* counter, const void* scale,
                                   const void* bias, int param_bf16,
                                   const void* fs, const void* fb,
                                   long long film_sb, int film_bf16, float eps,
                                   float cnt, void* a, void* b, void* stream) {
  Params p{scale, bias, fs, fb, film_sb, param_bf16, film_bf16, eps, cnt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = (x_bf16 ? 100 : 0) + vec;
#define K2_GN(KEY, T, V) \
  case KEY:              \
    return launch<T, V>(x, B, N, C, G, splits, rows_per_split, part, counter, p, a, b, s);
  switch (key) {
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
