// Flash attention for Hopper (sm_90a), bf16 in, fp32 accumulation: the
// forward (K3) and the backward (K4 dK/dV, K5 dQ), in one source so that one
// nvcc call builds them all.
//
// ---- Forward (K3) ----
//
// Replaces the Pallas TPU kernel kandinsky2_tpu/ops/flash_attention.py
// (_flash_kernel, launched by _flash_bhd): non-causal, unmasked
// softmax(q k^T / sqrt(d)) v with an online softmax, writing O and the
// per-row log-sum-exp (natural log) as [B*H, T] fp32 for a later backward.
//
// Design.
// * One block per (batch*head, q-tile).  The TPU's sequential kv grid axis
//   becomes a loop inside the block over 64-row K/V tiles staged in shared
//   memory with cp.async (the V copy overlaps the Q K^T product).
// * Tensor cores through mma.sync m16n8k16 (bf16 x bf16 -> fp32).  Each warp
//   owns 16 query rows.  The fp32 score fragment is rescaled, exponentiated
//   and repacked in registers as the bf16 A operand of the P V product
//   (the FlashAttention-2 register layout), so P never touches memory.
// * Running max, running sum and the O accumulator stay fp32, in registers.
// * Ragged tails: q rows >= T and kv rows >= S are zero-filled by cp.async;
//   scores of kv columns >= S are set to -inf.  The wrapper does no padding.
//
// Head dims.  d = 64 (UNet AttentionBlock): 4 warps along the rows, a
// 64-row q-tile, 27.6 KB of shared memory.
// d = 512 (MoVQ AttnBlock, one head over 9216 tokens): a 64-row fp32
// accumulator would be 128 KB, half the SM's register file, before the Q
// fragments and scores, so the block takes a q-tile of 16 rows and splits
// d over 8 warps: each warp keeps the O accumulator of its 64-wide d-slice
// in registers and computes a partial Q K^T over that slice; the 8 partial
// score tiles are summed through shared memory (36 KB with padding).  K
// and V tiles are 64 x 512 bf16 (65 KB each with padding), so the block
// uses 182 KB of dynamic shared memory, set with
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize).
//
// Bound on the H100: both head dims do 4*T*S*d FLOP per head against
// operands that fit in the 50 MB L2 (174 GFLOP against 19 MB for the MoVQ
// call), so the work is for the tensor cores; mma.sync reaches only part of
// the wgmma rate, which a later kernel (wgmma + TMA, warp-specialised)
// should recover.  At d = 512 each 16-row block also streams all of K and V
// from L2 and reads every warp's partial scores from shared memory; the
// padding of every shared-memory row keeps those accesses and the fragment
// loads free of bank conflicts.

// ---- Backward (K4 dK/dV, K5 dQ) ----
//
// Replaces the Pallas TPU kernels of kandinsky2_tpu/ops/flash_attention.py
// launched by _flash_bwd_bhd: _flash_bwd_dkv_kernel (K4) and
// _flash_bwd_dq_kernel (K5).  Both recompute the probabilities from the
// forward's saved log-sum-exp instead of storing the [T, S] matrix:
//
//   S  = scale * Q K^T            (fp32)
//   P  = exp(S - LSE)             (0 for q rows >= T and kv rows >= S)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale, delta = rowsum(dO * O) from the wrapper
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K
//
// Design.
// * Two kernels, as on the TPU, so that every output has one writer: no
//   atomics, and the result does not depend on the order blocks run in.
//   K5: one block per (batch*head, 64-row q-tile), looping over 64-row K/V
//   tiles; K4: one block per (batch*head, 64-row kv-tile), looping over
//   64-row Q/dO tiles.  The TPU's sequential grid axis becomes that loop.
// * Tensor cores through mma.sync m16n8k16; four warps, each owning 16 rows
//   of the block's tile.  The operand that stays fixed over the loop is held
//   in registers as A fragments (Q and dO in K5, K and V in K4).
// * K4 works in the transposed frame: each warp computes S^T = K Q^T and
//   dP^T = V dO^T for its 16 kv rows, so P^T and dS^T come out of the MMA in
//   the C-fragment layout that repacks in registers (c_to_a) as the A operand
//   of dV += P^T dO and dK += dS^T Q.  No tile of P or dS is transposed
//   through shared memory.  The cost is register pressure: three 16x64
//   fp32 tiles (P^T, then dS^T in its place, and the dK and dV
//   accumulators) beside the K and V fragments, about 130 live registers a
//   thread; dP^T is formed 8 columns at a time.
// * P and dS are rounded to bf16 only as MMA operands; everything else is
//   fp32 in registers.  LSE (natural log, [B*H, T], T unpadded, as the
//   forward writes it) is used in the log2 domain.
// * Ragged tails: Q/dO rows >= T and K/V rows >= S are zero-filled by
//   cp.async, P is masked to 0 outside [T, S], and rows past the tails are
//   not stored.  The wrapper pads nothing.
// * Shared memory: four 64 x 72 bf16 tiles (a row pitch of 72 keeps the
//   32-bit fragment loads and the 16-bit column loads free of bank
//   conflicts), 36 KB, plus K4's per-tile LSE and delta, within the 48 KB of
//   static shared memory.
//
// Bound on the H100: per head, K5 does 6 T S d FLOP and K4 8 T S d against
// operands that fit in L2, so both are for the tensor cores; mma.sync and
// the 16-bit loads of the B operands of P^T dO, dS^T Q and dS K keep them
// well below the wgmma rate, which a later kernel (wgmma + TMA,
// ldmatrix.trans) should recover.  Head dim 64 only: the UNet's attention,
// the one the training path differentiates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef long long ll;

// Device helpers of the forward and the backward: the bf16 mma.sync tile
// product, cp.async copies with zero-fill, and the fragment loads.  Fragment
// layouts are those of mma.sync.m16n8k16 (A row-major 16x16, B column-major
// 16x8, C 16x8 fp32): lane = 4 * g + tig holds A/C rows g and g + 8, columns
// 2 * tig, 2 * tig + 1 (+ 8), and B rows (k) 2 * tig, 2 * tig + 1 (+ 8) of
// column g.

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld16(const bf16* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p));
}

// Copy `rows` rows of D bf16 values (row stride `stride` elements) starting
// at global row `row0` into shared memory with row pitch LD; rows at or past
// `limit` are zero-filled.
template <int D, int LD, int NTHREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          ll stride, int row0, int rows,
                                          int limit) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * CPR; c += NTHREADS) {
    int r = c / CPR;
    int col = (c % CPR) * 8;
    bool ok = row0 + r < limit;
    const bf16* g = src + (ok ? static_cast<ll>(row0 + r) * stride : 0) + col;
    cp_async16(dst + r * LD + col, g, ok);
  }
}

// A fragments (16 rows x 16k per k-step) of the 16-row slice of a
// shared-memory tile that starts at `row` (pitch LD): the operand held in
// registers across a loop (Q in the forward, K and V in the dK/dV pass).
template <int KSTEPS, int LD>
__device__ __forceinline__ void load_a_frags(uint32_t (*f)[4], const bf16* row) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    f[kk][0] = ld32(row + kk * 16);
    f[kk][1] = ld32(row + 8 * LD + kk * 16);
    f[kk][2] = ld32(row + kk * 16 + 8);
    f[kk][3] = ld32(row + 8 * LD + kk * 16 + 8);
  }
}

// The C fragments of n-tiles 2 kk and 2 kk + 1 of a 16-row fp32 tile,
// rounded to bf16 and repacked in registers as the A operand of k-step kk
// (the FlashAttention-2 register layout): the tile never touches memory.
__device__ __forceinline__ void c_to_a(uint32_t* a, float (*c)[4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// acc[16 x 8*NT] += a[16 x 16] * X[16 x 8*NT], where X is rows kk*16 ..
// kk*16+15 of a row-major shared-memory tile (pitch LD) whose rows are the
// k index: `x` points at row 16 kk + 2 tig, column g.
template <int NT, int LD>
__device__ __forceinline__ void mma_ab(float (*acc)[4], const uint32_t* a,
                                       const bf16* x) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const bf16* p = x + nt * 8;
    uint32_t b0 = ld16(p) | (ld16(p + LD) << 16);
    uint32_t b1 = ld16(p + 8 * LD) | (ld16(p + 9 * LD) << 16);
    mma_bf16_16816(acc[nt], a, b0, b1);
  }
}

// acc[16 x 8] += A[16 x 16*KSTEPS] * Y^T, where Y is an 8-row slice of a
// row-major shared-memory tile whose columns are the k index: `y` points at
// row g, column 2 tig.
template <int KSTEPS>
__device__ __forceinline__ void mma_abt(float* acc, uint32_t (*a)[4],
                                        const bf16* y) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    mma_bf16_16816(acc, a[kk], ld32(y + kk * 16), ld32(y + kk * 16 + 8));
  }
}

// ---- Forward (K3) ----

constexpr int BN = 64;  // kv rows per tile
// row pitch (floats) of the partial score tiles: with 64 the eight row
// groups of a warp hit the same banks; 72 makes each float2 phase
// conflict-free
constexpr int SLD = BN + 8;

template <int D, int WM, int WD>
__global__ void __launch_bounds__(WM * WD * 32)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int T, int S,
                 ll qsb, ll qsh, ll qst, ll ksb, ll ksh, ll kst,
                 ll vsb, ll vsh, ll vst, ll osb, ll osh, ll ost,
                 float scale_log2) {
  constexpr int BM = 16 * WM;      // q rows per block
  constexpr int DW = D / WD;       // d-slice per warp
  constexpr int LD = D + 8;        // padded shared-memory row (elements)
  constexpr int NT_S = BN / 8;     // score n-tiles per warp
  constexpr int NT_O = DW / 8;     // output n-tiles per warp
  constexpr int KQ = DW / 16;      // k-steps of Q K^T per warp
  constexpr int NTHREADS = WM * WD * 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BM * LD;
  bf16* Vs = Ks + BN * LD;
  float* Sp = reinterpret_cast<float*>(Vs + BN * LD);  // [WD][BM][SLD]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WD, wd = warp % WD;
  const int g = lane >> 2, tig = lane & 3;

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;

  load_tile<D, LD, NTHREADS>(Qs, qb, qst, m0, BM, T);
  cp_async_commit();

  uint32_t qf[KQ][4];
  float oacc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};

  const bf16* qrow = Qs + (wm * 16 + g) * LD + wd * DW + tig * 2;
  const int ntiles = (S + BN - 1) / BN;
  for (int j = 0; j < ntiles; ++j) {
    const int n0 = j * BN;
    __syncthreads();  // every warp is done with the previous K/V/Sp tiles
    load_tile<D, LD, NTHREADS>(Ks, kb, kst, n0, BN, S);
    cp_async_commit();
    load_tile<D, LD, NTHREADS>(Vs, vb, vst, n0, BN, S);
    cp_async_commit();
    cp_async_wait<1>();  // Q and K have landed; V may still be in flight
    __syncthreads();
    if (j == 0) load_a_frags<KQ, LD>(qf, qrow);

    // S = Q K^T over this warp's d-slice
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const bf16* krow = Ks + (nt * 8 + g) * LD + wd * DW + tig * 2;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        mma_bf16_16816(s[nt], qf[kk], ld32(krow + kk * 16),
                       ld32(krow + kk * 16 + 8));
      }
    }
    if (WD > 1) {
      // sum the partial score tiles of the WD warps sharing these rows
      float* mine = Sp + (wd * BM + wm * 16 + g) * SLD + tig * 2;
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        *reinterpret_cast<float2*>(mine + nt * 8) = make_float2(s[nt][0], s[nt][1]);
        *reinterpret_cast<float2*>(mine + 8 * SLD + nt * 8) =
            make_float2(s[nt][2], s[nt][3]);
      }
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      }
      for (int w = 0; w < WD; ++w) {
        const float* part = Sp + (w * BM + wm * 16 + g) * SLD + tig * 2;
#pragma unroll
        for (int nt = 0; nt < NT_S; ++nt) {
          float2 lo = *reinterpret_cast<const float2*>(part + nt * 8);
          float2 hi = *reinterpret_cast<const float2*>(part + 8 * SLD + nt * 8);
          s[nt][0] += lo.x;
          s[nt][1] += lo.y;
          s[nt][2] += hi.x;
          s[nt][3] += hi.y;
        }
      }
    }

    // online softmax in the log2 domain; rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mloc[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int col = n0 + nt * 8 + tig * 2 + (e & 1);
        float val = col < S ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][e] = val;
        mloc[e >> 1] = fmaxf(mloc[e >> 1], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mloc[r] = fmaxf(mloc[r], __shfl_xor_sync(0xffffffffu, mloc[r], 1));
      mloc[r] = fmaxf(mloc[r], __shfl_xor_sync(0xffffffffu, mloc[r], 2));
      float m_new = fmaxf(m_i[r], mloc[r]);
      alpha[r] = exp2f(m_i[r] - m_new);
      m_i[r] = m_new;
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] - m_i[e >> 1]);
        s[nt][e] = p;
        rsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_i[r] = l_i[r] * alpha[r] + rsum[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      oacc[nt][0] *= alpha[0];
      oacc[nt][1] *= alpha[0];
      oacc[nt][2] *= alpha[1];
      oacc[nt][3] *= alpha[1];
    }

    cp_async_wait<0>();
    __syncthreads();  // V tile visible to every warp

    // O += P V over this warp's d-slice
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s, kk);
      mma_ab<NT_O, LD>(oacc, a, Vs + (kk * 16 + tig * 2) * LD + wd * DW + g);
    }
  }

  // epilogue: O / l in the input dtype, LSE = ln(l) + max in natural log
  const float LN2 = 0.6931471805599453f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + wm * 16 + g + 8 * r;
    if (row >= T) continue;
    const float inv = 1.f / l_i[r];
    bf16* orow = o + b * osb + h * osh + static_cast<ll>(row) * ost + wd * DW +
                 tig * 2;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8) = __floats2bfloat162_rn(
          oacc[nt][2 * r] * inv, oacc[nt][2 * r + 1] * inv);
    }
    if (wd == 0 && tig == 0) {
      lse[static_cast<ll>(bh) * T + row] = (m_i[r] + log2f(l_i[r])) * LN2;
    }
  }
}

template <int D, int WM, int WD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int T, int S, const ll* st, cudaStream_t stream) {
  constexpr int BM = 16 * WM;
  constexpr int LD = D + 8;
  size_t smem = static_cast<size_t>(BM + 2 * BN) * LD * sizeof(bf16);
  if (WD > 1) smem += static_cast<size_t>(WD) * BM * SLD * sizeof(float);
  auto kern = flash_fwd_kernel<D, WM, WD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + BM - 1) / BM, B * H);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  kern<<<grid, WM * WD * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, T, S, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// ---- Backward (K4, K5), head dim 64 ----

namespace bwd {

constexpr int D = 64;
constexpr int BM = 64;  // q rows per tile
constexpr int BN = 64;  // kv rows per tile
constexpr int LD = D + 8;
constexpr int NTHREADS = 128;
constexpr int KSTEPS = D / 16;  // k-steps of a product over d
constexpr int NT_D = D / 8;     // n-tiles of a 16 x d tile
constexpr int NT_R = 64 / 8;    // n-tiles of a 16 x 64 tile of P or dS
constexpr float LOG2E = 1.4426950408889634f;

// Element strides (batch, head, row) of the [B, L, H, D] tensors, in the
// order q, k, v, dO, dQ, dK, dV.
struct Strides {
  ll s[21];
};

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int H, T, S;
  float scale;  // 1 / sqrt(D)
  Strides st;
};

// Tensor `i` (in the order of Strides) of batch b and head h, and its row
// stride.  Kernel parameters are indexed with constants only, so the
// struct stays in the parameter bank.
#define HEAD(ptr, i) ((ptr) + b * a.st.s[3 * (i)] + h * a.st.s[3 * (i) + 1])
#define ROW_STRIDE(i) (a.st.s[3 * (i) + 2])

__device__ __forceinline__ void store_rows(bf16* out, ll row_stride,
                                           float (*acc)[4], int row0, int limit,
                                           int g, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= limit) continue;
    bf16* p = out + static_cast<ll>(row) * row_stride + tig * 2;
#pragma unroll
    for (int nt = 0; nt < NT_D; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(p + nt * 8) =
          __floats2bfloat162_rn(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
}

// K5: dQ for one 64-row q-tile.
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(const Args a) {
  __shared__ __align__(16) bf16 Qs[BM * LD];
  __shared__ __align__(16) bf16 dOs[BM * LD];
  __shared__ __align__(16) bf16 Ks[BN * LD];
  __shared__ __align__(16) bf16 Vs[BN * LD];

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const float scale_log2 = a.scale * LOG2E;

  load_tile<D, LD, NTHREADS>(Qs, HEAD(a.q, 0), ROW_STRIDE(0), m0, BM, a.T);
  load_tile<D, LD, NTHREADS>(dOs, HEAD(a.dout, 3), ROW_STRIDE(3), m0,
                             BM, a.T);
  cp_async_commit();

  // this thread's rows: g (C elements 0, 1) and g + 8 (elements 2, 3)
  float lse2[2], dlt[2];
  bool row_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    row_ok[r] = row < a.T;
    const ll i = static_cast<ll>(bh) * a.T + row;
    lse2[r] = row_ok[r] ? a.lse[i] * LOG2E : 0.f;
    dlt[r] = row_ok[r] ? a.delta[i] : 0.f;
  }

  uint32_t qf[KSTEPS][4], dof[KSTEPS][4];
  float dq[NT_D][4];
#pragma unroll
  for (int nt = 0; nt < NT_D; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;

  const bf16* kb = HEAD(a.k, 1);
  const bf16* vb = HEAD(a.v, 2);
  const int ntiles = (a.S + BN - 1) / BN;
  for (int j = 0; j < ntiles; ++j) {
    const int n0 = j * BN;
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile<D, LD, NTHREADS>(Ks, kb, ROW_STRIDE(1), n0, BN, a.S);
    cp_async_commit();
    load_tile<D, LD, NTHREADS>(Vs, vb, ROW_STRIDE(2), n0, BN, a.S);
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and K have landed; V may be in flight
    __syncthreads();
    if (j == 0) {
      load_a_frags<KSTEPS, LD>(qf, Qs + (warp * 16 + g) * LD + tig * 2);
      load_a_frags<KSTEPS, LD>(dof, dOs + (warp * 16 + g) * LD + tig * 2);
    }

    // P = exp(scale Q K^T - LSE), masked past S and T
    float p[NT_R][4];
#pragma unroll
    for (int nt = 0; nt < NT_R; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = 0.f;
      mma_abt<KSTEPS>(p[nt], qf, Ks + (nt * 8 + g) * LD + tig * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + tig * 2 + (e & 1);
        p[nt][e] = (col < a.S && row_ok[e >> 1])
                       ? exp2f(p[nt][e] * scale_log2 - lse2[e >> 1])
                       : 0.f;
      }
    }

    cp_async_wait<0>();
    __syncthreads();  // V tile visible to every warp

    // dS = P (dO V^T - delta) scale, in place of P
#pragma unroll
    for (int nt = 0; nt < NT_R; ++nt) {
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_abt<KSTEPS>(dp, dof, Vs + (nt * 8 + g) * LD + tig * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[nt][e] = p[nt][e] * (dp[e] - dlt[e >> 1]) * a.scale;
      }
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t af[4];
      c_to_a(af, p, kk);
      mma_ab<NT_D, LD>(dq, af, Ks + (kk * 16 + tig * 2) * LD + g);
    }
  }

  store_rows(HEAD(a.dq, 4), ROW_STRIDE(4), dq, m0 + warp * 16, a.T,
             g, tig);
}

// K4: dK and dV for one 64-row kv-tile.
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(const Args a) {
  __shared__ __align__(16) bf16 Ks[BN * LD];
  __shared__ __align__(16) bf16 Vs[BN * LD];
  __shared__ __align__(16) bf16 Qs[BM * LD];
  __shared__ __align__(16) bf16 dOs[BM * LD];
  __shared__ float lse_s[BM];    // log2 domain, 0 past T
  __shared__ float delta_s[BM];  // 0 past T

  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const float scale_log2 = a.scale * LOG2E;

  load_tile<D, LD, NTHREADS>(Ks, HEAD(a.k, 1), ROW_STRIDE(1), n0, BN,
                             a.S);
  load_tile<D, LD, NTHREADS>(Vs, HEAD(a.v, 2), ROW_STRIDE(2), n0, BN,
                             a.S);
  cp_async_commit();

  bool kv_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kv_ok[r] = n0 + warp * 16 + g + 8 * r < a.S;

  uint32_t kf[KSTEPS][4], vf[KSTEPS][4];
  float dk[NT_D][4], dv[NT_D][4];
#pragma unroll
  for (int nt = 0; nt < NT_D; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  const bf16* qb = HEAD(a.q, 0);
  const bf16* dob = HEAD(a.dout, 3);
  const ll row_base = static_cast<ll>(bh) * a.T;
  const int ntiles = (a.T + BM - 1) / BM;
  for (int i = 0; i < ntiles; ++i) {
    const int m0 = i * BM;
    __syncthreads();  // every warp is done with the previous Q/dO tiles
    load_tile<D, LD, NTHREADS>(Qs, qb, ROW_STRIDE(0), m0, BM, a.T);
    cp_async_commit();
    load_tile<D, LD, NTHREADS>(dOs, dob, ROW_STRIDE(3), m0, BM, a.T);
    cp_async_commit();
    if (threadIdx.x < BM) {
      const int row = m0 + threadIdx.x;
      const bool ok = row < a.T;
      lse_s[threadIdx.x] = ok ? a.lse[row_base + row] * LOG2E : 0.f;
      delta_s[threadIdx.x] = ok ? a.delta[row_base + row] : 0.f;
    }
    cp_async_wait<1>();  // K, V and Q have landed; dO may be in flight
    __syncthreads();
    if (i == 0) {
      load_a_frags<KSTEPS, LD>(kf, Ks + (warp * 16 + g) * LD + tig * 2);
      load_a_frags<KSTEPS, LD>(vf, Vs + (warp * 16 + g) * LD + tig * 2);
    }

    // P^T = exp(scale K Q^T - LSE[col]), masked past T (columns) and S (rows)
    float p[NT_R][4];
#pragma unroll
    for (int nt = 0; nt < NT_R; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = 0.f;
      mma_abt<KSTEPS>(p[nt], kf, Qs + (nt * 8 + g) * LD + tig * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + tig * 2 + (e & 1);
        p[nt][e] = (m0 + qc < a.T && kv_ok[e >> 1])
                       ? exp2f(p[nt][e] * scale_log2 - lse_s[qc])
                       : 0.f;
      }
    }

    cp_async_wait<0>();
    __syncthreads();  // dO tile visible to every warp

    // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t af[4];
      c_to_a(af, p, kk);
      mma_ab<NT_D, LD>(dv, af, dOs + (kk * 16 + tig * 2) * LD + g);
    }

    // dS^T = P^T (V dO^T - delta[col]) scale, in place of P^T
#pragma unroll
    for (int nt = 0; nt < NT_R; ++nt) {
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_abt<KSTEPS>(dp, vf, dOs + (nt * 8 + g) * LD + tig * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + tig * 2 + (e & 1);
        p[nt][e] = p[nt][e] * (dp[e] - delta_s[qc]) * a.scale;
      }
    }

    // dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t af[4];
      c_to_a(af, p, kk);
      mma_ab<NT_D, LD>(dk, af, Qs + (kk * 16 + tig * 2) * LD + g);
    }
  }

  store_rows(HEAD(a.dk, 5), ROW_STRIDE(5), dk, n0 + warp * 16, a.S, g,
             tig);
  store_rows(HEAD(a.dv, 6), ROW_STRIDE(6), dv, n0 + warp * 16, a.S, g,
             tig);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk, void* dv,
               int H, int T, int S, const ll* strides) {
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.H = H;
  a.T = T;
  a.S = S;
  a.scale = 1.f / sqrtf(static_cast<float>(D));
  for (int i = 0; i < 21; ++i) a.st.s[i] = strides[i];
  return a;
}

// K5 (dkv false): one block per 64-row q-tile; K4 (dkv true): one block per
// 64-row kv-tile.
int launch(bool dkv, const Args& a, int B, cudaStream_t stream) {
  if (dkv) {
    dim3 grid((a.S + BN - 1) / BN, B * a.H);
    flash_bwd_dkv_kernel<<<grid, NTHREADS, 0, stream>>>(a);
  } else {
    dim3 grid((a.T + BM - 1) / BM, B * a.H);
    flash_bwd_dq_kernel<<<grid, NTHREADS, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd

}  // namespace

// q: [B, T, H, D] and k, v: [B, S, H, D] given by element strides
// st = {q_b, q_h, q_t, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_t} with the
// last dim contiguous and 16-byte aligned rows; o like q; lse [B*H, T] fp32.
// Returns a cudaError_t (0 on success), or -1 for an unsupported head dim.
extern "C" int k2_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int H, int T,
                                 int S, int D, const ll* strides,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64, 4, 1>(q, k, v, o, lse, B, H, T, S, strides, s);
  if (D == 512) return launch<512, 1, 8>(q, k, v, o, lse, B, H, T, S, strides, s);
  return -1;
}

// q, dO: [B, T, H, D]; k, v: [B, S, H, D]; lse, delta: [B*H, T] fp32; the
// outputs like their inputs.  `strides` holds the element strides (batch,
// head, row) of q, k, v, dO, dQ, dK, dV, with the last dim contiguous and
// 16-byte aligned rows.  Each entry point returns a cudaError_t (0 on
// success), or -1 for an unsupported head dim.

// K5: dQ.  dk and dv are not touched.
extern "C" int k2_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dq, void* dk,
                                    void* dv, int B, int H, int T, int S,
                                    int Dh, const ll* strides, void* stream) {
  if (Dh != bwd::D) return -1;
  return bwd::launch(false, bwd::make_args(q, k, v, dout, lse, delta, dq, dk,
                                           dv, H, T, S, strides),
                     B, static_cast<cudaStream_t>(stream));
}

// K4: dK and dV.  dq is not touched.
extern "C" int k2_flash_bwd_dkv_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, void* dk, void* dv, int B, int H,
                                     int T, int S, int Dh, const ll* strides,
                                     void* stream) {
  if (Dh != bwd::D) return -1;
  return bwd::launch(true, bwd::make_args(q, k, v, dout, lse, delta, dq, dk,
                                          dv, H, T, S, strides),
                     B, static_cast<cudaStream_t>(stream));
}
