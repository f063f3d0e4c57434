// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulation.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef long long ll;

constexpr int BN = 64;  // kv rows per tile
// row pitch (floats) of the partial score tiles: with 64 the eight row
// groups of a warp hit the same banks; 72 makes each float2 phase
// conflict-free
constexpr int SLD = BN + 8;

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
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        qf[kk][0] = ld32(qrow + kk * 16);
        qf[kk][1] = ld32(qrow + 8 * LD + kk * 16);
        qf[kk][2] = ld32(qrow + kk * 16 + 8);
        qf[kk][3] = ld32(qrow + 8 * LD + kk * 16 + 8);
      }
    }

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
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vrow = Vs + (kk * 16 + tig * 2) * LD + wd * DW + g;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        const bf16* vp = vrow + nt * 8;
        uint32_t b0 = ld16(vp) | (ld16(vp + LD) << 16);
        uint32_t b1 = ld16(vp + 8 * LD) | (ld16(vp + 9 * LD) << 16);
        mma_bf16_16816(oacc[nt], a, b0, b1);
      }
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
