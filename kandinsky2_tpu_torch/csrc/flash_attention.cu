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
// The scale 1/sqrt(d) is applied in fp32 and P is rounded to bf16 before
// P V, at both head dims.
//
// Bound on the H100: 4 T S d FLOP per head against operands that fit in
// the 50 MB L2, so the work is for the tensor cores: 989 TFLOP/s of bf16
// (34 us at the UNet's ds2 call, B*H 24, T 2304, S 2391; 176 us at the
// MoVQ's d = 512 call, T = S = 9216).
//
// d = 64 (UNet AttentionBlock): wgmma + TMA, warp-specialised.
// * One block per (batch*head, q-tile): two or three consumer warpgroups
//   of 64 q rows each and one producer warp (288 or 416 threads); the
//   launch picks the count that needs fewer waves of blocks over the SMs.
// * The producer's lane 0 issues TMA loads (cp.async.bulk.tensor, 4-d
//   tensor maps over (d, H, T or S, B) with byte strides, so any
//   16-byte-aligned strided view is read in place and the out-of-bounds
//   zero fill stops at T or S, never reading the next batch's rows): Q once,
//   then 128-row K and V tiles into a ring of STAGES stages, each with a
//   "full" mbarrier per tensor (K and V land separately, so S = Q K^T
//   starts before V arrives) and one "empty" mbarrier the consumers arrive
//   on when they are done with the stage.
// * Every tile is 64 bf16 = 128 bytes wide, so the TMA writes it with the
//   128-byte swizzle that wgmma reads without bank conflicts.
// * Consumer warpgroups: S = Q K^T with wgmma.m64n128k16 from shared memory
//   (K-major K), the online softmax in registers in the log2 domain, then
//   O += P V with wgmma.m64n64k16, P as the A operand from registers (the
//   fp32 S fragment repacked as bf16) and V from shared memory as an
//   MN-major B (the transpose flag), so V is never transposed.
// * Ragged tails: the TMA zero-fills rows past T and S; scores of kv columns
//   >= S are set to -inf; rows >= T are not stored.  No padding.
// * One block per SM (81 or 89 KB of shared memory): the ds2 call's 12 x 24
//   = 288 blocks of three warpgroups run in 2.2 waves.
//
// d = 512 (MoVQ AttnBlock, one head over 9216 tokens): the same machinery.
// * A 64-row fp32 O accumulator of 512 columns is 128 KB, more than one
//   warpgroup's registers, so one block takes 64 q rows with four consumer
//   warpgroups and one producer warp (544 threads).  Warpgroup w owns
//   O columns 128 w .. + 127 (64 registers a thread) and score columns
//   16 w .. + 15 of each 64-row kv tile: S over the full d with
//   wgmma.m64n16k16 (32 k-steps), so no partial scores are exchanged.
// * A TMA box with the 128-byte swizzle is at most 64 bf16 wide, so each
//   512-wide row of Q, K and V loads as 8 boxes into 8 swizzled sub-tiles.
//   Shared memory: Q 64 KB, one K and one V tile of 64 rows, 64 KB each,
//   P 8 KB, 203 KB in all.  K and V have their own full and empty
//   barriers, so K of tile j + 1 loads while P V of tile j runs and V of
//   tile j + 1 while S of tile j + 1 runs.
// * Online softmax across the four warpgroups: each writes its row maxima
//   to shared memory, a named barrier (bar.sync 1, 512) joins the
//   consumers, and every warpgroup takes the same maximum over the four.
//   Each writes its 16 columns of P to shared memory as bf16 in the
//   swizzled layout (fence.proxy.async before the barrier), and each
//   warpgroup runs O += P V with P as a shared-memory A operand and its
//   128 columns of V as an MN-major B (two 64-column sub-tiles, 8 KB apart
//   as the leading-byte offset).  Row sums stay per warpgroup until the
//   epilogue adds the four.
// * 9216 / 64 = 144 blocks on 132 SMs with one block per SM (203 KB of
//   shared memory): the last 12 blocks run as a second wave.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.9), printed by chip_smoke.py's build
// phase: d = 64 126 registers with two or three consumer warpgroups, no
// spills, 81 or 89 KB of dynamic shared memory; d = 512 96 registers and 48
// bytes of spill stores and loads (the 544-thread block caps the
// registers), 203 KB of dynamic shared memory.

// ---- Backward (K4 dK/dV, K5 dQ) ----
//
// Replaces the Pallas TPU kernels of kandinsky2_tpu/ops/flash_attention.py
// launched by _flash_bwd_bhd: _flash_bwd_dq_kernel (K5) and
// _flash_bwd_dkv_kernel (K4), and the delta = rowsum(dO * O) that
// _flash_bwd_bhd computes in XLA before them.  Both recompute the
// probabilities from the forward's saved log-sum-exp instead of storing the
// [T, S] matrix:
//
//   S  = scale * Q K^T            (fp32)
//   P  = exp(S - LSE)             (0 for q rows >= T and kv rows >= S)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale, delta = rowsum(dO * O)
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K
//
// Bound on the H100: per head, K5 does 6 T S d FLOP and K4 8 T S d against
// operands that fit in the 50 MB L2, so both are for the tensor cores:
// 26 us and 34 us at 989 TFLOP/s for the training step's ds2 call (B*H 12,
// T 2304, S 2391).  At d = 64 the exponentials (T S of them, on the 16
// MUFU lanes of an SM) and the elementwise work between the products cost
// as much issue time as the products themselves, so the design keeps
// several warpgroups on each SM and forms P while dP is still in the
// tensor cores.
//
// Design: wgmma + TMA, the machinery of the d = 64 forward (tensor maps,
// mbarriers, 128-byte swizzled tiles).
// * Two kernels, as on the TPU, so that every output element has one
//   writer: no atomics, and sums in a fixed order, so dq, dk, dv and delta
//   are bitwise repeatable and do not depend on the order blocks run in.
//   K5 runs first and writes delta [B*H, T] fp32 for K4, on the same stream.
// * Each block computes 64 rows with one warpgroup, so the small training
//   shapes get many blocks (ds8: 72 for K5, 96 for K4), and
//   several blocks share an SM: warpgroups an SM are what hides the
//   exponentials (one block an SM instead of two read 1.42x slower for K5
//   and 1.33x for K4 at ds2 on the H100).  The count is set by registers:
//   K5 fits 128 a thread (four blocks), K4 needs 164 (two blocks; three
//   left a lone fourth block on 60 SMs at ds2 and read 1.3x slower).
// * TMA loads over 4-d tensor maps (d, H, L, B) with byte strides, so the
//   UNet's strided q view and any 16-byte aligned strided dO are read in
//   place and the zero fill stops at T or S within each batch.
// * K5 (dQ): one block per (batch*head, 64 q rows), 128 threads, four
//   blocks an SM (122 registers, 49 KB of shared memory).  Thread 0 loads
//   Q and dO once and 64-row K and V tiles into a ring of two stages, each
//   with one full barrier; once the warpgroup is done with a stage
//   (__syncthreads, since a warp's wgmma wait does not cover the other
//   warps' parts of the product) it refills it: no producer warp, no empty
//   barriers.  Prologue, while the loads fly: delta for the block's rows
//   from O and dO in device memory (each row's four threads sum 16
//   columns in fp32 and shuffle), kept in registers and written for K4;
//   LSE in the log2 domain (+inf past T, so P is 0 there).  Per tile:
//   S = Q K^T and dP = dO V^T (m64n64k16, both operands from shared
//   memory) as two groups; P = ex2(S scale log2e - LSE log2e) (the bare
//   ex2.approx.ftz) while dP runs, masked past S; dS / scale = P (dP -
//   delta) packed to bf16 A fragments in registers; dQ += dS K (m64n64k16,
//   dS from registers, K as an MN-major B through the transpose flag, as
//   the forward reads V).
// * K4 (dK, dV), in the transposed frame: one block per (batch*head, 64 kv
//   rows), one consumer warpgroup and a producer warp (160 threads), two
//   blocks an SM (__launch_bounds__(160, 2): about 168 registers; 164
//   used, 66 KB of shared memory).  The producer's lane 0 loads K and V
//   once and 64-row Q and dO tiles into a ring of three stages; its lanes
//   write each tile's LSE log2e and delta (+inf and 0 past T) into shared
//   memory with the stage and arrive on its full barrier beside the TMA
//   bytes; the consumers arrive on the stage's empty barrier.  (K5's
//   protocol, thread 0 refilling after a __syncthreads with the consumers
//   staging the rows, read 1.17x slower at ds2 at two blocks an SM;
//   presumably half K5's blocks an SM hide less of each barrier's stall.)
//   Per tile:
//   S^T = K Q^T and dP^T = V dO^T (m64n64k16, Q and dO K-major) as two
//   groups; P^T = ex2(S^T scale log2e - LSE[col]) while dP^T runs; P^T and
//   dS^T / scale = P^T (dP^T - delta[col]) come out of the tensor cores as
//   accumulators whose rows are kv rows, so they repack in registers as the
//   A operands of dV += P^T dO and dK += dS^T Q (dO and Q as MN-major Bs):
//   no tile is transposed.  Accumulators dK 32, dV 32, S^T 32, dP^T 32 a
//   thread; issuing dV before dS^T was formed spilled at 166 registers.
// * scale = 1/sqrt(64) = 1/8 is a power of two, so it is applied once to dQ
//   and dK at the end: the bf16 rounding of dS is the same.  P and dS are
//   rounded to bf16 only as operands; everything else is fp32.
// * Rows past T or S are not stored.  Head dim 64 only: the UNet's
//   attention, the one the training path differentiates.
// ptxas (-Xptxas -v, sm_90a): K5 122 registers, K4 164, no spills.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef long long ll;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- Hopper primitives: mbarriers, TMA, wgmma ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// one arrival that also expects `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed; a wait of more
// than about ten seconds traps, so that a protocol fault ends the launch
// with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  } while (!done);
}

// one TMA load of a box of a 4-d tensor map at coordinates (c0, c1, c2, c3),
// completing on the mbarrier `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a tile written with the 128-byte
// swizzle, starting at `addr` (1024-byte aligned atoms of 8 rows x 128 B):
// lbo and sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of wgmma are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x with the MUFU instruction alone (no range scaling for denormal
// results, which flush to 0): the softmax of the wgmma forwards is bound
// by its issue rate at d = 64, where exp2 costs as much as the products
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// order later reads of an accumulator after the wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// keep an A operand held in registers alive, unchanged, until the wgmma
// wait that follows the product reading it
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory
// (K-major B); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the fragment
// layout of mma.m16n8k16 per warp), B from shared memory (MN-major).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory
// (K-major B); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16], A and B from shared memory
// (K-major B); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n16k16_ss(float* d, uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory
// (MN-major B); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16_ss_mn(float* d, uint64_t da, uint64_t db,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- TMA tensor maps ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so that the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map over a [B, L, H, D] bf16 tensor with element strides
// (b, h, l) = st[0..2], as a 4-d map (d, H, L, B): boxes of 64 columns
// (128 bytes, the widest the 128-byte swizzle takes) and `rows` rows of one
// head, zero fill out of bounds.
bool make_map(CUtensorMap* map, const void* ptr, int D, int B, int L, int H,
              const ll* st, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- Forward (K3), head dim 64: wgmma + TMA ----

namespace fwd64 {

constexpr int D = 64;
constexpr int BN = 128;         // kv rows per tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr int ROW = D * 2;      // bytes of a row: one 128-byte swizzle row
constexpr int TILE_BYTES = BN * ROW;

// the block of CONSUMERS warpgroups (64 q rows each) and the producer warp
template <int CONSUMERS>
struct Block {
  static constexpr int BM = 64 * CONSUMERS;  // q rows per block
  static constexpr int NTHREADS = CONSUMERS * 128 + 32;
  static constexpr int Q_BYTES = BM * ROW;
  static constexpr int SMEM = 1024 /* alignment slack */ + Q_BYTES +
                              2 * STAGES * TILE_BYTES + 8 * (1 + 3 * STAGES);
};

template <int CONSUMERS>
__global__ void __launch_bounds__(Block<CONSUMERS>::NTHREADS, 1)
flash_fwd_d64_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ o, float* __restrict__ lse, int H, int T,
                     int S, ll osb, ll osh, ll ost, float scale_log2) {
  constexpr int BM = Block<CONSUMERS>::BM;
  constexpr int Q_BYTES = Block<CONSUMERS>::Q_BYTES;
  extern __shared__ unsigned char smem_raw[];
  // shared-memory map: Q, K[STAGES], V[STAGES], then the mbarriers
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + Q_BYTES;
  const uint32_t sv = sk + STAGES * TILE_BYTES;
  const uint32_t bar = sv + STAGES * TILE_BYTES;
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * BM;
  const int ntiles = (S + BN - 1) / BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: lane 0 keeps the ring of K/V stages full
    if (lane == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      tma_load_4d(sq, &tq, q_full, 0, h, m0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty(s), ((j / STAGES) - 1) & 1);
        mbar_expect_tx(k_full(s), TILE_BYTES);
        tma_load_4d(sk + s * TILE_BYTES, &tk, k_full(s), 0, h, j * BN, b);
        mbar_expect_tx(v_full(s), TILE_BYTES);
        tma_load_4d(sv + s * TILE_BYTES, &tv, v_full(s), 0, h, j * BN, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows m0 + 64 wg .. + 63; this warp's 16 of them
  const int wg = warp >> 2, wr = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  const uint64_t qdesc = sw128_desc(sq + wg * 64 * ROW, 16, 1024);

  // accumulator element i sits at row g + 8 ((i >> 1) & 1) of this warp's
  // 16 rows, column 8 (i >> 2) + 2 tig + (i & 1)
  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};  // this thread's part of the row sums

  mbar_wait(q_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const uint64_t kdesc = sw128_desc(sk + s * TILE_BYTES, 16, 1024);
    const uint64_t vdesc = sw128_desc(sv + s * TILE_BYTES, 16, 1024);

    // S = Q K^T: four k-steps of 16 along d (32 bytes into each swizzled row)
    float sacc[64];
    mbar_wait(k_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n128k16_ss(sacc, qdesc + 2 * kk, kdesc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<64>(sacc);

    // online softmax in the log2 domain
    const int n0 = j * BN;
    if (n0 + BN > S) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (n0 + 8 * (i >> 2) + 2 * tig + (i & 1) >= S) sacc[i] = -INFINITY;
      }
    }
    float mloc[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i) mloc[(i >> 1) & 1] = fmaxf(mloc[(i >> 1) & 1], sacc[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mloc[r] = fmaxf(mloc[r], __shfl_xor_sync(0xffffffffu, mloc[r], 1));
      mloc[r] = fmaxf(mloc[r], __shfl_xor_sync(0xffffffffu, mloc[r], 2));
      const float m_new = fmaxf(m_i[r], mloc[r] * scale_log2);
      alpha[r] = fast_exp2(m_i[r] - m_new);
      m_i[r] = m_new;
      l_i[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      sacc[i] = fast_exp2(fmaf(sacc[i], scale_log2, -m_i[r]));
      l_i[r] += sacc[i];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[i] *= alpha[(i >> 1) & 1];
    // P in bf16 as the A fragments of the eight k-steps of P V
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
    }

    // O += P V: eight k-steps of 16 kv rows (2048 bytes each)
    mbar_wait(v_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_m64n64k16_rs(oacc, pa[kk], vdesc + kk * (16 * ROW >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(oacc);
    mbar_arrive(empty(s));
  }

  // epilogue: O / l in bf16, LSE = ln(l) + max in natural log
  const float LN2 = 0.6931471805599453f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    const int row = m0 + wg * 64 + wr * 16 + g + 8 * r;
    if (row >= T) continue;
    const float inv = 1.f / l_i[r];
    bf16* orow = o + b * osb + h * osh + static_cast<ll>(row) * ost + tig * 2;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) = __floats2bfloat162_rn(
          oacc[4 * c + 2 * r] * inv, oacc[4 * c + 2 * r + 1] * inv);
    }
    if (tig == 0) lse[static_cast<ll>(bh) * T + row] = (m_i[r] + log2f(l_i[r])) * LN2;
  }
}

template <int CONSUMERS>
int launch_with(const void* q, const void* k, const void* v, void* o, void* lse,
                int B, int H, int T, int S, const ll* st, cudaStream_t stream) {
  typedef Block<CONSUMERS> Blk;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, B, T, H, st, Blk::BM) ||
      !make_map(&tk, k, D, B, S, H, st + 3, BN) || !make_map(&tv, v, D, B, S, H, st + 6, BN))
    return -2;
  auto kern = flash_fwd_d64_kernel<CONSUMERS>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Blk::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + Blk::BM - 1) / Blk::BM, B * H);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  kern<<<grid, Blk::NTHREADS, Blk::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), H, T, S, st[9],
      st[10], st[11], scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// Three warpgroups (192 q rows) a block unless two (128 rows) need fewer
// waves of blocks over the SMs, or as few with more SMs busy: on the
// H100 three win at the UNet's ds2 and ds4 calls (more warps to hide the
// softmax behind the tensor cores), two at ds8 (48 heads of 144 rows).
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
           int H, int T, int S, const ll* st, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const ll n2 = static_cast<ll>((T + 127) / 128) * B * H;
  const ll n3 = static_cast<ll>((T + 191) / 192) * B * H;
  const ll w2 = (n2 + sms - 1) / sms, w3 = (n3 + sms - 1) / sms;
  if (w2 < w3 || (w2 == w3 && n2 > n3))
    return launch_with<2>(q, k, v, o, lse, B, H, T, S, st, stream);
  return launch_with<3>(q, k, v, o, lse, B, H, T, S, st, stream);
}

}  // namespace fwd64

// ---- Forward (K3), head dim 512: wgmma + TMA ----

namespace fwd512 {

constexpr int D = 512;
constexpr int BM = 64;          // q rows per block
constexpr int BN = 64;          // kv rows per tile
constexpr int CONSUMERS = 4;    // warpgroups: 16 score columns, 128 O columns each
constexpr int NTHREADS = CONSUMERS * 128 + 32;  // + the producer warp
constexpr int SUB = 64 * 128;   // one 64-row x 64-column swizzled sub-tile
constexpr int TILE_BYTES = 8 * SUB;  // 64 rows x 512 columns
constexpr int P_BYTES = BM * BN * 2;
constexpr int SMEM = 1024 /* alignment slack */ + 3 * TILE_BYTES + P_BYTES +
                     2 * CONSUMERS * BM * 4 + 8 * 5;

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_d512_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ o, float* __restrict__ lse, int H, int T,
                      int S, ll osb, ll osh, ll ost, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  // shared-memory map: Q, K, V (each 8 sub-tiles of 64 columns), P, the
  // row-max exchange, the row-sum exchange, then the mbarriers
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + TILE_BYTES;
  const uint32_t sv = sk + TILE_BYTES;
  const uint32_t sp = sv + TILE_BYTES;
  unsigned char* base = smem_raw + (sq - smem_addr(smem_raw));
  float* red_max = reinterpret_cast<float*>(base + 3 * TILE_BYTES + P_BYTES);
  float* red_sum = red_max + CONSUMERS * BM;
  const uint32_t bar = sp + P_BYTES + 2 * CONSUMERS * BM * 4;
  const uint32_t q_full = bar, k_full = bar + 8, k_empty = bar + 16;
  const uint32_t v_full = bar + 24, v_empty = bar + 32;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * BM;
  const int ntiles = (S + BN - 1) / BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(k_empty, CONSUMERS * 128);
    mbar_init(v_empty, CONSUMERS * 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // producer: one K and one V buffer, each refilled as soon as the
    // consumers release it (K after S = Q K^T, V after O += P V)
    if (lane == 0) {
      mbar_expect_tx(q_full, TILE_BYTES);
      for (int c = 0; c < 8; ++c) tma_load_4d(sq + c * SUB, &tq, q_full, 64 * c, h, m0, b);
      for (int j = 0; j < ntiles; ++j) {
        if (j > 0) mbar_wait(k_empty, (j - 1) & 1);
        mbar_expect_tx(k_full, TILE_BYTES);
        for (int c = 0; c < 8; ++c)
          tma_load_4d(sk + c * SUB, &tk, k_full, 64 * c, h, j * BN, b);
        if (j > 0) mbar_wait(v_empty, (j - 1) & 1);
        mbar_expect_tx(v_full, TILE_BYTES);
        for (int c = 0; c < 8; ++c)
          tma_load_4d(sv + c * SUB, &tv, v_full, 64 * c, h, j * BN, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: score columns 16 wg .. + 15 of each kv tile and
  // O columns 128 wg .. + 127; this warp's 16 of the 64 q rows
  const int wg = warp >> 2, wr = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = wr * 16 + g;  // this thread's rows: row0 and row0 + 8

  float oacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) oacc[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};  // this thread's part of its warpgroup's row sums

  mbar_wait(q_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const uint32_t parity = j & 1;

    // S[:, 16 wg .. + 15] = Q K^T over all 512 columns: 32 k-steps, 8 per
    // sub-tile (32 bytes into each swizzled row)
    float sacc[8];
    mbar_wait(k_full, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * SUB + (kk & 3) * 32;
      wgmma_m64n16k16_ss(sacc, sw128_desc(sq + off, 16, 1024),
                         sw128_desc(sk + off + wg * 16 * 128, 16, 1024), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<8>(sacc);
    mbar_arrive(k_empty);

    // row max over this warpgroup's columns, then over the four
    const int n0 = j * BN + wg * 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (n0 + 8 * (i >> 2) + 2 * tig + (i & 1) >= S) sacc[i] = -INFINITY;
    }
    float mloc[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i) mloc[(i >> 1) & 1] = fmaxf(mloc[(i >> 1) & 1], sacc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mloc[r] = fmaxf(mloc[r], __shfl_xor_sync(0xffffffffu, mloc[r], 1));
      mloc[r] = fmaxf(mloc[r], __shfl_xor_sync(0xffffffffu, mloc[r], 2));
      if (tig == 0) red_max[wg * BM + row0 + 8 * r] = mloc[r];
    }
    consumers_sync();
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = red_max[row0 + 8 * r];
#pragma unroll
      for (int w = 1; w < CONSUMERS; ++w) mt = fmaxf(mt, red_max[w * BM + row0 + 8 * r]);
      const float m_new = fmaxf(m_i[r], mt * scale_log2);
      alpha[r] = fast_exp2(m_i[r] - m_new);
      m_i[r] = m_new;
      l_i[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i >> 1) & 1;
      sacc[i] = fast_exp2(fmaf(sacc[i], scale_log2, -m_i[r]));
      l_i[r] += sacc[i];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) oacc[i] *= alpha[(i >> 1) & 1];

    // P (bf16) into shared memory in the swizzled layout wgmma reads: row
    // r, 16-byte chunk c at r * 128 + ((c ^ (r & 7)) * 16)
    unsigned char* pbase = base + 3 * TILE_BYTES;
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int chunk = 2 * wg + (i >> 2);
      *reinterpret_cast<uint32_t*>(pbase + row * 128 + ((chunk ^ (row & 7)) * 16) +
                                   tig * 4) = pack_bf16(sacc[i], sacc[i + 1]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();

    // O[:, 128 wg .. + 127] += P V: four k-steps of 16 kv rows; the
    // warpgroup's 128 columns are sub-tiles 2 wg and 2 wg + 1 of V (MN-major
    // B, 8 KB apart)
    mbar_wait(v_full, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      wgmma_m64n128k16_ss_mn(oacc, sw128_desc(sp + kk * 32, 16, 1024),
                             sw128_desc(sv + 2 * wg * SUB + kk * 16 * 128, SUB, 1024),
                             1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<64>(oacc);
    mbar_arrive(v_empty);
  }

  // epilogue: the row sums of the four warpgroups, O / l in bf16, LSE
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    if (tig == 0) red_sum[wg * BM + row0 + 8 * r] = l_i[r];
  }
  consumers_sync();
  const float LN2 = 0.6931471805599453f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = red_sum[row0 + 8 * r];
#pragma unroll
    for (int w = 1; w < CONSUMERS; ++w) l += red_sum[w * BM + row0 + 8 * r];
    const int row = m0 + row0 + 8 * r;
    if (row >= T) continue;
    const float inv = 1.f / l;
    bf16* orow = o + b * osb + h * osh + static_cast<ll>(row) * ost + wg * 128 + tig * 2;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) = __floats2bfloat162_rn(
          oacc[4 * c + 2 * r] * inv, oacc[4 * c + 2 * r + 1] * inv);
    }
    if (wg == 0 && tig == 0)
      lse[static_cast<ll>(bh) * T + row] = (m_i[r] + log2f(l)) * LN2;
  }
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
           int H, int T, int S, const ll* st, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, B, T, H, st, BM) || !make_map(&tk, k, D, B, S, H, st + 3, BN) ||
      !make_map(&tv, v, D, B, S, H, st + 6, BN))
    return -2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_d512_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + BM - 1) / BM, B * H);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  flash_fwd_d512_kernel<<<grid, NTHREADS, SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), H, T, S, st[9],
      st[10], st[11], scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwd512

// ---- Backward (K4 dK/dV, K5 dQ), head dim 64: wgmma + TMA ----

namespace bwd {

constexpr int D = 64;
constexpr int ROW = D * 2;             // bytes of a row: one 128-byte swizzle row
constexpr int OWN = 64;                // rows a block owns: q rows (K5), kv rows (K4)
constexpr int OWN_BYTES = OWN * ROW;
constexpr int TILE = 64;               // rows of a streamed tile: kv rows (K5), q rows (K4)
constexpr int TILE_BYTES = TILE * ROW;
constexpr float LOG2E = 1.4426950408889634f;

// K5: one warpgroup, whose thread 0 issues the TMA loads; K and V tiles in
// a ring of two stages; four blocks an SM
constexpr int DQ_THREADS = 128;
constexpr int DQ_STAGES = 2;
constexpr int DQ_SMEM = 1024 /* alignment slack */ + 2 * OWN_BYTES +
                        2 * DQ_STAGES * TILE_BYTES + 8 * (1 + DQ_STAGES);

// K4: one consumer warpgroup and a producer warp; Q and dO tiles with
// their rows' LSE (log2 domain) and delta in a ring of three stages; two
// blocks an SM
constexpr int DKV_THREADS = 128 + 32;
constexpr int DKV_STAGES = 3;
constexpr int DKV_ROWS = 2 * TILE * 4;
constexpr int DKV_SMEM = 1024 /* alignment slack */ + 2 * OWN_BYTES +
                         DKV_STAGES * (2 * TILE_BYTES + DKV_ROWS) + 8 * (1 + 2 * DKV_STAGES);

// element strides (batch, head, row) of a [B, L, H, D] tensor
struct Rows {
  ll b, h, l;
};

__device__ __forceinline__ ll at(const Rows& r, int b, int h, int row) {
  return b * r.b + h * r.h + static_cast<ll>(row) * r.l;
}

// rows row0 + g and row0 + g + 8 (those below `limit`) of a 64-column fp32
// accumulator in the wgmma layout, times `mul`, as bf16
__device__ __forceinline__ void store_rows(bf16* out, const Rows& st, int b, int h,
                                           int row0, int limit, const float* acc,
                                           float mul, int g, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= limit) continue;
    bf16* p = out + at(st, b, h, row) + tig * 2;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 2 * r] * mul, acc[4 * c + 2 * r + 1] * mul);
    }
  }
}

// K5: dQ and delta for 64 q rows of one (batch, head).
__global__ void __launch_bounds__(DQ_THREADS, 4)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const bf16* __restrict__ o, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int T, int S, Rows ost, Rows dost,
                    Rows dqst, float scale) {
  extern __shared__ unsigned char smem_raw[];
  // shared-memory map: Q, dO, K[STAGES], V[STAGES], then the mbarriers
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sdo = sq + OWN_BYTES;
  const uint32_t sk = sdo + OWN_BYTES;
  const uint32_t sv = sk + DQ_STAGES * TILE_BYTES;
  const uint32_t bar = sv + DQ_STAGES * TILE_BYTES;
  const uint32_t qdo_full = bar;
  auto full = [&](int s) { return bar + 8 * (1 + s); };

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * OWN;
  const int ntiles = (S + TILE - 1) / TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;

  // K and V tile j into stage s
  auto load_kv = [&](int j, int s) {
    mbar_expect_tx(full(s), 2 * TILE_BYTES);
    tma_load_4d(sk + s * TILE_BYTES, &tk, full(s), 0, h, j * TILE, b);
    tma_load_4d(sv + s * TILE_BYTES, &tv, full(s), 0, h, j * TILE, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qdo_full, 2 * OWN_BYTES);
    tma_load_4d(sq, &tq, qdo_full, 0, h, m0, b);
    tma_load_4d(sdo, &tdo, qdo_full, 0, h, m0, b);
    for (int j = 0; j < DQ_STAGES && j < ntiles; ++j) load_kv(j, j);
  }

  // prologue, while the loads fly: delta = rowsum(dO * O) in fp32 from
  // device memory, each of the row's four threads summing 16 columns; LSE
  // in the log2 domain.  Rows past T get delta 0 and LSE +inf, so their P
  // is 0.  This thread's rows are m0 + 16 warp + g (+ 8).
  const float scale_log2 = scale * LOG2E;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    float sum = 0.f;
    if (row < T) {
      const uint4* po = reinterpret_cast<const uint4*>(o + at(ost, b, h, row) + tig * 16);
      const uint4* pd = reinterpret_cast<const uint4*>(dout + at(dost, b, h, row) + tig * 16);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint4 vo = po[c], vd = pd[c];
        const __nv_bfloat162* xo = reinterpret_cast<const __nv_bfloat162*>(&vo);
        const __nv_bfloat162* xd = reinterpret_cast<const __nv_bfloat162*>(&vd);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fo = __bfloat1622float2(xo[e]), fd = __bfloat1622float2(xd[e]);
          sum = fmaf(fo.x, fd.x, sum);
          sum = fmaf(fo.y, fd.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dlt[r] = sum;
    lse2[r] = row < T ? lse[static_cast<ll>(bh) * T + row] * LOG2E : INFINITY;
    if (row < T && tig == 0) delta[static_cast<ll>(bh) * T + row] = sum;
  }
  __syncthreads();  // the barriers are initialised

  const uint64_t qdesc = sw128_desc(sq, 16, 1024);
  const uint64_t dodesc = sw128_desc(sdo, 16, 1024);
  float dqacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqacc[i] = 0.f;

  mbar_wait(qdo_full, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % DQ_STAGES;
    const uint64_t kdesc = sw128_desc(sk + s * TILE_BYTES, 16, 1024);
    const uint64_t vdesc = sw128_desc(sv + s * TILE_BYTES, 16, 1024);

    // S = Q K^T and dP = dO V^T (four k-steps of 16 along d each) as two
    // groups, so that P is formed while dP is still in the tensor cores
    float sacc[32], dpacc[32];
    mbar_wait(full(s), (j / DQ_STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(sacc, qdesc + 2 * kk, kdesc + 2 * kk, kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(dpacc, dodesc + 2 * kk, vdesc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<32>(sacc);

    // P = exp2(S scale log2e - LSE log2e), 0 past S; element i is at row
    // g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 tig + (i & 1)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      sacc[i] = fast_exp2(fmaf(sacc[i], scale_log2, -lse2[(i >> 1) & 1]));
    const int n0 = j * TILE;
    if (n0 + TILE > S) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (n0 + 8 * (i >> 2) + 2 * tig + (i & 1) >= S) sacc[i] = 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs<32>(dpacc);

    // dS / scale = P (dP - delta) in bf16 as the A fragments of dQ += dS K
    // (K as an MN-major B; scale = 1/8 is applied to dQ at the end, exactly)
    uint32_t da[TILE / 16][4];
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        const float dl = dlt[e & 1];
        da[kk][e] = pack_bf16(sacc[i] * (dpacc[i] - dl), sacc[i + 1] * (dpacc[i + 1] - dl));
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_m64n64k16_rs(dqacc, da[kk], kdesc + kk * (16 * ROW >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<4 * TILE / 16>(&da[0][0]);
    fence_regs<32>(dqacc);
    __syncthreads();  // every warp's products reading stage s are done: refill it
    if (threadIdx.x == 0 && j + DQ_STAGES < ntiles) load_kv(j + DQ_STAGES, s);
  }

  store_rows(dq, dqst, b, h, m0 + warp * 16, T, dqacc, scale, g, tig);
}

// K4: dK and dV for 64 kv rows of one (batch, head), in the transposed
// frame: S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out of the
// tensor cores as accumulators that repack in registers as the A operands
// of dV += P^T dO and dK += dS^T Q.
__global__ void __launch_bounds__(DKV_THREADS, 2)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T, int S,
                     Rows dkst, Rows dvst, float scale) {
  extern __shared__ unsigned char smem_raw[];
  // shared-memory map: K, V, Q[STAGES], dO[STAGES], rows[STAGES] (LSE
  // log2e, then delta, 64 floats each), then the mbarriers
  const uint32_t sk = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sv = sk + OWN_BYTES;
  const uint32_t sq = sv + OWN_BYTES;
  const uint32_t sdo = sq + DKV_STAGES * TILE_BYTES;
  const uint32_t srows = sdo + DKV_STAGES * TILE_BYTES;
  float* rows = reinterpret_cast<float*>(smem_raw + (srows - smem_addr(smem_raw)));
  const uint32_t bar = srows + DKV_STAGES * DKV_ROWS;
  const uint32_t kv_full = bar;
  auto full = [&](int s) { return bar + 8 * (1 + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + DKV_STAGES + s); };

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int n0 = blockIdx.x * OWN;
  const int ntiles = (T + TILE - 1) / TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA bytes' arrival and the producer's lanes
      mbar_init(empty(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer: K and V once, then the ring of Q/dO stages; lane 0 issues
    // the TMA loads, every lane writes two rows' LSE and delta (LSE +inf and
    // delta 0 past T, so P^T and dS^T are 0 in those columns)
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * OWN_BYTES);
      tma_load_4d(sk, &tk, kv_full, 0, h, n0, b);
      tma_load_4d(sv, &tv, kv_full, 0, h, n0, b);
    }
    const ll base = static_cast<ll>(bh) * T;
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % DKV_STAGES;
      if (i >= DKV_STAGES) mbar_wait(empty(s), ((i / DKV_STAGES) - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full(s), 2 * TILE_BYTES);
        tma_load_4d(sq + s * TILE_BYTES, &tq, full(s), 0, h, i * TILE, b);
        tma_load_4d(sdo + s * TILE_BYTES, &tdo, full(s), 0, h, i * TILE, b);
      }
      float* r = rows + s * (DKV_ROWS / 4);
      for (int c = lane; c < TILE; c += 32) {
        const int row = i * TILE + c;
        r[c] = row < T ? lse[base + row] * LOG2E : INFINITY;
        r[TILE + c] = row < T ? delta[base + row] : 0.f;
      }
      mbar_arrive(full(s));
    }
    return;
  }

  // the consumer warpgroup; this thread's kv rows are n0 + 16 warp + g (+ 8)
  // and its q columns 8 (i >> 2) + 2 tig + (i & 1) of accumulator element i
  const int g = lane >> 2, tig = lane & 3;
  const float scale_log2 = scale * LOG2E;
  const uint64_t kdesc = sw128_desc(sk, 16, 1024);
  const uint64_t vdesc = sw128_desc(sv, 16, 1024);
  float dkacc[32], dvacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dkacc[i] = dvacc[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % DKV_STAGES;
    const uint32_t parity = (i / DKV_STAGES) & 1;
    const uint64_t qdesc = sw128_desc(sq + s * TILE_BYTES, 16, 1024);
    const uint64_t dodesc = sw128_desc(sdo + s * TILE_BYTES, 16, 1024);
    const float* lse2 = rows + s * (DKV_ROWS / 4);
    const float* dlt = lse2 + TILE;

    // S^T = K Q^T and dP^T = V dO^T (Q and dO K-major), as two groups, so
    // that P^T is formed while dP^T is still in the tensor cores
    float sacc[32], dpacc[32];
    mbar_wait(full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(sacc, kdesc + 2 * kk, qdesc + 2 * kk, kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss(dpacc, vdesc + 2 * kk, dodesc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs<32>(sacc);

    // P^T = exp2(S^T scale log2e - LSE[col] log2e)
#pragma unroll
    for (int i2 = 0; i2 < 32; ++i2) {
      const int col = 8 * (i2 >> 2) + 2 * tig + (i2 & 1);
      sacc[i2] = fast_exp2(fmaf(sacc[i2], scale_log2, -lse2[col]));
    }
    wgmma_wait<0>();
    fence_regs<32>(dpacc);

    // P^T and dS^T / scale = P^T (dP^T - delta[col]) in bf16, as the A
    // fragments of dV += P^T dO and dK += dS^T Q (dO and Q as MN-major Bs;
    // scale = 1/8 is applied to dK at the end, exactly)
    uint32_t pa[TILE / 16][4], dsa[TILE / 16][4];
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i2 = 8 * kk + 2 * e;
        const int col = 16 * kk + 8 * (e >> 1) + 2 * tig;
        pa[kk][e] = pack_bf16(sacc[i2], sacc[i2 + 1]);
        dsa[kk][e] = pack_bf16(sacc[i2] * (dpacc[i2] - dlt[col]),
                               sacc[i2 + 1] * (dpacc[i2 + 1] - dlt[col + 1]));
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_m64n64k16_rs(dvacc, pa[kk], dodesc + kk * (16 * ROW >> 4));
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_m64n64k16_rs(dkacc, dsa[kk], qdesc + kk * (16 * ROW >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<16>(&pa[0][0]);
    fence_regs<16>(&dsa[0][0]);
    fence_regs<32>(dvacc);
    fence_regs<32>(dkacc);
    mbar_arrive(empty(s));
  }

  store_rows(dk, dkst, b, h, n0 + warp * 16, S, dkacc, scale, g, tig);
  store_rows(dv, dvst, b, h, n0 + warp * 16, S, dvacc, 1.f, g, tig);
}

Rows rows_of(const ll* st) { return Rows{st[0], st[1], st[2]}; }

// K5.  st: strides of q, k, v, o, dO, dQ.
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq, int B, int H,
              int T, int S, const ll* st, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  if (!make_map(&tq, q, D, B, T, H, st, OWN) || !make_map(&tdo, dout, D, B, T, H, st + 12, OWN) ||
      !make_map(&tk, k, D, B, S, H, st + 3, TILE) || !make_map(&tv, v, D, B, S, H, st + 6, TILE))
    return -2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T + OWN - 1) / OWN, B * H);
  flash_bwd_dq_kernel<<<grid, DQ_THREADS, DQ_SMEM, stream>>>(
      tq, tdo, tk, tv, static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<bf16*>(dq), H,
      T, S, rows_of(st + 9), rows_of(st + 12), rows_of(st + 15),
      1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// K4.  st: strides of q, k, v, dO, dK, dV.
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B, int H,
               int T, int S, const ll* st, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  if (!make_map(&tq, q, D, B, T, H, st, TILE) ||
      !make_map(&tdo, dout, D, B, T, H, st + 9, TILE) ||
      !make_map(&tk, k, D, B, S, H, st + 3, OWN) || !make_map(&tv, v, D, B, S, H, st + 6, OWN))
    return -2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DKV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + OWN - 1) / OWN, B * H);
  flash_bwd_dkv_kernel<<<grid, DKV_THREADS, DKV_SMEM, stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T, S, rows_of(st + 12),
      rows_of(st + 15), 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd

}  // namespace

// q: [B, T, H, D] and k, v: [B, S, H, D] given by element strides
// st = {q_b, q_h, q_t, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_t} with the
// last dim contiguous, 16-byte aligned rows and (for d = 64, read by TMA)
// strides that are multiples of 8 elements; o like q; lse [B*H, T] fp32.
// Returns a cudaError_t (0 on success), -1 for an unsupported head dim, or
// -2 if a TMA tensor map could not be made.
extern "C" int k2_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int H, int T,
                                 int S, int D, const ll* strides,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return fwd64::launch(q, k, v, o, lse, B, H, T, S, strides, s);
  if (D == 512) return fwd512::launch(q, k, v, o, lse, B, H, T, S, strides, s);
  return -1;
}

// q, o, dO, dQ: [B, T, H, D]; k, v, dK, dV: [B, S, H, D]; lse, delta:
// [B*H, T] fp32.  `strides` holds the element strides (batch, head, row) of
// the six bf16 tensors each entry point takes, in the order of its
// arguments, with the last dim contiguous, 16-byte aligned rows and strides
// that are multiples of 8 elements (read by TMA).  Each entry point returns
// a cudaError_t (0 on success), -1 for an unsupported head dim, or -2 if a
// TMA tensor map could not be made.

// K5: dQ, and delta = rowsum(dO * O) for K4.
extern "C" int k2_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                    const void* o, const void* dout, const void* lse,
                                    void* delta, void* dq, int B, int H, int T, int S,
                                    int Dh, const ll* strides, void* stream) {
  if (Dh != bwd::D) return -1;
  return bwd::launch_dq(q, k, v, o, dout, lse, delta, dq, B, H, T, S, strides,
                        static_cast<cudaStream_t>(stream));
}

// K4: dK and dV from K5's delta, launched after K5 on the same stream.
extern "C" int k2_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dk, void* dv, int B,
                                     int H, int T, int S, int Dh, const ll* strides,
                                     void* stream) {
  if (Dh != bwd::D) return -1;
  return bwd::launch_dkv(q, k, v, dout, lse, delta, dk, dv, B, H, T, S, strides,
                         static_cast<cudaStream_t>(stream));
}
