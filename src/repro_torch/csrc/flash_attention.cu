// Prefill attention with an online softmax: causal or not, an optional
// sliding window, queries aligned to the end of the valid keys.
//
// Replaces the TPU kernel `flash_attention_pallas` / `_flash_kernel`
// (src/repro/kernels/flash_attention/flash_attention.py). Per query row i
// (position q_offset + i) and key j it computes
//   s_ij = (q_i . k_j) * D^-1/2, masked to NEG where j >= valid_lk,
//          (causal) q_offset + i < j, or (window) q_offset + i - j >= window;
//   o_i  = sum_j softmax_j(s_ij) v_j,
// with float32 sums, written back in the input type.
//
// Layout: q (B*Hq, Lq, D), k and v (B*Hkv, Lk, D), Hq = rep * Hkv: query
// head h reads kv head h / rep, so GQA never materializes repeated keys.
// The masking value is the finite NEG = -1e30 of the reference: with -inf
// a row whose first kv tile is wholly masked (a sliding window) would give
// exp(-inf - -inf) = NaN; with NEG the row's junk is scaled away by
// alpha = exp(NEG - m) = 0 once a real key arrives. Tiles masked for every
// row of a block (beyond the causal diagonal or before the window) are
// skipped, which is exact for the same reason. With Lk < Lq the offset is
// negative and, under a causal mask, the first Lq - Lk rows see no key:
// the reference's kernel gives them the sum of v over bk ceil(Lk / bk)
// (its NEG makes every key of every tile of bk keys weigh 1; bk is its
// keyword, 128 by default), and a second small kernel
// (`no_key_rows_kernel`) writes them so after any design.
//
// What bounds it on the H100: at Zamba2's prefill (B*Hq = 256, L = 512,
// D = 80, causal) the function needs ~10.8 GFLOP against ~84 MB of q, k,
// v and o: 0.025 ms at 3.35 TB/s, 0.011 ms on the bf16 tensor cores, so
// bytes bound it; at one 4,096-token prompt the products bound it
// (0.087 ms). Two designs, by input type, up to D 256, and one for any D
// past it (`flash_kernel_wide`, below).
//
// bf16 (the LM path): `flash_kernel_bf16<DP, WGS, BK, ST, MINB>`, built
// for Hopper (sm_90a) after FlashAttention-3.
// - Blocks and work. One block an SM (persistent), 3 warpgroups: a
//   producer and WGS = 2 consumers of 64 query rows each, so a work tile
//   is 128 query rows of one head. Blocks walk the work tiles in a snake
//   (round k forwards, round k + 1 backwards); heads go in groups whose
//   K and V fit 16 MB of the 50 MB L2, and within a group tile index
//   major, causal tiles longest first in the last group and alternating
//   before it, so a head's K and V are read from HBM about once and the
//   blocks' loads stay even. GQA: a work tile reads kv head
//   bh / Hq * Hkv + (bh % Hq) / rep; the rep heads sharing it are
//   neighbouring work tiles, which share its K and V through L2 (rep
//   heads are not packed into one block).
// - Loads. One producer thread issues TMA (cp.async.bulk.tensor) over 3-D
//   tensor maps, (D, L, B*H) for q and o and (D, Lk, B*Hkv) for k and v,
//   encoded on the host for each call (cuTensorMapEncodeTiled through
//   the runtime's driver entry point; the maps are __grid_constant__
//   parameters): Q into one tile, K and V into a ring of ST stages of BK
//   keys, each with full and empty mbarriers (transaction-counted); the
//   ring runs on from one work tile into the next. A box past L, Lk or D
//   reads TMA's zero fill, never the next head's rows. D is padded to DP
//   in shared memory: 64-column atoms with the 128-byte swizzle and a
//   tail box of 16 or 32 columns with the 32- or 64-byte swizzle (D 80 =
//   64 + 16), each with its own map and wgmma descriptors.
// - Products. Each consumer loads its Q rows into registers (ldmatrix
//   through the swizzle) and hands Q's tile back at once; S = Q K^T is a
//   register-A wgmma (m64 x BK x k16, K K-major from shared memory), and
//   O += P V a register-A wgmma with V MN-major (transpose flag) from
//   shared memory, per 64-column atom and for the tail. P goes from S's
//   float32 accumulators straight into bf16 A fragments (the single
//   rounding `ref.attention_p_bf16` emulates); the row max and sum stay
//   in registers, exp2 with log2(e) folded into the scale (one FFMA and
//   one MUFU a score).
// - Overlap. Inside a warpgroup S of tile j + 1 is issued before P V of
//   tile j, and tile j + 1's softmax runs while P V is on the tensor
//   cores; across the two warpgroups the issues alternate (named
//   barriers, FA3's ping-pong), one issuing while the other runs its
//   softmax. setmaxnreg gives the producer 24 registers and each consumer
//   240.
// - Masks. Tiles wholly masked for a work tile are never loaded, tiles
//   wholly masked for a warpgroup's rows are passed; the finite NEG,
//   never -inf, so a window's first tile cannot give NaN. A tile that no
//   bound can cut is not masked at all; one that can is masked by two
//   compares a score against each row's column range.
// - Tilings (DP, WGS, BK, ST): (16..80, 2, 128, 4), (96, 2, 128, 3),
//   (128, 2, 64, 5), (192, 2, 64, 3), (256, 2, 64, 2); the wrapper picks
//   the least DP >= D (`ops.tiling`). O leaves through a staging tile and
//   a TMA store, which drops rows past Lq and columns past D.
// - Past DP 128 a consumer's O alone takes DP / 2 = 128 registers a
//   thread, and Q's fragments another DP / 4: Q stays in its tile and S
//   = Q K^T reads both operands from shared memory; O is staged through
//   Q's tile, which goes back to the producer once O's store has read it
//   (the next work tile's Q loads after the last one's store, not
//   ahead). Shared memory at DP 256: Q 64 KB, two stages of 64-key K and
//   V 128 KB; at 192: 48 + 144 KB (three stages).
// Measured by tools/flash_variants.py on an NVIDIA H100 80GB HBM3 at
// 700.00 W (device ms a call, back-to-back, beside SDPA and the previous
// mma.sync kernel in the same run, in turns): 8 x 32 heads x 512, D 80,
// causal 0.0486-0.0493 ms (220 TFLOP/s, 0.51 of its byte bound; SDPA
// 0.0549-0.0551; previous 0.0853-0.0859); 1 x 32 x 4,096 0.193-0.196
// (443 TFLOP/s, 0.45 of its operation bound; SDPA 0.247-0.253; previous
// 0.420-0.440); mixtral's 8 x 48 over 8 kv heads x 512, D 128, causal
// 0.076-0.079 (332 TFLOP/s, 0.45 of its byte bound; SDPA 0.0782-0.0783;
// previous 0.170-0.176). What holds it there: at 4,096 tokens the exps
// (16 MUFU results a clock an SM: 80 % of a 128 x 128 tile's product
// time at D 80) and the softmax's place between the products keep the
// tensor cores at 45 % of their peak; at 512 tokens each work tile's
// fill and drain (its first S and softmax before any overlap, its last P
// V and O's store after) add ~2 us to its ~2.5 tiles, against the
// steady 1.5 us (D 80) to 2 us (D 128) a 128 x 128 tile.
// Tried and measured there (D 80 prefill | long; D 128 mixtral): a
// 2-stage ring 0.053 | 0.210 against 4 stages' 0.049 | 0.183; 64-key
// tiles 0.049 | 0.212; one consumer warpgroup at 2 blocks an SM 0.055 |
// 0.226, three consumers 0.051 | 0.210; D 80 padded to 96 columns 0.051
// | 0.192 and to 128 0.054 | 0.251 instead of split into 64 + 16; at D
// 128 128-key tiles in a 2-stage ring 0.082 against 64-key tiles' 0.078.
// While the design grew, the same tool measured the steps that made it:
// the ping-pong (long 0.239 -> 0.187 ms, 3-stage ring), the
// persistent walk with a snake and Q loaded ahead (mixtral 0.095 ->
// 0.075), the L2 head groups (prefill 0.054 -> 0.049), Q in registers
// (D 128 steady state 9 % faster). Not kept: wgmma issues under runtime
// conditions (a turn stream crossing work tiles) made ptxas serialize
// the wgmmas (advisories C7514/C7517/C7520) and ran 1.5-2x slower; so
// does any compiler-inserted warpgroup.arrive on a path it deems
// divergent, hence the warpgroup index broadcast by __shfl_sync and the
// operand fences before every wgmma.fence. Also not kept: storing a work
// tile's O while the next one's first S runs (ptxas waits for S first,
// C7517, no gain against SDPA in the same run; from a register copy of
// O it spills and runs 1.3-1.5x slower).
//
// float32: `flash_kernel`, the CUDA-core design of the first port. Its
// 2e-5 bar is beyond TF32's ~1e-3, so its products stay float32 FFMA
// from shared memory (8 warps x 8 rows, a lane scoring keys lane and
// lane + 32, the key tile padded to D + 1 floats, D up to 128 or 256 in
// 4 or 8 accumulator slots a lane): the rate of FFMA and shared loads
// bounds it, not the card's bytes.
//
// Past D 256, either type: `flash_kernel_wide`, the float32 design with
// D cut into passes for S and slices of O over blocks (below).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include "hopper.cuh"

#define F32_BQ 64
#define F32_BK 64
#define F32_THREADS 256
#define N_WARPS (F32_THREADS / 32)
#define RPW (F32_BQ / N_WARPS)  // query rows per warp
#define NEG (-1e30f)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

static size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)F32_BQ * d + (size_t)F32_BK * (d + 1) +
                           (size_t)F32_BK * d + F32_BQ * F32_BK);
}

// DSLOTS columns of 32 a lane accumulates: D up to 32 DSLOTS (128 or 256)
template <int DSLOTS>
__global__ void __launch_bounds__(F32_THREADS)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int hq,
                 int rep,
                 int lq, int lk, int d, int q_offset, int valid_lk,
                 int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int dk = d + 1;
  float* qs = smem;              // F32_BQ x d
  float* ks = qs + F32_BQ * d;   // F32_BK x (d + 1)
  float* vs = ks + F32_BK * dk;  // F32_BK x d
  float* ps = vs + F32_BK * d;   // F32_BQ x F32_BK probabilities
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, q0 = blockIdx.y * F32_BQ;
  const int hkv = hq / rep;
  const size_t kvh = (size_t)(bh / hq) * hkv + (bh % hq) / rep;
  const float* qp = q + (size_t)bh * lq * d;
  const float* kp = k + kvh * lk * d;
  const float* vp = v + kvh * lk * d;

  for (int i = tid; i < F32_BQ * d; i += F32_THREADS) {
    const int r = i / d, c = i - r * d;
    qs[i] = q0 + r < lq ? qp[(size_t)(q0 + r) * d + c] : 0.0f;
  }

  // keys any row of this block can attend
  const int rows = min(F32_BQ, lq - q0);
  const int qlo = q_offset + q0, qhi = qlo + rows - 1;
  int kend = valid_lk;
  if (causal) kend = min(kend, qhi + 1);
  const int kstart = window > 0 ? max(0, qlo - window + 1) : 0;

  float m[RPW], l[RPW], acc[RPW][DSLOTS];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DSLOTS; ++c) acc[r][c] = 0.0f;
  }

  for (int t0 = (kstart / F32_BK) * F32_BK; t0 < kend; t0 += F32_BK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < F32_BK * d; i += F32_THREADS) {
      const int r = i / d, c = i - r * d, key = t0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (key < lk) {
        kv = kp[(size_t)key * d + c];
        vv = vp[(size_t)key * d + c];
      }
      ks[r * dk + c] = kv;
      vs[r * d + c] = vv;
    }
    __syncthreads();

    float s[RPW][2];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r][0] = s[r][1] = 0.0f;
    for (int c = 0; c < d; ++c) {
      const float k0 = ks[lane * dk + c], k1 = ks[(lane + 32) * dk + c];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float qv = qs[(warp * RPW + r) * d + c];
        s[r][0] = fmaf(qv, k0, s[r][0]);
        s[r][1] = fmaf(qv, k1, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = qlo + warp * RPW + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = t0 + lane + 32 * j;
        bool ok = kpos < valid_lk;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s[r][j] = ok ? s[r][j] * scale : NEG;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new), p1 = expf(s[r][1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
      ps[(warp * RPW + r) * F32_BK + lane] = p0;
      ps[(warp * RPW + r) * F32_BK + lane + 32] = p1;
#pragma unroll
      for (int c = 0; c < DSLOTS; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    for (int j = 0; j < F32_BK; ++j) {
      float vv[DSLOTS];
#pragma unroll
      for (int c = 0; c < DSLOTS; ++c) {
        const int col = lane + 32 * c;
        vv[c] = col < d ? vs[j * d + col] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float p = ps[(warp * RPW + r) * F32_BK + j];
#pragma unroll
        for (int c = 0; c < DSLOTS; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DSLOTS; ++c) {
      const int col = lane + 32 * c;
      if (col < d)
        o[((size_t)bh * lq + row) * d + col] = acc[r][c] / denom;
    }
  }
}

// ---- bf16: Hopper (TMA, mbarrier ring, wgmma) ------------------------------

#define LOG2E 1.4426950408889634f
#define PRODUCER_REGS 24
#define L2_SHARE (16L << 20)  // bytes of K and V a head group keeps in L2

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The tensor maps of one call: q and o boxes of 64 rows (one consumer
// warpgroup's), k and v boxes of BK rows; each as 64-column atoms with
// the 128-byte swizzle (`x`) and, where DP % 64 != 0, a tail box of 16 or
// 32 columns with the 32- or 64-byte swizzle (`x_tail`).
struct FlashMaps {
  CUtensorMap q, q_tail, k, k_tail, v, v_tail, o, o_tail;
};

// A head dim padded to DP (a multiple of 16): A atoms of 64 columns
// (128-byte rows) and a tail of R columns (R * 2-byte rows); a tile of
// `rows` rows keeps atom j at j * rows * 128 bytes and the tail after
// the atoms. Every part starts on a 1,024-byte boundary. Up to DP 128 a
// consumer holds its Q rows in registers (Q_REG) and O leaves through a
// staging tile of its own; past it (192, 256: whole atoms) O's
// accumulators alone take DP / 2 registers a thread, so S = Q K^T reads
// Q's tile in place (both operands from shared memory) and O leaves
// through Q's tile once the work tile's last S is done.
template <int DP_, int WGS, int BK, int ST_, int MINB_>
struct FlashCfg {
  static constexpr int DP = DP_, ST = ST_, MINB = MINB_;
  static constexpr int A = DP / 64, R = DP % 64, RB = 2 * R;
  static constexpr bool Q_REG = DP <= 128;
  static_assert(DP % 16 == 0 && DP <= 256 &&
                    (R == 0 || (Q_REG && (R == 16 || R == 32))),
                "DP must be 16, 32, 64, 80, 96, 128, 192 or 256");
  static_assert(BK == 64 || BK == 128, "BK must be 64 or 128");
  static_assert(Q_REG || BK == 64, "Q read in place takes 64-key tiles");
  static constexpr int RSW = R == 16 ? 3 : 2;  // tail descriptor swizzle
  static constexpr int BQ = 64 * WGS;
  static constexpr int THREADS = 128 * (WGS + 1);  // and the producer's
  static constexpr int Q_BYTES = 64 * DP * 2;    // one warpgroup's rows
  static constexpr int KV_BYTES = BK * DP * 2;
  static constexpr int OFF_O = Q_REG ? WGS * Q_BYTES : 0;  // O staging
  static constexpr int OFF_K = OFF_O + WGS * Q_BYTES;
  static constexpr int OFF_V = OFF_K + ST * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + ST * KV_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (2 + 3 * ST) + 1024;
  static_assert(MINB * (SMEM + 1024) <= 233472, "MINB blocks fit an SM");
  // registers a thread at launch (MINB blocks an SM), then after the
  // producer warpgroup hands its own down to PRODUCER_REGS
  static constexpr int LAUNCH_REGS =
      (65536 / (MINB * THREADS) < 255 ? 65536 / (MINB * THREADS) : 255) /
      8 * 8;
  static constexpr int MMA_REGS_ =
      (LAUNCH_REGS * THREADS - PRODUCER_REGS * 128) / (128 * WGS) / 8 * 8;
  static constexpr int MMA_REGS = MMA_REGS_ < 240 ? MMA_REGS_ : 240;
};

// rows [row, row + ROWS) of head `head` into a tile at `dst`, completing
// on `bar`
template <class C, int ROWS>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const CUtensorMap* atoms,
                                          const CUtensorMap* tail,
                                          uint64_t* bar, int row, int head) {
#pragma unroll
  for (int j = 0; j < C::A; ++j)
    tma_load_3d(dst + j * ROWS * 128, atoms, bar, 64 * j, row, head);
  if constexpr (C::R > 0)
    tma_load_3d(dst + C::A * ROWS * 128, tail, bar, 64 * C::A, row, head);
}

// descriptor of k-step kk (16 columns of D) of the K tile (BK keys,
// K-major) at `base`: B of S = Q K^T
template <class C, int BK>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int kk) {
  if (kk < 4 * C::A)  // kk / 4: atom, kk % 4: 32 bytes into its rows
    return wgmma_desc(base + (kk / 4) * BK * 128 + (kk % 4) * 32, 0, 1024, 1);
  return wgmma_desc(base + C::A * BK * 128 + (kk - 4 * C::A) * 32, 0,
                    8 * C::RB, C::RSW);
}

// K and V of stage s
template <class C>
__device__ __forceinline__ uint32_t k_tile(unsigned char* sm, int s) {
  return smem_u32(sm + C::OFF_K + s * C::KV_BYTES);
}

template <class C>
__device__ __forceinline__ uint32_t v_tile(unsigned char* sm, int s) {
  return smem_u32(sm + C::OFF_V + s * C::KV_BYTES);
}

// a tile no row of the warpgroup attends: wait for it, as the ring's
// accounting needs, and hand its stage back
template <class C>
__device__ __forceinline__ void pass_tile(uint64_t* k_full, uint64_t* v_full,
                                          uint64_t* empty, int it) {
  constexpr int ST = C::ST;
  mbar_wait(&k_full[it % ST], (it / ST) & 1);
  mbar_wait(&v_full[it % ST], (it / ST) & 1);
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(&empty[it % ST]);
}

// This warpgroup's 64 rows of Q, from its swizzled tile `qs` into A
// fragments (4 registers a k-step of 16 columns) by ldmatrix: lanes 0-7
// and 8-15 address rows 0-7 and 8-15 of the warp's 16 at columns 0-7 of
// the k-step, lanes 16-31 the same rows at columns 8-15.
template <class C>
__device__ __forceinline__ void load_q(uint32_t (&qf)[C::DP / 4],
                                       const unsigned char* qs) {
  const int lane = threadIdx.x % 32;
  const int r = 16 * (threadIdx.x % 128 / 32) + (lane & 15);
  const int half = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < C::DP / 16; ++kk) {
    int off;  // 16-byte chunk c of row r, through the tile's swizzle
    if (kk < 4 * C::A) {
      const int c = 2 * (kk % 4) + half;
      off = (kk / 4) * 64 * 128 + r * 128 + ((c ^ (r & 7)) << 4);
    } else if (C::R == 16) {
      off = C::A * 64 * 128 + r * 32 + ((half ^ ((r >> 2) & 1)) << 4);
    } else {
      const int c = 2 * (kk - 4 * C::A) + half;
      off = C::A * 64 * 128 + r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
    }
    ldsm_x4(qf + 4 * kk, qs + off);
  }
}

// S = Q K^T, 64 rows x BK keys, Q from registers, issued (not waited for)
template <class C, int BK>
__device__ __forceinline__ void qk_issue(float (&sc)[BK / 2],
                                         const uint32_t (&qf)[C::DP / 4],
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < C::DP / 16; ++kk)
    wgmma_rs_k<BK>(sc, qf + 4 * kk, desc_k<C, BK>(k_addr, kk), kk > 0);
}

// the same with Q's tile (64 rows, K-major like K's) read in place
template <class C, int BK>
__device__ __forceinline__ void qk_issue_ss(float (&sc)[BK / 2],
                                            uint32_t q_addr,
                                            uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < C::DP / 16; ++kk)
    wgmma_ss_k<BK>(sc, desc_k<C, 64>(q_addr, kk), desc_k<C, BK>(k_addr, kk),
                   kk > 0);
}

// O += P V, issued: V (keys x D) is MN-major, a k-step 16 keys; each
// 64-column atom and the tail are products of their own
template <class C, int BK>
__device__ __forceinline__ void pv_issue(float (&o)[C::DP / 2],
                                         const uint32_t (&pa)[BK / 4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < C::A; ++j)
      wgmma_rs<64>(o + 32 * j, pa + 4 * kk,
                   wgmma_desc(v_addr + j * BK * 128 + kk * 16 * 128, 1024,
                              1024, 1));
    if constexpr (C::R > 0)
      wgmma_rs<C::R>(o + 32 * C::A, pa + 4 * kk,
                     wgmma_desc(v_addr + C::A * BK * 128 + kk * 16 * C::RB,
                                8 * C::RB, 8 * C::RB, C::RSW));
  }
}

// P rounded to bf16: the accumulators of n-blocks 2kk and 2kk + 1 are
// the A operand of k-step kk
template <int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&pa)[BK / 4]) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// the online softmax's state for a thread's two rows (a: g, b: g + 8):
// running max of the raw scores q . k, and this lane's part of the sums
struct Rows {
  float m_a, m_b, l_a, l_b;
};

// what masks a score of the warpgroup's rows [wlo, whi]: key >= valid_lk,
// (causal) key > row, (window) row - key >= window; pos_a, pos_b are
// this thread's rows, col its first column of an n-block (2t)
struct Mask {
  int valid_lk, causal, window, wlo, whi, pos_a, pos_b, col;
};

// One tile's online softmax on S's accumulators (64 rows x BK keys):
// masked to NEG unless no row or key of the tile can be, the running
// max updated, S replaced by the unnormalized probabilities
// exp2(s c - m c), c = D^-1/2 log2(e) (one FFMA and one MUFU a score),
// the row sums updated, and the factors alpha that rescale O returned.
// A row with every key masked so far keeps max NEG and takes m c = 0, so
// its probabilities are exp2(NEG c) = 0 until a real key arrives.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], Rows& st,
                                             const Mask& mk, int t0,
                                             float c, float& al_a,
                                             float& al_b) {
  constexpr int NS = BK / 2;
  const bool full = t0 + BK <= mk.valid_lk &&
                    (!mk.causal || t0 + BK - 1 <= mk.wlo) &&
                    (mk.window <= 0 || mk.whi - t0 < mk.window);
  if (!full) {
    // each row's keys [lo, hi] as columns of the tile counted from this
    // lane's first (t0 + 2t), against which a score's column 8 (i / 4) +
    // i % 2 is a constant
    const int base = t0 + mk.col;
    int hi_a = mk.valid_lk - 1, hi_b = mk.valid_lk - 1;
    if (mk.causal) {
      hi_a = min(hi_a, mk.pos_a);
      hi_b = min(hi_b, mk.pos_b);
    }
    hi_a -= base;
    hi_b -= base;
    const int lo_a = mk.window > 0 ? mk.pos_a - mk.window + 1 - base : -BK;
    const int lo_b = mk.window > 0 ? mk.pos_b - mk.window + 1 - base : -BK;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kc = 8 * (i / 4) + (i & 1);
      const bool ok = (i & 2) ? (kc >= lo_b && kc <= hi_b)
                              : (kc >= lo_a && kc <= hi_a);
      sc[i] = ok ? sc[i] : NEG;
    }
  }
  float mx_a = NEG, mx_b = NEG;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (i & 2)
      mx_b = fmaxf(mx_b, sc[i]);
    else
      mx_a = fmaxf(mx_a, sc[i]);
  }
  // the four lanes of a quad hold one row
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
  const float mn_a = fmaxf(st.m_a, mx_a), mn_b = fmaxf(st.m_b, mx_b);
  al_a = ex2((st.m_a - mn_a) * c);
  al_b = ex2((st.m_b - mn_b) * c);
  st.m_a = mn_a;
  st.m_b = mn_b;
  const float mc_a = mn_a == NEG ? 0.0f : mn_a * c;
  const float mc_b = mn_b == NEG ? 0.0f : mn_b * c;
  float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    sc[i] = ex2(fmaf(sc[i], c, (i & 2) ? -mc_b : -mc_a));
    if (i & 2)
      ps_b += sc[i];
    else
      ps_a += sc[i];
  }
  st.l_a = al_a * st.l_a + ps_a;
  st.l_b = al_b * st.l_b + ps_b;
}

// one work tile: BQ query rows of one head, and the key tiles they attend
struct Work {
  int bh, q0, kvh, kfirst, n_tiles;
};

// Work w: heads come in groups of `group` (whose K and V share the L2
// cache while the group runs), tile index major within a group. Causal
// tiles shorten along the last group and, group by group before it,
// lengthen and shorten in turn: the lengths run as a triangle wave that
// the blocks' snake walk shares out evenly, and the shortest come last.
template <int BQ, int BK>
__device__ __forceinline__ Work work_tile(int w, int n_bh, int n_qt,
                                          int group, int hq, int rep, int lq,
                                          int q_offset, int valid_lk,
                                          int causal, int window) {
  Work wk;
  const int gi = w / (group * n_qt), g0 = gi * group;  // the group's heads
  const int gn = min(group, n_bh - g0), r = w - g0 * n_qt;
  const int n_groups = (n_bh + group - 1) / group;
  wk.bh = g0 + r % gn;
  const int j = r / gn;
  const bool longest_first = ((n_groups - 1 - gi) & 1) == 0;
  wk.q0 = (causal && longest_first ? n_qt - 1 - j : j) * BQ;
  wk.kvh = wk.bh / hq * (hq / rep) + wk.bh % hq / rep;
  const int qlo = q_offset + wk.q0;
  const int qhi = qlo + min(BQ, lq - wk.q0) - 1;
  int kend = valid_lk;
  if (causal) kend = min(kend, qhi + 1);
  wk.kfirst = (window > 0 ? max(0, qlo - window + 1) : 0) / BK * BK;
  wk.n_tiles = kend > wk.kfirst ? (kend - wk.kfirst + BK - 1) / BK : 0;
  return wk;
}

template <int DP, int WGS, int BK, int ST, int MINB>
__global__ void __launch_bounds__(128 * (WGS + 1), MINB)
    flash_kernel_bf16(const __grid_constant__ FlashMaps maps, int n_bh,
                      int group, int hq, int rep, int lq, int q_offset,
                      int valid_lk, int causal, int window,
                      float scale_log2) {
  using C = FlashCfg<DP, WGS, BK, ST, MINB>;
  extern __shared__ unsigned char fsm_raw[];
  unsigned char* sm =
      fsm_raw + ((1024 - (smem_u32(fsm_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;  // ST each
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;
  // the warpgroup, uniform across each warp as the compiler sees it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int n_qt = (lq + C::BQ - 1) / C::BQ;
  const int n_work = n_bh * n_qt;
  // round k of the walk takes work k G + c, or k G + G - 1 - c on odd
  // rounds: causal tiles come longest first, and the snake evens out
  // what each block is given
  const int G = gridDim.x, cta = blockIdx.x;
  auto work_of = [&](int k) {
    return k * G + ((k & 1) ? G - 1 - cta : cta);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 4 * WGS);  // a warp of each consumer
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 4 * WGS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == WGS) {
    // producer warpgroup: one thread keeps Q and the K/V ring full, one
    // work tile after another; the ring runs on across them
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * WGS) {
      int ring = 0, j = 0;
      for (int k = 0; k * G < n_work; ++k) {
        const int w = work_of(k);
        if (w >= n_work) continue;
        const Work wk =
            work_tile<C::BQ, BK>(w, n_bh, n_qt, group, hq, rep, lq, q_offset,
                                 valid_lk, causal, window);
        // Q's tile is free once the consumers hold the last one in
        // registers (Q_REG), or have stored the last work tile's O
        // through it
        if (j > 0) mbar_wait(q_empty, (j - 1) & 1);
        mbar_expect_tx(q_full, WGS * C::Q_BYTES);
        for (int g = 0; g < WGS; ++g)
          load_rows<C, 64>(sm + g * C::Q_BYTES, &maps.q, &maps.q_tail,
                           q_full, wk.q0 + 64 * g, wk.bh);
        ++j;
        for (int it = 0; it < wk.n_tiles; ++it, ++ring) {
          const int s = ring % ST, t0 = wk.kfirst + it * BK;
          if (ring >= ST) mbar_wait(&empty[s], (ring / ST - 1) & 1);
          mbar_expect_tx(&k_full[s], C::KV_BYTES);
          load_rows<C, BK>(sm + C::OFF_K + s * C::KV_BYTES, &maps.k,
                           &maps.k_tail, &k_full[s], t0, wk.kvh);
          mbar_expect_tx(&v_full[s], C::KV_BYTES);
          load_rows<C, BK>(sm + C::OFF_V + s * C::KV_BYTES, &maps.v,
                           &maps.v_tail, &v_full[s], t0, wk.kvh);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows [q0 + 64 wg, + 64) of each work
    // tile
    setmaxnreg_inc<C::MMA_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    unsigned char* os = sm + C::OFF_O + wg * C::Q_BYTES;  // O staging
    const uint32_t q_addr = smem_u32(sm + wg * C::Q_BYTES);
    constexpr int NO = DP / 2, NS = BK / 2;
    int ring = 0, j = 0;
    for (int k = 0; k * G < n_work; ++k) {
      const int w = work_of(k);
      if (w >= n_work) continue;
      const Work wk =
          work_tile<C::BQ, BK>(w, n_bh, n_qt, group, hq, rep, lq, q_offset,
                               valid_lk, causal, window);
      const int n_tiles = wk.n_tiles, kfirst = wk.kfirst;
      const int r0 = wk.q0 + 64 * wg;
      const int wrows = min(64, lq - r0);  // <= 0: rows past Lq only
      const int wlo = q_offset + r0, whi = wlo + wrows - 1;
      // this thread's two rows: g and g + 8 of the warp's 16
      const int pos_a = wlo + 16 * warp + g, pos_b = pos_a + 8;
      // the tiles [lo, hi) of the work tile's in which a row of this
      // warpgroup attends a key; the others it only passes on
      int lo = 0, hi = 0;
      if (wrows > 0) {
        lo = window > 0 ? max(0, wlo - window + 1 - kfirst) / BK : 0;
        hi = causal ? min(n_tiles, (whi - kfirst) / BK + 1) : n_tiles;
      }
      float o[NO];
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] = 0.0f;
      Rows st{NEG, NEG, 0.0f, 0.0f};
      const Mask mk{valid_lk, causal, window, wlo, whi, pos_a, pos_b, 2 * t};
      // Q into registers, and its buffer back to the producer (Q_REG);
      // else Q's tile stays until O has left through it
      uint32_t qf[C::Q_REG ? DP / 4 : 1];
      mbar_wait(q_full, j & 1);
      if constexpr (C::Q_REG) {
        load_q<C>(qf, sm + wg * C::Q_BYTES);
        __syncwarp();
        if (lane == 0) mbar_arrive(q_empty);
      }
      ++j;

      // The consumers take turns at issuing their products, in a ring
      // (warpgroup w waits on named barrier 1 + WGS + w, then lets w + 1
      // go): one issues while the others run their softmax. Each takes
      // n_tiles + 1 turns a work tile, a turn without products for a
      // tile it does not attend, so the barriers' counts match.
      int turn = 0;
      auto turn_begin = [&] {
        if constexpr (WGS > 1) named_sync(1 + WGS + wg, 256);
      };
      auto turn_end = [&] {
        if constexpr (WGS > 1)
          if (!(wg == WGS - 1 && turn == n_tiles))
            named_arrive(1 + WGS + (wg + 1) % WGS, 256);
        ++turn;
      };
      if constexpr (WGS > 1)  // warpgroup 0 goes first
        if (wg == WGS - 1) named_arrive(1 + WGS, 256);

      int it = 0;
      for (; it < min(lo, hi); ++it) {
        turn_begin();
        turn_end();
        pass_tile<C>(k_full, v_full, empty, ring + it);
      }
      if (lo < hi) {
        // S of tile it is issued before P V of tile it - 1, and its
        // softmax runs while P V is on the tensor cores
        float sc[NS];
        uint32_t pa[BK / 4];
        float al_a, al_b;
        const int r = ring + lo;
        turn_begin();
        mbar_wait(&k_full[r % ST], (r / ST) & 1);
        reg_fence(sc);
        if constexpr (C::Q_REG) reg_fence(qf);
        wgmma_fence();
        if constexpr (C::Q_REG)
          qk_issue<C, BK>(sc, qf, k_tile<C>(sm, r % ST));
        else
          qk_issue_ss<C, BK>(sc, q_addr, k_tile<C>(sm, r % ST));
        wgmma_commit();
        turn_end();
        wgmma_wait<0>();
        reg_fence(sc);
        // Q's registers stay Q's until S retires
        if constexpr (C::Q_REG) reg_fence(qf);
        softmax_tile<BK>(sc, st, mk, kfirst + lo * BK, scale_log2, al_a,
                         al_b);
        pack_p<BK>(sc, pa);
        for (it = lo + 1; it < hi; ++it) {
          const int rc = ring + it, rp = rc - 1;
          turn_begin();
          mbar_wait(&k_full[rc % ST], (rc / ST) & 1);
          mbar_wait(&v_full[rp % ST], (rp / ST) & 1);
          reg_fence(sc);
          reg_fence(o);
          reg_fence(pa);
          if constexpr (C::Q_REG) reg_fence(qf);
          wgmma_fence();  // from here to the commits: no branch
          if constexpr (C::Q_REG)
            qk_issue<C, BK>(sc, qf, k_tile<C>(sm, rc % ST));
          else
            qk_issue_ss<C, BK>(sc, q_addr, k_tile<C>(sm, rc % ST));
          wgmma_commit();
          pv_issue<C, BK>(o, pa, v_tile<C>(sm, rp % ST));
          wgmma_commit();
          turn_end();
          wgmma_wait<1>();  // S of tile it
          reg_fence(sc);
          if constexpr (C::Q_REG) reg_fence(qf);
          softmax_tile<BK>(sc, st, mk, kfirst + it * BK, scale_log2, al_a,
                           al_b);
          wgmma_wait<0>();  // P V of tile it - 1
          reg_fence(o);
          reg_fence(pa);  // P's registers stay P's until the product retires
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[rp % ST]);
#pragma unroll
          for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? al_b : al_a;
          pack_p<BK>(sc, pa);
        }
        const int rp = ring + hi - 1;
        turn_begin();
        mbar_wait(&v_full[rp % ST], (rp / ST) & 1);
        reg_fence(o);
        reg_fence(pa);
        wgmma_fence();
        pv_issue<C, BK>(o, pa, v_tile<C>(sm, rp % ST));
        wgmma_commit();
        turn_end();
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[rp % ST]);
        it = hi;
      } else {
        turn_begin();  // the turn of the last P V, which it has not
        turn_end();
      }
      for (; it < n_tiles; ++it) {
        turn_begin();
        turn_end();
        pass_tile<C>(k_full, v_full, empty, ring + it);
      }
      ring += n_tiles;

      float l_a = st.l_a, l_b = st.l_b;
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
      l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
      const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
      const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
      if (wrows > 0) {
        // O through the staging tile, in the swizzled layout the o maps
        // store from (rows past Lq and columns past D are dropped), once
        // the previous work tile's store has read it
        if (tid == 0) tma_store_wait_read();
        named_sync(1 + wg, 128);
        const int ra = 16 * warp + g, rb = ra + 8;
#pragma unroll
        for (int i = 0; i < NO / 4; ++i) {
          const int a = i / 8, c = i % 8;  // atom (or the tail), 16-B chunk
          int off_a, off_b;
          if (a < C::A) {
            off_a = a * 64 * 128 + ra * 128 + ((c ^ (ra & 7)) << 4);
            off_b = a * 64 * 128 + rb * 128 + ((c ^ (rb & 7)) << 4);
          } else if (C::R == 16) {
            off_a = C::A * 64 * 128 + ra * 32 + ((c ^ ((ra >> 2) & 1)) << 4);
            off_b = C::A * 64 * 128 + rb * 32 + ((c ^ ((rb >> 2) & 1)) << 4);
          } else {
            off_a = C::A * 64 * 128 + ra * 64 + ((c ^ ((ra >> 1) & 3)) << 4);
            off_b = C::A * 64 * 128 + rb * 64 + ((c ^ ((rb >> 1) & 3)) << 4);
          }
          *reinterpret_cast<uint32_t*>(os + off_a + 4 * t) =
              pack_bf16(o[4 * i] * inv_a, o[4 * i + 1] * inv_a);
          *reinterpret_cast<uint32_t*>(os + off_b + 4 * t) =
              pack_bf16(o[4 * i + 2] * inv_b, o[4 * i + 3] * inv_b);
        }
        fence_async_shared();
        named_sync(1 + wg, 128);
        if (tid == 0) {
#pragma unroll
          for (int a = 0; a < C::A; ++a)
            tma_store_3d(&maps.o, os + a * 64 * 128, 64 * a, r0, wk.bh);
          if constexpr (C::R > 0)
            tma_store_3d(&maps.o_tail, os + C::A * 64 * 128, 64 * C::A, r0,
                         wk.bh);
          tma_store_commit();
        }
      }
      if constexpr (!C::Q_REG) {
        // Q's tile back to the producer once O's store has read it (every
        // warp is past its last product: the barrier)
        if (tid == 0 && wrows > 0) tma_store_wait_read();
        named_sync(1 + wg, 128);
        if (lane == 0) mbar_arrive(q_empty);
      }
    }
    if (tid == 0) tma_store_wait_read();  // before the block's smem goes
  }
}

// (d, rows, heads) bf16, boxes of (cols, box_rows, 1) at the swizzle;
// elements outside the tensor load as zeros and are dropped on store
static bool encode_map(CUtensorMap* m, const void* base, int d, int rows,
                       int heads, int cols, int box_rows,
                       CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)box_rows, 1};
  return encode_bf16_map(m, base, 3, dims, strides, box, swizzle);
}

// the atom and tail maps of one tensor
template <class C>
static bool encode_pair(CUtensorMap* atoms, CUtensorMap* tail,
                        const void* base, int d, int rows, int heads,
                        int box_rows) {
  if (C::A && !encode_map(atoms, base, d, rows, heads, 64, box_rows,
                          CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  if (C::R && !encode_map(tail, base, d, rows, heads, C::R, box_rows,
                          C::R == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                     : CU_TENSOR_MAP_SWIZZLE_64B))
    return false;
  return true;
}

template <int DP, int WGS, int BK, int ST, int MINB>
static int launch_bf16(const void* q, const void* k, const void* v, void* o,
                       int bh, int hq, int rep, int lq, int lk, int d,
                       int q_offset, int valid_lk, int causal, int window,
                       float scale, cudaStream_t stream) {
  using C = FlashCfg<DP, WGS, BK, ST, MINB>;
  FlashMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (!encode_pair<C>(&maps.q, &maps.q_tail, q, d, lq, bh, 64) ||
      !encode_pair<C>(&maps.o, &maps.o_tail, o, d, lq, bh, 64) ||
      !encode_pair<C>(&maps.k, &maps.k_tail, k, d, lk, bh / rep, BK) ||
      !encode_pair<C>(&maps.v, &maps.v_tail, v, d, lk, bh / rep, BK))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_kernel_bf16<DP, WGS, BK, ST, MINB>;
  // setmaxnreg.inc waits until the block's registers allow it: refuse a
  // build whose register count would leave the consumers waiting forever
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return (int)e;
    regs = fa.numRegs;
  }
  if (regs * C::THREADS < 128 * (WGS * C::MMA_REGS + PRODUCER_REGS))
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  // persistent: MINB blocks an SM walk over the (head, query tile) work
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const long n_work = (long)bh * ((lq + C::BQ - 1) / C::BQ);
  const int grid = (int)(n_work < (long)sms * MINB ? n_work : sms * MINB);
  // heads a group: as few groups of whole GQA groups, as even as can
  // be, as keep each group's K and V within L2_SHARE of the 50 MB L2
  const long kv_bytes = 4L * lk * d;  // one kv head's K and V, bf16
  const long kv_heads = bh / rep, fit = L2_SHARE / kv_bytes;
  const long n_groups = fit > 0 ? (kv_heads + fit - 1) / fit : kv_heads;
  const long group = (kv_heads + n_groups - 1) / n_groups * rep;
  kern<<<grid, C::THREADS, C::SMEM, stream>>>(maps, bh, (int)group, hq, rep,
                                              lq, q_offset, valid_lk, causal,
                                              window, scale * LOG2E);
  return (int)cudaGetLastError();
}

// ---- float32: CUDA cores -------------------------------------------------

template <int DSLOTS>
static int launch_f32(const void* q, const void* k, const void* v, void* o,
                      int bh, int hq, int rep, int lq, int lk, int d,
                      int q_offset, int valid_lk, int causal, int window,
                      float scale, cudaStream_t stream) {
  // 213,248 bytes at D 256, of the 232,448 a block may have
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DSLOTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (lq + F32_BQ - 1) / F32_BQ);
  flash_kernel<DSLOTS><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, rep, lq, lk,
      d, q_offset, valid_lk, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---- any D: CUDA cores, the output's columns in slices over blocks ------

#define WIDE_DC 64   // columns of D a pass of S = Q K^T takes
#define WIDE_DS 128  // columns of O a block owns

static size_t wide_smem_bytes() {
  return sizeof(float) * ((size_t)F32_BQ * WIDE_DC + F32_BK * (WIDE_DC + 1) +
                          F32_BK * WIDE_DS + F32_BQ * F32_BK);
}

// Head dims past the tiled kernels' (256), in either type: the float32
// kernel's loops (8 warps x 8 rows, a lane scoring keys lane and lane +
// 32, float32 sums and probabilities, output rounded to T), with D cut
// two ways. Block (head, query tile, slice) owns O's columns [128 slice,
// + 128); for each key tile it rebuilds the whole S = Q K^T in passes of
// 64 columns of D through shared memory, then adds P V over its own
// columns of V. Every slice repeats S: slow, and right at any D (82,176
// bytes of shared memory whatever D is).
template <typename T>
__global__ void __launch_bounds__(F32_THREADS)
    flash_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int hq,
                      int rep, int lq, int lk, int d, int q_offset,
                      int valid_lk, int causal, int window, float scale) {
  extern __shared__ float smem[];
  constexpr int DK = WIDE_DC + 1, SLOTS = WIDE_DS / 32;
  float* qs = smem;                   // F32_BQ x WIDE_DC
  float* ks = qs + F32_BQ * WIDE_DC;  // F32_BK x (WIDE_DC + 1)
  float* vs = ks + F32_BK * DK;       // F32_BK x WIDE_DS
  float* ps = vs + F32_BK * WIDE_DS;  // F32_BQ x F32_BK probabilities
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, q0 = blockIdx.y * F32_BQ;
  const int s0 = blockIdx.z * WIDE_DS, ds = min(WIDE_DS, d - s0);
  const int hkv = hq / rep;
  const size_t kvh = (size_t)(bh / hq) * hkv + (bh % hq) / rep;
  const T* qp = q + (size_t)bh * lq * d;
  const T* kp = k + kvh * lk * d;
  const T* vp = v + kvh * lk * d;

  // keys any row of this block can attend
  const int rows = min(F32_BQ, lq - q0);
  const int qlo = q_offset + q0, qhi = qlo + rows - 1;
  int kend = valid_lk;
  if (causal) kend = min(kend, qhi + 1);
  const int kstart = window > 0 ? max(0, qlo - window + 1) : 0;

  float m[RPW], l[RPW], acc[RPW][SLOTS];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < SLOTS; ++c) acc[r][c] = 0.0f;
  }

  for (int t0 = (kstart / F32_BK) * F32_BK; t0 < kend; t0 += F32_BK) {
    float s[RPW][2];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r][0] = s[r][1] = 0.0f;
    for (int c0 = 0; c0 < d; c0 += WIDE_DC) {
      const int dc = min(WIDE_DC, d - c0);
      __syncthreads();  // every warp is done with the previous pass
      for (int i = tid; i < F32_BQ * WIDE_DC; i += F32_THREADS) {
        const int r = i / WIDE_DC, c = i - r * WIDE_DC;
        const bool col = c < dc;
        qs[i] = col && q0 + r < lq
                    ? to_f32(qp[(size_t)(q0 + r) * d + c0 + c])
                    : 0.0f;
        ks[r * DK + c] = col && t0 + r < lk
                             ? to_f32(kp[(size_t)(t0 + r) * d + c0 + c])
                             : 0.0f;
      }
      __syncthreads();
      for (int c = 0; c < dc; ++c) {
        const float k0 = ks[lane * DK + c], k1 = ks[(lane + 32) * DK + c];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float qv = qs[(warp * RPW + r) * WIDE_DC + c];
          s[r][0] = fmaf(qv, k0, s[r][0]);
          s[r][1] = fmaf(qv, k1, s[r][1]);
        }
      }
    }
    // this block's columns of V (every warp's P V of the previous tile
    // is done: the passes' barriers)
    for (int i = tid; i < F32_BK * WIDE_DS; i += F32_THREADS) {
      const int r = i / WIDE_DS, c = i - r * WIDE_DS;
      vs[i] = c < ds && t0 + r < lk
                  ? to_f32(vp[(size_t)(t0 + r) * d + s0 + c])
                  : 0.0f;
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = qlo + warp * RPW + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = t0 + lane + 32 * j;
        bool ok = kpos < valid_lk;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s[r][j] = ok ? s[r][j] * scale : NEG;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new), p1 = expf(s[r][1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
      ps[(warp * RPW + r) * F32_BK + lane] = p0;
      ps[(warp * RPW + r) * F32_BK + lane + 32] = p1;
#pragma unroll
      for (int c = 0; c < SLOTS; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();  // V's columns are in

    for (int j = 0; j < F32_BK; ++j) {
      float vv[SLOTS];
#pragma unroll
      for (int c = 0; c < SLOTS; ++c) vv[c] = vs[j * WIDE_DS + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float p = ps[(warp * RPW + r) * F32_BK + j];
#pragma unroll
        for (int c = 0; c < SLOTS; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row >= lq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < SLOTS; ++c) {
      const int col = lane + 32 * c;
      if (col < ds)
        from_f32(&o[((size_t)bh * lq + row) * d + s0 + col],
                 acc[r][c] / denom);
    }
  }
}

template <typename T>
static int launch_wide(const void* q, const void* k, const void* v, void* o,
                       int bh, int hq, int rep, int lq, int lk, int d,
                       int q_offset, int valid_lk, int causal, int window,
                       float scale, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (lq + F32_BQ - 1) / F32_BQ, (d + WIDE_DS - 1) / WIDE_DS);
  flash_kernel_wide<T><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, rep, lq, lk, d,
      q_offset, valid_lk, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---- rows that see no key ------------------------------------------------

// Under a causal mask with Lk < Lq the rows i < Lq - Lk sit before the
// first key. The reference's kernel writes them as its finite NEG makes
// them: a row whose every score is NEG keeps max NEG, so each key of each
// key tile of bk keys, the zero keys padding Lk to that tile among them,
// takes exp(NEG - NEG) = 1, and the row is the sum of v over the Lk keys
// over bk ceil(Lk / bk) (flash_attention.py:52-58 and ops.py:28-31 of the
// reference's kernel package; bk is its keyword, 128 by default). The
// main kernels leave these rows to this one, launched after them on the
// same stream: block (query head, slice) takes up to NK_THREADS 16-byte
// units of E values of the row. The column sums: thread (g, u) sums unit
// u of keys g, g + G, ... (G = NK_THREADS / units groups, a few keys
// each), the groups add up in group order in shared memory, and the
// slice's value goes out to every row as 16-byte stores.
#define NK_THREADS 256

// d a multiple of 8 (so of E); v, o and their rows at 16 bytes
template <typename T>
__global__ void __launch_bounds__(NK_THREADS)
    no_key_rows_kernel(const T* __restrict__ v, T* __restrict__ o, int hq,
                       int rep, int lq, int lk, int d, int n_rows,
                       float n_keys) {
  constexpr int E = 16 / sizeof(T);  // values a 16-byte unit
  __shared__ float part[NK_THREADS * E];
  __shared__ __align__(16) T val[NK_THREADS * E];
  const int bh = blockIdx.x, tid = threadIdx.x;
  const size_t kvh = (size_t)(bh / hq) * (hq / rep) + (bh % hq) / rep;
  const T* vp = v + kvh * lk * d;
  const int units = d / E, u0 = blockIdx.y * NK_THREADS;
  const int us = min(NK_THREADS, units - u0);  // this block's units
  const int groups = NK_THREADS / us, w = us * E;
  if (tid < groups * us) {
    const int u = tid % us, g = tid / us;
    float acc[E];
#pragma unroll
    for (int j = 0; j < E; ++j) acc[j] = 0.0f;
    for (int r = g; r < lk; r += groups) {
      const uint4 x =
          __ldg(reinterpret_cast<const uint4*>(vp + (size_t)r * d) + u0 + u);
      const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int j = 0; j < E; ++j) acc[j] += to_f32(e[j]);
    }
#pragma unroll
    for (int j = 0; j < E; ++j) part[g * w + u * E + j] = acc[j];
  }
  __syncthreads();
  for (int c = tid; c < w; c += NK_THREADS) {
    float acc = 0.0f;
    for (int g = 0; g < groups; ++g) acc += part[g * w + c];
    from_f32(&val[c], acc / n_keys);
  }
  __syncthreads();
  const uint4* src = reinterpret_cast<const uint4*>(val);
  uint4* op = reinterpret_cast<uint4*>(o + (size_t)bh * lq * d);
  for (long long i = tid; i < (long long)n_rows * us; i += NK_THREADS) {
    const long long row = i / us;
    const int u = (int)(i - row * us);
    op[row * units + u0 + u] = src[u];
  }
}

static int launch_no_key_rows(const void* v, void* o, int bh, int hq,
                              int rep, int lq, int lk, int d, int n_rows,
                              int bk, int bf16, cudaStream_t stream) {
  const float n_keys = (float)((long long)bk * ((lk + bk - 1) / bk));
  const int units = d / (bf16 ? 8 : 4);
  dim3 grid(bh, (units + NK_THREADS - 1) / NK_THREADS);
  if (bf16)
    no_key_rows_kernel<__nv_bfloat16><<<grid, NK_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        hq, rep, lq, lk, d, n_rows, n_keys);
  else
    no_key_rows_kernel<float><<<grid, NK_THREADS, 0, stream>>>(
        static_cast<const float*>(v), static_cast<float*>(o), hq, rep, lq,
        lk, d, n_rows, n_keys);
  return (int)cudaGetLastError();
}

// the kernel for `tiling` (the wrapper's `ops.tiling`): bf16 DP of the
// Hopper kernel's table, float32 128 or 256 (4 or 8 slots a lane), 0 the
// wide kernel at any D
static int launch_main(const void* q, const void* k, const void* v, void* o,
                       int bh, int hq, int rep, int lq, int lk, int d,
                       int q_offset, int valid_lk, int causal, int window,
                       float scale, int bf16, int tiling, cudaStream_t s) {
  if (tiling > 0 && d > tiling) return (int)cudaErrorInvalidValue;
#define FLASH_ARGS \
  q, k, v, o, bh, hq, rep, lq, lk, d, q_offset, valid_lk, causal, window, \
      scale, s
  if (!bf16) {
    if (tiling == 128) return launch_f32<4>(FLASH_ARGS);
    if (tiling == 256) return launch_f32<8>(FLASH_ARGS);
    if (tiling == 0) return launch_wide<float>(FLASH_ARGS);
    return (int)cudaErrorInvalidValue;
  }
#define FLASH_BF16(DP, WGS, BK, ST, MINB) \
  if (tiling == DP) return launch_bf16<DP, WGS, BK, ST, MINB>(FLASH_ARGS);
  FLASH_BF16(16, 2, 128, 4, 1)
  FLASH_BF16(32, 2, 128, 4, 1)
  FLASH_BF16(64, 2, 128, 4, 1)
  FLASH_BF16(80, 2, 128, 4, 1)
  FLASH_BF16(96, 2, 128, 3, 1)
  FLASH_BF16(128, 2, 64, 5, 1)
  FLASH_BF16(192, 2, 64, 3, 1)
  FLASH_BF16(256, 2, 64, 2, 1)
#undef FLASH_BF16
  if (tiling == 0) return launch_wide<__nv_bfloat16>(FLASH_ARGS);
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

// q (bh, lq, d), k/v (bh / rep, lk, d), o like q; bf16 != 0 means
// __nv_bfloat16 operands, else float32. window <= 0 means none; scale is
// D^-1/2 as the caller rounds it (from the true head dim where the caller
// padded d). d must be a multiple of 8 and, for bf16, the pointers 16-byte
// aligned (checked by the wrapper); `tiling` names the kernel (see
// launch_main). q_offset = lk - lq may be negative: with a causal mask the
// rows before the first key then get the reference kernel's value at key
// tiles of `no_key_bk` (`no_key_rows_kernel`).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int bh, int hq, int rep, int lq,
                               int lk, int d, int q_offset, int valid_lk,
                               int causal, int window, float scale, int bf16,
                               int tiling, int no_key_bk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lk == 0)  // no key: the output is zero, as with every key masked
    return (int)cudaMemsetAsync(o, 0, (size_t)bh * lq * d * (bf16 ? 2 : 4),
                                s);
  const int err = launch_main(q, k, v, o, bh, hq, rep, lq, lk, d, q_offset,
                              valid_lk, causal, window, scale, bf16, tiling,
                              s);
  if (err != (int)cudaSuccess || !causal || q_offset >= 0) return err;
  return launch_no_key_rows(v, o, bh, hq, rep, lq, lk, d,
                            q_offset < -lq ? lq : -q_offset, no_key_bk, bf16,
                            s);
}
