// Mamba2 SSD (state-space duality) scan.
//
// Replaces the TPU kernel `ssd_pallas` / `_ssd_kernel`
// (src/repro/kernels/ssd/ssd.py). For one head h with A_h < 0, dt >= 0,
// B and C shared across heads, it computes the output of the recurrence
//   S_t = exp(A_h dt_t) S_{t-1} + dt_t x_t (x) B_t,   y_t = C_t . S_t + D_h x_t
// in the chunked dual form. Per chunk of Q steps, with cum = cumsum(A_h dt):
//   y_intra = ((C B^T) o M) (dt x),  M_ij = exp(cum_i - cum_j) for i >= j
//             (masked BEFORE the exp: for i < j the exponent is positive);
//   y_inter = exp(cum) o (C S^T);
//   S       = exp(cum_last) S + (exp(cum_last - cum) o dt x)^T B.
// The in-chunk cumsum is float64: at Zamba2's decays (A dt down to -48) a
// float32 cum_i - cum_j loses ~eps |cum| to cancellation, |cum| reaching
// the thousands in a chunk, which moves y past the 2e-4 bar once |y| is in
// the hundreds; in float64 the exponents are exact to float32.
//
// The TPU walked chunks as the innermost, sequential grid axis with the
// (P, N) state in VMEM scratch. The dual form is exact for any chunk
// length (the chunk only moves rounding). Steps past L (the ragged tail)
// are dt = 0 steps: they neither decay nor inject state, and their y is
// not written.
//
// What bounds it on the H100: at Zamba2's prefill (B = 8, L = 512, H = 80,
// P = N = 64, bf16) the kernel moves ~88 MB (x and y dominate): 0.026 ms
// at 3.35 TB/s. Its dual-form products (~2.1 MFLOP per chunk of 128 and
// head) are ~11 GFLOP, 0.011 ms on the bf16 tensor cores, so bytes bound
// the function. Two designs, by input type, up to N 256, and one for any
// N past it (`ssd_kernel_wide`, below). Every design cuts P into slices of
// 64 over its blocks or work tiles: y's columns depend only on x's, while
// C B^T and the decays, which each slice repeats, depend on neither.
//
// bf16 (the LM path): `ssd_kernel_bf16<G, NA, WGS, ST, MINB>`, built for
// Hopper (sm_90a).
// - Work. Chunks of SQ = 64 steps run in parallel: a work tile is (batch,
//   chunk, G heads, P slice), numbered chunk major and taken from an
//   atomic counter by persistent blocks (one an SM: WGS consumer
//   warpgroups and a producer warp for each). Each tile computes its
//   chunk's y_intra and its own state S_loc = x^T (w o B) (the products
//   that take the time) without waiting; then it waits for chunk c - 1's
//   final state of the same (batch, head, P slice), adds exp(cum) o
//   (C S^T) to y and publishes S_c = exp(total) S + S_loc. Only that
//   hand-over is serial along a sequence.
// - Hand-over. S goes out in float32 to scratch in device memory, one slot per
//   (batch, head, P slice): chunk c + 1 alone reads chunk c's state, and
//   rewrites the slot after. Each thread writes its own accumulator fragments
//   (thread-major, so a warp's accesses are whole 512-byte rows) as 16-byte
//   units of two floats and a 64-bit tag (epoch << 32) | (chunk + 1), one
//   relaxed vector store each: the hardware moves an aligned 16-byte access as
//   one, so a reader that sees its tag has the floats stored with it, and no
//   fence or flag sits on the chain (a flag published after a GPU-scope fence
//   cost ~2.6 us a hop). The reader's warps each wait on their own: lane 0
//   spins on the warp's first unit, then the warp loads its units, again while
//   a tag is missing. The epoch is new each call, so a unit an earlier call
//   left never reads as ready and no memset is launched; the last block resets
//   the counter. Forward progress: a tile waits only for a tile handed out
//   before it (the counter runs in chunk order), and a consumer's next tile is
//   taken only when it starts the last head of its current one: a tile taken
//   earlier could wait behind it, and the chain whose next chunk it is would
//   wait too. The sum order is fixed, so calls on the same inputs are
//   bit-equal.
// - C B^T once a tile, for its G heads, float32 from exact bf16 C and B,
//   parked in shared memory; each head applies its own M o dt_j to it.
// - Loads. The producer warp issues TMA (cp.async.bulk.tensor) over
//   tensor maps encoded on the host for each call over the operands'
//   own strides: x as (P, H, L, B), one head's (64, 1, SQ, 1) box each,
//   B and C as (N, L, B) boxes of (64, SQ, 1), all with the 128-byte
//   swizzle; its lanes load dt. The model's x, B and C are views of one
//   conv output (rows of d_inner + 2N) and are read in place. A box past
//   L, P or N reads TMA's zero fill. Each consumer has its own ring of
//   ST / WGS stages with full and empty mbarriers.
// - Products on wgmma (m64 x 64 x k16, float32 accumulate), each with an
//   exact bf16 operand and the float32 one as a hi + lo bf16 pair (two
//   passes, ~2^-17 relative): C B^T (C from registers, B K-major from its
//   tile); (C B^T o M o dt_j) x (A from registers, x MN-major from its
//   tile); (w o B)^T x for S^T (A from B's ldmatrix.trans fragments,
//   scaled by w = exp(total - cum) dt and split); C S^T (C from
//   registers, S^T's hi and lo tiles MN-major, written by the consumer
//   in the 128-byte swizzle). cum_i - cum_j is taken from float64 cum as
//   float hi + lo pairs in log2 units (three FADDs and one MUFU ex2 an
//   element). y + D_h x is rounded to bf16 over x's tile and each warp's
//   16 rows leave by its own TMA store (steps past L, columns past P
//   dropped).
// - Any P (slices of 64) and N up to 256 (NA 1, 2 or 4 64-column atoms of
//   N); the wrapper pads them to multiples of 8. Past N 128 S_loc and the
//   previous S of all four m-blocks would hold 256 registers a thread, so
//   the hand-over goes an m-block at a time (its S_loc, the wait, the
//   store), and a consumer's S^T hi and lo tiles take 64 KB.
// - Tiling: G 2, two consumers with two stages each, one block an SM
//   (168 registers; ptxas holds the whole kernel to the launch bound, so
//   two blocks of 256 threads an SM left 128 and spilled). N 128: one
//   consumer. N 256: one consumer with one stage (a stage's B and C are
//   64 KB: 169 KB of shared memory in all).
// Measured by tools/ssd_variants.py on an NVIDIA H100 80GB HBM3 at
// 700.00 W (device ms a call, back-to-back, in turns with the previous
// mma.sync kernel): 8 x 512 x 80 heads 0.134 ms (previous 0.147), the
// same on the model's strided views 0.134, 1 x 4,096 0.138-0.139
// (previous 0.453-0.457), against a bound of 0.026 (by bytes). What
// holds it there: at the prefill a consumer's head is a chain of
// latencies, ~11,200 SM clocks (its trace: the products 2,800, the
// previous state's two L2 round trips 3,400, the hand-over 700, C S^T
// after its barrier 2,300, the epilogue 1,700) against ~800 of tensor
// work, with two consumers an SM to hide them; at 4,096 tokens the 64
// hand-overs of a chain, ~1.7 us each (1.2 us from a state's store to
// the next chunk having it, two round trips, and 0.5 us to its own
// store). Tilings in the same run (prefill | long): one head a tile
// 0.119 | 0.135 (faster at the prefill, but C B^T once a head, which
// the head group is there to share); four heads 0.136 | 0.143 (one
// stage a consumer) and 0.155 | 0.155 (one consumer); one consumer at
// two heads 0.157 | 0.154; two consumers with one stage each 0.138 |
// 0.137. Tried in runs beside the kept design (its time after the
// semicolon): the next tile taken at a tile's start 0.131 | 0.152;
// 0.136 | 0.138; the state loaded before the lane-0 wait 0.142 | 0.158;
// the same; one y store a head after a barrier 0.137 | 0.139; 0.131 |
// 0.135. Across runs: the state loaded at a head's start spilled 468
// bytes and ran 0.22 | 0.27; the states prefetched into L2 by the
// producer gained nothing; the hand-over as a flag published after a
// GPU-scope fence, 0.131 | 0.236 (2.6 us a hop); two blocks an SM at
// 128 registers, 0.162 | 0.289.
//
// float32: `ssd_kernel`, the CUDA-core design of the first port: one
// block a (batch, head, P slice) walking the sequence in tiles of 64
// steps, N up to 256 (the state in shared memory). Its
// 2e-4 bar against the recurrence at |y| ~ 200 is beyond TF32's ~1e-3,
// so its products stay float32 FFMA from shared memory (4 x 4 or 4 x 8
// register tiles, rows of B, C and the state padded to N + 1 floats),
// bound by the FFMA rate and the barriers between the phases of each tile.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include "hopper.cuh"

#define TQ 64
#define THREADS 256
#define P_SLICE 64  // columns of P a block or work tile takes
#define F32_MAX_N 256

// pw: the widest P slice (min(P, 64))
static size_t smem_bytes(int pw, int n) {
  const size_t nk = n + 1;
  return sizeof(double) * TQ                     // cum
         + sizeof(float) * (2 * TQ * nk          // B, C tiles
                            + TQ * (TQ + 1)      // decay-masked C B^T
                            + (size_t)TQ * pw    // dt x
                            + (size_t)pw * nk    // state
                            + 3 * TQ);           // dt, exp(cum), exp(tot - cum)
}

// Block (batch, head, P slice): y's columns depend only on x's, so P is
// cut into slices of 64 over the grid (exact), each repeating C B^T and
// the decays. N up to 256 (231,680 bytes of shared memory at P 64).
__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ dskip,
               float* __restrict__ y, int L, int H, int P, int N) {
  extern __shared__ double sm[];
  const int nk = N + 1, gk = TQ + 1, pw = min(P, P_SLICE);
  double* cum = sm;             // TQ: inclusive cumsum of A_h dt
  float* bs = reinterpret_cast<float*>(cum + TQ);  // TQ x (N + 1)
  float* cs = bs + TQ * nk;     // TQ x (N + 1)
  float* g = cs + TQ * nk;      // TQ x (TQ + 1)
  float* xd = g + TQ * gk;      // TQ x pw: dt * x
  float* st = xd + TQ * pw;     // pw x (N + 1): the carried state
  float* dts = st + pw * nk;    // TQ
  float* ecum = dts + TQ;       // TQ: exp(cum)
  float* eout = ecum + TQ;      // TQ: exp(cum_last - cum)
  const int tid = threadIdx.x, lane = tid & 31;
  const int nps = (P + P_SLICE - 1) / P_SLICE;
  const int bh = blockIdx.x / nps, p0 = blockIdx.x % nps * P_SLICE;
  const int b = bh / H, h = bh % H, ps_n = min(P_SLICE, P - p0);
  const float ah = a[h], dh = dskip[h];
  const size_t xrow = (size_t)H * P;   // x and y stride along L
  const size_t xcol = (size_t)h * P + p0;
  // register-tile coordinates: 16 x 16 threads, 4 (or 8) strided items each
  const int ti = tid >> 4, tj = tid & 15;

  for (int i = tid; i < pw * nk; i += THREADS) st[i] = 0.0f;

  for (int t0 = 0; t0 < L; t0 += TQ) {
    const int q = min(TQ, L - t0);
    __syncthreads();  // the previous tile is done with every buffer

    // cum = inclusive cumsum of A_h dt over the tile (two warps)
    if (tid < TQ) {
      const float d = tid < q ? dt[((size_t)b * L + t0 + tid) * H + h] : 0.0f;
      double v = ah * d;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      dts[tid] = d;
      cum[tid] = v;
    }
    for (int i = tid; i < TQ * N; i += THREADS) {
      const int j = i / N, n = i - j * N;
      const size_t off = ((size_t)b * L + t0 + j) * N + n;
      bs[j * nk + n] = j < q ? bm[off] : 0.0f;
      cs[j * nk + n] = j < q ? cm[off] : 0.0f;
    }
    __syncthreads();
    if (tid >= 32 && tid < TQ) cum[tid] += cum[31];
    __syncthreads();
    const double total = cum[TQ - 1];
    if (tid < TQ) {
      ecum[tid] = expf((float)cum[tid]);
      eout[tid] = expf((float)(total - cum[tid]));
    }
    for (int i = tid; i < TQ * pw; i += THREADS) {
      const int j = i / pw, p = i - j * pw;
      xd[i] = j < q && p < ps_n
                  ? x[((size_t)b * L + t0 + j) * xrow + xcol + p] * dts[j]
                  : 0.0f;
    }

    // g = (C B^T) o M, lower triangle
    {
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = cs[(ti + 16 * r) * nk + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = bs[(tj + 16 * c) * nk + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ti + 16 * r, j = tj + 16 * c;
          g[i * gk + j] =
              i >= j ? acc[r][c] * expf((float)(cum[i] - cum[j])) : 0.0f;
        }
    }
    __syncthreads();

    // y = g (dt x) + exp(cum) o (C S^T) + D_h x, rows ti + 16r, cols tj + 16c
    {
      float yi[4][4] = {}, ys[4][4] = {};
      for (int j = 0; j < TQ; ++j) {
        float gv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = g[(ti + 16 * r) * gk + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tj + 16 * c;
          xv[c] = p < ps_n ? xd[j * pw + p] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) yi[r][c] = fmaf(gv[r], xv[c], yi[r][c]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = cs[(ti + 16 * r) * nk + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tj + 16 * c;
          sv[c] = p < ps_n ? st[p * nk + n] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) ys[r][c] = fmaf(cv[r], sv[c], ys[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        if (i >= q) continue;
        const size_t row = ((size_t)b * L + t0 + i) * xrow + xcol;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tj + 16 * c;
          if (p >= ps_n) continue;
          const float out = yi[r][c] + ecum[i] * ys[r][c];
          y[row + p] = out + dh * x[row + p];
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // S = exp(total) S + (exp(total - cum) o dt x)^T B; rows ti + 16r of
    // the P slice, columns n0 + tj + 16c of N, 128 columns a pass
    const float decay = expf((float)total);
    for (int n0 = 0; n0 < N; n0 += 128) {
      float acc[4][8] = {};
      for (int j = 0; j < TQ; ++j) {
        float wv[4], bv[8];
        const float e = eout[j];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = ti + 16 * r;
          wv[r] = p < ps_n ? e * xd[j * pw + p] : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = n0 + tj + 16 * c;
          bv[c] = n < N ? bs[j * nk + n] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(wv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = ti + 16 * r;
        if (p >= ps_n) continue;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int n = n0 + tj + 16 * c;
          if (n < N) st[p * nk + n] = decay * st[p * nk + n] + acc[r][c];
        }
      }
    }
  }
}

// ---- bf16: Hopper (TMA, mbarrier ring, wgmma), chunks in parallel -------

#define SQ 64                  // steps a chunk: a work tile's rows
#define SSD_PRODUCER_REGS 40
#define LOG2E_D 1.4426950408889634

__device__ __forceinline__ float ex2f(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The tensor maps of one call: x and y as (P, H, L, B), boxes of one
// head's (64, 1, SQ, 1) and of a warp's 16 rows (64, 1, 16, 1), at a P
// slice's first column; B and C as (N, L, B), boxes of (64, SQ, 1);
// every box 64 columns wide with the 128-byte swizzle, P and N
// zero-filled past their ends (and dropped on store).
struct SsdMaps {
  CUtensorMap x, y, b, c;
};

// The scratch of one call, in device memory the wrapper keeps: the work
// counter and the count of blocks done (reset by the last block), then
// for each (batch, head, P slice) the state a chunk hands to the next:
// its S^T fragments, thread-major, two floats and the chunk's tag a
// 16-byte unit, NA * 2,048 units a slot (`ops.scratch_bytes`).
struct SsdScratch {
  unsigned int* counters;
  uint64_t* states;  // pairs: (two floats, tag)
};

// bytes of counters ahead of the states
constexpr size_t SCRATCH_STATES = 64;

// G heads a work tile, NA 64-column atoms of N, WGS consumer warpgroups
// (each takes its own work tiles), ST stages in the ring (a multiple of
// WGS: consumer k fills stages k, k + WGS, ...), MINB blocks an SM. A
// stage holds x (G heads x SQ steps x 64 columns), B and C (NA atoms
// each), dt (G x SQ float32) and the work tile's index; every tile
// starts on a 1,024-byte boundary.
template <int G_, int NA_, int WGS_, int ST_, int MINB_>
struct SsdCfg {
  static constexpr int G = G_, NA = NA_, WGS = WGS_, ST = ST_, MINB = MINB_;
  static_assert(NA == 1 || NA == 2 || NA == 4, "N up to 256");
  static_assert(ST % WGS == 0, "each consumer its own stages");
  static constexpr int BLOCK_THREADS = 128 * (WGS + 1);
  static constexpr int X_BYTES = G * SQ * 128;
  static constexpr int BC_BYTES = NA * SQ * 128;
  static constexpr int OFF_B = X_BYTES, OFF_C = OFF_B + BC_BYTES;
  static constexpr int OFF_DT = OFF_C + BC_BYTES;
  static constexpr int OFF_W = OFF_DT + G * SQ * 4;
  static constexpr int STAGE = (OFF_W + 16 + 1023) / 1024 * 1024;
  // per consumer: S^T's hi and lo tiles (N rows of 64 columns), C B^T
  // (float32, thread-major) and, per warp, the chunk's cum (as float hi +
  // lo, log2 units) and w
  static constexpr int S_BYTES = NA * 64 * 128;
  static constexpr int CB_BYTES = SQ * SQ * 4;
  static constexpr int ARR_BYTES = 3 * SQ * 4;
  static constexpr int OFF_S = ST * STAGE;
  static constexpr int OFF_CB = OFF_S + WGS * 2 * S_BYTES;
  static constexpr int OFF_ARR = OFF_CB + WGS * CB_BYTES;
  static constexpr int OFF_BAR = OFF_ARR + WGS * 4 * ARR_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (2 * ST + WGS) + 1024;
  static_assert(MINB * (SMEM + 1024) <= 233472, "MINB blocks fit an SM");
  static constexpr int REGS_ = 65536 / (MINB * BLOCK_THREADS);
  static constexpr int LAUNCH_REGS = (REGS_ < 255 ? REGS_ : 255) / 8 * 8;
  static constexpr int MMA_REGS_ =
      (LAUNCH_REGS * BLOCK_THREADS - SSD_PRODUCER_REGS * 128) /
      (128 * WGS) / 8 * 8;
  static constexpr int MMA_REGS = MMA_REGS_ < 240 ? MMA_REGS_ : 240;
};

// work tile w, chunk major: (chunk, batch, head group, P slice)
struct SsdWork {
  int c, b, h0, ps;
};

template <int G>
__device__ __forceinline__ SsdWork ssd_work(int w, int batch, int n_groups,
                                            int nps) {
  SsdWork wk;
  wk.ps = w % nps;
  w /= nps;
  wk.c = w / (batch * n_groups);
  const int r = w - wk.c * batch * n_groups;
  wk.b = r / n_groups;
  wk.h0 = (r - wk.b * n_groups) * G;
  return wk;
}

// byte offset of the 16-byte chunk `chunk` of row `row` in a tile of
// 128-byte rows written with the 128-byte swizzle
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// w o B for one B^T fragment register (two bf16 of B at steps with
// weights w_lo, w_hi), as hi + lo bf16
__device__ __forceinline__ void scale_split(uint32_t b, float w_lo,
                                            float w_hi, uint32_t& hi,
                                            uint32_t& lo) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  split_bf16(v.x * w_lo, v.y * w_hi, hi, lo);
}

// C's SQ rows as A fragments (K = N, 4 registers a k-step), through the
// tile's swizzle (the layout flash_attention.cu's load_q reads)
template <int NA>
__device__ __forceinline__ void load_c(uint32_t (&cf)[NA * 16],
                                       const unsigned char* ct) {
  const int lane = threadIdx.x % 32;
  const int r = 16 * (threadIdx.x % 128 / 32) + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < NA * 4; ++kk)
    ldsm_x4(cf + 4 * kk,
            ct + (kk / 4) * SQ * 128 + swz(r, 2 * (kk % 4) + (lane >> 4)));
}

// descriptor of k-step kk of a tile of 128-byte rows read MN-major (x
// over steps, S^T over the state)
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int kk) {
  return wgmma_desc(base + kk * 16 * 128, 1024, 1024, 1);
}

// Trace points of a head (TRACE builds, for tools/ssd_variants.py): the
// SM clock at each, and the global timer at the hand-over, per (work
// tile, head).
enum {
  TR_HEAD,       // head start
  TR_PRE,        // its products done, before the hand-over
  TR_FLAG,       // the previous chunk's state seen (clock)
  TR_PUB,        // this chunk's state stored
  TR_INTER,      // C S^T done
  TR_END,        // y stored
  TR_FLAG_NS,    // the previous state seen (global timer)
  TR_PUB_NS,     // this state stored (global timer)
  TR_N
};

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int G, int NA, int WGS, int ST, int MINB, bool TRACE>
__global__ void __launch_bounds__(128 * (WGS + 1), MINB)
    ssd_kernel_bf16(const __grid_constant__ SsdMaps maps,
                    const float* __restrict__ dt, const float* __restrict__ a,
                    const float* __restrict__ dskip, SsdScratch scr, int L,
                    int H, int batch, int n_groups, int nps, int n_chunks,
                    unsigned long long epoch, long long* trace) {
  using C = SsdCfg<G, NA, WGS, ST, MINB>;
  constexpr int D = ST / WGS;  // stages of each consumer
  extern __shared__ unsigned char ssm_raw[];
  unsigned char* sm =
      ssm_raw + ((1024 - (smem_u32(ssm_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* empty = full + ST;
  uint64_t* want = empty + ST;  // a consumer is ready for its next tile
  // the warpgroup, uniform across each warp as the compiler sees it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int n_work = n_chunks * batch * n_groups * nps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 4);  // the consumer's warps
    }
    for (int k = 0; k < WGS; ++k) mbar_init(&want[k], 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == WGS) {
    // producer warp k feeds consumer k its own ring of D stages: it takes
    // work tiles from the counter, in order, x, B and C by TMA and dt by
    // its lanes, then one end mark. A consumer's next tile is taken when
    // it starts the last head of its current one: a tile taken earlier
    // would wait behind it, and so would the chain whose next chunk it is.
    setmaxnreg_dec<SSD_PRODUCER_REGS>();
    const int k = (threadIdx.x - 128 * WGS) / 32, lane = threadIdx.x % 32;
    if (k < WGS) {
      for (int ring = 0;; ++ring) {
        const int s = k * D + ring % D;
        if (ring >= D) mbar_wait_or_trap(&empty[s], (ring / D - 1) & 1);
        if (ring >= 1) mbar_wait_or_trap(&want[k], (ring - 1) & 1);
        unsigned char* stage = sm + s * C::STAGE;
        int w = 0;
        if (lane == 0) w = (int)atomicAdd(scr.counters, 1u);
        w = __shfl_sync(0xffffffffu, w, 0);
        if (w >= n_work) {
          if (lane == 0) *reinterpret_cast<int*>(stage + C::OFF_W) = -1;
          mbar_arrive(&full[s]);
          break;
        }
        const SsdWork wk = ssd_work<G>(w, batch, n_groups, nps);
        const int t0 = wk.c * SQ, ng = min(G, H - wk.h0);
        // the TMA loads first, then dt, whose loads overlap them
        if (lane == 0) {
          *reinterpret_cast<int*>(stage + C::OFF_W) = w;
          mbar_add_tx(&full[s], ng * SQ * 128 + 2 * C::BC_BYTES);
          for (int g = 0; g < ng; ++g)
            tma_load_4d(stage + g * SQ * 128, &maps.x, &full[s],
                        P_SLICE * wk.ps, wk.h0 + g, t0, wk.b);
#pragma unroll
          for (int at = 0; at < NA; ++at) {
            tma_load_3d(stage + C::OFF_B + at * SQ * 128, &maps.b, &full[s],
                        64 * at, t0, wk.b);
            tma_load_3d(stage + C::OFF_C + at * SQ * 128, &maps.c, &full[s],
                        64 * at, t0, wk.b);
          }
        }
        float* dts = reinterpret_cast<float*>(stage + C::OFF_DT);
        for (int i = lane; i < G * SQ; i += 32) {
          const int g = i / SQ, j = i % SQ;
          dts[i] = wk.h0 + g < H && t0 + j < L
                       ? dt[((size_t)wk.b * L + t0 + j) * H + wk.h0 + g]
                       : 0.0f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // consumer warpgroup wg; rows 16 warp + g and + 8 of each product's
    // 64.
    setmaxnreg_inc<C::MMA_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int gq = lane / 4, t4 = lane % 4;
    const int ra = 16 * warp + gq, rb = ra + 8;
    const int bar = 1 + wg;
    unsigned char* s_hi = sm + C::OFF_S + wg * 2 * C::S_BYTES;
    unsigned char* s_lo = s_hi + C::S_BYTES;
    float4* cbs =
        reinterpret_cast<float4*>(sm + C::OFF_CB + wg * C::CB_BYTES);
    float* ach = reinterpret_cast<float*>(sm + C::OFF_ARR +
                                          (wg * 4 + warp) * C::ARR_BYTES);
    float* acl = ach + SQ;
    float* aw = acl + SQ;
    for (int ring = 0;; ++ring) {
      const int s = wg * D + ring % D;
      mbar_wait_or_trap(&full[s], (ring / D) & 1);
      unsigned char* stage = sm + s * C::STAGE;
      const int w = __shfl_sync(
          0xffffffffu, *reinterpret_cast<const int*>(stage + C::OFF_W), 0);
      if (w < 0) break;
      const SsdWork wk = ssd_work<G>(w, batch, n_groups, nps);
      const int c = wk.c, t0 = c * SQ;
      const uint32_t x_addr = smem_u32(stage);
      const uint32_t b_addr = smem_u32(stage + C::OFF_B);
      const unsigned char* ctile = stage + C::OFF_C;
      const unsigned char* btile = stage + C::OFF_B;
      const float* dts = reinterpret_cast<const float*>(stage + C::OFF_DT);
      long long* tr = TRACE ? trace + (size_t)w * G * TR_N : nullptr;

      // C B^T, once for the G heads: 64 x 64 steps, float32 from exact
      // bf16 C (registers) and B (K-major from its tile), parked in
      // shared memory (each thread its own fragments) while heads run
      {
        float cb[32];
        uint32_t cf[NA * 16];
        load_c<NA>(cf, ctile);
        reg_fence(cf);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NA * 4; ++kk)
          wgmma_rs_k<64>(cb, cf + 4 * kk,
                         wgmma_desc(b_addr + (kk / 4) * SQ * 128 +
                                        (kk % 4) * 32,
                                    0, 1024, 1),
                         kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(cb);
        reg_fence(cf);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          cbs[i * 128 + tid] = make_float4(cb[4 * i], cb[4 * i + 1],
                                           cb[4 * i + 2], cb[4 * i + 3]);
      }

      const int ng = min(G, H - wk.h0);
      const bool first = c == 0, last = c + 1 == n_chunks;
      const uint64_t tag_in = (epoch << 32) | (uint64_t)c,
                     tag_out = tag_in + 1;
#pragma unroll 1
      for (int g = 0; g < ng; ++g) {
        const int h = wk.h0 + g;
        const float ah = a[h], dh = dskip[h];
        const float* dg = dts + g * SQ;
        const uint32_t xg = x_addr + g * SQ * 128;
        unsigned char* xt = stage + g * SQ * 128;
        if (TRACE && tid == 0) tr[g * TR_N + TR_HEAD] = clock64();
        // the last head: the producer may take this consumer's next tile
        if (g == ng - 1 && tid == 0) mbar_arrive(&want[wg]);

        // the previous chunk's state S: this thread's units of the one slot
        // of its (batch, head, P slice) (chunk c + 1 alone reads chunk c's
        // state, and rewrites the slot)
        uint64_t* slot =
            scr.states +
            (((size_t)wk.b * H + h) * nps + wk.ps) * (NA * 4096);

        // cum = inclusive cumsum of A_h dt over the chunk in float64 (each
        // warp its own copy; a lane owns steps 2 lane and 2 lane + 1),
        // kept in log2 units as float hi + lo: the differences cum_i -
        // cum_j come out as exact as float64's rounded to float32
        __syncwarp();
        float th, tl;
        {
          const float d0 = dg[2 * lane], d1 = dg[2 * lane + 1];
          const double v0 = (double)(ah * d0), v1 = v0 + (double)(ah * d1);
          double sc = v1;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const double u = __shfl_up_sync(0xffffffffu, sc, off);
            if (lane >= off) sc += u;
          }
          const double c0 = (sc - v1 + v0) * LOG2E_D, c1 = sc * LOG2E_D;
          const double tot = __shfl_sync(0xffffffffu, sc, 31) * LOG2E_D;
          th = (float)tot;
          tl = (float)(tot - (double)th);
          const float h0f = (float)c0, h1f = (float)c1;
          const float l0f = (float)(c0 - (double)h0f);
          const float l1f = (float)(c1 - (double)h1f);
          ach[2 * lane] = h0f;
          ach[2 * lane + 1] = h1f;
          acl[2 * lane] = l0f;
          acl[2 * lane + 1] = l1f;
          // w = exp(total - cum) dt: the weight of a step's input in the
          // chunk's final state
          aw[2 * lane] = ex2f((th - h0f) + (tl - l0f)) * d0;
          aw[2 * lane + 1] = ex2f((th - h1f) + (tl - l1f)) * d1;
        }
        __syncwarp();
        const float cha = ach[ra], cla = acl[ra], chb = ach[rb], clb = acl[rb];

        // y = (C B^T o M o dt_j) x: A from registers as hi + lo, x
        // MN-major from its tile; M_ij = exp(cum_i - cum_j), masked
        // (i >= j) before the exp
        float yacc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) yacc[i] = 0.0f;
        uint32_t ph[16], pl[16];
        {
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int j0 = 8 * nb + 2 * t4, j1 = j0 + 1;
            const float ch0 = ach[j0], cl0 = acl[j0], ch1 = ach[j1],
                        cl1 = acl[j1], d0 = dg[j0], d1 = dg[j1];
            const float4 cv = cbs[nb * 128 + tid];
            float v[4];
            v[0] = j0 <= ra ? cv.x * ex2f((cha - ch0) + (cla - cl0)) * d0
                            : 0.0f;
            v[1] = j1 <= ra ? cv.y * ex2f((cha - ch1) + (cla - cl1)) * d1
                            : 0.0f;
            v[2] = j0 <= rb ? cv.z * ex2f((chb - ch0) + (clb - cl0)) * d0
                            : 0.0f;
            v[3] = j1 <= rb ? cv.w * ex2f((chb - ch1) + (clb - cl1)) * d1
                            : 0.0f;
            // n-blocks 2kk and 2kk + 1 are k-step kk's A fragment
            const int q = 4 * (nb / 2) + 2 * (nb % 2);
            split_bf16(v[0], v[1], ph[q], pl[q]);
            split_bf16(v[2], v[3], ph[q + 1], pl[q + 1]);
          }
          reg_fence(yacc);
          reg_fence(ph);
          reg_fence(pl);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_rs<64>(yacc, ph + 4 * kk, desc_mn(xg, kk));
            wgmma_rs<64>(yacc, pl + 4 * kk, desc_mn(xg, kk));
          }
          wgmma_commit();
        }

        // the chunk's own state, summed from zero: S_loc^T = (w o B)^T x
        // (N x P), A from B's ldmatrix.trans fragments as hi + lo, one
        // 64-row m-block of N at a time; and the hand-over, each warp on
        // its own: the previous chunk's state S (zero for the first chunk)
        // as each thread's units tagged with chunk c - 1 (lane 0 waits for
        // the warp's first, then the warp loads its units, again while a
        // tag is not yet there), S_c = exp(total) S + S_loc out tagged with
        // chunk c, and S into S^T's hi and lo tiles for C S^T. Both go in
        // passes of HB m-blocks: the whole of N up to 128 (S_loc before
        // the wait, which its products overlap), one m-block a pass past
        // it, where S_loc and S of all four would not fit in registers.
        constexpr int HB = NA <= 2 ? NA : 1;
        const float decay = ex2f(th + tl);
#pragma unroll
        for (int m0 = 0; m0 < NA; m0 += HB) {
          float sl[HB][32];
#pragma unroll
          for (int i = 0; i < HB; ++i) {
            const int mb = m0 + i;
#pragma unroll
            for (int e = 0; e < 32; ++e) sl[i][e] = 0.0f;
            uint32_t wh[16], wl[16];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int kr = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
              const int mc = 16 * warp + ((lane >> 3) & 1) * 8;
              uint32_t bf[4];
              ldsm_x4_t(bf, btile + mb * SQ * 128 + swz(kr, mc / 8));
              const int j = 16 * kk + 2 * t4;
              const float w0 = aw[j], w1 = aw[j + 1], w8 = aw[j + 8],
                          w9 = aw[j + 9];
              scale_split(bf[0], w0, w1, wh[4 * kk], wl[4 * kk]);
              scale_split(bf[1], w0, w1, wh[4 * kk + 1], wl[4 * kk + 1]);
              scale_split(bf[2], w8, w9, wh[4 * kk + 2], wl[4 * kk + 2]);
              scale_split(bf[3], w8, w9, wh[4 * kk + 3], wl[4 * kk + 3]);
            }
            reg_fence(sl[i]);
            reg_fence(wh);
            reg_fence(wl);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              wgmma_rs<64>(sl[i], wh + 4 * kk, desc_mn(xg, kk));
              wgmma_rs<64>(sl[i], wl + 4 * kk, desc_mn(xg, kk));
            }
            wgmma_commit();
            wgmma_wait<0>();
            reg_fence(sl[i]);
            reg_fence(wh);
            reg_fence(wl);
          }
          if (m0 == 0) {
            reg_fence(yacc);
            reg_fence(ph);
            reg_fence(pl);
            if (TRACE && tid == 0) tr[g * TR_N + TR_PRE] = clock64();
          }

          float sp[HB][32];
          if (!first) {
            const long long t_start = clock64();  // trap, not hang, if lost
            if (m0 == 0 && lane == 0) {
              uint64_t v, t;
              do {
                ld_tagged(slot + 2 * tid, v, t);
                if (clock64() - t_start > (1LL << 34)) __trap();
              } while (t != tag_in);
            }
            __syncwarp();
            bool ok;
            do {
              ok = true;
#pragma unroll
              for (int u = 0; u < HB * 16; ++u) {
                uint64_t v, t;
                ld_tagged(slot + 2 * ((m0 * 16 + u) * 128 + tid), v, t);
                ok = ok && t == tag_in;
                sp[u / 16][2 * (u % 16)] = __uint_as_float((uint32_t)v);
                sp[u / 16][2 * (u % 16) + 1] =
                    __uint_as_float((uint32_t)(v >> 32));
              }
              if (clock64() - t_start > (1LL << 34)) __trap();
            } while (!ok);
          } else {
#pragma unroll
            for (int i = 0; i < HB; ++i)
#pragma unroll
              for (int e = 0; e < 32; ++e) sp[i][e] = 0.0f;
          }
          if (TRACE && tid == 0 && m0 == 0) {
            tr[g * TR_N + TR_FLAG] = clock64();
            tr[g * TR_N + TR_FLAG_NS] = global_ns();
          }
          if (!last) {
#pragma unroll
            for (int u = 0; u < HB * 16; ++u) {
              const float* q = sp[u / 16] + 2 * (u % 16);
              const float* l = sl[u / 16] + 2 * (u % 16);
              st_tagged(slot + 2 * ((m0 * 16 + u) * 128 + tid),
                        (uint64_t)__float_as_uint(decay * q[0] + l[0]) |
                            ((uint64_t)__float_as_uint(decay * q[1] + l[1])
                             << 32),
                        tag_out);
            }
          }
#pragma unroll
          for (int i = 0; i < HB; ++i) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int n0 = 64 * (m0 + i) + ra, n1 = n0 + 8;
              uint32_t hi, lo;
              split_bf16(sp[i][4 * e], sp[i][4 * e + 1], hi, lo);
              *reinterpret_cast<uint32_t*>(s_hi + swz(n0, e) + 4 * t4) = hi;
              *reinterpret_cast<uint32_t*>(s_lo + swz(n0, e) + 4 * t4) = lo;
              split_bf16(sp[i][4 * e + 2], sp[i][4 * e + 3], hi, lo);
              *reinterpret_cast<uint32_t*>(s_hi + swz(n1, e) + 4 * t4) = hi;
              *reinterpret_cast<uint32_t*>(s_lo + swz(n1, e) + 4 * t4) = lo;
            }
          }
        }
        if (TRACE && tid == 0 && !last) {
          tr[g * TR_N + TR_PUB] = clock64();
          tr[g * TR_N + TR_PUB_NS] = global_ns();
        }
        fence_async_shared();  // S^T's tiles, for the wgmma below
        named_sync(bar, 128);  // and every warp's products have read x

        // + exp(cum) o (C S^T): C from registers, S^T MN-major (hi, lo)
        float yx[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) yx[i] = 0.0f;
        {
          uint32_t cf[NA * 16];
          load_c<NA>(cf, ctile);
          const uint32_t sh = smem_u32(s_hi), sw = smem_u32(s_lo);
          reg_fence(yx);
          reg_fence(cf);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < NA * 4; ++kk) {
            wgmma_rs<64>(yx, cf + 4 * kk, desc_mn(sh, kk));
            wgmma_rs<64>(yx, cf + 4 * kk, desc_mn(sw, kk));
          }
          wgmma_commit();
          wgmma_wait<0>();
          reg_fence(yx);
          reg_fence(cf);
        }
        if (TRACE && tid == 0) tr[g * TR_N + TR_INTER] = clock64();
        // + D_h x; y rounded to bf16 over the warp's 16 rows of x's tile
        // (every product that read x is done: the barrier above), stored
        // by the warp's own TMA (steps past L, columns past P dropped)
        const float ea = ex2f(cha + cla), eb = ex2f(chb + clb);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = r ? rb : ra;
            const float e = r ? eb : ea;
            __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
                xt + swz(row, i) + 4 * t4);
            const float2 xv = __bfloat1622float2(*p);
            *p = __floats2bfloat162_rn(
                yacc[4 * i + 2 * r] + e * yx[4 * i + 2 * r] + dh * xv.x,
                yacc[4 * i + 2 * r + 1] + e * yx[4 * i + 2 * r + 1] +
                    dh * xv.y);
          }
        }
        fence_async_shared();
        __syncwarp();
        if (lane == 0) {
          tma_store_4d(&maps.y, xt + warp * 16 * 128, P_SLICE * wk.ps, h,
                       t0 + 16 * warp, wk.b);
          tma_store_commit();
          if (TRACE && tid == 0) tr[g * TR_N + TR_END] = clock64();
        }
      }
      // the stage goes back to the producer once each warp's y stores
      // have read it
      if (lane == 0) {
        tma_store_wait_read();
        mbar_arrive(&empty[s]);
      }
    }
  }
  // the last block to finish resets the work counter for the next call
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(scr.counters + 1, 1u) == gridDim.x - 1) {
      scr.counters[0] = 0;
      scr.counters[1] = 0;
      __threadfence();
    }
  }
}

template <int G, int NA, int WGS, int ST, int MINB, bool TRACE = false>
static int launch_bf16(const void* x, const void* dt, const void* a,
                       const void* bm, const void* cm, const void* d,
                       void* y, int batch, int L, int H, int P, int N,
                       const long long* xs, const long long* bs,
                       const long long* cs, void* scratch,
                       unsigned long long epoch, cudaStream_t stream,
                       long long* trace = nullptr) {
  using C = SsdCfg<G, NA, WGS, ST, MINB>;
  SsdMaps maps;
  memset(&maps, 0, sizeof(maps));
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  {  // x (P, H, L, B) over its strides (elements: batch, step, head)
    const cuuint64_t dims[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)L,
                                (cuuint64_t)batch};
    const cuuint64_t st[3] = {(cuuint64_t)xs[2] * 2, (cuuint64_t)xs[1] * 2,
                              (cuuint64_t)xs[0] * 2};
    const cuuint32_t box[4] = {64, 1, SQ, 1};
    if (!encode_bf16_map(&maps.x, x, 4, dims, st, box, sw))
      return (int)cudaErrorInvalidValue;
  }
  {  // y (B, L, H, P) contiguous, as (P, H, L, B); a warp's 16 rows a box
    const cuuint64_t dims[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)L,
                                (cuuint64_t)batch};
    const cuuint64_t st[3] = {(cuuint64_t)P * 2, (cuuint64_t)H * P * 2,
                              (cuuint64_t)L * H * P * 2};
    const cuuint32_t box[4] = {64, 1, 16, 1};
    if (!encode_bf16_map(&maps.y, y, 4, dims, st, box, sw))
      return (int)cudaErrorInvalidValue;
  }
  const void* bc[2] = {bm, cm};
  const long long* bcs[2] = {bs, cs};
  CUtensorMap* bcm[2] = {&maps.b, &maps.c};
  for (int i = 0; i < 2; ++i) {  // B, C (N, L, B) over their strides
    const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)L,
                                (cuuint64_t)batch};
    const cuuint64_t st[2] = {(cuuint64_t)bcs[i][1] * 2,
                              (cuuint64_t)bcs[i][0] * 2};
    const cuuint32_t box[3] = {64, SQ, 1};
    if (!encode_bf16_map(bcm[i], bc[i], 3, dims, st, box, sw))
      return (int)cudaErrorInvalidValue;
  }
  unsigned char* base = static_cast<unsigned char*>(scratch);
  SsdScratch scr{reinterpret_cast<unsigned int*>(base),
                 reinterpret_cast<uint64_t*>(base + SCRATCH_STATES)};
  auto kern = ssd_kernel_bf16<G, NA, WGS, ST, MINB, TRACE>;
  // setmaxnreg.inc waits until the block's registers allow it: refuse a
  // build whose register count would leave the consumers waiting forever
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return (int)e;
    regs = fa.numRegs;
  }
  if (regs * C::BLOCK_THREADS <
      128 * (WGS * C::MMA_REGS + SSD_PRODUCER_REGS))
    return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_groups = (H + G - 1) / G, n_chunks = (L + SQ - 1) / SQ;
  const int nps = (P + P_SLICE - 1) / P_SLICE;
  const long n_work = (long)n_chunks * batch * n_groups * nps;
  if (n_work > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  // persistent: MINB blocks an SM, each consumer taking work tiles in
  // chunk order from the counter
  const long cap = (long)sms * MINB;
  const int grid = (int)(n_work < cap ? n_work : cap);
  kern<<<grid, C::BLOCK_THREADS, C::SMEM, stream>>>(maps,
                                               static_cast<const float*>(dt),
                                               static_cast<const float*>(a),
                                               static_cast<const float*>(d),
                                               scr, L, H, batch, n_groups,
                                               nps, n_chunks, epoch, trace);
  return (int)cudaGetLastError();
}

// ---- float32: CUDA cores -------------------------------------------------

static int launch_f32(const void* x, const void* dt, const void* a,
                      const void* b, const void* c, const void* d, void* y,
                      int batch, int L, int H, int P, int N,
                      cudaStream_t stream) {
  if (N > F32_MAX_N) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(P < P_SLICE ? P : P_SLICE, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)batch * H * ((P + P_SLICE - 1) / P_SLICE);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  ssd_kernel<<<(int)blocks, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(d),
      static_cast<float*>(y), L, H, P, N);
  return (int)cudaGetLastError();
}

// ---- any N: CUDA cores, the state in device memory -------------------------

#define WIDE_NC 64  // columns of N a pass takes

// the sums and carried state of the wide kernel: float64 for float32
// operands, float32 for bf16
template <typename T>
struct WideAcc {
  using type = float;
};
template <>
struct WideAcc<float> {
  using type = double;
};

template <typename T>
static size_t wide_smem_bytes() {
  using A = typename WideAcc<T>::type;
  const size_t nk = WIDE_NC + 1;
  return sizeof(double) * TQ                      // cum
         + sizeof(float) * (2 * TQ * nk           // a pass of B, C
                            + TQ * (TQ + 1)       // decay-masked C B^T
                            + TQ * P_SLICE        // dt x
                            + 3 * TQ)  // dt, exp(cum), exp(tot - cum)
         + sizeof(A) * P_SLICE * nk;   // a pass of the state
}

// States past N 256, in either type: the float32 kernel's steps, with the
// carried state of block (batch, head, P slice) in device memory (`state`,
// (batch, H, P, N) in the sums' type, the wrapper's; the first chunk reads
// none, so it needs no zeroing) and N taken in passes of 64 columns
// through shared memory: C B^T summed over the passes, C S^T likewise
// (C's pass read again), and the state updated a pass at a time, each
// thread its own (p, n) items. x, B and C are read over their strides
// (elements); y is contiguous. Sums in float32 for bf16, y rounded to it.
// For float32 operands the sums over N and the carried state are float64:
// at N 320 and Zamba2's decays |y| reaches ~350, where the plain version's
// float32 sums alone sit ~1.2e-4 from float64's, so a second float32
// order could differ from it by more than the 2e-4 bar. Slow, and right
// at any N (84,224 bytes of shared memory whatever N is; 100,864 for
// float32).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_kernel_wide(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ dskip,
                    T* __restrict__ y,
                    typename WideAcc<T>::type* __restrict__ state, int L,
                    int H, int P, int N, long long x_sb, long long x_sl,
                    long long x_sh, long long b_sb, long long b_sl,
                    long long c_sb, long long c_sl) {
  using A = typename WideAcc<T>::type;
  extern __shared__ double sm[];
  constexpr int nk = WIDE_NC + 1, gk = TQ + 1;
  double* cum = sm;             // TQ: inclusive cumsum of A_h dt
  A* sts = reinterpret_cast<A*>(cum + TQ);  // P_SLICE x nk: state's pass
  float* bs = reinterpret_cast<float*>(sts + P_SLICE * nk);  // TQ x nk: B
  float* cs = bs + TQ * nk;     // TQ x nk: a pass of C
  float* g = cs + TQ * nk;      // TQ x (TQ + 1)
  float* xd = g + TQ * gk;      // TQ x P_SLICE: dt * x
  float* dts = xd + TQ * P_SLICE;  // TQ
  float* ecum = dts + TQ;       // TQ: exp(cum)
  float* eout = ecum + TQ;      // TQ: exp(cum_last - cum)
  const int tid = threadIdx.x, lane = tid & 31;
  const int nps = (P + P_SLICE - 1) / P_SLICE;
  const int bh = blockIdx.x / nps, p0 = blockIdx.x % nps * P_SLICE;
  const int b = bh / H, h = bh % H, ps_n = min(P_SLICE, P - p0);
  const float ah = a[h], dh = dskip[h];
  const T* xp = x + b * x_sb + h * x_sh + p0;
  const T* bp = bm + b * b_sb;
  const T* cp = cm + b * c_sb;
  A* stp = state + ((size_t)bh * P + p0) * N;  // rows p0.. of (P, N)
  const int ti = tid >> 4, tj = tid & 15;

  // a pass of B and (with `want_c`) C: steps [t0, t0 + q), columns n0..
  auto load_pass = [&](int t0, int q, int n0, int nc, bool want_c) {
    for (int i = tid; i < TQ * WIDE_NC; i += THREADS) {
      const int j = i / WIDE_NC, n = i - j * WIDE_NC;
      const bool ok = j < q && n < nc;
      bs[j * nk + n] = ok ? to_f32(bp[(t0 + j) * b_sl + n0 + n]) : 0.0f;
      if (want_c)
        cs[j * nk + n] = ok ? to_f32(cp[(t0 + j) * c_sl + n0 + n]) : 0.0f;
    }
  };

  for (int t0 = 0; t0 < L; t0 += TQ) {
    const int q = min(TQ, L - t0);
    const bool first = t0 == 0;
    __syncthreads();  // the previous tile is done with every buffer

    if (tid < TQ) {
      const float d = tid < q ? dt[((size_t)b * L + t0 + tid) * H + h] : 0.0f;
      double v = ah * d;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      dts[tid] = d;
      cum[tid] = v;
    }
    __syncthreads();
    if (tid >= 32 && tid < TQ) cum[tid] += cum[31];
    __syncthreads();
    const double total = cum[TQ - 1];
    if (tid < TQ) {
      ecum[tid] = expf((float)cum[tid]);
      eout[tid] = expf((float)(total - cum[tid]));
    }
    for (int i = tid; i < TQ * P_SLICE; i += THREADS) {
      const int j = i / P_SLICE, p = i - j * P_SLICE;
      xd[i] = j < q && p < ps_n ? to_f32(xp[(t0 + j) * x_sl + p]) * dts[j]
                                : 0.0f;
    }

    // g = (C B^T) o M, lower triangle, C B^T summed over the passes
    {
      A acc[4][4] = {};
      for (int n0 = 0; n0 < N; n0 += WIDE_NC) {
        const int nc = min(WIDE_NC, N - n0);
        __syncthreads();  // the previous pass is done with bs, cs
        load_pass(t0, q, n0, nc, true);
        __syncthreads();
        for (int n = 0; n < nc; ++n) {
          A cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = cs[(ti + 16 * r) * nk + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = bs[(tj + 16 * c) * nk + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] += cv[r] * bv[c];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ti + 16 * r, j = tj + 16 * c;
          g[i * gk + j] =
              i >= j ? (float)acc[r][c] * expf((float)(cum[i] - cum[j]))
                     : 0.0f;
        }
    }
    __syncthreads();

    // y = g (dt x) + exp(cum) o (C S^T) + D_h x, rows ti + 16r, cols
    // tj + 16c of the slice; C S^T summed over the passes
    {
      A yi[4][4] = {}, ys[4][4] = {};
      for (int j = 0; j < TQ; ++j) {
        A gv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = g[(ti + 16 * r) * gk + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = xd[j * P_SLICE + tj + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) yi[r][c] += gv[r] * xv[c];
      }
      for (int n0 = 0; !first && n0 < N; n0 += WIDE_NC) {
        const int nc = min(WIDE_NC, N - n0);
        __syncthreads();
        load_pass(t0, q, n0, nc, true);
        for (int i = tid; i < P_SLICE * WIDE_NC; i += THREADS) {
          const int p = i / WIDE_NC, n = i - p * WIDE_NC;
          sts[p * nk + n] =
              p < ps_n && n < nc ? stp[(size_t)p * N + n0 + n] : A(0);
        }
        __syncthreads();
        for (int n = 0; n < nc; ++n) {
          A cv[4], sv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = cs[(ti + 16 * r) * nk + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) sv[c] = sts[(tj + 16 * c) * nk + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) ys[r][c] += cv[r] * sv[c];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
        if (i >= q) continue;
        const size_t row = (((size_t)b * L + t0 + i) * H + h) * P + p0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tj + 16 * c;
          if (p >= ps_n) continue;
          const float xv = to_f32(xp[(t0 + i) * x_sl + p]);
          from_f32(&y[row + p],
                   (float)(yi[r][c] + ecum[i] * ys[r][c] + dh * xv));
        }
      }
    }

    // S = exp(total) S + (exp(total - cum) o dt x)^T B, a pass of N at a
    // time; rows ti + 16r of the slice, columns n0 + tj + 16c
    const float decay = expf((float)total);
    for (int n0 = 0; n0 < N; n0 += WIDE_NC) {
      const int nc = min(WIDE_NC, N - n0);
      __syncthreads();  // every read of the old state and of bs is done
      load_pass(t0, q, n0, nc, false);
      __syncthreads();
      A acc[4][4] = {};
      for (int j = 0; j < TQ; ++j) {
        A wv[4], bv[4];
        const A e = eout[j];
#pragma unroll
        for (int r = 0; r < 4; ++r) wv[r] = e * xd[j * P_SLICE + ti + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = bs[j * nk + tj + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += wv[r] * bv[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = ti + 16 * r;
        if (p >= ps_n) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = tj + 16 * c;
          if (n >= nc) continue;
          A* sp = stp + (size_t)p * N + n0 + n;
          *sp = (first ? A(0) : decay * *sp) + acc[r][c];
        }
      }
    }
  }
}

template <typename T>
static int launch_wide(const void* x, const void* dt, const void* a,
                       const void* b, const void* c, const void* d, void* y,
                       void* state, int batch, int L, int H, int P, int N,
                       const long long* xs, const long long* bs,
                       const long long* cs, cudaStream_t stream) {
  const size_t smem = wide_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)batch * H * ((P + P_SLICE - 1) / P_SLICE);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  ssd_kernel_wide<T><<<(int)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(d),
      static_cast<T*>(y), static_cast<typename WideAcc<T>::type*>(state), L,
      H, P, N, xs[0],
      xs[1], xs[2], bs[0], bs[1], cs[0], cs[1]);
  return (int)cudaGetLastError();
}

// x, y (batch, L, H, P); dt (batch, L, H) float32 contiguous; a, d (H,)
// float32; b, c (batch, L, N). x, b, c, y are bf16 when bf16 != 0, else
// float32; y contiguous. `na` names the kernel (the wrapper's `ops.plan`):
// bf16 na 1, 2 or 4, the Hopper kernel with N in na 64-column atoms, and
// `scratch` ops.scratch_bytes(batch, H, P, N) bytes that only this stream
// uses, tagged by `epoch`; float32 na > 0, the shared-memory kernel (N up
// to 256, every tensor contiguous); na 0, either type, the wide kernel,
// `scratch` the (batch, H, P, N) state, float64 for float32 operands and
// float32 for bf16. x, b, c are read over
// their strides, in elements — xs (batch, step, head), bs and cs (batch,
// step) — which for bf16 must be multiples of 8, with P and N multiples of
// 8 and the pointers 16-byte aligned (the wrapper checks and pads).
// Every route cuts P into slices of 64.
extern "C" int ssd_scan(const void* x, const void* dt, const void* a,
                        const void* b, const void* c, const void* d, void* y,
                        int batch, int L, int H, int P, int N, int bf16,
                        int na, long long x_sb, long long x_sl,
                        long long x_sh, long long b_sb, long long b_sl,
                        long long c_sb, long long c_sl, void* scratch,
                        unsigned long long epoch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long xs[3] = {x_sb, x_sl, x_sh}, bs[2] = {b_sb, b_sl},
                  cs[2] = {c_sb, c_sl};
  if (na == 0)
    return bf16 ? launch_wide<__nv_bfloat16>(x, dt, a, b, c, d, y, scratch,
                                             batch, L, H, P, N, xs, bs, cs, s)
                : launch_wide<float>(x, dt, a, b, c, d, y, scratch, batch, L,
                                     H, P, N, xs, bs, cs, s);
  if (!bf16) return launch_f32(x, dt, a, b, c, d, y, batch, L, H, P, N, s);
  if (N > 64 * na) return (int)cudaErrorInvalidValue;
  if (na == 1)
    return launch_bf16<2, 1, 2, 4, 1>(x, dt, a, b, c, d, y, batch, L, H, P,
                                      N, xs, bs, cs, scratch, epoch, s);
  if (na == 2)
    return launch_bf16<2, 2, 1, 2, 1>(x, dt, a, b, c, d, y, batch, L, H, P,
                                      N, xs, bs, cs, scratch, epoch, s);
  if (na == 4)
    return launch_bf16<2, 4, 1, 1, 1>(x, dt, a, b, c, d, y, batch, L, H, P,
                                      N, xs, bs, cs, scratch, epoch, s);
  return (int)cudaErrorInvalidValue;
}
