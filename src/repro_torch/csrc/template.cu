// Fleet-scale criticality template scoring (paper §III-B): one VM per warp
// up to 1,024 slots, one VM per block past that.
//
// Replaces the TPU kernel `criticality_scores_pallas` / `_criticality_kernel`
// (src/repro/kernels/template/template.py). Per (B, T) row of utilization
// series it computes [Compare8, Compare12] = [dev24/dev8, dev24/dev12]:
//   1. de-trend by the mean of the previous 24 h, from an inclusive cumsum
//      with the prefix-mean warm-up, exactly as `rolling_day_mean`;
//   2. normalize by the population std, floored as the oracle floors it:
//      x / max(sqrt(var), EPS). The TPU kernel floored var at EPS^2 inside
//      the sqrt instead; since sqrt is monotone the two agree but for
//      rounding;
//   3. per-slot median templates for periods 48/24/16 over T/period
//      repetitions; an even count averages the two middle values as
//      `jnp.median` does;
//   4. |x - tiled template| per period, and the mean of the
//      k = round(keep_frac T) smallest (keep_frac 0.8 by default), selected
//      exactly: the function the sort-based oracle computes. The TPU
//      kernel approximated this selection by a 24-step bisection because
//      it has no cheap sort.
//
// What bounds it on the H100: the kernel reads 4 T bytes and writes 8 bytes
// per row (63 MB at 65,536 x 240, under 20 us at 3.35 TB/s) and does a few
// hundred operations per element, so instruction slots, not bytes, set its pace.
// The first design, one block of 256 threads per row with the row in shared
// memory, took 1.47 ms there and 0.210 ms at 8,000 x 240 (NVIDIA H100 80GB
// HBM3, 700.00 W, from chip_smoke.py): ~80x its byte bound, spent in ~44
// block-wide barriers (36 of them in a bitonic network with half the
// threads idle) and in 88 threads ranking the medians while 168 waited.
// This design takes 0.046 ms and 0.32 ms of kernel time (same card and
// limit, chip_smoke.py's profiler times), 17x the byte bound at 65,536
// rows; by instruction count the exact selection's passes take most of
// its instruction slots.
//
// Design (T <= 1,024): WARPS rows per block, one warp per row, no block
// barrier at all.
// - Lane j holds elements [j PER, (j + 1) PER) in registers (PER = NP / 32,
//   NP the next power of two >= T: 8 at T = 240, 32 at T = 1008), loaded as
//   float4 (float2 at T = 48).
// - Cumsum: a serial scan of the lane's PER values plus the exclusive
//   shuffle scan of the lane totals, in float64 (exact for utilization
//   series) and rounded to float32 slot by slot, which is what the plain
//   version's CPU cumsum computes. A float32 scan in another order moves
//   cs by an ulp, and on a row of 239 slots at 100 and one at 99.66 that
//   ulp decides whether the de-trended row is flat (Compare8 0) or noisy
//   (Compare8 1). The window's start cs[i - 48] comes by one shuffle from
//   a lane below (48 is a whole number of lanes).
// - Mean and std: two passes of xor-butterfly warp sums in float64; the
//   sums of the k smallest deviations too.
// - Medians: the normalized row goes to a per-warp buffer in shared
//   memory (__syncwarp only, no block barrier); lane j takes slots j,
//   j + 32 of each period, loads the slot's repetitions into registers
//   (+inf past T / p) and sorts them with Batcher's odd-even merge
//   network (16 wide for periods 24 and 16 at T = 240, 8 for period 48):
//   4 rounds of a few hundred instructions, where ranking every element
//   against its slot's repetitions took 3 T x T / p compares.
// - Selection: the deviations' bit patterns order as unsigned ints (they
//   are non-negative floats, +inf included). A radix select sets the k-th
//   smallest's bits from 30 down to 0: a bit is set when fewer than k
//   patterns lie under the prefix with it set (one compare a pattern; one
//   warp reduction a bit carries the counts of all three periods, packed),
//   and a period's walk stops as soon as one pattern is left between the
//   prefix and its next step. The k-th smallest v_k and the count `below`
//   of patterns under it are then exact, and the sum of the k smallest is
//   sum(d < v_k) + (k - below) v_k (emulated on the CPU in
//   `ref.smallest_k_radix`).
#include <cuda_runtime.h>
#include <math.h>

#define WARPS 8
#define N_SLOTS (48 + 24 + 16)
#define EPS 1e-6f
#define FULL 0xffffffffu
// Pattern of the padding past T: above every mid a radix pass compares
// with, so it never counts, and below 2^31, so that (u - mid) >> 31 is
// u < mid for every pattern.
#define PAD 0x7fffffffu

template <typename F>
__device__ __forceinline__ F warp_sum(F v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Sums of the k smallest of the warp's 32 PER patterns u[q] (non-negative
// floats as unsigned ints, under 2^31; PAD marks padding past T, which
// never counts) for the three periods q, by exact radix selects of the k-th
// smallest run side by side: one warp reduction a pass carries the three
// counts packed 10 bits apart (each at most T <= 1,008). The values under
// v_k are summed in float64.
template <int PER>
__device__ __forceinline__ void smallest_k_sums(const unsigned (&u)[3][PER],
                                                int k, int T,
                                                float (&sum)[3]) {
  unsigned prefix[3] = {0u, 0u, 0u};  // the bits above b of the k-th
  unsigned hi[3];                     // prefix + 2^b once one is left
  int below[3] = {0, 0, 0};           // patterns < prefix
  int upto[3] = {T, T, T};            // patterns < prefix + 2^(b + 1)
  bool done[3] = {false, false, false};
  for (int b = 30; b >= 0; --b) {
    unsigned packed = 0;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const unsigned mid = prefix[q] | (1u << b);
      unsigned c = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) c += (u[q][j] - mid) >> 31;  // u < mid
      packed |= c << (10 * q);
    }
    packed = __reduce_add_sync(FULL, packed);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int c = (packed >> (10 * q)) & 1023;
      if (!done[q]) {
        if (c < k) {
          prefix[q] |= 1u << b;
          below[q] = c;
        } else {
          upto[q] = c;
        }
        hi[q] = prefix[q] + (1u << b);
        done[q] = upto[q] - below[q] == 1 || b == 0;
      }
    }
    if (done[0] && done[1] && done[2]) break;
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    // the one pattern in [prefix, hi) is v_k; all others under hi are less
    unsigned m = 0;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (u[q][j] < hi[q]) m = max(m, u[q][j]);
    const unsigned vk = __reduce_max_sync(FULL, m);
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if (u[q][j] < vk) s += __uint_as_float(u[q][j]);
    sum[q] = (float)(warp_sum(s) + (double)(k - below[q]) * __uint_as_float(vk));
  }
}

// Smallest power of two >= ceil(np / p): the sorting network's width for
// the repetitions of one slot of period p in a row of at most np slots.
__host__ __device__ constexpr int net_size(int np, int p) {
  int n = 1;
  while (n * p < np) n <<= 1;
  return n;
}

// Batcher's odd-even merge sort over N registers, ascending (63 compare-
// exchanges at N = 16, where a bitonic network takes 80). Comparator
// (x, x + k) of merge stage (p, k) exists when x >= k % p, (x - k % p)
// mod 2k < k and x, x + k lie in one block of 2p; every index is a
// compile-time constant once the loops unroll.
template <int N>
__device__ __forceinline__ void sort_net(float (&v)[N]) {
#pragma unroll
  for (int p = 1; p < N; p <<= 1) {
#pragma unroll
    for (int k = p; k >= 1; k >>= 1) {
#pragma unroll
      for (int x = 0; x < N; ++x) {
        if (x + k < N && x >= k % p && (x - k % p) % (2 * k) < k &&
            x / (2 * p) == (x + k) / (2 * p)) {
          const float a = v[x], b = v[x + k];
          v[x] = fminf(a, b);
          v[x + k] = fmaxf(a, b);
        }
      }
    }
  }
}

// Per-slot medians of period P over the T / P repetitions of the row in
// `buf`: lane j takes slots j, j + 32, ..., sorts the slot's repetitions
// (+inf past T / P) in registers and averages the two middle values of an
// even count, as `jnp.median` does.
template <int P, int N>
__device__ __forceinline__ void medians(const float* buf, float* tm, int T,
                                        int lane) {
  const int reps = T / P, hi_r = reps / 2, lo_r = (reps - 1) / 2;
  for (int s = lane; s < P; s += 32) {
    float v[N];
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] = c < reps ? buf[s + c * P] : INFINITY;
    sort_net<N>(v);
    float lo = v[0], hi = v[0];
#pragma unroll
    for (int c = 1; c < N; ++c) {
      if (c == lo_r) lo = v[c];
      if (c == hi_r) hi = v[c];
    }
    tm[s] = (reps & 1) ? hi : (lo + hi) * 0.5f;
  }
}

template <int PER>
__global__ void __launch_bounds__(WARPS * 32)
criticality_kernel(const float* __restrict__ series, float* __restrict__ out,
                   int B, int T, int k) {
  __shared__ __align__(16) float s_row[WARPS][32 * PER];
  __shared__ float s_tmpl[WARPS][N_SLOTS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= B) return;              // warp-uniform; no block barriers
  float* buf = s_row[warp];
  float* tmpl = s_tmpl[warp];
  const float* src = series + (size_t)row * T;
  const int i0 = lane * PER;

  // T is a multiple of 48, so a float4 (float2) is wholly in or past T
  float x[PER];
  constexpr int V = PER >= 4 ? 4 : 2;
#pragma unroll
  for (int j = 0; j < PER; j += V) {
    if (i0 + j < T) {
      if constexpr (V == 4) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(src + i0 + j));
        x[j] = w.x;
        x[j + 1] = w.y;
        x[j + 2] = w.z;
        x[j + 3] = w.w;
      } else {
        const float2 w = __ldg(reinterpret_cast<const float2*>(src + i0 + j));
        x[j] = w.x;
        x[j + 1] = w.y;
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[j + v] = 0.0f;
    }
  }

  // 1. inclusive cumsum in float64 (exact for such rows), rounded to
  //    float32 slot by slot as the plain version's CPU cumsum rounds it:
  //    serial in the lane, then the exclusive scan of the lane totals
  double part[PER];
  double run = 0.0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    run += x[j];
    part[j] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double n = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += n;
  }
  double excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.0;
  float cs[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) cs[j] = (float)(excl + part[j]);
  // de-trend: divide by the mean of the previous 48 slots (prefix mean
  // while fewer than 48 exist). cs[i - 48] sits in register j of lane
  // lane - 48 / PER (PER <= 16), or at j -+ 16 one or two lanes down.
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    float prev;
    if constexpr (PER <= 16)
      prev = __shfl_up_sync(FULL, cs[j], 48 / PER);
    else
      prev = __shfl_up_sync(FULL, cs[(j + 16) & (PER - 1)], j >= 16 ? 1 : 2);
    const int i = i0 + j;
    if (i < T) {
      const int lo = max(i - 47, 0);
      const float win = cs[j] - (i >= 48 ? prev : 0.0f);
      const float mean = win / (float)(i - lo + 1);
      x[j] = x[j] / fmaxf(mean, EPS);
    }
  }

  // 2. normalize by the population std of the whole row (two passes in
  //    float64, as the plain version's CPU std accumulates)
  double acc = 0.0;
#pragma unroll
  for (int j = 0; j < PER; ++j) acc += x[j];       // padding holds 0
  const double mu = warp_sum(acc) / T;
  acc = 0.0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const double d = x[j] - mu;
    if (i0 + j < T) acc += d * d;
  }
  const float sd = fmaxf((float)sqrt(warp_sum(acc) / T), EPS);
#pragma unroll
  for (int j = 0; j < PER; ++j) x[j] = x[j] / sd;
#pragma unroll
  for (int j = 0; j < PER; j += V) {
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(buf + i0 + j) =
          make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
    else
      *reinterpret_cast<float2*>(buf + i0 + j) = make_float2(x[j], x[j + 1]);
  }
  __syncwarp();

  // 3. median templates: slots [0,48) period 48, [48,72) period 24,
  //    [72,88) period 16, one slot a lane
  medians<48, net_size(32 * PER, 48)>(buf, tmpl, T, lane);
  medians<24, net_size(32 * PER, 24)>(buf, tmpl + 48, T, lane);
  medians<16, net_size(32 * PER, 16)>(buf, tmpl + 72, T, lane);
  __syncwarp();

  // 4. deviations (padding past T) and the mean of the k smallest
  unsigned u[3][PER];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int p = q == 0 ? 48 : (q == 1 ? 24 : 16);
    const int off = q == 0 ? 0 : (q == 1 ? 48 : 72);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = i0 + j;
      u[q][j] = i < T ? __float_as_uint(fabsf(x[j] - tmpl[off + i % p]))
                      : PAD;
    }
  }
  float dev[3];
  smallest_k_sums<PER>(u, k, T, dev);
#pragma unroll
  for (int q = 0; q < 3; ++q) dev[q] = dev[q] / (float)k;
  if (lane == 0) {
    out[(size_t)row * 2] = dev[0] / fmaxf(dev[2], EPS);
    out[(size_t)row * 2 + 1] = dev[0] / fmaxf(dev[1], EPS);
  }
}

// ---- long series: a block a row, the row in shared memory ---------------
//
// Past 1,024 slots a row no longer fits a warp's registers. Here one block
// of BLOCK_THREADS takes a row, held in shared memory with one buffer of
// the same size (8 T bytes, up to 28,896 slots in the 227 KB a block may
// have), and computes what the warp path computes, in the same arithmetic:
// - cumsum: each thread sums a run of ceil(T / threads) slots serially in
//   float64, a block scan of the run totals gives each run's start, and
//   each slot's cumsum is rounded to float32 from float64, as above;
// - mean and std: two passes of float64 block sums;
// - medians: per period the row copied slot-major into the second
//   buffer, then a warp a slot: its T / p repetitions (270 for the 8 h
//   period at T = 4,320, past what a sorting network unrolls) selected in
//   place by a radix select over their order-preserving bit patterns,
//   which finds the lower middle value, and one more pass the upper (the
//   next pattern, or the same one when it repeats);
// - deviations of one period at a time in the second buffer, and the k
//   smallest summed after a block-wide radix select of the k-th smallest,
//   bits 30 to 0, as `smallest_k_sums` (the three periods one after
//   another: their deviations do not fit beside the row together).
#define BLOCK_THREADS 256
#define BLOCK_WARPS (BLOCK_THREADS / 32)

// float bit patterns in an order an unsigned compare keeps: negatives
// flipped whole, non-negatives with the sign bit set
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the block's sum of v, in warp order, the same at every thread
__device__ __forceinline__ double block_sum(double v, double* red) {
  v = warp_sum(v);
  __syncthreads();  // the last use of `red` is over
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int w = 0; w < BLOCK_WARPS; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ unsigned block_count(unsigned c, unsigned* red) {
  c = __reduce_add_sync(FULL, c);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = c;
  __syncthreads();
  unsigned s = 0;
#pragma unroll
  for (int w = 0; w < BLOCK_WARPS; ++w) s += red[w];
  return s;
}

// the median of the reps values at `v` (one slot's repetitions), by the
// calling warp
__device__ float slot_median(const float* v, int reps, int lane) {
  const int lo_r = (reps - 1) / 2;  // 0-based rank of the lower middle
  unsigned prefix = 0;  // the largest pattern with <= lo_r patterns under it
  for (int b = 31; b >= 0; --b) {
    const unsigned mid = prefix | (1u << b);
    unsigned c = 0;
    for (int r = lane; r < reps; r += 32) c += order_key(v[r]) < mid;
    if (__reduce_add_sync(FULL, c) <= (unsigned)lo_r) prefix = mid;
  }
  const float lo = key_value(prefix);
  if (reps & 1) return lo;
  // the upper middle: the same pattern when more than lo_r + 1 are at or
  // under it, else the least pattern above it
  unsigned le = 0, next = 0xffffffffu;
  for (int r = lane; r < reps; r += 32) {
    const unsigned u = order_key(v[r]);
    le += u <= prefix;
    if (u > prefix) next = min(next, u);
  }
  le = __reduce_add_sync(FULL, le);
  next = __reduce_min_sync(FULL, next);
  const float hi = le > (unsigned)(lo_r + 1) ? lo : key_value(next);
  return (lo + hi) * 0.5f;
}

__global__ void __launch_bounds__(BLOCK_THREADS)
criticality_block_kernel(const float* __restrict__ series,
                         float* __restrict__ out, int T, int k) {
  extern __shared__ __align__(16) float s_buf[];
  __shared__ float tmpl[N_SLOTS];
  __shared__ double red[BLOCK_WARPS];
  __shared__ unsigned cnt[BLOCK_WARPS];
  float* x = s_buf;       // the row, de-trended and normalized in place
  float* w = s_buf + T;   // the cumsum, then one period's deviations
  unsigned* u = reinterpret_cast<unsigned*>(w);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* src = series + (size_t)blockIdx.x * T;
  for (int i = tid; i < T / 4; i += BLOCK_THREADS)
    reinterpret_cast<float4*>(x)[i] =
        __ldg(reinterpret_cast<const float4*>(src) + i);
  __syncthreads();

  // 1. inclusive cumsum in float64, rounded to float32 slot by slot: a
  //    run of `per` slots a thread, then the exclusive scan of the runs
  const int per = (T + BLOCK_THREADS - 1) / BLOCK_THREADS;
  const int i0 = min(tid * per, T), i1 = min(i0 + per, T);
  double run = 0.0;
  for (int i = i0; i < i1; ++i) run += x[i];
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double n = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += n;
  }
  if (lane == 31) red[warp] = incl;
  double excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.0;
  __syncthreads();
  for (int v = 0; v < warp; ++v) excl += red[v];
  double part = 0.0;
  for (int i = i0; i < i1; ++i) {
    part += x[i];
    w[i] = (float)(excl + part);
  }
  __syncthreads();
  //    de-trend by the mean of the previous 48 slots (prefix mean while
  //    fewer than 48 exist)
  for (int i = tid; i < T; i += BLOCK_THREADS) {
    const int lo = max(i - 47, 0);
    const float win = w[i] - (i >= 48 ? w[i - 48] : 0.0f);
    x[i] = x[i] / fmaxf(win / (float)(i - lo + 1), EPS);
  }
  __syncthreads();

  // 2. normalize by the population std (two passes in float64)
  double acc = 0.0;
  for (int i = tid; i < T; i += BLOCK_THREADS) acc += x[i];
  const double mu = block_sum(acc, red) / T;
  acc = 0.0;
  for (int i = tid; i < T; i += BLOCK_THREADS) {
    const double d = x[i] - mu;
    acc += d * d;
  }
  const float sd = fmaxf((float)sqrt(block_sum(acc, red) / T), EPS);
  for (int i = tid; i < T; i += BLOCK_THREADS) x[i] = x[i] / sd;
  __syncthreads();

  // 3. median templates: slots [0,48) period 48, [48,72) period 24,
  //    [72,88) period 16. Per period the row is copied slot-major into
  //    the second buffer, so that a slot's repetitions lie side by side
  //    (the row's stride p would put a warp's reads in two banks), then a
  //    warp takes a slot.
  for (int q = 0; q < 3; ++q) {
    const int p = q == 0 ? 48 : (q == 1 ? 24 : 16);
    const int off = q == 0 ? 0 : (q == 1 ? 48 : 72);
    const int reps = T / p;
    for (int i = tid; i < T; i += BLOCK_THREADS)
      w[(i % p) * reps + i / p] = x[i];
    __syncthreads();
    for (int j = warp; j < p; j += BLOCK_WARPS) {
      const float m = slot_median(w + j * reps, reps, lane);
      if (lane == 0) tmpl[off + j] = m;
    }
    __syncthreads();
  }

  // 4. per period, the deviations and the mean of the k smallest
  float dev[3];
  for (int q = 0; q < 3; ++q) {
    const int p = q == 0 ? 48 : (q == 1 ? 24 : 16);
    const int off = q == 0 ? 0 : (q == 1 ? 48 : 72);
    for (int i = tid; i < T; i += BLOCK_THREADS)
      u[i] = __float_as_uint(fabsf(x[i] - tmpl[off + i % p]));
    __syncthreads();
    unsigned prefix = 0;
    int below = 0;  // patterns < prefix
    for (int b = 30; b >= 0; --b) {
      const unsigned mid = prefix | (1u << b);
      unsigned c = 0;
      for (int i = tid; i < T; i += BLOCK_THREADS) c += u[i] < mid;
      c = block_count(c, cnt);
      if ((int)c < k) {
        prefix = mid;
        below = (int)c;
      }
    }
    // prefix is now the k-th smallest pattern v_k
    double sm = 0.0;
    for (int i = tid; i < T; i += BLOCK_THREADS)
      if (u[i] < prefix) sm += __uint_as_float(u[i]);
    sm = block_sum(sm, red);
    dev[q] = (float)(sm + (double)(k - below) * __uint_as_float(prefix)) /
             (float)k;
    __syncthreads();  // every thread is done with this period's u
  }
  if (tid == 0) {
    out[(size_t)blockIdx.x * 2] = dev[0] / fmaxf(dev[2], EPS);
    out[(size_t)blockIdx.x * 2 + 1] = dev[0] / fmaxf(dev[1], EPS);
  }
}

// series (B, T) float32 at a 16-byte boundary, T % 48 == 0, T > 1,024 and
// 8 T bytes within the block's shared memory; 1 <= k <= T. out (B, 2).
extern "C" int criticality_scores_long(const float* series, float* out,
                                       int B, int T, int k, void* stream) {
  const size_t smem = (size_t)8 * T;
  cudaError_t err = cudaFuncSetAttribute(
      criticality_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  criticality_block_kernel<<<B, BLOCK_THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(series, out,
                                                                  T, k);
  return (int)cudaGetLastError();
}

// series (B, T) float32 at a 16-byte boundary, T % 48 == 0; NP the next
// power of two >= T, 64 to 1024; 1 <= k <= T. out (B, 2) float32.
extern "C" int criticality_scores(const float* series, float* out, int B,
                                  int T, int NP, int k, void* stream) {
  const dim3 grid((B + WARPS - 1) / WARPS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (NP) {
    case 64: criticality_kernel<2><<<grid, WARPS * 32, 0, s>>>(series, out, B, T, k); break;
    case 128: criticality_kernel<4><<<grid, WARPS * 32, 0, s>>>(series, out, B, T, k); break;
    case 256: criticality_kernel<8><<<grid, WARPS * 32, 0, s>>>(series, out, B, T, k); break;
    case 512: criticality_kernel<16><<<grid, WARPS * 32, 0, s>>>(series, out, B, T, k); break;
    case 1024: criticality_kernel<32><<<grid, WARPS * 32, 0, s>>>(series, out, B, T, k); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
