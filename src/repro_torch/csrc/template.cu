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
// of BLOCK_THREADS takes a row and holds it in one float32 buffer of T
// slots (plus one per column when T / 48 is even) in shared memory, and
// computes what the warp path computes, in the same arithmetic.
//
// What bounds it on the H100: like the warp path it reads 4 T bytes a row
// and writes 8, so instructions and barriers, not bytes, set its pace. The
// first design (one period after another: 93 block-wide radix passes of
// two barriers each, 88 slot medians of 32 warp-reduced passes, the row
// copied slot-major once a period and a second buffer of T floats for the
// deviations) took 1.891 / 3.026 ms of kernel time at 8,000 x 1,440 /
// 4,320 slots, 137x / 73x its byte bound, and its second buffer capped T
// at 28,896. This design takes 0.52 / 0.97 ms there (NVIDIA H100 80GB
// HBM3, 700.00 W, tools/template_variants.py), 50 / 44 % of it in the
// medians' walk steps, 19 / 23 % in the selection. Per row:
// - Layout: slot i = 48 r + c lives at c rp + r, R = T / 48 and rp = R | 1
//   (48 columns, slot-major; an odd column stride keeps the 32 lanes of a
//   row-order pass on 32 banks). A period-48 slot of the median templates
//   is then one contiguous run of R repetitions, a period-24 slot two runs
//   (columns s, s + 24), a period-16 slot three (s, s + 16, s + 32).
// - Cumsum in the buffer: warp w scans a run of about T / 8 slots read
//   from device memory, 4 a lane (a float4) and 128 a step by shuffles,
//   in float64 after a block scan of the warps' totals, each slot rounded
//   to float32 as above. The de-trend then re-reads x (L2-resident) and
//   overwrites the cumsum in place, in tiles of TILE slots from the end of
//   the row backward: a tile reads cs[i] and cs[i - 48] (the slot above in
//   its column) before one barrier and writes after it, and no tile below
//   it writes a slot it reads. The mean is summed on the way (float64),
//   then the std (float64 block sums); the normalized row is stored as
//   the bits of its order-preserving keys, each column's least and largest
//   key kept.
// - Medians: a warp a slot (11 each, balanced by runs), the lower middle
//   selected exactly from the highest bit where the slot's least and
//   largest keys differ (all keys share the bits above it). Up to
//   WALK_REPS repetitions a column the keys sit in registers and a radix
//   walk sets one bit a step (one compare a key, one warp reduction),
//   stopping as soon as one key is left between the prefix and its next
//   step; past that, rounds of 5-bit digits, each a pass that counts the
//   keys under the prefix into the warp's own 32-bin histogram and a warp
//   scan that finds the digit holding the rank, stopping when that bin
//   holds one key. (Over the walk's range, digit selects of 5 or 8 bits
//   made the kernel 12-26 % slower: a round's scan is a longer chain of
//   dependent steps than the walk's bits it saves; PERF.md.) One more
//   pass takes the key and, for an even count, the upper middle (the same
//   key when more repeat it, else the least key above), averaged as
//   `jnp.median` does. Then the keys go back to floats.
// - Selection: the k-th smallest deviation of the three periods in the same
//   rounds, 8-bit digits of bits 30..0 of the non-negative float patterns
//   (30-23, 22-15, 14-7, 6-0), each round one pass that recomputes the
//   three deviations |x - template| of every slot from the row (a
//   thread's slots lie in three columns, whose templates it keeps in
//   registers: no modulo a slot), three 256-bin block histograms, a warp
//   a period to find its digit, two barriers. A period whose bin holds
//   one pattern stops; the rounds stop when all three have. One last pass
//   sums the patterns under each period's bin in float64 (a block sum in
//   warp order) and takes the largest pattern up to the bin's end, which
//   is v_k; the mean of the k smallest is (sum + (k - below) v_k) / k as
//   before. The counts are integers, so shared-memory atomics add them
//   exactly in any order; every float sum keeps a fixed order.
// Hot bins: deviations of a row share a few exponents, so the first
// digit's bins take most patterns, and a tied row puts every pattern of a
// round in one bin. Each lane adds its own count: the card's shared-memory
// atomics took lanes on one address faster than grouping them by
// __match_any_sync costs (0.52 / 0.97 ms against 0.59 / 1.15, and 0.67
// against 0.93 ms on 8,000 x 4,320 constant rows; PERF.md).
// Per-warp copies of the three histograms would spread warps, not the
// lanes of one warp, and take 24 KB of the buffer's room.
#define BLOCK_THREADS 256
#define BLOCK_WARPS (BLOCK_THREADS / 32)
#define BINS 256
// Columns of at most WALK_REPS repetitions (T <= 6,144) take the medians'
// register walk, longer ones their digit select, of MED_BITS-bit digits
// (a 32-bin histogram a warp, one bin a lane)
#define WALK_REPS 128
#define MED_BITS 5
// de-trend tile: TILE_PER slots a thread held in registers across the barrier
#define TILE_PER 8
#define TILE (TILE_PER * BLOCK_THREADS)

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

// position of slot i in the slot-major buffer of column stride rp
__device__ __forceinline__ int slot_pos(int i, int rp) {
  return (int)((unsigned)i % 48u) * rp + (int)((unsigned)i / 48u);
}

// The bin of the selection's 256-bin histogram h in which the counts
// reach `rank` (1-based, at most their total), with the counts before it
// and in it; the same at every lane. Zeroes h for its next round. Whole
// warp.
__device__ __forceinline__ unsigned find_bin(unsigned* h, unsigned rank,
                                             unsigned& before,
                                             unsigned& in) {
  const int lane = threadIdx.x & 31;
  uint4* h4 = reinterpret_cast<uint4*>(h);
  const uint4 a = h4[2 * lane], b = h4[2 * lane + 1];
  const unsigned c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  unsigned tot = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) tot += c[j];
  unsigned incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned n = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += n;
  }
  const int at = __ffs(__ballot_sync(FULL, incl >= rank)) - 1;
  unsigned bin = 0, bf = 0, cnt = 0, run = incl - tot;
  bool found = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (!found && run + c[j] >= rank) {
      found = true;
      bin = 8 * lane + j;
      bf = run;
      cnt = c[j];
    }
    run += c[j];
  }
  h4[2 * lane] = make_uint4(0u, 0u, 0u, 0u);
  h4[2 * lane + 1] = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();
  before = __shfl_sync(FULL, bf, at);
  in = __shfl_sync(FULL, cnt, at);
  return __shfl_sync(FULL, bin, at);
}

// The median of one slot's n = runs R repetitions, given as the bits of
// their order keys: `runs` columns of R keys `stride` apart from `col`,
// whose least and largest are mn and mx; by the calling warp with its
// zeroed 32-bin histogram h (left zeroed). Digits of MED_BITS bits from
// the highest bit where mn and mx differ; a round counts the keys under
// the prefix into h, one bin a lane, and a warp scan finds the bin where
// the counts reach the lower middle's rank; the select stops when that
// bin holds one key or its last bit is set.
__device__ float slot_median(const float* col, int stride, int runs, int R,
                             unsigned mn, unsigned mx, unsigned* h,
                             int lane) {
  const int n = runs * R;
  const unsigned lo_r = (n - 1) / 2;  // 0-based rank of the lower middle
  unsigned lo_key = mn, hi_key = mn;  // a constant slot
  if (mn != mx) {
    int hi = 31 - __clz(mn ^ mx), lo;   // keys share the bits above hi
    unsigned prefix = hi == 31 ? 0u : mn & (~0u << (hi + 1));
    unsigned below = 0, in = 0;
    for (;;) {
      lo = max(hi - (MED_BITS - 1), 0);
      // a key is under the prefix when key - prefix <= span
      const unsigned span = hi == 31 ? ~0u : (2u << hi) - 1;
      for (int g = 0; g < runs; ++g)
        for (int r0 = 0; r0 < R; r0 += 32) {
          const int r = r0 + lane;
          const unsigned u =
              (r < R ? __float_as_uint(col[g * stride + r]) : 0u) - prefix;
          if (r < R && u <= span) atomicAdd(h + (u >> lo), 1u);
        }
      __syncwarp();
      const unsigned cnt = h[lane];
      h[lane] = 0u;
      unsigned incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += v;
      }
      const int d = __ffs(__ballot_sync(FULL, incl >= lo_r + 1 - below)) - 1;
      below += __shfl_sync(FULL, incl - cnt, d);
      in = __shfl_sync(FULL, cnt, d);
      __syncwarp();  // h zeroed before the next round's counts
      prefix |= (unsigned)d << lo;
      if (in == 1 || lo == 0) break;
      hi = lo - 1;
    }
    // the bin [prefix, last] holds the lower middle: the one key there
    // when `in` is 1, else (lo == 0) `in` copies of one key
    const unsigned last = prefix | ((1u << lo) - 1);
    unsigned m = 0u, nx = 0xffffffffu;
    for (int g = 0; g < runs; ++g)
      for (int r = lane; r < R; r += 32) {
        const unsigned u = __float_as_uint(col[g * stride + r]);
        if (u <= last) m = max(m, u);
        else nx = min(nx, u);
      }
    lo_key = __reduce_max_sync(FULL, m);
    nx = __reduce_min_sync(FULL, nx);
    hi_key = below + in > lo_r + 1 ? lo_key : nx;
  }
  const float a = key_value(lo_key);
  return (n & 1) ? a : (a + key_value(hi_key)) * 0.5f;
}

// The median of one slot as slot_median, for R <= 32 J, with the slot's
// keys held in registers (lane l holds rows l + 32 j of each of the RUNS
// columns; ~0 past R, which no compare counts): a radix walk from the
// highest bit where mn and mx differ sets the lower middle's bits, a bit
// set while at most its rank of keys lie under the prefix with it set
// (one compare a key, one warp reduction a bit), and stops as soon as one
// key is left between the prefix and its next step, as the warp path's
// selection does.
template <int RUNS, int J>
__device__ float slot_median_walk(const float* col, int stride, int R,
                                  unsigned mn, unsigned mx, int lane) {
  const int n = RUNS * R;
  const unsigned lo_r = (n - 1) / 2;
  unsigned key[RUNS][J];
#pragma unroll
  for (int g = 0; g < RUNS; ++g)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int r = lane + 32 * j;
      key[g][j] = r < R ? __float_as_uint(col[g * stride + r]) : ~0u;
    }
  unsigned lo_key = mn, hi_key = mn;  // a constant slot
  if (mn != mx) {
    int b = 31 - __clz(mn ^ mx);        // keys share the bits above b
    unsigned prefix = b == 31 ? 0u : mn & (~0u << (b + 1));
    unsigned below = 0, upto = n;  // keys under prefix, prefix + 2^(b+1)
    for (;; --b) {
      const unsigned mid = prefix | (1u << b);
      unsigned c = 0;
#pragma unroll
      for (int g = 0; g < RUNS; ++g)
#pragma unroll
        for (int j = 0; j < J; ++j) c += key[g][j] < mid;
      c = __reduce_add_sync(FULL, c);
      if (c <= lo_r) {
        prefix = mid;
        below = c;
      } else {
        upto = c;
      }
      if (upto - below == 1 || b == 0) break;
    }
    // [prefix, last] holds the lower middle: the one key there, or (b 0)
    // upto - below copies of one key
    const unsigned last = prefix | ((1u << b) - 1);
    unsigned m = 0u, nx = ~0u;
#pragma unroll
    for (int g = 0; g < RUNS; ++g)
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (lane + 32 * j < R) {
          if (key[g][j] <= last) m = max(m, key[g][j]);
          else nx = min(nx, key[g][j]);
        }
    lo_key = __reduce_max_sync(FULL, m);
    nx = __reduce_min_sync(FULL, nx);
    hi_key = upto > lo_r + 1 ? lo_key : nx;
  }
  const float a = key_value(lo_key);
  return (n & 1) ? a : (a + key_value(hi_key)) * 0.5f;
}

template <int RUNS>
__device__ __forceinline__ float slot_median_regs(const float* col,
                                                  int stride, int R,
                                                  unsigned mn, unsigned mx,
                                                  int lane) {
  switch ((R + 31) >> 5) {
    case 1: return slot_median_walk<RUNS, 1>(col, stride, R, mn, mx, lane);
    case 2: return slot_median_walk<RUNS, 2>(col, stride, R, mn, mx, lane);
    case 3: return slot_median_walk<RUNS, 3>(col, stride, R, mn, mx, lane);
    default: return slot_median_walk<RUNS, 4>(col, stride, R, mn, mx, lane);
  }
}

// A thread's slots i = tid + 256 u + 768 m (u < 3, m >= 0) lie in three
// columns, since 256 = 5 x 48 + 16: column (tid + 16 u) % 48, at rows
// (tid + 256 u) / 48 + 16 m. `pos` holds their first positions in the
// buffer, t48 / t24 their columns' templates; the 16 h template is one
// for all three (16 u is 0 mod 16).
struct Slots {
  int pos[3];
  float t48[3], t24[3], t16;
};

// One round of the selection, digit bits [LO, HI] of the patterns: each
// period not yet done counts its patterns under its prefix into its block
// histogram, then warp q finds period q's digit. Returns true once all
// three periods are done.
template <int LO, int HI>
__device__ __forceinline__ bool select_round(
    const float* buf, const Slots& s, int T, int k, unsigned (*hist)[BINS],
    unsigned (*sel)[4], unsigned (&pfx)[3], unsigned (&below)[3],
    unsigned (&in)[3], unsigned (&last)[3]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a pattern is under the prefix when pattern - prefix <= SPAN
  constexpr unsigned SPAN = (2u << HI) - 1;
  for (int m = 0; m * 768 < T; ++m) {
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const bool ok = tid + 256 * u + 768 * m < T;
      float x = 0.0f;
      if (ok) x = buf[s.pos[u] + 16 * m];
      const float t[3] = {s.t48[u], s.t24[u], s.t16};
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (in[q] == 1) continue;  // the same at every thread
        const unsigned d =
            (__float_as_uint(x - t[q]) & 0x7fffffffu) - pfx[q];
        if (ok && d <= SPAN) atomicAdd(hist[q] + (d >> LO), 1u);
      }
    }
  }
  __syncthreads();
  if (warp < 3 && sel[warp][2] != 1) {
    unsigned bf, n;
    const unsigned dg = find_bin(hist[warp], k - sel[warp][1], bf, n);
    if (lane == 0) {
      sel[warp][0] |= dg << LO;
      sel[warp][1] += bf;
      sel[warp][2] = n;
      sel[warp][3] = sel[warp][0] | ((1u << LO) - 1);
    }
  }
  __syncthreads();
  bool all = true;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    pfx[q] = sel[q][0];
    below[q] = sel[q][1];
    in[q] = sel[q][2];
    last[q] = sel[q][3];
    all = all && in[q] == 1;
  }
  return all;
}

// Trace points of a row (TRACE builds, for tools/template_variants.py):
// SM clocks at the start and after each phase.
enum { TR_START, TR_CUMSUM, TR_DETREND, TR_NORM, TR_MEDIANS, TR_SELECT,
       TR_END, TR_N };

template <bool TRACE>
__global__ void __launch_bounds__(BLOCK_THREADS)
criticality_block_kernel(const float* __restrict__ series,
                         float* __restrict__ out, int T, int k,
                         long long* trace) {
  extern __shared__ __align__(16) float buf[];  // 48 columns of rp slots
  // the selection's three 256-bin histograms, or the medians' eight of 32
  __shared__ __align__(16) unsigned hist[3][BINS];
  __shared__ float tmpl[N_SLOTS];
  __shared__ double red[3][BLOCK_WARPS];
  __shared__ unsigned redu[3][BLOCK_WARPS];
  __shared__ unsigned sel[3][4];   // a period's prefix, below, in, last
  __shared__ unsigned cmin[48], cmax[48];  // each column's extreme keys
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = T / 48, rp = R | 1;
  const float* src = series + (size_t)blockIdx.x * T;
  long long* tr = TRACE ? trace + (size_t)blockIdx.x * TR_N : nullptr;
  if (TRACE && tid == 0) tr[TR_START] = clock64();
  for (int i = tid; i < 3 * BINS; i += BLOCK_THREADS) (&hist[0][0])[i] = 0u;
  if (tid < 12) (&sel[0][0])[tid] = 0u;
  if (tid < 48) {
    cmin[tid] = ~0u;
    cmax[tid] = 0u;
  }
  Slots s;
#pragma unroll
  for (int u = 0; u < 3; ++u)
    s.pos[u] = slot_pos(tid + 256 * u, rp);

  // 1. inclusive cumsum in float64, rounded to float32 slot by slot, into
  //    the buffer: warp w's run of L slots (T / 8 rounded up to a
  //    multiple of 4), 128 at a time, 4 a lane as one float4
  const int L = (T / BLOCK_WARPS + 3) & ~3;
  const int w0 = min(warp * L, T), w1 = min(w0 + L, T);
  double acc = 0.0;
  for (int i = w0 + 4 * lane; i < w1; i += 128) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src + i));
    acc += ((double)v.x + v.y) + ((double)v.z + v.w);
  }
  acc = warp_sum(acc);
  if (lane == 0) red[0][warp] = acc;
  __syncthreads();
  double carry = 0.0;
  for (int v = 0; v < warp; ++v) carry += red[0][v];
  for (int base = w0; base < w1; base += 128) {
    const int i = base + 4 * lane;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < w1) v = __ldg(reinterpret_cast<const float4*>(src + i));
    const double p0 = v.x, p1 = p0 + v.y, p2 = p1 + v.z, p3 = p2 + v.w;
    double incl = p3;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double n = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += n;
    }
    double excl = __shfl_up_sync(FULL, incl, 1);
    excl = carry + (lane == 0 ? 0.0 : excl);
    if (i < w1) {  // slots i..i+3: one row, four neighbouring columns
      const int q = slot_pos(i, rp);
      buf[q] = (float)(excl + p0);
      buf[q + rp] = (float)(excl + p1);
      buf[q + 2 * rp] = (float)(excl + p2);
      buf[q + 3 * rp] = (float)(excl + p3);
    }
    carry += __shfl_sync(FULL, incl, 31);
  }
  __syncthreads();
  if (TRACE && tid == 0) tr[TR_CUMSUM] = clock64();
  //    de-trend by the mean of the previous 48 slots (prefix mean while
  //    fewer than 48 exist), tiles from the end backward, in place
  acc = 0.0;
  for (int t0 = (T - 1) / TILE * TILE; t0 >= 0; t0 -= TILE) {
    float xd[TILE_PER];
#pragma unroll
    for (int e = 0; e < TILE_PER; ++e) {
      const int i = t0 + e * BLOCK_THREADS + tid;
      xd[e] = 0.0f;
      if (i < T) {
        const int q = slot_pos(i, rp);
        const float win = buf[q] - (i >= 48 ? buf[q - 1] : 0.0f);
        xd[e] = __ldg(src + i) / fmaxf(win / (float)(min(i, 47) + 1), EPS);
        acc += xd[e];
      }
    }
    __syncthreads();  // the tile's cumsum is read
#pragma unroll
    for (int e = 0; e < TILE_PER; ++e) {
      const int i = t0 + e * BLOCK_THREADS + tid;
      if (i < T) buf[slot_pos(i, rp)] = xd[e];
    }
  }
  if (TRACE && tid == 0) tr[TR_DETREND] = clock64();

  // 2. normalize by the population std (two passes in float64)
  const double mu = block_sum(acc, red[1]) / T;
  acc = 0.0;
  for (int m = 0; m * 768 < T; ++m)
#pragma unroll
    for (int u = 0; u < 3; ++u)
      if (tid + 256 * u + 768 * m < T) {
        const double d = buf[s.pos[u] + 16 * m] - mu;
        acc += d * d;
      }
  const float sd = fmaxf((float)sqrt(block_sum(acc, red[2]) / T), EPS);
  //    the normalized row as order keys for the medians, with each
  //    column's least and largest key
  unsigned kmin[3] = {~0u, ~0u, ~0u}, kmax[3] = {0u, 0u, 0u};
  for (int m = 0; m * 768 < T; ++m)
#pragma unroll
    for (int u = 0; u < 3; ++u)
      if (tid + 256 * u + 768 * m < T) {
        const int q = s.pos[u] + 16 * m;
        const unsigned key = order_key(buf[q] / sd);
        buf[q] = __uint_as_float(key);
        kmin[u] = min(kmin[u], key);
        kmax[u] = max(kmax[u], key);
      }
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const int c = (tid + 16 * u) % 48;
    atomicMin(&cmin[c], kmin[u]);
    atomicMax(&cmax[c], kmax[u]);
  }
  __syncthreads();
  if (TRACE && tid == 0) tr[TR_NORM] = clock64();

  // 3. median templates, a warp a slot: j < 48 period 48 (column j),
  //    j < 72 period 24 (columns s, s + 24), else period 16 (s, s + 16,
  //    s + 32)
  for (int j = warp; j < N_SLOTS; j += BLOCK_WARPS) {
    const int p = j < 48 ? 48 : (j < 72 ? 24 : 16);
    const int c = j < 48 ? j : (j < 72 ? j - 48 : j - 72);
    unsigned mn = cmin[c], mx = cmax[c];
    for (int g = c + p; g < 48; g += p) {
      mn = min(mn, cmin[g]);
      mx = max(mx, cmax[g]);
    }
    const float* col = buf + c * rp;
    const float m =
        R > WALK_REPS ? slot_median(col, p * rp, 48 / p, R, mn, mx,
                                    hist[0] + 32 * warp, lane)
        : p == 48     ? slot_median_regs<1>(col, p * rp, R, mn, mx, lane)
        : p == 24     ? slot_median_regs<2>(col, p * rp, R, mn, mx, lane)
                      : slot_median_regs<3>(col, p * rp, R, mn, mx, lane);
    if (lane == 0) tmpl[j] = m;
  }
  __syncthreads();
  if (TRACE && tid == 0) tr[TR_MEDIANS] = clock64();
  //    the keys back to the normalized row, and each thread's templates
  for (int m = 0; m * 768 < T; ++m)
#pragma unroll
    for (int u = 0; u < 3; ++u)
      if (tid + 256 * u + 768 * m < T) {
        const int q = s.pos[u] + 16 * m;
        buf[q] = key_value(__float_as_uint(buf[q]));
      }
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    const int c = (tid + 16 * u) % 48;
    s.t48[u] = tmpl[c];
    s.t24[u] = tmpl[48 + c % 24];
  }
  s.t16 = tmpl[72 + tid % 16];
  __syncthreads();

  // 4. the k-th smallest deviation of the three periods, 8-bit digits of
  //    the patterns' bits 30..0, in the same rounds
  unsigned pfx[3] = {0u, 0u, 0u}, below[3] = {0u, 0u, 0u};
  unsigned in[3] = {0u, 0u, 0u}, last[3];
  select_round<23, 30>(buf, s, T, k, hist, sel, pfx, below, in, last) ||
      select_round<15, 22>(buf, s, T, k, hist, sel, pfx, below, in, last) ||
      select_round<7, 14>(buf, s, T, k, hist, sel, pfx, below, in, last) ||
      select_round<0, 6>(buf, s, T, k, hist, sel, pfx, below, in, last);
  if (TRACE && tid == 0) tr[TR_SELECT] = clock64();
  //    the patterns under each period's bin summed in float64; the
  //    largest up to its end is v_k
  double sm[3] = {0.0, 0.0, 0.0};
  unsigned vk[3] = {0u, 0u, 0u};
  for (int m = 0; m * 768 < T; ++m)
#pragma unroll
    for (int u = 0; u < 3; ++u)
      if (tid + 256 * u + 768 * m < T) {
        const float x = buf[s.pos[u] + 16 * m];
        const float t[3] = {s.t48[u], s.t24[u], s.t16};
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const unsigned d = __float_as_uint(x - t[q]) & 0x7fffffffu;
          if (d < pfx[q]) sm[q] += __uint_as_float(d);
          if (d <= last[q]) vk[q] = max(vk[q], d);
        }
      }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    sm[q] = warp_sum(sm[q]);
    vk[q] = __reduce_max_sync(FULL, vk[q]);
    if (lane == 0) {
      red[q][warp] = sm[q];
      redu[q][warp] = vk[q];
    }
  }
  __syncthreads();
  if (tid == 0) {
    float dev[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      double sum = 0.0;
      unsigned v = 0u;
#pragma unroll
      for (int w = 0; w < BLOCK_WARPS; ++w) {
        sum += red[q][w];
        v = max(v, redu[q][w]);
      }
      dev[q] = (float)(sum + (double)(k - below[q]) * __uint_as_float(v)) /
               (float)k;
    }
    out[(size_t)blockIdx.x * 2] = dev[0] / fmaxf(dev[2], EPS);
    out[(size_t)blockIdx.x * 2 + 1] = dev[0] / fmaxf(dev[1], EPS);
    if (TRACE) tr[TR_END] = clock64();
  }
}

// Shared memory the block kernel takes for a row of T slots beside its
// static arrays: 48 columns of (T / 48) | 1 floats.
static size_t block_smem(int T) { return (size_t)4 * 48 * ((T / 48) | 1); }

template <bool TRACE = false>
int launch_block(const float* series, float* out, int B, int T, int k,
                 void* stream, long long* trace = nullptr) {
  const size_t smem = block_smem(T);
  cudaError_t err = cudaFuncSetAttribute(
      criticality_block_kernel<TRACE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  criticality_block_kernel<TRACE><<<B, BLOCK_THREADS, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      series, out, T, k, trace);
  return (int)cudaGetLastError();
}

// series (B, T) float32, T % 48 == 0, T > 1,024 and the buffer within the
// block's shared memory beside the static arrays; 1 <= k <= T. out (B, 2).
extern "C" int criticality_scores_long(const float* series, float* out,
                                       int B, int T, int k, void* stream) {
  return launch_block(series, out, B, T, k, stream);
}

// The block kernel's static shared memory in bytes (the wrapper's
// BLOCK_STATIC_SMEM must cover it), or minus a cudaError_t.
extern "C" int criticality_block_static_smem() {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, criticality_block_kernel<false>);
  return err != cudaSuccess ? -(int)err : (int)a.sharedSizeBytes;
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
