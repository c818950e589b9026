// Fleet-scale criticality template scoring (paper §III-B), one VM per block.
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
//      repetitions. A thread owns one slot and selects the middle order
//      statistics by rank counting over the repetitions (O(reps^2)
//      compares in registers, no scratch); an even count averages the two
//      middle values as `jnp.median` does;
//   4. |x - tiled template| per period, padded with +inf to the next power
//      of two NP >= T, and a bitonic sort of the three deviation rows in
//      shared memory. The mean of the k = round(0.8 T) smallest is then
//      exact, the function the sort-based oracle computes. The TPU kernel
//      approximated this selection by a 24-step bisection because it has
//      no cheap sort.
// Masked lanes (i >= T) never enter the cumsum, the mean, the std or the
// counts; they exist only as +inf padding of the sort. No batch padding is
// needed: the grid has one block per row.
//
// What bounds it on the H100: the kernel reads 4 T bytes and writes 8 bytes
// per row (63 MB at 65,536 x 240), under 20 us at 3.35 TB/s, and does a few
// hundred operations per element. This simple design takes 1.49 ms there
// (an H100 SXM at 700 W, from chip_smoke.py), ~80x the byte bound: it is
// bound by the latency of its ~70 block-wide barriers (most of them in the
// bitonic network) and of the serial median selection. It keeps every
// row's intermediates in shared memory (16 KB per block) so that nothing
// but the series and the two ratios touches device memory.
#include <cuda_runtime.h>
#include <math.h>

#define THREADS 256
#define MAX_T 1024
#define ITEMS (MAX_T / THREADS)
#define N_WARPS (THREADS / 32)
#define N_SLOTS (48 + 24 + 16)
#define EPS 1e-6f

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide sums of three values; every thread gets the results.
__device__ void block_sum3(float v[3], float (*scratch)[N_WARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float w = warp_sum(v[p]);
    if (lane == 0) scratch[p][warp] = w;
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < N_WARPS; ++w) s += scratch[p][w];
    v[p] = s;
  }
  __syncthreads();
}

__global__ void criticality_kernel(const float* __restrict__ series,
                                   float* __restrict__ out, int T, int NP,
                                   int k) {
  __shared__ float xs[MAX_T];
  __shared__ float dev[3][MAX_T];
  __shared__ float tmpl[N_SLOTS];
  __shared__ float scratch[3][N_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = series + (size_t)blockIdx.x * T;

  for (int i = tid; i < T; i += THREADS) xs[i] = row[i];
  __syncthreads();

  // 1. inclusive cumsum into dev[0]: a serial scan of ITEMS consecutive
  //    values per thread, then a block scan of the thread totals.
  float* cs = dev[0];
  float part[ITEMS];
  float run = 0.0f;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = tid * ITEMS + j;
    run += (i < T) ? xs[i] : 0.0f;
    part[j] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  if (lane == 31) scratch[0][warp] = incl;
  __syncthreads();
  float offset = incl - run;
  for (int w = 0; w < warp; ++w) offset += scratch[0][w];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = tid * ITEMS + j;
    if (i < T) cs[i] = part[j] + offset;
  }
  __syncthreads();

  // de-trend: divide by the mean of the previous 48 slots (prefix mean
  // while fewer than 48 exist)
  for (int i = tid; i < T; i += THREADS) {
    const int lo = max(i - 47, 0);
    const float win = cs[i] - (lo > 0 ? cs[lo - 1] : 0.0f);
    const float base = win / (float)(i - lo + 1);
    xs[i] = xs[i] / fmaxf(base, EPS);
  }
  __syncthreads();

  // 2. normalize by the population std of the whole row
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int i = tid; i < T; i += THREADS) acc[0] += xs[i];
  block_sum3(acc, scratch);
  const float mu = acc[0] / (float)T;
  acc[0] = acc[1] = acc[2] = 0.0f;
  for (int i = tid; i < T; i += THREADS) {
    const float d = xs[i] - mu;
    acc[0] += d * d;
  }
  block_sum3(acc, scratch);
  const float sd = fmaxf(sqrtf(acc[0] / (float)T), EPS);
  for (int i = tid; i < T; i += THREADS) xs[i] = xs[i] / sd;
  __syncthreads();

  // 3. median templates: slots [0,48) period 48, [48,72) period 24,
  //    [72,88) period 16
  if (tid < N_SLOTS) {
    const int period = tid < 48 ? 48 : (tid < 72 ? 24 : 16);
    const int slot = tid < 48 ? tid : (tid < 72 ? tid - 48 : tid - 72);
    const int reps = T / period;
    const int hi_rank = reps / 2;
    const int lo_rank = (reps % 2) ? hi_rank : hi_rank - 1;
    float lo_val = 0.0f, hi_val = 0.0f;
    for (int a = 0; a < reps; ++a) {
      const float va = xs[a * period + slot];
      int less = 0, eq = 0;
      for (int b = 0; b < reps; ++b) {
        const float vb = xs[b * period + slot];
        less += vb < va;
        eq += vb == va;
      }
      if (less <= hi_rank && hi_rank < less + eq) hi_val = va;
      if (less <= lo_rank && lo_rank < less + eq) lo_val = va;
    }
    tmpl[tid] = (reps % 2) ? hi_val : (lo_val + hi_val) * 0.5f;
  }
  __syncthreads();

  // 4. deviations, +inf padded to NP, then one bitonic network sorting
  //    all three rows ascending
  for (int i = tid; i < NP; i += THREADS) {
    if (i < T) {
      dev[0][i] = fabsf(xs[i] - tmpl[i % 48]);
      dev[1][i] = fabsf(xs[i] - tmpl[48 + i % 24]);
      dev[2][i] = fabsf(xs[i] - tmpl[72 + i % 16]);
    } else {
      dev[0][i] = dev[1][i] = dev[2][i] = INFINITY;
    }
  }
  __syncthreads();
  for (int size = 2; size <= NP; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < (NP >> 1); i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const float a = dev[p][lo], b = dev[p][hi];
          if ((a > b) == ascending) {
            dev[p][lo] = b;
            dev[p][hi] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // mean of the k smallest deviations per period
  acc[0] = acc[1] = acc[2] = 0.0f;
  for (int i = tid; i < k; i += THREADS) {
    acc[0] += dev[0][i];
    acc[1] += dev[1][i];
    acc[2] += dev[2][i];
  }
  block_sum3(acc, scratch);
  if (tid == 0) {
    const float dev24 = acc[0] / (float)k;
    const float dev12 = acc[1] / (float)k;
    const float dev8 = acc[2] / (float)k;
    out[(size_t)blockIdx.x * 2] = dev24 / fmaxf(dev8, EPS);
    out[(size_t)blockIdx.x * 2 + 1] = dev24 / fmaxf(dev12, EPS);
  }
}

// series (B, T) float32, T % 48 == 0, T <= MAX_T; NP the next power of two
// >= T; k = round(0.8 T). out (B, 2) float32.
extern "C" int criticality_scores(const float* series, float* out, int B,
                                  int T, int NP, int k, void* stream) {
  criticality_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      series, out, T, NP, k);
  return static_cast<int>(cudaGetLastError());
}
