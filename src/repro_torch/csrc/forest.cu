// Oblivious-forest inference for a stack of equally shaped forests.
//
// Replaces the TPU kernel `forest_predict_pallas` / `_forest_kernel_tiled`
// (src/repro/kernels/forest/forest.py). There the feature gather and the
// leaf lookup were two one-hot matrix products so that they could reach
// the MXU. Here each lane walks its trees directly: it reads
// x[row, feat_idx[f, t, l]] by index, so no product can round a feature
// before the strict `>` compare (a TF32 or reordered sum could flip a leaf
// index against `ObliviousForest.leaf_index_np`).
//
// What bounds it on the H100: at serving shapes (B = 256 rows, F = 18,
// four forests of T = 48 trees at depth D = 6, K = 2) the kernel reads
// about 140 KB and does under a million operations, so neither bytes nor
// arithmetic bound it (0.00004 ms); a launch's own floor of a few us
// does. The first design (one thread per (row, forest) walking all T x D
// levels in one dependent chain, 8 blocks on 132 SMs) took 0.067 ms there
// and 0.326 ms at B = 65,536 (NVIDIA H100 80GB HBM3, 700.00 W, from
// chip_smoke.py). This design takes about 0.004 ms of kernel time at
// B = 256 and 0.07-0.08 ms at B = 65,536, ~28x the 0.0026 ms operations
// bound there (same card and limit, chip_smoke.py's profiler times):
// instruction slots per (row, tree) set its pace, in the level reads, the leaf
// gather (one table per lane) and the lane-sum shuffles.
//
// Design:
// - Grid (ceil(B / rows), NF), WARPS warps a block. A row gets G = 8, 16
//   or 32 lanes (the launch plan takes the smallest G that still gives
//   the card two blocks per SM), so a warp takes 32 / G rows at a time;
//   lane j of a row's group walks trees j, j + G, ... of the tile, so its
//   dependent chains are D levels per tree, not T x D. At the serving
//   shape (B = 256) that is 256 blocks of 4 rows, G = 32; at B = 65,536,
//   G = 8 (6 trees a lane at T = 48, 4 rows a warp step, 3 shuffle steps)
//   and 4,096 blocks of 64 rows.
// - Each (tree, level) pair is staged as one 8-byte (index, threshold)
//   word in shared memory, level-major ([D][tile]): at a level a row's
//   lanes read neighbouring words, the same ones for every row of the
//   warp. The block's (rows x F) feature tile is staged with
//   coalesced loads; a feature row wider than the tile budget is read
//   from global memory instead (`SX` false).
// - Leaves are read through the read-only cache, K = 2 as one float2
//   and K % 4 == 0 as float4. Outputs go KC at a time (K = 10 takes a
//   chunk of 8 and one of 2), so any K runs.
// - Trees are tiled `tile` at a time (a multiple of 32, so that a lane
//   keeps the trees j mod G), as the Pallas kernel's `block_t` tiles
//   them: the node tile stays within 32 KB for any T and D, and there is
//   no limit on T, K or the leaf table's size (depth up to 31).
//
// Summation order (emulated in `ref.forest_sums_lanes`): per tile, lane j
// of a row's G adds the leaf values of its trees j, j + G, ... in tree
// order, from 0; the G lane sums are combined by an xor butterfly (lanes
// G / 2 apart, then G / 4, ..., 1; a + b == b + a, so every lane holds the
// same sum); tile sums are added to the output in tile order.
// Normalization (RF mean, GB softmax) and the confidence gate stay
// outside, in torch.
#include <cuda_runtime.h>

#define WARPS 4
#define FULL 0xffffffffu

template <int KC>
__device__ __forceinline__ void load_leaf(const float* __restrict__ lv,
                                          int n, float (&v)[KC]) {
  if constexpr (KC == 2) {
    if (n == 2) {
      const float2 w = __ldg(reinterpret_cast<const float2*>(lv));
      v[0] = w.x;
      v[1] = w.y;
      return;
    }
  } else if constexpr (KC == 4) {
    if (n == 4) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(lv));
      v[0] = w.x;
      v[1] = w.y;
      v[2] = w.z;
      v[3] = w.w;
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < KC; ++c) v[c] = c < n ? __ldg(lv + c) : 0.0f;
}

// One level's compare bit: x[row, index] > threshold, the feature read by
// index from the staged tile (or from global memory) and never rounded.
template <bool SX>
__device__ __forceinline__ unsigned bit(const float* xr, int2 w) {
  const float v = SX ? xr[w.x] : __ldg(xr + w.x);
  return v > __int_as_float(w.y) ? 1u : 0u;
}

// Adds the KC leaf values at `lv` (n of them real) to acc.
template <int KC>
__device__ __forceinline__ void add_leaf(float (&acc)[KC],
                                         const float* __restrict__ lv, int n) {
  float v[KC];
  load_leaf<KC>(lv, n, v);
#pragma unroll
  for (int c = 0; c < KC; ++c) acc[c] += v[c];
}

// x (B, F); feat_idx, thr (NF, T, D); leaf (NF, T, 2^D, K); out (B, NF, K).
template <int KC, bool SX>
__global__ void __launch_bounds__(WARPS * 32)
forest_sums_kernel(const float* __restrict__ x,
                   const int* __restrict__ feat_idx,
                   const float* __restrict__ thr,
                   const float* __restrict__ leaf, float* __restrict__ out,
                   int B, int F, int NF, int T, int D, int K, int rows,
                   int tile, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* s_node = reinterpret_cast<int2*>(smem);                // [D][tile]
  float* s_x = reinterpret_cast<float*>(s_node + (size_t)tile * D);
  const int f = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane & (G - 1), sub = lane / G, R = 32 / G;
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, B - row0);
  const size_t n_leaves = (size_t)1 << D;

  if (SX) {
    const float* src = x + (size_t)row0 * F;
    for (int i = threadIdx.x; i < nrows * F; i += blockDim.x) s_x[i] = src[i];
  }
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int n = min(KC, K - k0);
    for (int t0 = 0; t0 < T; t0 += tile) {
      const int nt = min(tile, T - t0);
      __syncthreads();                  // the previous tile is read out
      const size_t g0 = ((size_t)f * T + t0) * D;
      const float* leaf_tile = leaf + ((size_t)f * T + t0) * n_leaves * K;
      for (int i = threadIdx.x; i < nt * D; i += blockDim.x) {
        const int t = i / D, l = i - t * D;
        s_node[l * tile + t] = make_int2(__ldg(feat_idx + g0 + i),
                                         __float_as_int(__ldg(thr + g0 + i)));
      }
      __syncthreads();
      for (int r = warp * R + sub; r - sub < nrows; r += WARPS * R) {
        const bool live = r < nrows;   // every lane joins the shuffles
        const float* xr = SX ? s_x + r * F : x + (size_t)(row0 + r) * F;
        float acc[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[c] = 0.0f;
        for (int tt = g; live && tt < nt; tt += G) {
          unsigned idx = 0;
          for (int l = 0; l < D; ++l)
            idx = (idx << 1) | bit<SX>(xr, s_node[l * tile + tt]);
          add_leaf<KC>(acc, leaf_tile + ((size_t)tt * n_leaves + idx) * K + k0,
                       n);
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            if (off < G) acc[c] += __shfl_xor_sync(FULL, acc[c], off);
        }
        if (live && g < n) {
          float s = acc[0];
#pragma unroll
          for (int c = 1; c < KC; ++c)
            if (g == c) s = acc[c];
          float* o = out + ((size_t)(row0 + r) * NF + f) * K + k0 + g;
          *o = t0 == 0 ? s : *o + s;
        }
      }
    }
  }
}

template <int KC, bool SX>
static void launch(dim3 grid, size_t smem, cudaStream_t stream,
                   const float* x, const int* feat_idx, const float* thr,
                   const float* leaf, float* out, int B, int F, int NF,
                   int T, int D, int K, int rows, int tile, int G) {
  forest_sums_kernel<KC, SX><<<grid, WARPS * 32, smem, stream>>>(
      x, feat_idx, thr, leaf, out, B, F, NF, T, D, K, rows, tile, G);
}

// The launch plan (rows per block, tree tile, lanes per row, outputs per
// chunk KC in {1, 2, 4, 8}, whether the feature tile is staged) comes from
// the wrapper's `launch_plan`; it keeps the shared memory within 48 KB.
// B, NF, T >= 1; lanes 8, 16 or 32; rows a multiple of WARPS x 32 / lanes;
// tile a multiple of 32.
extern "C" int forest_sums(const float* x, const int* feat_idx,
                           const float* thr, const float* leaf, float* out,
                           int B, int F, int NF, int T, int D, int K,
                           int rows, int tile, int lanes, int kc,
                           int stage_x, void* stream) {
  const size_t smem = (size_t)tile * D * sizeof(int2) +
                      (stage_x ? (size_t)rows * F * sizeof(float) : 0);
  const dim3 grid((B + rows - 1) / rows, NF);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FOREST_LAUNCH(KC_, SX_)                                            \
  launch<KC_, SX_>(grid, smem, s, x, feat_idx, thr, leaf, out, B, F, NF, T, \
                   D, K, rows, tile, lanes)
  switch (kc * 2 + (stage_x ? 1 : 0)) {
    case 3: FOREST_LAUNCH(1, true); break;
    case 2: FOREST_LAUNCH(1, false); break;
    case 5: FOREST_LAUNCH(2, true); break;
    case 4: FOREST_LAUNCH(2, false); break;
    case 9: FOREST_LAUNCH(4, true); break;
    case 8: FOREST_LAUNCH(4, false); break;
    case 17: FOREST_LAUNCH(8, true); break;
    case 16: FOREST_LAUNCH(8, false); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FOREST_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
