// Oblivious-forest inference for a stack of equally shaped forests.
//
// Replaces the TPU kernel `forest_predict_pallas` / `_forest_kernel_tiled`
// (src/repro/kernels/forest/forest.py). There the feature gather and the
// leaf lookup were two one-hot matrix products so that they could reach
// the MXU. Here each thread walks its trees directly: it reads
// x[row, feat_idx[f, t, l]] by index, so no product can round a feature
// before the strict `>` compare (a TF32 or reordered sum could flip a leaf
// index against `ObliviousForest.leaf_index_np`).
//
// What bounds it on the H100: at serving shapes (B = 256 rows, F = 18,
// four forests of T = 48 trees at depth D = 6, K = 2) the kernel reads
// about 140 KB and does under a million operations, so neither bytes nor
// arithmetic bound it (0.00004 ms). Latency does: only 8 blocks run on
// the 132 SMs and each thread walks a serial chain of T x D dependent
// shared-memory and feature reads (0.08 ms on an H100 SXM at 700 W, from
// chip_smoke.py). At batch-scoring shapes (B = 65,536) the same chain per
// thread bounds it. Splitting a forest's trees across threads is the
// next step; this first version keeps one plain walk per thread.
//
// Design: grid (ceil(B / ROWS_PER_BLOCK), n_forests); one thread per
// (row, forest). The block stages its forest's feature indices,
// thresholds and leaf table in shared memory (T*D*8 + T*2^D*K*4 bytes,
// 27 KB at T = 48, D = 6, K = 2; the wrapper refuses shapes over the
// 48 KB static limit), then each thread loops over trees and levels,
// packs the bits MSB-first (bit l weighs 2^(D-1-l)) and sums the leaf
// values over trees in tree order, in float32. Normalization (RF mean,
// GB softmax) and the confidence gate stay outside, in torch.
#include <cuda_runtime.h>

#define ROWS_PER_BLOCK 128
#define MAX_K 8

__global__ void forest_sums_kernel(const float* __restrict__ x,
                                   const int* __restrict__ feat_idx,
                                   const float* __restrict__ thr,
                                   const float* __restrict__ leaf,
                                   float* __restrict__ out,
                                   int B, int F, int NF, int T, int D,
                                   int K) {
  extern __shared__ unsigned char smem[];
  const int f = blockIdx.y;
  const int td = T * D;
  const int n_leaves = 1 << D;
  const int tlk = T * n_leaves * K;
  int* s_fi = reinterpret_cast<int*>(smem);
  float* s_thr = reinterpret_cast<float*>(s_fi + td);
  float* s_leaf = s_thr + td;

  const int* g_fi = feat_idx + (size_t)f * td;
  const float* g_thr = thr + (size_t)f * td;
  const float* g_leaf = leaf + (size_t)f * tlk;
  for (int i = threadIdx.x; i < td; i += blockDim.x) {
    s_fi[i] = g_fi[i];
    s_thr[i] = g_thr[i];
  }
  for (int i = threadIdx.x; i < tlk; i += blockDim.x) s_leaf[i] = g_leaf[i];
  __syncthreads();

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const float* xr = x + (size_t)row * F;
  float acc[MAX_K];
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) acc[k] = 0.0f;

  for (int t = 0; t < T; ++t) {
    int idx = 0;
    for (int l = 0; l < D; ++l) {
      const int j = t * D + l;
      idx = (idx << 1) | (xr[s_fi[j]] > s_thr[j] ? 1 : 0);
    }
    const float* lv = s_leaf + (t * n_leaves + idx) * K;
#pragma unroll
    for (int k = 0; k < MAX_K; ++k)
      if (k < K) acc[k] += lv[k];
  }
  float* o = out + ((size_t)row * NF + f) * K;
#pragma unroll
  for (int k = 0; k < MAX_K; ++k)
    if (k < K) o[k] = acc[k];
}

extern "C" int forest_sums(const float* x, const int* feat_idx,
                           const float* thr, const float* leaf, float* out,
                           int B, int F, int NF, int T, int D, int K,
                           void* stream) {
  const size_t smem = (size_t)T * D * (sizeof(int) + sizeof(float)) +
                      (size_t)T * (1 << D) * K * sizeof(float);
  dim3 grid((B + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, NF);
  forest_sums_kernel<<<grid, ROWS_PER_BLOCK, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, feat_idx, thr, leaf, out, B, F, NF, T, D, K);
  return static_cast<int>(cudaGetLastError());
}

