// Tilings of the bf16 flash-attention kernel (src/repro_torch/csrc/
// flash_attention.cu) side by side, for tools/flash_variants.py: the
// same kernel template at other head-dim paddings, consumer warpgroups,
// key tiles, ring depths and blocks per SM than the library's table
// picks. Not part of the port's library.
#include "flash_attention.cu"

// (dp, wgs, bk, st, minb): the library's own tilings first (D 80 and
// D 128), then one change each: a shallower ring, 64- or 128-key tiles,
// one or three consumer warpgroups, D 80 padded to 96 or 128 columns
// instead of split into 64 + 16.
#define VARIANTS(X)      \
  X(80, 2, 128, 4, 1)    \
  X(128, 2, 64, 5, 1)    \
  X(80, 2, 128, 2, 1)    \
  X(80, 2, 128, 3, 1)    \
  X(80, 2, 64, 4, 1)     \
  X(80, 1, 128, 2, 2)    \
  X(80, 3, 64, 4, 1)     \
  X(96, 2, 128, 3, 1)    \
  X(128, 2, 64, 4, 1)    \
  X(128, 2, 128, 2, 1)   \
  X(128, 1, 128, 2, 1)

// the list above as (dp, wgs, bk, st, minb) rows; returns their count
extern "C" int flash_variant_list(int* rows, int max_rows) {
  int n = 0;
#define ROW(DP, WGS, BK, ST, MINB)                                        \
  if (n < max_rows) {                                                     \
    int* r = rows + 5 * n;                                                \
    r[0] = DP, r[1] = WGS, r[2] = BK, r[3] = ST, r[4] = MINB;             \
  }                                                                       \
  ++n;
  VARIANTS(ROW)
#undef ROW
  return n;
}

// `flash_attention`'s bf16 path through tiling (dp, wgs, bk, st, minb)
extern "C" int flash_variant(const void* q, const void* k, const void* v,
                             void* o, int bh, int hq, int rep, int lq, int lk,
                             int d, int q_offset, int valid_lk, int causal,
                             int window, float scale, int dp, int wgs, int bk,
                             int st, int minb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > dp) return (int)cudaErrorInvalidValue;
#define CALL(DP, WGS, BK, ST, MINB)                                         \
  if (dp == DP && wgs == WGS && bk == BK && st == ST && minb == MINB)       \
    return launch_bf16<DP, WGS, BK, ST, MINB>(q, k, v, o, bh, hq, rep, lq,  \
                                              lk, d, q_offset, valid_lk,    \
                                              causal, window, scale, s);
  VARIANTS(CALL)
#undef CALL
  return (int)cudaErrorInvalidValue;
}
