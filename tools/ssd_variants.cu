// Tilings of the bf16 SSD kernel (src/repro_torch/csrc/ssd.cu) side by
// side, for tools/ssd_variants.py: the same kernel template at other
// head groups, consumer warpgroups and ring depths than the library's
// table picks (N <= 64). Not part of the port's library.
#include "ssd.cu"

// (g, wgs, st, minb): the library's own tiling first, then one change
// each: one head a tile, four (one consumer, or two consumers with one
// stage each), one consumer, two consumers with one stage each.
#define VARIANTS(X) \
  X(2, 2, 4, 1)     \
  X(1, 2, 4, 1)     \
  X(4, 1, 2, 1)     \
  X(4, 2, 2, 1)     \
  X(2, 1, 2, 1)     \
  X(2, 2, 2, 1)

// the list above as (g, wgs, st, minb) rows; returns their count
extern "C" int ssd_variant_list(int* rows, int max_rows) {
  int n = 0;
#define ROW(G, WGS, ST, MINB)              \
  if (n < max_rows) {                      \
    int* r = rows + 4 * n;                 \
    r[0] = G, r[1] = WGS, r[2] = ST, r[3] = MINB; \
  }                                        \
  ++n;
  VARIANTS(ROW)
#undef ROW
  return n;
}

// `ssd_scan`'s bf16 path (N <= 64) through tiling (g, wgs, st, minb)
extern "C" int ssd_variant(const void* x, const void* dt, const void* a,
                           const void* b, const void* c, const void* d,
                           void* y, int batch, int L, int H, int P, int N,
                           long long x_sb, long long x_sl, long long x_sh,
                           long long b_sb, long long b_sl, long long c_sb,
                           long long c_sl, void* scratch,
                           unsigned long long epoch, int g, int wgs, int st,
                           int minb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > 64) return (int)cudaErrorInvalidValue;
  const long long xs[3] = {x_sb, x_sl, x_sh}, bs[2] = {b_sb, b_sl},
                  cs[2] = {c_sb, c_sl};
#define CALL(G, WGS, ST, MINB)                                             \
  if (g == G && wgs == WGS && st == ST && minb == MINB)                    \
    return launch_bf16<G, 1, WGS, ST, MINB>(x, dt, a, b, c, d, y, batch, L, \
                                            H, P, N, xs, bs, cs, scratch,  \
                                            epoch, s);
  VARIANTS(CALL)
#undef CALL
  return (int)cudaErrorInvalidValue;
}

// the library's tiling, or the same at one head a tile (g 1), with its
// trace points recorded into `trace` (TR_N values per work tile and head)
extern "C" int ssd_variant_trace(const void* x, const void* dt,
                                 const void* a, const void* b, const void* c,
                                 const void* d, void* y, int batch, int L,
                                 int H, int P, int N, long long x_sb,
                                 long long x_sl, long long x_sh,
                                 long long b_sb, long long b_sl,
                                 long long c_sb, long long c_sl,
                                 void* scratch, unsigned long long epoch,
                                 int g, long long* trace, void* stream) {
  if (N > 64) return (int)cudaErrorInvalidValue;
  const long long xs[3] = {x_sb, x_sl, x_sh}, bs[2] = {b_sb, b_sl},
                  cs[2] = {c_sb, c_sl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g == 1)
    return launch_bf16<1, 1, 2, 4, 1, true>(x, dt, a, b, c, d, y, batch, L,
                                            H, P, N, xs, bs, cs, scratch,
                                            epoch, s, trace);
  return launch_bf16<2, 1, 2, 4, 1, true>(x, dt, a, b, c, d, y, batch, L, H,
                                          P, N, xs, bs, cs, scratch, epoch, s,
                                          trace);
}

// values the trace holds per (work tile, head)
extern "C" int ssd_trace_points() { return TR_N; }
