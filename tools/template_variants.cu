// The template kernel's block path with its trace points, for
// tools/template_variants.py: the library's kernel (src/repro_torch/csrc/
// template.cu), writing TR_N SM clocks a row to `trace` when it is given.
#include "template.cu"

extern "C" int criticality_long_variant(const float* series, float* out,
                                        int B, int T, int k,
                                        long long* trace, void* stream) {
  return trace ? launch_block<true>(series, out, B, T, k, stream, trace)
               : launch_block(series, out, B, T, k, stream);
}

extern "C" int criticality_trace_points() { return TR_N; }
