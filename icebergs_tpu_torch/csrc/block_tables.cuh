// The block tables of the contact searches K2 (extract_sorted.cu) and K5
// (prepass_sorted.cu), which each CTA builds itself, as the TPU wrappers
// build them (icebergs_tpu/ops/pallas_prepass.py:116-131 for K5, :663-675
// for K2; the plain versions take ops/extract.py and ops/prepass.py
// block_tables).  A block of bn consecutive sorted rows spans the cells
// c0 = key[b*bn] .. c1c = min(key of its last row, ncells - 1), with a
// tail block padded by dead keys (ncells).  Its ns = 2r+1 strips are the
// grid rows j-r .. j+r of that span.  The two kernels differ only in the
// window test each applies to a strip's slot range, which stays with
// them.
#pragma once

#include <stdint.h>

// a block's cell span: c0 and c1c
struct BlockSpan {
  int c0, c1c;
};

__device__ __forceinline__ BlockSpan block_span(
    const int32_t* __restrict__ key_s, int b, int bn, int n, int ncells) {
  const int last = b * bn + bn - 1;
  return {key_s[b * bn], min(last < n ? key_s[last] : ncells, ncells - 1)};
}

// the span's bad rule: wider than nx - ns cells
__device__ __forceinline__ bool span_bad(BlockSpan sp, int nx, int ns) {
  return sp.c1c - sp.c0 > nx - ns;
}

// strip s of ns: its cells [clo, chi], clamped to [0, ncells-1] and
// [-1, ncells-1], and its slots [start, stop) = [cs[clo], cs[chi+1])
struct Strip {
  int clo, chi, start, stop;
};

__device__ __forceinline__ Strip block_strip(
    BlockSpan sp, int s, int ns, int nx, int ncells,
    const int32_t* __restrict__ cell_starts) {
  const int rad = ns / 2;
  const int off = (s - rad) * nx;
  Strip st;
  st.clo = min(max(sp.c0 - rad + off, 0), ncells - 1);
  st.chi = min(max(sp.c1c + rad + off, -1), ncells - 1);
  st.start = cell_starts[st.clo];
  st.stop = cell_starts[st.chi + 1];
  return st;
}
