// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpudist/ops/paged_attention.py
// (paged_attention, body _kernel): decode / speculative-verify attention
// that walks each slot's block table in-kernel, dequantizes int8 blocks
// against their per-(layer, block, kv-head) scales, and treats the
// uncommitted window buffer as the walk's last virtual block under the
// per-query causal mask col <= fill + i.
//
// Bound on the H100: bytes.  A decode step does 4 flops per K/V byte at
// bf16 (R = group * s query rows per kv head), far below the ~295 flops/byte
// where the tensor cores become the limit, so the time is the live KV
// blocks read from HBM.  The design reads only the live blocks of each lane
// (never the table's sentinel tail, never a dense max_len view), reads each
// block once per kv head group, and keeps q, the running (m, l) and the
// accumulator in shared memory, so HBM traffic is live KV + q + window +
// output.  The walk is sequential within a CTA; overlapping block loads
// (cp.async / TMA) and splitting long walks over several CTAs are later work.
#include "paged_common.cuh"

extern "C" int tpd_paged_attention(
    const void* q, const void* pool_k, const void* pool_v,
    const void* scale_k, const void* scale_v, const void* table,
    const void* pos0, const void* fill, const void* wk, const void* wv,
    void* out, int S, int n_kv, int R, int s, int dh, int nb, int bs, int M,
    int W, int layer, int window, float scale, int q_dtype, int pool_dtype,
    void* stream) {
  tpd::AttnArgs a;
  a.q = q;
  a.pool_k = pool_k;
  a.pool_v = pool_v;
  a.scale_k = static_cast<const float*>(scale_k);
  a.scale_v = static_cast<const float*>(scale_v);
  a.table = static_cast<const int*>(table);
  a.pos0 = static_cast<const int*>(pos0);
  a.fill = static_cast<const int*>(fill);
  a.wk = wk;
  a.wv = wv;
  a.out = out;
  a.n_kv = n_kv;
  a.R = R;
  a.s = s;
  a.dh = dh;
  a.nb = nb;
  a.bs = bs;
  a.M = M;
  a.W = W;
  a.layer = layer;
  a.window = window;
  a.scale = scale;
  return (int)tpd::launch_attention(a, S, q_dtype, pool_dtype,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* tpd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
