"""Shared numpy inputs for the port's kernel tests (tests/test_torch_*.py):
ragged paged-attention, paged-prefill and sampling cases, made from a seed;
and the CPU set-up every port test module runs first.  Imports numpy only
(torch comes in as an argument), so the GPU tests can use it where JAX is
absent."""

import contextlib

import numpy as np


@contextlib.contextmanager
def settled_torch_cpu(torch, threads: int = 2):
    """Run a test module's torch CPU work on at most ``threads`` intra-op
    threads, with torch's transcendental CPU kernels warmed up first.

    The first ``torch.exp`` of a fresh process sometimes returns values
    about 1e-4 relative off: in fresh processes under the six-worker load
    of the suite, 5 of 150 first calls on the flash case's ``[2, 2, 64,
    128]`` scores read an error of 1.05e-4 against float64 where the
    others read 3.1e-8, the same wrong values each time (exp alone: the
    products and sums around it stay exact).  The plain flash forward's
    first call then misses the JAX kernel by up to 3.2e-5 in about ten of
    32768 elements, past ``atol 2e-5``.  After one warm-up call, 0 of 150
    fresh processes read wrong (``tests/torch_exp_first_call.py`` counts
    both arms).  Tiny CPU tensors gain nothing from more threads, and the
    suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, threads))
    for size in (1 << 10, 1 << 17):  # serial and parallel sizes
        x = torch.linspace(-4.0, 4.0, size)
        for fn in (torch.exp, torch.sin, torch.cos, torch.tanh):
            fn(x)
        torch.log(x.abs() + 1.0)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _pool(r, L, nb, n_kv, bs, dh, quant):
    if quant:
        pk = r.integers(-127, 128, size=(L, nb, n_kv, bs, dh)).astype(np.int8)
        pv = r.integers(-127, 128, size=(L, nb, n_kv, bs, dh)).astype(np.int8)
        sk = r.uniform(0.01, 0.2, size=(L, nb, n_kv)).astype(np.float32)
        sv = r.uniform(0.01, 0.2, size=(L, nb, n_kv)).astype(np.float32)
    else:
        pk = r.normal(size=(L, nb, n_kv, bs, dh)).astype(np.float32)
        pv = r.normal(size=(L, nb, n_kv, bs, dh)).astype(np.float32)
        sk = sv = np.ones((L, nb, n_kv), np.float32)
    return pk, pv, sk, sv


def decode_case(S, nh, n_kv, s, dh, L, nb, bs, M, quant, seed, fill_max=0):
    """Ragged decode inputs: cursors anywhere in [0, M*bs - s] (a
    zero-live lane and partial last blocks included), sentinel table tails,
    optional mid-window fills."""
    r = np.random.default_rng(seed)
    q = r.normal(size=(S, nh, s, dh)).astype(np.float32)
    pk, pv, sk, sv = _pool(r, L, nb, n_kv, bs, dh, quant)
    pos0 = r.integers(0, M * bs - s + 1, size=S).astype(np.int32)
    pos0[0] = 0
    table = np.full((S, M), nb, np.int32)
    for b in range(S):
        live = -(-int(pos0[b]) // bs)
        table[b, :live] = r.choice(nb, size=live, replace=False)
    fill = (r.integers(0, fill_max + 1, size=S).astype(np.int32)
            if fill_max else np.zeros(S, np.int32))
    W = s + fill_max
    wk = r.normal(size=(S, n_kv, W, dh)).astype(np.float32)
    wv = r.normal(size=(S, n_kv, W, dh)).astype(np.float32)
    return [q, pk, pv, sk, sv, table, pos0, fill, wk, wv]


def wtable(table, pos0, clen, bs, M, Mw, nb):
    """The engine's write-table rule: ids of the blocks covering
    ``[pos0, pos0 + clen)``, sentinel past the span and on dead lanes."""
    t0 = pos0 // bs
    n_t = np.where(clen > 0, (pos0 + clen - 1) // bs - t0 + 1, 0)
    logical = t0[:, None] + np.arange(Mw)[None]
    ids = np.take_along_axis(table, np.minimum(logical, M - 1), axis=1)
    live = (np.arange(Mw)[None] < n_t[:, None]) & (logical < M)
    return np.where(live, ids, nb).astype(np.int32)


def prefill_case(S, nh, n_kv, dh, L, nb, bs, M, P, quant, seed, pos0=None,
                 clen=None):
    """Ragged prefill inputs: a fresh lane, a dead (clen 0) lane, a
    non-block-aligned cursor (partial first block), sentinel tails; or the
    lanes' ``pos0`` and ``clen`` as given (``nb >= S * M``)."""
    r = np.random.default_rng(seed)
    q = r.normal(size=(S, nh, P, dh)).astype(np.float32)
    kn = r.normal(size=(S, n_kv, P, dh)).astype(np.float32)
    vn = r.normal(size=(S, n_kv, P, dh)).astype(np.float32)
    pk, pv, sk, sv = _pool(r, L, nb, n_kv, bs, dh, quant)
    if pos0 is not None:
        pos0 = np.asarray(pos0, np.int32)
        clen = np.asarray(clen, np.int32)
    else:
        pos0 = r.integers(0, (M - (P - 1) // bs - 1) * bs, size=S).astype(
            np.int32)
        pos0[0] = 0
        if S > 2:
            pos0[2] = bs + 1
        clen = r.integers(1, P + 1, size=S).astype(np.int32)
        if S > 1:
            clen[1] = 0
    table = np.full((S, M), nb, np.int32)
    perm = r.permutation(nb)
    Mw = min(M, (P - 1) // bs + 2)
    for b in range(S):
        span = min(M, -(-int(pos0[b] + (P if clen[b] else 0)) // bs) or 1)
        table[b, :span] = perm[b * M:b * M + span]
    wt = wtable(table, pos0, clen, bs, M, Mw, nb)
    return [q, kn, vn, pk, pv, sk, sv, table, wt, pos0, clen]


def sample_case(seed=0, S=3, V=33):
    """Logits, temperatures and grammar operands for the sampling prep."""
    r = np.random.default_rng(seed)
    logits = r.normal(size=(S, V)).astype(np.float32)
    temps = np.asarray([0.0, 0.7, 1.3], np.float32)
    gallow = r.random((3, 4, V)) > 0.3
    gallow[2] = True
    gidx = np.asarray([0, 2, 1], np.int32)
    gstate = np.asarray([1, 0, 3], np.int32)
    return [logits, temps, gallow, gidx, gstate]


def flash_case(h, h_kv, s, d, b=2, seed=0, s_k=None):
    """q [b, h, s, d], k/v [b, h_kv, s_k, d] and an output cotangent, f32."""
    r = np.random.default_rng(seed)
    s_k = s if s_k is None else s_k
    q = r.normal(size=(b, h, s, d)).astype(np.float32)
    k = r.normal(size=(b, h_kv, s_k, d)).astype(np.float32)
    v = r.normal(size=(b, h_kv, s_k, d)).astype(np.float32)
    do = r.normal(size=(b, h, s, d)).astype(np.float32)
    return q, k, v, do


def filter_case(seed=0, S=6, V=256):
    """Logits for the top-k / top-p filters: distinct values, a row of ties
    at the k-th value, a flat row and a grammar-masked row."""
    r = np.random.default_rng(seed)
    logits = (r.normal(size=(S, V)) * 2).astype(np.float32)
    logits[1, :12] = 3.0  # ties straddling the top-k threshold
    logits[2] = 0.5  # flat row: every value ties
    temps = np.asarray([1.0, 0.7, 1.3, 0.0, 2.0, 0.5][:S], np.float32)
    gallow = r.random((2, 3, V)) > 0.5
    gallow[1] = True
    gidx = np.asarray([1, 0, 1, 0, 1, 0][:S], np.int32)
    gstate = np.asarray([0, 1, 2, 0, 1, 2][:S], np.int32)
    return [logits, temps, gallow, gidx, gstate]


def top_p_boundary_gap(out, ref, topk_row):
    """How far from the top-p threshold the disagreements of two filtered
    rows lie: for every position kept by one side and dropped by the other,
    the softmax mass (f64) of the sorted top-k-filtered row before that
    value, minus ``top_p`` in the caller.  Returns the masses (empty when
    the kept sets agree)."""
    neg = np.finfo(np.float32).min
    masses = []
    for row in range(out.shape[0]):
        diff = np.flatnonzero((out[row] == neg) != (ref[row] == neg))
        if not len(diff):
            continue
        srt = np.sort(topk_row[row].astype(np.float64))[::-1]
        p = np.exp(srt - srt[0])
        cum_before = np.concatenate([[0.0], np.cumsum(p / p.sum())[:-1]])
        for pos in diff:
            first = int(np.flatnonzero(srt == float(topk_row[row, pos]))[0])
            masses.append(cum_before[first])
    return np.asarray(masses)
