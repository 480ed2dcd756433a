"""Shared numpy inputs for the port's kernel tests (tests/test_torch_*.py):
ragged paged-attention, paged-prefill and sampling cases, made from a seed.
Imports numpy only, so the GPU tests can use it where JAX is absent."""

import numpy as np


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


def prefill_case(S, nh, n_kv, dh, L, nb, bs, M, P, quant, seed):
    """Ragged prefill inputs: a fresh lane, a dead (clen 0) lane, a
    non-block-aligned cursor (partial first block), sentinel tails."""
    r = np.random.default_rng(seed)
    q = r.normal(size=(S, nh, P, dh)).astype(np.float32)
    kn = r.normal(size=(S, n_kv, P, dh)).astype(np.float32)
    vn = r.normal(size=(S, n_kv, P, dh)).astype(np.float32)
    pk, pv, sk, sv = _pool(r, L, nb, n_kv, bs, dh, quant)
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
        span = -(-int(pos0[b] + (P if clen[b] else 0)) // bs) or 1
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
