"""One rank of the port's ring attention over ``torch.distributed`` (gloo),
for ``tests/test_torch_ring.py``; imports no JAX.

``python -m torch_ring_worker --out DIR --seq N`` (from ``tests/``, under
the torchrun contract) joins the process group, builds the ``(data,
seq)`` mesh (a :class:`~tpudist_torch.parallel.ProcessGroupRing` a data
row), runs every case of :data:`CASES` on its shard of its data row's
inputs, forward and backward, and writes ``DIR/rank<r>.npz``.  The test
runs :func:`run_case` on a :class:`~tpudist_torch.parallel.LocalRing` over
the whole sequence and holds each rank's shard to it."""

import argparse
import os

import numpy as np
import torch

from tpudist_torch.parallel import (SeqLayout, make_ring_attention,
                                    make_zigzag_ring_attention)

B, H, SEQ, DH = 2, 4, 32, 16
#: name -> (attention over a ring, zigzag layout, kv heads)
CASES = {
    "xla causal": (lambda r: make_ring_attention(
        r, causal=True, kernel="xla"), False, H),
    "xla window 6, inner_block 4": (lambda r: make_ring_attention(
        r, causal=True, kernel="xla", window=6, inner_block=4), False, H),
    "flash causal, gqa": (lambda r: make_ring_attention(
        r, causal=True, kernel="flash"), False, 2),
    "flash window 20": (lambda r: make_ring_attention(
        r, causal=True, kernel="flash", window=20), False, H),
    "flash full": (lambda r: make_ring_attention(
        r, causal=False, kernel="flash"), False, H),
    "zigzag xla": (lambda r: make_zigzag_ring_attention(r, kernel="xla"),
                   True, H),
    "zigzag flash, gqa": (lambda r: make_zigzag_ring_attention(
        r, kernel="flash"), True, 2),
}


def inputs(data_row: int, kv: int):
    """The global ``q, k, v`` and output cotangent of one data row, in
    temporal order (f32 numpy from a seed)."""
    rng = np.random.default_rng(10 + data_row)
    q = rng.normal(size=(B, H, SEQ, DH)).astype(np.float32)
    k = rng.normal(size=(B, kv, SEQ, DH)).astype(np.float32)
    v = rng.normal(size=(B, kv, SEQ, DH)).astype(np.float32)
    g = rng.normal(size=(B, H, SEQ, DH)).astype(np.float32)
    return q, k, v, g


def run_case(name: str, ring, data_row: int = 0) -> dict:
    """``out, dq, dk, dv`` of case ``name`` over ``ring`` on this
    process's tokens of data row ``data_row`` (in the layout's order)."""
    attention, zigzag, kv = CASES[name]
    idx = SeqLayout(ring, SEQ, zigzag=zigzag).positions
    q, k, v, g = (torch.from_numpy(np.ascontiguousarray(a[:, :, idx]))
                  for a in inputs(data_row, kv))
    for t in (q, k, v):
        t.requires_grad_(True)
    out = attention(ring)(q, k, v)
    out.backward(g)
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def main() -> None:
    from tpudist_torch.runtime import initialize, process_index, shutdown
    from tpudist_torch.runtime.mesh import MeshConfig, make_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--seq", type=int, required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    initialize(device="cpu")
    mesh = make_mesh(MeshConfig(data=-1, seq=args.seq), device="cpu")
    res = {}
    for name in CASES:
        for what, arr in run_case(name, mesh.ring,
                                  mesh.coords["data"]).items():
            res[f"{name}|{what}"] = arr
    np.savez(os.path.join(args.out, f"rank{process_index()}.npz"),
             data=mesh.coords["data"], seq=mesh.coords["seq"], **res)
    shutdown()


if __name__ == "__main__":
    main()
