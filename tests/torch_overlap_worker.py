"""One rank of the port's collective matmuls, overlapped FSDP MLP and MoE
layer over ``torch.distributed`` (gloo), for ``tests/
test_torch_overlap.py``; imports no JAX.

``python -m torch_overlap_worker --inp IN.npz --out DIR --cases A,B`` (from
``tests/``, under the torchrun contract) joins the process group and runs
each case; every rank writes ``DIR/<case>_r<rank>.npz``.

- ``prims``: ``ag_matmul`` (each gather, both modes) and ``matmul_rs``
  (and its ``pad_rows`` form) over a :class:`ProcessGroupRing` of the whole
  group, on this rank's pieces of IN.npz's global operands; then the TP
  chain (the ``lhs`` gather into the first matmul, the reduce-scatter out
  of the second) with the gradients of ``Σ out²`` on this rank's pieces.
- ``fsdp|<mode>``: the d64 LM of IN.npz's weights (the JAX init's) with the
  overlapped FSDP MLP in every block, :data:`STEPS` Adam steps under
  ``fsdp_sharding`` on IN.npz's global batches: the losses, the first
  step's averaged ``wi``/``wo`` gradients and the runtime's counts of that
  step, and the whole weights after the last step; ``ddp|<mode>`` the same
  with the weights replicated under DDP (each block cuts its pieces).
- ``moe``: the MoE layer with ``batch_axis='data'`` (top-2, capacity factor
  1: some assignments drop) on this rank's rows of IN.npz's tokens: its
  rows of the output, the stats, and the gradients of ``Σ y·g + balance``
  averaged over the ranks."""

import argparse
import os

import numpy as np
import torch

from torch_fsdp_worker import STEPS, build

MODES = ("ring", "bidir")
#: the MoE case's experts (a model axis of 4 folded onto the CPU)
MOE_EXPERTS, MOE_K, MOE_CAPACITY = 4, 2, 1.0


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def run_prims(inp, ring, rank: int, n: int) -> dict:
    from tpudist_torch.parallel import ag_matmul, matmul_rs

    out = {}
    for mode in MODES:
        x, w = inp["lhs_x"], inp["lhs_w"]
        out[f"lhs_{mode}"] = ag_matmul(_t(np.split(x, n)[rank]), _t(w),
                                       axis=ring, mode=mode, gather="lhs")
        x, w = inp["rhs_x"], inp["rhs_w"]
        out[f"rhs_{mode}"] = ag_matmul(_t(x), _t(np.split(w, n, 1)[rank]),
                                       axis=ring, mode=mode, gather="rhs")
        x, w = inp["con_x"], inp["con_w"]
        out[f"con_{mode}"] = ag_matmul(_t(x), _t(np.split(w, n)[rank]),
                                       axis=ring, mode=mode,
                                       gather="contract")
        x, w = inp["rs_x"], inp["rs_w"]
        out[f"rs_{mode}"] = matmul_rs(_t(np.split(x, n, 1)[rank]),
                                      _t(np.split(w, n)[rank]), axis=ring,
                                      mode=mode)
        x, w = inp["pad_x"], inp["pad_w"]
        out[f"pad_{mode}"] = matmul_rs(_t(np.split(x, n, 1)[rank]),
                                       _t(np.split(w, n)[rank]), axis=ring,
                                       mode=mode, pad_rows=True)
        xs = _t(np.split(inp["tp_x"], n)[rank]).requires_grad_(True)
        w1 = _t(np.split(inp["tp_w1"], n, 1)[rank]).requires_grad_(True)
        w2 = _t(np.split(inp["tp_w2"], n)[rank]).requires_grad_(True)
        h = ag_matmul(xs, w1, axis=ring, mode=mode, gather="lhs")
        y = matmul_rs(h, w2, axis=ring, mode=mode)
        (y * y).sum().backward()
        for name, t in (("x", xs), ("w1", w1), ("w2", w2)):
            out[f"tp_{mode}_g{name}"] = t.grad
    return {k: v.detach().numpy() for k, v in out.items()}


def run_lm(inp, layout: str, mode: str) -> dict:
    import torch.distributed as dist

    from tpudist_torch.parallel import fsdp_sharding, overlap_fsdp_mlp
    from tpudist_torch.runtime.mesh import make_mesh
    from tpudist_torch.train import make_lm_train_step

    model, opt = build(inp, "d64", "adam", 0.0)
    mesh = make_mesh(device="cpu")
    model.mlp_fn = overlap_fsdp_mlp(mesh, overlap=mode)
    step = make_lm_train_step(model, opt, state_sharding=(
        fsdp_sharding(mesh, model, opt) if layout == "fsdp" else None))
    rt = step.runtime
    world, rank = dist.get_world_size(), dist.get_rank()
    batches = inp["d64_batches"]
    share = batches.shape[1] // world
    out, losses = {}, []
    for i in range(STEPS):
        rows = batches[i, rank * share:(rank + 1) * share]
        losses.append(float(step(_t(rows.astype(np.int64)))))
        if i == 0 and rt is not None:
            out.update({f"count/{k}": v for k, v in rt.counts.items()})
            for name in rt._order:
                if name.endswith((".wi", ".wo")):
                    grads = [t.grad for t in rt.pieces[name]]
                    out[f"g/{name}"] = rt._whole(
                        name, grads, rt._shapes[name]).numpy()
    out["losses"] = np.array(losses)
    view = model if rt is None else rt.model_view
    out.update({f"w/{k}": v.detach().numpy() for k, v in
                view.state_dict().items()})
    return out


def run_moe(inp) -> dict:
    import torch.distributed as dist

    from tpudist_torch.models.transformer import moe_expert_fn
    from tpudist_torch.parallel import make_moe
    from tpudist_torch.runtime.mesh import MeshConfig, make_mesh

    world, rank = dist.get_world_size(), dist.get_rank()
    mesh = make_mesh(MeshConfig(data=-1, model=MOE_EXPERTS), device="cpu")
    moe = make_moe(mesh, moe_expert_fn, batch_axis="data", k=MOE_K,
                   capacity_factor=MOE_CAPACITY)
    params = {"router": _t(inp["moe_router"]).requires_grad_(True),
              "experts": {"w": _t(inp["moe_w"]).requires_grad_(True),
                          "wo": _t(inp["moe_wo"]).requires_grad_(True)}}
    x = _t(np.split(inp["moe_x"], world)[rank])
    g = _t(np.split(inp["moe_g"], world)[rank])
    y, stats = moe(params, x)
    ((y * g).sum() + stats.balance_loss).backward()
    out = {"y": y.detach().numpy()}
    out.update({f"stat/{k}": v.detach().numpy()
                for k, v in stats._asdict().items()})
    for name, t in (("router", params["router"]),
                    ("w", params["experts"]["w"]),
                    ("wo", params["experts"]["wo"])):
        grad = t.grad.clone()
        dist.all_reduce(grad)
        out[f"g/{name}"] = (grad / world).numpy()
    return out


def main() -> None:
    import torch.distributed as dist

    from tpudist_torch.parallel.overlap import axis_ring
    from tpudist_torch.runtime import initialize, shutdown
    from tpudist_torch.runtime.mesh import make_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--inp", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    initialize(device="cpu")
    inp = np.load(args.inp)
    rank, n = dist.get_rank(), dist.get_world_size()
    for case in args.cases.split(","):
        if case == "prims":
            out = run_prims(inp, axis_ring(make_mesh(device="cpu"), "data"),
                            rank, n)
        elif case.startswith(("fsdp|", "ddp|")):
            out = run_lm(inp, *case.split("|"))
        elif case == "moe":
            out = run_moe(inp)
        else:
            raise ValueError(case)
        np.savez(os.path.join(args.out, f"{case.replace('|', '_')}_r{rank}"
                              ".npz"), **out)
    shutdown()


if __name__ == "__main__":
    main()
