"""One rank of the port's sharded training state over ``torch.distributed``
(gloo), for ``tests/test_torch_fsdp.py`` and ``tests/test_torch_tp.py``;
imports no JAX.

``python -m torch_fsdp_worker --inp IN.npz --out DIR --cases A,B`` (from
``tests/``, under the torchrun contract) joins the process group and runs
each case: a TransformerLM holding the weights of ``IN.npz`` (the JAX
init's, carried across by the test) trains :data:`STEPS` steps on the
global batches of ``IN.npz``, each rank on its rows, under the case's
layout.  Rank 0 writes ``DIR/<case>.npz``: the losses, the whole weights
after the last step (every rank gathers them) and the runtime's collective
counts of the first step.

A case is ``<layout>|<optimizer>|<grad_clip>``: ``fsdp`` (ZeRO-3 at
``min_size`` 1024), ``zero1``, ``merged`` (TP over a model axis of 2 on
this rank's devices, FSDP elsewhere), ``compressed`` (replicated state,
``grad_reduce_dtype`` bf16), ``ckpt`` (``fsdp`` then a checkpoint of the
last step under ``DIR/ckpt``)."""

import argparse
import os

import numpy as np
import torch

STEPS = 3
LR = 1e-3
#: the geometry of IN.npz's weights: JAX's TestFSDP model, and a d128 one
#: whose matrices Adafactor factors (both axes at least 128)
GEOMS = {
    "d64": dict(vocab=32, d_model=64, n_layers=2, n_heads=4, d_ff=128,
                max_len=32),
    "d128": dict(vocab=32, d_model=128, n_layers=2, n_heads=4, d_ff=256,
                 max_len=32),
}


def geom_of(optimizer: str) -> str:
    return "d128" if optimizer == "adafactor" else "d64"


def build(inp, geom: str, optimizer: str, clip: float, device="cpu"):
    from tpudist_torch.models import TransformerLM
    from tpudist_torch.train import build_optimizer

    model = TransformerLM(param_dtype=torch.float32, **GEOMS[geom])
    model.load_state_dict({k[len(geom) + 1:]: torch.from_numpy(inp[k])
                           for k in inp.files if k.startswith(geom + "/")})
    model = model.to(device).requires_grad_(True)
    opt, _ = build_optimizer(model.parameters(), LR, optimizer=optimizer,
                             grad_clip=clip)
    return model, opt


def run_case(case: str, inp, out_dir: str) -> None:
    import torch.distributed as dist

    from tpudist_torch.checkpoint import CheckpointConfig, CheckpointManager
    from tpudist_torch.models.transformer import transformer_tp_sharding
    from tpudist_torch.parallel import (fsdp_sharding, merge_shardings,
                                        zero1_sharding)
    from tpudist_torch.runtime.mesh import MeshConfig, make_mesh
    from tpudist_torch.train import make_lm_train_step
    from tpudist_torch.train.step import ModelState

    layout_kind, optimizer, clip = case.split("|")
    geom = geom_of(optimizer)
    model, opt = build(inp, geom, optimizer, float(clip))
    world, rank = dist.get_world_size(), dist.get_rank()
    kw = {}
    if layout_kind in ("fsdp", "ckpt"):
        kw["state_sharding"] = fsdp_sharding(
            make_mesh(device="cpu"), model, opt)
    elif layout_kind == "zero1":
        kw["state_sharding"] = zero1_sharding(
            make_mesh(device="cpu"), model, opt)
    elif layout_kind == "merged":
        mesh = make_mesh(MeshConfig(data=-1, model=2), device="cpu")
        kw["state_sharding"] = merge_shardings(
            transformer_tp_sharding(mesh, model, opt),
            fsdp_sharding(mesh, model, opt))
    elif layout_kind == "compressed":
        kw["grad_reduce_dtype"] = torch.bfloat16
    else:
        raise ValueError(case)
    step = make_lm_train_step(model, opt, **kw)
    batches = inp[f"{geom}_batches"]
    share = batches.shape[1] // world
    losses, counts = [], None
    for i in range(STEPS):
        rows = batches[i, rank * share:(rank + 1) * share]
        losses.append(float(step(torch.from_numpy(rows.astype(np.int64)))))
        if i == 0 and step.runtime is not None:
            counts = dict(step.runtime.counts)
    view = model if step.runtime is None else step.runtime.model_view
    whole = {k: v.detach().numpy() for k, v in view.state_dict().items()}
    if layout_kind == "ckpt":
        mgr = CheckpointManager(CheckpointConfig(
            os.path.join(out_dir, "ckpt"), save_every=1, async_save=False),
            seed=0)
        mgr.save(STEPS, {"lm": ModelState(view, step.replica,
                                          step.optimizer)},
                 {"iteration": STEPS, "epoch": 0})
        mgr.close()
    if rank == 0:
        extra = {f"count/{k}": v for k, v in (counts or {}).items()}
        np.savez(os.path.join(out_dir, case.replace("|", "_") + ".npz"),
                 losses=np.array(losses), **{f"w/{k}": v
                                             for k, v in whole.items()},
                 **extra)


def main() -> None:
    from tpudist_torch.runtime import initialize, shutdown

    ap = argparse.ArgumentParser()
    ap.add_argument("--inp", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    initialize(device="cpu")
    inp = np.load(args.inp)
    for case in args.cases.split(","):
        run_case(case, inp, args.out)
    shutdown()


if __name__ == "__main__":
    main()
