"""One rank of the port's pipelined LM over ``torch.distributed`` (gloo),
for ``tests/test_torch_pipeline_lm.py``; imports no JAX.

``python -m torch_pipeline_worker --inp IN.npz --out DIR --cases A,B``
(from ``tests/``, under the torchrun contract) joins the process group and
runs each case: a TransformerLM holding the weights of ``IN.npz`` trains
:data:`STEPS` steps on the global batches of ``IN.npz`` through
``make_pp_lm_train_step`` on the ``(data, stage)`` mesh of the case, each
data row on its rows.  Every rank writes ``DIR/<case>_r<rank>.npz``: the
losses and its replicated parameters (the embeddings, final norm and
head); rank 0 adds the whole weights after the last step (every rank
gathers them).

A case is ``<schedule>|<stages>|<microbatches>|<chunks>|<grad_clip>``;
``ckpt`` as the schedule runs ``1f1b`` and then saves a checkpoint of the
last step under ``DIR/ckpt``."""

import argparse
import os

import numpy as np
import torch

STEPS = 3
LR = 1e-3
#: the geometry of IN.npz's weights: JAX's TestLMInterleaved.CFG8 LM
GEOM = dict(vocab=32, d_model=32, n_layers=8, n_heads=4, d_ff=64,
            max_len=16)
#: the replicated parameters, held bit-equal across the stage ranks
REPLICATED = ("tok_embed", "pos_embed", "ln_f", "head")


def build(inp, clip: float = 0.0, device="cpu"):
    from tpudist_torch.models import TransformerLM
    from tpudist_torch.train import build_optimizer

    model = TransformerLM(param_dtype=torch.float32, **GEOM)
    model.load_state_dict({k[2:]: torch.from_numpy(inp[k])
                           for k in inp.files if k.startswith("w/")})
    model = model.to(device).requires_grad_(True)
    opt, _ = build_optimizer(model.parameters(), LR, grad_clip=clip)
    return model, opt


def case_name(case: str) -> str:
    return case.replace("|", "_").replace(".", "p")


def run_case(case: str, inp, out_dir: str) -> None:
    import torch.distributed as dist

    from tpudist_torch.checkpoint import CheckpointConfig, CheckpointManager
    from tpudist_torch.parallel import make_pp_lm_train_step
    from tpudist_torch.runtime.mesh import MeshConfig, make_mesh
    from tpudist_torch.train.step import ModelState

    schedule, stages, micro, chunks, clip = case.split("|")
    ckpt = schedule == "ckpt"
    schedule = "1f1b" if ckpt else schedule
    model, opt = build(inp, float(clip))
    mesh = make_mesh(MeshConfig(data=-1, stage=int(stages)), device="cpu")
    step = make_pp_lm_train_step(
        mesh, model, opt, n_stages=int(stages), num_microbatches=int(micro),
        schedule=schedule, n_chunks=int(chunks))
    batches = inp["batches"]
    rows, row = mesh.shape["data"], mesh.coords["data"]
    share = batches.shape[1] // rows
    losses = []
    for i in range(STEPS):
        t = batches[i, row * share:(row + 1) * share]
        losses.append(float(step(torch.from_numpy(t.astype(np.int64)))))
    rep = {f"rep/{k}": getattr(model, k).detach().numpy()
           for k in REPLICATED}
    whole = {f"w/{k}": v.detach().numpy()
             for k, v in step.runtime.model_view.state_dict().items()}
    if ckpt:
        mgr = CheckpointManager(CheckpointConfig(
            os.path.join(out_dir, "ckpt"), save_every=1, async_save=False),
            seed=0)
        mgr.save(STEPS, {"lm": ModelState(step.runtime.model_view, None,
                                          step.optimizer)},
                 {"iteration": STEPS, "epoch": 0})
        mgr.close()
    rank = dist.get_rank()
    np.savez(os.path.join(out_dir, f"{case_name(case)}_r{rank}.npz"),
             losses=np.array(losses), **rep, **(whole if rank == 0 else {}))


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
