"""One rank of the port's hybrid (DCN × ICI) mesh over ``torch.distributed``
(gloo), for ``tests/test_torch_hybrid_mesh.py``; imports no JAX.

``python -m torch_hybrid_worker --out DIR --mode force|nodes`` (from
``tests/``, under the torchrun contract) joins the process group and
builds :func:`~tpudist_torch.runtime.mesh.make_hybrid_mesh` for each
configuration of :data:`CONFIGS`: with ``force_granules=2`` on one node
(``force``), or over the nodes the launch contract and ``TPUDIST_NODE_NAME``
state (``nodes``).  It writes ``DIR/rank<r>.json``: each configuration's
coordinates of this rank, the ranks of its ``seq`` ring and its ``stage``
chain, or the ``ValueError`` text it raised; and this rank's node name."""

import argparse
import json
import os

#: name -> (data, stage, seq)
CONFIGS = {"data 4": (4, 1, 1), "data 2 x seq 2": (2, 1, 2),
           "data 2 x stage 2": (2, 2, 1), "data 1 x seq 4": (1, 1, 4)}


def main() -> None:
    from tpudist_torch.runtime import initialize, process_index, shutdown
    from tpudist_torch.runtime.mesh import (MeshConfig, make_hybrid_mesh,
                                            node_name)

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--mode", choices=("force", "nodes"), required=True)
    args = ap.parse_args()
    initialize(device="cpu")
    force = 2 if args.mode == "force" else None
    res = {"node": node_name()}
    for name, (data, stage, seq) in CONFIGS.items():
        try:
            mesh = make_hybrid_mesh(MeshConfig(data=data, stage=stage,
                                               seq=seq),
                                    force_granules=force, device="cpu")
        except ValueError as e:
            res[name] = {"error": str(e)}
            continue
        res[name] = {
            "coords": mesh.coords,
            "ring": (list(mesh.ring.ranks) if mesh.ring is not None
                     else None),
            "stages": (list(mesh.stages.ranks) if mesh.stages is not None
                       else None)}
    if args.mode == "nodes":
        try:
            make_hybrid_mesh(MeshConfig(data=4), force_granules=2,
                             device="cpu")
        except ValueError as e:
            res["force across nodes"] = str(e)
    with open(os.path.join(args.out, f"rank{process_index()}.json"),
              "w") as f:
        json.dump(res, f)
    shutdown()


if __name__ == "__main__":
    main()
