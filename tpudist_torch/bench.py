"""The toy model's benchmarks — the port's counterparts of ``bench.py``'s
``bench_toy`` and ``bench_fused_mlp``.

``python -m tpudist_torch.bench [--device cuda]`` prints ONE JSON line:

- ``toy``: the ``demo.py`` hot loop — two ToyMLPs, Adam 1e-3, batch 256,
  the 512-sample dataset held on the device, index windows of 256
  iterations from ``default_rng(0)`` through the scanned step — as the best
  of 3 segments of at least 0.5 s, each ended by a value fetch:
  ``toy_mlp_samples_per_sec_per_chip``;
- ``fused_mlp``: the toy forward at batch 4096 through the fused kernel
  (``kernel_fused``) and through the plain eager chain on the same device
  (``plain_chain``, in place of the JAX bench's XLA arm), both first held
  against a float64 numpy forward, in samples/s, and their ratio.

Run on the card (``--device cuda``, the default) the numbers are the
card's; ``--device cpu`` runs the plain path on the host.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from tpudist_torch.models.toy_mlp import create_toy_model
from tpudist_torch.models.transformer import resolve_device


def _sync(x: torch.Tensor) -> float:
    """A value fetch of the last element: the device has run everything
    queued before it."""
    return float(x.reshape(-1)[-1])


#: iterations in one call of the scanned step (``TrainLoopConfig.sync_every``)
WINDOW = 256


def toy_setup(device):
    """The toy bench's inputs on ``device``: two ToyMLPs (seed 0) with Adam
    1e-3, the scanned step, the 512-sample dataset and one ``[WINDOW,
    256]`` index window from ``default_rng(0)``."""
    from tpudist_torch.data import make_toy_data
    from tpudist_torch.train import (init_model_states,
                                     make_scanned_train_step)
    from tpudist_torch.train.optim import build_optimizer

    gen = torch.Generator().manual_seed(0)
    models = {"model_X": create_toy_model(gen, device=device),
              "model_Y": create_toy_model(gen, device=device)}
    states = init_model_states(models, lambda p: build_optimizer(p, 1e-3))
    batch = 256  # the reference's batch per rank (demo.py:145)
    data = make_toy_data(seed=0)
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, len(data), size=(WINDOW, batch))).to(device)
    return (states, make_scanned_train_step(),
            torch.from_numpy(data.x).to(device),
            torch.from_numpy(data.y).to(device), idx)


def bench_toy(device="cuda", rounds: int = 3) -> dict:
    """Samples/s of the scanned two-model train step (counterpart of
    ``bench.py:47 bench_toy``): the best of ``rounds`` timed runs of at
    least 8 windows and half a second each."""
    device = resolve_device(device)
    states, chunk_step, x_all, y_all, idx = toy_setup(device)
    batch = idx.shape[1]
    for _ in range(3):  # warm-up
        states, losses = chunk_step(states, x_all, y_all, idx)
    _sync(losses["model_X"])
    best = 0.0
    for _ in range(rounds):
        chunks = 0
        t0 = time.perf_counter()
        while True:
            for _ in range(8):
                states, losses = chunk_step(states, x_all, y_all, idx)
            _sync(losses["model_X"])
            chunks += 8
            dt = time.perf_counter() - t0
            if dt >= 0.5:
                break
        best = max(best, batch * WINDOW * chunks / dt)
    return {"metric": "toy_mlp_samples_per_sec_per_chip", "value": best,
            "unit": "samples/sec/chip", "device": _device_name(device)}


def _device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def f64_forward(x: np.ndarray, weights) -> np.ndarray:
    """The toy forward in float64 numpy: the benches' ground truth."""
    from tpudist_torch.ops.fused_mlp import NEGATIVE_SLOPE

    h = np.asarray(x, np.float64)
    for i, (w, b) in enumerate(weights):
        h = h @ np.asarray(w, np.float64) + np.asarray(b, np.float64)
        if i + 1 < len(weights):
            h = np.where(h >= 0, h, NEGATIVE_SLOPE * h)
    return h


def bench_fused_mlp(batch: int = 4096, device="cuda") -> dict:
    """The fused toy forward against the plain eager chain (counterpart of
    ``bench.py:114 bench_fused_mlp``), on the toy model's weights (seed 0).

    Before timing both are held against a float64 numpy forward, relative
    to its largest magnitude: the kernel within 1e-4 (the JAX bench's own
    bound), the plain chain within 1e-5 (full f32 here: TF32 is off for the
    call).  ``kernel_calls`` counts the fused calls made while timing."""
    from tpudist_torch.ops.fused_mlp import (fused_mlp, mlp_reference,
                                             pack_params)

    device = resolve_device(device)
    model = create_toy_model(0, device=device)
    weights = [(w.detach(), b.detach()) for w, b in model.layers()]
    packed = pack_params(weights)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (batch, 2)).astype(np.float32)).to(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            ref = f64_forward(x.cpu().numpy(),
                              [(w.cpu().numpy(), b.cpu().numpy())
                               for w, b in weights])
            scale = max(float(np.abs(ref).max()), 1e-6)
            rel = float(np.abs(fused_mlp(x, packed).cpu().numpy() - ref)
                        .max() / scale)
            rel_plain = float(np.abs(mlp_reference(x, weights).cpu().numpy()
                                     - ref).max() / scale)
            if not np.isfinite(rel) or rel > 1e-4:
                raise AssertionError(f"fused_mlp numerics mismatch: "
                                     f"rel={rel}")
            if not np.isfinite(rel_plain) or rel_plain > 1e-5:
                raise AssertionError(f"plain chain numerics mismatch: "
                                     f"rel={rel_plain}")
            rates, calls = {}, 0
            for tag, fn in (("kernel_fused", lambda: fused_mlp(x, packed)),
                            ("plain_chain",
                             lambda: mlp_reference(x, weights))):
                _sync(fn())  # warm-up
                best = 0.0
                for _ in range(3):
                    n = 0
                    t0 = time.perf_counter()
                    while True:
                        for _ in range(20):
                            out = fn()
                        _sync(out)
                        n += 20
                        dt = time.perf_counter() - t0
                        if dt >= 0.3:
                            break
                    best = max(best, batch * n / dt)
                    if tag == "kernel_fused":
                        calls += n
                rates[tag] = best
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"metric": "toy_mlp_fused_forward_samples_per_sec",
            "unit": "samples/sec (forward only)", "config": {"batch": batch},
            "device": _device_name(device),
            "max_rel_err_vs_f64": rel, "plain_rel_err_vs_f64": rel_plain,
            **rates, "kernel_over_plain": rates["kernel_fused"]
            / rates["plain_chain"], "kernel_calls": calls}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    out = {"toy": bench_toy(args.device),
           "fused_mlp": bench_fused_mlp(4096, args.device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
