#!/usr/bin/env python3
"""Phases of ``chip_smoke.py`` in two trees on one NVIDIA card, in turns,
and the kernels they exercise at the main path's shapes in both.

Run from the repository root on the GPU machine::

    python3 tests/torch_kernels_parent.py --parent DIR [--out FILE]
        [--sections linear,sample]

``DIR`` holds another checkout of the repository, for example an earlier
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists.  In the order parent, this tree, this tree, parent, a child process
in each tree runs the sections asked for (both by default).

Section ``linear`` builds that tree's ``lora_delta``, ``fused_rope_qkv``
and ``fused_mlp`` kernels and runs:

- its own ``chip_smoke.check_fused_linear`` (phase 3c) and
  ``chip_smoke.check_fused_mlp`` (phase 3e): every kernel against its plain
  version, then that tree's timings;
- the same timing table in every tree, from this script (``QKV_SHAPES``,
  ``LORA_SHAPES``, ``MLP_SHAPES``): the tree's ``fused_rope_qkv``,
  ``lora_delta`` and ``fused_mlp`` wrappers at the main path's shapes (the
  speculative verify's T 5 included, which an older phase 3c may not
  time), each with ``chip_smoke.time_ms`` (CUDA events, median of 30, L2
  flushed before each launch);
- ``tpudist_torch.bench.bench_fused_mlp(4096)`` (phase 11's forward bench:
  samples/s of the kernel and of the plain chain, host-paced);
- its own ``chip_smoke.serve_adapter_path`` (phase 4b: the d1024 LM served
  with 4 adapters on the fused arms; tokens/s, TTFT and TPOT, host-paced).

Section ``table`` builds that tree's flash, ``fused_rope_qkv`` and
``lora_delta`` kernels and times only the common rows of both other
sections' kind: ``QKV_SHAPES`` (the planned arm, and the ``mma.sync`` arm
forced), ``LORA_SHAPES`` and ``FLASH_SHAPES`` (the flash kernels'
``mma.sync`` arms forced in bf16, and their f32 arms: forward, dq and
dk/dv at head dims 128 and 32), each with ``chip_smoke.time_ms`` (~5
min).

Section ``sample`` builds that tree's serving kernels (``paged_attention``,
``paged_prefill``, ``fused_sample``) and runs:

- the same timing table in every tree (``SAMPLE_SHAPES``,
  ``RESIDUAL_SHAPES``): the tree's ``fused_sample_prep`` and
  ``fused_residual_prep`` on the arm its own plan picks, each with
  ``chip_smoke.time_ms``; a shape the tree's kernel refuses (an earlier
  tree sorted a filtered row in one CTA's shared memory, up to vocab 4096)
  reads ``None``;
- its own ``chip_smoke.check_residual`` (phase 3d);
- its own ``chip_smoke.serve_main_path`` and ``serve_spec_path`` (phases 4
  and 4c: the d1024 LM served plain, then with speculative decoding;
  tokens/s, TTFT and TPOT, host-paced).

Each child prints one JSON line with the card's ``nvidia-smi`` name and
power limit.  Exits non-zero if a child fails.  Not collected by pytest:
it needs the card and a few minutes.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# (label, T, offsets): 8 slots of the d1024 / 8-head / dh-128 qkv projection
# with the LoRA delta on the lanes phase 3c marks, as phase 3c builds them
QKV_SHAPES = (("qkv decode", 1, "DECODE_OFFS"),
              ("qkv verify", 5, "DECODE_OFFS"),
              ("qkv prefill", 64, "PREFILL_OFFS"))
# (label, T, d_in, d_out): 8 slots at rank 8 over an 8-block pool, as phase
# 3c builds them
LORA_SHAPES = (("qkv decode", 1, 1024, 3072), ("wi decode", 1, 1024, 4096),
               ("wo decode", 1, 4096, 1024), ("wi verify", 5, 1024, 4096),
               ("wi prefill", 64, 1024, 4096))
# (label, weights, batch), as phase 3e builds them
MLP_SHAPES = (("toy b256", "toy", 256), ("toy b1000", "toy", 1000),
              ("toy b4096", "toy", 4096), ("toy b1048576", "toy", 1 << 20),
              ("wide 128x5 b4096", "wide", 4096))
# (label, S, vocab, top_k, top_p): the sampling prep's shapes, as phase 3
# names them: (a) serving, (b) the verify's 40 rows, (c) both filters at
# vocab 256, (d)-(f) long vocabularies
SAMPLE_SHAPES = (("a", 8, 256, 0, 0.0), ("b", 40, 256, 0, 0.0),
                 ("c", 8, 256, 50, 0.9), ("d", 8, 32000, 0, 0.0),
                 ("e", 8, 32000, 0, 0.9), ("f", 8, 50257, 50, 0.9))
# (label, k, vocab, dtype): the residual prep's shapes, the verify's first
RESIDUAL_SHAPES = (("[8, 4, 256] f32", 4, 256, "float32"),
                   ("[8, 4, 32000] f32", 4, 32000, "float32"),
                   ("[8, 4, 32000] bf16", 4, 32000, "bfloat16"))
# (label, b, h, s, head dim): the flash kernels' mma.sync arms, forced, and
# their f32 arms (the LM entry point's default precision) at phase 3b's
# timed shape and at ``python -m tpudist_torch.train``'s head dim
FLASH_SHAPES = (("dh 128", 8, 8, 2048, 128), ("dh 32", 8, 4, 512, 32))
SECTIONS = ("linear", "sample", "table")


def linear_table(torch, cs, dev, gen, flush) -> dict:
    """The common ``fused_rope_qkv`` and ``lora_delta`` rows."""
    from tpudist_torch.ops.fused_linear import fused_rope_qkv, lora_delta

    common = {}
    for label, T, offs in QKV_SHAPES:
        args = cs.qkv_inputs(torch, dev, gen, cs.SLOTS, T, cs.HEADS,
                             cs.HEADS, cs.DH, torch.bfloat16,
                             getattr(cs, offs))
        kw = dict(n_heads=cs.HEADS, n_kv=cs.HEADS, dh=cs.DH)
        common[f"fused_rope_qkv {label}"] = cs.time_ms(
            torch, lambda: fused_rope_qkv(*args, **kw), flush)
    for label, T, d_in, d_out in LORA_SHAPES:
        args = cs.lora_inputs(torch, dev, gen, cs.SLOTS, T, d_in, d_out,
                              torch.bfloat16, cs.RANK, cs.LORA_IDS)
        common[f"lora_delta {label}"] = cs.time_ms(
            torch, lambda: lora_delta(*args, layer=3), flush)
    return common


def measure_linear(torch, cs) -> dict:
    """Section ``linear``: phases 3c, 3e, the common table, the fused-MLP
    bench and phase 4b of the tree in the current directory."""
    from tpudist_torch.bench import bench_fused_mlp
    from tpudist_torch.ops import _build
    from tpudist_torch.ops.fused_mlp import fused_mlp, pack_params

    _build.build()
    dev = torch.device("cuda")
    lin_rec, lin_info = cs.check_fused_linear(torch, dev)
    mlp_rec, mlp_cases = cs.check_fused_mlp(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(5678)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    common = linear_table(torch, cs, dev, gen, flush)
    with torch.no_grad():
        for label, kind, batch in MLP_SHAPES:
            weights, x = cs.mlp_inputs(torch, kind, batch, dev)
            packed = pack_params(weights)
            common[f"fused_mlp {label}"] = cs.time_ms(
                torch, lambda: fused_mlp(x, packed), flush)
    del flush
    bench = bench_fused_mlp(4096, "cuda")
    model, cpu_model = lm_models(torch, cs)
    ad = cs.serve_adapter_path(torch, model, 7, cpu_model)
    adapter_path = {k: ad[k] for k in ("tokens_per_s", "ttft_p50_ms",
                                       "tpot_p50_ms", "forwards",
                                       "launches")}
    return dict(common_ms=common,
                phase_3c=dict(kernels=lin_rec, timings=lin_info["timings"]),
                phase_3e=dict(kernels=mlp_rec, cases=mlp_cases),
                bench_fused_mlp=bench, adapter_path=adapter_path)


def lm_models(torch, cs):
    """Phase 4's d1024 LM on the card (bf16) and its CPU f32 twin."""
    from tpudist_torch.models import TransformerLM, create_transformer

    cpu_model = create_transformer(0, device="cpu", dtype=torch.float32,
                                   **cs.MODEL)
    model = TransformerLM(dtype=torch.bfloat16, **cs.MODEL)
    model.load_state_dict(cpu_model.state_dict())
    return model.to("cuda").requires_grad_(False), cpu_model


def measure_sample(torch, cs) -> dict:
    """Section ``sample``: the common sampling and residual table, phase
    3d and phases 4 and 4c of the tree in the current directory."""
    from tpudist_torch.ops import _build
    from tpudist_torch.ops.fused_sample import (fused_residual_prep,
                                                fused_sample_prep)

    _build.build(["paged_attention", "paged_prefill", "fused_sample"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2468)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    common = {}
    for label, S, vocab, tk, tp in SAMPLE_SHAPES:
        lg = torch.randn(S, vocab, generator=gen, device=dev) * 2
        temps = torch.rand(S, generator=gen, device=dev) + 0.5
        try:
            fused_sample_prep(lg, temps, top_k=tk, top_p=tp)
        except ValueError:  # this tree's kernel refuses the shape
            common[f"fused_sample ({label})"] = None
            continue
        common[f"fused_sample ({label})"] = cs.time_ms(
            torch, lambda: fused_sample_prep(lg, temps, top_k=tk, top_p=tp),
            flush)
    temps = torch.rand(cs.SLOTS, generator=gen, device=dev) + 0.5
    for label, k, vocab, dtype in RESIDUAL_SHAPES:
        lt, ld = ((torch.randn(cs.SLOTS, k, vocab, generator=gen,
                               device=dev) * 3).to(getattr(torch, dtype))
                  for _ in range(2))
        common[f"fused_residual_prep {label}"] = cs.time_ms(
            torch, lambda: fused_residual_prep(lt, ld, temps), flush)
    del flush
    phase_3d = cs.check_residual(torch, dev)
    model, _ = lm_models(torch, cs)
    main_path = cs.serve_main_path(torch, model, gen_seed=7)
    spec = cs.serve_spec_path(torch, model, 7, main_path)
    keys = ("tokens_per_s", "ttft_p50_ms", "tpot_p50_ms", "launches")
    return dict(common_ms=common, phase_3d=phase_3d,
                serving={k: main_path[k] for k in keys},
                spec_serving={k: spec[k] for k in keys + (
                    "acceptance_rate", "spec_blocks")})


def measure_table(torch, cs) -> dict:
    """Section ``table``: the common ``fused_rope_qkv`` and ``lora_delta``
    rows and the flash ``mma.sync`` arms of the tree in the current
    directory."""
    from tpudist_torch.ops import _build
    from tpudist_torch.ops.flash_attention import (_launch_dkv, _launch_dq,
                                                   _launch_fwd)
    from tpudist_torch.ops.fused_linear import _launch_rope

    _build.build(["flash_attention", "flash_backward", "fused_rope_qkv",
                  "lora_delta"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5678)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    common = linear_table(torch, cs, dev, gen, flush)
    for label, T, offs in QKV_SHAPES:  # the mma.sync arm, forced
        args = cs.qkv_inputs(torch, dev, gen, cs.SLOTS, T, cs.HEADS,
                             cs.HEADS, cs.DH, torch.bfloat16,
                             getattr(cs, offs))
        kw = dict(n_heads=cs.HEADS, n_kv=cs.HEADS, dh=cs.DH)
        common[f"fused_rope_qkv mma {label}"] = cs.time_ms(
            torch, lambda: _launch_rope("mma", *args, **kw), flush)
    band = (0, None)
    for (label, b, h, s, d), (arm, dtype) in itertools.product(
            FLASH_SHAPES, (("mma", torch.bfloat16), ("f32", torch.float32))):
        q, k, v, g = (torch.randn(b, h, s, d, generator=gen, device=dev)
                      .to(dtype) for _ in range(4))
        _, lse = _launch_fwd(arm, q, k, v, band)
        delta = torch.randn(b, h, s, generator=gen, device=dev)
        for kname, fn in (
                ("forward", lambda: _launch_fwd(arm, q, k, v, band)),
                ("dq", lambda: _launch_dq(arm, q, k, v, g, lse, delta,
                                          band)),
                ("dk/dv", lambda: _launch_dkv(arm, q, k, v, g, lse, delta,
                                              band))):
            common[f"flash {kname} {arm} {label}"] = cs.time_ms(torch, fn,
                                                                flush)
    del flush
    return dict(common_ms=common)


def measure(sections) -> dict:
    """The sections asked for, of the tree in the current directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = dict(tree=os.getcwd(), card=cs.card_line())
    for name in sections:
        out[name] = {"linear": measure_linear, "sample": measure_sample,
                     "table": measure_table}[name](torch, cs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="the other tree's root")
    ap.add_argument("--out", default=None, help="write every line here too")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated sections to run: "
                    + ", ".join(SECTIONS))
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sections = [x for x in args.sections.split(",") if x]
    if not set(sections) <= set(SECTIONS):
        ap.error(f"--sections: one or more of {SECTIONS}")
    if args.measure:
        print(json.dumps(measure(sections)))
        return 0
    if not args.parent:
        ap.error("--parent is required")
    parent = Path(args.parent).resolve()
    lines = []
    for label, tree in (("parent", parent), ("change", ROOT),
                        ("change", ROOT), ("parent", parent)):
        run = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--measure",
             "--sections", ",".join(sections)],
            cwd=tree, capture_output=True, text=True, timeout=900,
            env=dict(os.environ, PYTHONPATH=str(tree)))
        if run.returncode != 0:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(run.stdout.strip().splitlines()[-1])
        res["label"] = label
        lines.append(res)
        brief = dict(label=label, card=res["card"])
        for name in sections:
            brief[name] = {k: v for k, v in res[name].items()
                           if k in ("common_ms", "bench_fused_mlp",
                                    "adapter_path", "serving",
                                    "spec_serving")}
        print(json.dumps(brief), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
