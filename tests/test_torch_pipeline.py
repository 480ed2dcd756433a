"""The port's pipeline schedules (``tpudist_torch.parallel.pipeline`` and
``pipeline_interleaved``) against the JAX package's, on the CPU.

- The interleaved simulator's tables, ``total_ticks``, the bank depths,
  ``bubble_ticks`` and ``format_timeline`` equal JAX's over a grid of
  ``(D, V, M)`` (the port copies the framework-free simulator), with the
  ``M % D`` refusal.
- ``interleave_block_params`` / ``deinterleave_block_params`` against
  JAX's on the same stack.
- JAX's tanh stage function at ``(D, V, M)`` (4, 2, 8), (2, 4, 4) and
  (4, 1, 8), the same numpy inputs: ``pipeline_interleaved_shard`` over D
  places of V chunks, ``pipeline_1f1b_shard`` and ``pipeline_shard`` (with
  and without ``remat``) over D stages of V layers, and ``make_pipeline``
  — each against the JAX function on a ``stage`` mesh of D virtual
  devices; the port folds the D stages onto the CPU.  The loss at ``rtol
  1e-5``, the stage gradients, head gradients and dx at ``rtol 1e-4, atol
  1e-5`` (``tests/test_pipeline_interleaved.py``'s bounds).
- The refusals JAX makes (a schedule for another device count or
  microbatch count, a contiguous layout handed to the interleaved
  schedule, a batch that does not divide).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from torch_cases import settled_torch_cpu
from tpudist.parallel import make_pipeline as jax_make_pipeline
from tpudist.parallel import pipeline_1f1b_shard as jax_1f1b
from tpudist.parallel import pipeline_shard as jax_gpipe
from tpudist.parallel.overlap import compat_shard_map
from tpudist.parallel.pipeline_interleaved import (
    deinterleave_block_params as jax_deinterleave,
    format_timeline as jax_format_timeline,
    interleave_block_params as jax_interleave,
    interleaved_schedule as jax_schedule,
    pipeline_interleaved_shard as jax_interleaved)
from tpudist_torch.parallel import (LocalRing, deinterleave_block_params,
                                    interleave_block_params,
                                    interleaved_schedule, make_pipeline,
                                    pipeline_1f1b_shard,
                                    pipeline_interleaved_shard,
                                    pipeline_shard)
from tpudist_torch.parallel.pipeline_interleaved import format_timeline

LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
GRID = [(4, 2, 8), (2, 4, 4), (4, 1, 8)]


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


@pytest.mark.parametrize("D,V,M", [(1, 1, 1), (1, 3, 2), (2, 1, 4),
                                   (2, 2, 4), (2, 4, 4), (3, 2, 6),
                                   (4, 1, 8), (4, 2, 8), (4, 4, 16),
                                   (8, 1, 16)])
def test_interleaved_schedule_equals_jax(D, V, M):
    want, got = jax_schedule(D, V, M), interleaved_schedule(D, V, M)
    for field in ("n_dev", "n_chunks", "n_micro", "total_ticks",
                  "act_depth", "cot_depth", "bubble_ticks"):
        assert getattr(got, field) == getattr(want, field), field
    assert sorted(got.tables) == sorted(want.tables)
    for k, v in want.tables.items():
        np.testing.assert_array_equal(got.tables[k], v, err_msg=k)
    assert format_timeline(got) == jax_format_timeline(want)


def test_interleaved_schedule_refusal():
    for fn in (jax_schedule, interleaved_schedule):
        with pytest.raises(ValueError, match="multiple"):
            fn(4, 2, 6)


def test_interleave_layout_equals_jax():
    stack = np.random.default_rng(0).normal(size=(8, 3, 2)).astype(
        np.float32)
    for n_dev in (1, 2, 4, 8):
        want = np.asarray(jax_interleave({"w": jnp.asarray(stack)},
                                         n_dev)["w"])
        got = interleave_block_params({"w": torch.from_numpy(stack)},
                                      n_dev)["w"]
        np.testing.assert_array_equal(got.numpy(), want)
        back = deinterleave_block_params({"w": got}, n_dev)["w"]
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jax_deinterleave(
                {"w": jnp.asarray(want)}, n_dev)["w"]))
        np.testing.assert_array_equal(back.numpy(), stack)
    for fn in (jax_interleave, interleave_block_params):
        with pytest.raises(ValueError, match="does not split over 3"):
            fn({"w": jnp.asarray(stack) if fn is jax_interleave
                else torch.from_numpy(stack)}, 3)


# -- the schedules on JAX's tanh stage function --------------------------------


def _jax_stage(p, x):
    for i in range(p.shape[0]):
        x = jnp.tanh(x @ p[i])
    return x


def _stage(p, x):
    for i in range(p.shape[0]):
        x = torch.tanh(x @ p[i])
    return x


def _jax_loss(ow, act, aux):
    return jnp.mean((act @ ow - aux) ** 2)


def _loss(ow, act, aux):
    return torch.mean((act @ ow - aux) ** 2)


def _inputs(D, V, M, d_model=8, micro=4):
    rng = np.random.default_rng(D * 100 + V * 10 + M)
    S = D * V
    return dict(
        Ws=(rng.normal(size=(S, 1, d_model, d_model)) * 0.3).astype(
            np.float32),
        ow=rng.normal(size=(d_model,)).astype(np.float32),
        xs=rng.normal(size=(M, micro, d_model)).astype(np.float32),
        aux=rng.normal(size=(M, micro)).astype(np.float32))


def _mesh(D):
    return Mesh(np.asarray(jax.devices()[:D]), ("stage",))


def _hold(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **GRAD_TOL)


@pytest.mark.parametrize("D,V,M", GRID)
def test_interleaved_shard_equals_jax(D, V, M):
    inp = _inputs(D, V, M)
    sched = jax_schedule(D, V, M)

    def body(Wb, ow, xm, am):
        return jax_interleaved(Wb, ow, xm, am, stage_fn=_jax_stage,
                               loss_fn=_jax_loss, schedule=sched,
                               axis_name="stage")

    jl, jcg, jog, jdx = jax.jit(compat_shard_map(
        body, mesh=_mesh(D), in_specs=(P("stage"), P(), P(), P()),
        out_specs=(P(), P("stage"), P(), P())))(
        jax_interleave(jnp.asarray(inp["Ws"]), D), inp["ow"], inp["xs"],
        inp["aux"])
    inter = interleave_block_params(torch.from_numpy(inp["Ws"]), D)
    chunks = [[inter[d * V + c].clone().requires_grad_() for c in range(V)]
              for d in range(D)]
    loss, cg, og, dx = pipeline_interleaved_shard(
        chunks, torch.from_numpy(inp["ow"]), torch.from_numpy(inp["xs"]),
        torch.from_numpy(inp["aux"]), stage_fn=_stage, loss_fn=_loss,
        schedule=interleaved_schedule(D, V, M), stages=LocalRing(D))
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    _hold(torch.stack([g for per in cg for g in per]).numpy(), jcg,
          "chunk grads")
    _hold(og.numpy(), jog, "out grads")
    _hold(dx.numpy(), jdx, "dx")


@pytest.mark.parametrize("D,V,M", GRID)
def test_1f1b_shard_equals_jax(D, V, M):
    inp = _inputs(D, V, M)
    Ws = inp["Ws"].reshape(D, V, *inp["Ws"].shape[2:])

    def body(Wb, ow, xm, am):
        return jax_1f1b(Wb, ow, xm, am, stage_fn=_jax_stage,
                        loss_fn=_jax_loss, axis_name="stage")

    jl, jsg, jog, jdx = jax.jit(compat_shard_map(
        body, mesh=_mesh(D), in_specs=(P("stage"), P(), P(), P()),
        out_specs=(P(), P("stage"), P(), P())))(
        Ws, inp["ow"], inp["xs"], inp["aux"])
    stages = [torch.from_numpy(Ws[s]).requires_grad_() for s in range(D)]
    loss, sg, og, dx = pipeline_1f1b_shard(
        stages, torch.from_numpy(inp["ow"]), torch.from_numpy(inp["xs"]),
        torch.from_numpy(inp["aux"]), stage_fn=_stage, loss_fn=_loss,
        stages=LocalRing(D))
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    _hold(torch.stack(sg).numpy(), jsg, "stage grads")
    _hold(og.numpy(), jog, "out grads")
    _hold(dx.numpy(), jdx, "dx")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("D,V,M", GRID)
def test_gpipe_shard_and_make_pipeline_equal_jax(D, V, M, remat):
    """``pipeline_shard`` under the head loss, its gradients taken by the
    port's fixed-order backward, and the global-view ``make_pipeline``."""
    inp = _inputs(D, V, M)
    Ws = inp["Ws"].reshape(D, V, *inp["Ws"].shape[2:])
    mesh = _mesh(D)

    def jax_total(Wb, ow, xm):
        out = compat_shard_map(
            lambda sp, x: jax_gpipe(sp, x, stage_fn=_jax_stage,
                                    axis_name="stage", remat=remat)[None],
            mesh=mesh, in_specs=(P("stage"), P()),
            out_specs=P("stage"))(Wb, xm)[-1]
        return sum(_jax_loss(ow, out[m], inp["aux"][m]) for m in range(M))

    jl, (jsg, jog, jdx) = jax.jit(jax.value_and_grad(
        jax_total, argnums=(0, 1, 2)))(Ws, inp["ow"], inp["xs"])
    stages = [torch.from_numpy(Ws[s]).requires_grad_() for s in range(D)]
    ow = torch.from_numpy(inp["ow"]).requires_grad_()
    xs = torch.from_numpy(inp["xs"]).requires_grad_()
    aux = torch.from_numpy(inp["aux"])
    out = pipeline_shard(stages, xs, stage_fn=_stage, stages=LocalRing(D),
                         remat=remat)
    loss = sum(_loss(ow, out[m], aux[m]) for m in range(M))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    _hold(torch.stack([s.grad for s in stages]).numpy(), jsg, "stage grads")
    _hold(ow.grad.numpy(), jog, "out grads")
    _hold(xs.grad.numpy(), jdx, "dx")

    # the global view: the whole [D, ...] stack and an unsplit batch
    x = inp["xs"].reshape(-1, inp["xs"].shape[-1])
    jfn = jax_make_pipeline(mesh, _jax_stage, num_microbatches=M,
                            remat=remat)
    jout, jgrad = jax.value_and_grad(
        lambda w, x: jnp.sum(jnp.sin(jfn(w, x))), argnums=(0, 1))(Ws, x)
    w = torch.from_numpy(Ws).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    fn = make_pipeline(LocalRing(D), _stage, num_microbatches=M,
                       remat=remat)
    total = torch.sum(torch.sin(fn(w, tx)))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jout),
                               rtol=LOSS_RTOL)
    _hold(w.grad.numpy(), jgrad[0], "stack grads")
    _hold(tx.grad.numpy(), jgrad[1], "x grads")


def test_schedule_refusals():
    D, V, M = 2, 2, 4
    inp = _inputs(D, V, M)
    inter = torch.from_numpy(inp["Ws"])
    chunks = [[inter[d * V + c] for c in range(V)] for d in range(D)]
    args = (torch.from_numpy(inp["ow"]), torch.from_numpy(inp["xs"]),
            torch.from_numpy(inp["aux"]))
    kw = dict(stage_fn=_stage, loss_fn=_loss)
    with pytest.raises(ValueError, match="built for 2 devices"):
        pipeline_interleaved_shard(chunks, *args, **kw,
                                   schedule=interleaved_schedule(2, V, M),
                                   stages=LocalRing(4))
    with pytest.raises(ValueError, match="built for 8 microbatches"):
        pipeline_interleaved_shard(chunks, *args, **kw,
                                   schedule=interleaved_schedule(D, V, 8),
                                   stages=LocalRing(D))
    # a contiguous layout (one chunk a device) to the interleaved schedule
    with pytest.raises(ValueError, match="stack_block_params_interleaved"):
        pipeline_interleaved_shard([[c[0]] for c in chunks], *args, **kw,
                                   schedule=interleaved_schedule(D, V, M),
                                   stages=LocalRing(D))
    with pytest.raises(ValueError, match="must divide into 3"):
        make_pipeline(LocalRing(D), _stage, num_microbatches=3)(
            {"w": inter[:D]}, torch.zeros(8, 8))
