"""Serving a model with an MoE FFN on the port (``tpudist_torch/models/
generate.py``, ``serve/engine.py``, ``serve/spmd.py``, ``serve/disagg.py``)
against the JAX package on the CPU, with the weights carried across by
``params_from_flax``.

The JAX package serves an MoE model by cloning its slot programs with
``moe_fn=None``: every serving forward runs ``dense_moe_reference`` (the
top-1 gate, routing in f32, ties to the lower expert).  The port's serving
contexts do the same on every arm, whatever ``moe_fn`` the model carries.

- the JAX ``InferenceServer`` (its default dense arms, top-2 logprobs) on
  a ``create_transformer(n_experts=4)`` with RoPE and with learned
  positions is the yardstick; the port's server on every arm — the paged
  kernel arms (their plain versions here), the teacher-forced prefill, the
  unfused sampling tail, the gather decode on the pool, the dense cache
  with either tail, speculative decoding with a tied 1-layer draft on the
  kernel and the dense arms, a 1x2 serving mesh — gives its greedy tokens
  exactly and its logprobs within 1e-5;
- the 1x2 mesh equals the unsharded engine's ``peek_logits`` bit for bit,
  keeps the MoE FFN whole on each place, resolves ``tp_overlap`` to
  ``"off"`` and counts the FFN as replicated;
- ``DisaggServer`` with 1 prefill and 2 decode workers (the dense arms at
  decode block 4, the kernel arms at decode block 1) gives the JAX
  server's tokens and logprobs;
- a model carrying a ``moe_fn`` (``make_moe(k=2)``, as phase 19 trains
  it) serves top-1 through the dense reference and never calls it, while
  its training forward does; ``generate()`` and ``make_slot_decode`` on it
  equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.models import create_transformer as jax_create
from tpudist.models import generate as jax_generate
from tpudist.serve import InferenceServer as JaxServer
from tpudist.serve import ServeConfig as JaxServeConfig
from torch_cases import settled_torch_cpu
from tpudist_torch.models import (TransformerLM, generate, moe_expert_fn,
                                  params_from_flax)
from tpudist_torch.parallel import make_moe
from tpudist_torch.runtime.mesh import data_model_mesh
from tpudist_torch.serve import (DisaggServer, InferenceServer, ServeConfig,
                                 SlotEngine)

EXPERTS = 4
CFG = dict(vocab=16, d_model=32, n_layers=2, n_heads=2, d_ff=64, max_len=64,
           n_experts=EXPERTS)
N_LP = 2
SERVE_KW = dict(num_slots=2, queue_limit=16, prefill_pad=8, kv_block=8,
                decode_block=2, logprobs=N_LP)
DENSE = dict(paged=False, attn_kernel="gather", prefill_kernel=False,
             sample_kernel=False)
#: the port's serving arms (its defaults are the paged kernel arms)
ARMS = {
    "kernel": {},
    "kernel-teacher-forced": dict(prefill_kernel=False),
    "kernel-unfused-tail": dict(sample_kernel=False),
    "gather-on-pool": dict(attn_kernel="gather"),
    "dense": DENSE,
    "dense-kernel-tail": dict(DENSE, sample_kernel=True),
    "spec-kernel": dict(spec=True, spec_draft_layers=1, spec_k=4),
    "spec-dense": dict(DENSE, spec=True, spec_draft_layers=1, spec_k=4),
    "mesh-1x2": dict(mesh="1x2"),
}


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    with settled_torch_cpu(torch):
        yield


def _prompt(plen, seed):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab"], size=plen).astype(np.int32)


#: (prompt, max_new): a prompt past the prefill chunk of 8 among them
REQS = [(_prompt(3, 0), 8), (_prompt(5, 1), 6), (_prompt(12, 2), 7),
        (_prompt(6, 3), 5)]


def _port(jparams, rope: bool, **extra) -> TransformerLM:
    model = TransformerLM(**CFG, rope=rope, **extra)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                        jparams)))
    return model.requires_grad_(False)


@pytest.fixture(scope="module")
def models():
    memo = {}

    def get(pos):
        if pos not in memo:
            jmod, jparams = jax_create(jax.random.PRNGKey(0), seq_len=16,
                                       rope=pos == "rope", **CFG)
            memo[pos] = (jmod, jparams), _port(jparams, pos == "rope")
        return memo[pos]

    return get


def _serve(srv):
    """``REQS`` submitted at once on a started server; the handles."""
    srv.start()
    try:
        hs = [srv.submit(p, max_new=n, logprobs=N_LP) for p, n in REQS]
        for h in hs:
            assert h.wait(120)
        return hs
    finally:
        assert srv.close(60)


@pytest.fixture(scope="module")
def reference(models):
    """The JAX server's handles (default arms) on each position kind."""
    memo = {}

    def get(pos):
        if pos not in memo:
            (jmod, jparams), _ = models(pos)
            memo[pos] = _serve(JaxServer(jmod, jparams, JaxServeConfig(
                **SERVE_KW), install_signal_handler=False))
        return memo[pos]

    return get


def _hold(got, want):
    """Greedy tokens equal, logprobs rows within 1e-5."""
    for g, w in zip(got, want):
        assert g.finish_reason == w.finish_reason == "length"
        assert g.tokens == w.tokens
        assert len(g.logprobs) == len(w.logprobs)
        for a, b in zip(w.logprobs, g.logprobs):
            assert (a is None) == (b is None)
            if a is not None:
                assert list(b[0]) == list(a[0])
                np.testing.assert_allclose(b[1], a[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arm,pos", [(arm, "rope") for arm in ARMS] + [
    ("kernel", "learned"), ("dense", "learned"), ("spec-kernel", "learned"),
    ("mesh-1x2", "learned")])
def test_server_arms_equal_jax(models, reference, arm, pos):
    _, model = models(pos)
    srv = InferenceServer(model, ServeConfig(**SERVE_KW, **ARMS[arm]),
                          device="cpu", install_signal_handler=False)
    _hold(_serve(srv), reference(pos))
    st = srv.stats()
    if ARMS[arm].get("spec"):
        assert st["spec"]["blocks"] > 0 and st["spec"]["drafted"] > 0
    if st["kv"]["paged"]:
        assert st["kv"]["blocks_in_use"] == 0


def test_mesh_keeps_the_moe_ffn_whole(models):
    """1x2 places: ``peek_logits`` equals the unsharded engine's bit for
    bit; the MoE FFN stays whole (no ``wi`` cut, the router and the
    expert stacks replicated); the overlapped MLP asked for resolves to
    ``"off"``, as the JAX engine forces it for an MoE model."""
    _, model = models("rope")
    kw = dict(num_slots=2, prefill_pad=8, kv_block=8, device="cpu")
    eng = SlotEngine(model, mesh="1x2", **kw)
    ring = SlotEngine(model, mesh=ServeConfig(
        mesh="1x2", tp_overlap="ring").mesh_config(), **kw)
    plain = SlotEngine(model, **kw)
    for e in (eng, ring, plain):
        e.start_batch([(0, REQS[0][0], 0.0, 0, 8),
                       (1, REQS[2][0], 0.0, 1, 8)])
        e.advance_prefill()
    want = plain.fns.peek_logits(plain.state, plain.cache)
    for e in (eng, ring):
        assert torch.equal(e.fns.peek_logits(e.state, e.cache), want)
        sp = e.spmd_stats()
        assert sp["tp_overlap"] == "off"
        assert "moe" in sp["replicated"] and "wi" not in sp["replicated"]
        assert e.places.wi_places == 1 and e.places.mlp_fn is None
        assert all("wi" not in pw and "wo" not in pw
                   for pw in e.places.blocks)
        # only qkv and the head split: the expert bytes stay on each place
        moe_bytes = sum(p.numel() * p.element_size()
                        for n, p in model.named_parameters() if ".moe." in n)
        assert sp["param_bytes_per_device"] > moe_bytes
        assert sp["param_bytes_sharded"] < sp["param_bytes_total"] - moe_bytes
    with pytest.raises(ValueError, match="MoE"):
        SlotEngine(model, adapters=True, mesh="1x2", **kw)


@pytest.mark.parametrize("arm", ["dense", "kernel"])
def test_disagg_one_plus_two_equal_jax(models, reference, arm):
    """``DisaggServer`` with 1 prefill and 2 decode workers: the dense arms
    at decode block 4 (schedule-free) and the kernel arms at decode block
    1, where a handed-off lane's block boundaries are one server's."""
    _, model = models("rope")
    knobs = (dict(DENSE, decode_block=4) if arm == "dense"
             else dict(decode_block=1))
    cfg = ServeConfig(**dict(SERVE_KW, **knobs), disagg=True,
                      prefill_workers=1, decode_workers=2, handoff="serial")
    srv = DisaggServer(model, cfg, device="cpu",
                       install_signal_handler=False)
    _hold(_serve(srv), reference("rope"))
    st = srv.stats()
    assert st["handoffs"] == len(REQS)
    assert st["decode_pool"]["workers"] == 2


class _Counted:
    """A ``moe_fn`` that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, params, tokens):
        self.calls += 1
        return self.fn(params, tokens)


def test_model_with_moe_fn_serves_top1(models, reference):
    """A model carrying the expert-parallel layer at top-2 (phase 19's
    training configuration) serves through the dense top-1 reference on
    every serving entry — the server, ``make_slot_decode`` through the
    engine, ``generate()`` — and never calls the layer; its training
    forward still routes through it, and differs."""
    (jmod, jparams), _ = models("rope")
    model = _port(jparams, True)
    fn = _Counted(make_moe(data_model_mesh(EXPERTS, device="cpu"),
                           moe_expert_fn, k=2))
    model.moe_fn = fn
    for arm in ("kernel", "dense", "spec-kernel"):
        srv = InferenceServer(model, ServeConfig(**SERVE_KW, **ARMS[arm]),
                              device="cpu", install_signal_handler=False)
        _hold(_serve(srv), reference("rope"))
    prompts = np.stack([REQS[0][0], _prompt(3, 9)])
    want = np.asarray(jax_generate(jmod, jparams, jnp.asarray(prompts), 6))
    got = generate(model, torch.from_numpy(prompts), 6).numpy()
    np.testing.assert_array_equal(got, want)
    assert fn.calls == 0
    toks = torch.tensor(want[:, :8], dtype=torch.int32)
    with torch.no_grad():
        routed = model(toks)
        model.moe_fn = None
        dense = model(toks)
    assert fn.calls == 2  # one call a layer of the training forward
    assert not torch.equal(routed, dense)  # top-2 is another function
