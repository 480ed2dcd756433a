"""The port's fused linear ops (tpudist_torch/ops/fused_linear.py) against
the JAX package's Pallas kernels in interpret mode and their references.

The same numpy inputs (seeded, built as tests/test_kernel_family.py builds
them: S 3, T 4, 4 q heads, head dim 8, per-slot offsets 0 / 3 / 11, the
delta on lanes 0 and 2) go through ``tpudist.ops.fused_linear`` and through
the port's CPU path (the plain versions the wrappers run for CPU tensors).

``_rope_qkv_split_reference``, the plain model of the CUDA split arm's
depth sum, goes through the same comparison at S 3, T 1 and 5, d 256 and
head dim 64; ``_rope_arm`` (the arm plan) and the constants it shares with
``csrc/fused_rope_qkv.cu`` are held without a card.

Tolerances:

- ``fused_rope_qkv``: the JAX suite's own, ``atol = rtol = 1e-6`` (f32;
  the product, the delta and the rotation differ only in the order of the
  f32 sums);
- ``lora_delta``: ``atol = rtol = 2e-6``.  JAX pins its kernel to its
  reference exactly, since both run the same XLA dot; across frameworks the
  two f32 contractions (depth 32, then rank 2, of unit-normal values, so
  outputs up to ~30) sum in another order, a few units in the last place
  of the larger intermediate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist.ops.fused_linear import fused_rope_qkv as jax_rope_qkv
from tpudist.ops.fused_linear import \
    fused_rope_qkv_reference as jax_rope_qkv_reference
from tpudist.ops.fused_linear import lora_delta as jax_lora_delta
from tpudist.ops.fused_linear import \
    lora_delta_reference as jax_lora_delta_reference
from torch_cases import settled_torch_cpu
from tpudist_torch.ops import (fused_rope_qkv, fused_rope_qkv_reference,
                               launch_counts, lora_delta,
                               lora_delta_reference, reset_launch_counts)
from tpudist_torch.ops import _build
from tpudist_torch.ops.fused_linear import (LORA_DECODE_ROWS, LORA_RANKS,
                                            ROPE_ARMS, ROPE_SPLIT_COLS,
                                            ROPE_SPLIT_KS,
                                            ROPE_SPLIT_MAX_D,
                                            ROPE_SPLIT_ROWS, ROPE_STAGES,
                                            ROPE_TILE_ROWS,
                                            ROPE_WGMMA_HEAD_DIMS,
                                            _launch_lora, _launch_rope,
                                            _lora_arm, _rope_arm,
                                            _rope_qkv_split_reference)

QKV_TOL = dict(atol=1e-6, rtol=1e-6)
LORA_TOL = dict(atol=2e-6, rtol=2e-6)


@pytest.fixture(scope="module", autouse=True)
def _settled_torch_cpu():
    """Two intra-op threads, torch's CPU kernels warmed up first
    (``torch_cases.settled_torch_cpu``)."""
    with settled_torch_cpu(torch):
        yield


def _case(seed, S=3, T=4, nh=4, n_kv=2, dh=8):
    r = np.random.default_rng(seed)
    d, kv = nh * dh, n_kv * dh
    h = r.normal(size=(S, T, d)).astype(np.float32)
    w = (r.normal(size=(d, d + 2 * kv)) * 0.05).astype(np.float32)
    offs = np.asarray([0, 3, 11], np.int32)[:S]
    extra = (r.normal(size=(S, T, d + 2 * kv)) * 0.1).astype(np.float32)
    on = np.asarray([1, 0, 1], np.int32)[:S]
    return h, w, offs, extra, on, dict(n_heads=nh, n_kv=n_kv, dh=dh)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "norope"])
@pytest.mark.parametrize("with_extra", [False, True],
                         ids=["base", "lora-extra"])
def test_rope_qkv_matches_jax(rope, with_extra, n_kv):
    """Projection, the masked pre-rotation delta and the per-slot-offset
    rotation agree with the interpreted Pallas kernel and the JAX
    reference, with the weight given in the JAX layout and as the
    transposed view of the port's ``[dtot, d]`` parameter."""
    h, w, offs, extra, on, kw = _case(rope + 2 * with_extra + 4 * n_kv,
                                      n_kv=n_kv)
    e, o = (extra, on) if with_extra else (None, None)
    jargs = [jnp.asarray(a) if a is not None else None
             for a in (h, w, offs, e, o)]
    refs = (jax_rope_qkv(*jargs, rope=rope, interpret=True, **kw),
            jax_rope_qkv_reference(*jargs, rope=rope, **kw))
    w_port = torch.from_numpy(np.ascontiguousarray(w.T)).t()
    for weight in (_t(w), w_port):
        out = fused_rope_qkv(_t(h), weight, _t(offs), _t(e), _t(o),
                             rope=rope, **kw)
        assert [tuple(x.shape) for x in out] == [
            (3, 4, 4, 8), (3, n_kv, 4, 8), (3, n_kv, 4, 8)]
        for ref in refs:
            for a, b in zip(out, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           **QKV_TOL)


def test_rope_qkv_bool_mask_and_no_mask():
    """``on`` as bool equals ``on`` as int32; ``on=None`` applies the delta
    to every lane, as the JAX kernel's all-ones default."""
    h, w, offs, extra, on, kw = _case(11)
    a = fused_rope_qkv(_t(h), _t(w), _t(offs), _t(extra), _t(on), **kw)
    b = fused_rope_qkv(_t(h), _t(w), _t(offs), _t(extra),
                       _t(on).bool(), **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = fused_rope_qkv(_t(h), _t(w), _t(offs), _t(extra), None, **kw)
    ref = jax_rope_qkv(*map(jnp.asarray, (h, w, offs, extra)), None,
                       interpret=True, **kw)
    for x, y in zip(c, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **QKV_TOL)


def test_rope_qkv_bf16_rounds_like_the_unfused_arm():
    """bf16: the plain version rounds the product, the delta sum and the
    rotation where the port's unfused arm rounds them (F.linear in bf16,
    the select, rope_rotate), so the two agree bit for bit."""
    from tpudist_torch.models.transformer import rope_rotate

    h, w, offs, extra, on, kw = _case(12)
    hb, wb, eb = (_t(a).bfloat16() for a in (h, w, extra))
    q, k, v = fused_rope_qkv(hb, wb, _t(offs), eb, _t(on), **kw)
    qkv = torch.nn.functional.linear(hb, wb.t())
    qkv = torch.where(_t(on).bool()[:, None, None], qkv + eb, qkv)
    S, T = h.shape[:2]
    q2 = qkv[..., :32].reshape(S, T, 4, 8).transpose(1, 2)
    v2 = qkv[..., 48:].reshape(S, T, 2, 8).transpose(1, 2)
    assert q.dtype == torch.bfloat16
    assert torch.equal(q, rope_rotate(q2, offset=_t(offs)))
    assert torch.equal(v, v2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("dh", [32, 64, 96, 128])
@pytest.mark.parametrize("M", [1, 8, 40, 64, 65, 512])
def test_rope_arm_by_rows_and_head_dim(M, dh, dtype):
    """bf16 up to ``ROPE_SPLIT_ROWS`` rows (decode's 8, the T 5 verify's
    40, 64) takes the split arm at head dims that hold whole
    ``ROPE_SPLIT_COLS``-column blocks (64, 128); past it (a prefill
    chunk's 512) the wgmma arm at head dims 64 and 128; the mma.sync arm
    at the others (32, 96) whatever the rows; float32 always the f32 arm."""
    arm = _rope_arm(M, dh, 1024, dtype)
    if dtype == torch.float32:
        assert arm == "f32"
    elif dh not in (64, 128):
        assert arm == "mma"
    else:
        assert arm == ("split" if M <= 64 else "wgmma")
    if dtype == torch.bfloat16 and dh in (64, 128):  # too deep to split
        assert _rope_arm(M, dh, 2 * ROPE_SPLIT_MAX_D, dtype) == "wgmma"


def test_rope_constants_match_the_kernel_source():
    """The split arm's rows, cluster size and depth limit, the wgmma arm's
    tile rows, stages and head dims, and the arm codes are the kernel's."""
    import re

    src = (_build.CSRC / "fused_rope_qkv.cu").read_text()
    for name, value in (("kSplitRows", ROPE_SPLIT_ROWS),
                        ("kSplitKS", ROPE_SPLIT_KS),
                        ("kSplitMaxDepth", ROPE_SPLIT_MAX_D),
                        ("kSplitCols", ROPE_SPLIT_COLS),
                        ("kWgRows", ROPE_TILE_ROWS),
                        ("kWgStages", ROPE_STAGES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    codes = dict(re.findall(r"kArm(\w+) = (\d+)",
                            re.search(r"enum Arm[^}]*}", src).group()))
    assert {k.lower(): int(v) for k, v in codes.items()} == {
        arm: i for i, arm in enumerate(ROPE_ARMS)}
    # the wgmma arm: one warpgroup a 64-wide slice of the head
    assert ROPE_WGMMA_HEAD_DIMS == (64, 128)
    assert "if (dh == 64) TPD_ROPE_WGMMA(1)" in src
    assert "TPD_ROPE_WGMMA(2)" in src


@pytest.mark.parametrize("n_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("rope", [True, False], ids=["rope", "norope"])
@pytest.mark.parametrize("with_extra", [False, True],
                         ids=["base", "lora-extra"])
@pytest.mark.parametrize("T", [1, 5], ids=["decode", "verify"])
def test_rope_split_model_matches_jax(T, with_extra, rope, n_kv):
    """The split arm's sum (``ROPE_SPLIT_KS`` depth slices of 32 at d 256,
    f32 partials summed in rank order) against the interpreted Pallas
    kernel and the JAX reference at decode (T 1) and the speculative
    verify's T 5, at ``QKV_TOL``.  h and w lie on dyadic grids (steps 1/8
    and 1/256), so every product and every partial or total sum over the
    depth is exact in f32 whatever its order: the comparison holds the
    slicing (each slice summed once), the rounding, the delta and the
    rotation, not the order of 256 f32 additions, which alone moves
    unit-scale outputs by ~1e-6."""
    h, w, offs, extra, on, kw = _case(30 + T + 2 * with_extra + 4 * rope
                                      + 8 * n_kv, T=T, nh=4, n_kv=n_kv,
                                      dh=64)
    h, w = np.round(h * 8) / 8, np.round(w * 256) / 256
    e, o = (extra, on) if with_extra else (None, None)
    jargs = [jnp.asarray(a) if a is not None else None
             for a in (h, w, offs, e, o)]
    refs = (jax_rope_qkv(*jargs, rope=rope, interpret=True, **kw),
            jax_rope_qkv_reference(*jargs, rope=rope, **kw))
    out = _rope_qkv_split_reference(_t(h), _t(w), _t(offs), _t(e), _t(o),
                                    rope=rope, **kw)
    assert [tuple(x.shape) for x in out] == [
        (3, 4, T, 64), (3, n_kv, T, 64), (3, n_kv, T, 64)]
    for ref in refs:
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **QKV_TOL)


def test_rope_split_model_slices_the_depth_as_the_kernel():
    """At d 64 (four 16-deep steps) only the first four of the eight ranks
    hold a step; the model equals the plain version's f32 product there and
    at d 256 (on the dyadic grids of the test above: exact sums), and
    refuses a depth the kernel's steps do not cut."""
    for d in (64, 256):
        h, w, offs, extra, on, kw = _case(40 + d, nh=d // 64, n_kv=d // 64,
                                          dh=64)
        h, w = np.round(h * 8) / 8, np.round(w * 256) / 256
        out = _rope_qkv_split_reference(_t(h), _t(w), _t(offs), _t(extra),
                                        _t(on), **kw)
        ref = fused_rope_qkv_reference(_t(h), _t(w), _t(offs), _t(extra),
                                       _t(on), **kw)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, **QKV_TOL)
    with pytest.raises(ValueError, match="16-deep"):
        _rope_qkv_split_reference(torch.zeros(1, 1, 40), torch.zeros(40, 24),
                                  torch.zeros(1, dtype=torch.int32),
                                  n_heads=1, n_kv=1, dh=8)


def test_rope_forced_arm_must_fit_the_shapes():
    """Forcing an arm the shapes or the dtype do not fit raises before
    anything launches: the split arm past ``ROPE_SPLIT_ROWS`` rows or at
    head dim 32, the wgmma arm at head dim 32, a bf16 arm on float32 and
    back, an unknown arm."""
    def args(S, T, dh, dtype):
        h = torch.zeros(S, T, 4 * dh, dtype=dtype)
        return (h, torch.zeros(4 * dh, 12 * dh, dtype=dtype),
                torch.zeros(S, dtype=torch.int32))

    for arm, a in (("split", args(5, 13, 64, torch.bfloat16)),
                   ("split", args(8, 1, 32, torch.bfloat16)),
                   ("wgmma", args(3, 64, 32, torch.bfloat16)),
                   ("mma", args(1, 1, 64, torch.float32)),
                   ("split", args(1, 1, 64, torch.float32)),
                   ("f32", args(1, 1, 64, torch.bfloat16)),
                   ("tiled", args(1, 1, 64, torch.bfloat16))):
        dh = a[0].shape[-1] // 4
        with pytest.raises(ValueError, match="arm"):
            _launch_rope(arm, *a, n_heads=4, n_kv=4, dh=dh)


@pytest.mark.parametrize("ids", [[0, 5, 3], [5, 5, 5], [4, 0, 4]],
                         ids=["mixed", "all-sentinel", "repeat"])
def test_lora_delta_matches_jax_every_layer(ids):
    """The gather-matmul against the interpreted Pallas kernel and the JAX
    reference on every layer, sentinel ids (B = 5) clamping to block 4."""
    h = _case(5)[0]
    r = np.random.default_rng(6)
    L, B, rank, dout = 2, 5, 2, 12
    pa = r.normal(size=(L, B, 32, rank)).astype(np.float32)
    pb = r.normal(size=(L, B, rank, dout)).astype(np.float32)
    ids = np.asarray(ids, np.int32)
    for layer in range(L):
        out = lora_delta(_t(h), _t(pa), _t(pb), _t(ids), layer=layer)
        assert out.shape == (3, 4, dout) and out.dtype == torch.float32
        for ref in (jax_lora_delta(*map(jnp.asarray, (h, pa, pb, ids)),
                                   layer=layer, interpret=True),
                    jax_lora_delta_reference(*map(jnp.asarray,
                                                  (h, pa, pb, ids)),
                                             layer=layer)):
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       **LORA_TOL)
    # a sentinel lane reads the clamped block: it equals a lane bound to
    # block B - 1 exactly
    clamped = lora_delta(_t(h), _t(pa), _t(pb),
                         _t(np.minimum(ids, B - 1)), layer=1)
    assert torch.equal(clamped, lora_delta(_t(h), _t(pa), _t(pb), _t(ids),
                                           layer=1))


@pytest.mark.parametrize("T", [1, 5, 8, 9])
def test_lora_delta_rows_across_the_arms_match_jax(T):
    """The decode step (T 1), the speculative verify (T 5), the cluster
    arm's last T (8) and the first T past it (9): the port's CPU path
    against the interpreted Pallas kernel and the JAX reference, as the arm
    the CUDA wrapper would take for that T."""
    r = np.random.default_rng(20 + T)
    S, L, B, rank, d_in, d_out = 3, 2, 5, 2, 32, 12  # LORA_TOL's shapes
    h = r.normal(size=(S, T, d_in)).astype(np.float32)
    pa = r.normal(size=(L, B, d_in, rank)).astype(np.float32)
    pb = r.normal(size=(L, B, rank, d_out)).astype(np.float32)
    ids = np.asarray([2, 5, 0], np.int32)
    assert _lora_arm(T) == ("cluster" if T <= 8 else "staged")
    out = lora_delta(_t(h), _t(pa), _t(pb), _t(ids), layer=1)
    assert out.shape == (S, T, d_out)
    for ref in (jax_lora_delta(*map(jnp.asarray, (h, pa, pb, ids)),
                               layer=1, interpret=True),
                jax_lora_delta_reference(*map(jnp.asarray,
                                              (h, pa, pb, ids)), layer=1)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LORA_TOL)


def test_lora_arm_by_rows():
    """Up to ``LORA_DECODE_ROWS`` rows a slot (decode, the draft steps,
    the verify's K + 1 at K up to 7) the cluster arm, past it (the
    prefill chunk) the staged kernel; forcing the cluster arm past it
    raises before anything launches."""
    assert [_lora_arm(T) for T in (1, 2, 5, 8)] == ["cluster"] * 4
    assert [_lora_arm(T) for T in (9, 16, 64)] == ["staged"] * 3
    x = torch.zeros(2, 9, 32)
    pa, pb = torch.zeros(1, 2, 32, 4), torch.zeros(1, 2, 4, 6)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="arm"):
        _launch_lora("cluster", x, pa, pb, ids, 0)
    with pytest.raises(ValueError, match="arm"):
        _launch_lora("split", x[:, :1], pa, pb, ids, 0)


def test_lora_constants_match_the_kernel_source():
    """The decode rows, the cluster size (8, the portable maximum) and the
    instantiated ranks are the kernel's."""
    import re

    src = (_build.CSRC / "lora_delta.cu").read_text()
    assert re.search(rf"constexpr int kDecodeRows = {LORA_DECODE_ROWS};",
                     src)
    assert re.search(r"constexpr int kCluster = 8;", src)
    assert tuple(int(r) for r in re.findall(r"TPD_LORA\((\d+)\)\n",
                                            src)) == LORA_RANKS


def test_lora_delta_bf16_rounds_factors_and_intermediate():
    """bf16: the factors round as they load and the [T, r] intermediate
    rounds before the second product."""
    h = torch.from_numpy(_case(7)[0]).bfloat16()
    r = np.random.default_rng(8)
    pa = torch.from_numpy(r.normal(size=(1, 2, 32, 4)).astype(np.float32))
    pb = torch.from_numpy(r.normal(size=(1, 2, 4, 6)).astype(np.float32))
    ids = torch.tensor([1, 0, 2], dtype=torch.int32)
    out = lora_delta(h, pa, pb, ids, layer=0)
    rows = torch.tensor([1, 0, 1])
    mid = torch.bmm(h, pa[0][rows].bfloat16())
    assert mid.dtype == torch.bfloat16
    assert torch.equal(out, torch.bmm(mid, pb[0][rows].bfloat16()))


def test_cpu_wrappers_count_nothing_and_check_shapes():
    """CPU tensors take the plain versions (no launch counted); shapes are
    checked before either path, and another device raises."""
    h, w, offs, extra, on, kw = _case(3)
    reset_launch_counts()
    fused_rope_qkv(_t(h), _t(w), _t(offs), **kw)
    fused_rope_qkv_reference(_t(h), _t(w), _t(offs), **kw)
    pa, pb = torch.zeros(1, 2, 32, 4), torch.zeros(1, 2, 4, 6)
    ids = torch.zeros(3, dtype=torch.int32)
    lora_delta(_t(h), pa, pb, ids, layer=0)
    lora_delta_reference(_t(h), pa, pb, ids, layer=0)
    counts = launch_counts()
    assert counts["fused_rope_qkv"] == counts["lora_delta"] == 0
    with pytest.raises(ValueError, match="does not match"):
        fused_rope_qkv(_t(h), _t(w)[:, :-1], _t(offs), **kw)
    with pytest.raises(ValueError):
        fused_rope_qkv(_t(h), _t(w), _t(offs), _t(extra)[:, :2], **kw)
    with pytest.raises(ValueError, match="out of range"):
        lora_delta(_t(h), pa, pb, ids, layer=1)
    with pytest.raises(ValueError):
        lora_delta(_t(h), pa, pb, ids[:2], layer=0)
    with pytest.raises(ValueError):
        fused_rope_qkv(*(t.to("meta") for t in (_t(h), _t(w), _t(offs))),
                       **kw)
    with pytest.raises(ValueError):
        lora_delta(_t(h).to("meta"), pa.to("meta"), pb.to("meta"),
                   ids.to("meta"), layer=0)
