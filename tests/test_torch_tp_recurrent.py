"""The tensor-parallel recurrent blocks (``rglru_block_tp``,
``rwkv_time_mix_chunked_tp``, ``rwkv_channel_mix_tp``) and the hybrid's
windowed ``attention_tp`` against the reference's ``rglru_block``,
``rwkv_time_mix_chunked``, ``rwkv_channel_mix`` and windowed
``attention``, on the CPU, at smoke size in float32.

The same numpy-seeded weights, inputs and output cotangents go through
the reference's function (``jax.vjp``) and the port's on 2 and 4 model
ranks (``distributed.tp.Group`` on a mesh naming the CPU ``R`` times;
each weight split as ``registry.tp_weight_splits`` splits it), with the
sequence over the ranks (``bsd`` sequence parallel) and without. The
output, the input's gradient and every weight's gradient (the ranks'
pieces joined) are held within 1e-5 of the reference's largest
magnitude (the sums over ranks add in another order, and the port's
RG-LRU scan associates its products otherwise than
``jax.lax.associative_scan``). Every activation the port places has the
layout ``constraint_spec`` asks for. The cases the layouts fall back
in: the SSM's 8 heads on 16 ranks (the time mix whole on every rank,
``bhsd`` replicated, where the storage's column split would cut a
head), and the hybrid's local attention with heads the ranks do not
divide (the query rows over the ranks, rows starting mid-sequence,
past the 64-token window). Whole steps against the reference's jitted
step (``lm_family_checks.check_sharded_against_reference``, tolerances
in ``tests/test_torch_train_sharded.py``'s docstring): the SSM's
head-cutting case and the hybrid's query-row fallback. A hybrid with a
tail (``n_layers=7``: two supers and one tail layer): ``lm_loss_tp``'s
loss and gradients against the reference's ``lm_loss`` (rtol 1e-5,
1e-4 of a leaf's largest gradient).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_family_checks as F
from lm_family_checks import one_torch_thread  # noqa: F401 — autouse
from repro.configs import get_config as jax_get_config
from repro.models import attention as JA
from repro.models import rglru as JG
from repro.models import rwkv6 as JW
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.data import make_pipeline
from repro_torch.distributed import ctx, tp
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention as PA
from repro_torch.models import rglru as PG
from repro_torch.models import rwkv6 as PW
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import tp_weight_splits

TOL = 1e-5
SEQ, BATCH = 128, 2          # past the hybrid's window, two RWKV chunks


def configs(arch, **over):
    cj = dataclasses.replace(jax_get_config(arch, smoke=True),
                             dtype=jnp.float32, **over)
    ct = dataclasses.replace(get_config(arch, smoke=True),
                             dtype=torch.float32, **over)
    return cj, ct


def group_of(ranks, seq_parallel=True):
    return tp.Group(make_host_mesh(ranks, devices=["cpu"] * ranks),
                    seq_parallel=seq_parallel)


def weights(shapes, seed):
    """numpy-seeded float32 weights ``{name: (shape, scale)}``."""
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * scale).astype(np.float32)
            for n, (s, scale) in shapes.items()}


def randn(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def check_layouts(group):
    """Every placed activation has ``constraint_spec``'s model dim;
    returns the (kind, dim) pairs."""
    assert group.layouts
    with ctx.activation_sharding(group.mesh,
                                 seq_parallel=group.seq_parallel):
        for kind, shape, dim in group.layouts:
            spec = ctx.constraint_spec(shape, kind)
            want = next((i for i, e in enumerate(spec) if e == "model"),
                        None)
            assert dim == want, (kind, shape, dim, spec)
    return {(k, d) for k, _, d in group.layouts}


def run_both(jfn, tfn, whole, x, gy, prefix, group):
    """``jfn(params, x)`` under ``jax.vjp`` and ``tfn(params, x)`` with
    its leaves split as ``tp_weight_splits`` splits them (``tfn.cfg``'s),
    both with the cotangent ``gy``: the output, ``x``'s gradient and each
    weight's (the ranks' pieces joined) held by ``close``. Returns the
    splits."""
    b, s = x.shape[:2]
    splits = tp_weight_splits(tfn.cfg, [prefix + n for n in whole], group,
                              b, s)
    jp = {n: jnp.asarray(w) for n, w in whole.items()}
    want, vjp = jax.vjp(jfn, jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(gy))
    tparams = {}
    for n, w in whole.items():
        dim = splits[prefix + n]
        t = torch.from_numpy(w)
        tparams[n] = (t if dim is None else tp.split_ranks(t, dim,
                                                           group.size)
                      ).clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(type("P", (), tparams), xt)
    (got * torch.from_numpy(gy)).sum().backward()
    pairs = [("out", got, want), ("dx", xt.grad, jgx)]
    for n, p in tparams.items():
        dim = splits[prefix + n]
        g = p.grad if dim is None else tp.merge_ranks(p.grad, dim)
        pairs.append((n, g, jgp[n]))
    for what, a, b_ in pairs:
        close(a, b_, what)
    return splits


def in_layout(fn, group, shape):
    """``fn`` of a residual-layout input on a whole input and output."""
    def run(params, x):
        if group.seq_split(shape):
            x = tp.split_ranks(x, 1, group.size)
        y = fn(params, x)
        return tp.merge_ranks(y, 1) if group.seq_split(shape) else y
    return run


# ------------------------------------------------------------------ RG-LRU
@pytest.mark.parametrize("ranks,sp", [(2, True), (4, True), (4, False),
                                      (3, True)])
def test_rglru_block_tp_is_the_references(ranks, sp):
    """256 channels split 128 or 64 a rank; on 3 ranks, which divide
    neither the width nor the sequence, the block runs once, whole."""
    cj, ct = configs("recurrentgemma-2b")
    d, w = ct.d_model, ct.rnn_width
    whole = weights({"w_in": ((d, w), 0.05), "w_gate_in": ((d, w), 0.05),
                     "conv_k": ((4, w), 0.2), "w_r": ((w, w), 0.05),
                     "w_i": ((w, w), 0.05), "lam": ((w,), 1.0),
                     "w_out": ((w, d), 0.05)}, 1)
    x, gy = randn((BATCH, SEQ, d), 2), randn((BATCH, SEQ, d), 3)
    g = group_of(ranks, sp)
    shape = x.shape
    st = JG.RglruState(h=jnp.zeros((BATCH, w), jnp.float32),
                       conv=jnp.zeros((BATCH, 3, w), jnp.float32))

    def tfn(p, xt):
        return in_layout(lambda p, x: PG.rglru_block_tp(p, x, ct, g, shape),
                         g, shape)(p, xt)
    tfn.cfg = ct
    splits = run_both(lambda p, x: JG.rglru_block(p, x, cj, st)[0], tfn,
                      whole, x, gy, "supers.0.r0.rglru.", g)
    if ranks == 3:
        assert set(splits.values()) == {None}
        assert set(g.traffic.values()) == {0}
        return
    assert {n.rsplit(".", 1)[1]: v for n, v in splits.items()} == {
        "w_in": 1, "w_gate_in": 1, "conv_k": 1, "w_r": 1, "w_i": 1,
        "lam": 0, "w_out": 0}
    n = (ranks - 1) * BATCH * SEQ * d * 4
    nw = (ranks - 1) * BATCH * SEQ * w * 4
    # u's channels all-gathered (backward: reduce-scattered); the input
    # gathered over the sequence and the partial sums reduce-scattered
    # onto it, or, the sequence whole, the input's gradient and the
    # partial sums all-reduced
    assert g.traffic == ({"all_gather": 2 * n + nw,
                          "reduce_scatter": 2 * n + nw, "all_reduce": 0}
                         if sp else {"all_gather": nw, "reduce_scatter": nw,
                                     "all_reduce": 2 * 2 * n})


# ------------------------------------------------------------------ RWKV-6
def _time_mix_weights(ct):
    d = ct.d_model
    return weights({**{f"mix_{c}": ((d,), 0.5) for c in "rkvw"},
                    **{f"w{c}": ((d, d), 0.05) for c in "rkvo"},
                    "w_lora_a": ((d, 64), 0.05), "w_lora_b": ((64, d), 0.05),
                    "w_bias": ((d,), 0.5), "u_bonus": ((d,), 0.5)}, 4)


@pytest.mark.parametrize("ranks,heads_split", [(2, True), (4, True),
                                               (16, False)])
def test_time_mix_tp_is_the_references(ranks, heads_split):
    """8 heads of 32: split 4, 2 a rank on 2 and 4 ranks; on 16 the
    storage's column split would cut every head in two, so the time mix
    runs whole on every rank (``bhsd`` replicated)."""
    cj, ct = configs("rwkv6-7b")
    d, dh = ct.d_model, ct.rwkv_head_dim
    whole = _time_mix_weights(ct)
    x, gy = randn((BATCH, SEQ, d), 5), randn((BATCH, SEQ, d), 6)
    g = group_of(ranks)
    st = JW.RwkvState(s=jnp.zeros((BATCH, d // dh, dh, dh), jnp.float32),
                      x_prev=jnp.zeros((BATCH, d), jnp.float32))

    def tfn(p, xt):
        return PW.rwkv_time_mix_chunked_tp(p, xt, ct, g)
    tfn.cfg = ct
    splits = run_both(
        lambda p, x: JW.rwkv_time_mix_chunked(p, x, cj, st)[0], tfn, whole,
        x, gy, "layers.0.tm.", g)
    dims = {n.rsplit(".", 1)[1]: v for n, v in splits.items()}
    want = {"wr": 1, "wk": 1, "wv": 1, "wo": 0} if heads_split else {}
    assert {n: v for n, v in dims.items() if v is not None} == want
    assert check_layouts(g) == {("bhsd", 1 if heads_split else None)}
    if heads_split:           # the wo partial sums' float32 all-reduce
        assert g.traffic["all_reduce"] > 0
    else:
        assert g.traffic == {"all_gather": 0, "reduce_scatter": 0,
                             "all_reduce": 0}


@pytest.mark.parametrize("ranks,d_ff,want", [
    (2, 512, {"wk": 1, "wv": 0, "wr": 1}),
    (4, 512, {"wk": 1, "wv": 0, "wr": 1}),
    (4, 510, {}), (3, 513, {})])
def test_channel_mix_tp_is_the_references(ranks, d_ff, want):
    """``wk`` column- and ``wv`` row-parallel over ``d_ff``, ``wr``
    column-parallel; ``r * (k @ wv)`` on channels (reduce-scatter,
    product, all-gather). Where the ranks do not divide both ``d`` and
    ``d_ff`` (``d_ff`` 510 on 4, ``d`` 256 on 3) the block is whole on
    every rank and moves nothing."""
    cj, ct = configs("rwkv6-7b", d_ff=d_ff)
    d, f = ct.d_model, ct.d_ff
    whole = weights({"mix_k": ((d,), 0.5), "mix_r": ((d,), 0.5),
                     "wk": ((d, f), 0.05), "wv": ((f, d), 0.05),
                     "wr": ((d, d), 0.05)}, 7)
    x, gy = randn((BATCH, SEQ, d), 8), randn((BATCH, SEQ, d), 9)
    g = group_of(ranks)

    def tfn(p, xt):
        return PW.rwkv_channel_mix_tp(p, xt, g)
    tfn.cfg = ct
    splits = run_both(
        lambda p, x: JW.rwkv_channel_mix(
            p, x, jnp.zeros((BATCH, d), jnp.float32))[0],
        tfn, whole, x, gy, "layers.0.cm.", g)
    assert {n.rsplit(".", 1)[1]: v for n, v in splits.items()
            if v is not None} == want
    if not want:
        assert g.traffic == {"all_gather": 0, "reduce_scatter": 0,
                             "all_reduce": 0}
        return
    n = (ranks - 1) * BATCH * SEQ * d * 4
    # forward: the reduce-scatter and the all-gather of the product;
    # backward: the reduce-scatter's all-gather (the all-gather's is each
    # rank taking its part), and the all-reduces of the two mixed inputs'
    # gradients
    assert g.traffic == {"all_gather": 2 * n, "reduce_scatter": n,
                         "all_reduce": 2 * 2 * n}


# -------------------------------------------------- the hybrid's attention
@pytest.mark.parametrize("ranks,over,q_dim", [
    (2, {}, 2), (4, {"n_heads": 6}, 1)])
def test_windowed_attention_tp_is_the_references(ranks, over, q_dim):
    """The hybrid's local attention (MQA, window 64) over 128 tokens: 4
    heads split 2 and 2 on 2 ranks; 6 heads on 4 ranks take the query
    rows, each rank's rows from its own start, its window measured from
    each query's position."""
    cj, ct = configs("recurrentgemma-2b", **over)
    d, hq, hkv, dh = ct.d_model, ct.n_heads, ct.n_kv_heads, ct.head_dim
    whole = weights({"wq": ((d, hq * dh), 0.05), "wk": ((d, hkv * dh), 0.05),
                     "wv": ((d, hkv * dh), 0.05),
                     "wo": ((hq * dh, d), 0.05)}, 10)
    x, gy = randn((BATCH, SEQ, d), 11), randn((BATCH, SEQ, d), 12)
    g = group_of(ranks)
    shape = x.shape
    pos = torch.arange(SEQ)

    def tfn(p, xt):
        return in_layout(lambda p, x: PA.attention_tp(
            p, x, ct, g, q_pos=pos, causal=True, window=ct.window),
            g, shape)(p, xt)
    tfn.cfg = ct
    run_both(lambda p, x: JA.attention(p, x, cj, jnp.arange(SEQ),
                                       window=cj.window),
             tfn, whole, x, gy, "supers.0.attn.attn.", g)
    assert ct.window < SEQ
    assert {("bshd", q_dim), ("bshd_kv", None)} <= check_layouts(g)


# ------------------------------------------------------- the whole models
@pytest.mark.parametrize("mp", [2, 4])
def test_hybrid_with_a_tail_matches_the_references_loss(mp):
    """Two supers and a tail layer (``n_layers=7``, the full model's end):
    ``lm_loss_tp`` on a (1, mp) mesh's model ranks against the
    reference's ``lm_loss`` and its gradient, on the reference's weights
    and one batch of 4 x 128 tokens: the loss within rtol 1e-5 and every
    gradient within 1e-4 of its leaf's largest (``grads_close``)."""
    cj, ct = F.train_configs("recurrentgemma-2b", n_layers=7)
    pj, tree = F.reference_weights(cj)
    batch = make_pipeline(ct, SEQ, 4, device="cpu").batch(0)
    want, jg = jax.value_and_grad(JT.lm_loss)(
        pj, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, cj)
    mesh = F.mesh_of(1, mp)
    model = F.sharded(params_from_numpy(ct, tree, device="cpu"), mesh)
    group = tp.Group(mesh)
    splits = tp_weight_splits(ct, model.layouts, group, 4, SEQ)
    module = model.tp_module_on("cpu", splits)
    names, plist = zip(*module.named_parameters())
    for p in plist:
        p.requires_grad_(True)
    got = PT.lm_loss_tp(module, batch, ct, group)
    grads = torch.autograd.grad(got, plist)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    F.grads_close(jax.tree.map(np.asarray, jg), {
        n: g if splits[n] is None else tp.merge_ranks(g, splits[n])
        for n, g in zip(names, grads)}, f"(1, {mp})")
    assert len(module.tail) == 1
    assert splits["tail.0.rglru.w_in"] == 1 and splits["tail.0.ffn.w_down"] == 0
    check_layouts(group)


@pytest.mark.parametrize("arch,mp,over,kinds", [
    ("rwkv6-7b", 16, {},
     {("bsd", 1), ("bsd_batch_only", None), ("bhsd", None),
      ("logits_v", 2)}),
    ("recurrentgemma-2b", 4, {"n_heads": 6},
     {("bsd", 1), ("bshd", 1), ("bshd_kv", None), ("logits_v", 2)})])
def test_recurrent_fallback_steps_match_reference(arch, mp, over, kinds):
    """The SSM's head-cutting case on (1, 16) and the hybrid's query-row
    fallback on (1, 4): each step against the reference's jitted step
    from its state, the weights after it bit for bit the whole-leaf
    AdamW step on its own gradients (``own_update``)."""
    model = F.check_sharded_against_reference(arch, 1, mp, seq=SEQ,
                                              own_update=True, **over)
    group = model.last_step["group"]
    assert group is not None
    assert {(k, d) for k, _, d in group.layouts} == kinds
