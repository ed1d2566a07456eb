"""Tensor- and expert-parallel compute on the ``"model"`` axis
(``repro_torch.distributed.tp``, the models' ``*_tp`` functions), on the
CPU, at smoke size in float32.

* Each collective's forward and backward equal their whole-tensor
  counterparts bit for bit (the sums over ranks in rank order, in
  float32), and count the bytes a ring moves.
* ``attention_tp``, ``mlp_tp``, ``moe_tp``, ``embed_tp`` and
  ``lm_head_loss_tp`` on 2, 4, 8 and 16 model ranks equal the unsharded
  ``attention`` (plain route), ``mlp``, ``moe`` (one routing group),
  embedding and ``cross_entropy_loss``: outputs and every gradient
  within 1e-5 of the largest magnitude (the sums over ranks add in
  another order), in every layout ``constraint_spec`` names: heads,
  the query-row fallback, replicated K/V, sequence parallelism on and
  off, a sequence the ranks do not divide, the vocabulary over the
  ranks or the sequence-sharded logits. Every activation they place has
  the layout ``constraint_spec`` asks for.
* Each expert runs on exactly the model rank ``ecd`` names.
* ``Sharded.gather_ranks`` and ``reduce_into`` with splits equal the
  whole-leaf gather and reduction, bit for bit, on one device and on
  distinct ones.
"""

import dataclasses

import pytest
import torch

from lm_family_checks import one_torch_thread  # noqa: F401 — autouse
from repro_torch.configs import get_config
from repro_torch.distributed import ctx, spmd, tp
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention as PA
from repro_torch.models import common as PCm
from repro_torch.models import mlp as PMl
from repro_torch.models import moe as PM
from repro_torch.models.common import normal_
from repro_torch.models.registry import tp_weight_splits

TOL = 1e-5


def group_of(mp, dp=1, seq_parallel=True):
    return tp.Group(make_host_mesh(mp, devices=["cpu"] * (dp * mp)),
                    seq_parallel=seq_parallel)


def config(arch="llama3.2-3b", **over):
    return dataclasses.replace(get_config(arch, smoke=True),
                               dtype=torch.float32, **over)


def randn(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def close(got, want, what=""):
    got, want = got.detach(), want.detach()
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max())
    assert err <= TOL * scale, (what, err, scale)


def to_layout(x, group, shape):
    """A whole residual in the residual's layout."""
    return tp.split_ranks(x, 1, group.size) if group.seq_split(shape) else x


def from_layout(y, group, shape):
    return tp.merge_ranks(y, 1) if group.seq_split(shape) else y


# ------------------------------------------------------------ collectives
def _sum(t):
    acc = t[0].float().clone()
    for r in range(1, t.shape[0]):
        acc.add_(t[r])
    return acc.to(t.dtype)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_collectives_are_their_whole_tensor_counterparts(ranks, dtype):
    """Forward and backward of each collective against the whole-tensor
    computation it stands for, bit for bit, and its bytes."""
    g = group_of(ranks)
    part = randn(ranks, 3, 2, 5).to(dtype).requires_grad_(True)
    whole = torch.cat(list(part.detach()), dim=1)           # (3, 2R, 5)
    partial = randn(ranks, 3, 2 * ranks, 5, seed=1).to(dtype)
    n = whole.numel() * whole.element_size()

    def run(fn, x, grad_seed):
        x = x.detach().clone().requires_grad_(True)
        y = fn(x)
        gy = randn(*y.shape, seed=grad_seed).to(dtype)
        (gx,) = torch.autograd.grad(y, x, gy)
        return y, gy, gx

    before = dict(g.traffic)
    y, gy, gx = run(lambda x: tp.gather_to_ranks(x, g, 1), part, 2)
    assert all(torch.equal(y[r], whole) for r in range(ranks))
    assert torch.equal(gx, tp.split_ranks(_sum(gy), 1, ranks))
    y, gy, gx = run(lambda x: tp.scatter_sum(x, g, 1), partial, 3)
    assert torch.equal(y, tp.split_ranks(_sum(partial), 1, ranks))
    assert all(torch.equal(gx[r], torch.cat(list(gy), 1))
               for r in range(ranks))
    y, gy, gx = run(lambda x: tp.reduce_from_ranks(x, g), partial, 4)
    assert torch.equal(y, _sum(partial))
    assert all(torch.equal(gx[r], gy) for r in range(ranks))
    y, gy, gx = run(lambda x: tp.copy_to_ranks(x, g), whole, 5)
    assert all(torch.equal(y[r], whole) for r in range(ranks))
    assert torch.equal(gx, _sum(gy))
    y, gy, gx = run(lambda x: tp.split_to_ranks(x, g, 1), whole, 6)
    assert torch.equal(torch.cat(list(y), 1), whole)
    assert torch.equal(gx, torch.cat(list(gy), 1))
    y, gy, gx = run(lambda x: tp.gather_from_ranks(x, g, 1), part, 7)
    assert torch.equal(y, whole)
    assert torch.equal(gx, tp.split_ranks(gy, 1, ranks))
    assert torch.equal(tp.max_from_ranks(partial, g), partial.amax(0))
    moved = {k: g.traffic[k] - before[k] for k in g.traffic}
    # all-gathers: gather_to_ranks, scatter_sum's backward, split's
    # backward, gather_from_ranks; reduce-scatters: scatter_sum,
    # gather_to_ranks' backward; all-reduces: reduce_from_ranks,
    # copy_to_ranks' backward (each 2 (R - 1) N) and the maximum
    assert moved == {"all_gather": 4 * (ranks - 1) * n,
                     "reduce_scatter": 2 * (ranks - 1) * n,
                     "all_reduce": 3 * 2 * (ranks - 1) * n}


def test_ranked_matmul_is_each_ranks_product():
    x, w = randn(4, 2, 3, 8), randn(4, 8, 5, seed=1)
    want = torch.stack([x[r] @ w[r] for r in range(4)])
    close(tp.ranked_matmul(x, w), want)
    close(tp.ranked_matmul(x[:1].expand(4, 2, 3, 8), w),
          torch.stack([x[0] @ w[r] for r in range(4)]))


# ----------------------------------------------------------------- modules
def _params(module_cls, cfg, seed):
    mod = module_cls(cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for p in mod.parameters():
        normal_(p, gen, 0.2)
    return {n: p.detach().clone() for n, p in mod.named_parameters()}


def _tp_params(whole, splits, prefix, ranks):
    out = {}
    for n, w in whole.items():
        dim = splits[prefix + n]
        t = w if dim is None else tp.split_ranks(w, dim, ranks)
        out[n] = t.clone().requires_grad_(True)
    return out


def _merged_grads(tparams, splits, prefix):
    return {n: p.grad if splits[prefix + n] is None
            else tp.merge_ranks(p.grad, splits[prefix + n])
            for n, p in tparams.items()}


def _check_layouts(group):
    """Every placed activation has ``constraint_spec``'s model dim."""
    assert group.layouts
    with ctx.activation_sharding(group.mesh,
                                 seq_parallel=group.seq_parallel):
        for kind, shape, dim in group.layouts:
            spec = ctx.constraint_spec(shape, kind)
            want = next((i for i, e in enumerate(spec) if e == "model"),
                        None)
            assert dim == want, (kind, shape, dim, spec)
    return {(k, d) for k, _, d in group.layouts}


# (ranks, seq, seq_parallel, config overrides, q layout, kv layout)
ATTENTION_CASES = {
    "heads": (2, 16, True, {}, 2, 2),
    "kv_replicated": (4, 16, True, {}, 2, None),
    "query_rows": (4, 16, True, {"n_heads": 6, "n_kv_heads": 2}, 1, None),
    "query_rows_no_sp": (4, 16, False, {"n_heads": 6, "n_kv_heads": 2}, 1,
                         None),
    "replicated": (8, 12, True, {}, None, None),
    "heads_16": (16, 32, True, {"n_heads": 16, "n_kv_heads": 16}, 2, 2),
}


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
@pytest.mark.parametrize("causal", [True, False])
def test_attention_tp_is_attention(case, causal):
    ranks, s, sp, over, q_dim, kv_dim = ATTENTION_CASES[case]
    cfg = config(**over)
    g = group_of(ranks, seq_parallel=sp)
    b, d = 2, cfg.d_model
    shape = (b, s, d)
    whole = _params(PA.Attention, cfg, 1)
    splits = tp_weight_splits(cfg, ["layers.0.attn." + n for n in whole],
                              g, b, s)
    tparams = _tp_params(whole, splits, "layers.0.attn.", ranks)
    x = randn(b, s, d, seed=2)
    pos = torch.arange(s)
    gy = randn(b, s, d, seed=3)

    wparams = {n: w.clone().requires_grad_(True) for n, w in whole.items()}
    xw = x.clone().requires_grad_(True)
    if causal:
        want = PA.attention(type("A", (), wparams), xw, cfg, pos,
                            backend="plain")
    else:
        q, k, v = (xw @ wparams["wq"], xw @ wparams["wk"],
                   xw @ wparams["wv"])
        q = PCm.rope(q.view(b, s, cfg.n_heads, -1), pos, cfg.rope_theta)
        k = PCm.rope(k.view(b, s, cfg.n_kv_heads, -1), pos, cfg.rope_theta)
        v = v.view(b, s, cfg.n_kv_heads, -1)
        out = PA.mha_attend(*(t.transpose(1, 2) for t in (q, k, v)),
                            causal=False, backend="plain")
        want = out.transpose(1, 2).reshape(b, s, -1) @ wparams["wo"]
    (want * gy).sum().backward()

    xt = x.clone().requires_grad_(True)
    got = PA.attention_tp(type("A", (), tparams), to_layout(xt, g, shape),
                          cfg, g, q_pos=pos, causal=causal)
    got = from_layout(got, g, shape)
    (got * gy).sum().backward()
    close(got, want, "out")
    close(xt.grad, xw.grad, "dx")
    for n, gw in _merged_grads(tparams, splits, "layers.0.attn.").items():
        close(gw, wparams[n].grad, n)
    kinds = _check_layouts(g)
    assert ("bshd", q_dim) in kinds and ("bshd_kv", kv_dim) in kinds


@pytest.mark.parametrize("case,split", [("heads", None),
                                        ("query_rows", 1)])
def test_attention_tp_refuses_weights_the_layout_does_not_take(case, split):
    """The weights' shape (``tp_weight_splits``) decides the heads'
    split; where it disagrees with ``bshd``'s layout the first placed
    activation says so: whole weights where the heads divide, weights
    split by heads in the query-row fallback."""
    ranks, s, sp, over, _, _ = ATTENTION_CASES[case]
    cfg = config(**over)
    g = group_of(ranks, seq_parallel=sp)
    shape = (2, s, cfg.d_model)
    whole = _params(PA.Attention, cfg, 1)
    splits = {"layers.0.attn." + n: (split if n != "wo" else 0)
              if split is not None and n in ("wq", "wo") else None
              for n in whole}
    tparams = _tp_params(whole, splits, "layers.0.attn.", ranks)
    with pytest.raises(ValueError, match="bshd"):
        PA.attention_tp(type("A", (), tparams),
                        to_layout(randn(*shape, seed=2), g, shape), cfg, g,
                        q_pos=torch.arange(s), causal=True)


@pytest.mark.parametrize("ranks,sp", [(2, True), (4, False)])
def test_cross_attention_tp_is_attention(ranks, sp):
    """Queries of one length over keys and values of another (the
    enc-dec model's cross-attention), non-causal."""
    cfg = config("seamless-m4t-large-v2")
    g = group_of(ranks, seq_parallel=sp)
    b, d, sq, skv = 2, cfg.d_model, 8, 12
    whole = _params(PA.Attention, cfg, 4)
    splits = tp_weight_splits(
        cfg, ["dec_layers.0.cross_attn." + n for n in whole], g, b, sq, skv)
    tparams = _tp_params(whole, splits, "dec_layers.0.cross_attn.", ranks)
    xq, xkv = randn(b, sq, d, seed=5), randn(b, skv, d, seed=6)
    qp, kp = torch.arange(sq), torch.arange(skv)
    wp = {n: w.clone().requires_grad_(True) for n, w in whole.items()}
    q = PCm.rope((xq @ wp["wq"]).view(b, sq, cfg.n_heads, -1), qp,
                 cfg.rope_theta)
    k = PCm.rope((xkv @ wp["wk"]).view(b, skv, cfg.n_kv_heads, -1), kp,
                 cfg.rope_theta)
    v = (xkv @ wp["wv"]).view(b, skv, cfg.n_kv_heads, -1)
    out = PA.mha_attend(*(t.transpose(1, 2) for t in (q, k, v)),
                        causal=False, backend="plain")
    want = out.transpose(1, 2).reshape(b, sq, -1) @ wp["wo"]
    gy = randn(b, sq, d, seed=7)
    (want * gy).sum().backward()
    got = PA.attention_tp(type("A", (), tparams),
                          to_layout(xq, g, (b, sq, d)), cfg, g, q_pos=qp,
                          causal=False, xkv=to_layout(xkv, g, (b, skv, d)),
                          kv_pos=kp)
    got = from_layout(got, g, (b, sq, d))
    (got * gy).sum().backward()
    close(got, want)
    for n, gw in _merged_grads(tparams, splits,
                               "dec_layers.0.cross_attn.").items():
        close(gw, wp[n].grad, n)
    _check_layouts(g)


@pytest.mark.parametrize("ranks,d_ff,sp", [(2, 512, True), (4, 512, False),
                                           (4, 510, True)])
def test_mlp_tp_is_mlp(ranks, d_ff, sp):
    cfg = config(d_ff=d_ff)
    g = group_of(ranks, seq_parallel=sp)
    b, s, d = 2, 8, cfg.d_model
    whole = _params(PMl.MLP, cfg, 8)
    splits = tp_weight_splits(cfg, ["layers.0.ffn." + n for n in whole],
                              g, b, s)
    assert (splits["layers.0.ffn.w_gate"] is None) == (d_ff % ranks != 0)
    tparams = _tp_params(whole, splits, "layers.0.ffn.", ranks)
    wp = {n: w.clone().requires_grad_(True) for n, w in whole.items()}
    x = randn(b, s, d, seed=9)
    want = PMl.mlp(type("M", (), wp), x)
    gy = randn(b, s, d, seed=10)
    (want * gy).sum().backward()
    got = from_layout(PMl.mlp_tp(type("M", (), tparams),
                                 to_layout(x, g, (b, s, d)), g, (b, s, d)),
                      g, (b, s, d))
    (got * gy).sum().backward()
    close(got, want)
    for n, gw in _merged_grads(tparams, splits, "layers.0.ffn.").items():
        close(gw, wp[n].grad, n)


def _moe_case(ranks, arch="olmoe-1b-7b", seed=11):
    cfg = config(arch)
    g = group_of(ranks)
    b, s, d = 2, 16, cfg.d_model
    whole = _params(PM.MoE, cfg, seed)
    splits = tp_weight_splits(cfg, ["layers.0.ffn." + n for n in whole],
                              g, b, s)
    return cfg, g, (b, s, d), whole, splits


@pytest.mark.parametrize("ranks", [2, 4, 16])
def test_moe_tp_is_moe(ranks):
    """Experts over 2 and 4 ranks, replicated over 16 (8 experts)."""
    cfg, g, shape, whole, splits = _moe_case(ranks)
    assert (splits["layers.0.ffn.w_gate"] is None) == (ranks == 16)
    tparams = _tp_params(whole, splits, "layers.0.ffn.", ranks)
    wp = {n: w.clone().requires_grad_(True) for n, w in whole.items()}
    x = randn(*shape, seed=12)
    gy = randn(*shape, seed=13)
    with ctx.rank_local(), PM.record_routing() as want_log:
        want = PM.moe(type("E", (), wp), x, cfg)
        (want * gy).sum().backward()
        with PM.record_routing() as got_log:
            got = PM.moe_tp(type("E", (), tparams), to_layout(x, g, shape),
                            cfg, g, shape)
    got = from_layout(got, g, shape)
    (got * gy).sum().backward()
    close(got, want)
    for n, gw in _merged_grads(tparams, splits, "layers.0.ffn.").items():
        close(gw, wp[n].grad, n)
    assert torch.equal(got_log[0].keep, want_log[0].keep)
    kinds = _check_layouts(g)
    assert ("gecd", None if ranks == 16 else 1) in kinds


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_place_pairs_is_the_routing_capacity_rule(groups):
    """``place_pairs`` on a routing's experts gives its slots, kept pairs
    and cap; in ``groups`` groups, those of each group routed alone."""
    cfg = config("olmoe-1b-7b")
    scores = randn(96, cfg.moe_experts, seed=21)
    scores[:, 3] += 3.0                          # one expert overflows
    r = PM.route_scores(scores, cfg, groups)
    slot, keep, cap = PM.place_pairs(r.expert, cfg, groups)
    assert cap == r.cap
    assert torch.equal(slot, r.slot) and torch.equal(keep, r.keep)
    assert not bool(keep.all())
    alone = [PM.route_scores(part, cfg) for part in scores.chunk(groups)]
    assert all(a.cap == cap for a in alone)
    assert torch.equal(slot, torch.cat([a.slot for a in alone]))
    assert torch.equal(keep, torch.cat([a.keep for a in alone]))


@pytest.mark.parametrize("ranks", [2, 4])
def test_each_expert_runs_on_the_rank_ecd_names(ranks, monkeypatch):
    """With every expert's ``w_down`` zero but expert j's, only the rank
    ``ecd`` puts expert j on gives a nonzero partial output."""
    cfg, g, shape, whole, splits = _moe_case(ranks)
    e, d = cfg.moe_experts, cfg.d_model
    with ctx.activation_sharding(g.mesh):
        spec = ctx.constraint_spec((e, 8, d), "ecd")
    assert spec[0] == "model"
    partials = []
    real = tp.scatter_sum
    monkeypatch.setattr(tp, "scatter_sum",
                        lambda y, grp, dim: partials.append(y) or
                        real(y, grp, dim))
    x = randn(*shape, seed=14)
    for j in range(e):
        w = dict(whole)
        w["w_down"] = torch.zeros_like(whole["w_down"])
        w["w_down"][j] = whole["w_down"][j]
        params = _tp_params(w, splits, "layers.0.ffn.", ranks)
        with ctx.rank_local(), torch.no_grad():
            PM.moe_tp(type("E", (), params), to_layout(x, g, shape), cfg, g,
                      shape)
        nonzero = [r for r in range(ranks)
                   if bool(partials[-1][r].abs().max() > 0)]
        assert nonzero == [j // (e // ranks)], (j, nonzero)


@pytest.mark.parametrize("vocab,ranks,sp", [(512, 4, True), (510, 4, True),
                                            (510, 4, False),
                                            (510, 8, True)])
def test_embed_and_loss_tp(vocab, ranks, sp):
    """The vocab-parallel embedding and cross entropy where the ranks
    divide the vocabulary; whole weights and sequence-sharded logits (or,
    where neither divides, replicated ones) where they do not."""
    cfg = config(vocab=vocab)
    g = group_of(ranks, seq_parallel=sp)
    b, s, d = 2, 12 if ranks == 8 else 16, cfg.d_model
    shape = (b, s, d)
    splits = tp_weight_splits(cfg, ["embed", "lm_head"], g, b, s)
    assert (splits["embed"] == 0) == (vocab % ranks == 0)
    emb, head = randn(vocab, d, seed=15), randn(d, vocab, seed=16) * 0.1
    tok = torch.randint(0, vocab, (b, s),
                        generator=torch.Generator().manual_seed(17))
    lab = torch.randint(0, vocab, (b, s),
                        generator=torch.Generator().manual_seed(18))
    e_w, h_w = emb.clone().requires_grad_(True), \
        head.clone().requires_grad_(True)
    x = torch.nn.functional.embedding(tok, e_w)
    want = PCm.cross_entropy_loss(x @ h_w, lab)
    want.backward()
    tpar = _tp_params({"embed": emb, "lm_head": head}, splits, "", ranks)
    xt = PCm.embed_tp(tpar["embed"], tok, g, shape)
    close(from_layout(xt, g, shape), x.detach())
    got = PCm.lm_head_loss_tp(xt, tpar["lm_head"], lab, g, shape)
    got.backward()
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) <= 1e-6 * abs(want)
    grads = _merged_grads(tpar, splits, "")
    close(grads["embed"], e_w.grad, "embed")
    close(grads["lm_head"], h_w.grad, "lm_head")
    want_dim = 2 if vocab % ranks == 0 else (1 if s % ranks == 0 else None)
    assert ("logits_v", want_dim) in _check_layouts(g)


# ------------------------------------------------------------- the shards
@pytest.mark.parametrize("devices", [["cpu"] * 4, ["cpu", "cpu:0"] * 2])
@pytest.mark.parametrize("spec,dim", [(("data", "model"), 1),
                                      (("model", "data"), 0),
                                      (("model", None, None), 0)])
def test_gather_ranks_and_reduce_with_splits(devices, spec, dim):
    """A position's model shard, gathered over the data axes, is the
    leaf's block; a ranked gradient added into the pieces equals the
    whole gradient added, bit for bit."""
    mesh = make_host_mesh(2, devices=devices)
    shape = (4, 6, 3) if len(spec) == 3 else (4, 6)
    full = randn(*shape, seed=19)
    lay = spmd.Layout(shape, spec, mesh)
    sh = spmd.Sharded.place(full, lay)
    for dev in ("cpu", "cpu:0"):
        assert torch.equal(sh.gather_ranks(dev, dim),
                           tp.split_ranks(full, dim, 2))
    grad = randn(*shape, seed=20)
    a, b = spmd.Sharded.zeros(lay, torch.float32), \
        spmd.Sharded.zeros(lay, torch.float32)
    spmd.reduce_into({"w": a}, {"w": full})
    spmd.reduce_into({"w": b}, {"w": tp.split_ranks(full, dim, 2)},
                     {"w": dim})
    spmd.reduce_into({"w": a}, {"w": grad})
    spmd.reduce_into({"w": b}, {"w": tp.split_ranks(grad, dim, 2)},
                     {"w": dim})
    assert torch.equal(a.gather("cpu"), b.gather("cpu"))
