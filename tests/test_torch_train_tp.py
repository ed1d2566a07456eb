"""The tensor- and expert-parallel train step of every family
(``"model"`` > 1; ``repro_torch.distributed.tp``) on the CPU, at smoke
size in float32, on meshes that name ``"cpu"`` several times. The
hybrid's and SSM's steps take 128 tokens (``seq_of``: past the hybrid's
64-token window, two RWKV chunks), the others 64.

* Against the reference's jitted step under the same data degree
  (``lm_family_checks.check_sharded_against_reference``, whose
  docstring in ``tests/test_torch_train_sharded.py`` gives the
  tolerances: losses rtol 1e-5, gradients within 1e-4 of a leaf's max,
  weights within 3·lr·1e-3 but at near-zero gradients) on (1, 4), (2,
  4), the enc-dec model's (1, 2) and (2, 2), and the hybrid's and SSM's
  (2, 2) x 2 microbatches (the dense and MoE (1, 2), (2, 2) and (2, 2)
  x 2 microbatches are in ``test_torch_train_sharded{,_moe}.py``), and
  on configs that force the query-row fallback, replicated K/V and
  sequence-sharded logits (the recurrent blocks' fallbacks:
  ``tests/test_torch_tp_recurrent.py``). The hybrid's and SSM's weights
  after a step are held bit for bit to the whole-leaf AdamW step on the
  step's own gradients and to the reference's element by element, with
  no cap on a leaf's share of elements parted at near-zero gradients
  (``own_update``: their 256-element vectors hold gradients a few Adam
  eps from zero, whose first update the gradients' rounding moves).
* Against the port's unsharded step under ``activation_sharding`` of
  the same data degree (the same MoE groups), with and without
  microbatches and int8 compression: the first step from the same
  state within the tolerances above (int8: losses rtol 1e-5 and the
  weights within two Adam steps, 2·lr, since a gradient at a rounding
  edge may round to the other int8 level), the second step's loss rtol
  1e-5; the hybrid's and SSM's first step as with ``own_update``.
* ``"model"`` = 1 meshes take the data-parallel step: losses and
  gradients bit for bit those written out here as the step was before
  tensor-parallel compute (each rank's whole gradient added in rank
  order), and the weights after bit for bit the whole-leaf AdamW step
  on them (the clip norm sums each gradient leaf gathered whole, so it
  does not depend on how a leaf's pieces are stacked).
* A data rank's positions on distinct devices give the one-device
  stack's losses, gradients and weights bit for bit.
* Each activation's layout is ``constraint_spec``'s; the MoE's drops by
  rank equal the unsharded step's groups'; the model-axis bytes of
  ``traffic`` equal a closed form of the shapes (the dense model's, the
  hybrid's and the SSM's); ``launch.train`` logs the compute each family
  takes and the bytes by type.
"""

import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

import lm_family_checks as F
from lm_family_checks import one_torch_thread  # noqa: F401 — autouse
from repro_torch.configs import get_config
from repro_torch.data import make_pipeline
from repro_torch.distributed import ctx
from repro_torch.distributed.ctx import activation_sharding
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as PM
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import init_params, loss_fn
from repro_torch.optim import AdamW, Int8EF
from repro_torch.optim.adamw import GradTransform
from repro_torch.train.step import make_train_fn

LR = F.TRAIN_LR
mesh_of, sharded = F.mesh_of, F.sharded
FALLBACKS = {"n_heads": 6, "n_kv_heads": 2, "vocab": 510}
RECURRENT = ("recurrentgemma-2b", "rwkv6-7b")


def seq_of(arch):
    """Tokens a row: 128 for the hybrid (past its 64-token window) and the
    SSM (two RWKV chunks), else ``lm_family_checks.TRAIN_SEQ``."""
    return 128 if arch in RECURRENT else F.TRAIN_SEQ


class Stash(GradTransform):
    def apply(self, grads, ef):
        return grads, grads


def duck(data):
    return types.SimpleNamespace(axis_names=("data",), shape={"data": data})


def smoke(arch, **over):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32, **over)
    return cfg, init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")


@pytest.mark.parametrize("arch,dp,mp,microbatches", [
    ("llama3.2-3b", 1, 4, 1), ("llama3.2-3b", 2, 4, 2),
    ("olmoe-1b-7b", 1, 4, 1), ("olmoe-1b-7b", 2, 4, 1),
    ("seamless-m4t-large-v2", 1, 2, 1), ("seamless-m4t-large-v2", 2, 2, 2),
    ("seamless-m4t-large-v2", 1, 4, 1), ("seamless-m4t-large-v2", 2, 4, 1),
    ("recurrentgemma-2b", 1, 4, 1), ("recurrentgemma-2b", 2, 4, 1),
    ("recurrentgemma-2b", 2, 2, 2), ("rwkv6-7b", 1, 4, 1),
    ("rwkv6-7b", 2, 4, 1), ("rwkv6-7b", 2, 2, 2)])
def test_tp_step_matches_reference(arch, dp, mp, microbatches):
    model = F.check_sharded_against_reference(
        arch, dp, mp, microbatches, seq=seq_of(arch),
        own_update=arch in RECURRENT)
    assert model.last_step["group"] is not None


@pytest.mark.parametrize("arch", ["llama3.2-3b", "seamless-m4t-large-v2"])
def test_tp_fallbacks_match_reference(arch):
    """24/8-like heads that the ranks do not divide (the query rows over
    the ranks, K/V replicated) and a vocabulary they do not divide (the
    logits' sequence over the ranks, the embedding whole)."""
    model = F.check_sharded_against_reference(arch, 1, 4, **FALLBACKS)
    kinds = {(k, d) for k, _, d in model.last_step["group"].layouts}
    assert {("bshd", 1), ("bshd_kv", None), ("logits_v", 1)} <= kinds
    assert model.last_step["splits"]["embed"] is None


def _step_pair(arch, dp, mp, microbatches, compress, steps=2):
    """The sharded step on (dp, mp) and the unsharded step under data
    ``dp``, from the same weights; per step (loss, loss, grads, grads,
    weights, weights), the first step's both from the same state."""
    cfg, base = smoke(arch)
    pipe = make_pipeline(cfg, seq_of(arch), F.TRAIN_BATCH, device="cpu")
    mesh = mesh_of(dp, mp)
    opt = AdamW(lr=LR, compress=compress or Stash())
    plain = copy.deepcopy(base)
    pstate = opt.init(plain)
    model = sharded(copy.deepcopy(base), mesh)
    state = opt.init(model)
    f = make_train_fn(cfg, opt, microbatches=microbatches)
    g = make_train_fn(cfg, opt, microbatches=microbatches, mesh=mesh)
    out = []
    for step in range(steps):
        with activation_sharding(duck(dp)):
            plain, pstate, want = f(plain, pstate, pipe.batch(step))
        with activation_sharding(mesh):
            model, state, got = g(model, state, pipe.batch(step))
        out.append((float(got), float(want),
                    {n: sh.gather("cpu") for n, sh in state.ef.items()},
                    dict(pstate.ef),
                    {n: p.detach().clone()
                     for n, p in model.named_parameters()},
                    {n: p.detach().clone()
                     for n, p in plain.named_parameters()}))
    assert model.last_step["group"] is not None
    return out


@pytest.mark.parametrize("compress", [None, "int8"])
@pytest.mark.parametrize("arch,dp,mp,microbatches", [
    ("llama3.2-3b", 2, 2, 1), ("llama3.2-3b", 1, 4, 2),
    ("olmoe-1b-7b", 2, 2, 2), ("olmoe-1b-7b", 2, 4, 1),
    ("seamless-m4t-large-v2", 2, 2, 1),
    ("seamless-m4t-large-v2", 1, 2, 2), ("recurrentgemma-2b", 2, 2, 1),
    ("rwkv6-7b", 1, 4, 2)])
def test_tp_step_matches_unsharded_step(arch, dp, mp, microbatches,
                                        compress):
    out = _step_pair(arch, dp, mp, microbatches,
                     Int8EF() if compress else None)
    for got, want, *_ in out:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    _, _, sg, pg, sw, pw = out[0]
    own = arch in RECURRENT and not compress
    if own:
        # the hybrid's and SSM's 256-element vectors hold gradients a few
        # Adam eps from zero: the first step's weights are held bit for
        # bit to the whole-leaf AdamW step on the sharded gradients, and
        # to the unsharded step element by element, with no cap on a
        # leaf's parted share (``check_sharded_against_reference``'s
        # ``own_update``)
        _, plain = smoke(arch)
        opt = AdamW(lr=LR, compress=Stash())
        opt.apply_(sg, opt.init(plain), plain)
        for name, p in plain.named_parameters():
            assert torch.equal(sw[name], p.detach()), name
    for name, p in pw.items():
        d = (sw[name] - p).abs()
        if compress:
            assert float(d.max()) <= 2 * LR, name
            continue
        g = pg[name].abs()
        scale = float(g.max())
        assert float((sg[name] - pg[name]).abs().max()) <= 1e-4 * scale, \
            name
        far = d > 3 * LR * 1e-3
        assert own or int(far.sum()) <= 1e-3 * d.numel(), name
        assert bool((g[far] <= 1e-4 * scale).all()), name


def _data_parallel_grads(cfg, model, batch, ranks, microbatches):
    """The data-parallel sharded step's loss and gradients written out on
    the whole model: each rank's gradient of its rows (one MoE group),
    added in float32 in microbatch and rank order, divided (and cast to
    the parameters' type with one microbatch)."""
    lfn = loss_fn(cfg, backend="plain")
    names, plist = zip(*model.named_parameters())
    gsum = [torch.zeros(p.shape, dtype=torch.float32) for p in plist]
    lsum = torch.zeros((), dtype=torch.float32)
    rows = next(iter(batch.values())).shape[0] // (ranks * microbatches)
    for p in plist:
        p.requires_grad_(True)
    for i in range(microbatches):
        for r in range(ranks):
            lo = (i * ranks + r) * rows
            sub = {k: v[lo:lo + rows] for k, v in batch.items()}
            with ctx.rank_local():
                loss = lfn(model, sub)
                torch._foreach_add_(gsum, torch.autograd.grad(loss, plist))
            lsum = lsum + loss.detach()
    for p in plist:
        p.requires_grad_(False)
    n = ranks * microbatches
    if n > 1:
        gsum = [g.div_(n) for g in gsum]
    if microbatches == 1:
        gsum = [g.to(p.dtype) for g, p in zip(gsum, plist)]
    return (lsum / n if n > 1 else lsum), dict(zip(names, gsum))


def _stash_steps(cfg, base, mesh, batches, microbatches=1, weights=None):
    """Sharded steps (gradients kept by ``Stash``), each from
    ``weights[step]`` when given: per step (loss, gradients, weights
    after)."""
    model = sharded(copy.deepcopy(base), mesh)
    opt = AdamW(lr=LR, compress=Stash())
    state = opt.init(model)
    step = make_train_fn(cfg, opt, microbatches=microbatches, mesh=mesh)
    out = []
    for s, batch in enumerate(batches):
        if weights is not None:
            model.load_(weights[s])
        with activation_sharding(mesh):
            model, state, loss = step(model, state, batch)
        out.append((loss, {n: sh.gather("cpu") for n, sh in state.ef.items()},
                    {n: p.detach().clone()
                     for n, p in model.named_parameters()}))
    return model, out


def _weights_before(out, base):
    return [dict(base.named_parameters())] + [w for _, _, w in out[:-1]]


@pytest.mark.parametrize("arch,dp,mp,microbatches,seq", [
    ("llama3.2-3b", 2, 1, 2, 64), ("llama3.2-3b", 4, 1, 1, 64),
    ("olmoe-1b-7b", 4, 1, 1, 64), ("seamless-m4t-large-v2", 2, 1, 1, 64),
    ("recurrentgemma-2b", 2, 1, 1, 128), ("rwkv6-7b", 2, 1, 2, 128)])
def test_data_parallel_compute_is_unchanged_bitwise(arch, dp, mp,
                                                    microbatches, seq):
    """``"model"`` = 1 meshes take the data-parallel step: two steps'
    losses and gradients bit for bit those written out here from the
    same weights, and the weights after bit for bit the whole-leaf AdamW
    step on them (each leaf's clip sum of squares is the same bits
    however its pieces are stacked)."""
    cfg, base = smoke(arch)
    pipe = make_pipeline(cfg, seq, 4, device="cpu")
    batches = [pipe.batch(s) for s in range(2)]
    model, out = _stash_steps(cfg, base, mesh_of(dp, mp), batches,
                              microbatches)
    assert model.last_step["group"] is None
    plain = copy.deepcopy(base)
    opt = AdamW(lr=LR)
    pstate = opt.init(plain)
    for (loss, grads, after), batch, before in zip(
            out, batches, _weights_before(out, base)):
        with torch.no_grad():
            for n, p in plain.named_parameters():
                p.copy_(before[n])
        want, wgrads = _data_parallel_grads(cfg, plain, batch, dp,
                                            microbatches)
        assert torch.equal(loss, want)
        for n, g in wgrads.items():
            assert torch.equal(grads[n], g), n
        pstate = opt.apply_(wgrads, pstate, plain)
        for n, p in plain.named_parameters():
            assert torch.equal(after[n], p.detach()), n


@pytest.mark.parametrize("arch,over", [
    ("llama3.2-3b", FALLBACKS), ("olmoe-1b-7b", {}),
    ("seamless-m4t-large-v2", {}), ("recurrentgemma-2b", {}),
    ("rwkv6-7b", {})])
def test_distinct_devices_are_the_stacked_path_bitwise(arch, over):
    """A data rank's model positions on ``"cpu"`` and ``"cpu:0"`` (their
    pieces copied to the rank's first device), or each data rank on its
    own device: from the same weights, two steps' losses, gradients and
    weights after are the one-device mesh's bit for bit, and so are the
    byte counts (the SSM on 64 tokens, one RWKV chunk; the others on
    32)."""
    cfg, base = smoke(arch, **over)
    pipe = make_pipeline(cfg, 64 if arch == "rwkv6-7b" else 32, 8,
                         device="cpu")
    batches = [pipe.batch(s) for s in range(2)]
    one, want = _stash_steps(cfg, base, make_host_mesh(
        4, devices=["cpu"] * 8), batches)
    for devices in (["cpu", "cpu:0"] * 4, ["cpu"] * 4 + ["cpu:0"] * 4):
        model, got = _stash_steps(cfg, base,
                                  make_host_mesh(4, devices=devices),
                                  batches, weights=_weights_before(want,
                                                                   base))
        assert len(set(map(str, model.mesh.devices.flat))) == 2
        for (la, ga, wa), (lb, gb, wb) in zip(got, want):
            assert torch.equal(la, lb)
            for n in ga:
                assert torch.equal(ga[n], gb[n]), n
                assert torch.equal(wa[n], wb[n]), n
        assert model.traffic() == one.traffic()


@pytest.mark.parametrize("arch,seq,sp,over,want", [
    ("llama3.2-3b", 64, True, {},
     {("bsd", 1), ("bshd", 2), ("bshd_kv", None), ("logits_v", 2)}),
    ("llama3.2-3b", 64, False, FALLBACKS,
     {("bsd", None), ("bshd", 1), ("bshd_kv", None), ("logits_v", 1)}),
    ("llama3.2-3b", 38, True, {"vocab": 510},
     {("bsd", None), ("bshd", 2), ("bshd_kv", None), ("logits_v", None)}),
    ("olmoe-1b-7b", 64, True, {},
     {("bsd", 1), ("bshd", 2), ("bshd_kv", 2), ("logits_v", 2),
      ("gtd", None), ("gec", 1), ("gecd", 1)}),
    ("seamless-m4t-large-v2", 64, True, FALLBACKS,
     {("bsd", 1), ("bshd", 1), ("bshd_kv", None), ("logits_v", 1)}),
    ("recurrentgemma-2b", 128, True, {},
     {("bsd", 1), ("bshd", 2), ("bshd_kv", None), ("logits_v", 2)}),
    ("rwkv6-7b", 128, True, {},
     {("bsd", 1), ("bsd_batch_only", None), ("bhsd", 1), ("logits_v", 2)}),
    ("rwkv6-7b", 64, False, {"rwkv_head_dim": 128},
     {("bsd", None), ("bsd_batch_only", None), ("bhsd", None),
      ("logits_v", 2)})])
def test_step_layouts_are_constraint_spec(arch, seq, sp, over, want):
    """On (1, 4) each activation the step places has the model dim
    ``constraint_spec`` asks for under the step's context; the kinds and
    their layouts are the expected ones (``bsd`` sequence-parallel only
    with ``seq_parallel`` and a length the ranks divide; the SSM's blocks
    on ``bsd_batch_only``, then ``bsd`` before the head; its time mix's
    heads over the ranks, ``bhsd``, or, with 2 heads of 128 the 4 ranks
    would cut, whole on every rank)."""
    cfg, base = smoke(arch, **over)
    mesh = mesh_of(1, 4)
    model = sharded(base, mesh)
    opt = AdamW(lr=LR)
    batch = make_pipeline(cfg, seq, 4, device="cpu").batch(0)
    with activation_sharding(mesh, seq_parallel=sp):
        make_train_fn(cfg, opt, mesh=mesh)(model, opt.init(model), batch)
        group = model.last_step["group"]
        assert group.seq_parallel == sp
        for kind, shape, dim in group.layouts:
            spec = ctx.constraint_spec(shape, kind)
            assert dim == next((i for i, e in enumerate(spec)
                                if e == "model"), None), (kind, shape)
    assert {(k, d) for k, _, d in group.layouts} == want


def test_moe_drops_by_rank_on_a_wider_model_axis():
    """On (2, 4) with 2 microbatches, as ``test_torch_train_sharded_moe``
    on (2, 2): the pairs each data rank drops, layer by layer, are those
    of the unsharded step's groups under data 2."""
    cj, ct = F.train_configs("olmoe-1b-7b")
    _, tree = F.reference_weights(cj)
    mesh = mesh_of(2, 4)
    model = sharded(params_from_numpy(ct, tree, device="cpu"), mesh)
    opt = AdamW(lr=LR)
    batch = make_pipeline(ct, F.TRAIN_SEQ, F.TRAIN_BATCH,
                          device="cpu").batch(0)
    with activation_sharding(mesh), PM.record_routing() as log:
        make_train_fn(ct, opt, microbatches=2, mesh=mesh)(
            model, opt.init(model), batch)
    n = ct.n_layers
    assert len(log) == 4 * n
    by_rank = [[int((~log[(mb * 2 + rank) * n + layer].keep).sum())
                for rank in range(2)]
               for mb in range(2) for layer in range(n)]
    one = params_from_numpy(ct, tree, device="cpu")
    with activation_sharding(duck(2)), PM.record_routing() as grouped:
        make_train_fn(ct, opt, microbatches=2)(one, opt.init(one), batch)
    assert [r.dropped_by_group().tolist() for r in grouped] == by_rank


@pytest.mark.parametrize("dp,mp", [(2, 2), (2, 4), (4, 2)])
def test_ranks_keep_the_grouped_rule_on_their_own_experts(dp, mp):
    """The check the card makes at full width in bf16, where the ranks'
    experts may part from the unsharded step's at near-ties: each layer's
    slots and kept pairs of the data ranks are, bit for bit, the capacity
    rule of ``dp`` groups (``moe.place_pairs``) on the experts the ranks
    chose, and its cap the groups'."""
    cfg, base = smoke("olmoe-1b-7b")
    mesh = mesh_of(dp, mp)
    model = sharded(base, mesh)
    opt = AdamW(lr=LR)
    batch = make_pipeline(cfg, 64, 2 * dp, device="cpu").batch(0)
    with activation_sharding(mesh), PM.record_routing() as log:
        make_train_fn(cfg, opt, mesh=mesh)(model, opt.init(model), batch)
    n = cfg.n_layers
    assert len(log) == dp * n
    for layer in range(n):
        mine = [log[r * n + layer] for r in range(dp)]
        slot, keep, cap = PM.place_pairs(torch.cat([x.expert for x in mine]),
                                         cfg, dp)
        assert cap == mine[0].cap
        assert torch.equal(slot, torch.cat([x.slot for x in mine]))
        assert torch.equal(keep, torch.cat([x.keep for x in mine]))
        assert not bool(keep.all())             # the rule drops pairs


@pytest.mark.parametrize("dp,mp,microbatches", [(1, 2, 1), (2, 2, 2),
                                                (1, 4, 1), (2, 4, 1)])
def test_model_axis_traffic_closed_form(dp, mp, microbatches):
    """The dense smoke model (L layers, d, V), a global batch of B x s
    tokens, float32, R = mp model ranks, sequence parallel and heads and
    vocabulary over the ranks. A layer's attention and MLP each
    all-gather the sequence (N = B s d 4 bytes over the data ranks, each
    (R - 1) N) and reduce-scatter their partial sums; the rematerialised
    forward runs both all-gathers again and the attention's
    reduce-scatter (``torch.utils.checkpoint`` stops recomputing once
    the backward has what it saved, before the MLP's); the backward
    reduce-scatters for each all-gather and all-gathers for each
    reduce-scatter. The embedding reduce-scatters (backward:
    all-gathers), the head all-gathers (backward: reduce-scatters), and
    the vocab-parallel loss all-reduces three (B, s) float32 tensors.
    The parameters: each 2-D leaf is cut over data and model, so a
    position gathers the other data ranks' pieces of its model shard,
    (D - 1) times the leaf over the mesh, or, where it computes with the
    whole leaf (K and V on 4 ranks: 2 KV heads), all but its own piece,
    (P - 1) times over the P positions; the norms are whole everywhere;
    each gradient is sent as its parameter is gathered, a microbatch,
    and a norm's, whose moments ZeRO cuts over data, less each
    position's 1/D."""
    cfg, base = smoke("llama3.2-3b")
    L, d, s, B = cfg.n_layers, cfg.d_model, F.TRAIN_SEQ, F.TRAIN_BATCH
    mesh = mesh_of(dp, mp)
    model = sharded(base, mesh)
    opt = AdamW(lr=LR)
    batch = make_pipeline(cfg, s, B, device="cpu").batch(0)
    with activation_sharding(mesh):
        make_train_fn(cfg, opt, microbatches=microbatches, mesh=mesh)(
            model, opt.init(model), batch)
    n = (mp - 1) * B * s * d * 4
    t = model.traffic()
    assert t["model_all_gather_bytes"] == (6 * L + 2) * n
    assert t["model_reduce_scatter_bytes"] == (5 * L + 2) * n
    assert t["model_all_reduce_bytes"] == 3 * 2 * (mp - 1) * B * s * 4
    named = dict(base.named_parameters())
    whole_kv = cfg.n_kv_heads % mp != 0
    kv = sum(p.numel() * 4 for n, p in named.items()
             if n.endswith((".wk", ".wv")) and whole_kv)
    split = sum(p.numel() * 4 for p in named.values() if p.dim() == 2) - kv
    norms = sum(p.numel() * 4 for p in named.values() if p.dim() == 1)
    positions = dp * mp
    assert t["gathered_bytes"] == (dp - 1) * split + (positions - 1) * kv
    assert t["reduce_scatter_bytes"] == microbatches * (
        (dp - 1) * split + (positions - 1) * kv
        + positions * norms * (dp - 1) // dp)


@pytest.mark.parametrize("arch,over,dp,mp,microbatches", [
    ("recurrentgemma-2b", {}, 1, 2, 1), ("recurrentgemma-2b", {}, 2, 2, 2),
    ("recurrentgemma-2b", {"n_layers": 7}, 1, 4, 1),
    ("rwkv6-7b", {}, 1, 2, 1), ("rwkv6-7b", {}, 2, 4, 1),
    ("rwkv6-7b", {}, 1, 16, 1)])
def test_recurrent_model_axis_traffic_closed_form(arch, over, dp, mp,
                                                 microbatches):
    """The model axis's bytes of the hybrid's and the SSM's steps in
    closed form: a global batch of B x s tokens, float32, R = mp ranks,
    N = (R - 1) B s d 4 bytes (an all-gather or a reduce-scatter of the
    residual), N_w likewise of the RG-LRU's width, the embedding, the
    head and the vocab-parallel loss as in
    ``test_model_axis_traffic_closed_form`` (2 N each way and three (B,
    s) all-reduces). The hybrid, sequence parallel, heads over the ranks
    and K/V replicated (MQA): a recurrent layer all-gathers the sequence
    for its RG-LRU and its MLP and u's channels (N_w), and
    reduce-scatters two partial sums; the backward runs the conjugates; an
    attention layer gathers and scatters twice (its K/V from the one
    gathered input). A super is rematerialised up to its last
    reduce-scatter, a tail layer is not: a super moves 18 N + 4 N_w
    gathered and 17 N + 2 N_w scattered, a tail layer 4 N + N_w each.
    The SSM, its blocks on the batch-only residual (one all-gather into
    it after the embedding; its backward's all-gather out of it before
    the head): the time mix all-reduces ``wo``'s partial sums (2 N) and,
    backward, the gradients of the three mixed inputs of ``wr``, ``wk``,
    ``wv`` (3 x 2 N), and all-gathers the decay's gradient (N); the
    channel mix reduce-scatters ``k @ wv`` onto channels and all-gathers
    the product (backward: an all-gather, and two 2 N all-reduces). A
    rematerialised block runs again up to its channel mix's product: a
    block moves 3 N gathered, 2 N scattered and 14 N all-reduced. With
    heads the ranks would cut (8 on 16) the time mix is whole and moves
    nothing: 2 N, 2 N and 4 N."""
    cfg, base = smoke(arch, **over)
    L, d, s, B = cfg.n_layers, cfg.d_model, 128, F.TRAIN_BATCH
    mesh = mesh_of(dp, mp)
    model = sharded(base, mesh)
    opt = AdamW(lr=LR)
    batch = make_pipeline(cfg, s, B, device="cpu").batch(0)
    with activation_sharding(mesh):
        make_train_fn(cfg, opt, microbatches=microbatches, mesh=mesh)(
            model, opt.init(model), batch)
    n = (mp - 1) * B * s * d * 4
    loss = 3 * 2 * (mp - 1) * B * s * 4
    t = model.traffic()
    if cfg.family == "hybrid":
        nw = (mp - 1) * B * s * cfg.rnn_width * 4
        supers, tail = divmod(L, 3)
        gathered = supers * (18 * n + 4 * nw) + tail * (4 * n + nw) + 2 * n
        scattered = supers * (17 * n + 2 * nw) + tail * (4 * n + nw) + 2 * n
        reduced = loss
    else:
        cut = cfg.d_model // cfg.rwkv_head_dim % mp != 0
        gathered = (2 if cut else 3) * L * n + 4 * n
        scattered = 2 * L * n + 2 * n
        reduced = (4 if cut else 14) * L * n + loss
    assert t["model_all_gather_bytes"] == gathered
    assert t["model_reduce_scatter_bytes"] == scattered
    assert t["model_all_reduce_bytes"] == reduced


def test_launch_logs_the_compute_and_traffic():
    lines = []
    for arch in ("llama3.2-3b", "olmoe-1b-7b", "rwkv6-7b"):
        launch_train.train(get_config(arch, smoke=True), steps=1, batch=4,
                           seq=64, device="cpu", mesh_devices=["cpu"] * 4,
                           model_parallel=2, log=lines.append)
    text = "\n".join(lines)
    assert "llama3.2-3b-smoke (dense) computes tensor-parallel" in text
    assert "(moe) computes tensor- and expert-parallel" in text
    assert "rwkv6-7b-smoke (ssm) computes tensor-parallel" in text
    assert text.count("model_all_gather_bytes") == 3
