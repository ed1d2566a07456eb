"""Checks shared by the port's per-family LM tests against the reference.

``tests/test_torch_moe.py``, ``test_torch_hybrid.py`` and
``test_torch_ssm.py`` (serving) and ``tests/test_torch_train_moe.py``,
``_hybrid.py``, ``_ssm.py`` and ``_encdec.py`` (training), and
``tests/test_torch_train_sharded*.py`` (sharded training, the section at
the end) run these on their family's smoke configs: the
reference draws the weights (``PRNGKey``) and the port takes the same
values through ``models.convert.params_from_numpy``; tokens come from
numpy. Tolerances (float32 1e-4, bf16 3e-2, greedy tokens exact except
counted near-ties) are the ones ``tests/test_torch_lm.py`` states for
the dense family.
"""

import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cells_for as jax_cells_for
from repro.configs import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.data.synthetic import make_pipeline as jax_make_pipeline
from repro.distributed import ctx as JC
from repro.models import registry as JR
from repro.optim import AdamW as JAdamW
from repro.optim.adamw import GradTransform as JGradTransform
from repro.runtime.checkpoint import restore_checkpoint as jax_restore
from repro.runtime.checkpoint import save_checkpoint as jax_save
from repro.train.step import make_train_fn as jax_make_train_fn
from repro_torch.configs import cells_for, get_config
from repro_torch.configs.base import smoke_variant
from repro_torch.data import make_pipeline
from repro_torch.distributed import spmd
from repro_torch.distributed.ctx import activation_sharding
from repro_torch.distributed.sharding import opt_state_specs, param_specs
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import generate, make_prompts
from repro_torch.models import encdec as PE
from repro_torch.models import registry as TR
from repro_torch.models import transformer as PT
from repro_torch.models.convert import (params_from_numpy, params_to_numpy,
                                        port_leaf, tensor_from_numpy)
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import GradTransform
from repro_torch.runtime.checkpoint import (read_manifest,
                                            restore_checkpoint,
                                            save_checkpoint)
from repro_torch.train.step import make_train_fn

TOL = 1e-4
BF16_TOL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for a family file: its operations are small, and
    beside the suite's other workers a thread pool per process waits on
    descheduled threads (``tests/test_torch_train.py`` says more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pair(cfg_jax, cfg_port, seed=1):
    """The reference's weights and the port's model holding them."""
    params = JR.init_params(cfg_jax, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_numpy(cfg_port, tree, device="cpu")


def smoke_pair(arch, seed=1, **overrides):
    cj = jax_get_config(arch, smoke=True)
    ct = get_config(arch, smoke=True)
    if overrides:
        cj, ct = (dataclasses.replace(c, **overrides) for c in (cj, ct))
    pj, pt = pair(cj, ct, seed)
    return cj, ct, pj, pt


def tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape) \
        .astype(np.int32)


def close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def check_config(arch, smoke_size):
    """Every field, the parameter counts and the shape cells equal the
    reference's."""
    cj = jax_get_config(arch, smoke=smoke_size)
    ct = get_config(arch, smoke=smoke_size)
    fields = [f.name for f in dataclasses.fields(ct)]
    assert fields == [f.name for f in dataclasses.fields(cj)]
    for name in fields:
        if name == "dtype":
            assert str(ct.dtype).split(".")[-1] == jnp.dtype(cj.dtype).name
        else:
            assert getattr(ct, name) == getattr(cj, name), name
    assert ct.param_count() == cj.param_count()
    assert ct.active_param_count() == cj.active_param_count()
    assert (ct.attention_free, ct.sub_quadratic, ct.q_per_kv) == \
        (cj.attention_free, cj.sub_quadratic, cj.q_per_kv)
    assert [c.name for c in cells_for(ct)] == \
        [c.name for c in jax_cells_for(cj)]


def check_forward_and_loss(arch, seq=64):
    cj, ct, pj, pt = smoke_pair(arch)
    toks = tokens(ct, (2, seq))
    labels = tokens(ct, (2, seq), seed=7)
    want = JR.forward_fn(cj)(pj, {"tokens": jnp.asarray(toks)})
    got = TR.forward_fn(ct)(pt, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, seq, ct.vocab)
    close(got, want)
    batch = {"tokens": toks, "labels": labels}
    want_loss = JR.loss_fn(cj)(pj, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    with torch.no_grad():
        got_loss = TR.loss_fn(ct)(pt, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               rtol=TOL, atol=TOL)


def check_decode(arch, steps=8, s_max=32, seed=3, **overrides):
    """``steps`` decode steps' logits, then every cache leaf."""
    cj, ct, pj, pt = smoke_pair(arch, **overrides)
    toks = tokens(ct, (2, steps), seed=seed)
    cache_j = JR.make_decode_state(cj, 2, s_max)
    cache_t = TR.make_decode_state(ct, 2, s_max, device="cpu")
    dfn = jax.jit(JR.decode_fn(cj))
    for t in range(steps):
        lj, cache_j = dfn(pj, jnp.asarray(toks[:, t:t + 1]), cache_j,
                          jnp.int32(t))
        lt, cache_t = TR.decode_fn(ct)(pt, torch.from_numpy(
            toks[:, t:t + 1]), cache_t, t)
        assert lt.shape == (2, 1, ct.vocab)
        close(lt, lj)
    assert [f is None for f in cache_t] == [f is None for f in cache_j]
    mine = [leaf for f in cache_t if f is not None
            for leaf in (f if isinstance(f, tuple) else (f,))]
    ref = [leaf for f in cache_j if f is not None
           for leaf in (f if isinstance(f, tuple) else (f,))]
    assert len(mine) == len(ref)
    for m, r in zip(mine, ref):
        assert tuple(m.shape) == r.shape
        if m.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(m.numpy(), np.asarray(r))
        else:
            close(m, r)
    return cache_t


def check_decode_matches_forward(arch, seq=24, **overrides):
    """The port's teacher-forced decode equals its own parallel forward."""
    ct = dataclasses.replace(get_config(arch, smoke=True), **overrides)
    pt = TR.init_params(ct, generator=torch.Generator().manual_seed(4),
                        device="cpu")
    toks = torch.from_numpy(tokens(ct, (1, seq), seed=3))
    full = TR.forward_fn(ct)(pt, {"tokens": toks})
    caches = TR.make_decode_state(ct, 1, 128, device="cpu")
    outs = []
    for t in range(seq):
        logits, caches = TR.decode_fn(ct)(pt, toks[:, t:t + 1], caches, t)
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=TOL,
                               atol=TOL)


def jax_serve(cfg, params, prompts, gen, cache_len):
    """The reference's serve loop (``repro.launch.serve.main``)."""
    caches = JR.make_decode_state(cfg, prompts.shape[0], cache_len)
    dfn = jax.jit(JR.decode_fn(cfg))
    prompts = jnp.asarray(prompts)
    for t in range(prompts.shape[1] - 1):
        _, caches = dfn(params, prompts[:, t:t + 1], caches, jnp.int32(t))
    tok = prompts[:, -1:]
    start = prompts.shape[1] - 1
    toks, logits = [], []
    for i in range(gen):
        lg, caches = dfn(params, tok, caches, jnp.int32(start + i))
        tok = jnp.argmax(lg[:, -1:, :], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok[:, 0]))
        logits.append(np.asarray(lg[:, -1, :]))
    return np.stack(toks, axis=1), np.stack(logits, axis=1)


def check_serve(arch, prompt_len=16, gen=12, cache_len=64):
    """The serve loop's greedy tokens equal the reference's, except rows
    that part where the reference's top two logits lie within twice the
    float32 tolerance (counted)."""
    cj, ct, pj, pt = smoke_pair(arch)
    prompts = make_prompts(ct, 4, prompt_len, seed=0, device="cpu")
    out = generate(pt, ct, prompts, gen=gen, cache_len=cache_len)
    ref_tokens, ref_logits = jax_serve(cj, pj, prompts.numpy(), gen,
                                       cache_len)
    got = out.tokens.numpy()
    assert got.shape == ref_tokens.shape and got.dtype == np.int32
    close(out.first_logits, ref_logits[:, 0])
    near_ties = 0
    for row in range(got.shape[0]):
        differ = np.flatnonzero(got[row] != ref_tokens[row])
        if differ.size == 0:
            continue
        top2 = np.sort(ref_logits[row, differ[0]])[-2:]
        limit = 2 * (TOL + TOL * abs(top2[1]))
        assert top2[1] - top2[0] <= limit, (row, differ[0], top2)
        near_ties += 1
    print(f"{arch} serve loop: {near_ties} of {got.shape[0]} rows diverge "
          "at a near-tie")
    return near_ties


def reference_layerwise_logits(cfg, params, toks):
    """The reference's forward run op by op: its own layer functions
    (``_block_fwd``, or ``_rec_fwd`` / ``_attn_fwd`` for the hybrid) on
    each layer's slice of the stacked parameters, not jitted. In bf16
    the compiled forward (a ``lax.scan`` of a ``jax.checkpoint``-ed
    layer) keeps fused intermediates that these ops round, so the two
    part by more than bf16's step; the port, run op by op too, is held
    to this one."""
    from repro.models import transformer as JT
    from repro.models.common import rms_norm
    x = params["embed"][jnp.asarray(toks)]
    positions = jnp.arange(x.shape[1])

    def rows(group):
        n = jax.tree.leaves(group)[0].shape[0]
        return [jax.tree.map(lambda a, i=i: a[i], group) for i in range(n)]

    if cfg.family == "hybrid":
        for p in rows(params["supers"]):
            x = JT._rec_fwd(cfg, p["r0"], x)
            x = JT._rec_fwd(cfg, p["r1"], x)
            x = JT._attn_fwd(cfg, p["attn"], x, positions)
        for p in rows(params["tail"]) if params["tail"] else []:
            x = JT._rec_fwd(cfg, p, x)
    else:
        for layer in rows(params["layers"]):
            x = JT._block_fwd(cfg, layer, x, positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return np.asarray((x @ params["lm_head"]).astype(jnp.float32))


def check_bf16_forward(arch, seq=64):
    """bf16 logits against the reference's op-by-op forward to 3e-2; the
    distance to its compiled forward is printed beside the reference's
    own distance between the two."""
    cj = jax_smoke_variant(jax_get_config(arch), dtype=jnp.bfloat16)
    ct = smoke_variant(get_config(arch), dtype=torch.bfloat16)
    pj, pt = pair(cj, ct, seed=2)
    toks = tokens(ct, (2, seq), seed=2)
    got = TR.forward_fn(ct)(pt, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    want = reference_layerwise_logits(cj, pj, toks)
    close(got, want, BF16_TOL)
    compiled = np.asarray(JR.forward_fn(cj)(pj, {"tokens": jnp.asarray(
        toks)}), np.float32)
    print(f"{arch} bf16: max |port - compiled reference| "
          f"{np.abs(got.float().numpy() - compiled).max():.4g}, reference "
          f"op by op vs compiled {np.abs(want - compiled).max():.4g}")


def check_round_trip(arch):
    """``params_to_numpy`` gives the reference's tree back: the same
    structure, shapes, dtypes and values."""
    cj, ct, pj, pt = smoke_pair(arch, seed=5)
    tree = jax.tree.map(np.asarray, pj)
    back = params_to_numpy(pt)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def check_init_scales(arch):
    """Port-drawn weights follow the reference's ``leaf`` scales and
    dtypes, name by name."""
    cfg = get_config(arch, smoke=True)
    model = TR.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, JR.init_params(
            jax_get_config(arch, smoke=True), jax.random.PRNGKey(0))))[0]
    ref_std = {}
    for path, leaf in ref:
        key = ".".join(str(getattr(p, "key", p)) for p in path)
        ref_std[key] = (leaf.dtype.name, float(leaf.astype(np.float32).std()))
    from repro_torch.models.convert import _tree_path
    for name, p in model.named_parameters():
        dtype, std = ref_std[".".join(_tree_path(name)[0])]
        assert str(p.dtype).split(".")[-1] == dtype, name
        if p.numel() >= 4096:
            got = float(p.float().std())
            assert abs(got - std) < 0.1 * std, (name, got, std)


# ---------------------------------------------------------------- MoE routing
# near-tie: two of a token's top k+1 float32 router scores within this,
# relative (``tests/test_torch_moe.py``'s docstring says how it is used)
TIE_RTOL = 1e-5




def reference_routing(scores, cfg):
    """The reference's routing (``repro.models.moe.moe``, lines 51-67,
    one group) of float32 scores ``(t, e)``: experts, gates, slots and
    keep."""
    t, e = scores.shape
    k = cfg.moe_topk
    gates, idx = jax.lax.top_k(jnp.asarray(scores)[None], k)
    gates = jax.nn.softmax(gates, axis=-1)
    cap = int(t * k / e * cfg.moe_capacity_factor)
    cap = max(8, -(-cap // 8) * 8)
    flat = idx.reshape(1, t * k)
    onehot = jax.nn.one_hot(flat, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=1) - onehot
    slot = jnp.take_along_axis(pos, flat[..., None], axis=2)[..., 0]
    return (np.asarray(idx[0]), np.asarray(gates[0]),
            np.asarray(slot.reshape(t, k)), np.asarray(slot < cap).reshape(
                t, k), cap)


def near_ties(scores, k):
    """Tokens whose top k+1 scores hold two within ``TIE_RTOL``."""
    top = -np.sort(-scores, axis=-1)[:, :k + 1]
    gap = top[:, :-1] - top[:, 1:]
    return (gap <= TIE_RTOL * np.abs(top[:, :-1])).any(axis=-1)


def assert_routing(got, want, ties=None):
    expert, gate, slot, keep, cap = want
    assert got.cap == cap
    t = expert.shape[0]
    ok = np.ones(t, bool) if ties is None else ~ties
    first = t if ties is None or not ties.any() else int(np.argmax(ties))
    np.testing.assert_array_equal(got.expert.numpy()[ok], expert[ok])
    np.testing.assert_array_equal(got.slot.numpy()[:first], slot[:first])
    np.testing.assert_array_equal(got.keep.numpy()[:first], keep[:first])
    np.testing.assert_allclose(got.gate.detach().numpy()[ok], gate[ok],
                               rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- training
# The train checks of ``tests/test_torch_train_{moe,hybrid,ssm,encdec}.py``,
# at ``tests/test_torch_train.py``'s sizes: batch 4 x 64 tokens (the
# enc-dec model's with 64 source frames; ``seq`` where a family needs more,
# as the SSM's chunk loop and the hybrid's local window do), lr 1e-3, the
# reference's weights from ``PRNGKey(0)``. Each check's docstring gives its
# tolerances.
TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR = 64, 4, 1e-3


class _JStash(JGradTransform):
    """Keeps the gradients the update sees in the error-feedback slot."""

    def apply(self, grads, ef):
        return grads, grads


class _Stash(GradTransform):
    def apply(self, grads, ef):
        return grads, grads


def train_configs(arch, dtype="float32", **overrides):
    """The reference's and the port's smoke configs of ``arch`` in
    ``dtype``."""
    cj = dataclasses.replace(jax_get_config(arch, smoke=True),
                             dtype=getattr(jnp, dtype), **overrides)
    ct = dataclasses.replace(get_config(arch, smoke=True),
                             dtype=getattr(torch, dtype), **overrides)
    return cj, ct


def reference_weights(cj, seed=0):
    """The reference's weights and their numpy tree."""
    pj = JR.init_params(cj, jax.random.PRNGKey(seed))
    return pj, jax.tree.map(np.asarray, pj)


def np32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _port_state(model, jstate):
    """The reference's ``AdamWState`` keyed by the port's names."""
    named = [n for n, _ in model.named_parameters()]

    def leaves(tree):
        tree = jax.tree.map(np.asarray, tree)
        return {n: tensor_from_numpy(port_leaf(tree, n)) for n in named}
    return type(jstate)(step=torch.tensor(int(jstate.step),
                                          dtype=torch.int32),
                        m=leaves(jstate.m), v=leaves(jstate.v),
                        ef=leaves(jstate.ef))


@torch.no_grad()
def _load_weights(model, tree):
    for name, p in model.named_parameters():
        p.copy_(tensor_from_numpy(port_leaf(tree, name)))


def run_both(cj, ct, pj, tree, steps, microbatches=1, *, jit=True,
             resync=False, seq=TRAIN_SEQ):
    """Both packages' train steps from the same weights and batches: the
    reference's jitted, or run op by op (``jit=False``, under
    ``jax.disable_jit``), on batches of ``seq`` tokens. With ``resync``
    each port step starts from the reference's weights and optimizer
    state before that step. Returns
    per step (reference loss, port loss, the gradients each update saw,
    and with ``resync`` the port's weights after the step as a numpy
    dict and the reference's as a numpy tree), then the reference's final
    weights (numpy tree) and the port's model."""
    jopt = JAdamW(lr=TRAIN_LR, compress=_JStash())
    topt = AdamW(lr=TRAIN_LR, compress=_Stash())
    jstep = jax_make_train_fn(cj, jopt, microbatches=microbatches)
    tstep = make_train_fn(ct, topt, microbatches=microbatches)
    jpipe = jax_make_pipeline(cj, seq, TRAIN_BATCH)
    tpipe = make_pipeline(ct, seq, TRAIN_BATCH, device="cpu")
    jp, js = pj, jopt.init(pj)
    tp = params_from_numpy(ct, tree, device="cpu")
    ts = topt.init(tp)
    out = []
    with contextlib.ExitStack() as stack:
        if jit:
            jstep = jax.jit(jstep)
        else:
            stack.enter_context(jax.disable_jit())
        for step in range(steps):
            if resync and step:
                _load_weights(tp, jax.tree.map(np.asarray, jp))
                ts = _port_state(tp, js)
            jp, js, jl = jstep(jp, js, jpipe.batch(step))
            tp, ts, tl = tstep(tp, ts, tpipe.batch(step))
            after = None
            if resync:
                after = ({n: np32(p).copy() for n, p in
                          tp.named_parameters()},
                         jax.tree.map(np.asarray, jp))
            out.append((float(jl), float(tl),
                        jax.tree.map(np.asarray, js.ef), dict(ts.ef),
                        after))
    return out, jax.tree.map(np.asarray, jp), tp


def grads_close(jg, tg, what, tol=TOL):
    """Every gradient within ``tol`` of its leaf's max |g|, in the
    reference's dtype."""
    for name, g in tg.items():
        want = port_leaf(jg, name)
        assert str(g.dtype).split(".")[-1] == want.dtype.name, (what, name)
        scale = float(np.abs(np32(want)).max())
        err = float(np.abs(np32(g) - np32(want)).max())
        assert err <= tol * scale, (what, name, err, scale)


def parted_near_zero(got, want, jg, tol, what, cap=True):
    """Hold weights after one step from the same state: every element of
    ``got`` (port names -> numpy) within ``tol`` of the reference's tree
    ``want``, except elements whose reference gradient ``jg`` lies within
    1e-4 of its leaf's max |g| of zero, where Adam's update (about +-lr)
    may take either sign: at most 0.1 % of a leaf (with ``cap``). Returns
    the parted elements' count."""
    parted = 0
    for name, p in got.items():
        d = np.abs(p - np32(port_leaf(want, name)))
        far = d > tol
        if not far.any():
            continue
        if cap:
            assert far.sum() <= 1e-3 * d.size, (what, name, int(far.sum()))
        g = np.abs(np32(port_leaf(jg, name)))
        assert (g[far] <= 1e-4 * g.max()).all(), (what, name)
        parted += int(far.sum())
    return parted


def check_train_steps(arch, microbatches, steps=3, seq=TRAIN_SEQ,
                      **overrides):
    """``steps`` float32 AdamW steps of ``seq`` tokens against the
    reference's jitted step, each port step started from the reference's
    weights and optimizer state before it: every loss rtol 1e-5, every
    gradient within 1e-4 of its leaf's max, the weights after every step
    by ``parted_near_zero`` within 3·lr·1e-3. The port's free run (from
    the same weights, its own state carried) holds every loss at rtol
    1e-5 too; its weights are not held element by element: they part
    from the reference's at the first step's near-zero gradients, by
    about 2·lr, which moves the later steps' gradients by up to 4e-4 of
    a leaf's max in the hybrid and SSM models, and Adam turns that into
    differences past the tolerance far from zero (the dynamics', not the
    port's)."""
    cj, ct = train_configs(arch, **overrides)
    pj, tree = reference_weights(cj)
    out, _, _ = run_both(cj, ct, pj, tree, steps, microbatches,
                         resync=True, seq=seq)
    parted = []
    for step, (jl, tl, jg, tg, (got, want)) in enumerate(out):
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"{step}")
        grads_close(jg, tg, f"step {step}")
        parted.append(parted_near_zero(got, want, jg, 3 * TRAIN_LR * 1e-3,
                                       f"step {step}"))
    opt = AdamW(lr=TRAIN_LR)
    step_fn = make_train_fn(ct, opt, microbatches=microbatches)
    model = params_from_numpy(ct, tree, device="cpu")
    state = opt.init(model)
    pipe = make_pipeline(ct, seq, TRAIN_BATCH, device="cpu")
    free = []
    for step in range(steps):
        model, state, loss = step_fn(model, state, pipe.batch(step))
        free.append(float(loss))
    np.testing.assert_allclose(free, [jl for jl, *_ in out], rtol=1e-5)
    print(f"{arch}, {microbatches} microbatch(es), {seq} tokens: losses "
          f"{free}; weight elements parted at near-zero gradients by step: "
          f"{parted}")
    return out


def bf16_units(x):
    """One bf16 unit in the last place at |x| (float32 input)."""
    return np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16


# the largest share of a leaf a bf16 step may part from the reference's by
# more than one unit (each such element by at most a flipped Adam step)
BF16_PARTED = 0.10


def check_bf16_step(arch, microbatches=1, *, jit=True, seq=TRAIN_SEQ,
                    **overrides):
    """One bf16 step of ``seq`` tokens from the same weights, against the
    reference's jitted step or (``jit=False``) its step run op by op
    (``jax.disable_jit``): the loss within the family's serving
    tolerance (3e-2); the update sees gradients in the parameters' dtype
    with one microbatch, float32 with two; after the step every weight
    within one bf16 unit of the reference's (at the largest of the old
    weight, the new and lr, since the update is rounded to bf16 before
    it is added), except at most ``BF16_PARTED`` of a leaf, each parted
    by at most a flipped Adam step (2·lr plus one unit). The first Adam
    step moves a weight by about lr times the sign of its gradient, and
    bf16 gradients summed in other orders flip the sign of the small
    ones: the reference's own jitted and op-by-op steps part so (at 64
    tokens) on up to 5.3 % of a stacked leaf (RWKV-6's ``w_lora_a``),
    4.6 % (the hybrid's tail ``w_i``) and 2.7 % (the MoE's ``w_gate``).
    Returns the largest share parted."""
    cj, ct = train_configs(arch, "bfloat16", **overrides)
    pj, tree = reference_weights(cj)
    out, jp, tp = run_both(cj, ct, pj, tree, 1, microbatches, jit=jit,
                           seq=seq)
    jl, tl, jg, tg, _ = out[0]
    np.testing.assert_allclose(tl, jl, rtol=BF16_TOL)
    dtypes = {n: p.dtype for n, p in tp.named_parameters()}
    for name, g in tg.items():
        assert str(g.dtype).split(".")[-1] == \
            port_leaf(jg, name).dtype.name, name
        assert g.dtype == (dtypes[name] if microbatches == 1
                           else torch.float32), name
    shares = {}
    for name, p in tp.named_parameters():
        want = np32(port_leaf(jp, name))
        old = np32(port_leaf(tree, name))
        unit = bf16_units(np.maximum(np.maximum(np.abs(want), np.abs(old)),
                                     TRAIN_LR))
        d = np.abs(np32(p) - want)
        assert np.all(d <= 2 * TRAIN_LR + unit), name
        shares[name] = float((d > unit).mean())
    name, worst = max(shares.items(), key=lambda kv: kv[1])
    print(f"{arch} bf16 step ({'compiled' if jit else 'op by op'} "
          f"reference, {microbatches} microbatch(es)): loss {tl:.5f} vs "
          f"{jl:.5f}; at most {worst:.4f} of a leaf ({name}) parted by "
          "more than one bf16 unit")
    assert worst <= BF16_PARTED, (name, worst)
    return worst


def check_remat_bitwise(arch, **overrides):
    """The loss and every gradient with the layers rematerialised equal
    them without, bit for bit (the same operations, recomputed)."""
    cj, ct = train_configs(arch, **overrides)
    _, tree = reference_weights(cj)
    model = params_from_numpy(ct, tree, device="cpu")
    batch = make_pipeline(ct, TRAIN_SEQ, TRAIN_BATCH, device="cpu").batch(0)
    plist = list(model.parameters())
    loss_of = (PE.encdec_loss if ct.family == "encdec" else PT.lm_loss)
    got = []
    with contextlib.ExitStack() as stack:
        for p in plist:
            p.requires_grad_(True)
        stack.callback(lambda: [p.requires_grad_(False) for p in plist])
        for remat in (True, False):
            loss = loss_of(model, batch, ct, remat=remat, backend="plain")
            got.append((loss.detach(), torch.autograd.grad(loss, plist)))
    assert torch.equal(got[0][0], got[1][0])
    for (name, _), a, b in zip(model.named_parameters(), got[0][1],
                               got[1][1]):
        assert torch.equal(a, b), name


def check_reference_checkpoint_resumes(arch, tmp_path, **overrides):
    """A float32 checkpoint of the reference's loop after 2 steps,
    restored into the port, steps to the reference's next loss at rtol
    1e-5."""
    cj, ct = train_configs(arch, **overrides)
    pj, tree = reference_weights(cj)
    jopt, topt = JAdamW(lr=TRAIN_LR), AdamW(lr=TRAIN_LR)
    jstep = jax.jit(jax_make_train_fn(cj, jopt))
    pipe = jax_make_pipeline(cj, TRAIN_SEQ, TRAIN_BATCH)
    jp, js = pj, jopt.init(pj)
    for step in range(2):
        jp, js, _ = jstep(jp, js, pipe.batch(step))
    jax_save(tmp_path, 1, (jp, js), extra={"step": 1, "seed": 0})
    _, _, want = jstep(jp, js, pipe.batch(2))

    model = params_from_numpy(ct, tree, device="cpu")   # step-0 weights
    state = topt.init(model)
    restored, extra = restore_checkpoint(
        tmp_path, launch_train.checkpoint_tree(model, state))
    state = launch_train.load_checkpoint_tree(restored, model)
    assert extra["step"] == 1 and int(state.step) == 2
    batch = make_pipeline(ct, TRAIN_SEQ, TRAIN_BATCH, device="cpu").batch(2)
    _, _, got = make_train_fn(ct, topt)(model, state, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def check_port_checkpoint_restores(arch, tmp_path, **overrides):
    """A float32 port checkpoint after one step holds the reference's
    keys, shapes and dtypes (an empty stacked group as the reference's
    ``{}``), and restores in the reference bit for bit."""
    cj, ct = train_configs(arch, **overrides)
    pj, tree = reference_weights(cj)
    topt, jopt = AdamW(lr=TRAIN_LR), JAdamW(lr=TRAIN_LR)
    model = params_from_numpy(ct, tree, device="cpu")
    state = topt.init(model)
    batch = make_pipeline(ct, TRAIN_SEQ, TRAIN_BATCH, device="cpu").batch(0)
    model, state, _ = make_train_fn(ct, topt)(model, state, batch)
    ptree, pstate = launch_train.checkpoint_tree(model, state)
    assert jax.tree.structure(ptree) == jax.tree.structure(tree)
    assert jax.tree.structure(pstate.m) == jax.tree.structure(tree)
    save_checkpoint(tmp_path / "port", 0, (ptree, pstate),
                    extra={"step": 0})
    jax_save(tmp_path / "ref", 0, (pj, jopt.init(pj)), extra={"step": 0})
    port_keys = read_manifest(tmp_path / "port")["leaves"]
    assert port_keys == read_manifest(tmp_path / "ref")["leaves"]

    (jp, js), extra = jax_restore(tmp_path / "port", (pj, jopt.init(pj)))
    assert extra == {"step": 0} and int(js.step) == 1 and js.ef is None
    jp, jm, jv = (jax.tree.map(np.asarray, t) for t in (jp, js.m, js.v))
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(port_leaf(jp, name),
                                      p.detach().numpy())
        np.testing.assert_array_equal(port_leaf(jm, name),
                                      state.m[name].numpy())
        np.testing.assert_array_equal(port_leaf(jv, name),
                                      state.v[name].numpy())


# ------------------------------------------------------------ sharded steps
# ``tests/test_torch_train_sharded*.py``: the port's sharded step on a
# (dp, mp) mesh naming the CPU dp x mp times, against the reference's step
# under a duck mesh of data degree dp, each port step started from the
# reference's state before it, held as ``check_train_steps`` holds its
# steps.
SHARDED_STEPS = 2


def mesh_of(dp, mp):
    return make_host_mesh(mp, devices=["cpu"] * (dp * mp))


def sharded(model, mesh):
    return spmd.ShardedModel(model, mesh, param_specs(model, mesh),
                             opt_state_specs(model, mesh))


_REFERENCE: dict = {}


def reference_run(arch, dp, microbatches, seq, **overrides):
    """The reference's jitted steps under data degree ``dp``: per step
    the weights and state before it (numpy trees), its loss and the
    gradients its update saw."""
    key = (arch, dp, microbatches, seq, tuple(sorted(overrides.items())))
    if key in _REFERENCE:
        return _REFERENCE[key]
    cj, ct = train_configs(arch, **overrides)
    pj, tree = reference_weights(cj)
    jopt = JAdamW(lr=TRAIN_LR, compress=_JStash())
    jstep = jax.jit(jax_make_train_fn(cj, jopt, microbatches=microbatches))
    pipe = jax_make_pipeline(cj, seq, TRAIN_BATCH)
    jp, js = pj, jopt.init(pj)
    out = []
    with JC.activation_sharding(types.SimpleNamespace(
            axis_names=("data",), shape={"data": dp})):
        for step in range(SHARDED_STEPS):
            before = (jax.tree.map(np.asarray, jp), js)
            jp, js, jl = jstep(jp, js, pipe.batch(step))
            out.append((before, float(jl), jax.tree.map(np.asarray, js.ef),
                        jax.tree.map(np.asarray, jp)))
    _REFERENCE[key] = (cj, ct, tree, out)
    return _REFERENCE[key]


def load_state(model, opt_state, jtree, jstate):
    """The reference's weights and moments into a ``ShardedModel`` and
    its sharded state."""
    model.load_({n: torch.from_numpy(np.array(port_leaf(jtree, n)))
                 for n, _ in model.named_parameters()})
    for mine, theirs in ((opt_state.m, jstate.m), (opt_state.v, jstate.v)):
        t = jax.tree.map(np.asarray, theirs)
        for name, sh in mine.items():
            full = torch.from_numpy(np.array(port_leaf(t, name)))
            for key, dev, piece in sh.items():
                piece.copy_(full[sh.layout.region(key)])
    return opt_state._replace(step=torch.tensor(int(jstate.step),
                                                dtype=torch.int32))


def check_sharded_against_reference(arch, dp, mp, microbatches=1,
                                    seq=TRAIN_SEQ, *, own_update=False,
                                    **overrides):
    """SHARDED_STEPS sharded steps on a (dp, mp) mesh, each from the
    reference's state before it, against the reference's steps under
    data ``dp`` (both on ``arch``'s smoke config with ``overrides``).
    With ``own_update`` the weights after each step are held bit for bit
    to the port's whole-leaf AdamW step on the sharded step's own
    gradients from the same state, and to the reference's weights
    within ``parted_near_zero``'s tolerance element by element, without
    its cap on a leaf's parted share: a 256-element norm or mix vector
    allows no parted element under the cap, and the SSM's have elements
    whose gradient is within a few Adam eps of zero, whose first update
    the gradients' rounding moves by more than the tolerance. Returns
    the last step's ``ShardedModel``."""
    cj, ct, tree, ref = reference_run(arch, dp, microbatches, seq,
                                      **overrides)
    mesh = mesh_of(dp, mp)
    model = sharded(params_from_numpy(ct, tree, device="cpu"), mesh)
    opt = AdamW(lr=TRAIN_LR, compress=_Stash())
    state = opt.init(model)
    step_fn = make_train_fn(ct, opt, microbatches=microbatches, mesh=mesh)
    pipe = make_pipeline(ct, seq, TRAIN_BATCH, device="cpu")
    parted = []
    for step, ((jtree, jstate), jl, jg, jafter) in enumerate(ref):
        state = load_state(model, state, jtree, jstate)
        with activation_sharding(mesh):
            model, state, loss = step_fn(model, state, pipe.batch(step))
        np.testing.assert_allclose(float(loss), jl, rtol=1e-5,
                                   err_msg=f"step {step}")
        grads = {n: sh.gather("cpu") for n, sh in state.ef.items()}
        grads_close(jg, grads, f"step {step}")
        got = {n: np32(p).copy() for n, p in model.named_parameters()}
        if own_update:
            plain = params_from_numpy(ct, jtree, device="cpu")
            opt.apply_(grads, _port_state(plain, jstate), plain)
            for name, p in plain.named_parameters():
                np.testing.assert_array_equal(got[name], np32(p),
                                              err_msg=name)
        parted.append(parted_near_zero(got, jafter, jg,
                                       3 * TRAIN_LR * 1e-3, f"step {step}",
                                       cap=not own_update))
    print(f"{arch} on ({dp}, {mp}), {microbatches} microbatch(es): weight "
          f"elements parted at near-zero gradients by step {parted}")
    return model
