"""Checks shared by the port's per-family LM tests against the reference.

``tests/test_torch_moe.py``, ``test_torch_hybrid.py`` and
``test_torch_ssm.py`` run these on their family's smoke configs: the
reference draws the weights (``PRNGKey``) and the port takes the same
values through ``models.convert.params_from_numpy``; tokens come from
numpy. Tolerances (float32 1e-4, bf16 3e-2, greedy tokens exact except
counted near-ties) are the ones ``tests/test_torch_lm.py`` states for
the dense family.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cells_for as jax_cells_for
from repro.configs import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.models import registry as JR
from repro_torch.configs import cells_for, get_config
from repro_torch.configs.base import smoke_variant
from repro_torch.launch.serve import generate, make_prompts
from repro_torch.models import registry as TR
from repro_torch.models.convert import params_from_numpy, params_to_numpy

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
