"""The sharded prefill and decode steps (``make_prefill_fn(mesh=)``,
``make_serve_fn(mesh=)``: per data rank, and per model rank on a
``"model"`` > 1 mesh) on the CPU at smoke size in float32, on meshes
(1, 1), (2, 2) and (1, 4) that name ``"cpu"`` every time, for every
family, against the port's unsharded steps and the reference's.

The unsharded runs (the port's and the reference's) run under
``activation_sharding`` of a duck mesh of the same data degree, whose
only effect is the MoE's routing groups (a data rank's rows are one
group in the sharded steps). Weights come from the reference's draw
(``lm_family_checks.smoke_pair``).

* Prefill: the last position's logits, rtol and atol 1e-4 (the
  per-rank partial sums add in another order).
* Decode: three greedy steps from position 0 whose tokens must be equal
  exactly, then every cache leaf (gathered whole from its pieces) within
  1e-4, relative to the leaf's largest magnitude; the enc-dec family's
  cross K/V are drawn at random (the same values everywhere). The caches
  are laid out by ``sharding.cache_specs``: the dense KV caches by heads
  on (2, 2) (2 KV heads) and by head width on (1, 4) (64 / 4), the
  MoE's and the enc-dec's by heads (4 KV heads), the hybrid's ring by
  head width (one KV head), the RG-LRU state by channels, the RWKV state
  by heads.
* A batch the data ranks do not divide is computed once, as the
  reference replicates it.
"""

import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_family_checks as F
from lm_family_checks import one_torch_thread  # noqa: F401 — autouse
from repro.distributed import ctx as JC
from repro.models import registry as JR
from repro.train.step import make_prefill_fn as jax_make_prefill_fn
from repro.train.step import make_serve_fn as jax_make_serve_fn
from repro_torch.configs import get_config
from repro_torch.distributed import ctx, spmd
from repro_torch.distributed.sharding import cache_specs, param_specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import registry as TR
from repro_torch.train.step import make_prefill_fn, make_serve_fn

FAMILIES = ("llama3.2-3b", "olmoe-1b-7b", "recurrentgemma-2b", "rwkv6-7b",
            "seamless-m4t-large-v2")
MESHES = [(1, 1), (2, 2), (1, 4)]
B = 4
TOL = 1e-4


def _duck(dp):
    return types.SimpleNamespace(axis_names=("data",), shape={"data": dp})


def _seq(cfg):
    return 128 if cfg.family in ("hybrid", "ssm") else 64


def _serving_model(pt, mesh):
    specs = param_specs(pt, mesh, serving=True)
    return spmd.ShardedModel(copy.deepcopy(pt), mesh, specs, specs)


def _batch(cfg, s, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["src_embeds"] = (rng.standard_normal((B, s, cfg.d_model))
                             .astype(np.float32))
    return out


def _check_prefill(arch, dp, mp, **overrides):
    """The sharded prefill's last logits against the unsharded port's and
    the reference's; returns the model-axis group (None at mp = 1)."""
    cj, ct, pj, pt = F.smoke_pair(arch, **overrides)
    batch = _batch(ct, _seq(ct))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with JC.activation_sharding(_duck(dp)):
        want = np.asarray(jax.jit(jax_make_prefill_fn(cj))(
            pj, {k: jnp.asarray(v) for k, v in batch.items()}))
    with ctx.activation_sharding(_duck(dp)):
        plain = make_prefill_fn(ct, backend="plain")(pt, tb)
    mesh = make_host_mesh(mp, devices=["cpu"] * (dp * mp))
    model = _serving_model(pt, mesh)
    got = make_prefill_fn(ct, mesh=mesh)(model, tb)
    assert got.shape == (B, ct.vocab)
    F.close(got, want, TOL)
    torch.testing.assert_close(got, plain, rtol=TOL, atol=TOL)
    group = model.last_step["group"]
    assert (group is None) == (mp == 1)
    if group is not None:
        assert group.seq_parallel
        assert group.traffic["all_gather"] > 0
    return group


@pytest.mark.parametrize("dp,mp", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_prefill_matches_unsharded_and_reference(arch, dp, mp):
    _check_prefill(arch, dp, mp)


def _caches(cj, ct, s_max, seed=7):
    """The reference's and the port's zeroed caches (the enc-dec
    family's cross K/V drawn, the same values in both)."""
    cache_j = JR.make_decode_state(cj, B, s_max, s_src=32)
    cache_t = TR.make_decode_state(ct, B, s_max, s_src=32, device="cpu")
    if ct.family == "encdec":
        rng = np.random.default_rng(seed)
        ck, cv = (rng.standard_normal(cache_t.cross_k.shape)
                  .astype(np.float32) * 0.5 for _ in range(2))
        cache_j = cache_j._replace(cross_k=jnp.asarray(ck),
                                   cross_v=jnp.asarray(cv))
        cache_t = cache_t._replace(cross_k=torch.from_numpy(ck),
                                   cross_v=torch.from_numpy(cv))
    return cache_j, cache_t


def _leaves(tree):
    return [leaf for f in tree if f is not None
            for leaf in (f if isinstance(f, tuple) else (f,))]


def _close_leaf(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if got.dtype.kind in "iu" or want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want)
        return
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def _check_decode(arch, dp, mp, **overrides):
    """Three greedy steps of the sharded decode against the unsharded
    port's and the reference's, tokens exact, then the caches; returns
    the model-axis group of the last step (None at mp = 1)."""
    cj, ct, pj, pt = F.smoke_pair(arch, **overrides)
    steps, s_max = 3, 64
    toks = np.random.default_rng(1).integers(
        0, ct.vocab, (B, steps)).astype(np.int32)
    cache_j, cache_t = _caches(cj, ct, s_max)
    mesh = make_host_mesh(mp, devices=["cpu"] * (dp * mp))
    model = _serving_model(pt, mesh)
    whole = copy.deepcopy(cache_t)
    sharded = spmd.ShardedCaches(whole, cache_specs(ct, whole, mesh), mesh)
    if mp > 1:
        want_dims = {"dense": 2 if mp == 2 else 4, "moe": 2,
                     "hybrid": 4, "ssm": 2,
                     "encdec": 2}[ct.family]
        assert sharded.model_dims[0] == want_dims
    jstep = jax.jit(jax_make_serve_fn(cj))
    plain, step = make_serve_fn(ct), make_serve_fn(ct, mesh=mesh)
    for t in range(steps):
        tj = jnp.asarray(toks[:, t:t + 1])
        with JC.activation_sharding(_duck(dp)):
            nj, cache_j = jstep(pj, tj, cache_j, jnp.int32(t))
        with ctx.activation_sharding(_duck(dp)):
            nu, cache_t = plain(pt, torch.from_numpy(toks[:, t:t + 1]),
                                cache_t, t)
        ns, _ = step(model, torch.from_numpy(toks[:, t:t + 1]), sharded, t)
        assert ns.dtype == torch.int32 and ns.shape == (B, 1)
        np.testing.assert_array_equal(ns.numpy(), np.asarray(nj))
        assert torch.equal(ns, nu)
    got = _leaves(sharded.gather())
    for g, u, j in zip(got, _leaves(cache_t), _leaves(cache_j)):
        assert g.shape == u.shape and g.dtype == u.dtype
        _close_leaf(g, j)
        _close_leaf(g, u)
    return model.last_step["group"]


@pytest.mark.parametrize("dp,mp", MESHES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_decode_matches_unsharded_and_reference(arch, dp, mp):
    _check_decode(arch, dp, mp)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "seamless-m4t-large-v2"])
def test_a_vocabulary_the_model_ranks_do_not_divide_keeps_the_head_whole(
        arch):
    """Vocabulary 1001 on (1, 4): the head is whole on every rank; the
    prefill's logits over every position split by sequence (the last
    rank's last row kept), the decode's replicated."""
    v = 1001
    group = _check_prefill(arch, 1, 4, vocab=v)
    assert ("logits_v", (B, _seq(get_config(arch, smoke=True)), v), 1) \
        in group.layouts
    group = _check_decode(arch, 1, 4, vocab=v)
    assert ("logits_v", (B, 1, v), None) in group.layouts


@pytest.mark.parametrize("arch", ["rwkv6-7b", "llama3.2-3b"])
def test_batch_the_data_ranks_do_not_divide_runs_once(arch):
    ct = dataclasses.replace(get_config(arch, smoke=True), n_layers=2)
    pt = TR.init_params(ct, generator=torch.Generator().manual_seed(3),
                        device="cpu")
    mesh = make_host_mesh(2, devices=["cpu"] * 4)
    model = _serving_model(pt, mesh)
    cache_t = TR.make_decode_state(ct, 1, 16, device="cpu")
    whole = copy.deepcopy(cache_t)
    sharded = spmd.ShardedCaches(whole, cache_specs(ct, whole, mesh), mesh)
    step, plain = make_serve_fn(ct, mesh=mesh), make_serve_fn(ct)
    tok = torch.tensor([[5]], dtype=torch.int32)
    for t in range(2):
        ns, _ = step(model, tok, sharded, t)
        nu, cache_t = plain(pt, tok, cache_t, t)
        assert torch.equal(ns, nu)
        tok = ns
    assert model.last_step["data_ranks"] == 1
    for g, u in zip(_leaves(sharded.gather()), _leaves(cache_t)):
        _close_leaf(g, u.numpy())


def test_sharded_decode_refuses_distinct_devices():
    ct = get_config("llama3.2-3b", smoke=True)
    mesh = make_host_mesh(2, devices=["cpu", "cpu:0", "cpu", "cpu:0"])
    caches = TR.make_decode_state(ct, B, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="names one device"):
        spmd.ShardedCaches(caches, cache_specs(ct, caches, mesh), mesh)
