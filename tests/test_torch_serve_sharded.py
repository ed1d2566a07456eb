"""The sharded prefill and decode steps (``make_prefill_fn(mesh=)``,
``make_serve_fn(mesh=)``: per data rank, and per model rank on a
``"model"`` > 1 mesh) on the CPU at smoke size in float32, on meshes
that name ``"cpu"`` every time, for every family, against the port's
unsharded steps and the reference's.

The unsharded runs (the port's and the reference's) run under
``activation_sharding`` of a duck mesh of the same data degree, whose
only effect is the MoE's routing groups (a data rank's rows are one
group in the sharded steps). Weights come from the reference's draw
(``lm_family_checks.smoke_pair``).

* Prefill on (1, 1), (2, 2) and (1, 4): the last position's logits,
  rtol and atol 1e-4 (the per-rank partial sums add in another order).
* Decode: three greedy steps whose tokens must be equal exactly, and
  after each step every cache leaf (gathered whole from its pieces)
  within 1e-4, relative to the leaf's largest magnitude; the enc-dec
  family's cross K/V are drawn at random (the same values everywhere).
  The caches are laid out by ``sharding.cache_specs``, and every layout
  it gives is computed:
  - on (1, 1), (2, 2) and (1, 4): the dense KV caches by heads on
    (2, 2) (2 KV heads) and by head width on (1, 4) (64 / 4), the MoE's
    and the enc-dec's by heads (4 KV heads), the hybrid's ring by head
    width (one KV head), the RG-LRU state by channels, the RWKV state
    by heads;
  - on (1, 3) (and (2, 3) for the dense family) every KV cache by
    sequence: 96 slots, the hybrid's ring of 48 (``window=48``) and the
    enc-dec's 48 source positions, from position 0 and from drawn
    caches at positions 93-95; the RWKV state stays whole;
  - the RWKV state by value width: two heads of 128 on (1, 4);
  - a batch of 1 on (2, 1) and (2, 2): every data rank computes it on
    its own copy of the caches, as the reference's program does, and
    every rank's tokens and caches equal rank 0's bit for bit.
* The split attention alone (``_cache_write``, ``_cache_attend`` by
  sequence) against ``_decode_attend`` on the whole cache, float32,
  within 1e-6 of the output's largest magnitude, where some ranks hold
  no visible slot.
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


def _caches(cj, ct, s_max, rows=B, s_src=32, start=0, seed=7):
    """The reference's and the port's caches, the same values in both:
    zeroed where ``start`` is 0 (the enc-dec family's cross K/V drawn),
    else every float leaf drawn and the hybrid's ring positions those of
    the tokens before ``start``, so that a step at ``start`` sees a full
    cache."""
    cache_j = JR.make_decode_state(cj, rows, s_max, s_src=s_src)
    cache_t = TR.make_decode_state(ct, rows, s_max, s_src=s_src,
                                   device="cpu")
    rng = np.random.default_rng(seed)
    cross = [getattr(cache_t, n, None) for n in ("cross_k", "cross_v")]
    flat_j, tree_j = jax.tree.flatten(cache_j)
    new_j = []
    for lj, lt in zip(flat_j, _leaves(cache_t)):
        assert tuple(lj.shape) == tuple(lt.shape)
        if lt.dtype.is_floating_point and (
                start > 0 or any(lt is c for c in cross)):
            val = rng.standard_normal(lt.shape).astype(np.float32) * 0.5
        elif start > 0 and lt.dtype == torch.int32 and lt.dim() == 2:
            # the hybrid's ring: slot j holds the last position before
            # start that is j modulo the ring's length
            win = lt.shape[1]
            last = (start - 1) // win * win + np.arange(win)
            last = np.where(last < start, last, last - win)
            val = np.broadcast_to(np.where(last >= 0, last, -1),
                                  lt.shape).astype(np.int32)
        else:
            new_j.append(lj)
            continue
        lt.copy_(torch.from_numpy(np.ascontiguousarray(val)))
        new_j.append(jnp.asarray(val))
    return jax.tree.unflatten(tree_j, new_j), cache_t


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


# the first leaf's model dimension by "model" degree and family: the KV
# caches (the SSM's state) by heads, head width or sequence
WANT_DIMS = {
    2: {"dense": 2, "moe": 2, "hybrid": 4, "ssm": 2, "encdec": 2},
    3: {"dense": 3, "moe": 3, "hybrid": 3, "ssm": None, "encdec": 3},
    4: {"dense": 4, "moe": 2, "hybrid": 4, "ssm": 2, "encdec": 2}}


def _check_decode(arch, dp, mp, *, rows=B, s_max=64, s_src=32, start=0,
                  want_dim=None, **overrides):
    """Three greedy steps of the sharded decode from position ``start``
    against the unsharded port's and the reference's, tokens exact, and
    every cache leaf after each step; where the data ranks do not divide
    the rows, every rank's tokens and caches equal rank 0's bit for bit.
    Returns the model-axis group of the last step (None at mp = 1)."""
    cj, ct, pj, pt = F.smoke_pair(arch, **overrides)
    steps = 3
    toks = np.random.default_rng(1).integers(
        0, ct.vocab, (rows, steps)).astype(np.int32)
    cache_j, cache_t = _caches(cj, ct, s_max, rows, s_src, start)
    mesh = make_host_mesh(mp, devices=["cpu"] * (dp * mp))
    model = _serving_model(pt, mesh)
    whole = copy.deepcopy(cache_t)
    sharded = spmd.ShardedCaches(whole, cache_specs(ct, whole, mesh), mesh)
    if mp > 1:
        want = WANT_DIMS[mp][ct.family] if want_dim is None else want_dim
        assert sharded.model_dims[0] == want
    jstep = jax.jit(jax_make_serve_fn(cj))
    plain, step = make_serve_fn(ct), make_serve_fn(ct, mesh=mesh)
    for t in range(start, start + steps):
        tt = toks[:, t - start:t - start + 1]
        with JC.activation_sharding(_duck(dp)):
            nj, cache_j = jstep(pj, jnp.asarray(tt), cache_j, jnp.int32(t))
        with ctx.activation_sharding(_duck(dp)):
            nu, cache_t = plain(pt, torch.from_numpy(tt), cache_t, t)
        ns, _ = step(model, torch.from_numpy(tt), sharded, t)
        assert ns.dtype == torch.int32 and ns.shape == (rows, 1)
        np.testing.assert_array_equal(ns.numpy(), np.asarray(nj))
        assert torch.equal(ns, nu)
        assert model.last_step["data_ranks"] == dp
        got = _leaves(sharded.gather())
        for g, u, j in zip(got, _leaves(cache_t), _leaves(cache_j)):
            assert g.shape == u.shape and g.dtype == u.dtype
            _close_leaf(g, j)
            _close_leaf(g, u)
        if rows % dp:
            for r in range(1, dp):
                assert torch.equal(model.last_step["tokens"][r], ns[:, 0])
                for a, b in zip(_leaves(sharded.rank_views(r)),
                                _leaves(sharded.rank_views(0))):
                    assert torch.equal(a, b)
            sharded.commit()
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


def _seq_overrides(arch):
    # a 48-slot ring: the smoke's 64-slot window would not divide over 3
    return {"window": 48} if arch == "recurrentgemma-2b" else {}


@pytest.mark.parametrize("late", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_sequence_split_decode_matches_unsharded_and_reference(arch, late):
    """(1, 3): neither the KV heads nor the head width divide, so every
    KV cache (the hybrid's ring, the enc-dec's self and cross K/V) is
    split over its 96 (48) slots; the SSM's state stays whole. From
    position 0 (ranks 1 and 2 hold no visible slot) and from drawn caches
    at positions 93-95 (every rank holds visible slots)."""
    _check_decode(arch, 1, 3, s_max=96, s_src=48, start=93 if late else 0,
                  **_seq_overrides(arch))


def test_sequence_split_decode_over_data_ranks():
    _check_decode("llama3.2-3b", 2, 3, s_max=96, start=93)


def test_rwkv_state_split_over_its_value_width():
    """Two heads of 128 on (1, 4): the ranks divide the head width but not
    the heads, so ``cache_specs`` splits the state on its value width
    (dim 4) and the time mix runs whole on each rank's columns."""
    _check_decode("rwkv6-7b", 1, 4, want_dim=4, rwkv_head_dim=128)


@pytest.mark.parametrize("dp,mp", [(2, 1), (2, 2)])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b",
                                  "llama3.2-3b"])
def test_batch_the_data_ranks_do_not_divide_runs_on_every_rank(arch, dp, mp):
    """Batch 1 over two data ranks: every rank computes the row from the
    step's starting state on its own copy of the caches, as the
    reference's program does; the tokens are rank 0's."""
    _check_decode(arch, dp, mp, rows=1, s_max=16)


@pytest.mark.parametrize("where", ["first", "middle", "last_rank_only"])
def test_sequence_split_attention_matches_the_whole_cache(where):
    """``_cache_write`` and ``_cache_attend`` by sequence over 3 ranks of
    16 slots against ``_decode_attend`` on the whole cache, float32:
    the new k and v land in the owner rank's slot, and the output agrees
    within 1e-6 of its largest magnitude, with no NaN. ``first``: only
    slot 0 is visible (ranks 1 and 2 see none); ``last_rank_only``: a
    one-slot window at the last slot (ranks 0 and 1 see none)."""
    from repro_torch.distributed import tp
    from repro_torch.models import attention as PA
    b, hq, hkv, s, dh, ranks = 2, 4, 2, 48, 16, 3
    pos, window = {"first": (0, None), "middle": (20, None),
                   "last_rank_only": (s - 1, 1)}[where]
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((b, hq, 1, dh), generator=gen)
    k, v = (torch.randn((b, hkv, s, dh), generator=gen) for _ in range(2))
    new_k, new_v = (torch.randn((b, hkv, 1, dh), generator=gen)
                    for _ in range(2))
    group = tp.Group(types.SimpleNamespace(axis_names=("model",),
                                           shape={"model": ranks}))
    ck, cv = tp.split_ranks(k, 2, ranks), tp.split_ranks(v, 2, ranks)
    positions = torch.tensor([pos])
    PA._cache_write(ck, new_k, positions, "seq", group)
    PA._cache_write(cv, new_v, positions, "seq", group)
    k.index_copy_(2, positions, new_k)
    v.index_copy_(2, positions, new_v)
    assert torch.equal(tp.merge_ranks(ck, 2), k)
    assert torch.equal(tp.merge_ranks(cv, 2), v)
    ki = torch.arange(s)
    valid = ki <= pos
    if window is not None:
        valid &= ki > pos - window
    got = PA._cache_attend(q, ck, cv, valid[None, :], "seq", group)
    want = PA._decode_attend(q, k, v, positions, window=window)
    assert not torch.isnan(got).any()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * scale)
    assert group.traffic["all_reduce"] > 0


def test_sharded_decode_refuses_distinct_devices():
    ct = get_config("llama3.2-3b", smoke=True)
    mesh = make_host_mesh(2, devices=["cpu", "cpu:0", "cpu", "cpu:0"])
    caches = TR.make_decode_state(ct, B, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="names one device"):
        spmd.ShardedCaches(caches, cache_specs(ct, caches, mesh), mesh)
