"""The port's activation-sharding context and the MoE's routing groups
against the reference's, on the CPU.

* ``constraint_spec`` equals the ``PartitionSpec`` the reference's
  ``constrain`` hands to ``jax.lax.with_sharding_constraint`` (captured
  with ``monkeypatch``), for every kind, at shapes the mesh axes divide
  and at shapes they do not, on duck meshes (``axis_names``, a ``shape``
  dict); where the reference makes no request, the port's spec is None;
* the context stack, ``moe_group_count`` and ``seq_parallel_enabled``
  behave as the reference's;
* the port's ``moe`` under ``activation_sharding`` with data 2 and 4
  equals the reference's grouped ``moe`` (float32, output within 1e-5 of
  its max), and its routing is the reference's group by group, exactly
  (experts, slots, drops; the reference's routing of each group's
  scores, ``lm_family_checks.reference_routing``), at a size where the
  groups drop other pairs than one group does; a token count that the
  group count does not divide routes in one group, as in the
  reference.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_family_checks as F
from lm_family_checks import one_torch_thread  # noqa: F401 — autouse
from repro.configs import get_config as jax_get_config
from repro.distributed import ctx as JC
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.distributed import ctx as PC
from repro_torch.models import moe as PM

KINDS = ("bsd", "bsd_batch_only", "bshd", "bshd_kv", "bhsd", "logits_v",
         "ecd", "gtd", "gecd", "gec", "gt")
# shapes per rank: some every axis divides, some none does
SHAPES = {2: [(8, 16), (3, 5), (16, 3), (2, 7)],
          3: [(8, 16, 32), (4, 6, 10), (3, 5, 7), (16, 3, 8), (6, 8, 3)],
          4: [(8, 16, 8, 4), (4, 6, 10, 2), (3, 5, 7, 9), (16, 3, 8, 4),
              (6, 8, 3, 2)]}
MESHES = {"data2_model2": {"data": 2, "model": 2},
          "data4_model4": {"data": 4, "model": 4},
          "pod2_data2_model8": {"pod": 2, "data": 2, "model": 8},
          "data2": {"data": 2},
          "model4": {"model": 4}}


def duck(shape: dict):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


@pytest.fixture
def captured(monkeypatch):
    """The specs the reference's ``constrain`` requests, in call order."""
    seen = []

    def capture(x, spec):
        seen.append(spec)
        return x
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", capture)
    return seen


@pytest.mark.parametrize("seq_parallel", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_constraint_spec_is_the_references_request(mesh, seq_parallel,
                                                    captured):
    m = duck(MESHES[mesh])
    asked = 0
    for kind in KINDS:
        for ndim, shapes in SHAPES.items():
            for shape in shapes:
                x = types.SimpleNamespace(shape=shape, ndim=ndim)
                captured.clear()
                with JC.activation_sharding(m, seq_parallel=seq_parallel):
                    JC.constrain(x, kind)
                with PC.activation_sharding(m, seq_parallel=seq_parallel):
                    got = PC.constraint_spec(shape, kind)
                    assert PC.constrain(x, kind) is x
                if captured:
                    asked += 1
                    assert got is not None, (kind, shape)
                    assert tuple(got) == tuple(captured[0]), (kind, shape)
                else:
                    assert got is None, (kind, shape)
    # the reference asks only on a mesh with a "model" axis
    assert bool(asked) == ("model" in MESHES[mesh])


def test_constraint_spec_off_a_mesh_is_none(captured):
    for kind in KINDS:
        x = types.SimpleNamespace(shape=(8, 16, 32), ndim=3)
        assert JC.constrain(x, kind) is x
        assert PC.constraint_spec((8, 16, 32), kind) is None
    assert not captured


def test_context_stack_as_the_references():
    outer, inner = duck({"pod": 2, "data": 4, "model": 2}), duck({"data": 3})
    for C in (JC, PC):
        assert C.moe_group_count() == 1
        assert not C.seq_parallel_enabled()
        with C.activation_sharding(outer):
            assert C.moe_group_count() == 8
            assert C.seq_parallel_enabled()
            with C.activation_sharding(inner, seq_parallel=False):
                assert C.moe_group_count() == 3
                assert not C.seq_parallel_enabled()
            assert C.moe_group_count() == 8
            with pytest.raises(RuntimeError):
                with C.activation_sharding(inner):
                    raise RuntimeError("popped on the way out")
            assert C.moe_group_count() == 8
        assert C.moe_group_count() == 1
    with PC.activation_sharding(outer), PC.rank_local():
        assert PC.moe_group_count() == 1
        assert PC.constraint_spec((8, 16, 32), "bsd") is None


def _moe_case(seed, b, s):
    """A smoke-size olmoe MoE layer (float32) whose router favours two
    experts, so capacity drops pairs, and a batch ``(b, s)``."""
    cj = dataclasses.replace(jax_get_config("olmoe-1b-7b", smoke=True),
                             dtype=jnp.float32)
    ct = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True),
                             dtype=torch.float32)
    rng = np.random.default_rng(seed)
    d, f, e = ct.d_model, ct.d_ff, ct.moe_experts
    router = rng.standard_normal((d, e)).astype(np.float32) * 0.05
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    # tokens of the first half lean on experts 0 and 1: a group of them
    # overflows where one group would not
    x[: b // 2, :, :8] += 1.0
    router[:8, :2] += 0.5
    p = {"router": router,
         "w_gate": rng.standard_normal((e, d, f)).astype(np.float32) * 0.05,
         "w_up": rng.standard_normal((e, d, f)).astype(np.float32) * 0.05,
         "w_down": rng.standard_normal((e, f, d)).astype(np.float32) * 0.05}
    layer = PM.MoE(ct, device="cpu")
    with torch.no_grad():
        for k, v in p.items():
            getattr(layer, k).copy_(torch.from_numpy(v))
    return cj, ct, p, layer, x


@pytest.mark.parametrize("data", [2, 4])
def test_grouped_moe_equals_the_references(data):
    cj, ct, p, layer, x = _moe_case(0, 8, 16)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    with JC.activation_sharding(duck({"data": data})):
        want = np.asarray(JM.moe(jp, jnp.asarray(x), cj))
    with PC.activation_sharding(duck({"data": data})), \
            PM.record_routing() as log:
        got = PM.moe(layer, torch.from_numpy(x), ct).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    (r,) = log
    assert r.groups == data
    t = x.shape[0] * x.shape[1]
    scores = (torch.from_numpy(x).reshape(t, -1) @ layer.router).float()
    tl = t // data
    for g in range(data):
        want_r = F.reference_routing(scores[g * tl:(g + 1) * tl].numpy(), cj)
        assert not F.near_ties(scores[g * tl:(g + 1) * tl].numpy(),
                               ct.moe_topk).any()
        part = PM.Routing(*(v[g * tl:(g + 1) * tl] if isinstance(
            v, torch.Tensor) else v for v in r[:6]))
        F.assert_routing(part, want_r)
    with PM.record_routing() as one:
        PM.moe(layer, torch.from_numpy(x), ct)
    dropped = r.dropped_by_group()
    assert dropped.shape == (data,)
    assert int(dropped.sum()) == int((~r.keep).sum())
    assert int(dropped.sum()) != int((~one[0].keep).sum()), \
        "pick a size where the groups drop other pairs than one group"


def test_group_count_falls_back_to_one_group():
    """15 tokens over data 2: the reference and the port route in one
    group."""
    cj, ct, p, layer, x = _moe_case(1, 3, 5)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    with JC.activation_sharding(duck({"data": 2})):
        want = np.asarray(JM.moe(jp, jnp.asarray(x), cj))
    with PC.activation_sharding(duck({"data": 2})), \
            PM.record_routing() as log:
        got = PM.moe(layer, torch.from_numpy(x), ct).numpy()
        assert PM.group_count(15) == 1 and PM.group_count(16) == 2
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert log[0].groups == 1
    assert log[0].cap == PM.capacity(15, ct)


def test_one_group_is_unchanged_bitwise():
    """Off a mesh and under data 1 the MoE is the one-group MoE, bit for
    bit."""
    _, ct, _, layer, x = _moe_case(2, 4, 16)
    xt = torch.from_numpy(x)
    base = PM.moe(layer, xt, ct)
    with PC.activation_sharding(duck({"data": 1, "model": 4})):
        assert torch.equal(PM.moe(layer, xt, ct), base)
    with PC.activation_sharding(duck({"data": 4})), PC.rank_local():
        assert torch.equal(PM.moe(layer, xt, ct), base)
