"""The port's sharding rules against the reference's, on the CPU.

``repro_torch.distributed.sharding`` against ``repro.distributed.sharding``
for all ten configs at full width (the port's models on the meta
device, the reference's ``init_params(abstract=True)``), on duck meshes
(``axis_names`` and a ``shape`` dict, all the reference's rules read)
of shapes (1, 1), (2, 1), (4, 2), (16, 16) and (2, 16, 16). The port's
parameters are per member of a stacked group; the reference's specs
carry a leading entry for the stacked axis, which is dropped before the
comparison, and the reference's short specs (``P()``) are padded with
None. Every comparison is exact.
"""

import types

import jax
import pytest

from repro.configs import get_config as jax_get_config
from repro.distributed import sharding as JS
from repro.models import registry as JR
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.distributed import sharding as S
from repro_torch.distributed.ctx import PartitionSpec
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import registry as TR
from repro_torch.models.convert import _tree_path
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import LM

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def duck(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)))


_TREES: dict = {}


def trees(arch):
    """The reference's abstract tree and the port's model on the meta
    device, at full width."""
    if arch not in _TREES:
        ct = get_config(arch)
        model = (EncDec if ct.family == "encdec" else LM)(ct, device="meta")
        _TREES[arch] = (JR.init_params(jax_get_config(arch), abstract=True),
                        model)
    return _TREES[arch]


def reference_spec(tree, name, ndim):
    """The reference's spec of the port's parameter ``name`` (of rank
    ``ndim``), padded, its stacked axis dropped."""
    node = tree
    path, row = _tree_path(name)
    for key in path:
        node = node[key]
    spec = tuple(node) + (None,) * (ndim + (row is not None) - len(node))
    return spec[1:] if row is not None else spec


def assert_same(want_tree, got, model, what):
    bad = []
    for name, p in model.named_parameters():
        want = reference_spec(want_tree, name, p.ndim)
        if tuple(got[name]) != want:
            bad.append((name, got[name], want))
    assert not bad, (what, len(bad), bad[:4])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_opt_specs_equal_the_references(arch, mesh):
    pj, model = trees(arch)
    m = duck(mesh)
    for serving in (False, True):
        assert_same(JS.param_specs(pj, m, serving=serving),
                    S.param_specs(model, m, serving=serving), model,
                    f"{arch} {mesh} param_specs serving={serving}")
    for zero in (False, True):
        assert_same(JS.opt_state_specs(pj, m, zero=zero),
                    S.opt_state_specs(model, m, zero=zero), model,
                    f"{arch} {mesh} opt_state_specs zero={zero}")


def _leaves(tree):
    out = []

    def walk(x):
        if x is None:
            return
        if isinstance(x, PartitionSpec) or not isinstance(
                x, (dict, tuple, list)):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        else:
            for v in x:
                walk(v)
    walk(tree)
    return out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_equal_the_references(arch):
    """Every decode-cache leaf of both packages, in order: the same
    shape and the same spec, on the (4, 2) and (16, 16) meshes."""
    cj, ct = jax_get_config(arch), get_config(arch)
    jc = JR.make_decode_state(cj, 16, 64, s_src=32, abstract=True)
    tc = TR.make_decode_state(ct, 16, 64, s_src=32, device="meta")
    jl, tl = jax.tree.leaves(jc), _leaves(tc)
    assert [tuple(x.shape) for x in jl] == [tuple(x.shape) for x in tl]
    for mesh in ("4x2", "16x16"):
        m = duck(mesh)
        js = jax.tree.leaves(JS.cache_specs(cj, jc, m), is_leaf=lambda x:
                             isinstance(x, jax.sharding.PartitionSpec))
        ts = _leaves(S.cache_specs(ct, tc, m))
        assert [tuple(a) + (None,) * (len(x.shape) - len(a))
                for a, x in zip(js, jl)] == [tuple(b) for b in ts], mesh


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["llama3.2-3b", "seamless-m4t-large-v2"])
def test_batch_specs_equal_the_references(arch, mesh):
    cj, ct = jax_get_config(arch), get_config(arch)
    for kind in ("train", "prefill", "decode"):
        want = JS.batch_specs(cj, duck(mesh), kind)
        got = S.batch_specs(ct, duck(mesh), kind)
        assert {k: tuple(v) for k, v in want.items()} == \
            {k: tuple(v) for k, v in got.items()}, kind


def test_moe_expert_leaves_take_the_expert_rule():
    """A per-layer ``(e, d, f)`` expert leaf read as stacked would take
    the dense ``ffn.w_gate`` rule, ``(data, model)`` on ``(d, f)``; the
    port computes it on the stacked shape: experts on ``"model"``, FSDP
    over d_model."""
    _, model = trees("olmoe-1b-7b")
    m = duck("16x16")
    specs = S.param_specs(model, m)
    for leaf in ("w_gate", "w_up", "w_down"):
        assert tuple(specs[f"layers.0.ffn.{leaf}"]) == \
            ("model", "data", None), leaf
    assert tuple(specs["layers.0.ffn.router"]) == (None, None)
    assert tuple(specs["layers.0.attn.wq"]) == ("data", "model")
    # applied to the per-layer leaf directly, the dense rule would win
    assert S._spec_for("layers.ffn.w_gate",
                       tuple(model.layers[0].ffn.w_gate.shape),
                       m) == (None, "data", "model")


def test_specs_on_a_port_mesh_and_shardings():
    """A port ``Mesh`` works where a duck mesh does, and
    ``param_shardings`` pairs each spec with its mesh."""
    mesh = make_host_mesh(2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    _, model = trees("llama3.2-3b")
    pj, _ = trees("llama3.2-3b")
    assert_same(JS.param_specs(pj, duck("4x2")), S.param_specs(model, mesh),
                model, "port mesh")
    sh = S.param_shardings(model, mesh)
    assert sh["embed"].mesh is mesh
    assert tuple(sh["embed"].spec) == ("model", "data")


def test_specs_allocate_nothing():
    """A full-width model on the meta device gives its specs: nothing is
    allocated (``qwen3-moe-235b-a22b`` whole is 470 GB in bf16)."""
    _, model = trees("qwen3-moe-235b-a22b")
    assert all(p.device.type == "meta" for p in model.parameters())
    specs = S.opt_state_specs(model, duck("2x16x16"))
    assert tuple(specs["layers.0.ffn.w_gate"]) == ("model", ("pod", "data"),
                                                   None)
