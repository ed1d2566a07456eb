"""The port's sharded train step against the reference's, on the CPU:
the dense family, the (1, 1) mesh, the clip and the compression on
shards, checkpoints across meshes, the CLI, the meshes, the layouts and
their byte counts, and a mesh of two distinct devices (the MoE and the
other families: ``tests/test_torch_train_sharded_{moe,families}.py``).
On meshes whose ``"model"`` axis is more than 1 the dense, MoE and
enc-dec steps compute tensor- (and expert-) parallel
(``tests/test_torch_train_tp.py`` holds that compute on wider meshes).

Meshes name the CPU several times (``make_host_mesh(mp, devices=["cpu"]
* n)``), which runs the placement, gather, reduce-scatter and per-piece
update for real on one device. The reference's step runs jitted under
``activation_sharding`` of a duck mesh with the same data-parallel
degree (``{"data": dp}``: the reference's sharded semantics are its MoE
group count; its layout requests move no data and need a real mesh only
on a ``"model"`` axis), on the smoke configs of
``tests/lm_family_checks.py``'s training section (batch 4 x 64 tokens,
lr 1e-3, float32, the reference's weights from ``PRNGKey(0)``).

Tolerances are those of the unsharded train tests
(``lm_family_checks.check_train_steps``), each port step started from the
reference's weights and moments before it: every loss rtol 1e-5; every
gradient the update saw within 1e-4 of its leaf's max |g|; the weights
after each step within 3·lr·1e-3, except elements at a near-zero
gradient, where Adam's first update may take either sign (at most 0.1 %
of a leaf, ``parted_near_zero``). Exact: the (1, 1) mesh against the
port's unsharded step (every weight, moment and loss, two steps, with
and without microbatches and int8 compression); the int8 compression on
shards against its whole-leaf result; two steps on a mesh of ``"cpu"``
and ``"cpu:0"`` (per-piece paths) against the one-device mesh (stacked
paths). The clip's norm on shards (each leaf gathered whole) is the
whole-leaf norm bit for bit, and so is a clipped step's result.
The CLI and checkpoint cases hold losses at rtol 1e-5 to the run they
continue.
"""

import copy
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import lm_family_checks as F
from lm_family_checks import one_torch_thread  # noqa: F401 — autouse
from repro_torch.configs import get_config
from repro_torch.data import make_pipeline
from repro_torch.distributed import spmd
from repro_torch.distributed.ctx import activation_sharding
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.registry import init_params
from repro_torch.optim import AdamW, Int8EF
from repro_torch.optim.adamw import leaf_sum_sq
from repro_torch.train.step import make_train_fn

LR = F.TRAIN_LR
mesh_of, sharded = F.mesh_of, F.sharded


@pytest.mark.parametrize("dp,mp,microbatches", [
    (1, 1, 1), (2, 1, 1), (1, 2, 1), (2, 2, 1), (2, 2, 2), (4, 1, 1)])
def test_dense_sharded_step_matches_reference(dp, mp, microbatches):
    F.check_sharded_against_reference("llama3.2-3b", dp, mp, microbatches)


def _bitwise_pair(arch, microbatches, compress):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    base = init_params(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    opt = AdamW(lr=LR, compress=compress)
    pipe = make_pipeline(cfg, 32, 4, device="cpu")
    plain = copy.deepcopy(base)
    pstate = opt.init(plain)
    mesh = mesh_of(1, 1)
    model = sharded(copy.deepcopy(base), mesh)
    state = opt.init(model)
    f = make_train_fn(cfg, opt, microbatches=microbatches)
    g = make_train_fn(cfg, opt, microbatches=microbatches, mesh=mesh)
    for step in range(2):
        plain, pstate, want = f(plain, pstate, pipe.batch(step))
        with activation_sharding(mesh):
            model, state, got = g(model, state, pipe.batch(step))
        assert torch.equal(got, want), step
    return plain, pstate, model, state


@pytest.mark.parametrize("compress", [None, "int8"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "olmoe-1b-7b"])
def test_one_position_mesh_is_the_unsharded_step_bitwise(arch, microbatches,
                                                         compress):
    plain, pstate, model, state = _bitwise_pair(
        arch, microbatches, Int8EF() if compress else None)
    for (name, a), (_, b) in zip(plain.named_parameters(),
                                 model.named_parameters()):
        assert torch.equal(a, b), name
    for mine, theirs in ((state.m, pstate.m), (state.v, pstate.v)) + (
            ((state.ef, pstate.ef),) if compress else ()):
        for name, sh in mine.items():
            assert torch.equal(sh.gather("cpu"), theirs[name]), name
    assert int(state.step) == int(pstate.step) == 2


def _random_shards(seed=0):
    """Gradients and error feedback of three leaves, whole and as pieces
    on a (4, 2) mesh by the moment specs of a small module."""
    gen = torch.Generator().manual_seed(seed)
    module = torch.nn.Module()
    module.embed = torch.nn.Parameter(torch.empty(64, 32))
    module.lm_head = torch.nn.Parameter(torch.empty(32, 64))
    module.final_norm = torch.nn.Parameter(torch.empty(256))
    for p in module.parameters():
        with torch.no_grad():
            p.normal_(generator=gen)
    mesh = mesh_of(4, 2)
    model = sharded(module, mesh)
    grads = {n: torch.randn(p.shape, generator=gen) * 3
             for n, p in module.named_parameters()}
    ef = {n: torch.randn(p.shape, generator=gen) * 1e-2
          for n, p in module.named_parameters()}
    lay = model.moment_layouts
    return (module, model, grads, ef,
            {n: spmd.Sharded.place(g, lay[n]) for n, g in grads.items()},
            {n: spmd.Sharded.place(e, lay[n]) for n, e in ef.items()})


def test_int8_on_shards_is_the_whole_leaf_result():
    _, model, grads, ef, gs, es = _random_shards()
    assert all(len(sh.layout.keys) > 1 for sh in gs.values())
    want_g, want_e = Int8EF().apply(grads, ef)
    got_g, got_e = Int8EF().apply_shards(gs, es)
    for name in grads:
        assert torch.equal(got_g[name].gather("cpu"), want_g[name]), name
        assert torch.equal(got_e[name].gather("cpu"), want_e[name]), name


def test_clip_on_shards_is_the_whole_leaf_result():
    """The clip norm over pieces (each leaf gathered whole) is the whole
    leaves' bit for bit, and so is one clipped AdamW step on the pieces
    against the whole-leaf step, with the norm far above the clip."""
    module, model, grads, ef, gs, _ = _random_shards(1)
    for name, g in grads.items():
        assert torch.equal(leaf_sum_sq(gs[name].gather(model.home)),
                           torch.sum(g * g)), name
    opt = AdamW(lr=0.1, clip_norm=1.0)
    plain = copy.deepcopy(module)
    opt.apply_(grads, opt.init(plain), plain)
    opt.apply_shards_(gs, opt.init(model), model)
    for (name, a), (_, b) in zip(plain.named_parameters(),
                                 model.named_parameters()):
        assert torch.equal(b, a), name


def test_microbatch_rows_must_split_over_the_ranks():
    cfg = get_config("llama3.2-3b", smoke=True)
    mesh = mesh_of(4, 1)
    model = sharded(init_params(cfg, device="cpu"), mesh)
    opt = AdamW(lr=LR)
    batch = make_pipeline(cfg, 16, 4, device="cpu").batch(0)
    step = make_train_fn(cfg, opt, microbatches=2, mesh=mesh)
    with pytest.raises(ValueError, match="2 rows do not split over 4"):
        step(model, opt.init(model), batch)


def _ckpt_run(tmp, **kw):
    cfg = get_config("llama3.2-3b", smoke=True)
    return launch_train.train(cfg, steps=4, batch=4, seq=32, lr=5e-3,
                              ckpt_dir=tmp, ckpt_every=2, device="cpu",
                              log=lambda s: None, **kw)


@pytest.mark.parametrize("first,second", [("sharded", "unsharded"),
                                          ("unsharded", "sharded")])
def test_checkpoint_resumes_across_meshes(tmp_path, first, second):
    """A run on one mesh killed after step 1's checkpoint resumes on the
    other and follows the uninterrupted run (losses rtol 1e-5)."""
    meshes = {"sharded": dict(mesh_devices=["cpu"] * 4, model_parallel=2),
              "unsharded": {}}
    full = _ckpt_run(tmp_path / "a", **meshes[first])
    assert isinstance(full.params, spmd.ShardedModel) == (first == "sharded")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    shutil.rmtree(tmp_path / "b" / "step_3")
    resumed = _ckpt_run(tmp_path / "b", **meshes[second])
    assert resumed.start == 2
    np.testing.assert_allclose([resumed.losses[s] for s in (2, 3)],
                               [full.losses[s] for s in (2, 3)], rtol=1e-5)


def test_cli_meshes(capsys):
    cfg = get_config("olmoe-1b-7b", smoke=True)
    run = launch_train.train(cfg, steps=2, batch=4, seq=16,
                             mesh_devices=["cpu"] * 4, model_parallel=2,
                             log=lambda s: None)
    assert run.params.mesh.shape == {"data": 2, "model": 2}
    assert all(np.isfinite(list(run.losses.values())))
    # a one-device pool: the (1, 1) mesh, as the reference on one device
    launch_train.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                       "--mesh", "host", "--model-parallel", "2", "--steps",
                       "2", "--batch", "2", "--seq", "16"])
    assert "step     1 loss" in capsys.readouterr().out
    for mesh in ("production", "production-multipod"):
        with pytest.raises(RuntimeError, match="need (256|512) devices"):
            launch_train.main(["--arch", "olmoe-1b-7b", "--smoke",
                               "--device", "cpu", "--mesh", mesh])
    assert launch_train.make_mesh("production", devices=["cpu"] * 256
                                  ).shape == {"data": 16, "model": 16}


@pytest.mark.parametrize("devices", [["cpu"] * 8, ["cpu", "cpu:0"] * 4])
def test_layout_place_and_gather(devices):
    """Pieces follow the spec as JAX's do (a tuple of axes splits a dim
    over their product, the first name major); each piece is stored once
    a distinct device; placing and gathering is the identity, bit for
    bit, also where a device holds only some pieces."""
    mesh = make_host_mesh(2, devices=devices)          # data 4, model 2
    full = torch.randn(8, 6, generator=torch.Generator().manual_seed(0))
    lay = spmd.Layout(full.shape, ("model", None), mesh)
    assert lay.counts == (2, 1) and lay.block == (4, 6)
    assert lay.key_at[(3, 1)] == (1, 0)
    lay2 = spmd.Layout((8, 6), (("data", "model"), None), mesh)
    assert lay2.counts == (8, 1)
    assert [lay2.key_at[(d, m)][0] for d in range(4) for m in range(2)] \
        == list(range(8))
    for layout in (lay, lay2, spmd.Layout((8, 6), (None, "model"), mesh)):
        sh = spmd.Sharded.place(full, layout)
        stored = sum(st.shape[0] for st in sh.stacks.values())
        assert stored == sum(len(layout.holders[k]) for k in layout.keys)
        if len(set(devices)) == 1:
            assert stored == len(layout.keys)
        for dev in ("cpu", "cpu:0"):
            assert torch.equal(sh.gather(dev), full)
        for key, dev, piece in sh.items():
            assert torch.equal(piece, full[layout.region(key)])
    with pytest.raises(ValueError, match="does not divide"):
        spmd.Layout((7, 6), ("data", None), mesh)


def test_traffic_and_bytes_per_position():
    """On (2, 2), data-parallel compute: a (data, model) leaf leaves each
    data rank's group half its pieces to gather and half its gradient to
    send; a replicated leaf moves nothing. Tensor-parallel compute (the
    2-D leaf split by columns over the model ranks): each position
    gathers the other data rank's half of its model shard and sends its
    shard's gradient less its own piece; the replicated leaf is gathered
    by no one, and its gradient, whose moment is cut over data, is sent
    less each position's half. The activation collectives' bytes come as
    counted. Each position holds a quarter of the 2-D leaf."""
    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.zeros(16, 8))
    module.g = torch.nn.Parameter(torch.zeros(8))
    mesh = mesh_of(2, 2)
    model = spmd.ShardedModel(module, mesh, {"w": ("data", "model"),
                                             "g": (None,)},
                              {"w": ("data", "model"), "g": ("data",)})
    none = {"model_all_gather_bytes": 0, "model_reduce_scatter_bytes": 0,
            "model_all_reduce_bytes": 0}
    t = spmd.traffic(model.layouts, model.moment_layouts, model.dtypes,
                     microbatches=2)
    assert t == {"gathered_bytes": 2 * 16 * 8 * 4 // 2,
                 "reduce_scatter_bytes": 2 * 2 * (16 * 8 * 4 // 2
                                                  + 8 * 4 // 2), **none}
    t = spmd.traffic(model.layouts, model.moment_layouts, model.dtypes,
                     microbatches=2, splits={"w": 1, "g": None},
                     activations={"all_gather": 5, "all_reduce": 7})
    assert t == {"gathered_bytes": 4 * 16 * 8 * 4 // 4,
                 "reduce_scatter_bytes": 2 * 4 * (16 * 8 * 4 // 4
                                                  + 8 * 4 // 2),
                 "model_all_gather_bytes": 5,
                 "model_reduce_scatter_bytes": 0,
                 "model_all_reduce_bytes": 7}
    assert model.shard_nbytes() == {
        "params_per_shard": 16 * 8 * 4 // 4 + 8 * 4,
        "params_total": (16 * 8 + 8) * 4,
        "moment_per_shard": 16 * 8 * 4 // 4 + 8 * 4 // 2,
        "moment_total": (16 * 8 + 8) * 4}


def test_distinct_devices_take_the_per_piece_paths_bitwise():
    """``"cpu"`` and ``"cpu:0"`` are distinct mesh devices: each then
    holds only some pieces, so placement, the gathers (a second gathered
    module), the reduce-scatter, the compression and the update run piece
    by piece, with copies between the devices. Two steps give the
    one-device mesh's results bit for bit."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True),
                              dtype=torch.float32)
    base = init_params(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    pipe = make_pipeline(cfg, 32, 8, device="cpu")
    out = []
    for devices in (["cpu"] * 4, ["cpu", "cpu", "cpu:0", "cpu:0"]):
        mesh = make_host_mesh(2, devices=devices)
        model = sharded(copy.deepcopy(base), mesh)
        if devices[-1] == "cpu:0":
            assert len(model.leaves["embed"].stacks) == 2
            assert len(set(map(str, model.compute_devices()))) == 2
        opt = AdamW(lr=LR, compress=Int8EF())
        state = opt.init(model)
        step = make_train_fn(cfg, opt, mesh=mesh)
        for s in range(2):
            with activation_sharding(mesh):
                model, state, loss = step(model, state, pipe.batch(s))
        out.append((loss, dict(model.named_parameters()),
                    {n: sh.gather("cpu") for n, sh in state.v.items()}))
    (la, pa, va), (lb, pb, vb) = out
    assert torch.equal(la, lb)
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
        assert torch.equal(va[name], vb[name]), name


def test_meshes_as_the_references():
    """The host mesh takes (n // mp, mp) of the pool, mp at most n, and
    raises where mp does not divide n (``jax.make_mesh`` does); the
    production meshes take the first 256 or 512 entries and raise on a
    smaller pool, never shrinking."""
    from repro_torch.launch.mesh import make_production_mesh
    assert mesh_of(1, 1).shape == {"data": 1, "model": 1}
    assert make_host_mesh(8, devices=["cpu"] * 2).shape == \
        {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(2, devices=["cpu"] * 3)
    pod = make_production_mesh(multi_pod=True, devices=["cpu"] * 600)
    assert pod.axis_names == ("pod", "data", "model")
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(RuntimeError, match="need 256 devices"):
        make_production_mesh(devices=["cpu"] * 255)
