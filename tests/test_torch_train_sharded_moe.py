"""The port's sharded MoE train step against the reference's, on the
CPU (``olmoe-1b-7b`` at smoke size, float32; the runner and its
tolerances: ``tests/lm_family_checks.py``'s sharded section and
``tests/test_torch_train_sharded.py``'s docstring).

The reference routes each microbatch in data-degree groups; the port's
ranks each route their own rows as one group. Besides the steps, the
pairs each rank drops are held, layer by layer, to the groups of the
port's unsharded step under ``activation_sharding`` with data 2 (whose
routing ``tests/test_torch_ctx.py`` holds to the reference's, group by
group), exactly, and their sum differs from one group's.
"""

import types

import pytest

import lm_family_checks as F
from lm_family_checks import one_torch_thread  # noqa: F401 — autouse
from repro_torch.data import make_pipeline
from repro_torch.distributed.ctx import activation_sharding
from repro_torch.models import moe as PM
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import AdamW
from repro_torch.train.step import make_train_fn

LR = F.TRAIN_LR
mesh_of, sharded = F.mesh_of, F.sharded


@pytest.mark.parametrize("dp,mp,microbatches", [
    (1, 2, 2), (2, 1, 1), (2, 2, 1), (2, 2, 2), (4, 1, 1)])
def test_moe_sharded_step_matches_reference(dp, mp, microbatches):
    F.check_sharded_against_reference("olmoe-1b-7b", dp, mp, microbatches)


def test_moe_drops_by_group_are_the_references():
    """On (2, 2) with 2 microbatches each rank routes its row as one
    group: the pairs each rank drops, layer by layer, are those of the
    unsharded step's groups under ``activation_sharding`` with data 2
    (whose routing ``tests/test_torch_ctx.py`` holds to the reference's
    group by group), and their sum is not one group's."""
    cj, ct = F.train_configs("olmoe-1b-7b")
    _, tree = F.reference_weights(cj)
    mesh = mesh_of(2, 2)
    model = sharded(params_from_numpy(ct, tree, device="cpu"), mesh)
    opt = AdamW(lr=LR)
    batch = make_pipeline(ct, F.TRAIN_SEQ, F.TRAIN_BATCH,
                          device="cpu").batch(0)
    with activation_sharding(mesh), PM.record_routing() as log:
        make_train_fn(ct, opt, microbatches=2, mesh=mesh)(
            model, opt.init(model), batch)
    # microbatch, then rank, then layer
    n = ct.n_layers
    assert len(log) == 4 * n
    assert all(r.groups == 1 and r.expert.shape[0] == F.TRAIN_SEQ
               for r in log)
    by_rank = [[int((~log[(mb * 2 + rank) * n + layer].keep).sum())
                for rank in range(2)]
               for mb in range(2) for layer in range(n)]
    runs = {}
    for data in (1, 2):
        one = params_from_numpy(ct, tree, device="cpu")
        with activation_sharding(types.SimpleNamespace(
                axis_names=("data",), shape={"data": data})), \
                PM.record_routing() as runs[data]:
            make_train_fn(ct, opt, microbatches=2)(one, opt.init(one), batch)
    assert [r.dropped_by_group().tolist() for r in runs[2]] == by_rank
    assert sum(map(sum, by_rank)) != \
        sum(int((~r.keep).sum()) for r in runs[1])
