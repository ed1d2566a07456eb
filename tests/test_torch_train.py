"""The port's trainer against the reference's, on the CPU.

``llama3.2-3b`` at smoke size (4 layers, d_model 256, float32; bf16
where named). The reference draws its weights (``init_params``,
``PRNGKey(0)``) and the port takes the same values through
``params_from_numpy``; both packages' pipelines give the same batches
bitwise. A gradient transform that stashes the gradients the update sees
in the error-feedback slot (``_Stash``) reads them out of both packages'
train steps, the reference's jitted one included.

Tolerances, and why:

* schedule: rtol 1e-6 (float32 arithmetic, libm's cosine);
* ``Int8EF``: bitwise (the same float32 operations, round half to even);
* ``AdamW`` on a tree of float32 and bf16 leaves: moments and updates
  rtol 1e-6, with an absolute floor of 1e-6 of the leaf's largest
  magnitude: the global norms are summed in two libraries' orders, so the
  clip scale may differ by one float32 unit, and where a moment cancels
  (a small update among large ones) that unit shows up to 6e-6 relative
  to the element; the new bf16 leaves within one bf16 unit in the last
  place (one rounding);
* the train step, float32: loss rtol 1e-5; every gradient within 1e-4 of
  its leaf's max |g| (CPU products of two libraries, summed in other
  orders); after three steps the parameters within 3·lr·1e-3, except
  elements whose reference gradient lies within 1e-4 of its leaf's max
  |g| of zero, where Adam's first update (about ±lr) may take either
  sign: at most 0.1 % of a leaf;
* bf16: loss rtol 2e-2; after one step every parameter within one bf16
  unit of the reference's, except at most 3 % of a leaf (2.3 % measured),
  each parted by at most a flipped Adam step (2·lr plus one unit): bf16
  gradients summed in other orders flip the sign of small ones;
* remat on and off: bitwise (the same operations, recomputed);
* checkpoints: a restored reference state steps to the reference's next
  loss at rtol 1e-5; a port checkpoint restores in the reference with
  the same keys and bitwise the same leaves;
* the CLI's loop: the loss descends, a resumed run's losses equal the
  uninterrupted run's bitwise, and from the reference's weights it
  follows the reference's loop to rtol 1e-4 (the reference's own bound
  for a resumed run).
"""

import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.data.synthetic import make_pipeline as jax_make_pipeline
from repro.models import registry as JR
from repro.optim import AdamW as JAdamW
from repro.optim import Int8EF as JInt8EF
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import cosine_with_warmup as jax_cosine
from repro.optim.adamw import GradTransform as JGradTransform
from repro.runtime.checkpoint import restore_checkpoint as jax_restore
from repro.runtime.checkpoint import save_checkpoint as jax_save
from repro.train.step import make_train_fn as jax_make_train_fn
from repro_torch.configs import get_config
from repro_torch.configs.base import smoke_variant
from repro_torch.data import make_pipeline
from repro_torch.kernels import backend as _backend
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as port_attention
from repro_torch.models import registry as TR
from repro_torch.models import transformer
from repro_torch.models.convert import (params_from_numpy, params_to_numpy,
                                        port_leaf)
from repro_torch.optim import AdamW, Int8EF, apply_updates, cosine_with_warmup
from repro_torch.optim.adamw import GradTransform, named_leaves
from repro_torch.runtime.checkpoint import (read_manifest, restore_checkpoint,
                                            save_checkpoint)
from repro_torch.train.sampled_eval import SampledEval
from repro_torch.train.step import default_microbatches, make_train_fn

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "llama3.2-3b"
LR = 1e-3
SEQ, BATCH = 64, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file: its operations are small, and
    beside the suite's other workers a thread pool per process keeps
    waiting on threads the busy host has descheduled (with six workers on
    an 8-core CPU host the CLI test took 345 s instead of 2 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _JStash(JGradTransform):
    def apply(self, grads, ef):
        return grads, grads


class _Stash(GradTransform):
    def apply(self, grads, ef):
        return grads, grads


def _configs(dtype="float32"):
    cj = jax_smoke_variant(jax_get_config(ARCH), dtype=getattr(jnp, dtype))
    ct = smoke_variant(get_config(ARCH), dtype=getattr(torch, dtype))
    return cj, ct


@pytest.fixture(scope="module")
def f32():
    cj, ct = _configs()
    pj = JR.init_params(cj, jax.random.PRNGKey(0))
    return cj, ct, pj, jax.tree.map(np.asarray, pj)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


def _run_both(cj, ct, pj, tree, opt_kw, steps, microbatches=1):
    """Both packages' train steps from the same weights and batches; the
    reference's jitted. Returns per step (reference, port) losses and the
    gradients each update saw, and the final parameters."""
    jopt = JAdamW(compress=_JStash(), **opt_kw)
    topt = AdamW(compress=_Stash(), **opt_kw)
    jstep = jax.jit(jax_make_train_fn(cj, jopt, microbatches=microbatches))
    tstep = make_train_fn(ct, topt, microbatches=microbatches)
    jpipe = jax_make_pipeline(cj, SEQ, BATCH)
    tpipe = make_pipeline(ct, SEQ, BATCH, device="cpu")
    jp, js = pj, jopt.init(pj)
    tp = params_from_numpy(ct, tree, device="cpu")
    ts = topt.init(tp)
    out = []
    for step in range(steps):
        jp, js, jl = jstep(jp, js, jpipe.batch(step))
        tp, ts, tl = tstep(tp, ts, tpipe.batch(step))
        out.append((float(jl), float(tl), jax.tree.map(np.asarray, js.ef),
                    dict(ts.ef)))
    return out, jax.tree.map(np.asarray, jp), tp


# ----------------------------------------------------------------- schedule
@pytest.mark.parametrize("peak,warmup,total,floor", [
    (3e-3, 10, 100, 0.1), (5e-3, 10, 8, 0.1), (1e-2, 0, 50, 0.0)])
def test_schedule_matches_reference(peak, warmup, total, floor):
    jlr = jax_cosine(peak, warmup, total, floor)
    tlr = cosine_with_warmup(peak, warmup, total, floor)
    steps = np.arange(total + 6, dtype=np.int32)
    want = np.array([float(jlr(jnp.int32(s))) for s in steps])
    got = np.array([float(tlr(torch.tensor(s, dtype=torch.int32)))
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert tlr(torch.tensor(3)).dtype == torch.float32


# ------------------------------------------------------------------- Int8EF
def _tree(seed, dtypes=("float32",)):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7,), "b": {"c": (5, 6), "d": (2, 3, 4)}, "e": (33, 3)}
    out, i = {}, 0

    def build(spec, node):
        nonlocal i
        for k, v in spec.items():
            if isinstance(v, dict):
                node[k] = build(v, {})
            else:
                dt = dtypes[i % len(dtypes)]
                i += 1
                node[k] = (rng.normal(size=v) * 10.0 ** rng.integers(-3, 2)
                           ).astype(np.float32)
                if dt == "bfloat16":
                    node[k] = np.asarray(jnp.asarray(node[k], jnp.bfloat16))
        return node
    return build(shapes, out)


def _torch_tree(tree):
    from repro_torch.models.convert import tensor_from_numpy
    return {k: _torch_tree(v) if isinstance(v, dict) else tensor_from_numpy(v)
            for k, v in tree.items()}


def _leaf_np(tree, name):
    node = tree
    for part in name.split("."):
        node = node[part]
    return np.asarray(node)


def test_int8ef_matches_reference_bitwise():
    jt = JInt8EF()
    tt = Int8EF()
    jef = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32),
                       _tree(0))
    tef = {n: torch.zeros(v.shape) for n, v in
           named_leaves(_torch_tree(_tree(0))).items()}
    for step in range(3):
        grads = _tree(step + 1)
        jg, jef = jt.apply(jax.tree.map(jnp.asarray, grads), jef)
        tg, tef = tt.apply(named_leaves(_torch_tree(grads)), tef)
        for name in tg:
            np.testing.assert_array_equal(tg[name].numpy(),
                                          _leaf_np(jg, name))
            np.testing.assert_array_equal(tef[name].numpy(),
                                          _leaf_np(jef, name))
            assert tg[name].dtype == torch.float32


def test_int8ef_error_feedback_converges():
    """The reference's convergence check (``tests/test_distributed.py``)
    on the port: 80 steps of AdamW on int8 gradients."""
    rng = np.random.default_rng(0)
    params = {"w": torch.tensor(rng.normal(size=(64, 64)),
                                dtype=torch.float32)}
    opt = AdamW(lr=5e-2, weight_decay=0.0, compress=Int8EF())
    state = opt.init(params)
    assert state.ef is not None

    def loss(p):
        return torch.sum(torch.square(p["w"] - 1.0))

    losses = []
    for _ in range(80):
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        u, state = opt.update({"w": g}, state, params)
        params = apply_updates(params, u)
        losses.append(float(loss(params)))
    assert losses[-1] < losses[0] * 0.1


# -------------------------------------------------------------------- AdamW
def _bf16_units(x):
    """One bf16 unit in the last place at |x| (float32 input)."""
    return np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(moment_dtype):
    dtypes = ("float32", "bfloat16")
    jopt = JAdamW(lr=jax_cosine(1e-2, 2, 5), clip_norm=0.5,
                  moment_dtype=getattr(jnp, moment_dtype))
    topt = AdamW(lr=cosine_with_warmup(1e-2, 2, 5), clip_norm=0.5,
                 moment_dtype=getattr(torch, moment_dtype))
    params = _tree(10, dtypes)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _torch_tree(params)
    js, ts = jopt.init(jp), topt.init(tp)
    clipped = 0
    for step in range(5):
        grads = _tree(20 + step, dtypes)
        gnorm = np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float32)))
                            for g in jax.tree.leaves(grads)))
        clipped += gnorm > 0.5
        ju, js = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        tu, ts_new = topt.update(_torch_tree(grads), ts, tp)
        # apply_ is update + apply_updates, in place and bitwise
        tp_inplace = {k: v.clone() for k, v in named_leaves(tp).items()}
        inplace = topt.apply_(
            _torch_tree(grads),
            type(ts)(ts.step, {k: v.clone() for k, v in ts.m.items()},
                     {k: v.clone() for k, v in ts.v.items()}),
            tp_inplace)
        ts = ts_new
        jp = jax_apply_updates(jp, ju)
        tp = apply_updates(tp, tu)
        assert int(ts.step) == int(js.step) == step + 1
        for name, p in named_leaves(tp).items():
            want_p = _leaf_np(jp, name)
            for got, want in ((tu[name], _leaf_np(ju, name)),
                              (ts.m[name], _leaf_np(js.m, name)),
                              (ts.v[name], _leaf_np(js.v, name))):
                assert str(got.dtype).split(".")[-1] == want.dtype.name
                np.testing.assert_allclose(
                    _np(got), _np(want), rtol=1e-6,
                    atol=1e-6 * float(np.abs(_np(want)).max()), err_msg=name)
            if p.dtype == torch.bfloat16:
                assert np.all(np.abs(_np(p) - _np(want_p))
                              <= _bf16_units(_np(want_p))), name
            else:
                np.testing.assert_allclose(_np(p), _np(want_p), rtol=1e-6,
                                           err_msg=name)
            assert torch.equal(tp_inplace[name], p), name
            assert torch.equal(inplace.m[name], ts.m[name]), name
            assert torch.equal(inplace.v[name], ts.v[name]), name
    assert clipped >= 3              # the clip was active


# the smoke trees whose stacked groups the decay rule must see: the dense
# ``layers``, the hybrid's ``supers`` and ``tail`` (7 layers: 2 supers and
# one tail layer), the enc-dec model's ``enc_layers`` and ``dec_layers``
DECAY_TREES = (("recurrentgemma-2b", {"n_layers": 7}),
               ("seamless-m4t-large-v2", {}))


def _smoke_tree(arch, **overrides):
    import dataclasses
    cj = dataclasses.replace(jax_get_config(arch, smoke=True), **overrides)
    ct = dataclasses.replace(get_config(arch, smoke=True), **overrides)
    pj = JR.init_params(cj, jax.random.PRNGKey(0))
    return cj, ct, pj, jax.tree.map(np.asarray, pj)


def test_decay_follows_the_references_stacked_shapes(f32):
    """Zero gradients leave only the decay, which applies where a leaf's
    rank in the reference's tree is >= 2: ``layers.<i>.ln*`` (``(d,)``
    here, ``(L, d)`` in the reference) decay, as do the hybrid's
    ``supers.<i>.…`` and ``tail.<j>.…`` norms and ``lam`` and the enc-dec
    stacks' norms, while ``final_norm`` and ``enc_norm`` do not. On the
    dense, hybrid (with a tail) and enc-dec smoke trees."""
    trees = [f32] + [_smoke_tree(arch, **kw) for arch, kw in DECAY_TREES]
    names = set()
    for cj, ct, pj, tree in trees:
        jopt, topt = JAdamW(lr=LR), AdamW(lr=LR)
        ju, _ = jopt.update(jax.tree.map(jnp.zeros_like, pj),
                            jopt.init(pj), pj)
        ju = jax.tree.map(np.asarray, ju)
        model = params_from_numpy(ct, tree, device="cpu")
        zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        tu, _ = topt.update(zeros, topt.init(model), model)
        for name, u in tu.items():
            np.testing.assert_allclose(u.numpy(), port_leaf(ju, name),
                                       rtol=1e-6, err_msg=name)
            decayed = name not in ("final_norm", "enc_norm")
            assert bool(u.abs().max() > 0) == decayed, name
        assert any(n.endswith((".ln1", ".ln")) and tu[n].abs().max() > 0
                   for n in tu)
        names.update(tu)
    assert {"tail.0.ln", "supers.1.r0.rglru.lam",
            "enc_layers.0.ln1"} <= names


@pytest.mark.parametrize("arch,layers", [
    ("llama3.2-3b", None), ("olmoe-1b-7b", None), ("recurrentgemma-2b", None),
    ("recurrentgemma-2b", 7), ("rwkv6-7b", None),
    ("seamless-m4t-large-v2", None)])
def test_reference_ndim_is_the_stacked_trees_rank(arch, layers):
    """``reference_ndim`` of every parameter of each family's smoke model
    is the rank of the reference's leaf that holds it (7 layers give the
    hybrid a tail)."""
    from repro_torch.models.convert import _tree_path
    from repro_torch.optim.adamw import reference_ndim
    _, ct, _, tree = _smoke_tree(
        arch, **({} if layers is None else {"n_layers": layers}))
    model = TR.init_params(ct, device="cpu")
    for name, p in model.named_parameters():
        node = tree
        for key in _tree_path(name)[0]:
            node = node[key]
        assert reference_ndim(name, p) == node.ndim, name


# --------------------------------------------------------------- train step
def _grads_close(jg, tg, what):
    for name, g in tg.items():
        want = port_leaf(jg, name)
        assert str(g.dtype).split(".")[-1] == want.dtype.name, (what, name)
        scale = float(np.abs(_np(want)).max())
        err = float(np.abs(_np(g) - _np(want)).max())
        assert err <= 1e-4 * scale, (what, name, err, scale)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(f32, microbatches):
    cj, ct, pj, tree = f32
    out, jp, tp = _run_both(cj, ct, pj, tree, {"lr": LR}, 3, microbatches)
    for step, (jl, tl, jg, tg) in enumerate(out):
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        _grads_close(jg, tg, f"step {step}")
    tol = 3 * LR * 1e-3
    for name, p in tp.named_parameters():
        d = np.abs(_np(p) - port_leaf(jp, name))
        parted = d > tol
        if not parted.any():
            continue
        assert parted.sum() <= 1e-3 * d.size, (name, int(parted.sum()))
        near_zero = np.zeros_like(parted)
        for _, _, jg, _ in out:
            g = np.abs(port_leaf(jg, name))
            near_zero |= g <= 1e-4 * g.max()
        assert near_zero[parted].all(), name


@pytest.mark.parametrize("microbatches", [1, 2])
def test_bf16_train_step_matches_reference(microbatches):
    """One step at bf16. The update sees the gradients in the parameters'
    dtype with one microbatch and in float32 with two, as the
    reference's."""
    cj, ct = _configs("bfloat16")
    pj = JR.init_params(cj, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, pj)
    out, jp, tp = _run_both(cj, ct, pj, tree, {"lr": LR}, 1, microbatches)
    jl, tl, jg, tg = out[0]
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    for name, g in tg.items():
        want = port_leaf(jg, name)
        assert str(g.dtype).split(".")[-1] == want.dtype.name, name
        p_dtype = dict(tp.named_parameters())[name].dtype
        assert g.dtype == (p_dtype if microbatches == 1 else torch.float32)
    for name, p in tp.named_parameters():
        want = _np(port_leaf(jp, name))
        old = _np(port_leaf(tree, name))
        unit = _bf16_units(np.maximum(np.abs(want), np.abs(old)))
        d = np.abs(_np(p) - want)
        assert np.all(d <= 2 * LR + unit), name
        assert (d > unit).sum() <= 0.03 * d.size, (name, int((d > unit).sum()))


def test_remat_on_equals_off_bitwise(f32):
    cj, ct, pj, tree = f32
    model = params_from_numpy(ct, tree, device="cpu")
    batch = make_pipeline(ct, SEQ, BATCH, device="cpu").batch(0)
    plist = list(model.parameters())
    for p in plist:
        p.requires_grad_(True)
    got = []
    for remat in (True, False):
        loss = transformer.lm_loss(model, batch, ct, remat=remat,
                                   backend="plain")
        got.append((loss.detach(), torch.autograd.grad(loss, plist)))
    assert torch.equal(got[0][0], got[1][0])
    for a, b in zip(got[0][1], got[1][1]):
        assert torch.equal(a, b)


def test_default_microbatches_matches_reference():
    from repro.configs.base import ShapeCell as JShapeCell
    from repro.train.step import default_microbatches as jax_default
    from repro_torch.configs.base import ShapeCell
    for kind, seq, batch in (("train", 1024, 8), ("train", 4096, 256),
                             ("prefill", 32768, 32)):
        for smoke in (False, True):
            want = jax_default(jax_get_config(ARCH, smoke=smoke),
                               JShapeCell("c", kind, seq, batch))
            got = default_microbatches(get_config(ARCH, smoke=smoke),
                                       ShapeCell("c", kind, seq, batch))
            assert got == want
    assert default_microbatches(get_config(ARCH),
                                ShapeCell("c", "train", 1024, 8)) == 2


# -------------------------------------------------------------- checkpoints
def test_reference_checkpoint_resumes_in_the_port(f32, tmp_path):
    cj, ct, pj, tree = f32
    jopt, topt = JAdamW(lr=LR), AdamW(lr=LR)
    jstep = jax.jit(jax_make_train_fn(cj, jopt))
    pipe = jax_make_pipeline(cj, SEQ, BATCH)
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
    batch = make_pipeline(ct, SEQ, BATCH, device="cpu").batch(2)
    _, _, got = make_train_fn(ct, topt)(model, state, batch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_port_checkpoint_restores_in_the_reference(f32, tmp_path):
    cj, ct, pj, tree = f32
    topt, jopt = AdamW(lr=LR), JAdamW(lr=LR)
    model = params_from_numpy(ct, tree, device="cpu")
    state = topt.init(model)
    batch = make_pipeline(ct, SEQ, BATCH, device="cpu").batch(0)
    model, state, _ = make_train_fn(ct, topt)(model, state, batch)
    save_checkpoint(tmp_path / "port", 0,
                    launch_train.checkpoint_tree(model, state),
                    extra={"step": 0})
    jax_save(tmp_path / "ref", 0, (pj, jopt.init(pj)), extra={"step": 0})
    port_keys = read_manifest(tmp_path / "port")["leaves"]
    ref_keys = read_manifest(tmp_path / "ref")["leaves"]
    assert port_keys == ref_keys              # keys, shapes and dtypes
    assert "[1].step" in port_keys and "[1].m['layers']['ln1']" in port_keys

    (jp, js), extra = jax_restore(tmp_path / "port", (pj, jopt.init(pj)))
    assert extra == {"step": 0} and int(js.step) == 1 and js.ef is None
    want_p = params_to_numpy(model)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(port_leaf(jax.tree.map(np.asarray, jp),
                                                name), p.detach().numpy())
        np.testing.assert_array_equal(port_leaf(want_p, name),
                                      p.detach().numpy())
        for ours, theirs in ((state.m, js.m), (state.v, js.v)):
            np.testing.assert_array_equal(
                port_leaf(jax.tree.map(np.asarray, theirs), name),
                ours[name].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_to_numpy_inverts_params_from_numpy(dtype):
    cj, ct = _configs(dtype)
    tree = jax.tree.map(np.asarray, JR.init_params(cj, jax.random.PRNGKey(2)))
    back = params_to_numpy(params_from_numpy(ct, tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_bf16_checkpoint_round_trips_in_the_port(tmp_path):
    _, ct = _configs("bfloat16")
    model = TR.init_params(ct, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    opt = AdamW(lr=LR)
    state = opt.init(model)
    save_checkpoint(tmp_path, 0, launch_train.checkpoint_tree(model, state))
    assert read_manifest(tmp_path)["leaves"]["[0]['embed']"]["dtype"] == \
        "bfloat16"
    fresh = TR.init_params(ct, generator=torch.Generator().manual_seed(1),
                           device="cpu")
    tree, _ = restore_checkpoint(
        tmp_path, launch_train.checkpoint_tree(fresh, opt.init(fresh)))
    launch_train.load_checkpoint_tree(tree, fresh)
    for (name, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    # into a numpy template (ml_dtypes bfloat16 leaves): the same bits
    (ptree, _), _ = restore_checkpoint(
        tmp_path, (params_to_numpy(fresh), launch_train.checkpoint_tree(
            fresh, opt.init(fresh))[1]))
    want = params_to_numpy(model)
    for a, b in zip(jax.tree.leaves(ptree), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))


# ---------------------------------------------------------------------- CLI
CLI = dict(steps=8, batch=BATCH, seq=SEQ, lr=5e-3, ckpt_every=5)


def test_cli_loop_descends_and_resumes_bitwise(tmp_path):
    cfg = get_config(ARCH, smoke=True)
    lines = []
    full = launch_train.train(cfg, device="cpu", ckpt_dir=tmp_path / "a",
                              log=lines.append, **CLI)
    losses = [full.losses[s] for s in range(8)]
    assert losses[-1] < losses[0]
    assert lines[0].startswith("step     0 loss ") and \
        lines[1].startswith("step     7 loss ")
    assert lines[2].startswith("mean step ")

    # the host dies after step 4's checkpoint: a new process resumes there
    launch_train.train(cfg, device="cpu", ckpt_dir=tmp_path / "b",
                       log=lambda s: None, **CLI)
    shutil.rmtree(tmp_path / "b" / "step_7")
    lines = []
    again = launch_train.train(cfg, device="cpu", ckpt_dir=tmp_path / "b",
                               log=lines.append, **CLI)
    assert lines[0] == "resumed from step 4" and again.start == 5
    assert again.losses == {s: full.losses[s] for s in range(5, 8)}
    for a, b in zip(full.params.parameters(), again.params.parameters()):
        assert torch.equal(a, b)


def test_cli_loop_follows_the_references_loop(f32):
    cj, ct, pj, tree = f32
    run = launch_train.train(ct, device="cpu", log=lambda s: None,
                             params=params_from_numpy(ct, tree,
                                                      device="cpu"),
                             **{k: v for k, v in CLI.items()
                                if k != "ckpt_every"})
    jopt = JAdamW(lr=jax_cosine(CLI["lr"], 10, CLI["steps"]))
    jstep = jax.jit(jax_make_train_fn(cj, jopt))
    pipe = jax_make_pipeline(cj, SEQ, BATCH)
    jp, js = pj, jopt.init(pj)
    for step in range(CLI["steps"]):
        jp, js, loss = jstep(jp, js, pipe.batch(step))
        np.testing.assert_allclose(run.losses[step], float(loss), rtol=1e-4)


@pytest.mark.parametrize("mesh,mp", [("production", 1), ("host", 2),
                                     ("production-multipod", 1)])
def test_cli_refuses_other_meshes(mesh, mp):
    """Since the sharded trainer: the production meshes refuse only for
    want of devices (one CPU here); the host mesh over one device is the
    (1, 1) mesh, whatever ``--model-parallel`` asks, as in the reference,
    and trains the unsharded model."""
    cfg = get_config(ARCH, smoke=True)
    kw = dict(steps=1, batch=2, seq=8, device="cpu", mesh=mesh,
              model_parallel=mp, log=lambda s: None)
    if mesh == "host":
        run = launch_train.train(cfg, **kw)
        assert isinstance(run.params, torch.nn.Module)
        assert np.isfinite(run.losses[0])
        return
    with pytest.raises(RuntimeError, match="need (256|512) devices"):
        launch_train.train(cfg, **kw)


def test_cli_main_runs_on_the_cpu(capsys):
    launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step     0 loss ")
    assert out[1].startswith("step     1 loss ")


# ------------------------------------------------------------ routes, imports
def test_inference_builds_no_graph(f32):
    """``forward`` and ``SampledEval``'s eval batches run without grad
    mode, even on parameters that require gradients."""
    cj, ct, pj, tree = f32
    model = params_from_numpy(ct, tree, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    tokens = make_pipeline(ct, 16, 2, device="cpu").batch(0)["tokens"]
    assert transformer.forward(model, tokens, ct).grad_fn is None
    loss_of = TR.loss_fn(ct)
    seen = []

    def eval_batch(i):
        batch = make_pipeline(ct, 16, 2, seed=i, device="cpu").batch(0)
        loss = loss_of(model, batch)
        seen.append((torch.is_grad_enabled(), loss.grad_fn))
        return float(loss), np.array([float(loss), float(i % 3)])

    se = SampledEval(n_batches=12, eval_batch=eval_batch, num_strata=3,
                     device="cpu")
    se.characterize(n_phase1=9)
    se.quick_estimate()
    se.ci_check(per_stratum=1)
    assert seen and all(not on and fn is None for on, fn in seen)


def test_train_step_never_reaches_flash_attention(f32, monkeypatch):
    """With the kernel route forced (as on the card) the inference
    forward reaches the flash wrapper, and the train step does not."""
    cj, ct, pj, tree = f32
    calls = []

    def refuse(*args, **kwargs):
        calls.append(1)
        raise AssertionError("flash_attention reached")

    monkeypatch.setattr(port_attention, "flash_attention", refuse)
    monkeypatch.setattr(_backend, "resolve_route",
                        lambda t, backend: "plain" if backend == "plain"
                        else "kernel")
    model = params_from_numpy(ct, tree, device="cpu")
    batch = make_pipeline(ct, SEQ, BATCH, device="cpu").batch(0)
    with pytest.raises(AssertionError, match="flash_attention reached"):
        transformer.forward(model, batch["tokens"], ct)
    assert calls == [1]
    opt = AdamW(lr=LR)
    _, _, loss = make_train_fn(ct, opt)(model, opt.init(model), batch)
    assert calls == [1] and np.isfinite(float(loss))
    assert not any(p.requires_grad for p in model.parameters())


def test_flash_attention_refuses_inputs_that_require_grad():
    from repro_torch.kernels.flash_attention.ops import flash_attention
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k, v = torch.randn(1, 1, 8, 16), torch.randn(1, 1, 8, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape
    assert flash_attention(q.detach(), k, v).grad_fn is None


def test_trainer_imports_no_jax():
    code = ("import sys; import repro_torch.optim, repro_torch.launch.train;"
            " bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
