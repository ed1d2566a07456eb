"""The port's cost model (``train.step.input_specs`` and ``lower_*``,
``launch.cost_analysis``, ``launch.dryrun``, ``launch.perf``,
``launch.roofline``) against the reference's on the CPU.

* ``input_specs`` and ``dryrun.model_flops_per_step`` equal the
  reference's for every arch and cell.
* At smoke size (float32, b = 4, s = 256, one microbatch) on a
  one-device ``("data", "model")`` mesh, the FLOPs of the port's traced
  prefill (plain route), decode step and train step equal the
  reference's ``program_costs(lower_*(...).compile().as_text())`` FLOPs
  for all five families; ``rwkv6-7b``'s prefill is short by 2 b s d per
  layer and its train step by 4 b s d per layer: the bonus term
  ``u k_t v_t`` of the time mix, a dot over each head's width in the
  reference (``einsum``) and a multiply and a sum in the port; the train
  step runs it twice, forward and rematerialised (its gradients are
  elementwise products in both programs, no dot). The argument bytes
  equal the reference's
  ``argument_size_in_bytes`` where the reference's jit keeps every
  argument (it prunes the ones the program does not read: the SSM's
  decode position, the enc-dec decode's encoder and cross ``wk``/``wv``).
* The sharded prefill on (2, 2) and (1, 4) costs the unsharded
  prefill's FLOPs: the head runs over every position on every
  ``"model"`` degree.
* The train step's rematerialisation in closed form against the
  unrematerialised count (the dense model).
* The collective counter reproduces ``tests/test_hlo_analysis.py``'s
  ``FAKE_HLO`` numbers through the port's own collectives, and the
  per-device model-axis bytes equal the closed forms of
  ``tests/test_torch_train_tp.py`` in the reference's convention.
* ``perf``'s ``fsdp_on`` and ``fsdp_off`` records equal ``baseline``
  (the lowering reads no fsdp flag, as the reference's does not);
  ``remat_off`` is refused. The roofline's ratios are not capped: one
  above 1 is returned as it is, with a warning that names the cell.
* ``BF16_ATTENTION_OPERANDS`` both ways: ``_attend_chunked`` against the
  reference's, float32 inputs rtol 1e-5, bfloat16 inputs within two
  bf16 units of the output (2^-6 relative, atol 1e-2).
* The flash kernel under a trace: the traced card program takes the
  kernel route, its FLOPs are ``flash_flops``, and the launch counter
  does not move.
"""

import dataclasses
import importlib
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from lm_family_checks import one_torch_thread  # noqa: F401 — autouse
from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import cells_for as jax_cells_for
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeCell as JShapeCell
from repro.launch import hlo_analysis as JH
from repro.models import attention as JA
from repro.train import step as JS
from repro_torch.configs import ALL_ARCHS, cells_for, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.device import is_traced, resolve_device, tracing
from repro_torch.distributed import tp
from repro_torch.distributed.ctx import activation_sharding
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun, perf
from repro_torch.launch.roofline import PEAK_FLOPS, bound_ms, roofline_terms
from repro_torch.models import attention as PA
from repro_torch.models import registry as TR
from repro_torch.models import transformer as PT
from repro_torch.optim import AdamW
from repro_torch.train import step as PS

FAMILIES = ("llama3.2-3b", "olmoe-1b-7b", "recurrentgemma-2b", "rwkv6-7b",
            "seamless-m4t-large-v2")
B, S = 4, 256


def _reference_dryrun():
    """``repro.launch.dryrun``, whose import sets ``XLA_FLAGS`` for 512
    host devices: the variable is put back at once (the suite's other
    files share this process)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


class _Duck:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


ONE = _Duck(data=1, model=1)


def _jmesh():
    return JMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_and_model_flops_match_reference(arch):
    assert sorted(ALL_ARCHS) == sorted(JAX_ARCHS)
    jdry = _reference_dryrun()
    cfg, cj = get_config(arch), jax_get_config(arch)
    cells = cells_for(cfg)
    assert [c.name for c in cells] == [c.name for c in jax_cells_for(cj)]
    for cell in cells:
        want = JS.input_specs(cj, cell)
        got = PS.input_specs(cfg, cell)
        assert list(got) == list(want)
        for k, spec in got.items():
            assert tuple(spec.shape) == tuple(want[k].shape), (cell, k)
            assert str(spec.dtype).removeprefix("torch.") \
                == str(np.dtype(want[k].dtype)), (cell, k)
        assert dryrun.model_flops_per_step(cfg, cell) \
            == jdry.model_flops_per_step(cj, cell)
        assert PS.default_microbatches(cfg, cell) \
            == JS.default_microbatches(cj, cell)


def _reference_costs(cj, kind):
    cell = JShapeCell("x", kind, S, B)
    compiled = JS.lower_cell(cj, cell, _jmesh(), microbatches=1).compile()
    return (JH.program_costs(compiled.as_text())["flops"],
            compiled.memory_analysis().argument_size_in_bytes)


def _port_lowered(cfg, kind):
    return PS.lower_cell(cfg, ShapeCell("x", kind, S, B), ONE,
                         microbatches=1)


def _plain_prefill(cfg) -> ca.Trace:
    """The unsharded prefill on the reference's attention route (the
    reference's CPU program has no Pallas call), traced on the card's
    program as ``_train_flops`` traces the loss."""
    cell = ShapeCell("x", "prefill", S, B)
    with tracing("cuda") as dev:
        model = TR.init_params(cfg, device=dev, abstract=True)
        batch = {k: torch.zeros(sp.shape, dtype=sp.dtype, device=dev)
                 for k, sp in PS.input_specs(cfg, cell).items()}
        with ca.CostMode() as mode:
            PS.make_prefill_fn(cfg, backend="plain")(model, batch)
    return mode.trace


def _pruned_argument_bytes(cfg, kind) -> int:
    """Bytes of the arguments the reference's jit drops from its
    program because it never reads them."""
    if kind != "decode":
        return 0
    if cfg.family == "ssm":
        return 4                                     # the int32 position
    if cfg.family == "encdec":
        model = TR.init_params(cfg, device="cpu")
        return sum(p.numel() * p.element_size()
                   for n, p in model.named_parameters()
                   if n.startswith(("enc_layers.", "enc_norm"))
                   or n.endswith(("cross_attn.wk", "cross_attn.wv")))
    return 0


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_traced_flops_and_arguments_match_reference(arch, kind):
    cfg, cj = get_config(arch, smoke=True), jax_get_config(arch, smoke=True)
    want_flops, want_args = _reference_costs(cj, kind)
    compiled = _port_lowered(cfg, kind).compile()
    got = ca.program_costs(compiled)["flops"]
    assert got == compiled.cost_analysis()["flops"]
    if kind == "prefill":           # the lowering traces flash's route
        got = ca.program_costs(_plain_prefill(cfg))["flops"]
    gap = 0
    if cfg.family == "ssm" and kind != "decode":
        per = 2 * B * S * cfg.d_model * cfg.n_layers  # the bonus u k v
        gap = per if kind == "prefill" else 2 * per
    assert got + gap == want_flops
    args = compiled.memory_analysis().argument_size_in_bytes
    assert args - _pruned_argument_bytes(cfg, kind) == want_args


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_prefill_costs_the_unsharded_prefills_flops(arch, shape):
    """The head runs over every position on every ``"model"`` degree
    (``common.last_logits_tp``), as in the unsharded forward and the
    reference's program: the whole sharded program's FLOPs equal the
    unsharded prefill's on the same (the reference's) attention route."""
    cfg = get_config(arch, smoke=True)
    mesh = _Duck(data=shape[0], model=shape[1])
    got = PS.lower_prefill(cfg, ShapeCell("x", "prefill", S, B), mesh)
    assert got.trace.n_devices == shape[0] * shape[1]
    assert got.trace.flops == _plain_prefill(cfg).flops


def _train_flops(cfg, remat: bool) -> int:
    with tracing("cuda") as dev:
        model = TR.init_params(cfg, device=dev, abstract=True)
        toks = torch.zeros((B, S), dtype=torch.int32, device=dev)
        params = list(model.parameters())
        for p in params:
            p.requires_grad_(True)
        with ca.CostMode() as mode:
            loss = PT.lm_loss(model, {"tokens": toks, "labels": toks}, cfg,
                              remat=remat, backend="plain")
            torch.autograd.grad(loss, params)
    return mode.trace.flops


def test_remat_against_the_unrematerialised_step_closed_form():
    """The dense model (L layers): the unrematerialised step is three
    forwards (F, the prefill's FLOPs); rematerialisation runs each
    layer's forward again up to its last saved product, which leaves out
    ``w_down`` (its output is not saved): per layer the q, k, v, o
    products 2 b s d (2 hq dh + 2 hkv dh), the gate and up products
    2 (2 b s d f) and attention's two products 4 b hq s^2 dh."""
    cfg = get_config("llama3.2-3b", smoke=True)
    prefill = _plain_prefill(cfg).flops
    plain = _train_flops(cfg, remat=False)
    assert plain == 3 * prefill
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.head_dim
    hq, hkv, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    layer = (2 * B * S * d * (2 * hq * dh + 2 * hkv * dh)
             + 2 * 2 * B * S * d * f + 4 * B * hq * S * S * dh)
    remat = _train_flops(cfg, remat=True)
    assert remat - plain == L * layer
    step = _port_lowered(cfg, "train").compile().trace.flops
    assert step == remat


def test_roofline_ratios_are_uncapped_and_warn_above_one():
    rec = {"arch": "llama3.2-3b", "shape": "train_4k", "mesh_shape": [2, 2],
           "model_flops": 8e12, "collectives": {"total_wire_bytes": 0},
           "cost_weighted": {"flops": 1e12, "bytes": 1e6}}
    with pytest.warns(UserWarning, match=r"llama3.2-3b train_4k on \[2, 2\]"):
        r = roofline_terms(rec)
    assert r["useful_ratio"] == 2.0
    assert r["roofline_fraction"] == pytest.approx(2.0, rel=1e-12)
    rec["model_flops"] = 2e12
    r = roofline_terms(rec)
    assert r["useful_ratio"] == 0.5
    assert r["bound_s"] == 1e12 / PEAK_FLOPS


def test_collectives_reproduce_the_reference_fake_hlo():
    """``tests/test_hlo_analysis.py``'s module: one f32[128,256]
    all-gather and an f32[4] all-reduce ten times, over groups of 16,
    issued through ``distributed.tp``'s collectives."""
    from test_hlo_analysis import FAKE_HLO
    group = tp.Group(_Duck(data=1, model=16))
    whole = tp.gather_to_ranks(torch.ones((16, 8, 256)), group, 0)
    assert whole.shape == (16, 128, 256)
    for _ in range(10):
        tp.reduce_from_ranks(torch.ones((16, 4)), group)
    trace = ca.Trace(16)
    trace.collectives = ca.model_axis_collectives(group, data_ranks=1)
    got = ca.collective_bytes(trace)
    want = JH.collective_bytes(FAKE_HLO)
    assert set(got) == set(want) == {"all-gather", "all-reduce"}
    for kind in want:
        assert got[kind].as_dict() == want[kind].as_dict(), kind
    assert ca.summarize_collectives(trace) \
        == JH.summarize_collectives(FAKE_HLO)
    # the ring totals over all positions convert to the same wire bytes
    for what, name in ca.COLLECTIVE_NAMES.items():
        if group.traffic[what]:
            assert group.traffic[what] == got[name].wire_bytes * 15


@pytest.mark.parametrize("arch,dp,mp,microbatches", [
    ("llama3.2-3b", 2, 2, 2), ("recurrentgemma-2b", 2, 2, 2),
    ("rwkv6-7b", 1, 2, 1)])
def test_model_axis_bytes_per_device_closed_form(arch, dp, mp,
                                                 microbatches):
    """``model_axis_collectives`` of a train step in the reference's
    convention: ``tests/test_torch_train_tp.py``'s closed forms of the
    ring totals over all positions (N = (R - 1) B s d 4 a residual
    collective), divided by (R - 1) and the data ranks."""
    import lm_family_checks as F
    from repro_torch.data import make_pipeline
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import (opt_state_specs,
                                                  param_specs)
    from repro_torch.launch.mesh import make_host_mesh
    cfg = get_config(arch, smoke=True)
    base = TR.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    s = 64 if cfg.family == "dense" else 128
    L, d, Bt = cfg.n_layers, cfg.d_model, F.TRAIN_BATCH
    mesh = make_host_mesh(mp, devices=["cpu"] * (dp * mp))
    model = spmd.ShardedModel(base, mesh, param_specs(base, mesh),
                              opt_state_specs(base, mesh))
    opt = AdamW(lr=1e-3)
    batch = make_pipeline(cfg, s, Bt, device="cpu").batch(0)
    with activation_sharding(mesh):
        PS.make_train_fn(cfg, opt, microbatches=microbatches, mesh=mesh)(
            model, opt.init(model), batch)
    n = (mp - 1) * Bt * s * d * 4
    loss = 3 * 2 * (mp - 1) * Bt * s * 4
    if cfg.family == "dense":
        gathered, scattered, reduced = (6 * L + 2) * n, (5 * L + 2) * n, loss
    elif cfg.family == "hybrid":
        nw = (mp - 1) * Bt * s * cfg.rnn_width * 4
        supers, tail = divmod(L, 3)
        gathered = supers * (18 * n + 4 * nw) + tail * (4 * n + nw) + 2 * n
        scattered = supers * (17 * n + 2 * nw) + tail * (4 * n + nw) + 2 * n
        reduced = loss
    else:
        gathered, scattered = 3 * L * n + 4 * n, 2 * L * n + 2 * n
        reduced = 14 * L * n + loss
    group = model.last_step["group"]
    assert group.traffic == {"all_gather": gathered,
                             "reduce_scatter": scattered,
                             "all_reduce": reduced}
    per = ca.model_axis_collectives(group, dp)
    for what, total in group.traffic.items():
        assert per[ca.COLLECTIVE_NAMES[what]].wire_bytes \
            == total / ((mp - 1) * dp)


def test_perf_fsdp_variants_equal_baseline_and_remat_off_is_refused():
    cfg = get_config("olmoe-1b-7b", smoke=True)
    cell = ShapeCell("x", "train", 128, 4)
    mesh = _Duck(data=2, model=2)
    recs = {}
    for variant in ("baseline", "fsdp_on", "fsdp_off"):
        rec = perf.measure(cfg, cell, mesh, **perf.variant_kwargs(variant))
        rec.pop("compile_s")
        recs[variant] = rec
    assert recs["fsdp_on"] == recs["baseline"] == recs["fsdp_off"]
    assert recs["baseline"]["bound_ms"] == bound_ms(
        recs["baseline"]["hlo_flops"], recs["baseline"]["hlo_bytes"],
        recs["baseline"]["wire_bytes"])[0]
    for variant in ("remat_off", "bogus"):
        with pytest.raises(SystemExit, match="unknown variant"):
            perf.variant_kwargs(variant)
    assert perf.variant_kwargs("mbff4") == {"moe_ffshard": True,
                                            "microbatches": 4}
    assert perf.variant_kwargs("kvchunk512") == {"kv_chunk": 512}


def test_dryrun_records_the_reference_schema(tmp_path, monkeypatch):
    cfg = get_config("llama3.2-3b", smoke=True)
    rec = dryrun.run_cell("llama3.2-3b", "decode_32k", "single", tmp_path,
                          cfg=dataclasses.replace(cfg, n_layers=1))
    assert rec["ok"], rec.get("error")
    for key in ("memory", "cost", "collectives", "cost_weighted",
                "model_flops", "lower_s", "compile_s", "mesh_shape",
                "axes"):
        assert key in rec
    assert rec["mesh_shape"] == [16, 16]
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    assert rec["cost_weighted"]["flops"] == rec["cost"]["flops"]
    assert (tmp_path / "llama3.2-3b__decode_32k__single.json").exists()

    def fail(*args, **kwargs):
        raise RuntimeError("no such program")
    monkeypatch.setattr(dryrun, "lower_cell", fail)
    rec = dryrun.run_cell("llama3.2-3b", "train_4k", "multi", tmp_path)
    assert rec["ok"] is False and "no such program" in rec["error"]
    assert rec["mesh_shape"] == [2, 16, 16]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flag", [True, False])
def test_bf16_attention_operands_both_ways(flag, dtype, monkeypatch):
    monkeypatch.setattr(PA, "BF16_ATTENTION_OPERANDS", flag)
    monkeypatch.setattr(JA, "BF16_ATTENTION_OPERANDS", flag)
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 4, n, 64)).astype(np.float32)
               for n in (300, 2500, 2500))
    tdt = getattr(torch, dtype)
    got = PA._attend_chunked(*(torch.from_numpy(t).to(tdt)
                               for t in (q, k, v)), window=None)
    want = JA._attend_chunked(*(jax.numpy.asarray(t, dtype=dtype)
                                for t in (q, k, v)), window=None)
    want = np.asarray(want.astype(np.float32))
    tol = (1e-5, 1e-5) if dtype == "float32" else (2 ** -6, 1e-2)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol[0],
                               atol=tol[1])


def test_flash_is_traced_through_its_operator_and_counts_no_launch():
    cfg = get_config("llama3.2-3b", smoke=True)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    launches = flash_ops.launch_count()
    cell = ShapeCell("x", "prefill", S, B)
    kernel = PS.lower_prefill(cfg, cell, ONE).compile().trace
    plain = _plain_prefill(cfg)
    assert flash_ops.launch_count() == launches
    assert kernel.calls("repro_torch.flash_attention") == cfg.n_layers
    assert plain.calls("repro_torch.flash_attention") == 0
    hq, dh, L = cfg.n_heads, cfg.head_dim, cfg.n_layers
    q, kv = (B, hq, S, dh), (B, cfg.n_kv_heads, S, dh)
    flash = flash_ops.flash_flops(q, kv, torch.bfloat16, True)
    assert flash == 2 * B * hq * dh * S * (S + flash_ops.BF16_ROWS)
    assert flash_ops.flash_flops(q, kv, torch.bfloat16, False) \
        == 4 * B * hq * dh * S * S
    # the plain route's two attention products, 4 b hq s^2 dh a layer
    assert kernel.flops == plain.flops - L * 4 * B * hq * S * S * dh \
        + L * flash


def test_abstract_construction_only_inside_a_trace():
    cfg = get_config("llama3.2-3b", smoke=True)
    with pytest.raises(RuntimeError, match="tracing"):
        TR.init_params(cfg, device="cpu", abstract=True)
    with pytest.raises(RuntimeError, match="tracing"):
        AdamW().init(TR.init_params(cfg, device="cpu"), abstract=True)
    assert not is_traced("cuda")
    with tracing("cuda") as dev:
        assert is_traced("cuda") and resolve_device("cuda") == dev
        model = TR.init_params(cfg, abstract=True)
        caches = TR.make_decode_state(cfg, 2, 8, abstract=True)
        state = AdamW().init(model, abstract=True)
        assert all(p.device == dev for p in model.parameters())
        assert caches.kv[0].shape == (cfg.n_layers, 2, cfg.n_kv_heads, 8,
                                      cfg.head_dim)
        assert state.m["embed"].shape == model.embed.shape
        with pytest.raises(RuntimeError, match="trace is on"):
            TR.init_params(cfg, device="cpu", abstract=True)
    assert not is_traced("cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="none is available"):
            resolve_device("cuda")


def test_lowered_shape_of_a_jax_lowering():
    cfg = get_config("olmoe-1b-7b", smoke=True)
    cell = ShapeCell("x", "train", 64, 4)
    lowered = PS.lower_train_step(cfg, cell, _Duck(data=2, model=2),
                                  microbatches=2)
    compiled = lowered.compile()
    ma = compiled.memory_analysis()
    assert ma.alias_size_in_bytes == ma.output_size_in_bytes - 4
    assert ma.temp_size_in_bytes == ma.program_temp_bytes // 4
    assert set(compiled.cost_analysis()) == {"flops", "bytes accessed",
                                             "transcendentals"}
    text = compiled.as_text()
    assert "aten.bmm" in text and "all-gather per device" in text
    colls = ca.summarize_collectives(compiled)
    assert set(colls) == {"per_type", "total_wire_bytes",
                          "total_result_bytes", "total_count"}
    assert colls["per_type"]["reduce-scatter"]["count"] > 0
