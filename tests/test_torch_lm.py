"""The port's dense LM serving path against the reference's, on the CPU.

``llama3.2-3b`` at smoke size (4 layers, d_model 256, float32): the
reference draws its weights (``PRNGKey``) and the port takes the same
values through ``models.convert.params_from_numpy``, so both packages
compute with the same weights and tokens. Tolerances: float32 logits,
losses and decode steps agree to rtol/atol 1e-4 (the products run through
different CPU libraries); the bf16 smoke variant to 3e-2. Integer outputs
— tokens of the synthetic pipeline and greedy tokens of the serve loop —
are equal exactly, except a greedy token where the reference's top two
logits lie within twice the float32 tolerance (a near-tie that either
side may break); such rows are counted, printed and compared no further.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as jax_all_archs
from repro.configs import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.data.synthetic import make_pipeline as jax_make_pipeline
from repro.models import registry as JR
from repro.train.step import make_prefill_fn as jax_make_prefill_fn
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.configs.base import smoke_variant
from repro_torch.data import make_pipeline
from repro_torch.launch.serve import generate, make_prompts
from repro_torch.launch.train import train
from repro_torch.models import registry as TR
from repro_torch.models.attention import Attention, make_kv_cache
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRU
from repro_torch.models.rwkv6 import RwkvChannelMix, RwkvTimeMix
from repro_torch.models.transformer import (LM, Block, LocalAttention,
                                            Recurrent, Super)
from repro_torch.train.step import make_prefill_fn, make_serve_fn

ARCH = "llama3.2-3b"
TOL = 1e-4
BF16_TOL = 3e-2
RNG_SEED = 0


def _pair(cfg_jax, cfg_port, seed=1):
    params = JR.init_params(cfg_jax, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return params, params_from_numpy(cfg_port, tree, device="cpu")


@pytest.fixture(scope="module")
def smoke():
    cj, ct = jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    pj, pt = _pair(cj, ct)
    return cj, ct, pj, pt


def _tokens(cfg, shape, seed=RNG_SEED):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape) \
        .astype(np.int32)


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("smoke_size", [True, False])
def test_config_matches_reference(smoke_size):
    cj = jax_get_config(ARCH, smoke=smoke_size)
    ct = get_config(ARCH, smoke=smoke_size)
    fields = [f.name for f in dataclasses.fields(ct)]
    assert fields == [f.name for f in dataclasses.fields(cj)]
    for name in fields:
        if name == "dtype":
            assert str(getattr(ct, name)).split(".")[-1] == \
                jnp.dtype(getattr(cj, name)).name
        else:
            assert getattr(ct, name) == getattr(cj, name), name
    assert ct.param_count() == cj.param_count()


def test_other_archs_and_families_raise():
    """Every architecture of the reference is registered and builds
    through the registry, the enc-dec one included; only an unknown name
    raises, and ``LM`` refuses the enc-dec family (the registry builds it
    as ``EncDec``)."""
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.transformer import LM
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    assert sorted(ALL_ARCHS) == sorted(jax_all_archs)
    for arch in ALL_ARCHS:
        cfg = get_config(arch, smoke=True)
        model = TR.init_params(cfg, device="cpu")
        assert model.cfg == cfg
        assert isinstance(model, EncDec if cfg.family == "encdec" else LM)
        TR.make_decode_state(cfg, 1, 8, device="cpu")
        for build in (TR.forward_fn, TR.loss_fn, TR.decode_fn):
            assert callable(build(cfg))
    encdec = get_config("seamless-m4t-large-v2", smoke=True)
    with pytest.raises(ValueError, match="enc-dec"):
        LM(encdec, device="cpu")


@pytest.mark.parametrize("arch", ["chameleon-34b", "command-r-35b",
                                  "granite-8b", "internlm2-20b"])
@pytest.mark.parametrize("smoke_size", [True, False])
def test_dense_configs_match_reference(arch, smoke_size):
    """The four other dense architectures: every field, the parameter
    counts and the shape cells equal the reference's."""
    from lm_family_checks import check_config
    check_config(arch, smoke_size)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "olmoe-1b-7b",
                                  "recurrentgemma-2b", "rwkv6-7b",
                                  "seamless-m4t-large-v2"])
def test_every_family_trains(arch):
    """``make_train_fn`` builds for each family (dense, MoE, hybrid, SSM,
    enc-dec) and ``launch.train`` runs 2 CPU steps at smoke size with
    finite losses (the families' training against the reference:
    ``tests/test_torch_train*.py``)."""
    from repro_torch.optim import AdamW
    from repro_torch.train.step import make_train_fn
    cfg = get_config(arch, smoke=True)
    assert callable(make_train_fn(cfg, AdamW(lr=1e-3), microbatches=2))
    lines = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = train(cfg, steps=2, batch=2, seq=64, device="cpu",
                    log=lines.append)
    finally:
        torch.set_num_threads(threads)
    assert sorted(run.losses) == [0, 1]
    assert all(np.isfinite(v) for v in run.losses.values())
    assert lines[0].startswith("step     0 loss ")


def test_forward_and_loss_match_reference(smoke):
    cj, ct, pj, pt = smoke
    toks = _tokens(ct, (2, 24))
    labels = _tokens(ct, (2, 24), seed=7)
    want = JR.forward_fn(cj)(pj, {"tokens": jnp.asarray(toks)})
    got = TR.forward_fn(ct)(pt, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 24, ct.vocab)
    _close(got, want)
    batch = {"tokens": toks, "labels": labels}
    want_loss = JR.loss_fn(cj)(pj, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    got_loss = TR.loss_fn(ct)(pt, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               rtol=TOL, atol=TOL)
    _close(make_prefill_fn(ct)(pt, {"tokens": torch.from_numpy(toks)}),
           jax_make_prefill_fn(cj)(pj, {"tokens": jnp.asarray(toks)}))


def test_decode_steps_match_reference(smoke):
    cj, ct, pj, pt = smoke
    toks = _tokens(ct, (2, 12))
    cache_j = JR.make_decode_state(cj, 2, 32)
    cache_t = TR.make_decode_state(ct, 2, 32, device="cpu")
    for t in range(toks.shape[1]):
        lj, cache_j = JR.decode_fn(cj)(pj, jnp.asarray(toks[:, t:t + 1]),
                                       cache_j, jnp.int32(t))
        lt, cache_t = TR.decode_fn(ct)(pt, torch.from_numpy(
            toks[:, t:t + 1]), cache_t, t)
        assert lt.shape == (2, 1, ct.vocab)
        _close(lt, lj)
    for mine, ref in zip(cache_t.kv, cache_j.kv):
        _close(mine, ref)


def test_port_decode_matches_port_forward(smoke):
    """Teacher-forced decode equals the parallel forward (same tokens)."""
    _, ct, _, pt = smoke
    toks = torch.from_numpy(_tokens(ct, (1, 24), seed=3))
    full = TR.forward_fn(ct)(pt, {"tokens": toks})
    caches = TR.make_decode_state(ct, 1, 64, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        logits, caches = TR.decode_fn(ct)(pt, toks[:, t:t + 1], caches, t)
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=TOL,
                               atol=TOL)


def _jax_serve(cfg, params, prompts, gen, cache_len):
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


def test_serve_loop_greedy_tokens_match_reference(smoke):
    cj, ct, pj, pt = smoke
    prompts = make_prompts(ct, 4, 16, seed=0, device="cpu")
    want = np.random.default_rng(0).integers(0, ct.vocab, (4, 16))
    np.testing.assert_array_equal(prompts.numpy(), want)
    out = generate(pt, ct, prompts, gen=12, cache_len=64)
    ref_tokens, ref_logits = _jax_serve(cj, pj, prompts.numpy(), 12, 64)
    got = out.tokens.numpy()
    assert got.shape == ref_tokens.shape and got.dtype == np.int32
    _close(out.first_logits, ref_logits[:, 0])
    near_ties = 0
    for row in range(got.shape[0]):
        differ = np.flatnonzero(got[row] != ref_tokens[row])
        if differ.size == 0:
            continue
        top2 = np.sort(ref_logits[row, differ[0]])[-2:]
        limit = 2 * (TOL + TOL * abs(top2[1]))
        assert top2[1] - top2[0] <= limit, (row, differ[0], top2)
        near_ties += 1
    print(f"serve loop: {near_ties} of {got.shape[0]} rows diverge at a "
          "near-tie")
    assert out.tokens_per_s > 0


def test_serve_fn_is_greedy_decode(smoke):
    _, ct, _, pt = smoke
    toks = torch.from_numpy(_tokens(ct, (2, 1), seed=5))
    caches = TR.make_decode_state(ct, 2, 8, device="cpu")
    logits, _ = TR.decode_fn(ct)(pt, toks, caches, 0)
    caches = TR.make_decode_state(ct, 2, 8, device="cpu")
    nxt, _ = make_serve_fn(ct)(pt, toks, caches, 0)
    assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
    assert torch.equal(nxt[:, 0], logits[:, -1].argmax(-1).to(torch.int32))


def test_bf16_forward_matches_reference():
    cj = jax_smoke_variant(jax_get_config(ARCH), dtype=jnp.bfloat16)
    ct = smoke_variant(get_config(ARCH), dtype=torch.bfloat16)
    pj, pt = _pair(cj, ct, seed=2)
    toks = _tokens(ct, (2, 32), seed=2)
    want = JR.forward_fn(cj)(pj, {"tokens": jnp.asarray(toks)})
    got = TR.forward_fn(ct)(pt, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


def test_chunked_attention_layer_matches_reference():
    """One layer at 2100 tokens: past 2048 keys both packages take the
    streaming-softmax route (``_attend_chunked``) on the CPU."""
    cj = jax_smoke_variant(jax_get_config(ARCH), n_layers=1)
    ct = smoke_variant(get_config(ARCH), n_layers=1)
    pj, pt = _pair(cj, ct, seed=3)
    toks = _tokens(ct, (1, 2100), seed=4)
    want = JR.forward_fn(cj)(pj, {"tokens": jnp.asarray(toks)})
    got = TR.forward_fn(ct)(pt, {"tokens": torch.from_numpy(toks)})
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_round_trip(dtype):
    cj = jax_smoke_variant(jax_get_config(ARCH), dtype=getattr(jnp, dtype))
    ct = smoke_variant(get_config(ARCH), dtype=getattr(torch, dtype))
    pj, pt = _pair(cj, ct, seed=5)
    tree = jax.tree.map(np.asarray, pj)
    names = dict(pt.named_parameters())
    assert len(names) == 3 + 9 * ct.n_layers
    for name, p in names.items():
        parts = name.split(".")
        if parts[0] == "layers":
            leaf = tree["layers"]
            for key in parts[2:]:
                leaf = leaf[key]
            leaf = leaf[int(parts[1])]
        else:
            leaf = tree[name]
        assert tuple(p.shape) == leaf.shape, name
        assert str(p.dtype).split(".")[-1] == leaf.dtype.name, name
        assert not p.requires_grad
        np.testing.assert_array_equal(p.float().numpy(),
                                      leaf.astype(np.float32))
    with pytest.raises(ValueError):
        params_from_numpy(ct, {k: v for k, v in tree.items()
                               if k != "lm_head"}, device="cpu")


def test_synthetic_pipeline_bitwise():
    cfg = get_config(ARCH, smoke=True)
    jp = jax_make_pipeline(jax_get_config(ARCH, smoke=True), 48, 3, seed=9)
    tp = make_pipeline(cfg, 48, 3, seed=9, device="cpu")
    for step in (0, 5):
        want, got = jp.batch(step), tp.batch(step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


def test_init_params_distributions():
    cfg = get_config(ARCH, smoke=True)
    gen = torch.Generator().manual_seed(0)
    model = TR.init_params(cfg, generator=gen, device="cpu")
    again = TR.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
        gain = name.rsplit(".", 1)[-1] in ("ln1", "ln2", "final_norm")
        assert p.dtype == (torch.float32 if gain else cfg.dtype)
        if p.numel() > 10000:
            assert abs(float(p.float().std()) - (1.0 if gain else 0.02)) \
                < 0.002


_NO_DEVICE_ENTRIES = {
    "init_params": lambda cfg, **kw: TR.init_params(cfg, **kw).embed,
    "make_decode_state": lambda cfg, **kw: TR.make_decode_state(
        cfg, 2, 8, **kw).kv[0],
    "make_kv_cache": lambda cfg, **kw: make_kv_cache(cfg, 2, 8, 1, **kw)[0],
    "make_pipeline": lambda cfg, **kw: make_pipeline(
        cfg, 8, 2, **kw).batch(0)["tokens"],
    "train": lambda cfg, **kw: train(cfg, steps=1, batch=2, seq=8,
                                     log=lambda s: None, **kw).params.embed,
}


@pytest.mark.parametrize("entry", sorted(_NO_DEVICE_ENTRIES))
def test_lm_entry_points_default_to_the_card(entry, monkeypatch):
    """With no device named they ask for the card: without one they raise
    the clear error; ``device="cpu"`` runs on the CPU."""
    cfg = get_config(ARCH, smoke=True)
    build = _NO_DEVICE_ENTRIES[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        build(cfg)
    assert build(cfg, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("module", [LM, Block, Attention, MLP, MoE, RGLRU,
                                    RwkvTimeMix, RwkvChannelMix, Recurrent,
                                    LocalAttention, Super])
def test_modules_take_an_explicit_device(module):
    arch = {MoE: "olmoe-1b-7b", RwkvTimeMix: "rwkv6-7b",
            RwkvChannelMix: "rwkv6-7b"}.get(module, ARCH)
    if module in (RGLRU, Recurrent, LocalAttention, Super):
        arch = "recurrentgemma-2b"
    cfg = get_config(arch, smoke=True)
    with pytest.raises(TypeError):
        module(cfg)
    params = list(module(cfg, device="cpu").parameters())
    assert params and all(p.device == torch.device("cpu") for p in params)
