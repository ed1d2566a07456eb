"""The port's enc-dec family (``seamless-m4t-large-v2``) against the
reference's, on the CPU.

Smoke size: 2 encoder and 2 decoder layers, d_model 256, 4 heads of 64
(MHA), d_ff 512, vocabulary 512, float32. The reference draws the
weights (``PRNGKey``) and the port takes the same values through
``models.convert.params_from_numpy``; source frames and tokens come from
numpy (``tests/lm_family_checks.py``).

Tolerances:

* float32 — ``encode``, the forward's logits, the loss, the cross K/V,
  each decode step's logits and every cache leaf: rtol/atol 1e-4 (the
  dense family's, ``tests/test_torch_lm.py``); the serve loop's greedy
  tokens exactly, and its first logits to 1e-4;
* bf16 — held to the reference run op by op (its layer functions on each
  layer's slice, and decode under ``jax.disable_jit``) to 3e-2, as the
  hybrid and SSM families are (``lm_family_checks.check_bf16_forward``:
  the reference's compiled forward parts from its own op-by-op run by
  more than bf16's step); the distance to the compiled reference is
  printed;
* attention: the plain flash version against the reference's Pallas
  kernel in interpret mode and ``mha_attend`` against the reference's,
  both causal branches, 2e-3 in float32 and 3e-2 in bf16
  (``tests/test_torch_flash.py``'s);
* ``SyntheticEncDec``'s batches and the conversion of the weights:
  bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_family_checks as F
from lm_family_checks import one_torch_thread  # noqa: F401 — autouse
from repro.configs import get_config as jax_get_config
from repro.configs.base import smoke_variant as jax_smoke_variant
from repro.data import synthetic as jax_synthetic
from repro.kernels.flash_attention.flash_attention import (
    flash_attention_padded as jax_flash_padded)
from repro.models import attention as jax_attention
from repro.models import encdec as JE
from repro.models import registry as JR
from repro.models.common import rms_norm as jax_rms_norm
from repro.models.mlp import mlp as jax_mlp
from repro_torch.configs import get_config
from repro_torch.configs.base import smoke_variant
from repro_torch.data import SyntheticEncDec, make_pipeline
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.launch import serve as port_serve
from repro_torch.models import attention as port_attention
from repro_torch.models import encdec as PE
from repro_torch.models import registry as TR
from repro_torch.models.convert import tensor_from_numpy

ARCH = "seamless-m4t-large-v2"
ATT_TOL = {"float32": 2e-3, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _src(cfg, shape, seed=0):
    return np.random.default_rng(seed).normal(
        0, 1, (*shape, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def smoke():
    return F.smoke_pair(ARCH)


def _bf16_pair(seed=2):
    cj = jax_smoke_variant(jax_get_config(ARCH), dtype=jnp.bfloat16,
                           head_dim=64, n_heads=4, n_kv_heads=4)
    ct = smoke_variant(get_config(ARCH), dtype=torch.bfloat16, head_dim=64,
                       n_heads=4, n_kv_heads=4)
    pj, pt = F.pair(cj, ct, seed=seed)
    return cj, ct, pj, pt


@pytest.mark.parametrize("smoke_size", [True, False])
def test_config_matches_reference(smoke_size):
    F.check_config(ARCH, smoke_size)


def test_full_size_parameters():
    """The full model (built on the meta device) holds 24 encoder layers
    of 29.4 M parameters, 24 decoder layers of 33.6 M and a 262 M
    embedding and head each: 2.035 B. The reference's ``param_count``
    formula counts both stacks as decoder-only layers, so it leaves out
    each decoder layer's cross-attention and ``ln_x`` and the two final
    norms."""
    cfg = get_config(ARCH)
    model = PE.EncDec(cfg, device="meta")
    sizes = {n: p.numel() for n, p in model.named_parameters()}
    enc = sum(v for n, v in sizes.items() if n.startswith("enc_layers.0."))
    dec = sum(v for n, v in sizes.items() if n.startswith("dec_layers.0."))
    assert (enc, dec) == (29_362_176, 33_557_504)
    assert sizes["embed"] == sizes["lm_head"] == 256_206 * 1024
    total = sum(sizes.values())
    assert total == 24 * (enc + dec) + 2 * 256_206 * 1024 + 2 * 1024 \
        == 2_034_784_256
    assert cfg.param_count() == total - 24 * (4 * 1024 * 1024 + 1024) \
        - 2 * 1024


def test_encode_matches_reference(smoke):
    cj, ct, pj, pt = smoke
    src = _src(ct, (2, 40))
    want = JE.encode(pj, jnp.asarray(src), cj)
    with torch.no_grad():
        got = PE.encode(pt, torch.from_numpy(src), ct)
    assert got.shape == (2, 40, ct.d_model) and got.dtype == torch.float32
    F.close(got, want)


@pytest.mark.parametrize("s_src,s_tgt", [(40, 24), (24, 40)])
def test_forward_and_loss_match_reference(smoke, s_src, s_tgt):
    """Cross-attention with fewer and with more source than target
    positions."""
    cj, ct, pj, pt = smoke
    src = _src(ct, (2, s_src), seed=s_src)
    toks = F.tokens(ct, (2, s_tgt))
    labels = F.tokens(ct, (2, s_tgt), seed=7)
    batch = {"src_embeds": src, "tokens": toks, "labels": labels}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = TR.forward_fn(ct)(pt, tb)
    assert got.shape == (2, s_tgt, ct.vocab)
    F.close(got, JR.forward_fn(cj)(pj, jb))
    with torch.no_grad():
        got_loss = TR.loss_fn(ct)(pt, tb)
    np.testing.assert_allclose(float(got_loss), float(JR.loss_fn(cj)(pj, jb)),
                               rtol=F.TOL, atol=F.TOL)


def test_precompute_cross_kv_matches_reference(smoke):
    cj, ct, pj, pt = smoke
    memory = _src(ct, (3, 20), seed=5)
    kj, vj = JE.precompute_cross_kv(pj, jnp.asarray(memory), cj)
    kt, vt = PE.precompute_cross_kv(pt, torch.from_numpy(memory), ct)
    shape = (ct.n_layers, 3, ct.n_kv_heads, 20, ct.head_dim)
    assert tuple(kt.shape) == tuple(vt.shape) == shape == kj.shape
    F.close(kt, kj)
    F.close(vt, vj)


def _decode_both(cj, ct, pj, pt, steps, s_max=32, s_src=24, jit=True):
    src = _src(ct, (2, s_src), seed=9)
    toks = F.tokens(ct, (2, steps), seed=3)
    cache_j = JR.make_decode_state(cj, 2, s_max, s_src=s_src)
    mem = JE.encode(pj, jnp.asarray(src), cj)
    ck, cv = JE.precompute_cross_kv(pj, mem, cj)
    cache_j = cache_j._replace(cross_k=ck, cross_v=cv)
    cache_t = TR.make_decode_state(ct, 2, s_max, s_src=s_src, device="cpu")
    with torch.no_grad():
        memt = PE.encode(pt, torch.from_numpy(src), ct)
    ckt, cvt = PE.precompute_cross_kv(pt, memt, ct)
    cache_t = cache_t._replace(cross_k=ckt, cross_v=cvt)
    dfn = jax.jit(JR.decode_fn(cj)) if jit else JR.decode_fn(cj)
    out = []
    for t in range(steps):
        lj, cache_j = dfn(pj, jnp.asarray(toks[:, t:t + 1]), cache_j,
                          jnp.int32(t))
        lt, cache_t = TR.decode_fn(ct)(pt, torch.from_numpy(
            toks[:, t:t + 1]), cache_t, t)
        assert lt.shape == (2, 1, ct.vocab)
        out.append((lt, lj))
    return out, cache_t, cache_j


def test_decode_steps_and_caches_match_reference(smoke):
    """Eight decode steps' logits, then every cache leaf (the self K/V
    written in place, the cross K/V and source positions untouched)."""
    cj, ct, pj, pt = smoke
    steps, cache_t, cache_j = _decode_both(cj, ct, pj, pt, steps=8)
    for lt, lj in steps:
        F.close(lt, lj)
    for got, want in zip(cache_t.self_kv, cache_j.self_kv):
        assert tuple(got.shape) == want.shape
        F.close(got, want)
    F.close(cache_t.cross_k, cache_j.cross_k)
    F.close(cache_t.cross_v, cache_j.cross_v)
    np.testing.assert_array_equal(cache_t.memory_pos.numpy(),
                                  np.asarray(cache_j.memory_pos))


def test_decode_matches_forward(smoke):
    """Teacher-forced decode equals the port's own parallel forward (the
    decoder's causal self-attention over the cache, the fixed cross
    K/V)."""
    _, ct, _, pt = smoke
    src = torch.from_numpy(_src(ct, (1, 16), seed=4))
    toks = torch.from_numpy(F.tokens(ct, (1, 12), seed=3))
    full = TR.forward_fn(ct)(pt, {"src_embeds": src, "tokens": toks})
    caches = TR.make_decode_state(ct, 1, 32, s_src=16, device="cpu")
    with torch.no_grad():
        ck, cv = PE.precompute_cross_kv(pt, PE.encode(pt, src, ct), ct)
    caches = caches._replace(cross_k=ck, cross_v=cv)
    outs = []
    for t in range(12):
        logits, caches = TR.decode_fn(ct)(pt, toks[:, t:t + 1], caches, t)
        outs.append(logits[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=F.TOL,
                               atol=F.TOL)


def _jax_serve_encdec(cfg, params, batch, prompt_len, gen, cache_len, seed):
    """The reference CLI's enc-dec branch (``repro.launch.serve.main``)."""
    rng = np.random.default_rng(seed)
    rng.integers(0, cfg.vocab, (batch, prompt_len))        # the prompts
    caches = JR.make_decode_state(cfg, batch, cache_len, s_src=prompt_len)
    dfn = jax.jit(JR.decode_fn(cfg))
    src = jnp.asarray(rng.normal(0, 1, (batch, prompt_len, cfg.d_model)),
                      jnp.float32)
    memory = JE.encode(params, src, cfg)
    ck, cv = JE.precompute_cross_kv(params, memory, cfg)
    caches = caches._replace(cross_k=ck, cross_v=cv)
    tok = jnp.zeros((batch, 1), jnp.int32)
    toks, logits = [], []
    for i in range(gen):
        lg, caches = dfn(params, tok, caches, jnp.int32(i))
        tok = jnp.argmax(lg[:, -1:, :], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok[:, 0]))
        logits.append(np.asarray(lg[:, -1, :]))
    return np.stack(toks, axis=1), np.stack(logits, axis=1)


def test_serve_loop_tokens_equal_reference_cli(smoke):
    """``launch.serve.generate`` on ``make_source``'s prompts and frames:
    the greedy tokens equal the reference CLI's, every one."""
    cj, ct, pj, pt = smoke
    prompts, src = port_serve.make_source(ct, 4, 20, seed=0, device="cpu")
    out = port_serve.generate(pt, ct, prompts, gen=12, cache_len=64,
                              src=src)
    ref_tokens, ref_logits = _jax_serve_encdec(cj, pj, 4, 20, 12, 64, seed=0)
    assert out.tokens.dtype == torch.int32
    np.testing.assert_array_equal(out.tokens.numpy(), ref_tokens)
    F.close(out.first_logits, ref_logits[:, 0])


def test_serve_cli_runs_the_encdec_family(capsys):
    port_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert "generated (2, 4) tokens" in capsys.readouterr().out


def test_generate_needs_source_frames(smoke):
    _, ct, _, pt = smoke
    prompts, _ = port_serve.make_source(ct, 1, 4, seed=0, device="cpu")
    with pytest.raises(ValueError, match="source frames"):
        port_serve.generate(pt, ct, prompts, gen=2, cache_len=8)


@pytest.mark.parametrize("step", [0, 3])
def test_synthetic_encdec_batches_bitwise(step):
    """``make_pipeline``'s enc-dec batches (tokens, labels, source
    frames) equal the reference's bit for bit."""
    cj = jax_get_config(ARCH, smoke=True)
    ct = get_config(ARCH, smoke=True)
    want = jax_synthetic.make_pipeline(cj, 300, 2, seed=5).batch(step)
    pipe = make_pipeline(ct, 300, 2, seed=5, device="cpu")
    assert isinstance(pipe, SyntheticEncDec) and pipe.src_len == 256
    got = pipe.batch(step)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == (torch.float32 if key == "src_embeds"
                                  else torch.int32)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_weights_round_trip(smoke):
    """``params_to_numpy`` gives the reference's tree back, leaf for leaf
    (the stacked ``enc_layers`` and ``dec_layers`` included)."""
    F.check_round_trip(ARCH)


def test_init_scales_follow_reference():
    F.check_init_scales(ARCH)


def test_registry_builds_and_defaults():
    """Every registry function builds the family; the decode state's
    source length defaults to 128, as the reference's."""
    ct = get_config(ARCH, smoke=True)
    model = TR.init_params(ct, device="cpu")
    assert isinstance(model, PE.EncDec) and model.cfg == ct
    caches = TR.make_decode_state(ct, 2, 16, device="cpu")
    assert tuple(caches.cross_k.shape) == (2, 2, 4, 128, 64)
    assert tuple(caches.self_kv[0].shape) == (2, 2, 4, 16, 64)
    for fn in (TR.forward_fn, TR.loss_fn, TR.decode_fn):
        assert callable(fn(ct))


def test_training_refuses_the_encdec_family():
    """The refusal this test held is gone: the enc-dec family trains.
    ``make_train_fn`` builds for it, and one step on a ``SyntheticEncDec``
    batch (tokens, labels and source frames) gives a finite loss and
    moves the encoder's weights (its training against the reference:
    ``tests/test_torch_train_encdec.py``)."""
    from repro_torch.optim import AdamW
    from repro_torch.train.step import make_train_fn
    cfg = get_config(ARCH, smoke=True)
    model = TR.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    before = model.enc_layers[0].attn.wq.detach().clone()
    opt = AdamW(lr=1e-3)
    batch = make_pipeline(cfg, 64, 2, device="cpu").batch(0)
    _, _, loss = make_train_fn(cfg, opt)(model, opt.init(model), batch)
    assert np.isfinite(float(loss))
    assert not torch.equal(model.enc_layers[0].attn.wq, before)


def test_remat_flag_changes_nothing_under_grad(smoke):
    """``remat`` recomputes each layer in the backward: loss and
    gradients equal the plain graph's bit for bit."""
    _, ct, _, pt = smoke
    src = torch.from_numpy(_src(ct, (1, 12), seed=2))
    toks = torch.from_numpy(F.tokens(ct, (1, 10)))
    batch = {"src_embeds": src, "tokens": toks, "labels": toks}
    w = pt.enc_layers[0].attn.wq
    grads = []
    for remat in (True, False):
        w.requires_grad_(True)
        loss = PE.encdec_loss(pt, batch, ct, remat=remat)
        grads.append((loss.detach(), torch.autograd.grad(loss, w)[0]))
        w.requires_grad_(False)
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


# ------------------------------------------------------------------ bf16
def _rows(group):
    n = jax.tree.leaves(group)[0].shape[0]
    return [jax.tree.map(lambda a, i=i: a[i], group) for i in range(n)]


def reference_layerwise_encdec(cfg, params, src, toks):
    """The reference's forward run op by op: its ``_mha``, ``rms_norm``
    and ``mlp`` on each layer's slice of the stacked parameters, not
    jitted."""
    eps = cfg.norm_eps
    x = jnp.asarray(src).astype(cfg.dtype)
    pos_s = jnp.arange(x.shape[1])
    for p in _rows(params["enc_layers"]):
        h = jax_rms_norm(x, p["ln1"], eps)
        x = x + JE._mha(p["attn"], h, h, cfg, causal=False, q_pos=pos_s,
                        kv_pos=pos_s)
        x = x + jax_mlp(p["ffn"], jax_rms_norm(x, p["ln2"], eps))
    memory = jax_rms_norm(x, params["enc_norm"], eps)
    x = params["embed"][jnp.asarray(toks)]
    pos_t = jnp.arange(x.shape[1])
    for p in _rows(params["dec_layers"]):
        h = jax_rms_norm(x, p["ln1"], eps)
        x = x + JE._mha(p["self_attn"], h, h, cfg, causal=True, q_pos=pos_t,
                        kv_pos=pos_t)
        hx = jax_rms_norm(x, p["ln_x"], eps)
        x = x + JE._mha(p["cross_attn"], hx, memory, cfg, causal=False,
                        q_pos=pos_t, kv_pos=pos_s)
        x = x + jax_mlp(p["ffn"], jax_rms_norm(x, p["ln2"], eps))
    x = jax_rms_norm(x, params["final_norm"], eps)
    return np.asarray((x @ params["lm_head"]).astype(jnp.float32))


def test_bf16_forward_matches_reference_op_by_op():
    cj, ct, pj, pt = _bf16_pair()
    src = _src(ct, (2, 48), seed=2)
    toks = F.tokens(ct, (2, 32), seed=2)
    got = TR.forward_fn(ct)(pt, {"src_embeds": torch.from_numpy(src),
                                 "tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    want = reference_layerwise_encdec(cj, pj, src, toks)
    F.close(got, want, F.BF16_TOL)
    compiled = np.asarray(JR.forward_fn(cj)(pj, {
        "src_embeds": jnp.asarray(src), "tokens": jnp.asarray(toks)}),
        np.float32)
    print(f"{ARCH} bf16: max |port - compiled reference| "
          f"{np.abs(got.float().numpy() - compiled).max():.4g}, reference "
          f"op by op vs compiled {np.abs(want - compiled).max():.4g}")


def test_bf16_decode_matches_reference_op_by_op():
    """Four bf16 decode steps (the cross logits rounded to bf16 before
    the softmax, as the reference rounds them) against the reference's
    decode run op by op (``jax.disable_jit``)."""
    cj, ct, pj, pt = _bf16_pair(seed=3)
    with jax.disable_jit():
        steps, cache_t, cache_j = _decode_both(cj, ct, pj, pt, steps=4,
                                               s_max=8, s_src=16, jit=False)
    for lt, lj in steps:
        assert lt.dtype == torch.bfloat16
        F.close(lt, lj, F.BF16_TOL)
    for got, want in zip(cache_t.self_kv, cache_j.self_kv):
        F.close(got, want, F.BF16_TOL)


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("shape", [(2, 256, 512, 64), (2, 512, 256, 64),
                                   (1, 256, 256, 128)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_flash_noncausal_matches_reference_kernel(shape, dtype):
    """``flash_attention_ref(causal=False)`` (and the wrapper's CPU route)
    against the reference's Pallas body with ``causal=False`` in
    interpret mode, at tile multiples (its BLOCK_Q = BLOCK_K = 256), sq
    below, above and equal to skv."""
    bh, sq, skv, d = shape
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(sum(shape))
    arrays = [jnp.asarray(rng.normal(size=s), jdt)
              for s in ((bh, sq, d), (bh, skv, d), (bh, skv, d))]
    want = jax_flash_padded(*arrays, causal=False, scale=d ** -0.5,
                            interpret=True)
    q, k, v = (tensor_from_numpy(np.asarray(a))[None] for a in arrays)
    got = flash_attention_ref(q, k, v, causal=False)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=ATT_TOL[dtype], atol=ATT_TOL[dtype])
    before = flash_ops.launch_count()
    routed = flash_ops.flash_attention(q, k, v, causal=False)
    assert flash_ops.launch_count() == before
    assert torch.equal(routed, got)


# (causal, b, hq, hkv, sq, skv, d): a causal call needs sq <= skv
MHA_CASES = [(True, 1, 4, 2, 40, 300, 64), (False, 1, 4, 2, 40, 300, 64),
             (True, 1, 2, 2, 300, 2100, 32), (False, 1, 2, 2, 300, 2100, 32),
             (False, 1, 2, 1, 2100, 40, 32), (False, 1, 2, 2, 2100, 2100, 32)]


@pytest.mark.parametrize("case", MHA_CASES,
                         ids=lambda c: ("causal" if c[0] else "bidir") + "-"
                         + "x".join(map(str, c[1:])))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mha_attend_matches_reference(case, dtype):
    """Both branches, at skv under and over 2048 (the streaming softmax),
    sq below and above skv; ``backend="plain"`` takes the same route on
    the CPU."""
    causal, b, hq, hkv, sq, skv, d = case
    jdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(skv + sq)
    arrays = [jnp.asarray(rng.normal(size=s), jdt)
              for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]
    want = np.asarray(jax_attention.mha_attend(*arrays, causal=causal),
                      np.float32)
    q, k, v = (tensor_from_numpy(np.asarray(a)) for a in arrays)
    for backend in ("auto", "plain"):
        got = port_attention.mha_attend(q, k, v, causal=causal,
                                        backend=backend)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=ATT_TOL[dtype], atol=ATT_TOL[dtype])


@pytest.mark.parametrize("sq,skv", [(9, 8), (8, 9), (1, 300)])
def test_flash_wrapper_takes_noncausal_calls(sq, skv):
    """A non-causal call takes sq above skv too; the causal one still
    refuses it."""
    rng = np.random.default_rng(sq + skv)
    q = torch.from_numpy(rng.normal(size=(1, 4, sq, 32)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(1, 2, skv, 32)).astype(np.float32))
    got = flash_ops.flash_attention(q, kv, kv, causal=False)
    want = flash_attention_ref(q, kv, kv, causal=False)
    assert torch.equal(got, want)
    rep = port_attention.repeat_kv(kv, 2)
    probs = torch.softmax(q @ rep.transpose(-1, -2) / 32 ** 0.5, dim=-1)
    torch.testing.assert_close(got, probs @ rep, rtol=1e-5, atol=1e-5)
    if sq > skv:
        with pytest.raises(ValueError, match="sq <= skv"):
            flash_ops.flash_attention(q, kv, kv)
