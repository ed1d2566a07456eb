"""The port's MoE family against the reference's, on the CPU.

``olmoe-1b-7b`` and ``qwen3-moe-235b-a22b`` at smoke size (4 layers,
d_model 256, 8 experts, top-2, float32), weights drawn by the reference
and carried over by ``params_from_numpy``, tokens from numpy
(``tests/lm_family_checks.py``).

Tolerances: float32 logits, losses, decode steps and caches to rtol/atol
1e-4; the bf16 variant to 3e-2. Integers are exact: the routing (each
token's k experts in score order, each pair's slot, which pairs are
dropped for capacity) from the same router scores, ties included; from
each package's own scores, every token but those whose k-th and
(k+1)-th (or any two of the top k+1) reference scores lie within 1e-5
relative — near-ties, counted and printed — and, since a token's slot
counts the earlier tokens' choices, the slots only up to the first
near-tie. Greedy serve tokens are exact except counted near-ties.
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
from repro.models import moe as jax_moe
from repro_torch.configs import get_config
from repro_torch.models import moe as port_moe
from repro_torch.models.convert import tensor_from_numpy

ARCHS = ["olmoe-1b-7b", "qwen3-moe-235b-a22b"]
TIE_RTOL = F.TIE_RTOL
_reference_routing = F.reference_routing
_near_ties = F.near_ties
_assert_routing = F.assert_routing


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke_size", [True, False])
def test_config_matches_reference(arch, smoke_size):
    F.check_config(arch, smoke_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    F.check_forward_and_loss(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    F.check_decode(arch)


def test_serve_loop_greedy_tokens_match_reference():
    F.check_serve("olmoe-1b-7b")


def test_port_decode_matches_port_forward():
    """With capacity for every pair (factor e / k) no token is dropped,
    so the teacher-forced decode equals the forward; at the configs'
    1.25 the forward's larger groups drop pairs that one-token steps
    keep, in both packages."""
    cfg = get_config("olmoe-1b-7b", smoke=True)
    F.check_decode_matches_forward(
        "olmoe-1b-7b",
        moe_capacity_factor=cfg.moe_experts / cfg.moe_topk)


def _own_near_ties(model, cfg, toks):
    """Rows whose port router scores, at any layer, hold their k-th and
    (k+1)-th within ``BF16_TIE`` of the row's largest |score|."""
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import attention
    from repro_torch.models.common import rms_norm
    x = torch.nn.functional.embedding(toks.long(), model.embed)
    pos = torch.arange(toks.shape[1])
    tie = torch.zeros(toks.shape, dtype=torch.bool)
    for layer in model.layers:
        xa = x + attention(layer.attn, rms_norm(x, layer.ln1, cfg.norm_eps),
                           cfg, pos)
        sc = (rms_norm(xa, layer.ln2, cfg.norm_eps) @ layer.ffn.router)
        top = torch.sort(sc.float(), dim=-1, descending=True).values
        k = cfg.moe_topk
        tie |= (top[..., k - 1] - top[..., k]) <= \
            BF16_TIE * top.abs().amax(-1)
        x = T._block_fwd(cfg, layer, x, pos, "auto")
    return tie.numpy()


# two bf16 units in the last place of a row's largest router score
BF16_TIE = 2.0 ** -7


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_reference(arch):
    """bf16 logits to 3e-2, except rows whose routing sits at a bf16
    near-tie (``BF16_TIE``; counted, at most a quarter of the rows). In
    bf16 router scores tie often, and the reference's own compiled
    forward keeps fused intermediates that its op-by-op layers round, so
    it can order two such scores either way. The capacity is e / k, so no
    pair is dropped and a parted routing moves no other token's slot
    (drops are held exactly in float32 above)."""
    from repro.configs.base import smoke_variant as jax_smoke_variant
    from repro.models import registry as JR
    from repro_torch.configs.base import smoke_variant
    from repro_torch.models import registry as TR
    cf = get_config(arch, smoke=True)
    cf = cf.moe_experts / cf.moe_topk
    cj = jax_smoke_variant(jax_get_config(arch), dtype=jnp.bfloat16,
                           moe_capacity_factor=cf)
    ct = smoke_variant(get_config(arch), dtype=torch.bfloat16,
                       moe_capacity_factor=cf)
    pj, pt = F.pair(cj, ct, seed=2)
    toks = F.tokens(ct, (2, 64), seed=2)
    want = np.asarray(JR.forward_fn(cj)(pj, {"tokens": jnp.asarray(toks)}),
                      np.float32)
    got = TR.forward_fn(ct)(pt, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    ties = _own_near_ties(pt, ct, torch.from_numpy(toks))
    print(f"{arch} bf16: {int(ties.sum())} of {ties.size} rows at a "
          "routing near-tie")
    assert ties.sum() <= ties.size // 4
    F.close(got.float().numpy()[~ties], want[~ties], F.BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    F.check_round_trip(arch)


def test_init_scales_follow_reference():
    F.check_init_scales("olmoe-1b-7b")


@pytest.mark.parametrize("case", ["random", "ties", "overflow"])
def test_routing_equals_reference_on_the_same_scores(case):
    """From the same float32 scores the routing is the reference's
    exactly: ``ties`` rounds scores to quarters so equal scores abound
    (the lower expert index wins, as ``jax.lax.top_k`` breaks them);
    ``overflow`` biases one expert so its pairs pass the capacity."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True),
                              moe_experts=16, moe_topk=4)
    rng = np.random.default_rng(11)
    scores = rng.normal(size=(96, 16)).astype(np.float32)
    if case == "ties":
        scores = np.round(scores * 4) / 4
    if case == "overflow":
        scores[:, 3] += 10.0
    want = _reference_routing(scores, cfg)
    got = port_moe.route_scores(torch.from_numpy(scores), cfg)
    _assert_routing(got, want)
    if case == "overflow":
        assert (~want[3]).sum() > 0
    if case == "ties":
        assert _near_ties(scores, cfg.moe_topk).sum() > 10


def _moe_layer(cfg, seed, bias_expert=None):
    """One MoE layer's weights drawn by the reference, and the port's
    ``MoE`` holding them; ``bias_expert`` adds a large column to the
    router so that expert overflows."""
    from repro.models.common import KeyGen
    params = jax_moe.init_moe(cfg, KeyGen(jax.random.PRNGKey(seed), False))
    if bias_expert is not None:
        params["router"] = params["router"].at[:, bias_expert].add(0.5)
    port = port_moe.MoE(get_config("olmoe-1b-7b", smoke=True), device="cpu")
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(tensor_from_numpy(np.asarray(params[name])))
    return params, port


@pytest.mark.parametrize("bias", [None, 5])
def test_moe_layer_routing_drops_and_output_match_reference(bias):
    """The layer on 4 x 48 tokens from each package's own scores: the
    routing (near-ties counted and excluded), the dropped pairs — with
    ``bias`` one expert overflows — and the output (up to the first
    near-tie, past which slots and drops may part)."""
    cfg = jax_get_config("olmoe-1b-7b", smoke=True)
    params, port = _moe_layer(cfg, seed=3, bias_expert=bias)
    x = np.random.default_rng(5).normal(size=(4, 48, cfg.d_model)) \
        .astype(np.float32)
    scores = np.asarray((jnp.asarray(x).reshape(-1, cfg.d_model)
                         @ params["router"]).astype(jnp.float32))
    want = _reference_routing(scores, cfg)
    ct = get_config("olmoe-1b-7b", smoke=True)
    with port_moe.record_routing() as log:
        got = port_moe.route(port, torch.from_numpy(x), ct)
        out = port_moe.moe(port, torch.from_numpy(x), ct)
    ties = _near_ties(scores, cfg.moe_topk)
    print(f"bias {bias}: {int(ties.sum())} of {len(ties)} tokens at a "
          f"near-tie; {int((~want[3]).sum())} pairs dropped")
    _assert_routing(got, want, ties)
    assert len(log) == 2 and all(torch.equal(r.keep, got.keep)
                                 for r in log)
    if bias is not None:
        assert (~want[3]).sum() > 0
    first = int(np.argmax(ties)) if ties.any() else len(ties)
    ref_out = np.asarray(jax_moe.moe(params, jnp.asarray(x), cfg))
    F.close(out.reshape(-1, cfg.d_model)[:first],
            ref_out.reshape(-1, cfg.d_model)[:first])


def test_combine_is_the_reference_scatter_add_bitwise():
    """On the same expert outputs and routing, ``combine`` (0 + each
    token's kept pairs in ascending expert order, float32) equals the
    reference's scatter-add over its (e, cap) table bit for bit
    (``repro.models.moe.moe``, lines 73-107, one group)."""
    cfg = dataclasses.replace(get_config("olmoe-1b-7b", smoke=True),
                              moe_experts=16, moe_topk=4)
    rng = np.random.default_rng(13)
    scores = rng.normal(size=(80, 16)).astype(np.float32)
    scores[:, 2] += 3.0                      # one expert overflows
    r = port_moe.route_scores(torch.from_numpy(scores), cfg)
    e, cap, d, t, k = 16, r.cap, 32, 80, 4
    ye = rng.normal(size=(e, cap, d)).astype(np.float32)
    got = port_moe.combine(torch.from_numpy(ye), r).numpy()

    fe = jnp.asarray(r.expert.numpy().reshape(-1))
    ss = jnp.asarray(np.where(r.keep.numpy(), r.slot.numpy(), cap)
                     .reshape(-1))
    ft = jnp.repeat(jnp.arange(t), k)
    fg = jnp.asarray(r.gate.numpy().reshape(-1))
    st = jnp.full((e, cap + 1), t, jnp.int32).at[fe, ss].set(
        jnp.where(ss < cap, ft, t))[:, :cap]
    gt = jnp.zeros((e, cap + 1), jnp.float32).at[fe, ss].set(
        jnp.where(ss < cap, fg, 0.0))[:, :cap]
    yw = jnp.asarray(ye) * gt[..., None]
    want = np.asarray(jnp.zeros((t + 1, d), jnp.float32).at[
        st.reshape(-1)].add(yw.reshape(-1, d))[:t])
    assert (~r.keep).sum() > 0
    np.testing.assert_array_equal(got, want)
