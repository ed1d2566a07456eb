"""Serving launcher: batched prefill + greedy decode loop on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        --smoke --device cpu --batch 4 --prompt-len 32 --gen 16

Counterpart of ``repro.launch.serve``, with ``--device`` (the card by
default). It keeps the reference's loop: the prompt is fed one token at a
time through the decode path (teacher-forced prefill, which exercises the
cache), then ``--gen`` tokens are generated greedily; it prints the
generation rate in tokens/s. Weights are random, drawn from ``--seed``.
Every ``--arch`` serves. For the enc-dec family (``seamless-m4t-large-v2``)
the prompt is ``(batch, prompt_len, d_model)`` source frames drawn from
the same numpy generator after the token prompts; they are encoded, the
cross-attention K/V of every decoder layer precomputed into the caches,
and greedy decoding starts from token 0 at position 0 (no teacher-forced
prefill).

On the card the decode step is captured once as a CUDA graph and
replayed at every position (the reference compiles it once with
``jax.jit``): eager, a step of several thousand small operations is
bound by the host's dispatch, not by the card. On the CPU it runs
eagerly.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.common import ModelConfig
from ..models.encdec import EncDecCaches, encode, precompute_cross_kv
from ..models.registry import decode_fn, init_params, make_decode_state

__all__ = ["Generation", "generate", "make_prompts", "make_source", "main"]


@dataclasses.dataclass(frozen=True)
class Generation:
    tokens: torch.Tensor        # (b, gen) int32 greedy tokens
    first_logits: torch.Tensor  # (b, vocab) float32 logits of the first
    #                             generated step (position prompt_len - 1;
    #                             0 for the enc-dec family)
    prefill_s: float            # teacher-forced prefill (enc-dec: encode
    #                             and cross K/V), seconds
    decode_s: float             # greedy generation, seconds

    @property
    def tokens_per_s(self) -> float:
        return self.tokens.numel() / self.decode_s


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_prompts(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                 device) -> torch.Tensor:
    """The reference's prompts: ``default_rng(seed)`` integers."""
    return make_source(cfg, batch, prompt_len, seed, device)[0]


def make_source(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                device) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The reference's prompts and, for the enc-dec family, its source
    frames ``(batch, prompt_len, d_model)`` float32, drawn after them from
    the same ``default_rng(seed)`` (None for the other families)."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len))
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=device)
    if cfg.family != "encdec":
        return prompts, None
    src = rng.normal(0, 1, (batch, prompt_len, cfg.d_model))
    return prompts, torch.as_tensor(src.astype(np.float32), device=device)


def _cache_tensors(caches) -> list[torch.Tensor]:
    """The cache tensors a decode step writes (an enc-dec step writes its
    self-attention K/V only; the cross K/V are fixed inputs)."""
    if isinstance(caches, EncDecCaches):
        return list(caches.self_kv)
    return [t for field in caches if field is not None
            for t in (field if isinstance(field, tuple) else (field,))]


def _graphed_decode(params, cfg: ModelConfig, caches, batch: int,
                    device: torch.device):
    """``step(tokens, pos) -> logits``: one decode step captured as a
    CUDA graph on static token and position buffers, replayed per call
    (the logits are the graph's own buffer, rewritten by the next call).
    The warm-up step that capture needs writes into the caches; their
    values are put back after it."""
    dfn = decode_fn(cfg)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=device)
    pos = torch.zeros((), dtype=torch.int64, device=device)
    cache_list = _cache_tensors(caches)
    saved = [t.clone() for t in cache_list]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        dfn(params, tok, caches, pos)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        logits, _ = dfn(params, tok, caches, pos)
    for t, s in zip(cache_list, saved):
        t.copy_(s)
    del saved

    def step(tokens: torch.Tensor, p: int) -> torch.Tensor:
        tok.copy_(tokens)
        pos.fill_(p)
        graph.replay()
        return logits

    return step


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompts: torch.Tensor, *, gen: int,
             cache_len: int, src: Optional[torch.Tensor] = None
             ) -> Generation:
    """The reference's serve loop on ``prompts`` ``(b, prompt_len)``
    (for the enc-dec family: on the source frames ``src`` ``(b, s_src,
    d_model)``, decoding from token 0 at position 0); on a CUDA device
    each step replays one captured decode graph (the capture is timed
    with the prefill)."""
    batch, prompt_len = prompts.shape
    encdec = cfg.family == "encdec"
    if encdec and src is None:
        raise ValueError(f"{cfg.name}: the enc-dec family serves source "
                         "frames: pass src (launch.serve.make_source)")
    start_pos = 0 if encdec else prompt_len - 1
    if start_pos + gen > cache_len:
        raise ValueError(f"cache of {cache_len} cannot hold {prompt_len} "
                         f"prompt and {gen} generated tokens")
    device = prompts.device
    caches = make_decode_state(cfg, batch, cache_len, device=device,
                               s_src=src.shape[1] if encdec else 0)
    t0 = time.perf_counter()
    if encdec:
        memory = encode(params, src, cfg)
        ck, cv = precompute_cross_kv(params, memory, cfg)
        del memory
        caches = caches._replace(cross_k=ck, cross_v=cv)
    if device.type == "cuda":
        graphed = _graphed_decode(params, cfg, caches, batch, device)

        def dfn(p, tokens, c, pos):
            return graphed(tokens, pos), c
    else:
        dfn = decode_fn(cfg)
    for t in range(start_pos):
        _, caches = dfn(params, prompts[:, t:t + 1], caches, t)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    tok = torch.zeros_like(prompts[:, :1]) if encdec else prompts[:, -1:]
    out_tokens = []
    first: Optional[torch.Tensor] = None
    t0 = time.perf_counter()
    for i in range(gen):
        logits, caches = dfn(params, tok, caches, start_pos + i)
        if first is None:       # a copy: a graph rewrites its logits
            first = logits[:, -1, :].to(torch.float32, copy=True)
        tok = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        out_tokens.append(tok[:, 0])
    _sync(device)
    decode_s = time.perf_counter() - t0
    return Generation(tokens=torch.stack(out_tokens, dim=1),
                      first_logits=first, prefill_s=prefill_s,
                      decode_s=decode_s)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    device = resolve_device(args.device, what="repro_torch.launch.serve")
    gen_ = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, generator=gen_, device=device)
    prompts, src = make_source(cfg, args.batch, args.prompt_len, args.seed,
                               device)
    out = generate(params, cfg, prompts, gen=args.gen,
                   cache_len=args.cache_len, src=src)
    print(f"generated {tuple(out.tokens.shape)} tokens in "
          f"{out.decode_s * 1e3:.1f} ms ({out.tokens_per_s:.1f} tok/s)")
    print("sample:", out.tokens[0][:16].cpu().numpy())


if __name__ == "__main__":
    main()
