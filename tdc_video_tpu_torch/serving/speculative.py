"""Prompt-lookup speculative decoding (port of
tdc_video_tpu/serving/speculative.py).

Drafts come from n-gram continuation lookup in the token history (prompt +
generated so far): a video-QA answer often echoes its prompt, and the
lookup needs no draft model.  Each verify step runs one K-token
`lm.verify_step` forward over [last token, K-1 drafts]; position j's argmax
is the token greedy decoding would produce after the window prefix, so the
longest prefix whose drafts agree, plus one bonus token, is exact: the
output is token-identical to serving/generate.decode_loop, and a window
with no agreeing draft still emits one token.

The loop runs on the host, as the port's plain loop does, and reads its
stop condition back every DONE_CHECK_EVERY verify steps (steps after every
row is done emit nothing).  The loop is greedy; sampled acceptance
(accept_and_emit_sampled, rejection sampling with deterministic drafts)
serves the engine's speculative chunks (serving/batching.py).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..config import TDCConfig
from ..models import lm as lm_mod
from . import prng
from .generate import DONE_CHECK_EVERY, _softmax, filter_rows

Params = Any


def propose_ngram(
    hist: torch.Tensor,  # [B, C] int32 token history (prompt + generated)
    hist_len: torch.Tensor,  # [B] int32 valid prefix length
    n: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draft k tokens per sample: the k tokens that followed the most recent
    earlier occurrence of the trailing n-gram.  Returns (draft [B, k],
    found [B] bool); where nothing is found the draft is the history's head,
    which verification rejects at no extra cost."""
    B, C = hist.shape
    dev = hist.device
    gidx = (hist_len[:, None] - n + torch.arange(n, device=dev)[None]).clamp_min(0)
    gram = torch.take_along_dim(hist, gidx.long(), dim=1)  # [B, n]
    match = torch.ones((B, C), dtype=torch.bool, device=dev)
    for j in range(n):
        match &= torch.roll(hist, -j, dims=1) == gram[:, j:j + 1]
    idx = torch.arange(C, device=dev)[None]
    # the match must end before the trailing gram itself (which also keeps
    # every compared slot in range)
    valid = match & (idx < hist_len[:, None] - n)
    best = torch.where(valid, idx, -1).amax(dim=1)  # the most recent match
    found = best >= 0
    start = torch.where(found, best + n, 0)
    didx = (start[:, None] + torch.arange(k, device=dev)[None]).clamp_max(C - 1)
    return torch.take_along_dim(hist, didx, dim=1), found


def accept_and_emit(
    greedy: torch.Tensor,  # [B, K] argmax continuations from verify_step
    draft: torch.Tensor,  # [B, K-1] proposed draft tokens
    eos: torch.Tensor,  # [E] eos token ids
    remaining: torch.Tensor,  # [B] budget left (max_new - emitted)
    done: torch.Tensor,  # [B] already finished
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy acceptance: emit the longest prefix of `greedy` whose drafts
    agreed, plus the bonus token, cut at the first emitted EOS and at the
    remaining budget.  Returns (m [B] emit counts, eos_emitted [B])."""
    K = greedy.shape[1]
    agree = greedy[:, :-1] == draft
    a = torch.cumprod(agree.to(torch.int32), dim=1).sum(dim=1)  # [B] 0..K-1
    m_raw = a + 1
    j_idx = torch.arange(K, device=greedy.device)[None]
    is_eos = (greedy[..., None] == eos[None, None, :]).any(dim=-1)
    eos_hit = is_eos & (j_idx < m_raw[:, None])
    first_eos = torch.where(eos_hit, j_idx, K).amin(dim=1)  # K: none
    m = torch.minimum(torch.minimum(m_raw, first_eos + 1), remaining)
    m = torch.where(done, 0, m).to(torch.int32)
    return m, first_eos < m


def accept_and_emit_sampled(
    logits: torch.Tensor,  # [B, K, V] verify_step logits
    draft: torch.Tensor,  # [B, K-1] proposed draft tokens
    eos: torch.Tensor,  # [E]
    remaining: torch.Tensor,  # [B]
    done: torch.Tensor,  # [B]
    temp: torch.Tensor,  # [B] f32; <= 0 rows take the exact greedy rule
    topk: torch.Tensor,  # [B]
    topp: torch.Tensor,  # [B] f32
    seed: torch.Tensor,  # [B]
    gidx: torch.Tensor,  # [B] tokens emitted so far (counter-mode index)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative sampling with deterministic (prompt-lookup) drafts: draft
    d_j is accepted with probability p_j(d_j) under the warped target
    distribution (generate.filter_rows); at the first rejection the token is
    drawn from p_j with d_j excluded, and after a fully accepted window the
    bonus token from p_{K-1}, so every emitted token is p-distributed.
    Greedy rows (temp <= 0) follow accept_and_emit's rule exactly.

    Keys are counter-mode: the token at index gidx+j draws from
    fold_in(fold_in(PRNGKey(0), seed), gidx+j), substream 1 for the accept
    uniform and substream 2 for the resample, as JAX's.  Returns (emit
    [B, K] tokens, m [B] emit counts, eos_emitted [B])."""
    B, K, V = logits.shape
    dev = logits.device
    x = logits.float()
    greedy = torch.argmax(x, dim=-1).to(torch.int32)  # [B, K]
    xw = filter_rows(x.reshape(B * K, V), temp.repeat_interleave(K), topk.repeat_interleave(K),
                     topp.repeat_interleave(K)).reshape(B, K, V)
    probs = _softmax(xw)
    j_idx = torch.arange(K, device=dev)
    base = prng.fold_in(prng.PRNGKey(0, device=dev), seed)  # [B, 2]
    keys = prng.fold_in(base[:, None, :], gidx[:, None].long() + j_idx[None])  # [B, K, 2]
    u = prng.uniform(prng.fold_in(keys, 1))  # [B, K]
    d = draft.long()
    p_d = torch.take_along_dim(probs[:, :-1], d[..., None], dim=-1)[..., 0]
    sampled_row = (temp > 0.0)[:, None]
    accept = torch.where(sampled_row, u[:, :-1] < p_d, greedy[:, :-1] == draft)
    a = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)  # [B] 0..K-1
    # final-token candidates: position j < K-1 resamples with its rejected
    # draft masked out (the residual), position K-1 is the bonus draw
    masked = xw[:, :-1].scatter(-1, d[..., None], float("-inf"))
    cand = torch.cat([masked, xw[:, -1:]], dim=1)  # [B, K, V]
    r = prng.categorical(prng.fold_in(keys, 2), cand).to(torch.int32)  # [B, K]
    ai = a[:, None].long()
    final = torch.where(temp > 0.0, torch.take_along_dim(r, ai, dim=1)[:, 0],
                        torch.take_along_dim(greedy, ai, dim=1)[:, 0])
    jj = j_idx[None]
    dpad = torch.cat([draft, draft[:, -1:]], dim=1).to(torch.int32)
    zero = torch.zeros_like(greedy)
    e = torch.where(jj < a[:, None], dpad, torch.where(jj == a[:, None], final[:, None], zero))
    # greedy rows emit the argmax (equal to the draft where it was accepted)
    e = torch.where(sampled_row, e, torch.where(jj <= a[:, None], greedy, zero))
    m_raw = a + 1
    is_eos = (e[..., None] == eos[None, None, :]).any(dim=-1)
    eos_hit = is_eos & (jj < m_raw[:, None])
    first_eos = torch.where(eos_hit, jj, K).amin(dim=1)
    m = torch.minimum(torch.minimum(m_raw, first_eos + 1), remaining)
    m = torch.where(done, 0, m).to(torch.int32)
    return e, m, first_eos < m


def pld_decode_loop(
    cfg: TDCConfig,
    params: Params,
    cache: Dict,
    first_token: torch.Tensor,  # [B] int32, from the prefill logits
    prompt_ids: torch.Tensor,  # [B, Lp] right-padded prompt tokens
    prompt_len: torch.Tensor,  # [B] valid prompt lengths
    max_new_tokens: int,
    window: int = 8,
    ngram: int = 3,
    attn_impl: str = "xla",
    mesh=None,
) -> Tuple[torch.Tensor, int]:
    """Greedy decode with prompt-lookup speculation; the contract of
    generate.decode_loop: (tokens [B, max_new_tokens] int32 with pad after
    EOS, verify steps).  Each step runs one K-token verify forward and emits
    0..K tokens a row; the steps returned are those that emitted a token
    (the loop runs up to DONE_CHECK_EVERY - 1 more, which emit none).  The cache needs window-1 slots of headroom
    past prompt_len + max_new_tokens (verify_step writes the whole window
    before acceptance is known)."""
    B, Lp = prompt_ids.shape
    K = window
    if K < 2:
        raise ValueError("window must be >= 2 (1 draft minimum)")
    dev = first_token.device
    eos = torch.tensor(cfg.lm.eos_token_ids, dtype=torch.int32, device=dev)
    pad = cfg.lm.pad_token_id
    C = Lp + max_new_tokens + 1
    brange = torch.arange(B, device=dev)
    first_token = first_token.to(torch.int32)
    prompt_len = prompt_len.to(torch.int32)

    hist = torch.zeros((B, C), dtype=torch.int32, device=dev)
    hist[:, :Lp] = prompt_ids.to(torch.int32)
    hist[brange, prompt_len.clamp_max(C - 1).long()] = first_token
    hist_len = prompt_len + 1

    out = torch.full((B, max_new_tokens), pad, dtype=torch.int32, device=dev)
    out[:, 0] = first_token
    done = (first_token[:, None] == eos[None]).any(-1)
    ne = torch.ones((B,), dtype=torch.int32, device=dev)
    last = first_token
    steps = 0
    emitting = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        if steps % DONE_CHECK_EVERY == 0 and not bool((~done & (ne < max_new_tokens)).any()):
            break
        draft, _ = propose_ngram(hist, hist_len, ngram, K - 1)
        tokens = torch.cat([last[:, None], draft], dim=1)  # [B, K]
        embeds = lm_mod.embed_tokens(cfg.lm, params["lm"], tokens, cfg.dtype, mesh)
        logits, cache = lm_mod.verify_step(cfg.lm, params["lm"], embeds, cache,
                                           attn_impl=attn_impl, dtype=cfg.dtype, mesh=mesh)
        g = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, K]
        m, eos_emitted = accept_and_emit(g, draft, eos, max_new_tokens - ne, done)
        for j in range(K):  # masked per-sample scatters
            sel = j < m
            pos = (ne + j).clamp_max(max_new_tokens - 1).long()
            out[brange, pos] = torch.where(sel, g[:, j], out[brange, pos])
            hpos = (hist_len + j).clamp_max(C - 1).long()
            hist[brange, hpos] = torch.where(sel, g[:, j], hist[brange, hpos])
        cache = lm_mod.commit_verified(cache, m)
        new_last = torch.take_along_dim(g, (m - 1).clamp_min(0)[:, None].long(), dim=1)[:, 0]
        last = torch.where(m > 0, new_last, last)
        ne = ne + m
        hist_len = hist_len + m
        done = done | eos_emitted
        emitting += (m > 0).any()
        steps += 1
    return out, int(emitting)
