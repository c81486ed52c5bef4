"""Continuous batching: an admission queue over one shared decode loop (port
of tdc_video_tpu/serving/batching.py).

A fixed pool of KV-cache slots decodes in lockstep, one masked decode step
over all slots (models/lm.decode_step(active=...)), and new requests are
admitted into free slots between decode chunks, so a long answer never
blocks a short one behind it.  Modes, as in JAX: greedy and per-request
sampled chunks (generate.sample_rows, counter-mode keys: a request's stream
depends only on its seed and token index); speculative chunks (spec_window
>= 2: one K-token verify_step a step with per-slot prompt-lookup drafts,
greedy or by rejection sampling); shared-prefix admission (a prefix is
prefilled once per prefix_key and each request extends only its suffix,
models/lm.extend_prefill); chunked admission (prefill_chunk > 0: a long
prompt prefills one chunk per decode chunk); cancel, timeouts and
on_tokens streaming with errors isolated; keep_prefix snapshots for
multi-turn sessions (serving/session.py).

PyTorch design.  JAX's chunk is one lax.scan of chunk_tokens steps; here it
is a host loop of chunk_tokens steps with all per-slot state (last token,
active mask, budget, sampling parameters, token index, draft history) on
the device, harvested once per chunk: the chunk's tokens, the active mask,
the budgets and the cache lengths come back in ONE device-to-host read.
`active` and `budget` keep host mirrors, refreshed by that read and by
admission, so that choosing a slot and deciding to stop never sync.

On a card, without a mesh and without speculation, the lockstep chunk is a
CUDA graph: one per variant (greedy, sampled), captured after the first
chunk of that variant has run eagerly on a side stream, and replayed for
every later chunk, so that a chunk costs the host one launch instead of
the ~1,760 ops a step.  Everything the chunk reads or writes is a buffer
the engine owns and updates in place: the shared cache (decode_step writes
its mask and lengths in place), the per-slot tensors (reset() zeroes them
in place) and the chunk's token buffer.  The eager path runs the same
in-place code.  Under a mesh the NCCL collectives stay outside graphs, and
speculative chunks stay eager.

The port's caches are written in place (models/lm.py), where JAX's are
functional: a stored prefix (donor) is copied before each extend, and
snapshots are copies, never views of a slot that will be reused.

mesh (parallel/mesh.py): the LM runs tensor-parallel over the mesh's
model axis on this rank's shard of the params, and every cache (the
shared one, each batch-1 prefill, chunk and prefix donor) holds this
rank's num_kv_heads/n heads (kv_cache_spec).  Every rank runs the same
engine on the same requests and takes the same admission and harvest
decisions from the same host state: the logits are whole on every rank
(models/lm.lm_head), so are the tokens, and the one device-to-host read
per chunk is one per rank.  Timeouts are the one input that differs
between ranks (each reads its own clock): when a live request has one,
the ranks agree on each chunk boundary's expiries (a MAX over the mesh).
cancel() must be called on every rank.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import TDCConfig
from ..device import resolve_device
from ..models import lm as lm_mod
from ..utils.profiling import span
from .generate import inference_params, sample_rows

Params = Any


@dataclass
class Request:
    """One decode request: an already-embedded prompt (text-only, or the
    packed multimodal prefix from TDCPredictor.pack_prompt)."""

    embeds: torch.Tensor  # [1, L, H] right-padded
    attn_mask: Any  # [1, L] bool (tensor or numpy)
    max_new_tokens: int = 64
    uid: Any = None
    # text ids of the prompt, which seed prompt-lookup drafts when the
    # engine speculates (the packed embeds have no token identity)
    prompt_ids: Optional[np.ndarray] = None
    # shared-prefix admission: requests with one prefix_key declare that
    # embeds[:, :prefix_len] are identical across them
    prefix_key: Any = None
    prefix_len: int = 0
    # seconds from submit(); a request past it ends with timed_out=True at
    # the next chunk boundary (queued: before it prefills)
    timeout_s: Optional[float] = None
    # sampling (temperature 0 = greedy): HF's warper order, counter-mode
    # keys on (seed, token index)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # multi-turn: at finish, snapshot this request's slot (prompt and
    # generated KV) into the prefix store under this key, kept until
    # release_prefix(key)
    keep_prefix: Any = None
    # filled by the engine
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    timed_out: bool = False
    submit_t: float = 0.0
    kv_len: int = 0  # at finish with keep_prefix: the committed cache length
    mask_host: Optional[np.ndarray] = field(default=None, repr=False)  # [L] bool


@dataclass
class _PendingPrefill:
    """A prefill in flight under chunked admission: advanced one chunk per
    run() iteration, between decode chunks."""

    req: Request
    key: Any  # prefix_key being built, or None for a plain prompt
    embeds: torch.Tensor  # [1, N, H] the valid tokens still to feed
    total: int  # N
    cache1: Dict  # capacity-length batch-1 cache being filled
    pos: int = 0  # tokens committed so far
    first: Any = None  # the last chunk's next-token argmax
    first_logits: Any = None  # the last chunk's next-token logits


_CACHE_KEYS = ("k", "v", "k_scale", "v_scale")


def _extract_cache(shared: Dict, slot: int) -> Dict:
    """A copy of one slot as a batch-1 capacity-length cache (the donor
    format extends take)."""
    out = {k: shared[k][:, slot:slot + 1].clone() for k in _CACHE_KEYS if k in shared}
    out["mask"] = shared["mask"][slot:slot + 1].clone()
    out["lengths"] = shared["lengths"][slot:slot + 1].clone()
    return out


def _copy_cache(cache: Dict) -> Dict:
    return {k: v.clone() for k, v in cache.items()}


def _insert_cache(shared: Dict, one: Dict, slot: int) -> Dict:
    """Write a batch-1 cache into `slot` of the shared cache, in place; the
    rows past its length are zeroed, as JAX's padded update writes them."""
    S1 = one["k"].shape[2]
    for k in _CACHE_KEYS:
        if k in shared:
            shared[k][:, slot, :S1] = one[k][:, 0]
            shared[k][:, slot, S1:] = 0
    shared["mask"][slot, :S1] = one["mask"][0]
    shared["mask"][slot, S1:] = False
    shared["lengths"][slot] = one["lengths"][0]
    return shared


def _pad_cache(cache1: Dict, capacity: int) -> Dict:
    """A batch-1 cache padded with zeros to `capacity` rows (a copy)."""
    S1 = cache1["k"].shape[2]
    out = {}
    for k in _CACHE_KEYS:
        if k in cache1:
            x = cache1[k]
            pad = x.new_zeros(x.shape[:2] + (capacity - S1,) + x.shape[3:])
            out[k] = torch.cat([x, pad], dim=2)
    out["mask"] = torch.cat([cache1["mask"], cache1["mask"].new_zeros((1, capacity - S1))], dim=1)
    out["lengths"] = cache1["lengths"].clone()
    return out


class DecodeEngine:
    """Fixed-slot continuous-batching decoder on `device` (CUDA unless the
    caller passes device="cpu")."""

    def __init__(
        self,
        cfg: TDCConfig,
        params: Params,
        num_slots: int = 4,
        capacity: int = 1024,
        chunk_tokens: int = 16,
        attn_impl: str = "xla",
        kv_quant: Optional[str] = None,  # "int8": int8 shared cache
        act_quant: bool = False,  # s8 x s8 prefill (decode stays weight-only)
        spec_window: int = 0,  # >= 2: speculative lockstep decode
        spec_ngram: int = 3,
        prefill_chunk: int = 0,  # > 0: chunked admission, this many tokens a chunk
        mesh=None,
        on_tokens=None,  # callable(req, new_token_ids): token streaming
        device=None,
    ):
        if prefill_chunk < 0 or prefill_chunk > capacity:
            raise ValueError(f"prefill_chunk {prefill_chunk} not in [0, {capacity}]")
        self.cfg = cfg
        self.params = inference_params(params)
        self.num_slots = num_slots
        self.capacity = capacity
        self.chunk_tokens = chunk_tokens
        self.attn_impl = attn_impl
        self.kv_quant = kv_quant
        self.act_quant = act_quant
        self.spec_window = spec_window
        self.spec_ngram = spec_ngram
        self.prefill_chunk = prefill_chunk
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.cache = self._new_cache(num_slots, capacity)
        self._eos = torch.tensor(cfg.lm.eos_token_ids, dtype=torch.int32, device=self.device)
        S, dev = num_slots, self.device
        # per-slot device state, allocated once and updated in place (the
        # chunk's graphs hold these storages); reset() zeroes it
        self._budget_dev = torch.zeros(S, dtype=torch.int32, device=dev)
        self._last_tok = torch.zeros(S, dtype=torch.int32, device=dev)
        self._active = torch.zeros(S, dtype=torch.bool, device=dev)
        self._temp = torch.zeros(S, dtype=torch.float32, device=dev)
        self._topk = torch.zeros(S, dtype=torch.int32, device=dev)
        self._topp = torch.ones(S, dtype=torch.float32, device=dev)
        self._seed = torch.zeros(S, dtype=torch.int32, device=dev)
        self._genidx = torch.zeros(S, dtype=torch.int32, device=dev)
        self._chunk_out = torch.zeros((S, chunk_tokens), dtype=torch.int32, device=dev)
        if spec_window >= 2:
            # per-slot draft history: prompt ids (<= capacity) + generated
            self._hist_cap = capacity + spec_window + 1
            self._hist = torch.zeros((S, self._hist_cap), dtype=torch.int32, device=dev)
            self._hist_len = torch.zeros(S, dtype=torch.int32, device=dev)
        # the chunk's CUDA graphs by variant (sampled: bool), kept across
        # reset(); None where chunks run eagerly.  The counts are over the
        # engine's life
        graphed = self.device.type == "cuda" and mesh is None and spec_window < 2
        self._graphs: Optional[Dict[bool, Any]] = {} if graphed else None
        self.graph_captures = 0  # chunk graphs captured
        self.graph_replays = 0  # chunks run by replaying one
        self.reset(on_tokens)

    def reset(self, on_tokens=None):
        """Clear the per-run request state so that the engine serves a new
        batch (answer_many reuses engines by shape).  The KV buffers stay:
        slot reads are length-masked, so a previous run's rows are
        unreachable.  The per-slot device tensors are zeroed in place, so
        that the chunk's graphs read live buffers."""
        S = self.num_slots
        self._pending: Optional[_PendingPrefill] = None
        self._requests: List[Optional[Request]] = [None] * S
        self._budget = np.zeros(S, np.int32)  # host mirror of _budget_dev
        self._active_host = np.zeros(S, bool)  # host mirror of _active
        self._lengths = np.zeros(S, np.int64)  # cache lengths at the last harvest
        self._queue: List[Request] = []
        self._finished: List[Request] = []
        self._prefixes: Dict[Any, Dict] = {}  # prefix_key -> batch-1 donor cache
        self._kept: set = set()  # keep_prefix keys, exempt from _gc_prefixes
        self.steps = 0  # decode chunks run
        self.prefix_prefills = 0  # full-prefix prefills run
        self.prefill_chunks = 0  # chunked-admission extends run
        self.chunk_spans: List[tuple] = []  # (t_dispatch, t_harvested, n_tok)
        self._harvested_last = 0
        state = [self._budget_dev, self._last_tok, self._active, self._temp, self._topk,
                 self._seed, self._genidx]
        if self.spec_window >= 2:
            state += [self._hist, self._hist_len]
        for x in state:
            x.zero_()
        self._topp.fill_(1.0)
        self.on_tokens = on_tokens
        self.on_tokens_errors: List[Exception] = []

    # -- device work ----------------------------------------------------------

    def _lm(self):
        return self.cfg.lm, self.params["lm"]

    def _new_cache(self, batch: int, capacity: int) -> Dict:
        """A zeroed cache on the engine's device (this rank's KV heads under
        a mesh)."""
        return lm_mod.init_kv_cache(self.cfg.lm, batch, capacity, self.cfg.dtype,
                                    device=self.device, quant=self.kv_quant, mesh=self.mesh)

    def _prefill_one(self, embeds, attn_mask, L: int):
        lm_cfg, lm_p = self._lm()
        with span("engine.prefill_one", device=True, rows=L):
            logits, cache1 = lm_mod.prefill(lm_cfg, lm_p, embeds, attn_mask, self._new_cache(1, L),
                                            attn_impl=self.attn_impl, dtype=self.cfg.dtype,
                                            act_quant=self.act_quant, mesh=self.mesh)
            return torch.argmax(logits, -1).to(torch.int32), logits, cache1

    def _prefill_prefix(self, embeds, attn_mask):
        """Prefill a shared prefix into a batch-1 cache at the engine's full
        capacity, so that suffixes can extend it."""
        lm_cfg, lm_p = self._lm()
        with span("engine.prefill_prefix", device=True, rows=embeds.shape[1]):
            return lm_mod.prefill(lm_cfg, lm_p, embeds, attn_mask,
                                  self._new_cache(1, self.capacity), attn_impl=self.attn_impl,
                                  dtype=self.cfg.dtype, act_quant=self.act_quant,
                                  mesh=self.mesh)[1]

    def _extend_one(self, suffix_embeds, n_valid: int, cache1: Dict):
        """Extend cache1 (owned by the caller; written in place) by a suffix;
        returns (first token, logits, cache1)."""
        lm_cfg, lm_p = self._lm()
        nv = torch.full((1,), n_valid, dtype=torch.int32, device=self.device)
        logits, cache1 = lm_mod.extend_prefill(lm_cfg, lm_p, suffix_embeds, nv, cache1,
                                               attn_impl=self.attn_impl, dtype=self.cfg.dtype,
                                               mesh=self.mesh)
        return torch.argmax(logits, -1).to(torch.int32), logits, cache1

    def _step(self, tok, active):
        lm_cfg, lm_p = self._lm()
        embeds = lm_mod.embed_tokens(lm_cfg, lm_p, tok[:, None], self.cfg.dtype, self.mesh)
        logits, self.cache = lm_mod.decode_step(lm_cfg, lm_p, embeds, self.cache,
                                                attn_impl=self.attn_impl, dtype=self.cfg.dtype,
                                                active=active, mesh=self.mesh)
        return logits

    def _decode_chunk(self, sampled: bool) -> torch.Tensor:
        """chunk_tokens lockstep steps over all slots, greedy or sampled
        (greedy rows of a sampled chunk take the same argmax).  Returns the
        tokens [slots, chunk] on the device (the engine's buffer, which the
        next chunk overwrites).  With graphs: the variant's first chunk runs
        eagerly and is captured, every later one is a replay."""
        if self._graphs is None:
            self._chunk_steps(sampled)
        elif sampled in self._graphs:
            self._graphs[sampled].replay()
            self.graph_replays += 1
        else:
            self._capture(sampled)
        return self._chunk_out

    def _capture(self, sampled: bool):
        """Run one chunk eagerly on a side stream (its warm-up, and this
        chunk's work), then capture the chunk as a CUDA graph on that stream
        (torch.cuda.graphs' order); the capture runs nothing.  The capture
        calls capture_begin/end itself: torch.cuda.graph's context would
        also synchronize, collect garbage and empty the allocator's cache,
        which only frees memory."""
        cur, side = torch.cuda.current_stream(self.device), torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self._chunk_steps(sampled)
            g.capture_begin(capture_error_mode="thread_local")
            try:
                self._chunk_steps(sampled)
            finally:
                g.capture_end()
        cur.wait_stream(side)
        self._graphs[sampled] = g
        self.graph_captures += 1

    def _chunk_steps(self, sampled: bool):
        """The chunk's steps, every write in place into the engine's
        buffers: the cache, the per-slot tensors and the token buffer."""
        pad = self.cfg.lm.pad_token_id
        tok, active, budget, out = self._last_tok, self._active, self._budget_dev, self._chunk_out
        for i in range(self.chunk_tokens):
            logits = self._step(tok, active)
            stepped = active.to(torch.int32)
            if sampled:
                nxt = sample_rows(logits, self._temp, self._topk, self._topp, self._seed,
                                  self._genidx)
                self._genidx.add_(stepped)
            else:
                nxt = torch.argmax(logits, -1).to(torch.int32)
            nxt = torch.where(active, nxt, pad)
            budget.sub_(stepped)
            hit_eos = (nxt[:, None] == self._eos[None]).any(-1)
            active.logical_and_(~hit_eos & (budget > 0))
            tok.copy_(torch.where(active | hit_eos, nxt, tok))
            out[:, i] = nxt

    def _decode_chunk_spec(self, sampled: bool):
        """chunk_tokens speculative steps: one K-token verify forward over
        all slots with per-slot prompt-lookup drafts and accept counts,
        greedy or by rejection sampling (speculative.accept_and_emit_sampled;
        greedy rows keep the greedy rule).  Returns (emitted [chunk, slots,
        K], counts [chunk, slots]) on the device."""
        from .speculative import accept_and_emit, accept_and_emit_sampled, propose_ngram

        lm_cfg, lm_p = self._lm()
        K = self.spec_window
        srange = torch.arange(self.num_slots, device=self.device)
        tok, active, budget = self._last_tok, self._active, self._budget_dev
        hist, hist_len = self._hist, self._hist_len
        es, ms = [], []
        for _ in range(self.chunk_tokens):
            draft, _ = propose_ngram(hist, hist_len, self.spec_ngram, K - 1)
            tokens = torch.cat([tok[:, None], draft], dim=1)
            embeds = lm_mod.embed_tokens(lm_cfg, lm_p, tokens, self.cfg.dtype, self.mesh)
            logits, self.cache = lm_mod.verify_step(lm_cfg, lm_p, embeds, self.cache,
                                                    attn_impl=self.attn_impl,
                                                    dtype=self.cfg.dtype, mesh=self.mesh)
            if sampled:
                e, m, eos_emitted = accept_and_emit_sampled(
                    logits, draft, self._eos, budget, ~active, self._temp, self._topk,
                    self._topp, self._seed, self._genidx)
                self._genidx = self._genidx + m
            else:
                e = torch.argmax(logits, dim=-1).to(torch.int32)
                m, eos_emitted = accept_and_emit(e, draft, self._eos, budget, ~active)
            for j in range(K):
                hpos = (hist_len + j).clamp_max(self._hist_cap - 1).long()
                hist[srange, hpos] = torch.where(j < m, e[:, j], hist[srange, hpos])
            hist_len = hist_len + m
            self.cache = lm_mod.commit_verified(self.cache, m)
            new_last = torch.take_along_dim(e, (m - 1).clamp_min(0)[:, None].long(), dim=1)[:, 0]
            tok = torch.where(m > 0, new_last, tok)
            budget = budget - m
            active = active & ~eos_emitted & (budget > 0)
            es.append(e)
            ms.append(m)
        self._last_tok, self._active, self._budget_dev = tok, active, budget
        self._hist, self._hist_len = hist, hist_len
        return torch.stack(es), torch.stack(ms)

    def _read(self, *tensors: torch.Tensor) -> List[np.ndarray]:
        """One device-to-host read of several small integer tensors."""
        flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors]).cpu().numpy()
        out, i = [], 0
        for t in tensors:
            n = t.numel()
            out.append(flat[i:i + n].reshape(tuple(t.shape)))
            i += n
        return out

    def _harvest_state(self, *outputs: torch.Tensor) -> List[np.ndarray]:
        """Read a chunk's outputs with the active mask, budgets and cache
        lengths, refreshing the host mirrors."""
        *outs, act, bud, lens = self._read(*outputs, self._active, self._budget_dev,
                                           self.cache["lengths"])
        self._active_host = act.astype(bool)
        self._budget = bud.astype(np.int32)
        self._lengths = lens
        return outs

    # -- host-side engine -------------------------------------------------------

    def submit(self, req: Request):
        req.submit_t = _time.perf_counter()
        if req.mask_host is None:
            m = req.attn_mask
            m = m.detach().cpu().numpy() if isinstance(m, torch.Tensor) else np.asarray(m)
            req.mask_host = m.reshape(-1).astype(bool)
        self._queue.append(req)

    def cancel(self, uid: Any) -> bool:
        """Cancel the request with this uid: a queued (or pending-prefill)
        request ends at once, an in-flight slot at the next chunk boundary.
        It comes back from run() with cancelled=True and its tokens so far.
        False when no live request has the uid."""
        for req in self._queue:
            if req.uid == uid:
                req.cancelled = True
                return True
        if self._pending is not None and self._pending.req.uid == uid:
            self._pending.req.cancelled = True
            return True
        for req in self._requests:
            if req is not None and req.uid == uid:
                req.cancelled = True
                return True
        return False

    def _emit_tokens(self, req: Request, new: List[int]):
        """on_tokens with its errors collected in on_tokens_errors: a raising
        callback must not strand the chunk's other tokens or leave finished
        requests in their slots."""
        if self.on_tokens is None:
            return
        try:
            self.on_tokens(req, new)
        except Exception as e:
            self.on_tokens_errors.append(e)

    def _expired(self, req: Request) -> bool:
        return req.timeout_s is not None and (_time.perf_counter() - req.submit_t > req.timeout_s)

    def _dead(self, reqs: List[Request]) -> List[bool]:
        """Whether each request is cancelled or past its timeout.  Under a
        mesh of several ranks, when any of them has a timeout, the ranks
        agree: a request is dead where any rank found it so."""
        flags = [r.cancelled or self._expired(r) for r in reqs]
        if (self.mesh is not None and self.mesh.size() > 1
                and any(r.timeout_s is not None for r in reqs)):
            t = torch.tensor(flags, dtype=torch.int32, device=self.device)
            flags = [bool(x) for x in self.mesh.all_reduce(t, None, op="max").tolist()]
        return flags

    def _finalize_dead(self, req: Request):
        req.timed_out = req.timed_out or not req.cancelled  # dead and not cancelled: expired
        req.done = True
        self._finished.append(req)

    def _set_inactive(self, slot: int):
        self._budget[slot] = 0
        self._active_host[slot] = False
        self._active[slot] = False
        self._budget_dev[slot] = 0

    def _sweep_dead(self):
        """Release cancelled and timed-out requests wherever they are; runs
        at every chunk boundary."""
        pending = [] if self._pending is None else [self._pending.req]
        slots = [s for s in range(self.num_slots) if self._requests[s] is not None]
        dead = self._dead(self._queue + pending + [self._requests[s] for s in slots])
        nq = len(self._queue)
        keep = []
        for r, d in zip(self._queue, dead[:nq]):
            if d:
                self._finalize_dead(r)
            else:
                keep.append(r)
        self._queue = keep
        if pending and dead[nq]:
            self._finalize_dead(pending[0])
            self._pending = None  # drop the half-built cache
        for slot, d in zip(slots, dead[nq + len(pending):]):
            if d:
                self._finalize_dead(self._requests[slot])
                self._requests[slot] = None
                self._set_inactive(slot)

    def _free_slot(self) -> Optional[int]:
        for slot in range(self.num_slots):
            if self._requests[slot] is None and not self._active_host[slot]:
                return slot
        return None

    def _start_pending(self, req: Request, key: Any, n: int):
        """Begin a chunked prefill of embeds[:, :n] (all valid tokens) into a
        capacity-length batch-1 cache."""
        self._pending = _PendingPrefill(req=req, key=key, embeds=req.embeds[:, :n], total=n,
                                        cache1=self._new_cache(1, self.capacity))

    def _extend_suffix(self, req: Request, donor: Dict):
        """Admit a shared-prefix request: extend a copy of the donor by the
        request's suffix (the donor stays as it was, for the next request)."""
        p = req.prefix_len
        n_valid = int(req.mask_host.sum()) - p
        with span("engine.extend_suffix", device=True, rows=n_valid):
            return self._extend_one(req.embeds[:, p:].to(self.device), n_valid,
                                    _copy_cache(donor))

    def _mask_on_device(self, req: Request, n: Optional[int] = None) -> torch.Tensor:
        m = req.mask_host if n is None else req.mask_host[:n]
        return torch.from_numpy(m[None].copy()).to(self.device)

    def _admit(self):
        while self._queue and self._pending is None:
            slot = self._free_slot()
            if slot is None:
                return
            req = self._queue.pop(0)
            with span("engine.admit", device=True, request=req.uid) as sp:
                if sp:
                    sp.set(queue_wait_s=_time.perf_counter() - req.submit_t,
                           prefix_rows_reused=0, rows_prefilled=0)
                if not self._admit_one(req, sp):
                    return

    def _admit_one(self, req: Request, sp) -> bool:
        """Prefill one request into a slot, or start its chunked prefill
        (False: admission waits for it).  `sp` is its engine.admit span."""
        L = req.embeds.shape[1]
        if L > self.capacity:
            raise ValueError(f"prompt length {L} exceeds capacity {self.capacity}")
        mask = req.mask_host
        if req.prefix_key is not None and req.prefix_len > 0:
            p = req.prefix_len
            if p >= L:
                raise ValueError(f"prefix_len {p} >= prompt length {L}: a request must "
                                 "contribute at least one suffix token")
            if not bool(mask[:p].all()):
                raise ValueError("shared prefix must be fully valid tokens")
            if int(mask.sum()) - p <= 0:
                raise ValueError(f"prompt valid length <= prefix_len {p}: a request must "
                                 "contribute at least one suffix token")
            reused = p
            if req.prefix_key not in self._prefixes:
                if 0 < self.prefill_chunk < p:
                    self._start_pending(req, req.prefix_key, p)
                    return False
                self._prefixes[req.prefix_key] = self._prefill_prefix(
                    req.embeds[:, :p].to(self.device), self._mask_on_device(req, p))
                self.prefix_prefills += 1
                reused = 0
            first, logits, cache1 = self._extend_suffix(req, self._prefixes[req.prefix_key])
        else:
            n = int(mask.sum())
            # chunked admission feeds the valid head: right-padded masks only
            if 0 < self.prefill_chunk < n and bool(mask[:n].all()):
                self._start_pending(req, None, n)
                return False
            reused = 0
            first, logits, cache1 = self._prefill_one(req.embeds.to(self.device),
                                                      self._mask_on_device(req), L)
        if sp:
            sp.set(prefix_rows_reused=reused, rows_prefilled=int(mask.sum()) - reused)
        self._finish_admission(req, self._first_token(req, first, logits), cache1)
        return True

    def _advance_pending(self):
        """Advance the chunked prefill by one chunk.  The ragged chunk (total
        % C) goes first, so every later window is a full C tokens ending at
        or before `total`: extend_prefill needs lengths + K <= capacity,
        which a padded ragged tail could break near capacity."""
        p = self._pending
        with span("engine.admit", device=True, request=p.req.uid) as sp:
            C = self.prefill_chunk
            k = (p.total % C or C) if p.pos == 0 else C
            seg = p.embeds[:, p.pos:p.pos + k].to(self.device)
            if k < C:
                seg = torch.cat([seg, seg.new_zeros((1, C - k, seg.shape[2]))], dim=1)
            p.first, p.first_logits, p.cache1 = self._extend_one(seg, k, p.cache1)
            p.pos += k
            self.prefill_chunks += 1
            if sp:
                sp.set(prefix_rows_reused=0, rows_prefilled=k)
            if p.pos < p.total:
                return
            self._pending = None
            if p.key is not None:
                self._prefixes[p.key] = p.cache1
                self.prefix_prefills += 1
                if sp:
                    sp.set(rows_prefilled=int(p.req.mask_host.sum()) - p.total + k)
                first, logits, cache1 = self._extend_suffix(p.req, p.cache1)
                self._finish_admission(p.req, self._first_token(p.req, first, logits), cache1)
            else:
                self._finish_admission(p.req, self._first_token(p.req, p.first, p.first_logits),
                                       p.cache1)

    def _first_token(self, req: Request, greedy_tok, logits) -> int:
        """The first generated token from the prefill logits: the argmax, or
        index 0 of the request's counter-mode stream through sample_rows."""
        if req.temperature <= 0.0:
            return int(greedy_tok[0])
        dev = self.device

        def one(v, dt):
            return torch.tensor([v], dtype=dt, device=dev)

        t = sample_rows(logits, one(req.temperature, torch.float32), one(req.top_k, torch.int32),
                        one(req.top_p, torch.float32), one(req.seed, torch.int32),
                        one(0, torch.int32))
        return int(t[0])

    def _finish_admission(self, req: Request, first_i: int, cache1: Dict):
        slot = self._free_slot()
        assert slot is not None  # held free: _admit waits while a prefill is pending
        L = req.embeds.shape[1]
        _insert_cache(self.cache, cache1, slot)
        req.tokens.append(first_i)
        self._emit_tokens(req, [first_i])
        # decode step g writes KV at row L + g, so G more tokens need L + G
        # <= capacity; a speculative window writes K - 1 rows past that
        headroom = max(self.spec_window - 1, 0)
        budget = min(req.max_new_tokens - 1, self.capacity - L - headroom)
        if first_i in self.cfg.lm.eos_token_ids or budget <= 0:
            self._keep_snapshot_cache1(req, cache1)
            req.done = True
            self._finished.append(req)
            return
        self._requests[slot] = req
        self._budget[slot] = budget
        self._active_host[slot] = True
        self._budget_dev[slot] = budget
        self._last_tok[slot] = first_i
        self._active[slot] = True
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._topp[slot] = req.top_p
        self._seed[slot] = req.seed
        self._genidx[slot] = 1  # index 0 was the first token
        if self.spec_window >= 2:
            row = np.zeros((self._hist_cap,), np.int32)
            n = 0
            if req.prompt_ids is not None:
                ids = np.asarray(req.prompt_ids, np.int32).reshape(-1)[: self.capacity]
                n = len(ids)
                row[:n] = ids
            row[n] = first_i
            self._hist[slot] = torch.from_numpy(row).to(self.device)
            self._hist_len[slot] = n + 1

    def _keep_snapshot(self, req: Request, slot: int):
        """Snapshot a finishing keep_prefix request's slot into the prefix
        store before the slot can be reused: the donor of a session's next
        turn."""
        if req.keep_prefix is None:
            return
        self._prefixes[req.keep_prefix] = _extract_cache(self.cache, slot)
        req.kv_len = int(self._lengths[slot])
        self._kept.add(req.keep_prefix)

    def _keep_snapshot_cache1(self, req: Request, cache1: Dict):
        """The same for a request that ended at admission: its batch-1 cache
        padded to capacity."""
        if req.keep_prefix is None:
            return
        self._prefixes[req.keep_prefix] = _pad_cache(cache1, self.capacity)
        req.kv_len = int(req.mask_host.sum())
        self._kept.add(req.keep_prefix)

    def release_prefix(self, key: Any) -> bool:
        """Drop a kept session donor (its memory goes at once)."""
        self._kept.discard(key)
        return self._prefixes.pop(key, None) is not None

    def _finish_slot(self, slot: int, req: Request, new: List[int]):
        req.tokens.extend(new)
        self._harvested_last += len(new)
        if new:
            self._emit_tokens(req, new)
        if not self._active_host[slot]:
            self._keep_snapshot(req, slot)
            req.done = True
            self._finished.append(req)
            self._requests[slot] = None

    def _harvest(self, toks: np.ndarray, budget_before: np.ndarray):
        self._harvested_last = 0
        for slot in range(self.num_slots):
            req = self._requests[slot]
            if req is None:
                continue
            n = int(budget_before[slot] - self._budget[slot])  # active steps taken
            self._finish_slot(slot, req, [int(t) for t in toks[slot][:n]])

    def _harvest_spec(self, es: np.ndarray, ms: np.ndarray):
        """Iteration i of slot s emitted es[i, s, :ms[i, s]]."""
        self._harvested_last = 0
        for slot in range(self.num_slots):
            req = self._requests[slot]
            if req is None:
                continue
            new = [int(t) for i in range(es.shape[0]) for t in es[i, slot, :int(ms[i, slot])]]
            self._finish_slot(slot, req, new)

    def _gc_prefixes(self):
        """Drop donors that no queued or pending request needs (each is a
        capacity-length batch-1 cache); kept session donors stay."""
        if not self._prefixes:
            return
        live = {r.prefix_key for r in self._queue if r.prefix_key is not None}
        if self._pending is not None and self._pending.key is not None:
            live.add(self._pending.key)
        live |= self._kept
        for key in [k for k in self._prefixes if k not in live]:
            del self._prefixes[key]

    def run(self) -> List[Request]:
        """Drain the queue and all slots; returns the requests in finish order."""
        while self._queue or self._pending is not None or any(
                r is not None for r in self._requests):
            self._sweep_dead()
            self._admit()
            self._gc_prefixes()
            if self._pending is not None:
                # one prefill chunk per decode chunk
                self._advance_pending()
            if not self._active_host.any():
                if self._queue or self._pending is not None:
                    # every admitted request ended at admission, or a chunked
                    # prefill is in flight: go on rather than strand the queue
                    continue
                break
            sampled = any(r is not None and r.temperature > 0.0 for r in self._requests)
            spec = self.spec_window >= 2
            budget_before = self._budget.copy()
            t0 = _time.perf_counter()
            graph = self._graphs is not None and sampled in self._graphs
            with span("engine.chunk"):
                with span("engine.dispatch", slots=self.num_slots, tokens=self.chunk_tokens,
                          graph=int(graph)):
                    outs = self._decode_chunk_spec(sampled) if spec else \
                        (self._decode_chunk(sampled),)
                with span("engine.harvest") as sp:
                    read = self._harvest_state(*outs)
                    self.steps += 1
                    if spec:
                        self._harvest_spec(*read)
                    else:
                        self._harvest(read[0], budget_before)
                    if sp:  # active slot-steps: one token a step; an iteration emits >= 1
                        sp.set(slot_steps=int((read[1] > 0).sum()) if spec
                               else self._harvested_last)
            self.chunk_spans.append((t0, _time.perf_counter(), self._harvested_last))
        out, self._finished = self._finished, []
        return out
