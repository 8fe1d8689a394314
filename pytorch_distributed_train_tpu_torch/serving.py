"""Continuous batching: a fixed pool of cache slots advanced by one batched
decode step.

The counterpart of the core of the JAX package's ``serving.py``. Requests
are admitted into free slots as they arrive; every active slot advances
one token per batched step; a slot frees the moment its row emits EOS or
exhausts its budget.

- The KV cache is one static (slots, max_seq_len, Hkv, D) buffer per layer
  with a per-row offset (the model's ``decode_rows`` mode), so slots at
  different positions share one step.
- A prompt prefills at B=1, right-padded to a power-of-two bucket, into a
  fresh zeroed row cache that is then copied into the slot
  (``_insert_row``), which sets the row's offset to the prompt's true
  length (the prefill wrote the padded length). Right padding is causal-
  safe: the last real token never attends to the pad, and the pad's K/V
  stays masked until real tokens overwrite it.
- Free slots keep decoding garbage rows; their outputs are ignored and
  their offsets free-run (writes clamp inside the row) until the next
  admission overwrites the row.

Not ported in this slice, and refused with ``NotImplementedError`` when
asked for: chat sessions (``keep``/``session``), prefix forks and
``preload``, speculative serving (``spec_k``), penalties and
``logit_bias``, the paged batcher and multi-device meshes.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from pytorch_distributed_train_tpu_torch.generate import (
    build_decode_model,
    filter_logits,
    init_cache,
)
from pytorch_distributed_train_tpu_torch.models.llama import KVCache


def trim_at_eos(tokens: list[int], eos_id: int | None) -> list[int]:
    """Cut a generated continuation at its first EOS (exclusive)."""
    if eos_id is not None and eos_id in tokens:
        return tokens[: tokens.index(eos_id)]
    return tokens


def build_serving_model(model_cfg, precision, params: dict | None = None, *,
                        device="cuda", seed: int = 0):
    """The continuous-batching model: per-row cache offsets enabled."""
    return build_decode_model(model_cfg, precision, params, device=device,
                              seed=seed).twin(decode_rows=True)


@torch.no_grad()
def _prefill_step(model, cache: KVCache, ids, true_len):
    """Prefill a right-padded (1, P) prompt; returns the logits (1, V) at
    the last REAL token (position true_len - 1). ``cache`` fills in
    place."""
    logits = model(ids, cache)
    return logits[0, true_len - 1][None]


@torch.no_grad()
def _insert_row(big: KVCache, row: KVCache, r: int, true_len: int) -> None:
    """Copy a freshly prefilled B=1 cache into slot ``r`` in place: the
    FULL row (zeros beyond the prompt erase the previous occupant), and the
    slot's offset set to the prompt's true length."""
    for dst, src in zip(big.k + big.v, row.k + row.v):
        dst[r].copy_(src[0])
    big.index[r] = true_len


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: int | None = None
    seed: int | None = None


@dataclasses.dataclass
class Completion:
    uid: int
    prompt: list[int]
    tokens: list[int]  # generated continuation (includes eos if emitted)
    finish_reason: str  # "eos" | "length"


MIN_BUCKET = 16  # smallest prefill bucket


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet")


class ContinuousBatcher:
    """Slot-based continuous batching over ``slots`` concurrent sequences.

    Usage::

        b = ContinuousBatcher(cfg, precision, params, slots=4)
        b.submit([1, 2, 3], max_new_tokens=32)
        for completion in b.run():
            ...

    ``params`` is the port's weight dict (``interop.params_from_jax``,
    ``models.llama.init_params``) or None to draw weights from ``seed``.
    ``step()`` admits queued requests into free slots (one B=1 bucketed
    prefill each), then advances every slot one token in one batched
    decode step. Greedy at temperature 0, else a categorical draw over
    temperature-scaled, top-k/top-p/min-p filtered logits
    (``generate.filter_logits``). A request with a ``seed`` draws from its
    own generator, seeded by (seed, tokens generated so far), so its output
    does not depend on what else is in flight; others share the batcher's
    generator.
    """

    def __init__(self, model_cfg, precision, params: dict | None = None, *,
                 slots: int = 4, top_k: int = 0, top_p: float = 0.0,
                 min_p: float = 0.0, generator: torch.Generator | None = None,
                 device="cuda", seed: int = 0,
                 mesh=None, auto_prefix_min: int = 0, spec_k: int = 0):
        if mesh is not None:
            raise _unported("multi-device serving (mesh=)")
        if auto_prefix_min:
            raise _unported("the automatic prefix cache (auto_prefix_min)")
        if spec_k:
            raise _unported("speculative serving (spec_k)")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.model = build_serving_model(model_cfg, precision, params,
                                         device=device, seed=seed)
        self.device = self.model.device
        self.slots = slots
        self.top_k, self.top_p, self.min_p = top_k, top_p, min_p
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        self.generator = generator
        self.cache = init_cache(self.model, slots)
        self.max_seq_len = self.model.max_seq_len
        self._build_buckets(self.max_seq_len, MIN_BUCKET)
        self.queue: deque[Request] = deque()
        self._next_uid = 0
        self._req: list[Request | None] = [None] * slots
        self._generated: list[list[int]] = [[] for _ in range(slots)]
        self._pending = np.zeros(slots, np.int64)  # next input token per slot
        self._temp = np.zeros(slots, np.float32)
        self._seed = np.full(slots, -1, np.int64)  # -1 = shared generator
        # host_ms: Python scheduling and bookkeeping of the decode loop;
        # device_ms: the batched step until its tokens reach the host;
        # admit_ms: admission (queue handling + prefill compute).
        self.stats = {"steps": 0, "prefills": 0, "prefill_tokens": 0,
                      "prefill_padded_tokens": 0, "generated_tokens": 0,
                      "host_ms": 0.0, "device_ms": 0.0, "admit_ms": 0.0}

    def _build_buckets(self, cap: int, min_bucket: int) -> None:
        # power-of-two prefill buckets
        self.buckets = []
        b = min_bucket
        while b < cap:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(cap)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds max bucket")

    # ------------------------------------------------------------- intake
    def submit(self, prompt, max_new_tokens: int, *,
               temperature: float = 0.0, eos_id: int | None = None,
               seed: int | None = None, keep: bool = False,
               session: int | None = None, prefix: int | None = None,
               repetition_penalty: float = 1.0,
               presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0,
               logit_bias: dict | None = None) -> int:
        if keep or session is not None or prefix is not None:
            raise _unported("chat sessions and prefix forks")
        if (repetition_penalty != 1.0 or presence_penalty != 0.0
                or frequency_penalty != 0.0 or logit_bias):
            raise _unported("logit penalties and logit_bias")
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if seed is not None and not 0 <= int(seed) < 2**32:
            raise ValueError(f"seed must be in [0, 2**32), got {seed}")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens} "
                "(admission always samples the first continuation token)")
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq_len "
                f"({self.max_seq_len})")
        uid = self._next_uid
        self._next_uid += 1
        self.queue.append(Request(uid, prompt, max_new_tokens, temperature,
                                  eos_id,
                                  seed=None if seed is None else int(seed)))
        return uid

    def preload(self, prompt) -> int:
        raise _unported("preloaded prefix templates")

    # ---------------------------------------------------------- scheduler
    def _prefill_into(self, r: int, prompt: list[int]):
        """Bucket-padded B=1 prefill copied into slot ``r``; returns the
        last-real-token logits (1, V)."""
        P = self._bucket(len(prompt))
        ids = np.zeros((1, P), np.int64)
        ids[0, : len(prompt)] = prompt
        row = init_cache(self.model, 1)
        last = _prefill_step(self.model, row,
                             torch.from_numpy(ids).to(self.device),
                             len(prompt))
        _insert_row(self.cache, row, r, len(prompt))
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += len(prompt)
        self.stats["prefill_padded_tokens"] += P
        return last

    def _admit(self, r: int, req: Request) -> Completion | None:
        """Prefill ``req`` into slot ``r``; returns a Completion iff the
        very first sampled token already finishes the request."""
        return self._start_slot(r, req, self._prefill_into(r, req.prompt))

    def _start_slot(self, r: int, req: Request,
                    last_logits) -> Completion | None:
        """Admission tail: sample the first token from the prefill's
        last logits and activate the slot."""
        self._temp[r] = req.temperature
        self._seed[r] = -1 if req.seed is None else req.seed
        first = int(self._sample_rows(last_logits, [r], ntok=[0])[0])
        self.stats["generated_tokens"] += 1
        self._req[r] = req
        self._generated[r] = [first]
        self._pending[r] = first
        return self._maybe_finish(r, first)

    @torch.no_grad()
    def _sample_rows(self, logits, rows: list[int], ntok: list[int]):
        """One token per row of ``logits`` (len(rows), V) for slots
        ``rows`` (numpy): greedy where the temperature is 0, else a draw
        from the filtered law with the row's generator."""
        tok = torch.argmax(logits, dim=-1)
        temp = self._temp[rows]
        hot = [i for i, t in enumerate(temp) if t > 0.0]
        if hot:
            dev = logits.device
            f = filter_logits(logits[hot],
                              torch.as_tensor(temp[hot], device=dev)[:, None],
                              self.top_k, self.top_p, self.min_p)
            probs = torch.softmax(f, dim=-1)
            for j, i in enumerate(hot):
                seed = int(self._seed[rows[i]])
                g = self.generator
                if seed >= 0:
                    g = torch.Generator(device=dev)
                    g.manual_seed(seed * 1_000_003 + int(ntok[i]))
                tok[i] = torch.multinomial(probs[j], 1, generator=g)[0]
        return tok.cpu().numpy()

    def _maybe_finish(self, r: int, token: int) -> Completion | None:
        req = self._req[r]
        done_eos = req.eos_id is not None and token == req.eos_id
        done_len = len(self._generated[r]) >= req.max_new_tokens
        if not (done_eos or done_len):
            return None
        self._req[r] = None  # slot free; its row is dead until re-admitted
        self._temp[r] = 0.0
        self._seed[r] = -1
        return Completion(req.uid, req.prompt, self._generated[r],
                          "eos" if done_eos else "length")

    @property
    def active_slots(self) -> list[int]:
        return [r for r in range(self.slots) if self._req[r] is not None]

    def _free_slot(self) -> int | None:
        for r in range(self.slots):
            if self._req[r] is None:
                return r
        return None

    @torch.no_grad()
    def _decode(self, ids):
        """One batched decode step over all slots; (slots, V) logits."""
        return self.model(ids, self.cache)[:, -1]

    def step(self) -> list[Completion]:
        """One scheduler quantum: admit queued requests into free slots,
        then one batched decode step advancing every active slot by one
        token."""
        t_admit = time.perf_counter()
        finished: list[Completion] = []
        while self.queue:
            r = self._free_slot()
            if r is None:
                break
            done = self._admit(r, self.queue.popleft())
            if done is not None:
                finished.append(done)
        active = self.active_slots
        self.stats["admit_ms"] += (time.perf_counter() - t_admit) * 1e3
        if not active:
            return finished
        # Free rows feed token 0 and are ignored.
        t_dev = time.perf_counter()
        ids = torch.from_numpy(self._pending[:, None].copy()).to(self.device)
        logits = self._decode(ids)
        rows = list(range(self.slots))
        nxt = self._sample_rows(logits, rows,
                                ntok=[len(g) for g in self._generated])
        t_host = time.perf_counter()
        self.stats["device_ms"] += (t_host - t_dev) * 1e3
        self.stats["steps"] += 1
        for r in active:
            tok = int(nxt[r])
            self._generated[r].append(tok)
            self._pending[r] = tok
            self.stats["generated_tokens"] += 1
            done = self._maybe_finish(r, tok)
            if done is not None:
                finished.append(done)
        self.stats["host_ms"] += (time.perf_counter() - t_host) * 1e3
        return finished

    def run(self):
        """Drive step() until queue and slots drain, yielding Completions
        as they finish."""
        while self.queue or self.active_slots:
            yield from self.step()
