"""Iteration-level request scheduler — the host half of continuous
batching, ported from ``tpudist/serve/scheduler.py`` for the serving slice.

Admission control at submit (budget rule and queue bound, rejected
synchronously with a machine-readable reason; a grammar ask compiled here,
so an uncompilable one rejects at once), a priority-ordered FIFO (higher
priority first, arrival order within a class) and deadline enforcement for
queued requests.  Thread contract: ``submit`` from any
number of threads; ``take``/``expire_queued`` from the single engine thread.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import warnings
from typing import Callable, List, Optional

import numpy as np

from tpudist_torch.telemetry.trace import new_trace_id

#: every reason a handle can finish with in this slice (name → contract)
FINISH_REASONS = {
    "length": "completed its max_new output-token budget",
    "eos": "emitted its per-request stop token",
    "deadline": "missed its relative deadline (queued or mid-decode)",
    "shutdown": "cut off by a non-graceful server stop (dead engine loop, "
                "hard drain, never-started server)",
    "cache_full": "hit a full KV cache with budget unspent — only reachable "
                  "when the admission budget rule is bypassed",
    "adapter_missing": "named a per-tenant adapter no longer resident in "
                       "the pool when its lane had to bind — a raced "
                       "unload between admission and placement "
                       "(submit-time misses reject with the same reason "
                       "instead; the engine never silently serves "
                       "base-model output for an adapter request)",
    "stop_sequence": "matched one of its per-request stop sequences on "
                     "the delivered stream (host-side suffix match on "
                     "the packed block fetch, block-boundary straddles "
                     "included; the stop tokens stay in the output)",
    "grammar_violation": "a constrained lane's emitted token broke its "
                         "grammar's host shadow automaton — the stream "
                         "is truncated before the violating token "
                         "(defense in depth: the device-side mask makes "
                         "this unreachable unless the pool tables and "
                         "the host shadow diverge)",
    "preempted": "parked in the host KV tier by a higher-priority "
                 "arrival and cut off (drain, stop) before it could "
                 "resume — an in-flight resume finishes with its normal "
                 "reason instead",
    "shed_load": "shed from the queue by the SLO-aware overload "
                 "controller: the protected priority class's measured "
                 "attainment fell below target, so queued lower-priority "
                 "work was finished with a reason instead of starving it",
    "session_resumed": "completed its max_new budget on a lane resumed "
                       "from the host KV tier without recompute (eos and "
                       "deadline still win when they fire first)",
    "replica_lost": "its fleet replica died mid-serve and the router "
                    "could not re-home it within the retry budget",
    "router_spill": "an inner per-replica attempt the fleet router "
                    "abandoned when it re-homed the request onto a "
                    "sibling — the caller's handle finishes with the "
                    "sibling's reason",
}


class AdmissionError(RuntimeError):
    """A request the scheduler refused; ``reason`` is machine-readable
    (``queue_full``, ``draining``, ``budget_exceeded: ...``,
    ``empty_prompt``, ``max_new_must_be_positive``, ``kv_exhausted: ...``,
    ``adapter_missing`` — the named per-tenant adapter is not loaded —,
    ``invalid_grammar: ...`` — an uncompilable or unsatisfiable grammar, a
    grammar and json_schema double ask, or a grammar without ``eos_id`` —,
    ``constrain_disabled`` — a grammar on a server without the
    structured-output pool —, ``invalid_stop: ...`` — a malformed stop
    sequence —, ``invalid_logprobs`` / ``logprobs_unavailable: ...`` — a
    bad or over-wide top-n ask —, and the overload controller's
    ``shed_load`` and ``fair_share: ...``)."""

    def __init__(self, reason: str):
        super().__init__(f"request rejected: {reason}")
        self.reason = reason


@dataclasses.dataclass
class Request:
    """One generation request in token-id space."""

    prompt: np.ndarray  # [plen] int32
    max_new: int
    temperature: float = 0.0  # 0 = greedy
    deadline_s: Optional[float] = None  # relative to submit; None = none
    seed: int = 0  # per-request sampling stream (temperature > 0)
    eos_id: Optional[int] = None  # stop token: finish "eos" on emission
    on_token: Optional[Callable[[int, int], None]] = None  # (token, index)
    #: prompt prefix hash chain, stamped once at submit (shared-prefix
    #: block reuse keys on it)
    prefix_hashes: tuple = ()
    priority: int = 0  # higher first; FIFO within a class
    #: tenant label: rides into telemetry (``request_finished``), the live
    #: metrics registry (per-tenant latency sketches + SLO attainment) and
    #: ``/statusz`` per-tenant in-flight.  None = untagged (pools under
    #: "default" in per-tenant views).
    tenant: Optional[str] = None
    #: multi-turn session id: on a host-tier server a finished turn's KV
    #: lane parks in host RAM under ``(tenant, session)`` and the next
    #: turn (whose prompt must extend the parked context token for token)
    #: resumes it without recompute.  None = stateless, never parked
    session: Optional[str] = None
    #: per-tenant adapter NAME: the request decodes through this adapter's
    #: rank-r factors from the adapter pool; None = the base model
    adapter: Optional[str] = None
    #: speculative-decoding opt: None = the server's default (speculate
    #: when the server has a draft), False = the plain stream even on a
    #: spec server, True = explicit opt-in
    spec: Optional[bool] = None
    #: compiled grammar (:class:`tpudist_torch.constrain.TokenGrammar`):
    #: the output is masked token by token by its tables (bound into the
    #: engine's pool at placement) and tracked by its host shadow
    #: automaton on delivery; compiled once at submit.  None =
    #: unconstrained
    grammar: Optional[object] = None
    #: stop sequences: a tuple of token-id tuples, suffix-matched on the
    #: delivered stream after every token (straddles across block
    #: boundaries match too); the first match finishes ``stop_sequence``
    #: with the stop tokens kept
    stop: tuple = ()
    #: top-n logprobs per emitted token (0 = off), capped by the server's
    #: engine-wide width
    logprobs: int = 0


class RequestHandle:
    """The caller's view of an in-flight request: streamed tokens, a
    ``done`` event, the finish reason and the latency stamps."""

    def __init__(self, request: Request, req_id: int):
        self.request = request
        self.id = req_id
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self._done = threading.Event()
        self.t_submit = time.monotonic()
        self.t_admitted: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.slot: Optional[int] = None
        #: per-request trace id (tpudist_torch.telemetry.trace), minted at
        #: submit and stamped on ``request_finished`` and the lifeline
        self.trace_id: str = new_trace_id()
        #: the disaggregated path's prefill-done and decode-start stamps,
        #: which the lifeline reads; None on this single-pool server
        self.t_prefill_done: Optional[float] = None
        self.t_decode_start: Optional[float] = None
        #: True once this request was served from a resumed session lane
        #: (its length finish then reads ``session_resumed``)
        self.resumed: bool = False
        #: the host shadow automaton's state over the DELIVERED tokens
        #: (``request.grammar`` only): the server advances it on delivery
        #: and truncates ``grammar_violation`` on divergence
        self.gstate: int = 0
        #: one ``(ids, logprobs)`` pair per delivered token
        #: (``request.logprobs > 0`` only), sliced to the asked width, or
        #: None for a token the prefill sampled (a stream's first)
        self.logprobs: List = []

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request finishes; True iff it did."""
        return self._done.wait(timeout)

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token, queue wait included."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def tpot_s(self) -> Optional[float]:
        """Time per output token after the first; None below two tokens."""
        if (self.t_done is None or self.t_first_token is None
                or len(self.tokens) < 2):
            return None
        return (self.t_done - self.t_first_token) / (len(self.tokens) - 1)

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_admitted is None:
            return None
        return self.t_admitted - self.t_submit

    # -- engine side --------------------------------------------------------

    def _expired(self, now: float) -> bool:
        d = self.request.deadline_s
        return d is not None and (now - self.t_submit) > d

    def _deliver(self, token: int) -> None:
        if self.t_first_token is None:
            self.t_first_token = time.monotonic()
        self.tokens.append(int(token))
        cb = self.request.on_token
        if cb is not None:
            try:
                cb(int(token), len(self.tokens) - 1)
            except Exception as e:  # a user callback must not kill the loop
                warnings.warn(f"on_token callback raised: {e!r}",
                              RuntimeWarning, stacklevel=2)

    def _finish(self, reason: str) -> None:
        if self._done.is_set():
            return
        self.finish_reason = reason
        self.t_done = time.monotonic()
        self._done.set()


class Scheduler:
    """Bounded priority FIFO + admission control (module doc)."""

    def __init__(self, *, queue_limit: int,
                 check_budget: Callable[[int, int], Optional[str]],
                 default_max_new: int = 64,
                 default_deadline_s: Optional[float] = None,
                 prefix_hasher: Optional[Callable] = None,
                 check_adapter: Optional[Callable] = None,
                 compile_grammar_fn: Optional[Callable] = None,
                 max_logprobs: int = 0):
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.queue_limit = queue_limit
        self.check_budget = check_budget
        self.default_max_new = default_max_new
        self.default_deadline_s = default_deadline_s
        self.prefix_hasher = prefix_hasher
        #: adapter-name admission gate (the server passes the engine's
        #: ``has_adapter``): ``name -> Optional[reason]``
        self.check_adapter = check_adapter
        #: grammar compiler (the server passes a closure over the engine's
        #: vocabulary and state cap): ``(regex, json_schema, eos_id) ->
        #: TokenGrammar``, raising ``ValueError`` on anything uncompilable;
        #: run outside the lock.  None = structured output off (grammar
        #: asks reject ``constrain_disabled``)
        self.compile_grammar_fn = compile_grammar_fn
        #: engine-wide top-n logprobs width (0 = off); asks past it reject
        #: ``logprobs_unavailable``
        self.max_logprobs = int(max_logprobs)
        self._q: "collections.deque[RequestHandle]" = collections.deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._refuse_reason: Optional[str] = None
        self._next_id = 0
        self.rejected = 0
        #: optional extra admission gate (the overload controller):
        #: ``Request, pending -> Optional[reason]``, consulted under the
        #: lock after the queue and budget checks — cheap, never blocking
        self.admission_gate: Optional[Callable] = None

    def _reject(self, reason: str) -> None:
        with self._lock:
            self.rejected += 1
        raise AdmissionError(reason)

    def _compile_grammar(self, grammar, json_schema, eos_id):
        """Compile a submit's grammar ask (outside the lock) or reject."""
        if grammar is None and json_schema is None:
            return None
        if self.compile_grammar_fn is None:
            self._reject("constrain_disabled")
        if grammar is not None and json_schema is not None:
            self._reject("invalid_grammar: pass exactly one of "
                         "grammar/json_schema")
        if eos_id is None:
            self._reject("invalid_grammar: a grammar requires eos_id — "
                         "the automaton can only terminate on EOS in an "
                         "accept state")
        try:
            return self.compile_grammar_fn(grammar, json_schema,
                                           int(eos_id))
        except ValueError as e:
            self._reject(f"invalid_grammar: {e}")

    def _norm_stop(self, stop) -> tuple:
        """A submit's ``stop`` ask as a tuple of token-id tuples (a bare
        int is a one-token sequence), or a rejection."""
        if not stop:
            return ()
        seqs = []
        try:
            for s in stop:
                if isinstance(s, (int, np.integer)):
                    seqs.append((int(s),))
                else:
                    t = tuple(int(x) for x in s)
                    if not t:
                        self._reject("invalid_stop: empty stop sequence")
                    seqs.append(t)
        except (TypeError, ValueError):
            self._reject("invalid_stop: stop must be a list of token "
                         "ids or token-id sequences")
        return tuple(seqs)

    def submit(self, prompt, *, max_new: Optional[int] = None,
               temperature: float = 0.0, deadline_s: Optional[float] = None,
               seed: Optional[int] = None, eos_id: Optional[int] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               priority: int = 0, adapter: Optional[str] = None,
               spec: Optional[bool] = None, grammar: Optional[str] = None,
               json_schema=None, stop=None, logprobs: int = 0,
               tenant: Optional[str] = None,
               session: Optional[str] = None) -> RequestHandle:
        """Admit a request or raise :class:`AdmissionError`.  ``deadline_s``
        None inherits the default; ``<= 0`` means no deadline.
        ``adapter`` names the per-tenant LoRA adapter the lane decodes
        through (it must be loaded — else ``adapter_missing``); ``spec``
        is the request's speculative-decoding opt (:class:`Request`).
        ``grammar`` (a regex) or ``json_schema`` constrains the output —
        compiled here, so an uncompilable ask rejects ``invalid_grammar``
        now, and a grammar requires ``eos_id``; ``stop`` is a list of stop
        sequences (token ids, or lists of token ids); ``logprobs`` asks for
        the top-n ``(id, logprob)`` pairs of every token; ``tenant``
        labels the request in telemetry; ``session`` keys the host-tier
        multi-turn resume."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        tg = self._compile_grammar(grammar, json_schema, eos_id)
        stop_seqs = self._norm_stop(stop)
        n_lp = int(logprobs or 0)
        if n_lp < 0:
            self._reject("invalid_logprobs")
        if n_lp > self.max_logprobs:
            self._reject(
                "logprobs_unavailable: asked top-%d, the engine computes "
                "top-%d (TPUDIST_SERVE_LOGPROBS)"
                % (n_lp, self.max_logprobs))
        if deadline_s is None:
            deadline = self.default_deadline_s
        else:
            deadline = float(deadline_s) if deadline_s > 0 else None
        resolved_max_new = (self.default_max_new if max_new is None
                            else int(max_new))
        hashes: tuple = ()
        # hashed outside the lock, and only for a request that stands a
        # chance (racy by design: a miss just means no prefix sharing)
        if (self.prefix_hasher is not None
                and self._refuse_reason is None
                and len(self._q) < self.queue_limit
                and self.check_budget(len(prompt), resolved_max_new) is None):
            hashes = tuple(self.prefix_hasher(prompt))
        req = Request(prompt=prompt, max_new=resolved_max_new,
                      temperature=float(temperature), deadline_s=deadline,
                      seed=0 if seed is None else int(seed),
                      eos_id=None if eos_id is None else int(eos_id),
                      on_token=on_token, prefix_hashes=hashes,
                      priority=int(priority),
                      tenant=None if tenant is None else str(tenant),
                      session=None if session is None else str(session),
                      adapter=None if adapter is None else str(adapter),
                      spec=None if spec is None else bool(spec),
                      grammar=tg, stop=stop_seqs, logprobs=n_lp)
        with self._lock:
            reason = self._refuse_reason
            if reason is None and len(self._q) >= self.queue_limit:
                reason = "queue_full"
            if reason is None:
                reason = self.check_budget(len(prompt), req.max_new)
            if reason is None and req.adapter is not None \
                    and self.check_adapter is not None:
                reason = self.check_adapter(req.adapter)
            if reason is None and self.admission_gate is not None:
                # the overload controller's gate (SLO-aware shedding,
                # per-tenant fair share): cheap gauge reads by contract
                reason = self.admission_gate(req, len(self._q))
            if reason is not None:
                self.rejected += 1
                raise AdmissionError(reason)
            handle = RequestHandle(req, self._next_id)
            self._next_id += 1
            if self._q and self._q[-1].request.priority < req.priority:
                for i, other in enumerate(self._q):
                    if other.request.priority < req.priority:
                        self._q.insert(i, handle)
                        break
            else:
                self._q.append(handle)
            self._work.notify_all()
            return handle

    def take(self, k: int, now: Optional[float] = None,
             admit: Optional[Callable[[RequestHandle], bool]] = None
             ) -> List[RequestHandle]:
        """Pop up to ``k`` admissible requests.  Requests already past
        their deadline finish ``"deadline"`` and are returned (done) without
        using a slot.  ``admit`` is an extra gate (the KV pool budget); its
        first refusal stops the take and leaves that request at the head."""
        if k <= 0:
            return []
        now = time.monotonic() if now is None else now
        out: List[RequestHandle] = []
        alive = 0
        with self._lock:
            while self._q and alive < k:
                h = self._q.popleft()
                if h._expired(now):
                    h._finish("deadline")
                    out.append(h)
                    continue
                if admit is not None and not admit(h):
                    self._q.appendleft(h)
                    break
                alive += 1
                out.append(h)
        return out

    def expire_queued(self, now: Optional[float] = None
                      ) -> List[RequestHandle]:
        """Finish and remove every queued request past its deadline."""
        now = time.monotonic() if now is None else now
        out: List[RequestHandle] = []
        with self._lock:
            keep: "collections.deque[RequestHandle]" = collections.deque()
            while self._q:
                h = self._q.popleft()
                if h._expired(now):
                    h._finish("deadline")
                    out.append(h)
                else:
                    keep.append(h)
            self._q = keep
        return out

    def head_info(self) -> Optional[dict]:
        """A peek at the queue head (no pop): what the server's preemption
        decision needs — its priority and footprint.  None when empty."""
        with self._lock:
            if not self._q:
                return None
            r = self._q[0].request
            return {"priority": r.priority, "prompt_len": len(r.prompt),
                    "max_new": r.max_new,
                    "prefix_hashes": r.prefix_hashes,
                    "session": r.session}

    def shed(self, predicate: Callable[[RequestHandle], bool]
             ) -> List[RequestHandle]:
        """Finish and remove every queued request ``predicate`` marks,
        with reason ``"shed_load"`` (the overload controller's shedding
        half); returns them for the caller's accounting."""
        out: List[RequestHandle] = []
        with self._lock:
            keep: "collections.deque[RequestHandle]" = collections.deque()
            while self._q:
                h = self._q.popleft()
                if predicate(h):
                    h._finish("shed_load")
                    out.append(h)
                else:
                    keep.append(h)
            self._q = keep
        return out

    def pending(self) -> int:
        with self._lock:
            return len(self._q)

    def wait_for_work(self, timeout: float) -> None:
        """Park the engine thread until a submit lands (or timeout)."""
        with self._lock:
            if not self._q:
                self._work.wait(timeout)

    def refuse_new(self, reason: Optional[str]) -> None:
        """Turn admission off (``reason``) or back on (``None``)."""
        with self._lock:
            self._refuse_reason = reason
            self._work.notify_all()
