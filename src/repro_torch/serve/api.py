"""The typed request API: the port's own copy of the part of
``repro.serve.api`` that ``generate`` and the engine use.

``SamplingParams`` (how logits become tokens), ``Request`` (one serving
request), ``StreamEvent`` (one generated token in flight), ``Completion``
(a finished request with its SLO record) and the ``--requests`` file
schema (``parse_request_file``). Values validate eagerly with actionable
messages.

Every type round-trips through plain-dict JSON (``to_json`` /
``from_json``), the router's wire format: the same field names, order and
defaults as the reference's, so either package reads the other's JSON.
``StreamEvent.replica`` and ``Completion.replica`` name the replica that
served a token or finished a request under ``serve/router.py``;
``Completion.n_redispatched`` counts the request's moves off a failed
replica. Not carried over: the reference's deprecation shims for loose
sampling kwargs (the port has no legacy callers). This module depends only
on numpy.
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import Optional

import numpy as np

# canonical class names for CLIs / request files (any int >= 0 is valid)
PRIORITY_CLASSES = {"interactive": 0, "standard": 1, "batch": 2}


class ApiValidationError(ValueError):
    """A request/params value failed validation. The message is written to
    be actionable: it names the offending field, the bad value, and what
    would have been accepted."""


def resolve_priority(p) -> int:
    """'interactive' / 'standard' / 'batch' or any int >= 0."""
    if isinstance(p, str):
        try:
            return PRIORITY_CLASSES[p]
        except KeyError:
            raise ApiValidationError(
                f"unknown priority class {p!r} — one of "
                f"{sorted(PRIORITY_CLASSES)} or an int >= 0") from None
    if isinstance(p, bool) or not isinstance(p, (int, np.integer)):
        raise ApiValidationError(
            f"priority must be a class name {sorted(PRIORITY_CLASSES)} or "
            f"an int >= 0, got {type(p).__name__} {p!r}")
    p = int(p)
    if p < 0:
        raise ApiValidationError(f"priority must be >= 0, got {p}")
    return p


def _check_keys(d: dict, allowed: tuple, what: str) -> None:
    for k in d:
        if k not in allowed:
            hint = difflib.get_close_matches(str(k), allowed, n=1)
            hint = f" — did you mean {hint[0]!r}?" if hint else ""
            raise ApiValidationError(
                f"{what}: unknown key {k!r}{hint} (allowed: "
                f"{', '.join(allowed)})")


def _int_field(d: dict, key: str, what: str, default=None, minimum=None):
    v = d.get(key, default)
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, (int, np.integer)):
        raise ApiValidationError(
            f"{what}: {key!r} must be an int, got {type(v).__name__} {v!r}")
    v = int(v)
    if minimum is not None and v < minimum:
        raise ApiValidationError(f"{what}: {key!r} must be >= {minimum}, "
                                 f"got {v}")
    return v


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How logits become tokens. ``temperature == 0`` is greedy argmax
    (the default, and the only mode with per-token parity guarantees);
    otherwise sample from ``softmax(logits / temperature)`` after optional
    top-k truncation (``top_k > 0``) then nucleus filtering
    (``top_p < 1``)."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    _FIELDS = ("temperature", "top_k", "top_p")

    def __post_init__(self):
        if not (self.temperature >= 0.0):
            raise ApiValidationError(
                f"temperature must be >= 0 (0 = greedy), got "
                f"{self.temperature!r}")
        if int(self.top_k) != self.top_k or self.top_k < 0:
            raise ApiValidationError(
                f"top_k must be an int >= 0 (0 = off), got {self.top_k!r}")
        if not (0.0 < self.top_p <= 1.0):
            raise ApiValidationError(
                f"top_p must be in (0, 1] (1 = off), got {self.top_p!r}")
        object.__setattr__(self, "temperature", float(self.temperature))
        object.__setattr__(self, "top_k", int(self.top_k))
        object.__setattr__(self, "top_p", float(self.top_p))

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    def to_json(self) -> dict:
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p}

    @classmethod
    def from_json(cls, d: dict, what: str = "sampling") -> "SamplingParams":
        if not isinstance(d, dict):
            raise ApiValidationError(
                f"{what}: expected an object like "
                f'{{"temperature": 0.7, "top_k": 40, "top_p": 0.9}}, '
                f"got {type(d).__name__} {d!r}")
        _check_keys(d, cls._FIELDS, what)
        try:
            return cls(**d)
        except ApiValidationError as e:
            raise ApiValidationError(f"{what}: {e}") from None


# ---------------------------------------------------------------------------
# Request
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request — the unit the engine admits and the router
    dispatches. ``prompt`` is stored as a tuple of ints (hashable,
    JSON-clean); ``prompt_ids`` hands back the int32 array the model eats.
    ``sampling=None`` means "the engine's configured sampling" — a request
    carrying explicit sampling must match the engine it lands on (the
    engine's sampler is compiled engine-wide; see ``EngineConfig``).
    ``request_id`` is assigned by the engine/router at submission when
    None."""
    prompt: tuple
    max_new_tokens: int
    eos_id: Optional[int] = None
    priority: int = PRIORITY_CLASSES["standard"]
    sampling: Optional[SamplingParams] = None
    request_id: Optional[int] = None

    _FIELDS = ("prompt", "max_new_tokens", "eos_id", "priority", "sampling",
               "request_id")

    def __post_init__(self):
        prompt = self.prompt
        if isinstance(prompt, np.ndarray):
            prompt = prompt.ravel().tolist()
        try:
            prompt = tuple(int(t) for t in prompt)
        except (TypeError, ValueError):
            raise ApiValidationError(
                f"prompt must be a sequence of token ids, got "
                f"{type(self.prompt).__name__}") from None
        if len(prompt) < 1:
            raise ApiValidationError("prompt must be non-empty (the model "
                                     "needs at least one token to prefill)")
        object.__setattr__(self, "prompt", prompt)
        if int(self.max_new_tokens) != self.max_new_tokens \
                or self.max_new_tokens < 1:
            raise ApiValidationError(
                f"max_new_tokens must be an int >= 1, got "
                f"{self.max_new_tokens!r}")
        object.__setattr__(self, "max_new_tokens", int(self.max_new_tokens))
        object.__setattr__(self, "priority",
                           resolve_priority(self.priority))
        if self.eos_id is not None:
            object.__setattr__(self, "eos_id", int(self.eos_id))
        if self.sampling is not None \
                and not isinstance(self.sampling, SamplingParams):
            object.__setattr__(self, "sampling",
                               SamplingParams.from_json(self.sampling))

    @property
    def prompt_ids(self) -> np.ndarray:
        return np.asarray(self.prompt, np.int32)

    def to_json(self) -> dict:
        d = {"prompt": list(self.prompt),
             "max_new_tokens": self.max_new_tokens}
        if self.eos_id is not None:
            d["eos_id"] = self.eos_id
        if self.priority != PRIORITY_CLASSES["standard"]:
            d["priority"] = self.priority
        if self.sampling is not None:
            d["sampling"] = self.sampling.to_json()
        if self.request_id is not None:
            d["request_id"] = self.request_id
        return d

    @classmethod
    def from_json(cls, d: dict, what: str = "request") -> "Request":
        if not isinstance(d, dict):
            raise ApiValidationError(
                f"{what}: expected an object like "
                f'{{"prompt": [1, 2, 3], "max_new_tokens": 16}}, got '
                f"{type(d).__name__} {d!r}")
        _check_keys(d, cls._FIELDS, what)
        if "prompt" not in d:
            raise ApiValidationError(f"{what}: missing required key "
                                     "'prompt' (a list of token ids)")
        if "max_new_tokens" not in d:
            raise ApiValidationError(f"{what}: missing required key "
                                     "'max_new_tokens' (int >= 1)")
        kw = dict(d)
        if "sampling" in kw and kw["sampling"] is not None:
            kw["sampling"] = SamplingParams.from_json(kw["sampling"],
                                                      f"{what}.sampling")
        try:
            return cls(**kw)
        except ApiValidationError as e:
            raise ApiValidationError(f"{what}: {e}") from None


# ---------------------------------------------------------------------------
# StreamEvent / Completion
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One generated token, as streamed: ``index`` is its 0-based position
    in the generated sequence, ``done`` marks the final token, ``replica``
    names the serving replica under the router (None on a bare engine)."""
    request_id: int
    token: int
    index: int
    done: bool
    replica: Optional[int] = None

    _FIELDS = ("request_id", "token", "index", "done", "replica")

    def to_json(self) -> dict:
        d = {"request_id": self.request_id, "token": self.token,
             "index": self.index, "done": self.done}
        if self.replica is not None:
            d["replica"] = self.replica
        return d

    @classmethod
    def from_json(cls, d: dict, what: str = "stream_event") -> "StreamEvent":
        _check_keys(d, cls._FIELDS, what)
        try:
            return cls(**d)
        except TypeError as e:
            raise ApiValidationError(f"{what}: {e}") from None


@dataclasses.dataclass(frozen=True)
class Completion:
    """A finished request: the generated tokens plus the per-request SLO
    record. Timing stamps are ``time.perf_counter`` values on the serving
    host; ``ttft_s`` / ``latency_s`` are the derived SLO numbers.
    ``n_cached`` counts prompt tokens served by the prefix cache,
    ``n_preempted`` the request's in-engine preemptions and
    ``n_redispatched`` its moves off a failed replica; ``replica`` is the
    replica that produced the final token."""
    request_id: int
    tokens: tuple
    n_prompt: int
    priority: int = PRIORITY_CLASSES["standard"]
    n_cached: int = 0
    n_preempted: int = 0
    n_redispatched: int = 0
    replica: Optional[int] = None
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: float = 0.0

    _FIELDS = ("request_id", "tokens", "n_prompt", "priority", "n_cached",
               "n_preempted", "n_redispatched", "replica", "t_submit",
               "t_first", "t_done")

    def __post_init__(self):
        tokens = self.tokens
        if isinstance(tokens, np.ndarray):
            tokens = tokens.ravel().tolist()
        object.__setattr__(self, "tokens", tuple(int(t) for t in tokens))

    @property
    def n_generated(self) -> int:
        return len(self.tokens)

    @property
    def token_ids(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)

    @property
    def ttft_s(self) -> Optional[float]:
        return (None if self.t_first is None
                else self.t_first - self.t_submit)

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    def to_json(self) -> dict:
        return {f: getattr(self, f) for f in self._FIELDS
                if f != "tokens"} | {"tokens": list(self.tokens)}

    @classmethod
    def from_json(cls, d: dict, what: str = "completion") -> "Completion":
        _check_keys(d, cls._FIELDS, what)
        try:
            return cls(**d)
        except TypeError as e:
            raise ApiValidationError(f"{what}: {e}") from None

    @classmethod
    def from_record(cls, rec: dict, *, request_id: Optional[int] = None,
                    replica: Optional[int] = None) -> "Completion":
        """Build from a scheduler finish record (``Scheduler._finish``)."""
        return cls(request_id=rec["rid"] if request_id is None
                   else request_id,
                   tokens=tuple(int(t) for t in rec["tokens"]),
                   n_prompt=rec["n_prompt"], priority=rec["priority"],
                   n_cached=rec["n_cached"],
                   n_preempted=rec["n_preempted"], replica=replica,
                   t_submit=rec["t_submit"], t_first=rec["t_first"],
                   t_done=rec["t_done"])


# ---------------------------------------------------------------------------
# Request files (launch/serve --requests, benchmark mixes)
# ---------------------------------------------------------------------------

_ENTRY_KEYS = ("prompt", "prompt_len", "gen", "max_new_tokens", "eos_id",
               "priority", "sampling", "request_id")


def normalize_request_entry(entry, index: int, *, default_gen: int,
                            default_priority=PRIORITY_CLASSES["standard"],
                            ) -> dict:
    """Validate one request-file entry and normalize it to canonical keys.

    The file schema is the ``Request`` JSON schema plus two conveniences:
    ``prompt_len`` (serve a seeded random prompt of that length — exactly
    one of ``prompt``/``prompt_len`` must be present) and ``gen`` as the
    historical alias of ``max_new_tokens``. Returns a dict with keys
    ``prompt`` (list | None), ``prompt_len`` (int | None),
    ``max_new_tokens``, ``eos_id``, ``priority`` (resolved int), and
    ``sampling`` (SamplingParams | None). Raises ``ApiValidationError``
    naming ``requests[index]`` on any problem.
    """
    what = f"requests[{index}]"
    if not isinstance(entry, dict):
        raise ApiValidationError(
            f"{what}: each entry must be an object like "
            f'{{"prompt_len": 16, "max_new_tokens": 8}}, got '
            f"{type(entry).__name__} {entry!r}")
    _check_keys(entry, _ENTRY_KEYS, what)
    if "gen" in entry and "max_new_tokens" in entry:
        raise ApiValidationError(
            f"{what}: 'gen' is the legacy alias of 'max_new_tokens' — "
            "pass one, not both")
    gen = _int_field(entry, "max_new_tokens", what, minimum=1)
    if gen is None:
        gen = _int_field(entry, "gen", what, minimum=1)
    if gen is None:
        gen = int(default_gen)
    if ("prompt" in entry) == ("prompt_len" in entry):
        raise ApiValidationError(
            f"{what}: exactly one of 'prompt' (explicit token ids) or "
            "'prompt_len' (seeded random prompt) is required")
    prompt = entry.get("prompt")
    if prompt is not None:
        try:
            prompt = [int(t) for t in prompt]
        except (TypeError, ValueError):
            raise ApiValidationError(
                f"{what}: 'prompt' must be a list of token ids, got "
                f"{prompt!r}") from None
        if not prompt:
            raise ApiValidationError(f"{what}: 'prompt' must be non-empty")
    sampling = entry.get("sampling")
    if sampling is not None:
        sampling = SamplingParams.from_json(sampling, f"{what}.sampling")
    try:
        priority = resolve_priority(entry.get("priority", default_priority))
    except ApiValidationError as e:
        raise ApiValidationError(f"{what}: {e}") from None
    return {"prompt": prompt,
            "prompt_len": _int_field(entry, "prompt_len", what, minimum=1),
            "max_new_tokens": gen,
            "eos_id": _int_field(entry, "eos_id", what, minimum=0),
            "priority": priority,
            "sampling": sampling,
            "request_id": _int_field(entry, "request_id", what, minimum=0)}


def parse_request_file(spec, *, default_gen: int,
                       default_priority=PRIORITY_CLASSES["standard"],
                       ) -> list:
    """Validate a whole ``--requests`` JSON document (a list of entries).
    Returns the normalized entry dicts (see ``normalize_request_entry``);
    the caller materializes ``prompt_len`` entries into seeded prompts."""
    if not isinstance(spec, list):
        raise ApiValidationError(
            "request file must be a JSON list of request objects, got "
            f"{type(spec).__name__}")
    if not spec:
        raise ApiValidationError("request file is empty — nothing to serve")
    return [normalize_request_entry(e, i, default_gen=default_gen,
                                    default_priority=default_priority)
            for i, e in enumerate(spec)]
