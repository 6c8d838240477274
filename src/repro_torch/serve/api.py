"""Typed sampling parameters: the port's own copy of the part of
``repro.serve.api`` the serving path uses (``SamplingParams`` and
``ApiValidationError``). It depends only on the standard library."""
from __future__ import annotations

import dataclasses
import difflib


class ApiValidationError(ValueError):
    """A request/params value failed validation. The message is written to
    be actionable: it names the offending field, the bad value, and what
    would have been accepted."""


def _check_keys(d: dict, allowed: tuple, what: str) -> None:
    for k in d:
        if k not in allowed:
            hint = difflib.get_close_matches(str(k), allowed, n=1)
            hint = f" — did you mean {hint[0]!r}?" if hint else ""
            raise ApiValidationError(
                f"{what}: unknown key {k!r}{hint} (allowed: "
                f"{', '.join(allowed)})")


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
