"""The router's wire format: ``to_json`` / ``from_json`` of the port's
``SamplingParams``, ``Request``, ``StreamEvent`` and ``Completion``
against the JAX package's. Each round-trips, the port's JSON equals the
reference's on the same values, each package reads the other's JSON, and
both reject the same bad input with the same message.

Floats are drawn at width 64 (every draw is then a float the JSON carries
exactly): the reference's own property tests ask hypothesis for
``min_value=0.01`` at width 32, which it refuses before any API code runs.
"""
import json

import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest

from repro.serve import api as japi
from repro_torch.serve import api

TYPES = ("SamplingParams", "Request", "StreamEvent", "Completion")


def _pair(name: str, kw: dict):
    """The same value built in both packages (sampling built in each)."""
    def build(mod):
        k = dict(kw)
        if isinstance(k.get("sampling"), dict):
            k["sampling"] = mod.SamplingParams(**k["sampling"])
        return getattr(mod, name)(**k)
    return build(api), build(japi)


def _check_wire(name: str, kw: dict) -> None:
    t, j = _pair(name, kw)
    td, jd = t.to_json(), j.to_json()
    assert td == jd and list(td) == list(jd)
    text = json.dumps(td)                # what crosses the wire
    tcls, jcls = getattr(api, name), getattr(japi, name)
    assert tcls.from_json(json.loads(text)) == t
    assert tcls.from_json(json.loads(json.dumps(jd))).to_json() == jd
    assert jcls.from_json(json.loads(text)).to_json() == td


sampling_st = st.builds(
    dict, temperature=st.floats(0, 4, allow_nan=False),
    top_k=st.integers(0, 100),
    top_p=st.floats(0.01, 1.0, allow_nan=False))
stamp_st = st.floats(0, 1e6, allow_nan=False)


@hypothesis.settings(max_examples=60, deadline=None)
@hypothesis.given(st.builds(
    dict, prompt=st.lists(st.integers(0, 10_000), min_size=1, max_size=64),
    max_new_tokens=st.integers(1, 1000),
    eos_id=st.none() | st.integers(0, 10_000),
    priority=st.integers(0, 5) | st.sampled_from(
        ["interactive", "standard", "batch"]),
    sampling=st.none() | sampling_st,
    request_id=st.none() | st.integers(0, 10_000)))
def test_request_wire_property(kw):
    _check_wire("Request", kw)


@hypothesis.settings(max_examples=40, deadline=None)
@hypothesis.given(sampling_st)
def test_sampling_wire_property(kw):
    _check_wire("SamplingParams", kw)


@hypothesis.settings(max_examples=40, deadline=None)
@hypothesis.given(st.builds(
    dict, request_id=st.integers(0, 10_000), token=st.integers(0, 50_000),
    index=st.integers(0, 1000), done=st.booleans(),
    replica=st.none() | st.integers(0, 7)))
def test_stream_event_wire_property(kw):
    _check_wire("StreamEvent", kw)


@hypothesis.settings(max_examples=40, deadline=None)
@hypothesis.given(st.builds(
    dict, request_id=st.integers(0, 10_000),
    tokens=st.lists(st.integers(0, 50_000), max_size=32),
    n_prompt=st.integers(1, 4096), priority=st.integers(0, 3),
    n_cached=st.integers(0, 4096), n_preempted=st.integers(0, 5),
    n_redispatched=st.integers(0, 3), replica=st.none() | st.integers(0, 7),
    t_submit=stamp_st, t_first=st.none() | stamp_st, t_done=stamp_st))
def test_completion_wire_property(kw):
    _check_wire("Completion", kw)


def test_completion_derived_fields_and_record():
    rec = {"rid": 3, "tokens": np.array([5, 6, 7]), "n_prompt": 4,
           "priority": 0, "n_cached": 2, "n_preempted": 1, "t_submit": 1.0,
           "t_first": 1.25, "t_done": 2.0}
    for mod in (api, japi):
        c = mod.Completion.from_record(rec, request_id=9, replica=1)
        assert (c.request_id, c.replica, c.n_redispatched) == (9, 1, 0)
        assert (c.ttft_s, c.latency_s, c.n_generated) == (0.25, 1.0, 3)
        assert c.token_ids.dtype == np.int32 and c.tokens == (5, 6, 7)
        assert mod.Completion.from_record(rec).request_id == 3
    assert api.Completion.from_record(rec).to_json() == \
        japi.Completion.from_record(rec).to_json()
    assert api.Completion(request_id=0, tokens=(), n_prompt=1).ttft_s is None


BAD = [
    ("Request", {"prompt": [1], "max_new_tokens": 2, "max_tokens": 3}),
    ("Request", {"prompt": [1], "max_new_tokens": 2, "priorty": 1}),
    ("Request", {"max_new_tokens": 2}),
    ("Request", {"prompt": [1]}),
    ("Request", {"prompt": [], "max_new_tokens": 2}),
    ("Request", {"prompt": "abc", "max_new_tokens": 2}),
    ("Request", {"prompt": [1], "max_new_tokens": 0}),
    ("Request", {"prompt": [1], "max_new_tokens": 2, "priority": "urgent"}),
    ("Request", {"prompt": [1], "max_new_tokens": 2, "priority": 1.5}),
    ("Request", {"prompt": [1], "max_new_tokens": 2, "priority": True}),
    ("Request", {"prompt": [1], "max_new_tokens": 2,
                 "sampling": {"temperature": -1.0}}),
    ("Request", {"prompt": [1], "max_new_tokens": 2,
                 "sampling": {"temprature": 0.5}}),
    ("Request", {"prompt": [1], "max_new_tokens": 2, "sampling": [0.5]}),
    ("Request", [1, 2, 3]),
    ("SamplingParams", {"top_p": 0.0}),
    ("SamplingParams", {"top_k": 1.5}),
    ("SamplingParams", "greedy"),
    ("StreamEvent", {"request_id": 1, "token": 2, "index": 0, "done": True,
                     "replicas": 0}),
    ("StreamEvent", {"request_id": 1, "token": 2}),
    ("Completion", {"request_id": 1, "tokens": [], "n_prompt": 1,
                    "n_redispached": 1}),
    ("Completion", {"request_id": 1, "tokens": []}),
]


@pytest.mark.parametrize("name,d", BAD, ids=lambda x: str(x)[:40])
def test_validation_errors_match(name, d):
    msgs = []
    for mod in (api, japi):
        with pytest.raises(mod.ApiValidationError) as e:
            getattr(mod, name).from_json(d)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_fields_match_reference():
    for name in TYPES:
        assert getattr(api, name)._FIELDS == getattr(japi, name)._FIELDS
