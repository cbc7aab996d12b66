"""The port's copy of diagnosis/grammar.py against the JAX package's.

The verdict token FSM (table, start, accept, eos, max_len) is equal bit for
bit, and ``parse_verdict`` / ``render_verdict`` agree on the fuzzed
renderings of the JAX package's grammar tests.
"""

import json

import numpy as np
import pytest

from k8s_llm_monitor_tpu.diagnosis import grammar as jgrammar
from k8s_llm_monitor_tpu_torch.diagnosis import grammar as tgrammar


@pytest.mark.parametrize("eos_id", [2, 257])
def test_verdict_fsm_equals_jax(eos_id):
    want = jgrammar.verdict_fsm(eos_id=eos_id)
    got = tgrammar.verdict_fsm(eos_id=eos_id)
    assert got.trans.dtype == want.trans.dtype == np.int32
    assert got.trans.shape == want.trans.shape
    assert np.array_equal(got.trans, want.trans)
    assert np.array_equal(got.accept, want.accept)
    assert (got.start, got.eos_id, got.max_len) == (
        want.start, want.eos_id, want.max_len)
    if eos_id == 2:
        assert got.trans.shape == (484, 259)
        assert (got.start, got.max_len) == (1, 469)


def test_fuzzed_renderings_parse_alike():
    rng = np.random.default_rng(0)
    alphabet = np.array(list(
        "abc XYZ123/.-_:\"\\\n\t{}[]üé" + chr(7)))
    severities = ["info", "warning", "critical", "fatal", ""]
    fsm = tgrammar.verdict_fsm()
    for i in range(200):
        fields = ["".join(rng.choice(alphabet, size=rng.integers(0, 80)))
                  for _ in range(3)]
        args = (severities[i % len(severities)], fields[0], fields[1],
                fields[2], float(rng.normal(0.5, 2.0)))
        text = tgrammar.render_verdict(*args)
        assert text == jgrammar.render_verdict(*args)
        v = tgrammar.parse_verdict(text)
        assert v == jgrammar.parse_verdict(text) == json.loads(text)
        # The rendering threads the token FSM to an accepting state.
        state = fsm.walk([b + 3 for b in text.encode()])
        assert state >= 1 and fsm.accept[state]


def test_rejections_agree():
    for bad in ["", "{}", '{"severity":"fatal"}', "not json",
                '{"severity":"info","component":"x","root_cause":"y",'
                '"recommendation":"z","confidence":0.5,"extra":1}']:
        with pytest.raises(tgrammar.GrammarError):
            tgrammar.parse_verdict(bad)
        with pytest.raises(jgrammar.GrammarError):
            jgrammar.parse_verdict(bad)
