"""A run whose timed path is broken underneath comes out not correct.

The harness runs the tiny cell on the CPU without its look for a card,
once sound and once for each fault a serving cell can have: a token
altered where it is produced, a decode step that returns its state
unchanged, half of a request's videos left out.  (The exchange between
chips has no place in a one-chip cell.)"""
import time

import pytest
import torch
from conftest import tiny_copy

from benchmark.harness import run_cell


def _run(tmp_path, model, beam):
    dest = tmp_path / "benchmark"
    man = tiny_copy(dest, model, beam)
    return run_cell(dest, man, "tiny.cell", 2**31 + 17, 0.3, False, "cpu", time.time(),
                    log=lambda *a, **k: None)


def _alter_greedy_tokens(monkeypatch):
    from echr_tpu_torch.models import decoder

    head = decoder.greedy_head

    def altered(out, w, b):
        tok, mx, lse = head(out, w, b)
        tok = tok.clone()
        tok[::5] = tok[::5] % (w.shape[0] - 1) + 1  # another word than the argmax
        return tok, mx, lse
    monkeypatch.setattr(decoder, "greedy_head", altered)


def _alter_beam_tokens(monkeypatch):
    from echr_tpu_torch.models import beam

    step = beam._beam_step

    def altered(finished, scores, tokens, logprobs, t):
        finished, scores, tokens, emit, src = step(finished, scores, tokens, logprobs, t)
        V = logprobs.shape[-1] - 1
        emit = torch.where(emit > 0, emit % V + 1, emit)
        tokens[..., t] = emit
        return finished, scores, tokens, emit, src
    monkeypatch.setattr(beam, "_beam_step", altered)


def _unchanged_state(monkeypatch, model):
    from echr_tpu_torch.models import decoder

    cls, step, layers = decoder.CORE_REGISTRY[model]

    def stuck(core, cfg, xt, ctxs, pre, state, *a, **k):
        out, _ = step(core, cfg, xt, ctxs, pre, state, *a, **k)
        return out, state
    monkeypatch.setitem(decoder.CORE_REGISTRY, model, (cls, stuck, layers))


def _half_the_videos(monkeypatch):
    from echr_tpu_torch.serve import CaptionService

    whole = CaptionService.decode_chunk

    def half(self, chunk, bucket):
        return whole(self, chunk[:max(1, len(chunk) // 2)], bucket)
    monkeypatch.setattr(CaptionService, "decode_chunk", half)


CELLS = [("three_stream", 1), ("h3", 4)]


@pytest.mark.parametrize("model,beam", CELLS)
def test_sound_run_is_correct(tmp_path, model, beam):
    res = _run(tmp_path, model, beam)
    assert res["correct"] and res["failed"] == 0, res["checks"]


@pytest.mark.parametrize("model,beam", CELLS)
@pytest.mark.parametrize("fault", ["token_altered", "state_unchanged", "half_the_videos"])
def test_fault_is_not_correct(tmp_path, monkeypatch, model, beam, fault):
    if fault == "token_altered":
        (_alter_beam_tokens if beam > 1 else _alter_greedy_tokens)(monkeypatch)
    elif fault == "state_unchanged":
        _unchanged_state(monkeypatch, model)
    else:
        _half_the_videos(monkeypatch)
    res = _run(tmp_path, model, beam)
    assert not res["correct"], res["checks"]
