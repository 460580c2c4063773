"""utils/profiling.span and trace_gc, and the spans of the serving path
(serve.CaptionService.caption down to the decode loops): the counters they
feed, the annotations a torch.profiler trace holds, and that the captions
are the same whether a profiler runs or not."""
import contextlib
import gc

import numpy as np
import pytest
import torch
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_torch_ops import small_cfg

from benchmark.arith import timeline
from echr_tpu_torch import serve
from echr_tpu_torch.engine.steps import encode_step_batched
from echr_tpu_torch.models.captioner import make_contexts
from echr_tpu_torch.models.decoder import decoder_sample_batched
from echr_tpu_torch.models.registry import init_captioner, init_tap
from echr_tpu_torch.utils import profiling

# the serving path's spans, by where they nest
GREEDY_SPANS = ("serve.caption", "serve.pad", "sst.encode", "select.topk", "select.fetch",
                "select.unpack", "decode.contexts", "decode.tsrm", "decode.loop",
                "decode.step", "decode.sync", "serve.fetch_tokens", "serve.render")
BEAM_SPANS = ("decode.contexts", "decode.tsrm", "decode.loop", "decode.step", "decode.sync")
NESTED = (("sst.encode", "serve.caption"), ("serve.pad", "serve.caption"),
          ("select.unpack", "serve.caption"), ("serve.render", "serve.caption"),
          ("decode.tsrm", "decode.contexts"), ("decode.step", "decode.loop"),
          ("decode.sync", "decode.loop"), ("decode.sync", "decode.step"))


def _owner():
    def f():
        pass

    f.host_ns = 0
    return f


def _service(beam_size):
    cfg = small_cfg()
    g = torch.Generator().manual_seed(0)
    vocab = {str(i): f"w{i}" for i in range(1, cfg.decoder.CG_vocab_size + 1)}
    return serve.CaptionService(cfg, init_tap(g, cfg), init_captioner(g, cfg), vocab,
                                device="cpu", batch_videos=3, topN=12, beam_size=beam_size)


def _requests(cfg, n=4):
    r = np.random.RandomState(0)
    return [serve.CaptionRequest(f"v{i}", (r.randn(70 + 15 * i, cfg.tap.video_dim) * 0.5)
                                 .astype(np.float32), 30.0 + i,
                                 r.randn(cfg.data.lda_dim).astype(np.float32))
            for i in range(n)]


def _profiled(fn, path):
    """fn() under torch.profiler (the CPU's activity); (its result, the
    trace's annotations as benchmark/arith/timeline reads them)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    return out, timeline.read(str(path))["notes"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Per beam size: the captions served without a profiler, those served
    under one, and the trace's annotations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        with torch.no_grad():
            for k in (1, 2):
                svc = _service(k)
                reqs = _requests(svc.cfg)
                plain = svc.caption(reqs)
                traced, notes = _profiled(lambda: svc.caption(reqs),
                                          tmp_path_factory.mktemp("trace") / "t.json")
                out[k] = (plain, traced, notes)
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("raises", [False, True])
def test_span_adds_elapsed_ns_to_its_owner(raises):
    f = _owner()
    with pytest.raises(KeyError) if raises else contextlib.nullcontext():
        with profiling.span("x", f):
            sum(range(20000))
            if raises:
                raise KeyError("out")
    assert f.host_ns > 0
    before = f.host_ns
    with profiling.span("y", f, "host_ns"):
        pass
    assert f.host_ns > before


def test_span_counts_into_the_named_counter_alone():
    f = _owner()
    f.wait_ns = 0
    with profiling.span("x", f, "wait_ns"):
        sum(range(1000))
    assert f.wait_ns > 0 and f.host_ns == 0


@pytest.mark.parametrize("under", ["a span", "a caption"])
def test_no_record_function_without_a_profiler(monkeypatch, under):
    """Without a profiler the spans never enter record_function; under one
    each span enters it once."""
    entered = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(profiling, "record_function", Counting)
    if under == "a span":
        with profiling.span("x", _owner()):
            pass
    else:
        svc = _service(1)
        with torch.no_grad():
            svc.caption(_requests(svc.cfg, 2))
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("x"):
            pass
    assert entered == ["x"]


@pytest.mark.parametrize("name", GREEDY_SPANS)
def test_greedy_trace_holds_the_span(served, name):
    assert name in {n for n, _, _ in served[1][2]}


@pytest.mark.parametrize("name", BEAM_SPANS)
def test_beam_trace_holds_the_span(served, name):
    assert name in {n for n, _, _ in served[2][2]}


@pytest.mark.parametrize("child,parent", NESTED)
def test_spans_nest_in_their_parent(served, child, parent):
    """Every ``child`` annotation lies inside a ``parent`` one."""
    for k in (1, 2):
        notes = served[k][2]
        outer = [(s, e) for n, s, e in notes if n == parent]
        inner = [(s, e) for n, s, e in notes if n == child]
        assert inner and outer
        for s, e in inner:
            assert any(ps <= s and e <= pe for ps, pe in outer), (k, child, s, e)


@pytest.mark.parametrize("beam_size", [1, 2])
def test_captions_are_the_same_under_a_profiler(served, beam_size):
    """The spans change no output: the captions served under torch.profiler
    equal those served without one, token for token and score for
    score."""
    plain, traced, _ = served[beam_size]
    assert list(plain) == list(traced) and all(plain.values())
    for vid in plain:
        assert plain[vid] == traced[vid]


def test_the_chunk_counters_advance():
    keys = [(serve.pad_chunk, "host_ns"), (serve.fetch_selection, "wait_ns"),
            (serve.unpack_selections, "host_ns"), (encode_step_batched, "host_ns"),
            (make_contexts, "host_ns"), (decoder_sample_batched, "host_ns"),
            (decoder_sample_batched, "sync_wait_ns")]
    before = [getattr(f, a) for f, a in keys]
    svc = _service(1)
    with torch.no_grad():
        svc.caption(_requests(svc.cfg, 2))
    assert all(getattr(f, a) > b for (f, a), b in zip(keys, before))


def test_a_collection_is_annotated_once(tmp_path):
    profiling.trace_gc()
    profiling.trace_gc()
    assert gc.callbacks.count(profiling._gc_annotate) == 1
    _, notes = _profiled(gc.collect, tmp_path / "gc.json")
    assert "gc.gen2" in {n for n, _, _ in notes}
    assert not profiling._gc_open
