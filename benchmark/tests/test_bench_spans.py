"""The readers of the serving path's span counters: ms a chunk from a
synthetic record, None where no chunk lies outside the profiled stretch
or where the program has no such counter, and the counters found on the
port by name."""
import pytest
from conftest import BENCH

from benchmark.harness import _reader

LOOPS = {1: "decoder_sample_batched", 4: "beam_search_batched"}
# one chunk's counters in ns, by beam size: each loop's own, and the other's
# moved too, which the reader of that beam size must leave out
COUNTERS = {"pad_chunk.host_ns": 30_000_000, "encode_step_batched.host_ns": 50_000_000,
            "fetch_selection.wait_ns": 40_000_000, "unpack_selections.host_ns": 20_000_000,
            "make_contexts.host_ns": 10_000_000,
            "decoder_sample_batched.host_ns": 200_000_000,
            "decoder_sample_batched.sync_wait_ns": 150_000_000,
            "beam_search_batched.host_ns": 240_000_000,
            "beam_search_batched.sync_wait_ns": 220_000_000}
# the mean of two unprofiled chunks, the second at twice the first's counters
EXPECT = {("pad_ms.serve", 1): 45.0, ("encode_host_ms.serve", 1): 75.0,
          ("select_wait_ms.serve", 1): 60.0, ("unpack_ms.serve", 1): 30.0,
          ("decode_host_ms.serve", 1): 1.5 * (10 + 200 - 150),
          ("decode_wait_ms.serve", 1): 225.0,
          ("decode_host_ms.serve", 4): 1.5 * (10 + 240 - 220),
          ("decode_wait_ms.serve", 4): 330.0}
KEYS = {"pad_ms.serve": ["pad_chunk.host_ns"],
        "encode_host_ms.serve": ["encode_step_batched.host_ns"],
        "select_wait_ms.serve": ["fetch_selection.wait_ns"],
        "unpack_ms.serve": ["unpack_selections.host_ns"],
        "decode_host_ms.serve": ["make_contexts.host_ns"]
        + [f"{loop}.{c}" for loop in LOOPS.values() for c in ("host_ns", "sync_wait_ns")],
        "decode_wait_ms.serve": [f"{loop}.sync_wait_ns" for loop in LOOPS.values()]}


def _rec(beam_size, profiled=(False, False, True), drop=None):
    chunks = []
    for i, p in enumerate(profiled):
        counters = {k: v * (i + 1) for k, v in COUNTERS.items() if k != drop}
        chunks.append({"request": i, "profiled": p, "counters": counters})
    return {"chunks": chunks, "beam_size": beam_size, "requests": [], "timeline": None}


@pytest.mark.parametrize("name,beam_size", sorted(EXPECT))
def test_reader_gives_ms_a_chunk(name, beam_size):
    assert _reader(BENCH, name)(_rec(beam_size)) == pytest.approx(EXPECT[(name, beam_size)])


@pytest.mark.parametrize("name", sorted(KEYS))
def test_reader_gives_none_without_unprofiled_chunks(name):
    read = _reader(BENCH, name)
    assert read(_rec(1, profiled=(True,))) is None
    assert read(_rec(4, profiled=())) is None


@pytest.mark.parametrize("name,key", [(n, k) for n in sorted(KEYS) for k in KEYS[n]])
def test_reader_gives_none_where_the_program_has_no_counter(name, key):
    """A program without the spans has none of these counters: its record
    reads None, and the reader does not raise."""
    beam = 4 if key.startswith("beam") else 1
    assert _reader(BENCH, name)(_rec(beam, drop=key)) is None


def test_the_span_counters_are_found_on_the_port_by_name():
    import echr_tpu_torch.serve  # noqa: F401
    from benchmark.harness import port_counters

    found = port_counters()
    for key in COUNTERS:
        obj, attr = found[key]
        assert type(getattr(obj, attr)) is int
