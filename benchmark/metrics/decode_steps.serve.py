"""decode_steps.serve: decode steps a chunk, from the port's counters
(decoder_sample_batched.steps for greedy, beam_search_batched.steps for
beam search), over every chunk of the traced window."""


def read(rec):
    cs = rec["chunks"]
    if not cs:
        return None
    key = "beam_search_batched.steps" if rec["beam_size"] > 1 else "decoder_sample_batched.steps"
    return sum(c["counters"][key] for c in cs) / len(cs)
