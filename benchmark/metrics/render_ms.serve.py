"""render_ms.serve: the serve layer outside decode_chunk (the copies of
the tokens to the host, utils/text.decode_sequence's rendering and the
captions' assembly in CaptionService.caption), in ms a request: a
request's wall time less its decode_chunk spans, the mean over the
requests outside the profiled stretch."""


def read(rec):
    reqs = [r for r in rec["requests"] if not r["profiled"] and r["captions"]]
    if not reqs:
        return None
    dec = {}
    for c in rec["chunks"]:
        dec[c["request"]] = dec.get(c["request"], 0.0) + c["decode_s"]
    return 1e3 * sum(r["end"] - r["start"] - dec.get(r["index"], 0.0) for r in reqs) / len(reqs)
