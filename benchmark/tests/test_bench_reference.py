"""The plain reference against echr_tpu_torch at tiny widths on the CPU,
both at f32: the port's plain kernels, the same seeded tree and inputs."""
import json

import numpy as np
import pytest
import torch
from conftest import BENCH, TINY_FLAGS

from benchmark import weights
from benchmark.reference.check import Served, judge, run_as_program, vocab
from benchmark.reference.model import Reference
from benchmark.spec import argv_of, spec_of
from benchmark.traffic.closed_loop import build


def _setup(model, seed=3):
    from echr_tpu_torch.bridge import captioner_from_jax, tap_from_jax
    from echr_tpu_torch.config import parse_config

    flags = json.loads((BENCH / "configs" / "echr_three_stream.json").read_text())["flags"]
    flags = dict(flags, **TINY_FLAGS, caption_model=model, compute_dtype="float32")
    s, cfg = spec_of(flags), parse_config(argv_of(flags))
    trees = weights.numpy_trees(weights.draw(s, seed, "cpu"))
    tap, cg = tap_from_jax(trees[0], cfg), captioner_from_jax(trees[1], cfg)
    ref = Reference(s, *(_tensors(t) for t in trees))
    traffic = build({"videos_per_request": 3, "distinct_requests": 1, "frames": [20, 40],
                     "feature_seconds": 2.0, "beam_size": 1, "topN": 10}, s, seed, "cpu")
    return s, cfg, tap, cg, ref, traffic.requests[0]


def _tensors(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, list):
        return [_tensors(x) for x in tree]
    return {k: _tensors(v) for k, v in tree.items()}


@pytest.mark.parametrize("model", ["three_stream", "h3"])
def test_encode_select_and_contexts(model):
    from echr_tpu_torch.engine.steps import select_topk_batched
    from echr_tpu_torch.models.captioner import ProposalBatch, make_contexts
    from echr_tpu_torch.models.sst import sst_forward_batched

    s, cfg, tap, cg, ref, videos = _setup(model)
    v = videos[0]
    feats = torch.from_numpy(v.feats)
    with torch.no_grad():
        hid, sc = sst_forward_batched(tap, feats[None])
    rh, rs = ref.encode(feats)
    torch.testing.assert_close(rs, sc[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rh, hid[0], atol=1e-5, rtol=1e-5)
    anchors = ref.select(rs, 10)
    idx, cnt, _ = select_topk_batched(sc, torch.tensor([len(feats)]), topN=10, nb=64)
    flat = idx[0, :int(cnt[0])].tolist()
    assert anchors == [(f // s.K, f % s.K) for f in flat]
    ctx = ref.contexts(feats, rh, torch.from_numpy(v.lda), anchors)
    soi = torch.tensor([[t - k, t + 1] for t, k in anchors])[None]
    props = ProposalBatch(torch.tensor([[t for t, _ in anchors]]), soi, torch.ones(1, len(anchors)))
    with torch.no_grad():
        pc = make_contexts(cg, cfg, hid, feats[None], torch.from_numpy(v.lda)[None], props,
                           frame_mask=torch.ones(1, len(feats)))
    torch.testing.assert_close(ctx.event, pc.event[0], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ctx.mask.float(), pc.clip_mask[0])


@pytest.mark.parametrize("model,beam", [("three_stream", 1), ("h3", 1), ("three_stream", 3),
                                        ("h3", 3)])
def test_served_captions_agree_with_the_reference(model, beam):
    from echr_tpu_torch.serve import CaptionRequest, CaptionService

    s, cfg, tap, cg, ref, videos = _setup(model)
    svc = CaptionService(cfg, tap, cg, vocab(s.vocab), device="cpu", batch_videos=3, topN=10,
                         beam_size=beam)
    res = svc.caption([CaptionRequest(v.vid, v.feats, v.duration, v.lda) for v in videos])
    served = [Served(v.feats, v.lda, v.duration, res[v.vid]) for v in videos]
    out = judge(ref, served, 10, beam)
    n = out["numbers"]
    assert n["malformed"] == 0 and out["seen"]["captions"] == 30
    assert n["select_gap"] == 0.0 and n["score_err"] < 1e-5
    assert n["video_logp_err_mean" if beam > 1 else "logp_err"] < 1e-3
    assert n["video_beam_gap_p90" if beam > 1 else "token_gap"] < 1e-4
    # the reference in the program's place serves the same captions
    for v in videos:
        mine = run_as_program(ref, Served(v.feats, v.lda, v.duration, []), 10, beam)
        assert [c.sentence for c in mine] == [c.sentence for c in res[v.vid]]
        assert [c.timestamp for c in mine] == [tuple(c.timestamp) for c in res[v.vid]]
        np.testing.assert_allclose([c.sentence_confidence for c in mine],
                                   [c.sentence_confidence for c in res[v.vid]], atol=1e-3)
