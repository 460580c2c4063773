"""The traffic: one seed gives the same requests, another seed other
features in another order over the same set of lengths."""
import numpy as np
import pytest
import torch
from conftest import BENCH

from benchmark.spec import spec_of
from benchmark.traffic import load


def _spec():
    import json

    return spec_of(json.loads((BENCH / "configs" / "echr_three_stream.json").read_text())["flags"])


@pytest.mark.parametrize("mix", ["greedy128", "beam4"])
def test_same_seed_same_requests_other_seed_same_sizes(mix):
    s = _spec()
    path = BENCH / "traffic" / f"{mix}.json"
    a, b, c = (load(path, s, seed, torch.device("cpu")) for seed in (2**31 + 11, 2**31 + 11, 5))
    for ra, rb in zip(a.requests, b.requests):
        for va, vb in zip(ra, rb):
            assert va.vid == vb.vid and va.duration == vb.duration
            np.testing.assert_array_equal(va.feats, vb.feats)
            np.testing.assert_array_equal(va.lda, vb.lda)
    assert not np.array_equal(a.requests[0][0].feats[:10], c.requests[0][0].feats[:10])
    for ra, rc in zip(a.requests, c.requests):
        assert sorted(len(v.feats) for v in ra) == sorted(len(v.feats) for v in rc)
    assert [len(v.feats) for v in a.requests[0]] != [len(v.feats) for v in c.requests[0]]
    n = a.videos_per_request
    assert len(a.requests[0]) == n and a.request(len(a.requests)) == 0
    lens = sorted(len(v.feats) for v in a.requests[0])
    assert lens[0] == 129 and lens[-1] <= 256 and (n != 128 or lens == list(range(129, 257)))
    v = a.requests[0][0]
    assert v.feats.shape[1] == s.video_dim and v.duration == 2.0 * len(v.feats)
    assert abs(float(v.lda.sum()) - 1.0) < 1e-5 and v.lda.shape == (s.lda_dim,)
