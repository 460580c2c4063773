"""Closed-loop clients sending requests of whole videos to the caption
service, as cli/serve.py sends a corpus: a client sends its next request
when the last one has returned.

Parameters (``<mix>.json``; the harness runs one client):
  videos_per_request  videos in a request, the service's batch_videos
  beam_size           1 greedy, else beam search of this width
  topN                proposals captioned a video
  frames              [lo, hi]: a request holds videos_per_request lengths
                      spread evenly over lo..hi C3D frames, in an order
                      drawn from the seed, so every seed has the same sizes
  feature_seconds     seconds a C3D frame (a video lasts frames x this)
  distinct_requests   requests drawn; the loop sends them in turn

Each video's features are N(0, 1) of the configuration's video_dim and
its LDA vector a softmax of lda_dim normals, all drawn on the device from
the seed in one call each and copied to the host once.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

SEED_MIX = 0x9E3779B97F4A7C15  # keeps the traffic's stream apart from the weights'


class Video(NamedTuple):
    vid: str
    feats: np.ndarray  # [frames, video_dim] f32
    lda: np.ndarray  # [lda_dim] f32
    duration: float


class Traffic(NamedTuple):
    requests: List[List[Video]]  # the distinct requests, sent in turn
    videos_per_request: int
    beam_size: int
    topN: int

    def request(self, i: int) -> int:
        """The distinct request the i-th send carries."""
        return i % len(self.requests)


def lengths(n: int, lo: int, hi: int) -> List[int]:
    return [lo + (i * (hi - lo + 1)) // n for i in range(n)]


def build(params, spec, seed: int, device) -> Traffic:
    n = int(params["videos_per_request"])
    P = int(params["distinct_requests"])
    lo, hi = (int(x) for x in params["frames"])
    sec = float(params["feature_seconds"])
    seed = int(seed) % 2**63
    rng = np.random.default_rng(seed)
    order = [rng.permutation(lengths(n, lo, hi)) for _ in range(P)]
    total = sum(int(x.sum()) for x in order)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed ^ SEED_MIX)
    feats = torch.randn(total, spec.video_dim, generator=gen, device=device).cpu().numpy()
    lda = torch.softmax(torch.randn(P * n, spec.lda_dim, generator=gen, device=device),
                        dim=1).cpu().numpy()
    reqs, off = [], 0
    for p, lens in enumerate(order):
        videos = []
        for j, T in enumerate(int(x) for x in lens):
            videos.append(Video(f"r{p}v{j}", feats[off:off + T], lda[p * n + j], T * sec))
            off += T
        reqs.append(videos)
    return Traffic(reqs, n, int(params["beam_size"]), int(params["topN"]))
