"""The model FLOPs a served caption needs, whatever computes them: two
a multiply-add of every product of the model, the elementwise work not
counted.  A video needs its SST over its own frames (not its time
bucket's padding), the clip projection over those frames and TSRM over
its served events; a caption needs each decode step up to and including
its END token, or CG_seq_length steps, of each of its beams: the core's
cells, the attention query, the attention over its window's frames and
the logit head.  Beams other than the best one are counted at the best
one's length, since the served output does not show theirs."""
from __future__ import annotations

from typing import Iterable, Tuple

from benchmark.reference.cores import core_module
from benchmark.spec import Spec


def video_flops(s: Spec, n_frames: int, n_events: int) -> float:
    H, N, d = s.hidden_dim, n_events, s.d_feats
    sst = sum(2 * 4 * H * ((s.video_dim if l == 0 else H) + H) for l in range(s.rnn_num_layers))
    f = n_frames * (sst + 2 * H * s.K + 2 * s.Dc * s.Hatt)
    if s.uses_tsrm:
        f += 2 * N * (s.tsrm_in * d + 2 * d * d + d * s.d_o)  # embed, query, key, output
        f += 2 * N * N * (d + d * s.n_head)  # affinities, relation-weighted heads
        if s.use_posit:
            f += 2 * N * N * (d * d + d * s.n_head)  # pair position MLP
    return float(f)


def step_flops(s: Spec, window: int) -> float:
    """One decode step of one row whose window holds ``window`` frames."""
    core = core_module(s.caption_model)
    cells = sum(2 * 4 * s.H * (n_in + s.H) for _, n_in in core.cell_inputs(s))
    head = 2 * core.LOGIT_WIDTH * s.H * (s.vocab + 1)
    return float(cells + head + 2 * s.H * s.Hatt + 2 * window * (s.Hatt + s.Dc))


def request_flops(s: Spec, videos: Iterable[Tuple[int, Iterable[Tuple[int, int]]]],
                  beam_size: int) -> float:
    """videos: (frames, [(window frames, tokens before END), ...]) each."""
    total = 0.0
    for n_frames, caps in videos:
        caps = list(caps)
        total += video_flops(s, n_frames, len(caps))
        for window, length in caps:
            total += beam_size * min(s.seq_length, length + 1) * step_flops(s, window)
    return total
