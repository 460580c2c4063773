"""three_stream, the ECHR decoder: three parallel LSTM cells over [word |
event], [word | attended clip] and [word | video]; the output is
concat(h0, h1, h2).  The attention is queried by the previous step's h1
(the reference's ThreeStream_Core, OldModel_NEW.py:762-823)."""
from __future__ import annotations

import torch

LOGIT_WIDTH = 3
LAYERS = 3


def cell_inputs(s):
    return [("layer0", s.E + s.De), ("layer1", s.E + s.Dc), ("layer2", s.E + s.Dv)]


def step(ref, rows, xt, state):
    h, c = state
    core = ref.cg["decoder"]["core"]
    h0, c0 = ref.cell(core["layer0"], torch.cat([xt, rows.event], 1), h[0], c[0])
    att = ref.attend(h[1], rows)
    h1, c1 = ref.cell(core["layer1"], torch.cat([xt, att], 1), h[1], c[1])
    h2, c2 = ref.cell(core["layer2"], torch.cat([xt, rows.video.expand(len(xt), -1)], 1),
                      h[2], c[2])
    return torch.cat([h0, h1, h2], 1), (torch.stack([h0, h1, h2]), torch.stack([c0, c1, c2]))
