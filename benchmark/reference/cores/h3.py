"""h3, the reference's hierarchical decoder: three stacked LSTM cells,
video -> event -> attended clip.  Cell 0 takes [word | video | the
previous step's top hidden], cell 1 [event | h0], cell 2 [attended clip
| h1], the attention queried by the new h1; the output is h2 (the
reference's H3_Core, among OldModel_NEW.py:404-508)."""
from __future__ import annotations

import torch

LOGIT_WIDTH = 1
LAYERS = 3


def cell_inputs(s):
    return [("layer0", s.E + s.Dv + s.H), ("layer1", s.De + s.H), ("layer2", s.Dc + s.H)]


def step(ref, rows, xt, state):
    h, c = state
    core = ref.cg["decoder"]["core"]
    video = rows.video.expand(len(xt), -1)
    h0, c0 = ref.cell(core["layer0"], torch.cat([xt, video, h[2]], 1), h[0], c[0])
    h1, c1 = ref.cell(core["layer1"], torch.cat([rows.event, h0], 1), h[1], c[1])
    att = ref.attend(h1, rows)
    h2, c2 = ref.cell(core["layer2"], torch.cat([att, h1], 1), h[2], c[2])
    return h2, (torch.stack([h0, h1, h2]), torch.stack([c0, c1, c2]))
