"""Seeded weights in echr_tpu's param-tree layout, drawn on the device.

The tree is the one a format-v2 checkpoint stores (``init_sst`` /
``init_captioner`` of the JAX package): a Linear is {"w": [in, out], "b":
[out]}, an LSTM cell {"w_ih": [in, 4H], "w_hh": [H, 4H], "b_ih", "b_hh"}
with gates i, f, g, o, TSRM's grouped projection "out_w" [g, d, d_o/g].
The uniform bounds are the seeded init's: 1/sqrt(H) for a cell,
1/sqrt(fan_in) for a Linear, 0.1 for the embedding and the logit weight,
a zero logit bias.

Every value comes from one ``torch.rand`` call on the device's generator
and one multiply by the leaves' bounds, so a seed gives the same tree on
every run.  The port receives it as numpy (one copy to the host), as its
checkpoint loader does; the reference takes the device tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.spec import Spec

Leaf = Tuple[Tuple, Tuple[int, ...], float]


def _dense(path, n_in, n_out, bias_bound=None) -> List[Leaf]:
    b = 1.0 / math.sqrt(n_in)
    return [(path + ("w",), (n_in, n_out), b),
            (path + ("b",), (n_out,), b if bias_bound is None else bias_bound)]


def _cell(path, n_in, H) -> List[Leaf]:
    b = 1.0 / math.sqrt(H)
    return [(path + ("w_ih",), (n_in, 4 * H), b), (path + ("w_hh",), (H, 4 * H), b),
            (path + ("b_ih",), (4 * H,), b), (path + ("b_hh",), (4 * H,), b)]


def tap_leaves(s: Spec) -> List[Leaf]:
    leaves = []
    for l in range(s.rnn_num_layers):
        leaves += _cell(("rnn", l), s.video_dim if l == 0 else s.hidden_dim, s.hidden_dim)
    return leaves + _dense(("scores",), s.hidden_dim, s.K)


def captioner_leaves(s: Spec) -> List[Leaf]:
    from benchmark.reference.cores import core_module

    leaves = [(("decoder", "embed"), (s.vocab + 1, s.E), 0.1),
              (("decoder", "logit", "w"), (s.logit_in, s.vocab + 1), 0.1),
              (("decoder", "logit", "b"), (s.vocab + 1,), 0.0)]
    for name, n_in in core_module(s.caption_model).cell_inputs(s):
        leaves += _cell(("decoder", "core", name), n_in, s.H)
    att = ("decoder", "core", "attention")
    leaves += (_dense(att + ("ctx2att",), s.Dc, s.Hatt) + _dense(att + ("h2att",), s.H, s.Hatt)
               + _dense(att + ("alpha_net",), s.Hatt, 1))
    if s.uses_tsrm:
        d, g = s.d_feats, s.n_head
        leaves += (_dense(("fusion", "event_emb"), s.tsrm_in, d)
                   + _dense(("fusion", "query"), d, d) + _dense(("fusion", "key"), d, d)
                   + [(("fusion", "out_w"), (g, d, s.d_o // g), 1.0 / math.sqrt(d)),
                      (("fusion", "out_b"), (s.d_o,), 1.0 / math.sqrt(d))])
        if s.use_posit:
            leaves += (_dense(("fusion", "pair_pos_fc1"), d, d)
                       + _dense(("fusion", "pair_pos_fc2"), d, g))
    return leaves


def _insert(tree: Dict, path: Tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def draw(s: Spec, seed: int, device) -> Tuple[Dict, Dict]:
    """(tap tree, captioner tree) of device f32 tensors for ``seed``."""
    parts = (tap_leaves(s), captioner_leaves(s))
    leaves = parts[0] + parts[1]
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    bounds = torch.repeat_interleave(
        torch.tensor([b for _, _, b in leaves], device=device),
        torch.tensor(sizes, device=device))
    flat = (flat * 2.0 - 1.0) * bounds
    trees, pieces = ({}, {}), iter(torch.split(flat, sizes))
    for tree, part in zip(trees, parts):
        for path, shape, _ in part:
            _insert(tree, path, next(pieces).view(shape))
    return trees


def numpy_trees(trees) -> Tuple[Dict, Dict]:
    """Both trees with numpy leaves, views of one copy to the host: the form
    a checkpoint gives the port."""
    flat_parts = [t for tree in trees for t in _tensors(tree)]
    host = torch.cat([t.reshape(-1) for t in flat_parts]).cpu().numpy()
    out, off = [], 0
    for tree in trees:
        def conv(x):
            nonlocal off
            if isinstance(x, torch.Tensor):
                n = x.numel()
                view = host[off:off + n].reshape(tuple(x.shape))
                off += n
                return view
            if isinstance(x, list):
                return [conv(v) for v in x]
            return {k: conv(v) for k, v in x.items()}
        out.append(conv(tree))
    return tuple(out)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, list):
        for x in tree:
            yield from _tensors(x)
    else:
        for v in tree.values():
            yield from _tensors(v)


