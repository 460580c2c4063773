"""The decoder cores of the reference, one module a ``caption_model``.

A core module defines ``LOGIT_WIDTH`` (the core output's width in units
of CG_rnn_size), ``LAYERS`` (cells in the state), ``cell_inputs(spec)``
(each cell's name in the param tree and its input width, in tree order)
and ``step(ref, rows, xt, state)`` -> (output [R, LOGIT_WIDTH*H], state).
A configuration with another core adds its module here.
"""
from __future__ import annotations

import importlib


def core_module(caption_model: str):
    return importlib.import_module(f"benchmark.reference.cores.{caption_model}")
