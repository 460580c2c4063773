"""Self-critical sequence training (SCST): the host rewards
(echr_tpu/engine/rl.py).

reward = METEOR(sampled) - METEOR(greedy baseline) per proposal against
its matched GT sentence, scored with the port's pure-Python METEOR
(metrics/scorers.py).  The reference's own SCST imports its scorer from
nowhere and never runs (reference: train.py:243,307).

The policy-gradient update replays the sampled rollout through the decoder
with the rollout's dropout masks (engine/steps.rl_update_step_batched), so
the gathered logprobs equal the rollout's and are differentiable.

This module imports neither torch nor anything that does: the reward
pool's spawned workers import it, and they must stay light and never
touch the GPU.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from echr_tpu_torch.metrics.scorers import Meteor
from echr_tpu_torch.metrics.tokenizer import tokenize_caption
from echr_tpu_torch.utils.text import decode_sequence

_METEOR: Optional[Meteor] = None  # per-process scorer (workers + main)


def _score_rows(rows: List[Tuple[int, str, str, str]], weight: float
                ) -> List[Tuple[int, float]]:
    """Score (index, gen, greedy, ref) sentence triples; pure Python METEOR
    that runs unchanged in the main process or a pool worker."""
    global _METEOR
    if _METEOR is None:
        _METEOR = Meteor()
    out = []
    for i, gen, greedy, ref_s in rows:
        ref = tokenize_caption(ref_s).split()
        s_gen = _METEOR._pair_score(tokenize_caption(gen).split(), ref)
        s_greedy = _METEOR._pair_score(tokenize_caption(greedy).split(), ref)
        out.append((i, weight * (s_gen - s_greedy)))
    return out


class RewardPool:
    """Process pool for the per-row METEOR rewards, the host half of every
    SCST step.  The scorer is pure Python (GIL-bound), so threads cannot
    parallelise it; a spawn-based process pool does.  Scores in-process
    when workers <= 1 or if the pool cannot be made.  Row scores are
    identical either way (tests/test_torch_scst.py)."""

    def __init__(self, workers: Optional[int] = None):
        if workers is None:  # auto: leave a core for the device dispatch
            workers = max((os.cpu_count() or 1) - 1, 0)
        self._pool = None
        self.workers = workers
        if workers > 1:
            try:
                import multiprocessing as mp
                from concurrent.futures import ProcessPoolExecutor

                # spawn, not fork: the parent holds a live CUDA context
                self._pool = ProcessPoolExecutor(
                    max_workers=workers, mp_context=mp.get_context("spawn"))
            except Exception:  # pragma: no cover - platform-specific
                self._pool = None

    def score(self, rows: List[Tuple[int, str, str, str]], weight: float,
              chunks: int = 0) -> List[Tuple[int, float]]:
        if self._pool is None or len(rows) < 4:
            return _score_rows(rows, weight)
        chunks = chunks or min(self.workers * 2, max(len(rows) // 4, 1))
        parts = [rows[i::chunks] for i in range(chunks)]
        futs = [self._pool.submit(_score_rows, p, weight) for p in parts if p]
        out: List[Tuple[int, float]] = []
        for f in futs:
            out.extend(f.result())
        return out

    def shutdown(self, wait: bool = False):
        """Stop the workers; ``wait`` joins them before returning."""
        if self._pool is not None:
            self._pool.shutdown(wait=wait, cancel_futures=True)
            self._pool = None


_DEFAULT_POOL: Optional[RewardPool] = None


def default_reward_pool() -> RewardPool:
    """Lazily-created shared pool (one per process, reused across steps)."""
    global _DEFAULT_POOL
    if _DEFAULT_POOL is None:
        _DEFAULT_POOL = RewardPool()
    return _DEFAULT_POOL


def close_default_reward_pool() -> None:
    """Join the shared pool's workers; the next default_reward_pool() makes
    a new one."""
    global _DEFAULT_POOL
    if _DEFAULT_POOL is not None:
        _DEFAULT_POOL.shutdown(wait=True)
        _DEFAULT_POOL = None


def _reward_rows(
    gen_seq: np.ndarray,
    greedy_seq: np.ndarray,
    gt_sentences: Sequence[str],
    vocab: Dict[str, str],
    prop_mask: np.ndarray,
) -> List[Tuple[int, str, str, str]]:
    gen_sents = decode_sequence(vocab, gen_seq)
    greedy_sents = decode_sequence(vocab, greedy_seq)
    return [
        (i, gen_sents[i], greedy_sents[i], gt_sentences[i])
        for i in range(gen_seq.shape[0])
        if i < len(gt_sentences) and prop_mask[i] > 0
    ]


def self_critical_reward(
    gen_seq: np.ndarray,  # [N, L] sampled tokens
    greedy_seq: np.ndarray,  # [N, L] greedy baseline tokens
    gt_sentences: Sequence[str],  # matched GT sentence per proposal
    vocab: Dict[str, str],
    prop_mask: np.ndarray,  # [N]
    meteor_weight: float = 1.0,
    pool: Optional[RewardPool] = None,
) -> np.ndarray:
    """[N, L] per-token reward (constant over the time axis, like the
    reference's broadcast of the sequence-level advantage)."""
    N, L = gen_seq.shape
    rows = _reward_rows(gen_seq, greedy_seq, gt_sentences, vocab, prop_mask)
    scored = (pool.score(rows, meteor_weight) if pool is not None
              else _score_rows(rows, meteor_weight))
    reward = np.zeros((N,), np.float32)
    for i, r in scored:
        reward[i] = r
    return np.broadcast_to(reward[:, None], (N, L)).copy()


def self_critical_reward_batched(
    gen_rows: Dict[int, np.ndarray],  # {video row: [N, L] sampled tokens}
    greedy_rows: Dict[int, np.ndarray],
    gt_per_video: Dict[int, Sequence[str]],
    vocab: Dict[str, str],
    mask_per_video: Dict[int, np.ndarray],
    n_videos: int,
    meteor_weight: float = 1.0,
    pool: Optional[RewardPool] = None,
) -> np.ndarray:
    """[B, N, L] rewards for a whole SCST batch, scored as one flat row list
    so that all B*N proposal rows spread over the pool."""
    some = next(iter(gen_rows.values()))
    N, L = some.shape
    flat: List[Tuple[int, str, str, str]] = []
    for b in sorted(gen_rows):
        rows = _reward_rows(gen_rows[b], greedy_rows[b], gt_per_video[b],
                            vocab, mask_per_video[b])
        flat.extend((b * N + i, g, gr, ref) for i, g, gr, ref in rows)
    scored = (pool.score(flat, meteor_weight) if pool is not None
              else _score_rows(flat, meteor_weight))
    rewards = np.zeros((n_videos, N), np.float32)
    for j, r in scored:
        rewards[j // N, j % N] = r
    return np.broadcast_to(rewards[:, :, None], (n_videos, N, L)).copy()
