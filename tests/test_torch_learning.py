"""The port learns, on the CPU: tests/test_learning.py's three tests and
tests/test_meteor_learning.py's, on the port's steps.train_step, at
tiny_cfg's sizes with their step counts and thresholds.

Losses fall over 30 cotrain steps; after 100 'tap' steps the SST scores
positive anchors above negatives by a margin that grew by 0.01 or more;
reverse_w0 flips the batcher's w1 weights; with learnable synthetic
captions, 120 'cg' steps raise val METEOR by 0.02, and at 450 steps beam 1
scores greedy's METEOR exactly, beam 4 within 0.03 of it, and beam 4's
sequence logprob on GT proposals is at least beam 1's.  Dropout is on in
every training step, drawn from a seeded torch generator.  train_step
differentiates only the models its phase updates, with the result of
differentiating both.
"""
import copy

import numpy as np
import pytest
import torch

from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from test_train_e2e import tiny_cfg

from echr_tpu_torch import config
from echr_tpu_torch.data.dataset import build_dataset
from echr_tpu_torch.data.loader import Loader
from echr_tpu_torch.engine.evaluate import eval_split
from echr_tpu_torch.engine.steps import (
    apply_grads,
    batch_to_device,
    beam_decode_step,
    encode_step,
    grad_step,
    init_train_state,
    train_step,
    val_loss_step,
)
from echr_tpu_torch.engine.train import _stack_batch
from echr_tpu_torch.models.captioner import ProposalBatch
from echr_tpu_torch.models.registry import init_captioner, init_tap
from echr_tpu_torch.models.sst import sst_forward
from echr_tpu_torch.ops.core import cast_compute_dtype


def _setup(tmp_path, seed, **over):
    """tiny_cfg in the port, its dataset and Loader, and a fresh TrainState
    from the port's seeded init."""
    cfg = config.Config.from_json(tiny_cfg(tmp_path, **over).to_json())
    dataset = build_dataset(cfg)
    loader = Loader(dataset, cfg, process_index=0, process_count=1, seed=0)
    cfg = cfg.replace_in("decoder", CG_vocab_size=dataset.vocab_size,
                         CG_seq_length=dataset.seq_length)
    gen = torch.Generator().manual_seed(seed)
    state = init_train_state(cfg, init_tap(gen, cfg), init_captioner(gen, cfg))
    return cfg, loader, state


def _train(state, loader, cfg, phase, steps, gen, done=0):
    """Train steps on usable train videos until ``steps`` have run in all."""
    while done < steps:
        batch, meta = loader.get_batch("train")
        if meta.proposal_num <= 0 or meta.n_frames <= 1:
            continue
        state, _ = train_step(state, batch_to_device(_stack_batch(batch), "cpu"), gen, cfg,
                              phase)
        done += 1
    return state


def _avg_val_loss(state, loader, cfg, key, n=3):
    dt = cfg.runtime.compute_dtype
    tap, cg = cast_compute_dtype(state.tap, dt), cast_compute_dtype(state.cg, dt)
    vals = []
    loader.reset_iterator("val")
    for _ in range(n):
        batch, meta = loader.get_batch("val")
        if meta.proposal_num <= 0 or meta.n_frames <= 1:
            continue
        m = val_loss_step(tap, cg, batch_to_device(batch, "cpu"), cfg, phase="tap_cg")
        vals.append(float(m[key]))
    return float(np.mean(vals))


def test_losses_decrease(tmp_path):
    cfg, loader, state = _setup(tmp_path, 0, **{"train.lr": 2e-3})
    tap0 = _avg_val_loss(state, loader, cfg, "tap_loss")
    cg0 = _avg_val_loss(state, loader, cfg, "cg_loss")
    state = _train(state, loader, cfg, "tap_cg", 30, torch.Generator().manual_seed(1))
    tap1 = _avg_val_loss(state, loader, cfg, "tap_loss")
    cg1 = _avg_val_loss(state, loader, cfg, "cg_loss")
    assert tap1 < tap0, (tap0, tap1)
    assert cg1 < cg0, (cg0, cg1)


def test_tap_score_separation_improves(tmp_path):
    """After 'tap' training the SST scores positive anchors above negatives
    on held-out videos by a margin that grew."""
    cfg, loader, state = _setup(tmp_path, 1, **{"train.lr": 2e-3,
                                                "data.synthetic_num_videos": 16})

    @torch.no_grad()
    def margin():
        vals = []
        loader.reset_iterator("val")
        for _ in range(4):
            batch, meta = loader.get_batch("val")
            if meta.proposal_num <= 0 or meta.n_frames <= 1:
                continue
            _, scores = sst_forward(state.tap, torch.from_numpy(np.asarray(batch.feats)))
            s = scores.numpy()
            pos = (np.asarray(batch.tap_labels) > 0) & (np.asarray(batch.tap_masks) > 0)
            neg = (np.asarray(batch.tap_labels) == 0) & (np.asarray(batch.tap_masks) > 0)
            vals.append(float(s[pos].mean() - s[neg].mean()))
        return float(np.mean(vals))

    m0 = margin()
    state = _train(state, loader, cfg, "tap", 100, torch.Generator().manual_seed(2))
    m1 = margin()
    assert m1 > m0 + 0.01, (m0, m1)


def test_reverse_w0_flips_weights(tmp_path):
    cfg = config.Config.from_json(tiny_cfg(tmp_path).to_json())
    b1, _ = Loader(build_dataset(cfg), cfg, 0, 1, seed=0).get_batch("train")
    cfg2 = config.Config.from_json(tiny_cfg(tmp_path, **{"train.reverse_w0": True}).to_json())
    b2, _ = Loader(build_dataset(cfg2), cfg2, 0, 1, seed=0).get_batch("train")
    np.testing.assert_allclose(np.asarray(b2.w1), 1.0 - np.asarray(b1.w1), atol=1e-7)


def _meteor(state, loader, cfg, tmp_path, tag, beam_size=1):
    _, scores, _ = eval_split(
        state.tap, state.cg, loader, cfg, str(tmp_path / f"m_{tag}.json"),
        {"num_vids_eval": 4, "val_all_metrics": False, "topN": 10, "get_eval_loss": False,
         "beam_size": beam_size},
        flag_eval_what="cg", device="cpu")
    return float(np.asarray(scores["METEOR"]).mean())


def test_meteor_improves_with_training(tmp_path):
    """Learnable captions: 120 'cg' steps raise val METEOR; at 450, beam 1
    scores greedy's METEOR, beam 4 within 0.03 of it (an imperfect model
    may trade METEOR for logprob), and beam 4's logprob on one val video's
    GT proposals is at least beam 1's."""
    cfg, loader, state = _setup(tmp_path, 0, **{"data.synthetic_learnable": True,
                                                "data.synthetic_num_videos": 16,
                                                "train.lr": 3e-3})
    gen = torch.Generator().manual_seed(1)
    m0 = _meteor(state, loader, cfg, tmp_path, "before")
    state = _train(state, loader, cfg, "cg", 120, gen)
    m1 = _meteor(state, loader, cfg, tmp_path, "after")
    assert m1 > m0 + 0.02, (m0, m1)

    state = _train(state, loader, cfg, "cg", 450, gen, done=120)
    m_greedy = _meteor(state, loader, cfg, tmp_path, "greedy_conv")
    m_beam1 = _meteor(state, loader, cfg, tmp_path, "beam1", beam_size=1)
    m_beam4 = _meteor(state, loader, cfg, tmp_path, "beam4", beam_size=4)
    assert m_beam1 == pytest.approx(m_greedy, abs=1e-9), (m_greedy, m_beam1)
    assert m_beam4 >= m_greedy - 0.03, (m_greedy, m_beam4)

    # the objective beam search raises: the sequence logprob summed to the
    # end token, over one val video's GT proposals
    loader.reset_iterator("val")
    batch, meta = loader.get_batch("val")
    while meta.proposal_num <= 0 or meta.n_frames <= 1:
        batch, meta = loader.get_batch("val")
    n_gt = len(meta.gt_featstamps)
    pi = np.zeros((64,), np.int64)
    ps = np.tile(np.array([[0, 1]], np.int64), (64, 1))
    pm = np.zeros((64,), np.float32)
    pi[:n_gt] = [f[1] for f in meta.gt_featstamps]
    ps[:n_gt] = [[f[0], f[1] + 1] for f in meta.gt_featstamps]
    pm[:n_gt] = 1
    props = ProposalBatch(torch.from_numpy(pi), torch.from_numpy(ps), torch.from_numpy(pm))
    dt = cfg.runtime.compute_dtype
    tap, cg = cast_compute_dtype(state.tap, dt), cast_compute_dtype(state.cg, dt)
    b = batch_to_device(batch, "cpu")
    with torch.no_grad():
        tap_feats, _ = encode_step(tap, b.feats, cfg)
        args = (cg, cfg, tap_feats, b.feats, b.lda, b.frame_mask, props)
        _, blp1 = beam_decode_step(*args, 1, length_alpha=0.0)
        _, blp4 = beam_decode_step(*args, 4, length_alpha=0.0)
    lp1, lp4 = blp1.numpy()[:n_gt], blp4.numpy()[:n_gt]
    assert (lp4 >= lp1 - 1e-4).all(), (lp1, lp4)


@pytest.mark.parametrize("phase", ["tap", "cg", "tap_cg"])
def test_train_step_takes_only_the_updated_models_gradients(tmp_path, phase):
    """train_step differentiates only the models its phase updates (phase
    'cg' runs no SST backward): its parameters and Adam state after a step
    equal those of grad_step over both models then apply_grads, bit for
    bit, and the other model stays as it was."""
    cfg, loader, state = _setup(tmp_path, 0, **{"train.lr": 2e-3})
    twin = init_train_state(cfg, copy.deepcopy(state.tap), copy.deepcopy(state.cg))
    batch, meta = loader.get_batch("train")
    while meta.proposal_num <= 0 or meta.n_frames <= 1:
        batch, meta = loader.get_batch("train")
    b = batch_to_device(_stack_batch(batch), "cpu")
    state, m = train_step(state, b, torch.Generator().manual_seed(3), cfg, phase)
    grads, m2 = grad_step(twin, b, torch.Generator().manual_seed(3), cfg, phase)
    apply_grads(twin, *grads, cfg, phase)
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in m2.items()}
    for name in ("tap", "cg"):
        for (pn, p), q in zip(getattr(state, name).named_parameters(),
                              getattr(twin, name).parameters()):
            assert torch.equal(p, q), (name, pn)
            assert p.requires_grad
    if phase == "cg":
        assert any(g.abs().sum() > 0 for g in grads[0])  # grad_step: the SST's too
