"""The batched eval loop (echr_tpu/engine/evaluate.py) on one GPU:
proposal selection -> batched decode -> the predictions JSON -> the
dense-captioning metrics (reference: eval_utils.py:14-227).

``eval_split_batched`` groups a split's videos by time bucket and runs each
group of ``batch_videos`` videos through the SST encode, top-N selection on
the device (or the host NMS), the val losses and greedy or beam decode, per
``flag_eval_what`` ('cg' GT segments | 'cg_extend' sampled good proposals |
'tap' proposals only | 'tap_cg' model proposals).  A caption's re_score is
10 * proposal_score + sentence_confidence; ``reranking`` keeps the top 10.
``sample_max=0`` decodes by multinomial sampling at ``temperature``, each
group's draws from a generator seeded by (``sample_seed``, the group's
dispatch index), so one seed gives one predictions JSON.

Not ported, each raising NotImplementedError: the per-video ``eval_split``
(ROADMAP.md A.9-A.10), external proposals (``flag_eval_what='SOTA_TEP'``,
A.6) and the multi-device sweep (``mesh`` / ``multihost``, A.13).
"""
from __future__ import annotations

import contextlib
import gc as _gc
import json
import logging
import os
import queue as _pyq
import threading
import time as _clk
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from echr_tpu_torch.config import Config
from echr_tpu_torch.data.batcher import VideoBatch
from echr_tpu_torch.data.labels import featstamp_to_time
from echr_tpu_torch.data.loader import Loader
from echr_tpu_torch.engine import proposals as P
from echr_tpu_torch.engine.steps import (
    batch_to_device,
    beam_decode_step_batched,
    decode_step_batched,
    encode_step_batched,
    select_topk_batched,
    unpack_topk_selection,
    val_loss_step_batched,
)
from echr_tpu_torch.metrics.eval_score import eval_score
from echr_tpu_torch.models.captioner import Captioner, ProposalBatch
from echr_tpu_torch.models.sst import SST
from echr_tpu_torch.ops.core import cast_compute_dtype
from echr_tpu_torch.utils.text import decode_sequence
from echr_tpu_torch.utils.watchdog import HangWatchdog

log = logging.getLogger("echr_tpu_torch.eval")

# proposal-count buckets of the decode batch: one decode shape per bucket
PROP_BUCKETS = (64, 128, 256, 512, 1024)
_MODES = ("cg", "cg_extend", "tap", "tap_cg")


def _prop_bucket(n: int) -> int:
    for b in PROP_BUCKETS:
        if n <= b:
            return b
    return PROP_BUCKETS[-1]


def _pad_props(ind, soi, n_bucket: int) -> ProposalBatch:
    """One video's selection padded to ``n_bucket`` rows, as numpy arrays
    (a group is stacked on the host and moved to the device at once)."""
    n = len(ind)
    pi = np.zeros((n_bucket,), np.int32)
    ps = np.tile(np.array([[0, 1]], np.int32), (n_bucket, 1))
    pm = np.zeros((n_bucket,), np.float32)
    if n:  # an empty selection is all padding (np.asarray([]) is 1-D)
        pi[:n] = np.asarray(ind)[:n]
        ps[:n] = np.asarray(soi)[:n].reshape(n, 2)
        pm[:n] = 1.0
    return ProposalBatch(pi, ps, pm)


def select_proposals(flag_eval_what, batch, meta, pp, masks, cfg, *, nms_threshold,
                     val_score_thres, topN):
    """One video's host-side proposal selection (reference:
    eval_utils.py:60-118).  ``pp`` / ``masks`` are its [n_frames, K] score
    grid and anchor mask, read by 'tap' and 'tap_cg' only.  Returns (ind,
    soi, cg_sel, timestamps, tap_prob)."""
    if flag_eval_what == "cg":
        n_gt = len(meta.gt_featstamps)
        ind = [f[1] for f in meta.gt_featstamps]
        soi = [[f[0], f[1] + 1] for f in meta.gt_featstamps]
        return ind, soi, list(range(n_gt)), list(meta.timestamps), [1.0] * n_gt
    if flag_eval_what == "cg_extend":
        pm = np.asarray(batch.prop_mask) > 0
        ind = np.asarray(batch.ind_select)[pm].tolist()
        soi = np.asarray(batch.soi)[pm].tolist()
        cg_sel = list(meta.cg_select[: pm.sum()])
        timestamps = [featstamp_to_time(s, e, meta.n_frames, meta.duration) for s, e in soi]
        return ind, soi, cg_sel, timestamps, [1.0] * len(ind)
    if flag_eval_what == "SOTA_TEP":
        raise NotImplementedError(
            "flag_eval_what='SOTA_TEP' (external proposals) is not ported: ROADMAP.md A.6")
    if flag_eval_what in ("tap", "tap_cg"):
        if nms_threshold:
            return P.top_proposals_nms(pp, masks, meta.gts_index, meta.duration,
                                       featstamp_to_time, overlap=nms_threshold, topN=topN)
        cg_gts = meta.gts_index * (meta.iou_scores >= cfg.tap.iou_threshold_for_good_proposal)
        return P.top_proposals(pp, masks, cg_gts, meta.duration, featstamp_to_time,
                               val_score_thres=val_score_thres, topN=topN)
    raise ValueError(f"flag_eval_what {flag_eval_what!r} not supported")


def device_selection_row(flag_eval_what, idx_row, cnt, conf_row, nb_sel, batch, meta, cfg, *,
                         nms_threshold, val_score_thres, topN, grid_fetch):
    """One video's selection from a select_topk_batched fetch: trusted when
    its count fits the nb_sel slots; for 'tap', whose host selection is
    unbounded, a count past them (a threshold-tie storm) falls back to the
    host path over the video's score grid, ``grid_fetch()`` (a host array;
    rows past n_frames are cut here).  The batched loop computes its val
    losses on the device, so cg_sel is not derived: it comes back empty
    unless the host path ran.

    Returns ((ind, soi, cg_sel, timestamps, tap_prob), fell_back)."""
    if flag_eval_what == "tap" and int(cnt) > nb_sel:
        pp = np.asarray(grid_fetch())[: meta.n_frames]
        masks = np.asarray(batch.tap_masks)[: meta.n_frames]
        return select_proposals(flag_eval_what, batch, meta, pp, masks, cfg,
                                nms_threshold=nms_threshold, val_score_thres=val_score_thres,
                                topN=topN), True
    ind, soi, ts, tp = unpack_topk_selection(idx_row, cnt, nb_sel, cfg.tap.K, meta.n_frames,
                                             meta.duration, conf_row)
    return (ind, soi, [], ts, tp), False


def eval_split(*args, **kwargs):
    """The per-video eval loop (echr_tpu/engine/evaluate.py:174) is not
    ported: it needs the per-video decode.  eval_split_batched gives the
    same predictions."""
    raise NotImplementedError(
        "eval_split (per-video decode) is not ported: ROADMAP.md A.9-A.10; "
        "use eval_split_batched")


def _group_seed(sample_seed: int, dispatch: int) -> int:
    """The seed of a multinomial decode's draws: one stream per group, by
    its dispatch index (echr_tpu's fold_in(PRNGKey(sample_seed), k))."""
    return int(np.random.SeedSequence([sample_seed, dispatch]).generate_state(1, np.uint64)[0])


def _fetch(*tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """Host copies of ``tensors`` with one synchronisation: the copies are
    queued on the current stream, then one event is waited on."""
    if all(t.device.type == "cpu" for t in tensors):
        return tuple(t.numpy() for t in tensors)
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return tuple(h.numpy() for h in host)


def eval_split_batched(
    tap: SST,
    cg: Captioner,
    loader: Loader,
    cfg: Config,
    json_path: str,
    eval_kwargs: Optional[Dict] = None,
    flag_eval_what: str = "tap_cg",
    batch_videos: int = 8,
    device="cuda",
    mesh=None,
    multihost: bool = False,
) -> Tuple[Dict, Dict, np.ndarray]:
    """Evaluate a split: returns (predictions, score dict, mean val losses
    [5]) as echr_tpu's eval_split_batched does, and writes the predictions
    JSON to ``json_path``.

    The models move to ``device`` and are cast to the compute dtype once,
    here.  Every group is padded to ``batch_videos`` rows by replaying its
    last video, so each time bucket has one shape.  The pipeline: group
    k+1's encode and selection are queued on the device before group k's
    selection fetch blocks, and an assembler thread fetches the decode
    outputs and renders the captions (``async_assemble``) on the caller's
    device and stream.  Every product runs on the caller's thread, so the
    process-wide TF32 switch of ``ops.core.matmul`` never reaches another
    thread's f32 products.  An exception mid-pass restores the loader's
    labels and feature dtype, joins the assembler and re-enables GC.

    ``eval_kwargs`` takes echr_tpu's keys (split, language_eval,
    val_score_thres, nms_threshold, reranking, topN, num_vids_eval,
    get_eval_loss, val_all_metrics, sample_max, temperature, sample_seed,
    beam_size, beam_length_alpha, eval_inflight, device_select,
    async_assemble, gc_pause, references); a ``timing_out`` dict receives
    the wall-time breakdown."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"eval_split_batched(device={device!r}): CUDA is not available")
    if mesh is not None or multihost:
        raise NotImplementedError("the multi-device eval sweep is not ported: ROADMAP.md A.13")
    if flag_eval_what == "SOTA_TEP":
        raise NotImplementedError(
            "flag_eval_what='SOTA_TEP' (external proposals) is not ported: ROADMAP.md A.6")
    if flag_eval_what not in _MODES:
        raise ValueError(f"flag_eval_what {flag_eval_what!r} not supported")
    kw = dict(eval_kwargs or {})
    split = kw.get("split", "val")
    lang_eval = kw.get("language_eval", cfg.eval.language_eval)
    val_score_thres = kw.get("val_score_thres", cfg.eval.val_score_thres)
    nms_threshold = kw.get("nms_threshold", cfg.eval.nms_threshold)
    is_reranking = kw.get("reranking", cfg.eval.reranking)
    topN = kw.get("topN", cfg.eval.topN)
    num_vids_eval = kw.get("num_vids_eval", cfg.eval.num_vids_eval) or loader.split_size(split)
    val_all_metrics = kw.get("val_all_metrics", cfg.eval.val_all_metrics)
    get_eval_loss = kw.get("get_eval_loss", True)
    greedy = bool(int(kw.get("sample_max", cfg.eval.sample_max)))
    temperature = float(kw.get("temperature", cfg.eval.temperature))
    sample_seed = int(kw.get("sample_seed", 0))
    dispatch_count = [0]
    beam_size = int(kw.get("beam_size", cfg.eval.beam_size) or 1)
    length_alpha = float(kw.get("beam_length_alpha", cfg.eval.beam_length_alpha))
    inflight = max(int(kw.get("eval_inflight", cfg.eval.eval_inflight)), 1)
    device_select = bool(kw.get("device_select", cfg.eval.device_select))
    bf16_transfer = cfg.runtime.transfer_dtype == "bfloat16"

    dt = cfg.runtime.compute_dtype
    tap = cast_compute_dtype(tap.to(dev), dt)
    cg = cast_compute_dtype(cg.to(dev), dt)
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    def on_device():
        """The caller's device and stream, for the assembler thread's fetches."""
        if stream is None:
            return contextlib.nullcontext()
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.cuda.device(dev))
        ctx.enter_context(torch.cuda.stream(stream))
        return ctx

    def to_dev(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(dev, non_blocking=True)

    # decode-only fast path: no training-label synthesis in the batcher;
    # cg / cg_extend need the label fields, and so do the val losses
    decode_only = (not get_eval_loss) and flag_eval_what in ("tap", "tap_cg")
    labels_before = loader.labels_for(split)
    feats_dtype_before = loader.feats_dtype_for(split)
    vocab = loader.dataset.ix_to_word
    predictions: Dict[str, List[dict]] = {}
    loss_sum = np.zeros(5)
    it_vids = 0  # usable videos iterated: the val losses' denominator (eval_utils.py:227)

    groups: Dict[int, List] = {}
    encoded = []  # stage A done: encode / select queued, fetch pending
    pending = []  # stage B done: decode queued, fetch pending
    tm = {"loader": 0.0, "host_prep": 0.0, "prep_stack": 0.0,
          "prep_put": 0.0, "prep_encode": 0.0, "select_fetch": 0.0,
          "host_select": 0.0, "loss_fetch": 0.0, "decode_dispatch": 0.0,
          "decode_fetch": 0.0, "assemble": 0.0, "groups": 0,
          "grid_fallbacks": 0}

    def stage_a(items: List):
        """Encode, device top-N and val-loss launches for one group, with no
        blocking fetch: those wait in stage_b, by when the next group's
        work is queued behind this one."""
        if not items:
            return None
        t0 = _clk.time()
        B = len(items)
        items_p = items + [items[-1]] * (batch_videos - B)
        t_s = _clk.time()
        # the prefetch workers' feats are bf16 tensors on the decode-only
        # path; items in flight before set_feats_dtype are f32 arrays
        fdt = torch.bfloat16 if bf16_transfer else torch.float32
        feats_h = torch.stack([torch.as_tensor(b.feats).to(fdt) for b, _ in items_p])
        tm["prep_stack"] += _clk.time() - t_s
        t_s = _clk.time()
        # bf16 halves the host->device payload; the upcast is on the device
        feats_b = feats_h.to(dev, non_blocking=True).float()
        tm["prep_put"] += _clk.time() - t_s
        t_s = _clk.time()
        tap_feats_b, pred_props_b = encode_step_batched(tap, feats_b, cfg)
        tm["prep_encode"] += _clk.time() - t_s
        a = {"items": items, "items_p": items_p, "B": B, "feats_b": feats_b,
             "tap_feats_b": tap_feats_b, "pred_props_b": pred_props_b}
        a["device_sel"] = (device_select and not nms_threshold
                           and flag_eval_what in ("tap", "tap_cg"))
        if a["device_sel"]:
            # the bucket ceiling, not bucket(topN): threshold ties can pass
            # topN, and the host path truncates at bucket(max_n) <= ceiling
            a["nb_sel"] = PROP_BUCKETS[-1]
            nfr = to_dev(np.array([m.n_frames for _, m in items_p], np.int32))
            a["sel_dev"] = select_topk_batched(pred_props_b, nfr, topN=topN, nb=a["nb_sel"],
                                               val_score_thres=val_score_thres)
        if get_eval_loss and split != "test":
            # selection-independent; stage_b adds a video's losses only
            # when its selection is not empty, but counts it in it_vids
            stacked = VideoBatch(*(np.stack([np.asarray(x) for x in xs])
                                   for xs in zip(*[b for b, _ in items_p])))
            a["loss_m"] = val_loss_step_batched(
                tap, cg, batch_to_device(stacked, dev), cfg,
                phase=("tap" if flag_eval_what == "tap" else "tap_cg"))
        tm["host_prep"] += _clk.time() - t0
        tm["groups"] += 1
        return a

    def stage_b(a):
        """The blocking selection and loss fetches, the host-side selection
        per video and the decode launch.  Returns a pending decode entry, or
        None for 'tap', which decodes nothing."""
        if a is None:
            return None
        items, items_p, B = a["items"], a["items_p"], a["B"]

        t0 = _clk.time()
        if a["device_sel"]:
            idx_np, cnt_np, conf_np = _fetch(*a["sel_dev"])
            pp_b = None
        else:
            (pp_b,) = _fetch(a["pred_props_b"].float())
        tm["select_fetch"] += _clk.time() - t0

        t0 = _clk.time()
        sel = []
        max_n = 1
        for i, (batch, meta) in enumerate(items):
            if a["device_sel"]:
                (ind, soi, _, ts, tp), fell_back = device_selection_row(
                    flag_eval_what, idx_np[i], cnt_np[i], conf_np[i], a["nb_sel"], batch, meta,
                    cfg, nms_threshold=nms_threshold, val_score_thres=val_score_thres,
                    topN=topN, grid_fetch=lambda i=i: _fetch(a["pred_props_b"][i].float())[0])
                tm["grid_fallbacks"] += int(fell_back)
            else:
                pp = pp_b[i][: meta.n_frames]
                masks = np.asarray(batch.tap_masks)[: meta.n_frames]
                ind, soi, _, ts, tp = select_proposals(
                    flag_eval_what, batch, meta, pp, masks, cfg, nms_threshold=nms_threshold,
                    val_score_thres=val_score_thres, topN=topN)
            sel.append((ind, soi, ts, tp))
            max_n = max(max_n, len(ind))
        tm["host_select"] += _clk.time() - t0

        if "loss_m" in a and any(len(s[0]) for s in sel):
            t0 = _clk.time()
            names = list(a["loss_m"])
            m = dict(zip(names, _fetch(*(a["loss_m"][k] for k in names))))
            has_sel = np.array([len(s[0]) > 0 for s in sel], bool)
            loss_sum[0] += float(m["tap_loss"][:B][has_sel].sum())
            if flag_eval_what != "tap":
                loss_sum[1] += float(m["cg_loss"][:B][has_sel].sum())
                loss_sum[2] += float(m["total_loss"][:B][has_sel].sum())
            tm["loss_fetch"] += _clk.time() - t0

        if flag_eval_what == "tap":
            for (batch, meta), (ind, soi, ts, tp) in zip(items, sel):
                vid_info = [
                    {"sentence": "", "timestamp": list(ts[i]),
                     "sentence_confidence": 0.0, "proposal_score": float(tp[i]),
                     "re_score": 10 * float(tp[i]), "num": [i, len(ind)]}
                    for i in range(len(ind))
                ]
                if vid_info:
                    predictions[meta.vid] = vid_info
            return None

        t0 = _clk.time()
        nb = _prop_bucket(max_n)
        sel_p = sel + [sel[-1]] * (len(items_p) - B)
        pads = [_pad_props(ind[:nb], soi[:nb], nb) for (ind, soi, _, _) in sel_p]
        props = ProposalBatch(*(to_dev(np.stack(xs)) for xs in zip(*pads)))
        lda_b = to_dev(np.stack([b.lda for b, _ in items_p]))
        fm_b = to_dev(np.stack([b.frame_mask for b, _ in items_p]))
        args = (cg, cfg, a["tap_feats_b"], a["feats_b"], lda_b, fm_b, props)
        if beam_size > 1:
            seq_b, logprob_b = beam_decode_step_batched(*args, beam_size,
                                                        length_alpha=length_alpha)
            tm["decode_dispatch"] += _clk.time() - t0
            return (items, sel, nb, seq_b, logprob_b, None)
        sample_gen = None
        if not greedy:
            sample_gen = torch.Generator(device=dev)
            sample_gen.manual_seed(_group_seed(sample_seed, dispatch_count[0]))
            dispatch_count[0] += 1
        seq_b, logps_b, active_b = decode_step_batched(*args, greedy=greedy,
                                                       temperature=temperature,
                                                       sample_gen=sample_gen)
        tm["decode_dispatch"] += _clk.time() - t0
        return (items, sel, nb, seq_b, logps_b, active_b)

    def collect_entry(entry):
        """The blocking decode fetch and the caption assembly of one group.
        Runs on the assembler thread with async_assemble; predictions is
        written from that thread only (or only from the caller's)."""
        t0 = _clk.time()
        items, sel, nb, seq_b, logps_b, active_b = entry
        is_beam = active_b is None  # beam entries carry [B, N] total logprobs
        with on_device():
            if is_beam:
                seq_np, logps_np = _fetch(seq_b, logps_b)
                active_np = None
            else:
                seq_np, logps_np, active_np = _fetch(seq_b, logps_b, active_b)
        tm["decode_fetch"] += _clk.time() - t0
        t0 = _clk.time()
        for i, ((batch, meta), (ind, soi, ts, tp)) in enumerate(zip(items, sel)):
            n_real = min(len(ind), nb)
            if n_real == 0 or (not is_beam and not bool(active_np[i][0])):
                continue  # reference: sample() returned [] (all ended at t=1)
            sents = decode_sequence(vocab, seq_np[i][:n_real])
            cg_score = logps_np[i][:n_real] if is_beam else logps_np[i][:n_real].sum(axis=1)
            cg_l = cg_score.astype(float).tolist()
            tp_l = np.asarray(tp[:n_real], dtype=float).tolist()
            ts_l = np.asarray(ts[:n_real], dtype=float).tolist()
            n = len(sents)
            vid_info = [
                {"sentence": s, "timestamp": ts_l[j], "sentence_confidence": cg_l[j],
                 "proposal_score": tp_l[j], "re_score": 10 * tp_l[j] + cg_l[j], "num": [j, n]}
                for j, s in enumerate(sents)
            ]
            if is_reranking:
                vid_info = P.rerank_top10(vid_info)
            predictions[meta.vid] = vid_info
        tm["assemble"] += _clk.time() - t0

    # the assembler thread; its bounded queue is the in-flight decode cap
    asm_q: "_pyq.Queue" = _pyq.Queue(maxsize=inflight)
    asm_exc: List[BaseException] = []

    def asm_run():
        while True:
            entry = asm_q.get()
            if entry is None:
                return
            if asm_exc:
                continue  # keep draining so collect() never blocks
            try:
                collect_entry(entry)
            except BaseException as e:  # re-raised at join
                asm_exc.append(e)

    asm_thread = None

    def collect(entry):
        if entry is None:
            return
        if asm_thread is not None:
            asm_q.put(entry)
        else:
            collect_entry(entry)

    def finish_assembly(reraise: bool = True):
        """Stop and join the assembler (idempotent); reraise=False is the
        abort path, which must not mask the first exception."""
        nonlocal asm_thread
        if asm_thread is not None:
            asm_q.put(None)
            asm_thread.join()
            asm_thread = None
            if asm_exc:
                if reraise:
                    raise asm_exc[0]
                log.warning("eval assembler raised during an aborted pass: %r", asm_exc[0])

    def drain(a_keep: int, b_keep: int):
        """Advance the pipeline until at most a_keep stage-A and b_keep
        stage-B entries are in flight.  With a_keep 1, group k's blocking
        selection fetch comes after group k+1's encode is queued."""
        while len(encoded) > a_keep:
            entry = stage_b(encoded.pop(0))
            if entry is not None:
                pending.append(entry)
        while len(pending) > b_keep:
            collect(pending.pop(0))

    # no cyclic GC during the pass: the predictions' many small objects
    # would be rescanned by every gen-2 collection; one collect at the end
    gc_was_enabled = _gc.isenabled()
    wd = HangWatchdog("eval", cfg.runtime.hang_warn_s)
    try:
        loader.set_labels(not decode_only, split)
        if bf16_transfer and decode_only:
            # the cast in the prefetch workers; with val losses the stacked
            # batch's feats must stay f32, so the cast stays in stage_a
            loader.set_feats_dtype(torch.bfloat16, split)
        loader.reset_iterator(split)
        if bool(kw.get("async_assemble", True)):
            asm_thread = threading.Thread(target=asm_run, name="eval-assembler", daemon=True)
            asm_thread.start()
        if gc_was_enabled and bool(kw.get("gc_pause", True)):
            _gc.disable()
        wd.start()
        done = False
        t_load = _clk.time()
        while not done:
            wd.beat()
            batch, meta = loader.get_batch(split)
            tm["loader"] += _clk.time() - t_load
            usable = meta.proposal_num > 0 and meta.n_frames > 1
            if usable:
                it_vids += 1
            # bad videos do not count toward num_vids_eval (eval_utils.py:44)
            done = meta.wrapped or it_vids >= num_vids_eval
            if usable:
                groups.setdefault(meta.t_bucket, []).append((batch, meta))
                if len(groups[meta.t_bucket]) >= batch_videos:
                    encoded.append(stage_a(groups.pop(meta.t_bucket)))
                    drain(1, inflight)
            t_load = _clk.time()
        for bucket in list(groups):
            encoded.append(stage_a(groups.pop(bucket)))
        drain(0, 0)
        finish_assembly()
    finally:
        wd.stop()
        finish_assembly(reraise=False)
        loader.set_labels(labels_before, split)
        loader.set_feats_dtype(feats_dtype_before, split)
        if gc_was_enabled and not _gc.isenabled():
            _gc.enable()
            _gc.collect()
    if tm["groups"]:
        log.info(
            "eval pipeline breakdown (%d groups): loader %.2fs, host_prep %.2fs, select_fetch "
            "%.2fs, host_select %.2fs, loss_fetch %.2fs, decode_dispatch %.2fs, decode_fetch "
            "%.2fs, assemble %.2fs, grid_fallbacks %d",
            tm["groups"], tm["loader"], tm["host_prep"], tm["select_fetch"], tm["host_select"],
            tm["loss_fetch"], tm["decode_dispatch"], tm["decode_fetch"], tm["assemble"],
            tm["grid_fallbacks"])
    if isinstance(kw.get("timing_out"), dict):
        kw["timing_out"].update(tm)

    pred2json = {
        "results": predictions,
        "version": "VERSION 1.0",
        "external_data": {"used": True, "details": "C3D features"},
    }
    os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
    with open(json_path, "w") as f:
        json.dump(pred2json, f)

    score: Dict[str, np.ndarray] = {}
    if lang_eval:
        references = kw.get("references") or list(cfg.eval.references)
        sample_score = eval_score(
            json_path, only_recall=(flag_eval_what == "tap"), verbose=bool(val_all_metrics),
            topN=topN, references=references, gt_from_loader=loader,
            meteor_synonyms=cfg.eval.meteor_synonyms,
            meteor_paraphrases=cfg.eval.meteor_paraphrases)
        for k, v in sample_score.items():
            score[k] = np.array(v)
    return predictions, score, loss_sum / max(it_vids, 1)
