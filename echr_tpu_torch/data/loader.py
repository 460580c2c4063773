"""Iteration and prefetch (echr_tpu/data/loader.py), the port's copy.

A thread-pool prefetcher replaces the reference's BlobFetcher (reference:
dataloader.py:680-743): label synthesis is numpy, which releases the GIL.
Iterator semantics match the reference: a per-split epoch order
reshuffled on wrap (dataloader.py:707-708), the ``wrapped`` flag on the
batch, and a restorable iterator / order state for resume.  That state is
tracked on the consumer side, since the prefetch threads run ahead.

The process rank and count are arguments: the port has no runtime to ask.
What only echr_tpu's eval pipelines call (the decode-only fetch, the
feature-dtype cast in the workers, external proposals, iterator resets)
is not copied yet.
"""
from __future__ import annotations

import logging
import queue
import threading
import zlib
from typing import Dict, List, Tuple

import numpy as np

from echr_tpu_torch.config import Config
from echr_tpu_torch.data.batcher import BatchMeta, VideoBatch, make_batch
from echr_tpu_torch.data.dataset import BaseDataset


def _derived_seed(base: int, split: str, epoch: int, pos: int) -> int:
    """A per-item seed from (base seed, split, epoch, position): independent
    of producer run-ahead and of other splits, so resume replays a sample."""
    return zlib.crc32(f"{base}:{split}:{epoch}:{pos}".encode()) & 0x7FFFFFFF


class Loader:
    def __init__(self, dataset: BaseDataset, cfg: Config, process_index: int,
                 process_count: int, seed: int = 0):
        """``process_index`` of ``process_count`` processes iterates a
        strided shard of the train split; the other splits stay whole."""
        self.dataset = dataset
        self.cfg = cfg
        self.prefetch = max(1, int(cfg.data.prefetch))
        self.base_seed = int(seed)
        self.process_index, self.process_count = process_index, process_count
        # producer-side state
        self.iterators: Dict[str, int] = {s: 0 for s in dataset.split_ix}
        self.split_order: Dict[str, List[int]] = {
            s: (list(ix[process_index::process_count])
                if process_count > 1 and s == "train" else list(ix))
            for s, ix in dataset.split_ix.items()}
        self.epochs: Dict[str, int] = {s: 0 for s in dataset.split_ix}
        self._shuffle_if_needed("train", epoch=0)
        # consumer-side state: split -> (next position, epoch order, epoch)
        self._consumed: Dict[str, Tuple[int, List[int], int]] = {}
        self._fetchers: Dict[str, "_Prefetcher"] = {}

    def state(self) -> Dict:
        """Consumer-side positions: a resumed run replays exactly the items
        not yet consumed, with the same per-item seeds."""
        iterators = dict(self.iterators)
        orders = {k: list(v) for k, v in self.split_order.items()}
        epochs = dict(self.epochs)
        for split, (pos, order, epoch) in list(self._consumed.items()):
            iterators[split] = pos
            orders[split] = list(order)
            epochs[split] = epoch
        return {"iterators": iterators, "split_order": orders,
                "epochs": epochs, "base_seed": self.base_seed}

    def load_state(self, st: Dict) -> None:
        # stop and join the fetchers before the producer state changes
        self._restart_fetchers()
        self.iterators.update(st.get("iterators", {}))
        for k, v in st.get("split_order", {}).items():
            self.split_order[k] = list(v)
        self.epochs.update(st.get("epochs", {}))
        self.base_seed = int(st.get("base_seed", self.base_seed))
        self._consumed.clear()

    def _shuffle_if_needed(self, split: str, epoch: int) -> None:
        if split == "train" and self.cfg.data.shuffle:
            np.random.RandomState(
                _derived_seed(self.base_seed, split + "/order", epoch, 0)
            ).shuffle(self.split_order[split])

    def _restart_fetchers(self) -> None:
        for f in self._fetchers.values():
            f.stop()
        self._fetchers.clear()

    def _make(self, ix: int, seed: int) -> Tuple[VideoBatch, BatchMeta]:
        ex = self.dataset.get_example(ix)
        return make_batch(ex, self.cfg, np.random.RandomState(seed), w1=self.dataset.w1)

    def get_batch(self, split: str) -> Tuple[VideoBatch, BatchMeta]:
        if split not in self._fetchers:
            n_threads = max(1, int(self.cfg.data.nthreads))
            self._fetchers[split] = _Prefetcher(self, split, self.prefetch, n_threads)
        batch, meta, resume = self._fetchers[split].get()
        self._consumed[split] = resume
        return batch, meta


class _Prefetcher:
    """A bounded pool of producer threads for one split.  Items reach the
    consumer in strict epoch order through a reorder buffer."""

    def __init__(self, loader: Loader, split: str, depth: int, n_threads: int = 1):
        self.loader = loader
        self.split = split
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.error = None  # the first worker exception; get() raises it
        self._stop = threading.Event()
        self._lock = threading.Lock()  # guards position assignment
        self._seq = 0  # next sequence number to assign
        self._emit = 0  # next sequence number to emit
        self._buf: Dict[int, Tuple] = {}
        self._buf_cv = threading.Condition()
        self._max_buf = depth + n_threads
        self.threads = [threading.Thread(target=self._run, daemon=True)
                        for _ in range(max(1, n_threads))]
        for t in self.threads:
            t.start()

    def _next_position(self):
        """(seq, ix, wrapped, seed, resume) under the lock; advances the
        loader's producer cursor, with the epoch counter and a reshuffle at
        a wrap.  ``resume`` is the consumer cursor after this item."""
        ld = self.loader
        with self._lock:
            pos = ld.iterators[self.split]
            order = ld.split_order[self.split]
            epoch = ld.epochs[self.split]
            ix = order[pos]
            wrapped = pos + 1 >= len(order)
            seq = self._seq
            self._seq += 1
            seed = _derived_seed(ld.base_seed, self.split, epoch, pos)
            if wrapped:
                ld.iterators[self.split] = 0
                ld.epochs[self.split] = epoch + 1
                ld.split_order[self.split] = list(order)  # in-flight items keep theirs
                ld._shuffle_if_needed(self.split, epoch + 1)
                resume = (0, ld.split_order[self.split], epoch + 1)
            else:
                ld.iterators[self.split] = pos + 1
                resume = (pos + 1, order, epoch)
            return seq, ix, wrapped, seed, resume

    def _run(self) -> None:
        try:
            self._run_inner()
        except BaseException as e:
            # a dead worker would stall the reorder buffer: keep the error
            # and wake everyone, so that get() raises it
            if self.error is None:
                self.error = e
            with self._buf_cv:
                self._buf_cv.notify_all()

    def _run_inner(self) -> None:
        ld = self.loader
        while not self._stop.is_set():
            with self._buf_cv:  # backpressure: bounded run-ahead
                while not self._stop.is_set() and self._seq - self._emit >= self._max_buf:
                    self._buf_cv.wait(timeout=0.25)
            if self._stop.is_set():
                return
            seq, ix, wrapped, seed, resume = self._next_position()
            batch, meta = ld._make(ix, seed)
            meta.wrapped = wrapped
            with self._buf_cv:
                self._buf[seq] = (batch, meta, resume)
                self._buf_cv.notify_all()
            # drain the head of the reorder buffer into the consumer queue
            while not self._stop.is_set():
                with self._buf_cv:
                    if self._emit not in self._buf:
                        break
                    item = self._buf.pop(self._emit)
                try:
                    self.q.put(item, timeout=0.25)
                except queue.Full:
                    with self._buf_cv:
                        self._buf[self._emit] = item  # put back, retry later
                    continue
                with self._buf_cv:
                    self._emit += 1
                    self._buf_cv.notify_all()

    def get(self):
        while True:
            try:
                item = self.q.get(timeout=0.25)
            except queue.Empty:
                if self.error is not None:
                    raise self.error
                if self._stop.is_set():
                    raise
                continue
            with self._buf_cv:  # wake the producers now, not at their next poll
                self._buf_cv.notify_all()
            return item

    def stop(self) -> None:
        """Stop and join the workers: callers change the producer state
        right after."""
        self._stop.set()
        with self._buf_cv:
            self._buf_cv.notify_all()
        try:
            while True:
                self.q.get_nowait()  # unblock producers stuck on a full queue
        except queue.Empty:
            pass
        for t in self.threads:
            t.join(timeout=10.0)
            if t.is_alive():
                logging.getLogger("echr_tpu_torch.loader").warning(
                    "prefetch worker %s still alive after a 10 s join; it finishes "
                    "against the stopped fetcher", t.name)
        try:
            while True:
                self.q.get_nowait()  # drop anything pushed while exiting
        except queue.Empty:
            pass
