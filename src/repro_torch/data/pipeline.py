"""Token pipeline with PUL-style host->device preloading (port of
``repro/data/pipeline.py``).

Batches are made on the host (a synthetic Zipf LM stream, or windows of
memory-mapped token files) and a prefetch thread keeps `prefetch_distance`
of them ready ahead of the training step. A batch is a pure function of
(seed, step): ``_host_batch`` is the reference's numpy code, so the port's
batch at a step equals the reference's bit for bit, the frontend stub's
embeddings included (drawn in fp32 and rounded to bf16, to nearest even, as
the reference's ``astype``). Resuming after a crash is ``skip_to(step)``.
``_put`` moves a batch onto the pipeline's device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    prefetch_distance: int = 2      # PUL distance, host->device
    pack_docs: bool = True
    token_files: Optional[tuple] = None   # memory-mapped .npy shards
    frontend_tokens: int = 0
    d_model: int = 0                # for frontend stub embeddings


class TokenPipeline:
    """Deterministic, resumable, prefetching batch source."""

    def __init__(self, cfg: DataConfig, device="cuda"):
        self.cfg = cfg
        self.step = 0
        self.device = resolve_device(device)
        self._mmaps = None
        if cfg.token_files:
            self._mmaps = [np.load(f, mmap_mode="r") for f in cfg.token_files]
        self._q: "queue.Queue" = queue.Queue(
            maxsize=max(1, cfg.prefetch_distance))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------ #
    def _host_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Pure function of (seed, step): CPU tensors, tokens and targets
        int32, loss_mask fp32, frontend_embeds bf16."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        if self._mmaps is not None:
            # sample contiguous windows from the mmap'd corpus
            m = self._mmaps[step % len(self._mmaps)]
            starts = rng.integers(0, max(1, m.shape[0] - S - 1), size=B)
            toks = np.stack([np.asarray(m[s:s + S + 1]) for s in starts])
        else:
            # synthetic Zipf-ish LM stream (documents separated by token 0)
            toks = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
            toks = np.minimum(toks, cfg.vocab_size - 1).astype(np.int32)
            if cfg.pack_docs:
                doc_ends = rng.random((B, S + 1)) < 1.0 / 512
                toks = np.where(doc_ends, 0, toks)
        batch = {
            "tokens": torch.from_numpy(toks[:, :S].astype(np.int32)),
            "targets": torch.from_numpy(toks[:, 1:].astype(np.int32)),
            "loss_mask": torch.ones((B, S), dtype=torch.float32),
        }
        if cfg.frontend_tokens:
            fe = (rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model))
                  .astype(np.float32) * 0.02)
            batch["frontend_embeds"] = torch.from_numpy(fe).to(torch.bfloat16)
        return batch

    def _put(self, batch):
        return {k: v.to(self.device) for k, v in batch.items()}

    # ------------------------------------------------------------------ #
    def skip_to(self, step: int):
        """Resume point: deterministic, O(1)."""
        if self._thread is not None:
            raise RuntimeError("skip before starting the prefetcher")
        self.step = step

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            batch = self._host_batch(s)
            while not self._stop.is_set():
                try:
                    self._q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def start(self):
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def stop(self):
        """Stops the prefetch thread and drops the batches it made."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        while not self._q.empty():
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._thread is None:
            # synchronous fallback (tests / simple loops)
            b = self._put(self._host_batch(self.step))
            self.step += 1
            return b
        s, batch = self._q.get()
        self.step = s + 1
        return self._put(batch)
