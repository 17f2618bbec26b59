"""The paper's technique as the training data pipeline, over the port's
dataframe engine, as the reference's ``repro/data/pipeline.py``.

Ingest → clean → select → pack → batch, with the clean/select stages
expressed as dataframe-algebra plans executed by the *opportunistic*
scheduler: while the card runs step i, the session's background threads
evaluate the plan for shard i+1 — the paper's "think-time computation"
recast as compute/IO overlap.  Shard plans are pure dataframe queries, so
the reuse cache dedupes re-walks after a restart, and the deterministic
shard→batch mapping gives exactly-once resume from the checkpoint's data
cursor.

Stages per shard (dataframe algebra, on the session's device):
    SELECTION   word_count ≥ min_words        (quality filter)
    DROP-DUP    by text                        (dedup)
    MAP         token_count := tokenize-len    (schema-inducing metadata map)
    SORT        by token_count                 (length bucketing → less padding)
Then host-side packing into fixed (seq_len+1) examples, as the reference
does, and batches of tensors on the session's device (CUDA unless
``device="cpu"``): ``tokens`` and ``labels`` int32, ``mask`` float32 ones,
and a bf16 ``memory`` stub from the same numpy draws as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..core import algebra as alg
from ..core.dtypes import Domain, parse_column
from ..core.frame import Column, Frame
from ..core.labels import labels_from_values
from ..core.session import EvalMode, Session
from .tokenizer import EOS, HashTokenizer


@dataclasses.dataclass
class PipelineConfig:
    seq_len: int = 128
    global_batch: int = 8
    min_words: int = 4
    shard_docs: int = 512          # docs per dataframe shard
    memory_len: int = 0            # >0 ⇒ emit modality-memory stubs
    d_model: int = 0
    seed: int = 0


class DataPipeline:
    def __init__(self, texts: list[str], vocab_size: int, pc: PipelineConfig,
                 session: Session | None = None, device=None):
        self.pc = pc
        self.tok = HashTokenizer(vocab_size)
        self.session = session or Session(mode=EvalMode.OPPORTUNISTIC,
                                          default_row_parts=4, device=device)
        self.device = self.session.device
        self.shards = [texts[i:i + pc.shard_docs]
                       for i in range(0, len(texts), pc.shard_docs)]
        self._plans: dict[int, alg.Node] = {}
        self._rng = np.random.default_rng(pc.seed)

    # ------------------------------------------------------------------
    def _shard_plan(self, i: int) -> alg.Node:
        if i in self._plans:
            return self._plans[i]
        texts = self.shards[i]
        frame = Frame.from_pydict({
            "doc_id": list(range(len(texts))),
            "text": texts,
            "word_count": [len(t.split()) for t in texts],
        }, device=self.device)
        src = self.session.register_frame(frame, row_parts=4)
        plan = alg.Selection(src, alg.col("word_count") >= alg.lit(self.pc.min_words))
        plan = alg.DropDuplicates(plan, subset=("text",))
        tok = self.tok

        def add_token_count(cols, fr):
            texts_ = cols["text"].to_pylist()
            counts = [len(tok.encode(t or "")) for t in texts_]
            p = parse_column(counts, Domain.INT, device=fr.device)
            out = dict(cols)
            out["token_count"] = Column(p.data, p.domain, p.mask, None)
            return Frame(list(out.values()), fr.row_labels,
                         labels_from_values(list(out.keys())))

        plan = alg.Map(plan, alg.Udf.wrap(add_token_count,
                                          name=f"tokcount_shard{i}",
                                          deps=frozenset(["text"]),
                                          elementwise=True,
                                          out_cols=("doc_id", "text", "word_count",
                                                    "token_count")))
        plan = alg.Sort(plan, ("token_count",), ascending=True)  # length bucketing
        self._plans[i] = plan
        return plan

    def _prefetch(self, i: int) -> None:
        if 0 <= i < len(self.shards):
            self.session.executor.submit(self._shard_plan(i))

    # ------------------------------------------------------------------
    def _shard_examples(self, i: int) -> np.ndarray:
        """(N, seq_len+1) int32 token matrix for shard i (deterministic)."""
        plan = self._shard_plan(i)
        self._prefetch(i + 1)  # overlap: next shard evaluates in background
        frame = self.session.collect(plan)
        texts = frame.col("text").to_pylist()
        stream: list[int] = []
        for t in texts:
            stream.extend(self.tok.encode(t or ""))
            stream.append(EOS)
        width = self.pc.seq_len + 1
        n = len(stream) // width
        if n == 0:
            return np.zeros((0, width), np.int32)
        return np.asarray(stream[: n * width], np.int32).reshape(n, width)

    def batches(self, start_batch: int = 0) -> Iterator[dict]:
        """Deterministic batch stream; ``start_batch`` resumes mid-epoch."""
        width = self.pc.seq_len + 1
        buf = np.zeros((0, width), np.int32)
        emitted = 0
        for i in range(len(self.shards)):
            buf = np.concatenate([buf, self._shard_examples(i)], axis=0)
            while buf.shape[0] >= self.pc.global_batch:
                ex, buf = buf[: self.pc.global_batch], buf[self.pc.global_batch:]
                emitted += 1
                if emitted <= start_batch:
                    continue
                yield self._to_batch(ex)

    def _to_batch(self, ex: np.ndarray) -> dict:
        dev = self.device
        batch = {
            "tokens": torch.from_numpy(np.ascontiguousarray(ex[:, :-1])).to(dev),
            "labels": torch.from_numpy(np.ascontiguousarray(ex[:, 1:])).to(dev),
            "mask": torch.ones((ex.shape[0], ex.shape[1] - 1), dtype=torch.float32,
                               device=dev),
        }
        if self.pc.memory_len:
            draw = self._rng.standard_normal(
                (ex.shape[0], self.pc.memory_len, self.pc.d_model)).astype(np.float32)
            batch["memory"] = torch.from_numpy(draw).to(dev).to(torch.bfloat16)
        return batch

    def stats(self) -> dict:
        st = self.session.executor.stats
        return {
            "background_tasks": st.background_tasks,
            "cache_hits": st.cache_hits,
            "evaluated_nodes": st.evaluated_nodes,
        }
