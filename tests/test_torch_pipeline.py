"""The port's data pipeline (``repro_torch/data/pipeline.py``) against the
JAX package's (``repro/data/pipeline.py``), on the CPU: the same corpus
through both, batches bit-equal (tokens, labels, mask and the bf16 memory
stub), exactly-once resume, the dataframe stages, background prefetch.

The corpus is the one ``tests/test_pipeline.py`` builds: 600 synthetic
documents (seed 2) with one short document (filtered) and one duplicate
(deduplicated).  Every comparison is exact.
"""
import numpy as np
import pytest
import torch

from repro.data import DataPipeline as RPipeline
from repro.data import PipelineConfig as RConfig
from repro.data import synthetic_corpus as r_corpus
from repro_torch.data import DataPipeline, PipelineConfig, synthetic_corpus


def _corpus():
    corpus = r_corpus(600, seed=2, mean_len=30)
    # inject short docs (filtered) and duplicates (deduped)
    corpus[10] = "short"
    corpus[11] = corpus[12]
    return corpus


def _pipes(**kw):
    corpus = _corpus()
    ref = RPipeline(corpus, 1024, RConfig(seq_len=24, global_batch=4, shard_docs=150, **kw))
    port = DataPipeline(corpus, 1024, PipelineConfig(seq_len=24, global_batch=4,
                                                     shard_docs=150, **kw), device="cpu")
    return ref, port


def _same_batch(rb: dict, tb: dict) -> None:
    assert set(rb) == set(tb)
    for k, v in rb.items():
        got = tb[k]
        assert got.device.type == "cpu"
        if k == "memory":
            assert got.dtype == torch.bfloat16
            want = np.asarray(v).astype(np.float32)
            got = got.float()
        else:
            want = np.asarray(v)
            assert got.dtype == {"tokens": torch.int32, "labels": torch.int32,
                                 "mask": torch.float32}[k]
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 2, 5])
def test_synthetic_corpus_matches_reference(seed):
    assert synthetic_corpus(300, seed=seed, mean_len=30) == r_corpus(300, seed=seed, mean_len=30)
    assert synthetic_corpus(20, seed=seed) == r_corpus(20, seed=seed)


def test_batches_bit_equal_to_reference():
    ref, port = _pipes()
    rb = [b for _, b in zip(range(40), ref.batches())]
    tb = [b for _, b in zip(range(40), port.batches())]
    assert len(rb) == len(tb) == 40
    for a, b in zip(rb, tb):
        assert tuple(b["tokens"].shape) == (4, 24)
        _same_batch(a, b)


def test_memory_stub_matches_reference_bf16_draws():
    ref, port = _pipes(memory_len=5, d_model=16, seed=3)
    for a, b in zip(ref.batches(), port.batches()):
        assert tuple(b["memory"].shape) == (4, 5, 16)
        _same_batch(a, b)


def test_resume_cursor_exactly_once():
    ref, port = _pipes()
    full = [b for _, b in zip(range(6), port.batches())]
    _, port2 = _pipes()
    resumed = [b for _, b in zip(range(3), port2.batches(start_batch=3))]
    ref_resumed = [b for _, b in zip(range(3), ref.batches(start_batch=3))]
    for a, b, r in zip(full[3:], resumed, ref_resumed):
        assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
        _same_batch(r, b)


def test_dataframe_stages_filter_dedup_sort():
    ref, port = _pipes()
    frame = port.session.collect(port._shard_plan(0))
    texts = frame.col("text").to_pylist()
    assert "short" not in texts                      # SELECTION applied
    assert len(texts) == len(set(texts))             # DROP-DUPLICATES applied
    counts = frame.col("token_count").to_pylist()    # SORT by token_count
    assert counts == sorted(counts)
    want = ref.session.collect(ref._shard_plan(0))
    assert texts == want.col("text").to_pylist()
    assert counts == want.col("token_count").to_pylist()
    assert frame.col("doc_id").to_pylist() == want.col("doc_id").to_pylist()


def test_background_prefetch_runs():
    _, port = _pipes()
    list(zip(range(4), port.batches()))
    stats = port.stats()
    assert set(stats) == {"background_tasks", "cache_hits", "evaluated_nodes"}
    assert stats["background_tasks"] >= 1


def test_pipeline_defaults_to_cuda():
    """Without device="cpu" the pipeline's session targets CUDA, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        DataPipeline(_corpus(), 1024, PipelineConfig())
