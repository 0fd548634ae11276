"""The port's data path (``repro_torch.data``) on the CPU: the cases of
``tests/test_data.py`` (determinism, shifted labels, the shard
invariant, the pipeline's prefetch and skip-ahead, a learnable stream)
and of ``tests/test_loop.py``'s pipeline cases (``next_at`` resyncs
without a restore hook; a loader error reaches the consumer). The port's
``SyntheticLM`` has no codebooks (no ported model reads them), and its
rows are pure in (seed, step, row), so the pipeline passes a shard and
no shard count."""
import numpy as np
import pytest
import torch

from repro_torch.data.pipeline import DataPipeline, Prefetcher
from repro_torch.data.synthetic import SyntheticLM

hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")


def test_batch_determinism():
    src = SyntheticLM(vocab_size=64, seed=3)
    a = src.batch(5, 4, 16)
    b = src.batch(5, 4, 16)
    assert torch.equal(a["tokens"], b["tokens"])
    c = src.batch(6, 4, 16)
    assert not torch.equal(a["tokens"], c["tokens"])


def test_labels_are_shifted_tokens():
    src = SyntheticLM(vocab_size=64, seed=0)
    b = src.batch(0, 2, 32)
    assert b["tokens"].shape == (2, 32) and b["labels"].shape == (2, 32)
    assert b["tokens"].dtype == b["labels"].dtype == torch.int64
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@hypothesis.given(step=st.integers(0, 50), shards=st.sampled_from([1, 2, 4]))
@hypothesis.settings(max_examples=10, deadline=None)
def test_elasticity_invariant(step, shards):
    """Re-sharding the pipeline preserves the global sample set: the
    concatenation of every shard's batch is the 1-shard batch."""
    src = SyntheticLM(vocab_size=32, seed=1)
    whole = DataPipeline(src, 8, 8).next_at(step)
    per = 8 // shards
    parts = []
    for s in range(shards):
        pipe = DataPipeline(src, per, 8, shard=s)
        parts.append(pipe.next_at(step)["tokens"])
        pipe.stop()
    assert torch.equal(torch.cat(parts), whole["tokens"])


@pytest.mark.parametrize("prefetch", [2, 0])
def test_pipeline_prefetch_and_skip(prefetch):
    """With a prefetch thread (the JAX package's pipeline) and without
    one (``prefetch=0``, the CLI's): the same batches by step."""
    src = SyntheticLM(vocab_size=64, seed=0)
    pipe = DataPipeline(src, batch_size=2, seq_len=8, prefetch=prefetch)
    pipe.start(0)
    b0 = pipe.next()
    b1 = pipe.next()
    pipe.skip_to(10)
    b10 = pipe.next()
    pipe.stop()
    assert torch.equal(b10["tokens"], src.batch(10, 2, 8)["tokens"])
    assert not torch.equal(b0["tokens"], b1["tokens"])


@pytest.mark.parametrize("prefetch", [2, 0])
def test_next_at_resyncs_without_on_restore(prefetch):
    pipe = DataPipeline(SyntheticLM(64, seed=0), 2, 8, prefetch=prefetch)
    pipe.start(0)
    want = {t: pipe.next_at(t)["tokens"].clone() for t in range(5)}
    assert torch.equal(pipe.next_at(2)["tokens"], want[2])
    assert torch.equal(pipe.next_at(3)["tokens"], want[3])
    pipe.stop()


def test_loader_error_reaches_the_consumer():
    def fetch(step):
        if step == 2:
            raise OSError("disk gone")
        return step

    pre = Prefetcher(fetch, 0)
    assert [pre.get(0), pre.get(1)] == [0, 1]
    with pytest.raises(OSError, match="disk gone"):
        pre.get(2)
    pre.close()
    pre = Prefetcher(lambda s: s, 3)
    with pytest.raises(RuntimeError, match="out of sync"):
        pre.get(4)
    pre.close()


def test_markov_stream_is_learnable():
    """Fewer than log(V) nats of entropy: every transition is one of the
    token's ``branching`` successors."""
    src = SyntheticLM(vocab_size=256, seed=0, branching=4)
    toks = src.batch(0, 8, 128)["tokens"].numpy()
    hits = sum(row[t + 1] in src.succ[row[t]]
               for row in toks for t in range(len(row) - 1))
    assert hits / (toks.shape[0] * (toks.shape[1] - 1)) > 0.99
