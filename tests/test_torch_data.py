"""The port's LM data pipeline against the JAX package's: the synthetic
token stream byte for byte, the sharded loader's shards and its
prefetching iterator (numpy on both sides; exact)."""

import numpy as np
import pytest

from repro.data import ShardedLoader as JShardedLoader
from repro.data import SyntheticTokens as JSyntheticTokens
from repro_torch.data import ShardedLoader, SyntheticTokens


def _equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("seed,step,vocab,seq,batch", [
    (0, 0, 512, 64, 4), (0, 7, 262_144, 1024, 2), (3, 1, 32_768, 17, 3),
    (11, 123, 100, 16, 1), (5, 2, 51_865, 300, 8)])
def test_synthetic_tokens_byte_equal(seed, step, vocab, seq, batch):
    kw = dict(vocab_size=vocab, seq_len=seq, batch_size=batch, seed=seed)
    got, want = SyntheticTokens(**kw).batch(step), \
        JSyntheticTokens(**kw).batch(step)
    _equal(got, want)
    assert got["tokens"].dtype == np.int32
    assert np.array_equal(got["labels"][:, :-1], got["tokens"][:, 1:])


@pytest.mark.parametrize("num_hosts", [1, 2, 4])
def test_sharded_loader_shards_equal(num_hosts):
    src = SyntheticTokens(vocab_size=512, seq_len=32, batch_size=8, seed=1)
    jsrc = JSyntheticTokens(vocab_size=512, seq_len=32, batch_size=8, seed=1)
    for host in range(num_hosts):
        got = ShardedLoader(src.batch, host_id=host, num_hosts=num_hosts)
        want = JShardedLoader(jsrc.batch, host_id=host, num_hosts=num_hosts)
        for step in (0, 5):
            _equal(got.get(step), want.get(step))
    with pytest.raises(AssertionError):
        ShardedLoader(src.batch, num_hosts=3).get(0)


@pytest.mark.parametrize("prefetch", [0, 1, 3])
def test_sharded_loader_iterate_equal_and_resumes(prefetch):
    src = SyntheticTokens(vocab_size=100, seq_len=16, batch_size=4, seed=2)
    jsrc = JSyntheticTokens(vocab_size=100, seq_len=16, batch_size=4, seed=2)
    got = list(ShardedLoader(src.batch, host_id=1, num_hosts=2,
                             prefetch=prefetch).iterate(3, 9))
    want = list(JShardedLoader(jsrc.batch, host_id=1, num_hosts=2,
                               prefetch=prefetch).iterate(3, 9))
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(3, 9))
    for (_, g), (_, w) in zip(got, want):
        _equal(g, w)
    # exact resume: starting at 6 gives the same batches as the tail
    tail = list(ShardedLoader(src.batch, host_id=1, num_hosts=2,
                              prefetch=prefetch).iterate(6, 9))
    for (s, g), (s2, w) in zip(tail, got[3:]):
        assert s == s2
        _equal(g, w)
