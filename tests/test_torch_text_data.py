"""The port's byte-corpus pipeline (``repro_torch.data.text``) against the
reference's (``repro.data.text``), on a corpus written to ``tmp_path``:
batches equal bit for bit at several steps, seeds and shapes, the same
fingerprint, and the same refusal of a corpus too small for one window."""
import torch_test_env  # noqa: F401  (first: caps torch's threads under xdist)
import numpy as np
import pytest

pytest.importorskip("jax")
from repro.data import text as RTX  # noqa: E402
from repro_torch.data import text as TX  # noqa: E402


@pytest.fixture
def corpus(tmp_path):
    rng = np.random.default_rng(11)
    p = tmp_path / "corpus.bin"
    p.write_bytes(rng.integers(0, 256, 5000, dtype=np.uint8).tobytes())
    return str(p)


@pytest.mark.parametrize("seq,gb,seed", [(32, 4, 0), (100, 3, 7)])
def test_batches_equal_reference(corpus, seq, gb, seed):
    mine = TX.ByteCorpus(TX.TextConfig(corpus, seq, gb, seed))
    ref = RTX.ByteCorpus(RTX.TextConfig(corpus, seq, gb, seed))
    assert (TX.BOS, TX.VOCAB) == (RTX.BOS, RTX.VOCAB)
    assert mine.n_windows == ref.n_windows
    assert mine.fingerprint() == ref.fingerprint()
    for step in (0, 1, 17, 10_000):
        got, want = mine.batch(step), ref.batch(step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            assert got[k].shape == (gb, seq)
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert (got["tokens"][:, 0] == TX.BOS).all()
        np.testing.assert_array_equal(got["tokens"][:, 2:],
                                      got["labels"][:, 1:-1])


def test_too_small_corpus_raises(tmp_path):
    p = tmp_path / "tiny.bin"
    p.write_bytes(b"x" * 33)
    with pytest.raises(ValueError, match="corpus too small: 33 bytes"):
        TX.ByteCorpus(TX.TextConfig(str(p), seq_len=32, global_batch=2))
    with pytest.raises(ValueError, match="corpus too small: 33 bytes"):
        RTX.ByteCorpus(RTX.TextConfig(str(p), seq_len=32, global_batch=2))
    assert TX.ByteCorpus(TX.TextConfig(str(p), seq_len=31,
                                       global_batch=2)).n_windows == 1
