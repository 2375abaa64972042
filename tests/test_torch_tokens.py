"""The port's synthetic token data (``repro_torch.data.tokens``, a numpy
copy of the reference's generator) against the reference: bitwise the
same arrays for several vocab sizes, clients and seeds, and the
reference's own properties (deterministic, non-IID across clients)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.data import tokens as jax_tokens  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from torch_parity import pin_torch_threads  # noqa: E402

pin_torch_threads()


@pytest.mark.parametrize("vocab,client,seed", [(32, 0, 0), (64, 1, 3), (512, 5, 7),
                                               (97, 13, 1)])
def test_sample_tokens_bitwise_the_references(vocab, client, seed):
    got = tokens.sample_tokens(vocab, 6, 40, client=client, seed=seed)
    expect = jax_tokens.sample_tokens(vocab, 6, 40, client=client, seed=seed)
    assert got.dtype == expect.dtype == np.int32
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("vocab,client", [(64, 0), (200, 9)])
def test_client_transition_bitwise_the_references(vocab, client):
    np.testing.assert_array_equal(tokens._client_transition(vocab, client),
                                  jax_tokens._client_transition(vocab, client))


def test_lm_batches_bitwise_the_references():
    got = list(tokens.make_lm_batches(128, 4, 16, 3, client=2, seed=5))
    expect = list(jax_tokens.make_lm_batches(128, 4, 16, 3, client=2, seed=5))
    assert len(got) == len(expect) == 3
    for g, e in zip(got, expect):
        assert set(g) == set(e) == {"tokens", "labels"}
        for k in g:
            np.testing.assert_array_equal(g[k], e[k])
        np.testing.assert_array_equal(g["tokens"][:, 1:], g["labels"][:, :-1])


@pytest.mark.parametrize("n_clients,vocab,seed", [(6, 512, 0), (3, 64, 4)])
def test_token_swarm_data_bitwise_the_references(n_clients, vocab, seed):
    got = tokens.make_token_swarm_data(n_clients, vocab, n_seqs=12, seq_len=32, seed=seed)
    expect = jax_tokens.make_token_swarm_data(n_clients, vocab, n_seqs=12, seq_len=32,
                                              seed=seed)
    assert len(got) == len(expect) == n_clients
    for g, e in zip(got, expect):
        assert g["n_train"] == e["n_train"] == 12
        for split in ("train", "val", "test"):
            for a, b in zip(g[split], e[split]):
                np.testing.assert_array_equal(a, b)
        assert g["train"][0].shape == (12, 32) and g["val"][0].shape == (2, 32)


def test_token_clients_are_non_iid():
    """As the reference's test_data: the transition maps differ."""
    clients = tokens.make_token_swarm_data(3, vocab=64, n_seqs=8, seq_len=128)

    def bigram_mass(toks):
        h = np.zeros((64, 64))
        for row in toks:
            for a, b in zip(row[:-1], row[1:]):
                h[a, b] += 1
        return h / h.sum()

    h0 = bigram_mass(clients[0]["train"][0])
    h1 = bigram_mass(clients[1]["train"][0])
    assert np.abs(h0 - h1).sum() > 0.5


def test_tokens_deterministic():
    a = tokens.sample_tokens(32, 4, 16, client=1, seed=3)
    b = tokens.sample_tokens(32, 4, 16, client=1, seed=3)
    np.testing.assert_array_equal(a, b)
