"""The port's serve path against the JAX reference on the CPU: the
scheduler copy, whole generations through the continuous-batching
engine on the reference's buckets (token for token against the
reference's ``generate``), chunked prefill, eos, the ring cache, the
engine against the port's own per-token loop, the CNN classifier,
client reduction, and the entry points' refusal to fall back to the
CPU. Whole generations compare with the reference's jnp decode path
(``use_pallas=False``), which is fast; the kernel-level parity with its
Pallas path is in test_torch_kernels.py and test_torch_lm.py."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import serve as jax_serve  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import bridge, serve  # noqa: E402
from repro_torch.configs import ModelConfig, get_config  # noqa: E402
from repro_torch.launch.serve import prefill_into_cache, run_serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import (BucketSpec, ImageClassifier, Request, ServeEngine,  # noqa: E402
                               SlotScheduler, default_bucket_layout)
from torch_parity import pin_torch_threads  # noqa: E402

pin_torch_threads()

BUCKETS = (BucketSpec(batch=2, seq=16), BucketSpec(batch=2, seq=48))


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n) for n in lens]


def _pair(**kw):
    """The reference model and params, and the port's on the same
    weights (granite-3-2b smoke, fp32)."""
    jcfg = dataclasses.replace(jax_get_config("granite-3-2b").smoke(), **kw)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return jm, jp, tm, bridge.params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def lm():
    return _pair()


def _tokens(res):
    return [r.tokens for r in res]


# ----------------------------------------------------------------- scheduler


def _req(rid, plen, new=4):
    return Request(rid=rid, prompt=np.zeros(plen, np.int32), max_new_tokens=new)


def test_bucket_routing_smallest_fit():
    s = SlotScheduler((BucketSpec(2, 16), BucketSpec(2, 64)))
    assert s.bucket_for(_req(0, 4)) == 0
    assert s.bucket_for(_req(1, 13)) == 1
    assert s.bucket_for(_req(2, 60, new=8)) is None
    with pytest.raises(ValueError):
        s.submit(_req(3, 100))


def test_admission_fifo_per_bucket_no_cross_blocking():
    s = SlotScheduler((BucketSpec(1, 16), BucketSpec(1, 64)))
    for rid, plen in ((0, 4), (1, 4), (2, 30), (3, 4)):
        s.submit(_req(rid, plen))
    adm = s.admit()
    assert [r.rid for _, r in adm[0]] == [0]
    assert [r.rid for _, r in adm[1]] == [2]
    assert [r.rid for r in s.queue] == [1, 3]
    assert s.admit() == {}
    s.release(0, adm[0][0][0])
    assert [r.rid for _, r in s.admit()[0]] == [1]
    assert s.occupancy()["b1xs16"] == 1.0


def test_no_spill_to_larger_bucket():
    s = SlotScheduler((BucketSpec(1, 16), BucketSpec(1, 64)))
    s.submit(_req(0, 4))
    s.submit(_req(1, 4))
    s.admit()
    assert s.occupancy()["b1xs64"] == 0.0
    assert [r.rid for r in s.queue] == [1]


def test_default_bucket_layout_pow2():
    bs = default_bucket_layout(128, slots=8, n_buckets=2)
    assert [(b.batch, b.seq) for b in bs] == [(4, 64), (4, 128)]


def test_scheduler_is_a_copy_not_an_import():
    import repro_torch.serve.scheduler as ours
    from repro.serve import scheduler as theirs
    assert ours.SlotScheduler is not theirs.SlotScheduler
    assert ours.default_bucket_layout(256, slots=6, n_buckets=3) == tuple(
        BucketSpec(b.batch, b.seq) for b in theirs.default_bucket_layout(256, slots=6,
                                                                         n_buckets=3))


# -------------------------------------------------------------------- engine


@pytest.mark.parametrize("lens,new,seed", [
    ((3, 9, 14), 5, 1),                 # test_engine_matches_per_token_reference's prompts
    ((3, 7, 12, 25, 5, 18), 6, 0),      # more requests than slots: admission mid-flight
])
def test_generate_matches_reference_token_for_token(lm, lens, new, seed):
    jm, jp, tm, tp = lm
    prompts = _prompts(tm.cfg.vocab_size, lens, seed=seed)
    ref = jax_serve.generate(jm, jp, prompts, max_new_tokens=new, buckets=BUCKETS)
    res, eng = serve.generate(tm, tp, prompts, max_new_tokens=new, buckets=BUCKETS,
                              device="cpu", return_engine=True)
    assert _tokens(res) == _tokens(ref)
    assert [r.bucket for r in res] == [r.bucket for r in ref]
    assert all(len(r.tokens) == new for r in res)
    assert all(r.t_done >= r.t_first >= r.t_submit > 0 for r in res)
    if len(lens) > 4:
        assert eng.n_prefill_calls > 2     # more than one admission wave per bucket


@pytest.mark.parametrize("chunk", [0, 8])
def test_admission_beside_running_slots_matches_reference(lm, chunk):
    """Staggered budgets: a slot frees while its neighbour keeps
    decoding, so each later prefill runs beside a live slot. The
    reference keeps the running slot's cache by selecting rows after the
    prefill; the port must not write into it at all."""
    jm, jp, tm, tp = lm
    prompts = _prompts(tm.cfg.vocab_size, (3, 7, 5, 6, 4), seed=6)
    budgets = (9, 3, 6, 2, 5)
    buckets = (BucketSpec(2, 32),)
    out = []
    for eng in (jax_serve.ServeEngine(jm, jp, buckets, prefill_chunk=chunk),
                ServeEngine(tm, tp, buckets, prefill_chunk=chunk, device="cpu")):
        for rid, (p, n) in enumerate(zip(prompts, budgets)):
            eng.submit(Request(rid=rid, prompt=np.asarray(p, np.int32), max_new_tokens=n))
        eng.run_until_drained()
        out.append([eng.results[i].tokens for i in range(len(prompts))])
        assert eng.n_prefill_calls == 4          # rids 2, 3 and 4 join a running slot
    assert out[1] == out[0]
    assert [len(t) for t in out[1]] == list(budgets)


def test_chunked_prefill_matches_single_chunk_and_reference(lm):
    jm, jp, tm, tp = lm
    prompts = _prompts(tm.cfg.vocab_size, (3, 12, 25), seed=4)
    whole = serve.generate(tm, tp, prompts, max_new_tokens=4, buckets=BUCKETS, device="cpu")
    chunked = serve.generate(tm, tp, prompts, max_new_tokens=4, buckets=BUCKETS,
                             prefill_chunk=8, device="cpu")
    ref = jax_serve.generate(jm, jp, prompts, max_new_tokens=4, buckets=BUCKETS,
                             prefill_chunk=8)
    assert _tokens(chunked) == _tokens(whole) == _tokens(ref)


def test_eos_early_stop(lm):
    _, _, tm, tp = lm
    prompts = _prompts(tm.cfg.vocab_size, (3, 7), seed=0)
    res = serve.generate(tm, tp, prompts, max_new_tokens=6, buckets=BUCKETS, device="cpu")
    eos = res[0].tokens[1]
    res_e = serve.generate(tm, tp, prompts, max_new_tokens=6, eos_id=eos, buckets=BUCKETS,
                           device="cpu")
    cut = res[0].tokens.index(eos) + 1
    assert res_e[0].tokens == res[0].tokens[:cut]


def test_ring_buffer_generation_matches_reference():
    """A sliding-window ring cache of 12 slots; generation runs past the
    window so the ring wraps."""
    jm, jp, tm, tp = _pair(sliding_window=12, cache_ring=True)
    prompts = _prompts(tm.cfg.vocab_size, (4, 9), seed=3)
    kw = dict(max_new_tokens=10, buckets=(BucketSpec(2, 32),))
    ref = jax_serve.generate(jm, jp, prompts, **kw)
    res = serve.generate(tm, tp, prompts, device="cpu", **kw)
    assert all(len(r.tokens) == 10 for r in res)
    assert _tokens(res) == _tokens(ref)


@pytest.mark.parametrize("scan", [False, True])
def test_engine_matches_its_own_per_token_loop(scan):
    """The engine (chunked prefill into gathered slots, per-row decode)
    against teacher-forcing one request at a time with the port's
    ``prefill_into_cache``, in both parameter layouts."""
    cfg = dataclasses.replace(get_config("granite-3-2b").smoke(), scan_layers=scan)
    tm = build_model(cfg)
    tp = tm.init(torch.Generator().manual_seed(3))
    prompts = _prompts(cfg.vocab_size, (3, 9, 14, 6), seed=5)
    res = serve.generate(tm, tp, prompts, max_new_tokens=5, buckets=BUCKETS, device="cpu")
    for r, p in zip(res, prompts):
        S = 16 if len(p) + 5 <= 16 else 48
        cache = tm.init_cache(1, S, "cpu")
        tok, cache = prefill_into_cache(tm, tp, torch.as_tensor(p[None], dtype=torch.int32),
                                        cache)
        out = [int(tok[0])]
        while len(out) < 5:
            logits, cache = tm.decode_step(tp, torch.tensor([[out[-1]]]), cache,
                                           len(p) + len(out) - 1)
            out.append(int(torch.argmax(logits[0, -1])))
        assert r.tokens == out


def test_engine_rejects_a_model_without_prefill():
    cnn = build_model(get_config("squeezenet-dr"))
    with pytest.raises(ValueError, match="attention-backed"):
        ServeEngine(cnn, None, (BucketSpec(1, 16),), device="cpu")


def test_entry_points_raise_without_a_card(monkeypatch, lm):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tm, tp = lm
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tm, tp, BUCKETS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.generate(tm, tp, [np.array([1, 2])], max_new_tokens=2, buckets=BUCKETS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serve("granite-3-2b")
    cnn = build_model(get_config("squeezenet-dr"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImageClassifier(cnn, {}, (1,))


def test_run_serve_on_the_cpu():
    gen, info = run_serve("granite-3-2b", batch=2, prompt_len=5, tokens=4, device="cpu")
    assert gen.shape == (2, 4) and gen.dtype == np.int32
    assert info["device"] == "cpu" and info["tok_per_s"] > 0


# ------------------------------------------------------------ CNN classifier


def test_image_classifier_matches_reference():
    """squeezenet-dr on the reference's weights: labels equal, confidence
    at atol 1e-5, the same bucket per request."""
    jm = jax_build_model(jax_get_config("squeezenet-dr"))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(get_config("squeezenet-dr"))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    imgs = np.random.default_rng(0).normal(size=(6, 32, 32, 3)).astype(np.float32)
    ref = jax_serve.ImageClassifier(jm, jp, (1, 4)).classify(
        [jax_serve.Request(rid=i, image=imgs[i]) for i in range(6)])
    out = serve.classify(tm, tp, list(imgs), batch_buckets=(1, 4), device="cpu")
    assert [o.bucket for o in out] == [o.bucket for o in ref] == ["b4"] * 4 + ["b1"] * 2
    assert [o.label for o in out] == [o.label for o in ref]
    np.testing.assert_allclose([o.confidence for o in out], [o.confidence for o in ref],
                               rtol=0, atol=1e-5)


def test_image_classifier_compile_counts_match_reference():
    """Two drains over buckets (1, 4, 8): each bucket in use counts 1,
    as the reference's per-bucket programs do, and b8, never used, 0."""
    jm = jax_build_model(jax_get_config("squeezenet-dr"))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(get_config("squeezenet-dr"))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp))
    imgs = np.random.default_rng(0).normal(size=(6, 32, 32, 3)).astype(np.float32)
    ref = jax_serve.ImageClassifier(jm, jp, (1, 4, 8))
    clf = ImageClassifier(tm, tp, (1, 4, 8), device="cpu")
    for n in (6, 5):
        ref.classify([jax_serve.Request(rid=i, image=imgs[i]) for i in range(n)])
        clf.classify([Request(rid=i, image=imgs[i]) for i in range(n)])
    assert clf.compile_counts() == ref.compile_counts() == {"b1": 1, "b4": 1, "b8": 0}


@pytest.mark.parametrize("client", ["mean", "client:2"])
def test_reduce_clients_matches_reference(client):
    rng = np.random.default_rng(2)
    tree = {"w": rng.normal(size=(4, 3, 5)).astype(np.float32),
            "blocks": [{"b": rng.normal(size=(4, 7)).astype(np.float32)}]}
    weights = np.array([1.0, 3.0, 0.5, 2.0], np.float32)
    ref = jax_serve.reduce_clients(jax.tree.map(jnp.asarray, tree), weights, client)
    got = serve.reduce_clients(bridge.tree_from_numpy(tree), weights, client)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(ref["w"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["blocks"][0]["b"].numpy(), np.asarray(ref["blocks"][0]["b"]),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown reduction"):
        serve.reduce_clients(bridge.tree_from_numpy(tree), weights, "median")
