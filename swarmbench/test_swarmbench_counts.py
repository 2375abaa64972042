"""The generators, weights and draws are deterministic in the seed; the
FLOP counts equal ``torch.utils.flop_counter.FlopCounterMode`` over the
plain reference, and K1's bytes the leaves' bytes, at small sizes; the
metric readers read a trace summary and stay silent on an empty one."""
from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from swarmbench import tiny

tiny.pin_threads()
SEEDS = (2**31 + 11, 5)
ENGINE = "repro_torch.core.engine"
READERS = ["local_phase_ms", "eval_ms", "coordinator_ms", "aggregate_ms",
           "param_stats_roofline", "device_idle_pct", "mfu_pct"]


def _same(a, b):
    return all(torch.equal(torch.as_tensor(x), torch.as_tensor(y)) for x, y in zip(a, b))


def _client_arrays(clients):
    return [x for c in clients for s in ("train", "val", "test") for x in c[s]]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_traffic_is_deterministic_in_the_seed(cell):
    from swarmbench.drivers import swarm_round as D
    ctx = tiny.context(cell)
    w = ctx.workload
    a = D.make_clients(SEEDS[0], w, ctx.device)
    b = D.make_clients(SEEDS[0], w, ctx.device)
    c = D.make_clients(SEEDS[1], w, ctx.device)
    assert _same(_client_arrays(a), _client_arrays(b))
    assert not _same(_client_arrays(a), _client_arrays(c))
    assert [x["n_train"] for x in a] == [x["n_train"] for x in c]


def test_weights_and_draws_are_deterministic_in_the_seed():
    from swarmbench.harness.draws import DrawPool
    from swarmbench.harness.weights import make_weights
    layout = [("a/w", (3, 2, 4)), ("a/b", (3, 4)), ("n/scale", (3, 4))]
    rules = [{"match": "/w$", "kind": "normal", "fan_in_axes": [0], "gain": 2.0},
             {"match": "/b$", "kind": "zeros"}, {"match": "scale$", "kind": "ones"}]
    w1, w2 = (make_weights(layout, rules, SEEDS[0], "cpu") for _ in range(2))
    w3 = make_weights(layout, rules, SEEDS[1], "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1) and not torch.equal(w1["a/w"], w3["a/w"])
    assert torch.all(w1["a/b"] == 0) and torch.all(w1["n/scale"] == 1)
    train_n = torch.tensor([5, 1, 9])
    p1, p2 = (DrawPool(SEEDS[0], train_n, 2, 4, 2, 8) for _ in range(2))
    assert torch.equal(p1(3).batch_idx, p2(3).batch_idx) and torch.equal(p1(3).g, p2(3).g)
    assert torch.all(p1(0).batch_idx < train_n[None, :, None])
    assert not torch.equal(p1(0).batch_idx, p1(1).batch_idx)


def test_sub_seeds_take_any_whole_number():
    from swarmbench.harness.seeds import sub_seed
    seeds = [0, 1, -1, 2**31 + 5, 2**40 + 3, 2**70]
    got = [sub_seed(s, "data") for s in seeds]
    assert len(set(got)) == len(got) and all(0 <= g < 2**63 for g in got)
    assert sub_seed(7, "data") != sub_seed(7, "weights")


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_dense_lm_flops_equal_the_counter_over_the_reference():
    from swarmbench.flops import dense_lm as flops
    from swarmbench.harness.weights import make_weights
    from swarmbench.reference import dense_lm as ref
    ctx = tiny.context(tiny.CELLS[0])
    cfg = ctx.config["model"]
    d, H, KV, hd = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    ff, V, L = cfg["intermediate_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    pre = "layers/period0/"
    layout = [("embedding/table", (1, V, d)), ("final_norm/scale", (1, d)),
              (pre + "attn/wq", (1, L, d, H * hd)), (pre + "attn/wk", (1, L, d, KV * hd)),
              (pre + "attn/wv", (1, L, d, KV * hd)), (pre + "attn/wo", (1, L, H * hd, d)),
              (pre + "attn_norm/scale", (1, L, d)), (pre + "mlp_norm/scale", (1, L, d)),
              (pre + "mlp/wg", (1, L, d, ff)), (pre + "mlp/wi", (1, L, d, ff)),
              (pre + "mlp/wo", (1, L, ff, d))]
    p = {k: v[0].requires_grad_() for k, v in
         make_weights(layout, ctx.config["init"], 3, "cpu").items()}
    B, S = 2, 12
    toks = torch.randint(0, V, (B, S))
    assert _counted(lambda: ref.forward(p, toks, cfg)) == B * flops.forward(cfg, S)
    assert _counted(lambda: ref.forward(p, toks, cfg).sum().backward()) == \
        B * flops.train(cfg, S)


def test_param_stats_bytes_are_the_leaves_read_once_and_the_stats_written_once():
    from swarmbench.flops import param_stats
    shapes = [(6, 49155, 2048), (6, 2, 2048, 512), (6, 2048)]
    leaf_bytes = sum(math.prod(s) * 4 for s in shapes)
    assert param_stats.bytes_moved(shapes) == leaf_bytes + 6 * 3 * 2 * 4


def _summary(**kw):
    from swarmbench.harness.trace import TraceSummary
    base = dict(profiled_rounds=4, window_us=2e6, busy_us=1.5e6,
                span_device_us={f"{ENGINE}:local_phase": 1.2e6, f"{ENGINE}:eval_swarm": 8e4,
                                f"{ENGINE}:_coordinate": 4e4, f"{ENGINE}:_aggregate": 2e4},
                kernel_us={"param_stats_kernel": (4, 40.0), "other": (9, 10.0)},
                facts={"param_stats_bytes": 3.35e6, "round_flops": 6.7e12, "peak_flops": 67e12,
                       "unprofiled_rounds": 10, "unprofiled_s": 5.0})
    base.update(kw)
    return TraceSummary(**base)


def test_metric_readers_read_a_summary_and_stay_silent_on_nothing():
    import importlib
    names = READERS
    got = {n: importlib.import_module(f"swarmbench.metrics.{n}").read(_summary())
           for n in names}
    assert got["local_phase_ms"] == pytest.approx(300.0)
    assert got["aggregate_ms"] == pytest.approx(5.0)
    assert got["param_stats_roofline"] == pytest.approx(10.0)   # 1 us bound / 10 us a round
    assert got["device_idle_pct"] == pytest.approx(25.0)
    assert got["mfu_pct"] == pytest.approx(20.0)
    empty = _summary(busy_us=0.0, span_device_us={}, kernel_us={}, facts={})
    assert all(importlib.import_module(f"swarmbench.metrics.{n}").read(empty) is None
               for n in names)


def test_the_traced_run_wraps_the_functions_its_readers_name():
    """A reader's SPAN names a function the program has, and the driver
    wraps exactly the SPANs of the readers it is given."""
    import importlib

    from swarmbench.drivers import swarm_round as D
    readers = D.metric_readers(READERS)
    spans = {r.SPAN for r in readers if hasattr(r, "SPAN")}
    assert spans == {f"{ENGINE}:{f}" for f in ("local_phase", "eval_swarm", "_coordinate",
                                               "_aggregate")}
    for spec in spans:
        module, func = spec.split(":")
        assert callable(getattr(importlib.import_module(module), func)), spec
    wrappers = D.span_wrappers(readers)
    assert {f"{m}:{f}" for m, fs in wrappers.items() for f in fs} == spans
    assert D.span_wrappers(D.metric_readers(["device_idle_pct", "mfu_pct"])) == {}


def test_readers_facts_come_from_the_cells_shapes():
    """The counts a reader needs come from its own ``facts``: K1's bytes
    from the leaves' shapes, the round's FLOPs from the configuration's
    module."""
    from swarmbench.drivers import swarm_round as D
    from swarmbench.flops import dense_lm, param_stats
    ctx = tiny.context(tiny.CELLS[0])
    setup, _ = D.prepare(ctx.seed, ctx.workload, ctx.config, ctx.device)
    facts = {}
    for r in D.metric_readers(READERS):
        if hasattr(r, "facts"):
            facts.update(r.facts(setup))
    val_rows = sum(len(c["val"][1]) for c in setup.clients)
    assert facts == {
        "param_stats_bytes": param_stats.bytes_moved([s for _, s in setup.layout]),
        "round_flops": dense_lm.round_flops(ctx.workload, ctx.config["model"], val_rows),
        "peak_flops": 989e12}
