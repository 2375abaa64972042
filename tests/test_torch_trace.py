"""The port's own spans (``repro_torch.utils.trace``) on the CPU, over one
round of a tiny LM swarm: with no profiler a round opens no
``record_function``; under ``torch.profiler`` its events hold each local
step's ``train.gradient`` around ``train.forward``, then
``train.optimizer``; the round's results are the same bitwise either
way; a span is a shared null context without a profiler and a
``record_function`` with one."""
import dataclasses
from contextlib import nullcontext

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config
from repro_torch.core import engine
from repro_torch.core.swarm import SwarmTrainer
from repro_torch.data.tokens import make_token_swarm_data
from repro_torch.models import build_model
from repro_torch.utils import trace
from repro_torch.utils.tree import tree_leaves
from torch_parity import pin_torch_threads

pin_torch_threads()

N_CLIENTS = 3
LOCAL_STEPS = 2
# (name, the innermost program span around it) of every span a plain
# round opens, and how many
TREE = {("train.gradient", None): LOCAL_STEPS, ("train.forward", "train.gradient"): LOCAL_STEPS,
        ("train.optimizer", None): LOCAL_STEPS}
NAMES = {n for n, _ in TREE}


def _trainer():
    cfg = dataclasses.replace(get_config("granite-3-2b").smoke(), n_layers=1, d_model=32,
                              n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64)
    clients = make_token_swarm_data(N_CLIENTS, cfg.vocab_size, n_seqs=6, seq_len=8)
    swarm = SwarmConfig(n_clients=N_CLIENTS, n_clusters=2, local_steps=LOCAL_STEPS, rounds=1)
    return SwarmTrainer(build_model(cfg), clients, swarm, OptimizerConfig(lr=2e-3), seed=3,
                        batch_size=2, device="cpu")


def _draws(tr):
    return engine.draw_round(torch.Generator().manual_seed(11), tr.swarm_data.train_n,
                             tr.engine_cfg)


def _round(tr, start, draws, profiled: bool):
    """One round from a copy of ``start``: (state, log, profiler or None)."""
    tr.state = engine.copy_state(start)
    with profile(activities=[ProfilerActivity.CPU]) if profiled else nullcontext() as prof:
        log = tr.round(draws=draws)
    return tr.state, log, prof


def _program_parent(e):
    p = e.cpu_parent
    while p is not None and p.name not in NAMES:
        p = p.cpu_parent
    return None if p is None else p.name


def test_a_round_without_a_profiler_opens_no_span(monkeypatch):
    opened = []
    real = trace.record_function
    monkeypatch.setattr(trace, "record_function", lambda name: opened.append(name) or real(name))
    tr = _trainer()
    tr.round(draws=_draws(tr))
    assert opened == []


def test_a_profiled_round_gives_the_span_tree():
    tr = _trainer()
    _, _, prof = _round(tr, tr.state, _draws(tr), profiled=True)
    got = {}
    for e in prof.events():
        if e.name in NAMES:
            key = (e.name, _program_parent(e))
            got[key] = got.get(key, 0) + 1
    assert got == TREE
    steps = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.name in ("train.gradient", "train.optimizer"))
    assert [n for _, n in steps] == ["train.gradient", "train.optimizer"] * LOCAL_STEPS


def test_the_round_is_the_same_bitwise_with_the_profiler_on_and_off():
    tr = _trainer()
    start, draws = tr.state, _draws(tr)
    on, log_on, _ = _round(tr, start, draws, profiled=True)
    off, log_off, _ = _round(tr, start, draws, profiled=False)
    for tree in ("params", "opt_state"):
        a, b = tree_leaves(getattr(on, tree)), tree_leaves(getattr(off, tree))
        assert len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))
    assert log_on.train_loss == log_off.train_loss
    assert log_on.mean_val_acc == log_off.mean_val_acc


def test_a_span_is_a_null_context_without_a_profiler_and_a_record_function_with_one():
    assert trace.span("outer") is trace.span("inner") is trace._OFF
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            torch.ones(3).sum()
    events = {e.name: e for e in prof.events()}
    assert "outer" in events and events["aten::sum"].cpu_parent.name == "outer"
    assert trace.span("after") is trace._OFF
