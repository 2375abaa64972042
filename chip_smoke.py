#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card. Run from the repository root::

    python3 chip_smoke.py

It needs a CUDA device and the repository's ``src/``; without either it
exits non-zero and prints no result. It imports nothing of JAX. Phases:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, in parallel) and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card at
   the main path's shapes and a few harder ones, and time kernel, plain
   version and a one-call PyTorch yardstick;
3. drive the main path: ``SwarmTrainer`` on squeezenet-dr at full width
   on the full Table I (3,657 images at 32 px, 14 clinics), adam at lr
   2e-3, batch 8, 12 local steps, k=3, p1=0.9, p2=0.8, 20 k-means
   iterations, 3 rounds, with every kernel's launch count read from
   that run alone; then profile one more round (device time by kernel,
   the device's busy share);
4. run one round from the same state and the same injected draws on
   the card and on the CPU (the plain versions there) and compare.

Any failure raises. The line before the last is one JSON object
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

ROUNDS = 3
LOCAL_STEPS = 12
BATCH = 8
K = 3
KMEANS_ITERS = 20
STATS_PASSES_PER_ROUND = 1        # one swarm_distribution_matrix per bso round


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(torch, fn, reps: int = 100, trials: int = 7) -> float:
    """Median over ``trials`` of the mean time of ``reps`` calls,
    between CUDA events, after a warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(torch, fn) -> float:
    """Device time of ``fn``'s launches alone: ``fn`` captured once in a
    CUDA graph, the replay timed as :func:`cuda_ms` times a call. The
    host's per-call cost (Python, allocation, launch) drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(torch, graph.replay)


def bound_ms(n_bytes: float, n_ops: float):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / FP32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# ------------------------------------------------------------------ phase 2


def check_param_stats(torch, dev, leaves):
    """K1 against its plain version. Tolerance: mean rtol 1e-5 / atol
    1e-6, var rtol 1e-4 / atol 1e-6 (fp32 Welford partials merged in
    another order than the plain two-pass sums, up to 1.7e7 elements)."""
    from repro_torch.kernels import param_stats, ref
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [("path", x) for x in leaves]
    cases += [("path-bf16", x.to(torch.bfloat16)) for x in leaves]
    cases.append(("cancellation", torch.randn((3, 1 << 20), generator=gen, device=dev)
                  * 0.5 + 1e4))
    cases.append(("ragged", torch.randn((5, 1_000_003), generator=gen, device=dev)))
    cases.append(("ragged-small", torch.randn((14, 7), generator=gen, device=dev)))
    cases.append((">16M", torch.randn((1, (1 << 24) + 5), generator=gen, device=dev) + 0.3))
    path_err = 0.0
    for name, x in cases:
        m, v = param_stats.param_stats_batched(x)
        rm, rv = ref.param_stats_batched(x)
        torch.cuda.synchronize()
        torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-6, msg=lambda s: f"{name} mean: {s}")
        torch.testing.assert_close(v, rv, rtol=1e-4, atol=1e-6, msg=lambda s: f"{name} var: {s}")
        if name == "path":
            path_err = max(path_err, (m - rm).abs().max().item(), (v - rv).abs().max().item())
        if name == "cancellation":
            assert (v - 0.25).abs().max().item() < 0.01, f"cancellation var {v.tolist()}"
    m, v = param_stats.param_stats_batched(torch.zeros((2, 0), device=dev))
    assert torch.isnan(m).all() and torch.isnan(v).all(), "empty rows must give NaN"
    log(f"[kernels] param_stats_batched: {len(cases)} cases agree with the plain version; "
        f"max abs err on the path leaves {path_err:.3e}")
    return path_err


def time_param_stats(torch, leaves):
    from repro_torch.kernels import param_stats, ref

    def kernel():
        for x in leaves:
            param_stats.param_stats_batched(x)

    def plain():
        for x in leaves:
            ref.param_stats_batched(x)

    def library():
        for x in leaves:
            torch.var_mean(x.view(x.shape[0], -1), 1, correction=0)

    ms, plain_ms, lib_ms = cuda_ms(torch, kernel), cuda_ms(torch, plain), cuda_ms(torch, library)
    log(f"[kernels] param_stats_batched device time alone (CUDA graph of the 28 calls): "
        f"kernel {graph_ms(torch, kernel):.4f} ms, plain {graph_ms(torch, plain):.4f} ms, "
        f"var_mean {graph_ms(torch, library):.4f} ms")
    n_el = sum(x.numel() for x in leaves)
    n_bytes = sum(x.numel() * x.element_size() + 2 * x.shape[0] * 4 for x in leaves)
    # 4 fp32 operations an element: a sum for the mean, then subtract,
    # square and add for the squared deviations
    b, by = bound_ms(n_bytes, 4 * n_el)
    return ms, plain_ms, lib_ms, b, by


def check_kmeans_assign(torch, dev, X, C):
    from repro_torch.kernels import kmeans_assign, ref
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [("path", X, C),
             ("wide", torch.randn((1000, 260), generator=gen, device=dev),
              torch.randn((37, 260), generator=gen, device=dev)),
             ("ties", torch.zeros((130, 4), device=dev), torch.zeros((5, 4), device=dev))]
    for name, x, c in cases:
        got = kmeans_assign.kmeans_assign(x, c)
        expect = ref.kmeans_assign(x, c)
        torch.cuda.synchronize()
        if not torch.equal(got, expect):
            bad = int((got != expect).sum())
            raise AssertionError(f"kmeans_assign {name}: {bad} of {got.numel()} ids differ")
    log(f"[kernels] kmeans_assign: {len(cases)} cases equal to the plain version")
    return 0.0


def time_kmeans_assign(torch, X, C):
    from repro_torch.kernels import kmeans_assign, ref
    ms = cuda_ms(torch, lambda: kmeans_assign.kmeans_assign(X, C), reps=500)
    plain_ms = cuda_ms(torch, lambda: ref.kmeans_assign(X, C), reps=500)
    lib_ms = cuda_ms(torch, lambda: torch.cdist(X, C).argmin(1), reps=500)
    log(f"[kernels] kmeans_assign device time alone (CUDA graph of one call): "
        f"kernel {graph_ms(torch, lambda: kmeans_assign.kmeans_assign(X, C)):.4f} ms, "
        f"plain {graph_ms(torch, lambda: ref.kmeans_assign(X, C)):.4f} ms, "
        f"cdist+argmin {graph_ms(torch, lambda: torch.cdist(X, C).argmin(1)):.4f} ms")
    N, F = X.shape
    Kc = C.shape[0]
    n_bytes = (N * F + Kc * F) * 4 + N * 4
    n_ops = 2 * N * Kc * F + 2 * N * F + 2 * Kc * F + 3 * N * Kc
    b, by = bound_ms(n_bytes, n_ops)
    return ms, plain_ms, lib_ms, b, by


# ------------------------------------------------------------- phases 3, 4


def main_path(torch, clients, dev):
    from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config
    from repro_torch.core.swarm import SwarmTrainer
    from repro_torch.kernels import kmeans_assign, param_stats
    from repro_torch.models import build_model

    swarm = SwarmConfig(n_clients=14, n_clusters=K, p1=0.9, p2=0.8,
                        kmeans_iters=KMEANS_ITERS, local_steps=LOCAL_STEPS, rounds=ROUNDS)
    tr = SwarmTrainer(build_model(get_config("squeezenet-dr")), clients, swarm,
                      OptimizerConfig(name="adam", lr=2e-3), seed=0, batch_size=BATCH,
                      device=dev)
    imgs = tr.swarm_data.train["images"]
    log(f"[main] squeezenet-dr, 14 clients, train stack {tuple(imgs.shape)} = "
        f"{imgs.numel() * imgs.element_size() / 1e6:.1f} MB on {imgs.device}")

    param_stats.param_stats_batched.launches = 0
    kmeans_assign.kmeans_assign.launches = 0
    round_s = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        lg = tr.round()
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        log(f"[main] round {lg.round}: {round_s[-1]:.3f} s  val_acc={lg.mean_val_acc:.4f} "
            f"loss={lg.train_loss:.4f} assignments={lg.assignments.tolist()} "
            f"centers={lg.centers.tolist()} events={lg.events}")
        assert math.isfinite(lg.train_loss), "train loss is not finite"
        assert 0.0 <= lg.mean_val_acc <= 1.0, "val accuracy outside [0, 1]"
    launches = {"param_stats_batched": param_stats.param_stats_batched.launches,
                "kmeans_assign": kmeans_assign.kmeans_assign.launches}
    n_leaves = sum(1 for _ in _leaves(tr.params))
    want = {"param_stats_batched": n_leaves * ROUNDS * STATS_PASSES_PER_ROUND,
            "kmeans_assign": (KMEANS_ITERS + 1) * ROUNDS}
    log(f"[main] launches {launches}, expected {want}")
    assert launches == want, f"launch counts {launches} != {want}"
    test_acc = tr.mean_accuracy("test")
    assert 0.0 <= test_acc <= 1.0
    log(f"[main] Eq. 3 test accuracy after {ROUNDS} rounds: {test_acc:.4f}; "
        f"round seconds {[round(s, 4) for s in round_s]}")
    return tr, launches, round_s


def _leaves(tree):
    from repro_torch.utils.tree import tree_leaves
    return tree_leaves(tree)


def profile_round(torch, tr) -> None:
    """One more round of the main path under ``torch.profiler``: device
    time by kernel and the device's busy share of the round's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.round()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    log(f"[profile] round of {wall_ms:.1f} ms wall: {len(spans)} device events, device busy "
        f"{busy_us / 1e3:.1f} ms ({busy_us / 1e3 / wall_ms:.1%}), idle {1 - busy_us / 1e3 / wall_ms:.1%}")
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)
    for line in table.splitlines():
        log(f"[profile] {line}")


def card_vs_cpu(torch, tr, clients, local_steps: int, eps: float):
    """One round on the card and on the CPU from the trainer's state and
    the same draws. Returns (max |param diff|, card metrics, cpu metrics)."""
    from dataclasses import replace

    from repro_torch.core import engine
    from repro_torch.core.bso import draw_bso
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.configs import OptimizerConfig
    from repro_torch.utils.tree import tree_map

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(11)
    data_cpu = engine.make_swarm_data(tr.cfg, clients, device=cpu)
    n = len(clients)
    draws = engine.RoundDraws(
        batch_idx=torch.stack([engine.draw_batch_idx(gen, data_cpu.train_n, BATCH)
                               for _ in range(local_steps)]),
        kmeans_init_idx=torch.randperm(n, generator=gen)[:K],
        bso=draw_bso(K, n, gen, cpu))
    cfg = replace(tr.engine_cfg, local_steps=local_steps,
                  opt=make_optimizer(OptimizerConfig(name="adam", lr=2e-3, eps=eps)))
    s_card = engine.copy_state(tr.state)
    s_cpu = s_card._replace(params=tree_map(lambda t: t.cpu(), s_card.params),
                            opt_state=tree_map(lambda t: t.cpu(), s_card.opt_state),
                            generator=gen, n_samples=s_card.n_samples.cpu())
    new_card, m_card = engine.swarm_round(s_card, tr.swarm_data, cfg, draws)
    new_cpu, m_cpu = engine.swarm_round(s_cpu, data_cpu, cfg, draws)
    torch.cuda.synchronize()
    diff = max((a.cpu() - b).abs().max().item()
               for a, b in zip(_leaves(new_card.params), _leaves(new_cpu.params)))
    return diff, m_card, m_cpu


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.diststats import swarm_distribution_matrix
    from repro_torch.data.dr import make_dr_swarm_data, scale_table
    from repro_torch.kernels import _build

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    # the plain versions and the comparisons run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- phase 1: build
    t0 = time.perf_counter()
    build_logs = _build.build()
    build_s = time.perf_counter() - t0
    for k, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {k}: {line.strip()}")
    card = card_line()
    log(f"[build] {len(build_logs)} kernel libraries built in {build_s:.2f} s on {name}")
    log(card)

    # --- phase 2: kernels against their plain versions, at the path's shapes
    clients = make_dr_swarm_data(image_size=32, seed=0, table=scale_table(1))
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_stack
    model = build_model(get_config("squeezenet-dr"))
    gen = torch.Generator(device=dev).manual_seed(0)
    stacked = tree_stack([model.init(gen) for _ in range(14)])
    leaves = [x.contiguous() for x in _leaves(stacked)]
    feats = swarm_distribution_matrix(stacked)                  # (14, 56), as on the path
    cents = feats[torch.randperm(14, generator=gen, device=dev)[:K]].contiguous()
    k1_err = check_param_stats(torch, dev, leaves)
    k2_err = check_kmeans_assign(torch, dev, feats, cents)
    k1 = time_param_stats(torch, leaves)
    k2 = time_kmeans_assign(torch, feats, cents)
    log(f"[kernels] param_stats_batched, 28 leaves x 14 clients: kernel {k1[0]:.4f} ms, "
        f"plain {k1[1]:.4f} ms, var_mean {k1[2]:.4f} ms, bound {k1[3]:.6f} ms ({k1[4]})")
    log(f"[kernels] kmeans_assign (14,56)x(3,56): kernel {k2[0]:.4f} ms, plain {k2[1]:.4f} ms, "
        f"cdist+argmin {k2[2]:.4f} ms, bound {k2[3]:.7f} ms ({k2[4]})")

    # --- phase 3: the main path, with launch counts from this run alone
    tr, launches, round_s = main_path(torch, clients, dev)

    profile_round(torch, tr)

    # --- phase 4: the same round on the card and on the CPU
    torch.backends.cudnn.deterministic = True
    diff, m_card, m_cpu = card_vs_cpu(torch, tr, clients, local_steps=2, eps=1e-6)
    log(f"[card-vs-cpu] 2 local steps, adam eps 1e-6: assignments "
        f"{m_card.assignments.tolist()} / {m_cpu.assignments.tolist()}, centers "
        f"{m_card.centers.tolist()} / {m_cpu.centers.tolist()}, max |param diff| {diff:.3e}, "
        f"max |val acc diff| {(m_card.val_acc.cpu() - m_cpu.val_acc).abs().max().item():.3e}")
    assert torch.equal(m_card.assignments.cpu(), m_cpu.assignments), "assignments differ"
    assert torch.equal(m_card.centers.cpu(), m_cpu.centers), "centers differ"
    # atol 1e-4: 5% of one adam step at lr 2e-3 (cuDNN and the CPU sum
    # the convolutions in other orders)
    assert diff <= 1e-4, f"card and CPU params differ by {diff}"
    diff12, _, _ = card_vs_cpu(torch, tr, clients, local_steps=LOCAL_STEPS, eps=1e-8)
    log(f"[card-vs-cpu] main-path config (12 local steps, adam eps 1e-8), not asserted: "
        f"max |param diff| {diff12:.3e}")

    kernels = [
        {"name": "param_stats_batched", "route": "cuda",
         "source": "src/repro_torch/csrc/param_stats.cu",
         "replaces": "src/repro/kernels/param_stats.py:92",
         "launches": launches["param_stats_batched"], "max_abs_err": k1_err,
         "ms": k1[0], "plain_ms": k1[1], "bound_ms": k1[3], "bound_by": k1[4],
         "library_ms": k1[2]},
        {"name": "kmeans_assign", "route": "cuda",
         "source": "src/repro_torch/csrc/kmeans_assign.cu",
         "replaces": "src/repro/kernels/kmeans_assign.py:44",
         "launches": launches["kmeans_assign"], "max_abs_err": k2_err,
         "ms": k2[0], "plain_ms": k2[1], "bound_ms": k2[3], "bound_by": k2[4],
         "library_ms": k2[2]},
    ]
    log(f"[done] {time.perf_counter() - t_all:.1f} s in all; "
        f"round seconds {round_s}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
