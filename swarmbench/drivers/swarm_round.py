"""Driver ``swarm_round``: the window drives the program's normal entry,
``repro_torch.core.swarm.SwarmTrainer.round(draws=...)``, which calls
``engine.swarm_round`` (local phase, eval, the coordinator, Eq. 2).

A run:

1. makes the clients' data on the device from the seed (the cell's
   ``data.generator``) and builds the trainer from it, as a user does;
2. installs the initial per-client weights, made on the device from the
   seed (``harness/weights.py``), with adam's state from
   ``engine.init_opt_state``;
3. takes every round's random inputs from a pool made from the seed
   (``harness/draws.py``);
4. runs the cell's check rounds (set-up; they also warm every shape of
   the cell) while observing the program's outputs: each local step's
   loss, each client's val accuracy, the program's own upload (K1's
   statistics, as ``engine.swarm_distribution_matrix`` hands them to
   the coordinator) beside the reference's statistics of the same
   weights, the reported assignments, centers and events, adam's first
   moment after the first local step and the weights after the last
   round (kept on the host);
5. times rounds back to back for ``--seconds`` (the window);
6. with ``--trace 1`` then profiles a few more rounds with a span
   around each program function that the cell's per-layer metric
   readers name (their ``SPAN``), and adds the counts their ``facts``
   work out from the cell's shapes;
7. frees the program's state and runs the float32 reference over the
   same weights, data and draws (``harness/checks.py`` says what is
   compared).

Every step that belongs to the check and not to the program (the
observers' statistics, the norms, making the weights again) is timed
and left out of ``setup_s``."""
from __future__ import annotations

import importlib
import math
import statistics
import sys
import time
import traceback
from contextlib import ExitStack, contextmanager, nullcontext
from dataclasses import dataclass

import torch

from swarmbench.harness import checks
from swarmbench.harness import trace as tracing
from swarmbench.harness.draws import DrawPool
from swarmbench.harness.weights import make_weights
from swarmbench.reference import swarm as ref

POOL_ROUNDS = 256


def flatten(tree) -> dict:
    """``{path: leaf}`` of a program tree, in the program's leaf order:
    dict keys sorted at every level, list items by index, joined by ``/``."""
    from repro_torch.utils.tree import tree_paths_and_leaves
    return dict(tree_paths_and_leaves(tree))


def rebuild(like, flat: dict, prefix: str = ""):
    """``like``'s structure (nested dicts and lists) with the leaves of
    ``flat``, found by :func:`flatten`'s paths."""
    if isinstance(like, dict):
        return {k: rebuild(v, flat, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, list):
        return [rebuild(v, flat, f"{prefix}{i}/") for i, v in enumerate(like)]
    return flat[prefix[:-1]]


def log(msg: str) -> None:
    print(f"[swarmbench] {msg}", file=sys.stderr, flush=True)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextmanager
def patched(module, wrappers: dict):
    """``module``'s attributes wrapped by ``wrappers[name](original)`` for
    the block; a name the module no longer has is skipped."""
    saved = {n: getattr(module, n) for n in wrappers if hasattr(module, n)}
    for n, f in saved.items():
        setattr(module, n, wrappers[n](f))
    try:
        yield sorted(saved)
    finally:
        for n, f in saved.items():
            setattr(module, n, f)


def program_config(config: dict):
    """The program's ModelConfig: its registered ``arch_id`` with the
    configuration file's values in the mapped fields."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    prog = config["program"]
    return replace(get_config(prog["arch_id"]),
                   **{f: config["model"][k] for f, k in prog["fields"].items()})


@dataclass
class Setup:
    """What both sides are given: data, weights' layout and draws."""
    seed: int
    device: torch.device
    traffic: dict
    config: dict
    clients: list
    layout: list            # (path, (N, ...)) of the program's leaves
    pool: DrawPool
    n_samples: torch.Tensor

    @property
    def swarm(self) -> dict:
        return self.traffic["round"]

    def weights(self) -> dict:
        return make_weights(self.layout, self.config["init"], self.seed, self.device)

    def draws(self, rounds) -> list:
        return [self.pool(r) for r in rounds]

    def rows(self, split: str) -> list:
        return [(torch.as_tensor(c[split][0], device=self.device),
                 torch.as_tensor(c[split][1], device=self.device)) for c in self.clients]


def make_clients(seed: int, traffic: dict, device):
    gen = importlib.import_module(f"swarmbench.generators.{traffic['data']['generator']}")
    return gen.make_clients(seed, traffic["data"], device)


def build_trainer(setup_clients, config: dict, traffic: dict, device):
    from repro_torch.configs import OptimizerConfig, SwarmConfig
    from repro_torch.core.swarm import SwarmTrainer
    from repro_torch.models import build_model

    r = traffic["round"]
    swarm = SwarmConfig(n_clients=len(setup_clients), n_clusters=r["k"], p1=r["p1"], p2=r["p2"],
                        local_steps=r["local_steps"], kmeans_iters=r["kmeans_iters"], rounds=1)
    return SwarmTrainer(build_model(program_config(config)), setup_clients, swarm,
                        OptimizerConfig(**r["optimizer"]), seed=0, batch_size=r["batch_size"],
                        device=device)


def install_weights(tr, theta0: dict) -> None:
    """The harness's weights and a fresh adam state in the trainer."""
    from repro_torch.core import engine
    params = rebuild(tr.state.params, theta0)
    tr.state = tr.state._replace(params=params, opt_state=engine.init_opt_state(tr.opt, params))


def program_draws(setup: Setup, r: int):
    from repro_torch.core import engine
    from repro_torch.core.bso import BSODraws
    d = setup.pool(r)
    return engine.RoundDraws(batch_idx=d.batch_idx, kmeans_init_idx=None,
                             bso=BSODraws(d.r1, d.g, d.r2, d.g2), kmeans_u=d.kmeans_u)


def _events(log_) -> tuple:
    return (log_.events.count("replace"), log_.events.count("swap"))


def _to_host(tree) -> dict:
    return {p: x.detach().to("cpu", copy=True) for p, x in flatten(tree).items()}


def check_rounds(tr, setup: Setup):
    """The cell's check rounds through ``tr.round``, observed. Returns the
    program's readings and the seconds the observing took.

    The first round's local phase is observed by running its first step
    alone through the same ``engine.local_phase``, step and batch first
    (adam's first moment then gives the first gradient as the optimizer
    got it), and that step's outputs are let go before the round runs.
    The weights that eval scored and those after the last round are kept
    on the host, so that no reading of the check sits on the card."""
    from repro_torch.core import engine
    dev = setup.device
    out = ref.Readings()
    cur = {}
    spent = [0.0]

    def losses(f):
        def g(step, params, opt_state, lr, batches, *a, **k):
            if not out.losses:
                batches = list(batches)
                t0 = time.perf_counter()
                _, first, _ = f(step, params, opt_state, lr, batches[:1], *a, **k)
                out.first_moment = ref.leaf_norms(flatten(first["m"])).cpu()
                del first
                _sync(dev)
                spent[0] += time.perf_counter() - t0
            res = f(step, params, opt_state, lr, batches, *a, **k)
            cur["losses"] = res[2].detach().double().cpu()
            return res
        return g

    def val(f):
        def g(model, params, *a, **k):
            res = f(model, params, *a, **k)
            cur["val"] = res.detach().float().cpu().clone()
            t0 = time.perf_counter()
            cur["eval_weights"] = _to_host(params)
            spent[0] += time.perf_counter() - t0
            return res
        return g

    def upload(f):
        def g(params, *a, **k):
            res = f(params, *a, **k)
            t0 = time.perf_counter()
            with torch.no_grad():
                cur["upload"] = res.detach().float().cpu().clone()
                cur["features"] = ref.features(flatten(params)).cpu()
            _sync(dev)
            spent[0] += time.perf_counter() - t0
            return res
        return g

    n = setup.traffic["check"]["rounds"]
    with patched(engine, {"local_phase": losses, "eval_swarm": val,
                          "swarm_distribution_matrix": upload}):
        for r in range(n):
            t_r = time.perf_counter()
            lg = tr.round(draws=program_draws(setup, r))
            _sync(dev)
            t_r = time.perf_counter() - t_r
            out.losses.append(cur.pop("losses"))
            out.val.append(cur.pop("val"))
            out.eval_weights.append(cur.pop("eval_weights"))
            out.features.append(cur.pop("features"))
            out.upload.append(cur.pop("upload"))
            out.assignments.append(torch.as_tensor(lg.assignments).long())
            out.centers.append(torch.as_tensor(lg.centers).long())
            out.events.append(_events(lg))
            log(f"check round {r} ({t_r:.3f} s): loss {lg.train_loss:.6f} "
                f"val {lg.mean_val_acc:.4f} assignments {lg.assignments.tolist()} centers {lg.centers.tolist()} "
                f"events {lg.events}")
    t0 = time.perf_counter()
    out.end_weights = _to_host(tr.params)
    spent[0] += time.perf_counter() - t0
    return out, spent[0]


def reference_readings(setup: Setup, precision: str, follow=None):
    """The plain reference's rounds from the same weights, data and draws
    (in the program's place, below float32, with the weights its eval
    scored kept)."""
    cfg = setup.config
    return ref.run_rounds(cfg["reference"], cfg["model"], setup.swarm["optimizer"], setup.swarm,
                          setup.weights(), setup.rows("train"), setup.rows("val"),
                          setup.n_samples, setup.draws(range(setup.traffic["check"]["rounds"])),
                          precision, follow, keep_eval_weights=follow is None)


def judge(setup: Setup, side, keep: dict = None) -> dict:
    """The numbers of ``harness/checks.py`` for one side's readings; with
    ``keep`` (a dict) the reference's readings and coordinator are left
    in it."""
    dev = setup.device
    t0 = time.perf_counter()
    if side.change is None:
        side.change = ref.leaf_norms(side.end_weights, setup.weights()).cpu()
        side.end_weights = None
    reference = reference_readings(setup, "float32", follow=side)
    uploads = side.upload or side.features
    coord = [ref.coordinate(uploads[r].to(dev), side.val[r].to(dev), d, setup.swarm)
             for r, d in enumerate(setup.draws(range(setup.traffic["check"]["rounds"])))]
    val = setup.rows("val")
    scored = [ref.eval_accuracy(setup.config["reference"], setup.config["model"], w, val)
              for w in side.eval_weights]
    values = checks.compare(side, reference, coord, scored)
    log(f"reference: {time.perf_counter() - t0:.2f} s for {len(coord)} rounds; losses "
        f"{[round(float(x), 6) for x in reference.losses[-1]]}")
    if keep is not None:
        keep.update(reference=reference, coord=coord)
    return values


def prepare(seed: int, traffic: dict, config: dict, device, layout=None):
    """Data, draws and (unless given) the weights' layout of a run, with
    the program's trainer when the layout is not given."""
    clients = make_clients(seed, traffic, device)
    tr = None
    if layout is None:
        tr = build_trainer(clients, config, traffic, device)
        layout = [(p, tuple(x.shape)) for p, x in flatten(tr.state.params).items()]
    train_n = torch.as_tensor([c["n_train"] for c in clients], dtype=torch.int64, device=device)
    r = traffic["round"]
    pool = DrawPool(seed, train_n, r["local_steps"], r["batch_size"], r["k"], POOL_ROUNDS)
    setup = Setup(seed, device, traffic, config, clients, layout, pool,
                  train_n.to(torch.float32))
    return setup, tr


def metric_readers(names) -> list:
    """The reader modules of the cell's per-layer metrics (``metrics/<name>.py``)."""
    return [importlib.import_module(f"swarmbench.metrics.{n}") for n in names]


def span_wrappers(readers) -> dict:
    """``{module: {function: wrapper}}``: a ``record_function`` span named
    by the reader's ``SPAN`` (``"<module>:<function>"``) around each
    program function that a reader names."""
    from torch.profiler import record_function

    def span(name):
        def wrap(f):
            def g(*a, **k):
                with record_function(name):
                    return f(*a, **k)
            return g
        return wrap

    out = {}
    for spec in sorted({r.SPAN for r in readers if hasattr(r, "SPAN")}):
        module, func = spec.split(":")
        out.setdefault(module, {})[func] = span(spec)
    return out


def profile_rounds(tr, setup: Setup, first: int, n: int, readers):
    """``n`` rounds under ``torch.profiler``, with the readers' spans."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if setup.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    spans = []
    with ExitStack() as stack:
        for module, wrappers in span_wrappers(readers).items():
            found = stack.enter_context(patched(importlib.import_module(module), wrappers))
            spans += [f"{module}:{f}" for f in found]
        _sync(setup.device)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for r in range(first, first + n):
                with record_function(tracing.ROUND_SPAN):
                    tr.round(draws=program_draws(setup, r))
                _sync(setup.device)
            wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary = tracing.summarize(prof, spans, n, wall * 1e6)
    for r in readers:
        if hasattr(r, "facts"):
            summary.facts.update(r.facts(setup))
    log(f"trace: {n} rounds profiled in {wall:.3f} s, reduced in {time.perf_counter() - t0:.2f} s;"
        f" kernels linked to a launching op {summary.facts['kernel_us_linked']:.0f} of "
        f"{summary.facts['kernel_us_all']:.0f} us; spans {summary.span_device_us}")
    return summary


def run(ctx) -> dict:
    """One run of a cell; returns the result before the fence."""
    dev = ctx.device
    traffic, config = ctx.workload, ctx.config
    setup, tr = prepare(ctx.seed, traffic, config, dev)
    log(f"data and trainer ready at {time.perf_counter() - ctx.t_start:.3f} s")
    install_weights(tr, setup.weights())
    log(f"{len(setup.clients)} clients, {len(setup.layout)} leaves, "
        f"{sum(math.prod(s) for _, s in setup.layout):,} parameters in all, train stack "
        f"{tuple(next(iter(tr.swarm_data.train.values())).shape)}")
    with ctx.faults() if ctx.faults else nullcontext():
        prog, excluded = check_rounds(tr, setup)
        setup_s = time.perf_counter() - ctx.t_start - excluded
        log(f"set-up {setup_s:.3f} s (check work left out: {excluded:.3f} s)")
        times, failed, raised, r = [], 0, False, traffic["check"]["rounds"]
        t_w0 = t1 = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            try:
                lg = tr.round(draws=program_draws(setup, r))
                _sync(dev)
            except Exception:               # the run reports it as failed, not as a crash
                traceback.print_exc()
                failed, raised = failed + 1, True
                break
            t1 = time.perf_counter()
            times.append(t1 - t0)
            r += 1
            if not math.isfinite(lg.train_loss):
                failed += 1
            if t1 - t_w0 >= ctx.seconds:
                break
        window_s = t1 - t_w0
        attempted = len(times) + int(raised)
        summary = None
        if ctx.trace and times and not failed:
            summary = profile_rounds(tr, setup, r, traffic["trace"]["profiled_rounds"],
                                     metric_readers(ctx.per_layer))
            attempted += traffic["trace"]["profiled_rounds"]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"window: {len(times)} rounds in {window_s:.3f} s; round seconds min "
        f"{min(times, default=float('nan')):.4f} median "
        f"{statistics.median(times) if times else float('nan'):.4f} max "
        f"{max(times, default=float('nan')):.4f}; peak {peak:,} bytes")
    log(f"round seconds: {[round(t, 4) for t in times]}")
    del tr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    values = judge(setup, prog)
    ok, table = checks.verdict(values, traffic["check"]["limits"])
    e2e = {}
    if times:
        e2e = {"round_s": window_s / len(times),
               "peak_mem_gib": peak / 2**30,
               "setup_s": setup_s}
    out = {"correct": bool(ok and not failed and times), "attempted": attempted,
           "failed": failed, "e2e": e2e, "checks": table, "peak": peak, "summary": summary}
    if summary is not None:
        summary.facts.update(unprofiled_rounds=len(times), unprofiled_s=window_s)
    return out
