"""The port's learning-rate schedules, trainer entry point and
microbatched train step (``repro_torch.optim.schedules``,
``repro_torch.launch.train``, ``repro_torch.train.steps``) against the
JAX reference on the CPU."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.data.tokens import make_lm_batches  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim.optimizers import make_optimizer as jax_make_optimizer  # noqa: E402
from repro.optim.schedules import make_schedule as jax_make_schedule  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro.utils.tree import tree_paths_and_leaves as jax_paths  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import restore_into  # noqa: E402
from repro_torch.configs import ModelConfig, OptimizerConfig  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.optimizers import make_optimizer  # noqa: E402
from repro_torch.optim.schedules import make_schedule  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from repro_torch.utils.tree import tree_map, tree_paths_and_leaves  # noqa: E402
from torch_parity import pin_torch_threads  # noqa: E402

pin_torch_threads()

# ------------------------------------------------------------------ schedules


@pytest.mark.parametrize("name,base_lr,kw", [
    ("constant", 0.5, {}),
    ("constant", 1e-3, {"warmup": 10}),
    ("cosine", 3e-4, {"warmup": 10, "total_steps": 100}),
    ("cosine", 2e-3, {"warmup": 0, "total_steps": 50, "min_ratio": 0.0}),
    ("cosine", 1.0, {"warmup": 6, "total_steps": 120, "min_ratio": 0.25}),
])
def test_schedule_values_match_reference(name, base_lr, kw):
    """Steps 0..120 within 1e-6 relative: the port rounds each operation
    to fp32 as the reference does; its cosine may differ by an fp32 ulp."""
    ours, theirs = make_schedule(name, base_lr, **kw), jax_make_schedule(name, base_lr, **kw)
    got = np.array([ours(s) for s in range(121)])
    expect = np.array([float(theirs(s)) for s in range(121)])
    assert all(isinstance(ours(s), float) for s in (0, 7))
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=0)


def test_schedule_shape():
    """tests/test_optim.py's test_schedules, on the port."""
    s = make_schedule("cosine", 1.0, warmup=10, total_steps=100)
    assert s(0) < 0.2
    assert s(10) > 0.9
    assert s(99) < 0.2
    assert make_schedule("constant", 0.5)(1234) == 0.5


@pytest.mark.parametrize("name,kw,match", [("cosine", {}, "total_steps"),
                                           ("linear", {}, "unknown schedule")])
def test_schedule_errors_match_reference(name, kw, match):
    with pytest.raises(ValueError, match=match):
        make_schedule(name, 1e-3, **kw)
    with pytest.raises(ValueError, match=match):
        jax_make_schedule(name, 1e-3, **kw)


# ------------------------------------------------------------------ trainer


@pytest.mark.parametrize("preset", sorted(train.PRESETS))
def test_presets_are_the_references(preset):
    assert train.PRESETS[preset] == jax_train.PRESETS[preset]
    assert dataclasses.asdict(train.preset_config(preset)) == \
        dataclasses.asdict(jax_train.preset_config(preset))


def _args(**kw):
    base = dict(mode="single", preset="tiny", steps=3, batch=8, seq=256, lr=1e-3, seed=0,
                ckpt="", device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_run_single_matches_reference_per_step_ce(tmp_path):
    """3 steps of the tiny preset from the reference's init, on the same
    ``make_lm_batches``, adamw at eps 1e-8 on the cosine schedule.

    Tolerance, rtol 1e-5 on each step's ce (~6.7): step 0 is a forward
    alone, fp32 sums of 128-512 products in another order (~1e-7
    relative). Adam's first steps move every weight by about
    lr * sign(g), so the two packages' gradient rounding changes a
    weight's update only where |g| is near eps = 1e-8, and such a
    weight moves ce by about |g| * lr, far below 1e-5. A wrong
    schedule, bias correction or weight decay moves ce by ~1e-3."""
    args = _args(ckpt=str(tmp_path / "single"))
    jcfg = jax_train.preset_config("tiny")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    opt = jax_make_optimizer(JaxOptimizerConfig(name="adamw", lr=args.lr))
    state = opt.init(jp)
    sched = jax_make_schedule("cosine", args.lr, warmup=max(10, args.steps // 20),
                              total_steps=args.steps)
    step = jax.jit(jax_make_train_step(jm, opt))
    expect, p = [], jp
    for i, b in enumerate(make_lm_batches(jcfg.vocab_size, args.batch, args.seq, args.steps,
                                          client=0, seed=args.seed)):
        p, state, m = step(p, state, {k: jnp.asarray(v) for k, v in b.items()},
                           jnp.asarray(sched(i)))
        expect.append(float(m["ce"]))

    params, ces = train.train_single(args,
                                     params=params_from_numpy(jax.tree.map(np.asarray, jp)))
    np.testing.assert_allclose(ces, expect, rtol=1e-5, atol=0)
    restored, saved_step = restore_into(tree_map(torch.zeros_like, params), args.ckpt)
    assert saved_step == 3
    for (path, a), (_, b) in zip(tree_paths_and_leaves(restored), tree_paths_and_leaves(params)):
        assert torch.equal(a, b), path


def test_run_single_seeded_init_trains(capsys):
    """``run_single`` returns the last step's ce as a float, as the
    reference's does; ``train_single`` returns the params and every
    step's ce, the same run's."""
    ce = train.run_single(_args(steps=4, seq=32))
    assert isinstance(ce, float) and np.isfinite(ce)
    out = capsys.readouterr().out
    assert "params=623,232 on cpu" in out and out.count("tok/s=") == 4
    params, ces = train.train_single(_args(steps=4, seq=32))
    assert len(ces) == 4 and np.all(np.isfinite(ces)) and ces[-1] == pytest.approx(ce, rel=1e-6)


def test_main_swarm_mode_runs_an_lm_round_on_the_cpu(capsys):
    acc = train.main(["--mode", "swarm", "--arch", "granite-3-2b", "--rounds", "1",
                      "--clients", "4", "--clusters", "2", "--local-steps", "2",
                      "--batch", "4", "--device", "cpu"])
    assert np.isfinite(acc) and 0.0 <= acc <= 1.0
    out = capsys.readouterr().out
    assert "[bso] round   0" in out and "final mean test accuracy" in out


def test_main_swarm_mode_runs_a_cnn_on_the_cpu():
    acc = train.main(["--mode", "swarm", "--arch", "squeezenet-dr", "--rounds", "1",
                      "--local-steps", "1", "--data-scale", "16", "--image-size", "8",
                      "--device", "cpu"])
    assert 0.0 <= acc <= 1.0


@pytest.mark.parametrize("mode", ["single", "swarm"])
def test_main_needs_a_card_unless_told(monkeypatch, mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--mode", mode, "--steps", "1", "--rounds", "1"])


# ------------------------------------------------------------------ gradient accumulation


def _mb_setup(arch):
    jcfg = jax_get_config(arch).smoke()
    jm, tm = jax_build_model(jcfg), build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, size=(4, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if jcfg.family == "encdec":
        batch["audio_embed"] = (rng.normal(size=(4, jcfg.encoder_seq, jcfg.d_model))
                                * 0.02).astype(np.float32)
    opt = dict(name="sgd", lr=1e-2, grad_clip=0)
    return (jm, jp, jax_make_optimizer(JaxOptimizerConfig(**opt)), tm,
            make_optimizer(OptimizerConfig(**opt)), batch)


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-base"])
def test_microbatched_step_matches_reference_and_the_full_batch(arch):
    """``make_train_step(..., microbatches=2)``: one sgd step (no clip) on
    4 rows against the reference's microbatched step and against the
    port's full-batch step, params within rtol 2e-5 / atol 2e-6 (the
    reference's own bound for accumulation against the full batch) and
    the averaged metrics within rtol 1e-5."""
    jm, jp, jopt, tm, topt, batch = _mb_setup(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jnew, _, jmet = jax.jit(jax_make_train_step(jm, jopt, microbatches=2))(
        jp, jopt.init(jp), jb, jnp.asarray(1e-2))
    micro, _, tmet = make_train_step(tm, topt, microbatches=2)(tp, topt.init(tp), tb, 1e-2)
    full, _, _ = make_train_step(tm, topt)(tp, topt.init(tp), tb, 1e-2)
    want = [np.asarray(a) for _, a in jax_paths(jnew)]
    for (p, a), b, (_, c) in zip(tree_paths_and_leaves(micro), want,
                                 tree_paths_and_leaves(full)):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-5, atol=2e-6, err_msg=p)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-5, atol=2e-6, err_msg=p)
    for k in ("loss", "ce", "acc"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)


def test_microbatches_must_divide_the_batch():
    _, _, _, tm, topt, batch = _mb_setup("granite-3-2b")
    tp = tm.init(torch.Generator().manual_seed(0))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(ValueError, match="does not split into 3 microbatches"):
        make_train_step(tm, topt, microbatches=3)(tp, topt.init(tp), tb, 1e-2)


# ------------------------------------------------------------------ rematerialisation


def _grads_under(cfg, params, batch, remat):
    """vmap(grad_and_value(loss)) over a 2-client stack at ``remat``."""
    model = build_model(dataclasses.replace(cfg, remat=remat))
    return torch.func.vmap(torch.func.grad_and_value(model.loss, has_aux=True))(params, batch)


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-1.2b"])
def test_remat_full_and_dots_give_the_plain_gradients(arch):
    """``remat="full"`` and ``"dots"`` (the port's ``jax.checkpoint`` and
    its dots policy) give ``"none"``'s loss and gradients within 1e-6
    under ``vmap(grad_and_value)``, a dense and a hybrid stack (whose
    shared attention block is rematerialised too); the port's smoke
    configs, two clients from two seeds."""
    from repro_torch.configs import get_config
    from repro_torch.utils.tree import tree_stack
    cfg = get_config(arch).smoke()
    model = build_model(cfg)
    params = tree_stack([model.init(torch.Generator().manual_seed(i)) for i in range(2)])
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 16), generator=torch.Generator().manual_seed(5))
    batch = {"tokens": toks, "labels": toks}
    g0, (l0, _) = _grads_under(cfg, params, batch, "none")
    for remat in ("full", "dots"):
        g, (loss, _) = _grads_under(cfg, params, batch, remat)
        np.testing.assert_allclose(loss.numpy(), l0.numpy(), rtol=0, atol=1e-6, err_msg=remat)
        for (p, a), (_, b) in zip(tree_paths_and_leaves(g), tree_paths_and_leaves(g0)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{remat} {p}")


def test_remat_must_be_known():
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("granite-3-2b").smoke(), remat="some")
    model = build_model(cfg)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="remat must be none, full or dots"):
        model.loss(model.init(torch.Generator().manual_seed(0)), {"tokens": toks, "labels": toks})


def test_remat_full_matches_the_reference_at_full():
    """The port at ``remat="full"`` against the reference at ``"full"``
    (``jax.checkpoint`` around each block) on the reference's weights:
    the loss within rtol 1e-5, gradients within rtol 2e-5 / atol 2e-6,
    the bound of the microbatched step's test above."""
    jcfg = dataclasses.replace(jax_get_config("granite-3-2b").smoke(), remat="full")
    jm, tm = jax_build_model(jcfg), build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, size=(4, 16)).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tt = torch.from_numpy(toks)
    tg, (tl, _) = torch.func.grad_and_value(tm.loss, has_aux=True)(tp, {"tokens": tt,
                                                                         "labels": tt})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for (p, a), (_, b) in zip(tree_paths_and_leaves(tg), jax_paths(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-6, err_msg=p)
