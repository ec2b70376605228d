"""Training on the CPU: the gradients of every family's loss, the SSD's
``autograd.Function`` (port fault F8's repair), remat, the train step and
the ``Trainer`` of the port, each held against the reference package on
the same params (``params_from_jax``) and batches, in f32."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import repro.configs.registry as jregistry
from repro.kernels.ssd_scan import ops as jssd_ops
from repro.models.api import build_model as jbuild_model
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import Trainer as JTrainer
import repro_torch.configs.registry as registry
from repro_torch.data.pipeline import DataConfig, SyntheticLMSource
from repro_torch.examples import quickstart
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import hybrid, lm
from repro_torch.models.api import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.loop import (
    TrainConfig,
    Trainer,
    make_train_step,
    value_and_grad,
)
from repro_torch.utils import pytree

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_ssm import _perturb  # noqa: E402

# the suite runs in several worker processes on one host: one intra-op
# thread each keeps torch from oversubscribing the cores that the
# timing-sensitive reference tests share
torch.set_num_threads(1)

# f32 losses of the same model in two frameworks: the same ops summed in
# another order (a CPU run: <= 4.8e-7 apart)
LOSS_ATOL = 1e-5
# each gradient leaf, relative L2 error against jax.grad's: the SSM
# families' SSD runs the port's ssd_full against the reference's jnp
# ssd_chunked, other sums in other orders (a CPU run: <= 3.6e-5, zamba2's
# conv_w; the dense families <= 1.6e-6)
GRAD_REL = 1e-4
FAMILIES = ["qwen2.5-3b", "granite-moe-1b-a400m", "pixtral-12b",
            "mamba2-780m", "zamba2-1.2b", "seamless-m4t-medium"]


def _pair(arch, **over):
    """(reference model, port model, numpy params) at the smoke size, f32,
    every constant param moved off its init."""
    over = {"dtype": "float32", **over}
    jcfg = jregistry.smoke_config(arch).replace(**over)
    cfg = registry.smoke_config(arch).replace(**over)
    jm, m = jbuild_model(jcfg), build_model(cfg)
    pnp = jax.tree_util.tree_map(np.array, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    for sub in pnp.values():
        if isinstance(sub, dict):
            _perturb(sub, rng)
        elif isinstance(sub, list):
            for g in sub:
                _perturb(g, rng)
    return jm, m, pnp


def _host_batches(cfg, n, batch=2, seq=64, seed=3):
    if cfg.family == "vlm":
        seq = cfg.n_prefix_tokens + 32
    src = SyntheticLMSource(DataConfig(batch, seq, seed), cfg)
    return [src.next_host_batch(i) for i in range(n)]


def _tb(hb):
    return {k: torch.from_numpy(v) for k, v in hb.items()}


def _jb(hb):
    return {k: jnp.asarray(v) for k, v in hb.items()}


def _rel(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grad_rel(got, want) -> dict:
    """{path: relative L2 error} over the leaves of two gradient trees."""
    paths = list(pytree.tree_paths(got))
    jl = jax.tree_util.tree_leaves(want)
    assert len(paths) == len(jl)
    return {p: _rel(g, w) for (p, g), w in zip(paths, jl)}


# ---- gradients ----------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_jax_grad(arch):
    """dense, moe, vlm, ssm, hybrid and audio: the port's loss and its
    gradient in every param against ``jax.value_and_grad`` of the
    reference's loss. The ssm and hybrid families' SSD runs through the
    F8 ``autograd.Function`` (its backward is the plain version's VJP)."""
    jm, m, pnp = _pair(arch)
    hb = _host_batches(m.cfg, 1)[0]
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, pnp), _jb(hb))
    loss, met, g = value_and_grad(m, lm.params_from_jax(pnp, "cpu"), _tb(hb))
    assert loss.grad_fn is None and met["loss"].grad_fn is None
    assert float(loss) == pytest.approx(float(jl), abs=LOSS_ATOL)
    assert float(met["acc"]) == pytest.approx(float(jmet["acc"]), abs=1e-6)
    rel = _grad_rel(g, jg)
    worst = max(rel, key=rel.get)
    assert rel[worst] <= GRAD_REL, (worst, rel[worst])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-780m",
                                  "zamba2-1.2b", "seamless-m4t-medium"])
@pytest.mark.parametrize("policy", ["full", "dots_nb"])
def test_remat_gives_the_same_gradients(arch, policy, monkeypatch):
    """Block remat recomputes the same ops in the backward: gradients
    equal to those without remat (exact on the CPU, one thread)."""
    _, m, pnp = _pair(arch)
    _, mr, _ = _pair(arch, remat=True, remat_policy=policy)
    hb = _tb(_host_batches(m.cfg, 1)[0])
    p = lm.params_from_jax(pnp, "cpu")
    l0, _, g0 = value_and_grad(m, p, hb)
    calls = []

    def counted(*args, **kw):
        calls.append(kw.get("context_fn"))
        return checkpoint(*args, **kw)

    monkeypatch.setattr(lm, "checkpoint", counted)
    l1, _, g1 = value_and_grad(mr, p, hb)
    # one checkpoint a block (the hybrid: a mamba layer, and the shared
    # block at each of its application points; the encoder-decoder: an
    # encoder and a decoder block)
    assert len(calls) == {
        "zamba2-1.2b": m.cfg.n_layers + hybrid.n_groups(m.cfg),
        "seamless-m4t-medium": m.cfg.n_layers + m.cfg.n_enc_layers,
    }.get(arch, m.cfg.n_layers)
    assert all((c is None) == (policy == "full") for c in calls)
    assert float(l0) == float(l1)
    for a, b in zip(pytree.tree_leaves(g0), pytree.tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_remat_is_off_without_grad():
    """Scoring runs the blocks as they are (no checkpoint) with remat on."""
    calls = []
    cfg = registry.smoke_config("qwen2.5-3b").replace(dtype="float32",
                                                      remat=True)

    def f(*args):
        calls.append(torch.is_grad_enabled())
        return args[0]

    wrapped = lm.make_remat(cfg)(f)
    with torch.no_grad():
        assert wrapped(torch.ones(1)) is not None
    assert calls == [False]


# ---- the SSD autograd.Function (F8) -------------------------------------------

def _ssd_inputs(rng, b=2, s=64, h=4, p=16, g=2, n=8):
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(
                np.float32) * 0.5,
            -np.linspace(1.0, 4.0, h).astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32) * 0.5,
            rng.standard_normal((b, s, g, n)).astype(np.float32) * 0.5,
            rng.standard_normal((b, h, p, n)).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_function_gradients_match_jax_grad(with_state):
    """``ssd_full`` under grad (the Function: kernels forward, the plain
    version's VJP backward) against ``jax.grad`` of the reference's
    ``ssd_full`` (its plain jnp path), the final state's cotangent used
    or not. f32; the same 1e-3 the reference holds ssd_full to
    ssd_chunked with."""
    rng = np.random.default_rng(11)
    x, dt, a, b, c, s0 = _ssd_inputs(rng)
    wy = rng.standard_normal(x.shape).astype(np.float32)
    ws = rng.standard_normal(s0.shape).astype(np.float32)

    def jloss(x, dt, a, b, c, s0):
        y, st = jssd_ops.ssd_full(x, dt, a, b, c, chunk=16,
                                  initial_state=s0 if with_state else None,
                                  use_kernel=False)
        out = jnp.sum(y * wy)
        return out + jnp.sum(st * ws) if with_state else out

    jg = jax.grad(jloss, argnums=tuple(range(6 if with_state else 5)))(
        *map(jnp.asarray, (x, dt, a, b, c, s0)))
    ts = [torch.from_numpy(t).requires_grad_() for t in (x, dt, a, b, c, s0)]
    y, st = ssd_ops.ssd_full(*ts[:5], chunk=16,
                             initial_state=ts[5] if with_state else None)
    assert type(y.grad_fn).__name__ == "_SSDFullBackward"
    out = (y * torch.from_numpy(wy)).sum()
    if with_state:
        out = out + (st * torch.from_numpy(ws)).sum()
    out.backward()
    for t, w in zip(ts, jg):
        assert _rel(t.grad, w) <= 1e-3
    if not with_state:
        assert ts[5].grad is None


def test_ssd_function_backward_is_the_plain_vjp():
    """The Function's gradients equal autograd's through the plain
    version (``use_kernel=False``), exactly on the CPU; an input that needs
    no gradient gets none."""
    rng = np.random.default_rng(12)
    arrs = _ssd_inputs(rng)
    wy = torch.from_numpy(rng.standard_normal(arrs[0].shape).astype(
        np.float32))
    grads = []
    for use_kernel in (True, False):
        ts = [torch.from_numpy(t).requires_grad_(i != 2)
              for i, t in enumerate(arrs)]
        y, st = ssd_ops.ssd_full(*ts[:5], chunk=16, initial_state=ts[5],
                                 use_kernel=use_kernel)
        ((y * wy).sum() + st.square().sum()).backward()
        assert ts[2].grad is None
        grads.append([t.grad for i, t in enumerate(ts) if i != 2])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ssd_full_without_grad_takes_no_function():
    rng = np.random.default_rng(13)
    ts = [torch.from_numpy(t).requires_grad_() for t in _ssd_inputs(rng)]
    with torch.no_grad():
        y, _ = ssd_ops.ssd_full(*ts[:5], chunk=16)
    assert y.grad_fn is None
    y, _ = ssd_ops.ssd_full(*(t.detach() for t in ts[:5]), chunk=16)
    assert y.grad_fn is None


# ---- the train step and the Trainer -------------------------------------------

def _run_both(arch, steps=4, n_micro=1, **tc):
    """The reference's Trainer and the port's from the same params and
    batches. Returns (port trainer, port out, ref trainer, ref out)."""
    jm, m, pnp = _pair(arch)
    hbs = _host_batches(m.cfg, steps, batch=4)
    kw = dict(steps=steps, n_microbatches=n_micro, warmup=2, log_every=1,
              **tc)
    jt = JTrainer(jm, JTrainConfig(opt=JAdamWConfig(lr=1e-3), **kw))
    jp = jax.tree_util.tree_map(jnp.asarray, pnp)
    jout = jt.run(iter([_jb(h) for h in hbs]),
                  initial_state=(jp, jadamw_init(jp)))
    t = Trainer(m, TrainConfig(opt=AdamWConfig(lr=1e-3), **kw))
    p = lm.params_from_jax(pnp, "cpu")
    out = t.run(iter([_tb(h) for h in hbs]), initial_state=(p, adamw_init(p)))
    return t, out, jt, jout


# AdamW divides by sqrt(v): where a gradient is near zero its update is
# near +-lr whatever its size, so a gradient 1e-6 apart in relative terms
# can move such an element by a fraction of lr (1e-3) over the steps; the
# params elsewhere agree to ~1e-6
PARAM_ATOL = 2e-4


def _assert_runs_agree(t, out, jt, jout):
    assert len(t.history) == len(jt.history)
    for a, b in zip(t.history, jt.history):
        assert a["step"] == b["step"]
        for k in ("loss", "acc", "aux", "step_ok"):
            assert a[k] == pytest.approx(b[k], abs=1e-4), k
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
    for g, w in zip(pytree.tree_leaves(out["params"]),
                    jax.tree_util.tree_leaves(jout["params"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=PARAM_ATOL)
    assert int(out["opt_state"]["step"]) == int(jout["opt_state"]["step"])


@pytest.mark.parametrize("arch,n_micro", [("qwen2.5-3b", 1),
                                          ("qwen2.5-3b", 2),
                                          ("mamba2-780m", 2)])
def test_trainer_matches_reference(arch, n_micro):
    """4 steps from the same params and batches: losses per step within
    1e-4 and the final params within PARAM_ATOL."""
    _assert_runs_agree(*_run_both(arch, n_micro=n_micro))


def test_trainer_restarts_from_a_reference_checkpoint(tmp_path):
    """The reference's Trainer writes a checkpoint at step 2; the port's
    Trainer restores it (a restart) and its last two steps match the
    reference's uninterrupted 4-step run."""
    jm, m, pnp = _pair("qwen2.5-3b")
    hbs = _host_batches(m.cfg, 4, batch=4)
    kw = dict(warmup=2, log_every=1, opt=None)
    jtc = dict(kw, opt=JAdamWConfig(lr=1e-3))
    jp = jax.tree_util.tree_map(jnp.asarray, pnp)
    # the writer: 2 steps, a checkpoint at step 2 (the schedule's total
    # is the full run's, as in a run that was cut)
    jw = JTrainer(jm, JTrainConfig(steps=2, checkpoint_dir=str(tmp_path),
                                   checkpoint_every=2, **jtc))
    jw.run(iter([_jb(h) for h in hbs]), initial_state=(jp, jadamw_init(jp)))
    # the uninterrupted reference run
    jt = JTrainer(jm, JTrainConfig(steps=4, **jtc))
    jp = jax.tree_util.tree_map(jnp.asarray, pnp)
    jout = jt.run(iter([_jb(h) for h in hbs]),
                  initial_state=(jp, jadamw_init(jp)))
    t = Trainer(m, TrainConfig(steps=4, checkpoint_dir=str(tmp_path),
                               checkpoint_every=2,
                               **dict(kw, opt=AdamWConfig(lr=1e-3))))
    out = t.run(iter([_tb(h) for h in hbs[2:]]),
                generator=torch.Generator().manual_seed(1), device="cpu")
    assert out["fault"].restarts == 1
    assert [r["step"] for r in t.history] == [2, 3]
    jt.history = jt.history[2:]
    _assert_runs_agree(t, out, jt, jout)


def test_train_step_updates_in_place_and_detaches_metrics():
    _, m, pnp = _pair("qwen2.5-3b")
    p = lm.params_from_jax(pnp, "cpu")
    st = adamw_init(p)
    before = p["embed"].clone()
    step = make_train_step(m, TrainConfig(steps=2, warmup=1))
    batch = _tb(_host_batches(m.cfg, 1)[0])
    step(p, st, batch)  # the schedule's scale at step 0 is 0
    p2, st2, met = step(p, st, batch)
    assert p2 is p and st2 is st and int(st["step"]) == 2
    assert not torch.equal(p["embed"], before)
    assert not p["embed"].requires_grad
    assert all(v.grad_fn is None for v in met.values())
    assert set(met) == {"loss", "aux", "acc", "grad_norm", "step_ok"}


def test_trainer_inits_on_the_device_asked(tmp_path):
    """No initial state: params from model.init on ``device`` with a
    generator seeded with 0 there (two runs give the same params)."""
    _, m, _ = _pair("qwen2.5-3b")
    hbs = _host_batches(m.cfg, 2)
    outs = []
    for _ in range(2):
        t = Trainer(m, TrainConfig(steps=2, warmup=1))
        outs.append(t.run(iter([_tb(h) for h in hbs]), device="cpu"))
    for a, b in zip(pytree.tree_leaves(outs[0]["params"]),
                    pytree.tree_leaves(outs[1]["params"])):
        assert a.device.type == "cpu"
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_launch_train_smoke_runs_on_the_host(capsys):
    trainer, out = launch_train.main(
        ["--arch", "mamba2-780m", "--steps", "3", "--batch", "2", "--seq",
         "32", "--policy", "scheduled", "--device", "cpu"])
    assert [r["step"] for r in trainer.history] == [0, 2]
    assert all(np.isfinite(r["loss"]) for r in trainer.history)
    assert "restarts=0" in capsys.readouterr().out


def test_quickstart_trains_then_serves_on_the_host(capsys):
    """The quickstart example: 20 steps of the smoke qwen (the loss falls),
    then the trained params served."""
    res = quickstart.main(["--device", "cpu"])
    assert len(res) == 2 and len(res[0].tokens) == 16
    losses = [float(x) for x in capsys.readouterr().out.split("loss: [")[1]
              .split("]")[0].split(",")]
    assert losses[-1] < losses[0]
