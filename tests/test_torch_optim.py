"""The port's tree utilities, LR schedules, AdamW and gradient compression
on the CPU, held against the reference package (``repro.utils.pytree``,
``repro.optim``) on the same numpy trees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import compression as jcomp
from repro.optim import schedule as jschedule
from repro.utils import pytree as jpytree
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import compression as comp
from repro_torch.optim import schedule
from repro_torch.utils import pytree

# the suite runs in several worker processes on one host: one intra-op
# thread each keeps torch from oversubscribing the cores that the
# timing-sensitive reference tests share
torch.set_num_threads(1)

# f32 elementwise arithmetic in the same order on both sides; the norm's
# sum runs in another order (chunked dot products against jnp.sum), so
# the results agree to a few f32 ulps of values of order 1
TOL = 1e-6


def _tree(rng, dtype=np.float32):
    """A param-like tree: a stacked matrix leaf (ndim 3), a matrix, a
    vector and a list holding a scalar-free dict, as the models' params."""
    return {
        "blocks": {"w": rng.standard_normal((3, 4, 5)).astype(dtype),
                   "scale": (1 + 0.1 * rng.standard_normal((3, 4))).astype(
                       dtype)},
        "embed": rng.standard_normal((7, 4)).astype(dtype),
        "bias": rng.standard_normal((6,)).astype(dtype),
        "groups": [{"a": rng.standard_normal((2, 3)).astype(dtype)},
                   {"a": rng.standard_normal((5,)).astype(dtype)}],
    }


def _torch(tree):
    return pytree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    return pytree.tree_map(lambda t: t.detach().numpy(), tree)


def _close(got, want, tol=TOL):
    got_l = pytree.tree_leaves(got)
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=tol,
                                   atol=tol)


# ---- pytree ---------------------------------------------------------------

def test_tree_leaves_follow_the_reference_order():
    tree = _tree(np.random.default_rng(0))
    got = [t.numpy() for t in pytree.tree_leaves(_torch(tree))]
    want = jax.tree_util.tree_leaves(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    paths = [p for p, _ in pytree.tree_paths(tree)]
    jpaths = [tuple(getattr(k, "key", getattr(k, "idx", k)) for k in p)
              for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert paths == jpaths


def test_tree_sizes_cast_and_zeros_match_the_reference():
    tree = _tree(np.random.default_rng(1))
    t = _torch(tree)
    assert pytree.tree_params(t) == jpytree.tree_params(tree)
    assert pytree.tree_bytes(t) == jpytree.tree_bytes(tree)
    bf = pytree.tree_cast(t, torch.bfloat16)
    assert pytree.tree_bytes(bf) == jpytree.tree_bytes(
        jpytree.tree_cast(tree, jnp.bfloat16))
    # the cast rounds as the reference's (bf16 round to nearest even): exact
    jbf = jpytree.tree_cast(tree, jnp.bfloat16)
    for g, w in zip(pytree.tree_leaves(bf), jax.tree_util.tree_leaves(jbf)):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    z = pytree.tree_zeros_like(t)
    assert all(not bool(x.any()) for x in pytree.tree_leaves(z))
    ints = pytree.tree_cast({"i": torch.arange(3)}, torch.float32)
    assert ints["i"].dtype == torch.int64  # non-floating leaves untouched


@pytest.mark.parametrize("bad", [None, np.nan, np.inf])
def test_tree_finite_and_global_norm_match_the_reference(bad):
    tree = _tree(np.random.default_rng(2))
    if bad is not None:
        tree["groups"][1]["a"][3] = bad
    t = _torch(tree)
    fin = pytree.tree_finite(t)
    assert fin.dim() == 0 and fin.dtype == torch.bool
    assert bool(fin) == bool(jpytree.tree_finite(tree))
    got = float(pytree.global_norm(t))
    want = float(jpytree.global_norm(tree))
    if bad is None:
        assert got == pytest.approx(want, rel=TOL)
    else:
        assert not np.isfinite(got) and not np.isfinite(want)


def test_global_norm_chunks_a_large_leaf(monkeypatch):
    """A leaf longer than a chunk is summed chunk by chunk."""
    monkeypatch.setattr(pytree, "CHUNK", 7)
    tree = _tree(np.random.default_rng(3))
    assert float(pytree.global_norm(_torch(tree))) == pytest.approx(
        float(jpytree.global_norm(tree)), rel=TOL)


# ---- schedules --------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 40, 99, 100, 150])
def test_cosine_schedule_matches_reference(step):
    for st in (step, torch.tensor(step, dtype=torch.int32)):
        got = schedule.cosine_schedule(st, warmup=10, total=100)
        assert got.dtype == torch.float32 and got.dim() == 0
        want = jschedule.cosine_schedule(step, warmup=10, total=100)
        assert float(got) == pytest.approx(float(want), rel=TOL, abs=TOL)
    assert float(schedule.constant_schedule(torch.tensor(step))) == 1.0


def test_cosine_schedule_shape():
    assert float(schedule.cosine_schedule(0, warmup=10, total=100)) == 0.0
    assert float(schedule.cosine_schedule(10, warmup=10, total=100)) == \
        pytest.approx(1.0, abs=1e-3)
    assert float(schedule.cosine_schedule(100, warmup=10, total=100)) == \
        pytest.approx(0.1, abs=1e-3)


# ---- AdamW ------------------------------------------------------------------

def _adamw_pair(tree, grads_seq, cfg_kw, lr_scales, param_dtype=np.float32):
    """The same param tree and gradient sequence through both optimizers;
    returns (port params, port state, port metrics list, reference
    params, reference state, reference metrics list)."""
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.dtype(param_dtype)), tree)
    p = pytree.tree_map(
        lambda a: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
        .to(getattr(torch, jnp.dtype(param_dtype).name)), jp)
    jst, st = jadamw_init(jp), adamw_init(p)
    jm_all, m_all = [], []
    for g, s in zip(grads_seq, lr_scales):
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        jp, jst, jm = jadamw_update(JAdamWConfig(**cfg_kw), jg, jst, jp,
                                    jnp.float32(s))
        p_before = p
        p, st, m = adamw_update(AdamWConfig(**cfg_kw), _torch(g), st, p,
                                torch.tensor(s, dtype=torch.float32))
        assert p is p_before  # updated in place
        jm_all.append(jm)
        m_all.append(m)
    return p, st, m_all, jp, jst, jm_all


@pytest.mark.parametrize("cfg_kw", [
    {},
    {"lr": 1e-2, "weight_decay": 0.0, "grad_clip": 0.5},
    {"lr": 3e-3, "b1": 0.8, "b2": 0.99, "eps": 1e-6, "skip_nonfinite": False},
], ids=["default", "clip-no-decay", "betas"])
def test_adamw_matches_reference_over_steps(cfg_kw):
    rng = np.random.default_rng(4)
    tree = _tree(rng)
    grads = [pytree.tree_map(lambda a: (rng.standard_normal(a.shape) * s)
                             .astype(np.float32), tree)
             for s in (0.1, 3.0, 0.01, 1.0)]
    p, st, m, jp, jst, jm = _adamw_pair(tree, grads, cfg_kw,
                                        [0.1, 1.0, 0.5, 0.9])
    _close(p, jp)
    _close(st["master"], jst["master"])
    _close(st["m"], jst["m"])
    _close(st["v"], jst["v"])
    assert st["step"].dtype == torch.int32 and st["step"].dim() == 0
    assert int(st["step"]) == int(jst["step"]) == 4
    for a, b in zip(m, jm):
        assert float(a["grad_norm"]) == pytest.approx(float(b["grad_norm"]),
                                                      rel=TOL)
        assert float(a["step_ok"]) == float(b["step_ok"]) == 1.0


def test_adamw_decays_matrices_only():
    """Zero gradients and no moments: only the ndim >= 2 leaves move, by
    the decoupled decay, as the reference's."""
    tree = _tree(np.random.default_rng(5))
    zeros = pytree.tree_map(np.zeros_like, tree)
    p, st, _, jp, jst, _ = _adamw_pair(
        tree, [zeros], {"lr": 0.1, "weight_decay": 0.5}, [1.0])
    _close(p, jp)
    np.testing.assert_array_equal(p["bias"].numpy(), tree["bias"])
    np.testing.assert_array_equal(p["groups"][1]["a"].numpy(),
                                  tree["groups"][1]["a"])
    assert not np.array_equal(p["embed"].numpy(), tree["embed"])
    assert not np.array_equal(p["blocks"]["scale"].numpy(),
                              tree["blocks"]["scale"])


def test_adamw_skips_a_nonfinite_step_as_the_reference():
    rng = np.random.default_rng(6)
    tree = _tree(rng)
    good = pytree.tree_map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree)
    bad = pytree.tree_map(np.copy, good)
    bad["blocks"]["w"][1, 2, 3] = np.nan
    p, st, m, jp, jst, jm = _adamw_pair(tree, [good, bad, good], {},
                                        [1.0, 1.0, 1.0])
    _close(p, jp)
    _close(st["m"], jst["m"])
    _close(st["v"], jst["v"])
    assert int(st["step"]) == int(jst["step"]) == 2
    assert [float(x["step_ok"]) for x in m] == \
        [float(x["step_ok"]) for x in jm] == [1.0, 0.0, 1.0]


def test_adamw_bf16_params_keep_an_f32_master():
    """bf16 params: the master is f32 and never aliases the param; the
    param is the master rounded, as the reference's."""
    rng = np.random.default_rng(7)
    tree = _tree(rng)
    grads = [pytree.tree_map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree) for _ in range(2)]
    p, st, _, jp, jst, _ = _adamw_pair(tree, grads, {}, [1.0, 1.0],
                                       param_dtype=jnp.bfloat16)
    assert p["embed"].dtype == torch.bfloat16
    assert st["master"]["embed"].dtype == torch.float32
    _close(st["master"], jst["master"])
    for g, w in zip(pytree.tree_leaves(p), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    f32 = {"w": torch.ones(3)}
    assert adamw_init(f32)["master"]["w"].data_ptr() != f32["w"].data_ptr()


def test_adamw_chunked_update_equals_whole_leaves(monkeypatch):
    """Chunking the update (a leaf in flat pieces) changes nothing."""
    rng = np.random.default_rng(8)
    tree = _tree(rng)
    grads = [pytree.tree_map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree) for _ in range(2)]
    whole = _adamw_pair(tree, grads, {}, [1.0, 1.0])[0]
    monkeypatch.setattr(pytree, "CHUNK", 5)
    chunked = _adamw_pair(tree, grads, {}, [1.0, 1.0])[0]
    for a, b in zip(pytree.tree_leaves(whole), pytree.tree_leaves(chunked)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def test_adamw_converges_on_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        grads = {"w": params["w"] - target}
        params, opt, _ = adamw_update(cfg, grads, opt, params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(2)}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=1.0, grad_clip=1e-3, weight_decay=0.0)
    params, _, m = adamw_update(cfg, {"w": torch.full((2,), 1e9)}, opt, params)
    assert float(params["w"].abs().max()) < 2.0
    assert float(m["grad_norm"]) > 1e8


# ---- compression ------------------------------------------------------------

def test_quantize_matches_reference_given_q():
    """Everything that does not depend on the draw is the reference's:
    the scale exactly, q within one step of x / scale (stochastic rounding
    of the same value), the dequantisation and the residual given q."""
    rng = np.random.default_rng(9)
    g = {"w": (rng.standard_normal((64, 3)) * 0.2).astype(np.float32),
         "b": rng.standard_normal((17,)).astype(np.float32)}
    r = {"w": (0.01 * rng.standard_normal((64, 3))).astype(np.float32),
         "b": np.zeros(17, np.float32)}
    gen = torch.Generator().manual_seed(0)
    c, res = comp.compress_grads(_torch(g), _torch(r), gen)
    jc, _ = jcomp.compress_grads(g, r, jax.random.PRNGKey(0))
    for k in g:
        x = g[k] + r[k]
        assert c[k].q.dtype == torch.int8
        # scale: bitwise the reference's (it does not depend on the draw)
        assert float(c[k].scale) == float(jc[k].scale)
        scaled = x / np.float32(c[k].scale)
        assert np.abs(c[k].q.numpy() - scaled).max() <= 1.0
        # given the port's q, the reference's dequantisation and residual
        jleaf = jcomp.CompressedLeaf(jnp.asarray(c[k].q.numpy()),
                                     jnp.asarray(c[k].scale.numpy()))
        deq = np.asarray(jcomp.dequantize_int8(jleaf))
        np.testing.assert_array_equal(comp.dequantize_int8(c[k]).numpy(), deq)
        np.testing.assert_array_equal(res[k].numpy(),
                                      np.asarray(jnp.asarray(x) - deq))
    d = comp.decompress_grads(c)
    assert set(d) == {"w", "b"} and d["w"].dtype == torch.float32
    z = comp.residual_zeros(_torch(g))
    assert z["w"].dtype == torch.float32 and not bool(z["w"].any())


def test_compression_draws_come_from_the_generator():
    x = {"w": torch.randn(512, generator=torch.Generator().manual_seed(1))}
    r = comp.residual_zeros(x)
    a = comp.compress_grads(x, r, torch.Generator().manual_seed(5))[0]
    b = comp.compress_grads(x, r, torch.Generator().manual_seed(5))[0]
    c = comp.compress_grads(x, r, torch.Generator().manual_seed(6))[0]
    assert torch.equal(a["w"].q, b["w"].q)
    assert not torch.equal(a["w"].q, c["w"].q)


def test_compression_error_feedback_unbiased():
    g = {"w": torch.randn(256, generator=torch.Generator().manual_seed(0))}
    res = comp.residual_zeros(g)
    gen = torch.Generator().manual_seed(0)
    acc = torch.zeros(256)
    for _ in range(50):
        c, res = comp.compress_grads(g, res, gen)
        acc = acc + comp.decompress_grads(c)["w"]
    # error feedback keeps the long-run average unbiased (the reference's
    # test and limit)
    np.testing.assert_allclose((acc / 50).numpy(), g["w"].numpy(), atol=0.02)


def test_compression_wire_savings_and_bytes_match_the_reference():
    x = np.random.default_rng(10).standard_normal(1024).astype(np.float32)
    c, _ = comp.compress_grads({"w": torch.from_numpy(x)},
                               comp.residual_zeros({"w": torch.zeros(1024)}),
                               torch.Generator().manual_seed(0))
    jc, _ = jcomp.compress_grads({"w": x}, {"w": np.zeros(1024, np.float32)},
                                 jax.random.PRNGKey(0))
    raw = 1024 * 4
    qs = {"w": c["w"].q}
    assert comp.wire_bytes(qs) < raw / 3
    assert comp.wire_bytes(qs) == jcomp.wire_bytes({"w": jc["w"].q})
    assert comp.wire_bytes(c) == jcomp.wire_bytes(jc) == 1024 + 4
