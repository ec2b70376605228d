"""The MoE layer on the CPU: the port's ``moe_apply`` against the
reference's at the granite and deepseek smoke shapes (the same params and
inputs, through ``params_from_jax``), the reference's own layer tests
mirrored on the port, and the moe model end to end."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.registry as jregistry
from repro.models import lm as jlm
from repro.models.api import build_model as jbuild_model
from repro.models.layers import moe as jmoe
import repro_torch.configs.registry as registry
from repro_torch.models import lm
from repro_torch.models.api import build_model
from repro_torch.models.layers import moe
from repro_torch.utils import trace

# the suite runs in several worker processes on one host: one intra-op
# thread each keeps torch from oversubscribing the cores that the
# timing-sensitive reference tests share
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
SMOKE = ["granite-moe-1b-a400m", "deepseek-moe-16b"]


def _layer(arch, dtype):
    """The reference's params of one moe layer at ``arch``'s smoke shape,
    as numpy arrays, and that smoke config."""
    cfg = jregistry.smoke_config(arch)
    p = jmoe.moe_params(KEY, cfg.d_model, cfg.n_experts,
                        cfg.d_expert or cfg.d_ff, cfg.n_shared_experts,
                        getattr(jnp, dtype))
    return jax.tree_util.tree_map(np.asarray, p), cfg


def _both(p_np, x_np, dtype, **kw):
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = lm.params_from_jax(p_np, "cpu")
    jx = jnp.asarray(x_np, getattr(jnp, dtype))
    tx = torch.from_numpy(x_np).to(getattr(torch, dtype))
    return jmoe.moe_apply(jp, jx, **kw), moe.moe_apply(tp, tx, **kw)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", SMOKE)
def test_moe_apply_matches_reference(arch, capacity_factor):
    p, cfg = _layer(arch, "float32")
    assert p["router"].dtype == np.float32
    x = np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    (jo, jm), (to, tm) = _both(p, x, "float32", top_k=cfg.top_k,
                               capacity_factor=capacity_factor)
    assert to.shape == x.shape and to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    assert float(tm.dropped_frac) == float(jm.dropped_frac)
    np.testing.assert_allclose(float(tm.aux_loss), float(jm.aux_loss),
                               rtol=0, atol=1e-6)
    if capacity_factor < 1:
        assert float(tm.dropped_frac) > 0


@pytest.mark.parametrize("arch,grouped", [
    *(pytest.param(a, False, id=a) for a in SMOKE),
    *(pytest.param(a, True, id=f"{a}-grouped") for a in SMOKE)])
def test_moe_apply_bf16_matches_reference(arch, grouped):
    """bf16 activations and experts, f32 router: the same routing, outputs
    within bf16's limit (the k-by-k combine rounds to bf16 on both
    sides). Grouped: at the capacity that seats every token, with no grad,
    the port's experts over their own seats against the reference's
    padded buffer, the same aux loss."""
    p, cfg = _layer(arch, "bfloat16")
    assert p["router"].dtype == np.float32
    x = np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    t = x.shape[0] * x.shape[1]
    kw = dict(top_k=cfg.top_k)
    if grouped:
        kw["capacity_factor"] = cfg.n_experts / cfg.top_k
    jo, jm = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x, jnp.bfloat16), **kw)
    with torch.no_grad(), trace.tally() as counts:
        to, tm = moe.moe_apply(lm.params_from_jax(p, "cpu"),
                               torch.from_numpy(x).to(torch.bfloat16),
                               ragged_tokens=t if grouped else 0, **kw)
    assert counts["moe.seats"] == cfg.top_k * t
    assert (counts["moe.rows"] == cfg.top_k * t) == grouped
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), rtol=2e-2,
                               atol=2e-2)
    assert float(tm.dropped_frac) == float(jm.dropped_frac)
    if grouped:
        assert float(tm.dropped_frac) == 0
        np.testing.assert_allclose(float(tm.aux_loss), float(jm.aux_loss),
                                   rtol=0, atol=1e-6)


def test_routing_matches_reference_seat_by_seat():
    """The k-major seats: at a capacity that drops, the same (token, slot)
    pairs are kept; a token's primary expert is seated before any
    secondary one."""
    p, cfg = _layer("granite-moe-1b-a400m", "float32")
    x = np.random.default_rng(3).standard_normal(
        (1, 32, cfg.d_model)).astype(np.float32)
    for cf in (0.25, 0.5, 1.0):
        (jo, jm), (to, tm) = _both(p, x, "float32", top_k=cfg.top_k,
                                   capacity_factor=cf)
        assert float(tm.dropped_frac) == float(jm.dropped_frac)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)


def test_shard_experts_is_the_identity():
    t = torch.ones(2, 3)
    assert moe._shard_experts(t, ("model", None)) is t


# ---- the reference's tests/test_layers.py MoE tests, on the port ---------

def _port_layer(d, n_experts, d_expert, n_shared, seed=0):
    return moe.moe_params(torch.Generator().manual_seed(seed), d, n_experts,
                          d_expert, n_shared, torch.float32, "cpu")


def test_moe_no_drops_at_high_capacity():
    p = _port_layer(32, 4, 16, 1)
    x = torch.randn((2, 8, 32), generator=torch.Generator().manual_seed(9))
    out, m = moe.moe_apply(p, x, top_k=2, capacity_factor=8.0)
    assert out.shape == x.shape
    assert float(m.dropped_frac) == 0.0
    assert np.isfinite(float(m.aux_loss))


def test_moe_capacity_drops_pass_through():
    p = _port_layer(16, 4, 8, 0)
    x = torch.randn((1, 16, 16), generator=torch.Generator().manual_seed(9))
    out, m = moe.moe_apply(p, x, top_k=2, capacity_factor=0.1)
    assert float(m.dropped_frac) > 0.3
    assert bool(torch.isfinite(out).all())


def test_moe_permutation_equivariance():
    p = _port_layer(16, 4, 8, 0)
    g = torch.Generator().manual_seed(11)
    x = torch.randn((1, 12, 16), generator=g)
    perm = torch.randperm(12, generator=g)
    y1, _ = moe.moe_apply(p, x, top_k=2, capacity_factor=16.0)
    y2, _ = moe.moe_apply(p, x[:, perm], top_k=2, capacity_factor=16.0)
    torch.testing.assert_close(y1[:, perm], y2, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_params_shapes_and_dtypes_match_reference(dtype):
    cfg = registry.smoke_config("deepseek-moe-16b").replace(dtype=dtype)
    jcfg = jregistry.smoke_config("deepseek-moe-16b").replace(dtype=dtype)
    ref = jax.eval_shape(lambda: jlm.init_params(KEY, jcfg))
    got = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[1] == str(leaf.dtype)
    assert got["blocks"]["moe"]["router"].dtype == torch.float32


def test_params_from_jax_carries_the_moe_tree_with_an_f32_router():
    """The reference's bf16 moe params, router and norms f32, carried
    over leaf by leaf with their dtypes."""
    jcfg = jregistry.smoke_config("deepseek-moe-16b")  # bfloat16
    jp = jlm.init_params(KEY, jcfg)
    tp = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    got = tp["blocks"]["moe"]
    assert got["router"].dtype == torch.float32
    assert got["we_up"].dtype == got["ws_down"].dtype == torch.bfloat16
    assert tp["blocks"]["ln2"]["scale"].dtype == torch.float32
    for k, v in jp["blocks"]["moe"].items():
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(v, np.float32))


def test_moe_model_aux_loss_is_the_sum_over_layers():
    """layer_apply returns each layer's router loss and the stack sums it,
    as the reference's scan does."""
    jcfg = jregistry.smoke_config("granite-moe-1b-a400m").replace(
        dtype="float32")
    cfg = registry.smoke_config("granite-moe-1b-a400m").replace(
        dtype="float32")
    jp = jbuild_model(jcfg).init(KEY)
    tp = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16))
    _, jaux = jlm.forward(jcfg, jp, jnp.asarray(toks, jnp.int32))
    logits, aux = build_model(cfg).forward(tp, {"tokens": torch.from_numpy(
        toks)})
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
    assert float(aux) > 0


# ---- the experts over their own seats, chosen by the call's shape --------

def _dropless_smoke():
    """granite-moe's smoke config, bf16, at the capacity that seats every
    token at every expert; ``moe_ragged_tokens`` left at its default."""
    cfg = registry.smoke_config("granite-moe-1b-a400m")
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)


@pytest.mark.parametrize("shape,grad,dropless,grouped", [
    ((1, 256), False, True, True),
    ((2, 128), False, True, True),  # a batch of prompts
    ((64, 1), False, True, False),  # one token a row: a decode step
    ((1, 256), True, True, False),
    ((1, 256), False, False, False),  # capacity 1.25: seats can drop
    ((1, 16), False, True, True),  # a short prompt
])
def test_a_model_routes_by_the_calls_shape(monkeypatch, shape, grad,
                                           dropless, grouped):
    """A model whose config leaves ``moe_ragged_tokens`` unset runs each
    expert over its own seats on a bf16, no-grad, dropless prefill of any
    length, and the padded buffer on a one-token step, with grad on, or
    where a seat can drop; ``moe.rows`` / ``moe.seats`` tick K*T / K*T on
    the first, E*C / K*T on the second, a layer each."""
    cfg = _dropless_smoke() if dropless else registry.smoke_config(
        "granite-moe-1b-a400m")
    assert cfg.moe_ragged_tokens == 1 and cfg.dtype == "bfloat16"
    calls = []
    real = moe._ragged_experts
    monkeypatch.setattr(moe, "_ragged_experts",
                        lambda *a: calls.append(1) or real(*a))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, shape))
    with torch.set_grad_enabled(grad), trace.tally() as counts:
        logits, _ = model.forward(params, {"tokens": toks})
    assert bool(torch.isfinite(logits.float()).all())
    t = shape[0] * shape[1]
    seats = cfg.top_k * t
    cap = math.ceil(cfg.top_k * t / cfg.n_experts * cfg.capacity_factor)
    assert len(calls) == (cfg.n_layers if grouped else 0)
    assert counts == {"moe.rows": cfg.n_layers * (
        seats if grouped else cfg.n_experts * cap),
        "moe.seats": cfg.n_layers * seats}


@pytest.mark.parametrize("ragged_tokens", [0, 20])
def test_the_counters_tick_the_rows_each_route_computes(ragged_tokens):
    """One call of the layer: ``moe.rows`` E*C on the padded buffer, K*T
    over the experts' own seats; ``moe.seats`` K*T on both. A call
    outside a tally with no profiler recording keeps nothing."""
    e, k, t = 8, 3, 20
    p = moe.moe_params(torch.Generator().manual_seed(9), 32, e, 16, 0,
                       torch.bfloat16)
    x = torch.randn((1, t, 32), generator=torch.Generator().manual_seed(4))
    cf = e / k  # capacity T: dropless
    with torch.no_grad(), trace.tally() as counts:
        moe.moe_apply(p, x.to(torch.bfloat16), top_k=k, capacity_factor=cf,
                      ragged_tokens=ragged_tokens)
    assert counts == {"moe.rows": k * t if ragged_tokens else e * t,
                      "moe.seats": k * t}
    before = trace.counters()
    with torch.no_grad():
        moe.moe_apply(p, x.to(torch.bfloat16), top_k=k, capacity_factor=cf,
                      ragged_tokens=ragged_tokens)
    assert trace.counters() == before


@pytest.mark.parametrize("e,n,seed", [(8, 60, 0), (72, 2560, 1),
                                      (64, 6, 2), (4, 0, 3)])
def test_the_scatter_seat_counts_are_bincounts(e, n, seed):
    """Each expert's seats summed by a scatter on the device: exactly
    ``torch.bincount``'s counts, dtype and all, experts that take no seat
    included."""
    flat_e = torch.randint(0, e, (n,),
                           generator=torch.Generator().manual_seed(seed))
    got = moe._seat_counts(flat_e, e)
    want = torch.bincount(flat_e, minlength=e)
    assert got.dtype == want.dtype and torch.equal(got, want)
