"""The encoder-decoder (audio) family on the CPU: the port's
``models/encdec.py`` against the reference's on the same params and
inputs: the encoder, the teacher-forced forward, prefill with its cross
cache and decode steps, and serving with frames as side inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.registry as jregistry
from repro.models import encdec as jencdec
from repro.models.api import build_model as jbuild_model
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServingEngine as JServingEngine
import repro_torch.configs.registry as registry
from repro_torch.launch import serve as launch_serve
from repro_torch.models import encdec
from repro_torch.models.api import build_model
from repro_torch.models.lm import params_from_jax
from repro_torch.serve.engine import ServeConfig, ServingEngine

# the suite runs in several worker processes on one host: one intra-op
# thread each keeps torch from oversubscribing the cores that the
# timing-sensitive reference tests share
torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
ATOL = 2e-4


@pytest.fixture(scope="module")
def pair():
    """(reference model, port model, reference params, port params), f32,
    with the norm biases perturbed so that every parameter takes part."""
    jm = jbuild_model(jregistry.smoke_config(ARCH).replace(dtype="float32"))
    m = build_model(registry.smoke_config(ARCH).replace(dtype="float32"))
    pnp = jax.tree_util.tree_map(np.array, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for stack in ("enc_blocks", "dec_blocks"):
        for ln in [k for k in pnp[stack] if k.startswith("ln")]:
            for k in pnp[stack][ln]:
                pnp[stack][ln][k] += (0.1 * rng.standard_normal(
                    pnp[stack][ln][k].shape)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, pnp)
    return jm, m, jp, params_from_jax(pnp, "cpu")


def _inputs(cfg, b=2, s_enc=12, s_dec=10, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (b, s_dec)).astype(np.int32)
    return frames, toks


def test_encoder_matches_reference(pair):
    jm, m, jp, tp = pair
    frames, _ = _inputs(m.cfg)
    ref = jencdec.encode(jm.cfg, jp, jnp.asarray(frames))
    got = encdec.encode(m.cfg, tp, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_forward_and_loss_match_reference(pair):
    jm, m, jp, tp = pair
    frames, toks = _inputs(m.cfg)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks),
          "labels": jnp.asarray(labels)}
    tb = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels)}
    jl, _ = jm.forward(jp, jb)
    tl, aux = m.forward(tp, tb)
    assert tl.dtype == torch.float32 and float(aux) == 0.0
    assert tuple(tl.shape) == (2, 10, m.cfg.vocab_padded)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    (jt, jmet), (tt, tmet) = jm.loss(jp, jb), m.loss(tp, tb)
    np.testing.assert_allclose(float(tt), float(jt), atol=ATOL)
    assert float(tmet["acc"]) == float(jmet["acc"])


def test_prefill_and_decode_match_reference_and_forward(pair):
    """prefill(S-1) + decode steps: logits and caches as the reference's;
    and the teacher-forced forward's logits at the same positions."""
    jm, m, jp, tp = pair
    frames, toks = _inputs(m.cfg, s_dec=12, seed=1)
    s, s_max = 9, 24
    jl, jc = jm.prefill(jp, {"frames": jnp.asarray(frames),
                             "tokens": jnp.asarray(toks[:, :s])}, s_max)
    tl, tc = m.prefill(tp, {"frames": torch.from_numpy(frames),
                            "tokens": torch.from_numpy(toks[:, :s])}, s_max)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    assert tc["self"].length == s and tc["cross"].length == frames.shape[1]
    np.testing.assert_allclose(tc["cross"].k.numpy(),
                               np.asarray(jc["cross"].k), atol=1e-5)
    cross_k = tc["cross"].k.clone()
    for i in range(3):
        tok = toks[:, s + i:s + i + 1]
        jl, jc = jm.decode(jp, jnp.asarray(tok), jc)
        tl, tc = m.decode(tp, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
    assert tc["self"].length == s + 3 == int(jc["self"].length[0])
    np.testing.assert_allclose(tc["self"].k.numpy(),
                               np.asarray(jc["self"].k), atol=1e-5)
    assert torch.equal(tc["cross"].k, cross_k)  # projected once, at prefill
    full, _ = m.forward(tp, {"frames": torch.from_numpy(frames),
                             "tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl[:, -1].numpy(), full[:, s + 2].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_init_params_and_cache_match_reference_layout():
    cfg = registry.smoke_config(ARCH)
    jcfg = jregistry.smoke_config(ARCH)
    ref = jax.eval_shape(lambda: jencdec.init_params(jax.random.PRNGKey(0),
                                                      jcfg))
    got = encdec.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    for path, leaf in leaves:
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[1] == str(leaf.dtype)
    jc = jbuild_model(jcfg).init_cache(2, 16, 7)
    tc = build_model(cfg).init_cache(2, 16, 7, device="cpu")
    for part in ("self", "cross"):
        assert tuple(tc[part].k.shape) == jc[part].k.shape
        assert tc[part].length == 0
    # s_enc defaults to s_max, as the reference's
    assert build_model(cfg).init_cache(1, 8, device="cpu")["cross"].k.shape[2] == 8


def test_params_from_jax_carries_the_encdec_tree():
    """The reference's bf16 encoder-decoder params: the same keys and
    stacked layouts, the norms (``ln_x``, ``enc_norm`` too) f32."""
    jcfg = jregistry.smoke_config(ARCH)  # bfloat16
    jp = jencdec.init_params(jax.random.PRNGKey(2), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert set(tp) == set(jp) and set(tp["dec_blocks"]) == set(
        jp["dec_blocks"])
    assert tp["dec_blocks"]["ln_x"]["bias"].dtype == torch.float32
    assert tp["enc_norm"]["scale"].dtype == torch.float32
    assert tp["dec_blocks"]["xattn"]["wk"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["dec_blocks"]["xattn"]["wk"].float().numpy(),
        np.asarray(jp["dec_blocks"]["xattn"]["wk"], np.float32))


def test_serving_with_frames_matches_reference(pair):
    """ServingEngine with frames as a side input (one scatter-gather TX
    with the prompts under INTERRUPT): the reference's greedy tokens."""
    jm, m, jp, tp = pair
    frames, toks = _inputs(m.cfg, b=2, s_enc=8, s_dec=6, seed=2)
    jeng = JServingEngine(jm, jp, JServeConfig(max_seq=32))
    eng = ServingEngine(m, tp, ServeConfig(max_seq=32))
    try:
        ref = [r.tokens for r in jeng.generate(
            toks, 5, extra_inputs={"frames": frames})]
        got = [r.tokens for r in eng.generate(
            toks, 5, extra_inputs={"frames": frames})]
        assert eng.engine.tx_bytes_total == toks.nbytes + frames.nbytes
    finally:
        jeng.close()
        eng.close()
    np.testing.assert_array_equal(np.stack(got), np.stack(ref))


def test_launch_serve_audio_on_the_cpu(capsys):
    res = launch_serve.main(["--device", "cpu", "--arch", ARCH, "--batch",
                             "2", "--prompt-len", "6", "--new-tokens", "3"])
    assert len(res) == 2 and res[0].tokens.shape == (3,)
    assert "req1: prefill=" in capsys.readouterr().out
