"""The port's LM serving path against the JAX reference, on the CPU.

Parameters come from the JAX ``init_params(..., dtype=float32)`` and cross
into the port with ``lm_params_from_numpy``; tokens are numpy arrays from a
seed. The port runs its plain PyTorch versions here (CPU tensors).

Tolerances, and why:

* logits of ``forward``, of the prefill step and of each decode step:
  ``rtol 1e-4, atol 1e-4`` — float32 products summed in another order
  through a few layers;
* the prefill step's bfloat16 caches: equal after the same cast, except
  where the float32 inputs differ in their last bits and round to
  neighbouring bfloat16 values: at most one bfloat16 ulp;
* greedy tokens: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.lm import model as JLM
from repro_torch import configs
from repro_torch.launch import train as launch
from repro_torch.models.convert import (lm_params_from_numpy,
                                        lm_params_to_numpy)
from repro_torch.models.lm import model as LM
from repro_torch.models.lm.config import (AttnConfig, LayerConfig, LMConfig,
                                          MoEConfig, Segment)

TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(5)
ARCHS = ("granite-3-2b", "yi-34b")


def _cfg(arch):
    return configs.get(arch).reduced()


def _params(cfg, seed=0):
    """JAX float32 params -> (JAX tree, port dict)."""
    jp = JLM.init_params(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    return jp, tp


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


def _bf16_within_one_ulp(port: torch.Tensor, ref) -> None:
    a = port.float().numpy()
    b = np.asarray(ref).astype(np.float32)
    assert a.shape == b.shape
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.float32(1e-30))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(a - b) <= ulp)
    assert np.mean(a == b) > 0.99


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (2, 7, 3, 16)).astype(np.float32)
    gamma = rng.normal(0, 0.1, 16).astype(np.float32)
    _close(LM.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma)),
           JLM.rms_norm(jnp.asarray(x), jnp.asarray(gamma)), rtol=1e-6,
           atol=1e-6)
    pos = np.arange(40, 47)
    for theta in (10000.0, 5000000.0):
        _close(LM.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               JLM.rope(jnp.asarray(x), jnp.asarray(pos), theta), rtol=1e-5,
               atol=1e-5)


def test_param_shapes_match_the_jax_tree_at_full_size():
    for arch in ARCHS:
        cfg = configs.get(arch).config()
        jshapes = jax.tree.map(
            lambda s: tuple(s.shape),
            jax.eval_shape(lambda: JLM.init_params(KEY, cfg, jnp.float32)))
        assert LM.param_shapes(cfg) == jshapes
    cfg = configs.get("granite-3-2b").config()
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        LM.param_shapes(cfg), is_leaf=lambda s: isinstance(s, tuple)))
    assert cfg.param_count() == 2_533_531_648
    assert n == cfg.param_count() + (cfg.vocab_padded - cfg.vocab) * 2048


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    cfg = _cfg(arch)
    jp, tp = _params(cfg)
    tok = _tokens(cfg, (2, 24))
    lj, _, _ = JLM.forward(jp, jnp.asarray(tok), cfg)
    lt, aux, caches = LM.forward(tp, torch.from_numpy(tok), cfg)
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (2, 24, cfg.vocab)
    assert aux == 0.0 and caches is None
    _close(lt, lj)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    """Prefill: last logits and bfloat16 caches. Then three decode steps from
    the same caches (the JAX ones, carried across), as ``serve_lm`` runs
    them: the prompt of 20 is followed by 3 zero tokens in the prefill."""
    cfg = _cfg(arch)
    jp, tp = _params(cfg, seed=1)
    b, s_ctx, new = 2, 20, 3
    tok = np.concatenate([_tokens(cfg, (b, s_ctx), 1),
                          np.zeros((b, new), np.int64)], 1)
    last_j, cj = jax.jit(JLM.make_prefill_step(cfg, b, s_ctx + new))(
        jp, jnp.asarray(tok, jnp.int32))
    last_t, ct = LM.make_prefill_step(cfg, b, s_ctx + new)(
        tp, torch.from_numpy(tok))
    _close(last_t, last_j)
    flat_j = jax.tree.leaves(cj)
    flat_t = [ct["seg0"]["sub0"]["k"], ct["seg0"]["sub0"]["v"]]
    assert len(flat_j) == 2
    for t, j in zip(flat_t, flat_j):
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        _bf16_within_one_ulp(t, j)

    ct = {"seg0": {"sub0": {
        name: torch.from_numpy(np.asarray(cj["seg0"]["sub0"][name])
                               .astype(np.float32)).to(torch.bfloat16)
        for name in ("k", "v")}}}
    dec_j = jax.jit(JLM.make_decode_step(cfg))
    dec_t = LM.make_decode_step(cfg)
    nxt = np.asarray(jnp.argmax(last_j, -1))[:, None]
    for i in range(3):
        lj, cj = dec_j(jp, cj, jnp.asarray(nxt, jnp.int32),
                       jnp.asarray(s_ctx + i, jnp.int32))
        lt, ct = dec_t(tp, ct, torch.tensor(nxt), s_ctx + i)
        _close(lt, lj)
        nxt = np.asarray(jnp.argmax(lj, -1))[:, None]


def _tiny(window=None):
    """tests/test_lm.py's small GQA config."""
    gqa = AttnConfig(kind="gqa", n_heads=4, n_kv_heads=2, d_head=16,
                     window=window)
    return LMConfig(name="t", d_model=32, vocab=101,
                    segments=(Segment(2, (LayerConfig(gqa, d_ff=64),)),))


def test_window_ring_cache_decode_matches_jax():
    """tests/test_lm.py::test_window_ring_cache_decode_long on both sides:
    prefill 24 tokens into a ring of 8, then decode past the window."""
    cfg = _tiny(window=8)
    jp, tp = _params(cfg, seed=3)
    s = 24
    tok = _tokens(cfg, (1, s), 3)
    nxt = _tokens(cfg, (1, 1), 4)

    cj = JLM.init_cache(cfg, 1, s + 8, dtype=jnp.float32)
    _, _, cj = JLM.forward(jp, jnp.asarray(tok), cfg, caches=cj, cache_pos=0,
                           kv_len=s)
    lj, _ = jax.jit(JLM.make_decode_step(cfg))(jp, cj, jnp.asarray(nxt),
                                               jnp.asarray(s, jnp.int32))
    ct = LM.init_cache(cfg, 1, s + 8, dtype=torch.float32)
    assert ct["seg0"]["sub0"]["k"].shape[2] == 8        # ring-buffered
    _, _, ct = LM.forward(tp, torch.from_numpy(tok), cfg, caches=ct,
                          cache_pos=0, kv_len=s)
    for name in ("k", "v"):
        _close(ct["seg0"]["sub0"][name], cj["seg0"]["sub0"][name])
    lt, _ = LM.make_decode_step(cfg)(tp, ct, torch.from_numpy(nxt), s)
    _close(lt, lj)
    full, _, _ = LM.forward(tp, torch.from_numpy(np.concatenate([tok, nxt],
                                                                1)), cfg)
    _close(lt, full[:, -1], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_a_jax_greedy_loop(arch):
    cfg = _cfg(arch)
    jp, tp = _params(cfg, seed=2)
    b, s_ctx, new = 2, 12, 5
    prompts = _tokens(cfg, (b, s_ctx), 2)
    prefill = jax.jit(JLM.make_prefill_step(cfg, b, s_ctx + new))
    decode = jax.jit(JLM.make_decode_step(cfg))
    last, caches = prefill(jp, jnp.concatenate(
        [jnp.asarray(prompts, jnp.int32), jnp.zeros((b, new), jnp.int32)], 1))
    tok = jnp.argmax(last, -1)[:, None].astype(jnp.int32)
    want = [tok]
    for i in range(new - 1):
        lg, caches = decode(jp, caches, tok, jnp.asarray(s_ctx + i, jnp.int32))
        tok = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, 1))
    got = launch.generate(tp, cfg, prompts, new, "cpu")
    assert got.tokens.shape == (b, new)
    np.testing.assert_array_equal(got.tokens, want)
    assert got.prefill_s > 0 and got.decode_s > 0


def test_mla_and_moe_are_not_ported_yet():
    mla = LMConfig(name="m", d_model=32, vocab=64, segments=(Segment(1, (
        LayerConfig(AttnConfig(kind="mla", n_heads=2, kv_lora=16, d_rope=8,
                               d_nope=8, d_v=8), d_ff=32),)),))
    moe = LMConfig(name="e", d_model=32, vocab=64, segments=(Segment(1, (
        LayerConfig(AttnConfig(n_heads=2, n_kv_heads=2, d_head=8),
                    moe=MoEConfig(n_experts=4, top_k=2, d_ff=16)),)),))
    gen = torch.Generator().manual_seed(0)
    for cfg, what in ((mla, "MLA"), (moe, "MoE")):
        with pytest.raises(NotImplementedError, match=what):
            LM.init_params(cfg, gen)
    with pytest.raises(NotImplementedError, match="MLA"):
        LM.init_cache(mla, 1, 8)


def test_registry_holds_only_ported_archs():
    gnns = ("gcn", "graphsage", "gat", "pna", "meshgraphnet", "schnet")
    assert sorted(configs.REGISTRY) == sorted(ARCHS + gnns)
    for arch in ARCHS:
        for which in ("config", "reduced"):
            mine = getattr(configs.get(arch), which)()
            ref = getattr(jconfigs.get(arch), which)()
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for arch in gnns:             # the paper's three models and the zoo's
        for which in ("config", "reduced"):
            mine = getattr(configs.get(arch), which)()
            ref = getattr(jconfigs.get(arch), which)()
            assert (mine.name, mine.d_edge_attr, mine.needs_weights) == \
                (ref.name, ref.d_edge_attr, ref.needs_weights)
            m, r = mine.make(602, 41), ref.make(602, 41)
            want = dataclasses.asdict(r)        # every field of the model
            assert {k: getattr(m, k) for k in want} == want
            assert m.comm_dims() == r.comm_dims()
    for arch in ("gemma2-27b", "nequip", "dlrm-mlperf"):
        with pytest.raises(KeyError, match="not ported yet"):
            configs.get(arch)


def test_lm_params_conversion_checks_every_key():
    cfg = _cfg("granite-3-2b")
    tree = jax.tree.map(np.asarray, JLM.init_params(KEY, cfg))   # bfloat16
    tp = lm_params_from_numpy(tree, cfg)
    assert tp["embed"].dtype == torch.bfloat16
    back = lm_params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b.astype(np.float32))
    f32 = lm_params_from_numpy(tree, cfg, dtype=torch.float32)
    assert f32["seg0"]["sub0"]["attn"]["wq"].dtype == torch.float32

    missing = jax.tree.map(lambda x: x, tree)
    del missing["seg0"]["sub0"]["ffn"]["up"]
    with pytest.raises(KeyError, match="seg0/sub0/ffn/up"):
        lm_params_from_numpy(missing, cfg)
    extra = dict(tree, unembed=tree["embed"].T)
    with pytest.raises(KeyError, match="unembed"):
        lm_params_from_numpy(extra, cfg)
    bad = dict(tree, ln_final=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="ln_final"):
        lm_params_from_numpy(bad, cfg)


def test_entry_point_needs_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                          capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "granite-3-2b", "--serve", "--reduced", "--batch", "2",
            "--seq", "8", "--decode-tokens", "3"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(argv)
    launch.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "decoded 2x3 tokens" in out and "sample:" in out
    for bad in (["--arch", "nequip"], ["--arch", "granite-3-2b"]):
        with pytest.raises(SystemExit, match="not ported yet"):
            launch.main(bad)
    # --scenario is ported: it trains on the card, so without one it raises
    # (tests/test_torch_scenarios.py runs it on the CPU)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--scenario", "smoke"])
