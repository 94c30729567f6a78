"""The port's LM serving path against the JAX reference, on the CPU.

Parameters come from the JAX ``init_params(..., dtype=float32)`` and cross
into the port with ``lm_params_from_numpy``; tokens are numpy arrays from a
seed. The port runs its plain PyTorch versions here (CPU tensors).

Tolerances, and why:

* logits of ``forward``, of the prefill step and of each decode step, and
  ``moe_ffn``'s output and aux loss: ``rtol 1e-4, atol 1e-4`` — float32
  products summed in another order through a few layers;
* the prefill step's bfloat16 caches (MLA's compressed latent ``ckv``
  too): equal after the same cast, except where the float32 inputs differ
  in their last bits and round to neighbouring bfloat16 values: at most
  one bfloat16 ulp. gemma2 scales its embeddings by sqrt(d_model) = 8, and
  its float32 caches differ by up to 2.1e-6 (measured on its reduced
  config); below |x| ~ 5e-4 that is more than a bfloat16 ulp, so its caches
  may also differ by up to 1e-5 (``CACHE_FLOOR``);
* greedy tokens: equal.

MoE routing is a top-k over float32 probabilities, so the two packages
route alike unless two probabilities tie to within their last bits; the
seeds here make no such tie.
"""
import dataclasses
import functools

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
CACHE_FLOOR = {"gemma2-27b": 1e-5}
KEY = jax.random.PRNGKey(5)
ARCHS = ("granite-3-2b", "yi-34b", "olmoe-1b-7b", "deepseek-v2-236b",
         "gemma2-27b")


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


def _bf16_within_one_ulp(port: torch.Tensor, ref, floor: float = 0.0) -> None:
    a = port.float().numpy()
    b = np.asarray(ref).astype(np.float32)
    assert a.shape == b.shape
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.float32(1e-30))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(a - b) <= np.maximum(ulp, floor))
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
    lj, aux_j, _ = JLM.forward(jp, jnp.asarray(tok), cfg)
    lt, aux, caches = LM.forward(tp, torch.from_numpy(tok), cfg)
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (2, 24, cfg.vocab)
    assert caches is None
    _close(lt, lj)
    # the MoE layers' summed load-balance loss; 0.0 without them
    _close(float(aux), float(aux_j))
    moe = any(lc.moe is not None for _, _, lc, _ in cfg.sub_layers())
    assert moe == (float(aux) > 0)


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
    leaves_t = list(LM.tree_leaves(ct))
    assert len(leaves_t) == len(jax.tree.leaves(cj))
    for path, t in leaves_t:        # GQA k / v, or MLA's latent ckv
        j = functools.reduce(lambda node, key: node[key], path, cj)
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
        assert tuple(t.shape) == j.shape
        _bf16_within_one_ulp(t, j, CACHE_FLOOR.get(arch, 0.0))

    ct = LM.tree_map(lambda j: torch.from_numpy(
        np.asarray(j).astype(np.float32)).to(torch.bfloat16), cj)
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


def _moe_cfg(n_shared=0, capacity_factor=1.25, d=8):
    moe = MoEConfig(n_experts=4, top_k=2, d_ff=16, n_shared=n_shared,
                    d_ff_shared=12 if n_shared else 0,
                    capacity_factor=capacity_factor)
    lc = LayerConfig(AttnConfig(n_heads=2, n_kv_heads=2, d_head=4), moe=moe)
    return LMConfig(name="moe", d_model=d, vocab=64,
                    segments=(Segment(1, (lc,)),)), lc


@pytest.mark.parametrize("case,tokens,capacity_factor,n_shared,groups", [
    ("no drops", 40, 16.0, 1, 1),
    ("heavy drops", 40, 0.1, 0, 1),
    ("two groups", 4200, 1.0, 1, 2)])
def test_moe_ffn_matches_jax(case, tokens, capacity_factor, n_shared,
                             groups):
    """``moe_ffn``'s output and aux loss against the reference's, with no
    assignment dropped (capacity factor 16), most of them dropped (0.1), and
    the T*k = 8,400 assignments cut into two groups of ``MOE_GROUP``, the
    second padded, whose boundary decides what is dropped."""
    cfg, lc = _moe_cfg(n_shared, capacity_factor)
    jp = JLM.ffn_params(jax.random.PRNGKey(7), cfg, lc, jnp.float32)
    tp = LM.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    assert tp["router"].dtype == torch.float32
    x = np.random.default_rng(8).normal(0, 1, (tokens, 8)).astype(np.float32)
    yj, aux_j = jax.jit(JLM.moe_ffn, static_argnums=2)(jp, jnp.asarray(x),
                                                       lc.moe)
    yt, aux_t = LM.moe_ffn(tp, torch.from_numpy(x), lc.moe)
    assert yt.dtype == torch.float32 and tuple(yt.shape) == (tokens, 8)
    _close(yt, yj)
    _close(float(aux_t), float(aux_j))

    gate_i = LM.moe_route(tp, torch.from_numpy(x), lc.moe)[2]
    keep, dst, (ng, c) = LM.moe_dispatch(gate_i, lc.moe)
    n_assign = tokens * lc.moe.top_k
    assert ng == groups and keep.shape == dst.shape == (n_assign,)
    gl = min(LM.MOE_GROUP, n_assign)
    assert c == int(capacity_factor * gl / lc.moe.n_experts + 1)
    dropped = int((~keep).sum())
    assert (dropped == 0) == (case == "no drops")
    if case == "heavy drops":
        assert dropped > n_assign // 2
    # a permutation: every kept assignment owns one slot of the buffer
    kept = dst[keep]
    assert kept.unique().numel() == kept.numel()
    assert int(kept.max()) < lc.moe.n_experts * ng * c
    assert torch.all(dst[~keep] == lc.moe.n_experts * ng * c)


def _mla_cfg():
    """One MLA layer without a query LoRA (``wq``), and a dense FFN."""
    mla = AttnConfig(kind="mla", n_heads=2, n_kv_heads=2, q_lora=0,
                     kv_lora=16, d_rope=8, d_nope=8, d_v=4)
    return LMConfig(name="mla", d_model=32, vocab=64, tie_embeddings=False,
                    segments=(Segment(2, (LayerConfig(mla, d_ff=48),)),))


def test_mla_without_a_query_lora_matches_jax():
    """The ``wq`` branch of MLA (deepseek-v2's reduced config covers the
    ``q_a`` / ``q_b`` one): forward logits, the prefill's ``ckv`` cache
    within one bfloat16 ulp, and two decode steps that re-expand it."""
    cfg = _mla_cfg()
    jp, tp = _params(cfg, seed=4)
    assert "wq" in tp["seg0"]["sub0"]["attn"]
    b, s = 2, 14
    tok = _tokens(cfg, (b, s), 4)
    lj, _, _ = JLM.forward(jp, jnp.asarray(tok), cfg)
    lt, _, _ = LM.forward(tp, torch.from_numpy(tok), cfg)
    _close(lt, lj)
    last_j, cj = jax.jit(JLM.make_prefill_step(cfg, b, s))(
        jp, jnp.asarray(tok, jnp.int32))
    last_t, ct = LM.make_prefill_step(cfg, b, s)(tp, torch.from_numpy(tok))
    _close(last_t, last_j)
    ckv = ct["seg0"]["sub0"]["ckv"]
    assert tuple(ckv.shape) == (2, b, s, 16 + 8)
    _bf16_within_one_ulp(ckv, cj["seg0"]["sub0"]["ckv"])
    dec_j = jax.jit(JLM.make_decode_step(cfg))
    nxt = _tokens(cfg, (b, 1), 5)
    for pos in (s - 2, s - 1):
        lj, cj = dec_j(jp, cj, jnp.asarray(nxt, jnp.int32),
                       jnp.asarray(pos, jnp.int32))
        lt, ct = LM.make_decode_step(cfg)(tp, ct, torch.from_numpy(nxt), pos)
        _close(lt, lj)


def test_registry_holds_only_ported_archs():
    gnns = ("gcn", "graphsage", "gat", "pna", "meshgraphnet", "schnet",
            "nequip")
    # every architecture of the reference's registry is ported
    assert sorted(configs.REGISTRY) == sorted(ARCHS + gnns
                                              + ("dlrm-mlperf",))
    assert sorted(configs.REGISTRY) == sorted(jconfigs.REGISTRY)
    assert len(ARCHS) == 5            # every LM of the JAX package
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
    for which in ("config", "reduced"):
        mine = getattr(configs.get("dlrm-mlperf"), which)()
        ref = getattr(jconfigs.get("dlrm-mlperf"), which)()
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("nosuch")


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


def test_lm_params_conversion_covers_the_moe_and_mla_trees():
    """deepseek-v2's reduced tree holds both: the router (float32 in a
    bfloat16 model, and kept so when a dtype is asked for), the experts
    (count, E, d, f), ``shared``, and MLA's ``q_*`` / ``kv_*`` leaves."""
    cfg = _cfg("deepseek-v2-236b")
    tree = jax.tree.map(np.asarray, JLM.init_params(KEY, cfg))  # bfloat16
    moe = tree["seg1"]["sub0"]
    assert moe["ffn"]["router"].dtype == np.float32
    assert set(moe["ffn"]) == {"router", "e_gate", "e_up", "e_down",
                               "shared"}
    assert set(moe["attn"]) == {"kv_a", "kv_norm", "kv_b", "wo", "q_a",
                                "q_norm", "q_b"}
    assert moe["ffn"]["e_gate"].shape == (2, 8, 64, 64)
    for dtype in (None, torch.bfloat16):
        tp = lm_params_from_numpy(tree, cfg, dtype=dtype)
        ffn = tp["seg1"]["sub0"]["ffn"]
        assert ffn["router"].dtype == torch.float32
        assert ffn["e_gate"].dtype == torch.bfloat16
        assert tp["seg0"]["sub0"]["attn"]["kv_b"].dtype == torch.bfloat16
    back = lm_params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b.astype(np.float32))
    port = LM.init_params(cfg, torch.Generator().manual_seed(0),
                          dtype=torch.bfloat16)
    assert port["seg1"]["sub0"]["ffn"]["router"].dtype == torch.float32
    assert LM.param_shapes(cfg) == jax.tree.map(lambda a: a.shape, tree)

    for path in (("seg1", "sub0", "ffn", "shared", "up"),
                 ("seg0", "sub0", "attn", "q_norm")):
        missing = jax.tree.map(lambda x: x, tree)
        del functools.reduce(lambda n, k: n[k], path[:-1], missing)[path[-1]]
        with pytest.raises(KeyError, match="/".join(path)):
            lm_params_from_numpy(missing, cfg)
    extra = jax.tree.map(lambda x: x, tree)
    extra["seg1"]["sub0"]["attn"]["wq"] = moe["attn"]["q_b"]
    with pytest.raises(KeyError, match="seg1/sub0/attn/wq"):
        lm_params_from_numpy(extra, cfg)
    bad = jax.tree.map(lambda x: x, tree)
    bad["seg1"]["sub0"]["ffn"]["e_down"] = moe["ffn"]["e_down"][..., :3]
    with pytest.raises(ValueError, match="e_down"):
        lm_params_from_numpy(bad, cfg)


@pytest.mark.parametrize("arch", ("olmoe-1b-7b", "deepseek-v2-236b",
                                  "gemma2-27b"))
def test_entry_point_serves_the_moe_mla_and_softcapped_lms(arch, capsys):
    launch.main(["--arch", arch, "--serve", "--reduced", "--batch", "2",
                 "--seq", "8", "--decode-tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"{_cfg(arch).name} on cpu" in out
    assert "decoded 2x3 tokens" in out and "sample:" in out


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
    # DLRM trains (it was refused before it was ported): on the card, so
    # without one it raises; an unknown arch fails as the reference's does
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "dlrm-mlperf"])
    with pytest.raises(KeyError, match="unknown arch"):
        launch.main(["--arch", "nosuch"])
    # an LM without --serve trains (it was refused before it was ported):
    # on the card, so without one it raises
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "granite-3-2b", "--reduced", "--steps", "1"])
    # --scenario is ported: it trains on the card, so without one it raises
    # (tests/test_torch_scenarios.py runs it on the CPU)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--scenario", "smoke"])
