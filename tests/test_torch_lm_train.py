"""The port's LM training step against the JAX reference, on the CPU: the
loss and every gradient leaf of step 1, the MoE layer's backward, and
remat.

Parameters come from the JAX ``init_params(..., dtype=float32)`` and cross
into the port with ``lm_params_from_numpy``; the batch is the first of
``token_stream`` (both packages give the same arrays). JAX runs under
``jax.jit``. The port runs its
plain versions here, the attention's gradient included
(``FlashAttention`` on a CPU tensor: ``attention_bshd_bwd_ref``).

Tolerances, and why:

* the loss: rtol 1e-6; each gradient leaf: max |port - JAX| <= 1e-4 x the
  leaf's largest magnitude (``LEAF_TOL``) — float32 sums in another order
  through a few layers and their backward (measured: below 3e-6);
* ``moe_ffn``'s input and parameter gradients: rtol 1e-4, atol 1e-5.

MoE routing is a top-k over float32 probabilities, so the two packages route
alike unless two probabilities tie to within their last bits; the seeds
here make no such tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import token_stream as jax_token_stream
from repro.models.lm import model as JLM
from repro_torch import configs
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.models.lm import model as LM
from repro_torch.models.lm.config import (AttnConfig, LayerConfig, LMConfig,
                                          MoEConfig, Segment)

ARCHS = ("granite-3-2b", "yi-34b", "olmoe-1b-7b", "deepseek-v2-236b",
         "gemma2-27b")
LEAF_TOL = 1e-4


def _setup(arch, batch=2, seq=24):
    cfg = configs.get(arch).reduced()
    jp = JLM.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    tok, lab = next(jax_token_stream(cfg.vocab, batch, seq, 0, 1))
    return cfg, jp, tp, tok, lab


def _port_loss_and_grads(tp, tok, lab, cfg):
    loss, grads = LM.loss_and_grads(tp, torch.from_numpy(tok),
                                    torch.from_numpy(lab), cfg)
    assert all(not t.requires_grad for _, t in LM.tree_leaves(tp))
    return loss, [g for _, g in LM.tree_leaves(grads)]


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_step_one_gradients_match_jax(arch):
    """``lm_loss`` and its gradient with respect to every leaf against
    ``jax.value_and_grad(repro.models.lm.model.lm_loss)``, the MoE's
    routing and ``0.01 * aux`` included (olmoe, deepseek-v2), MLA's
    narrower values through the attention's backward (deepseek-v2), the
    softcaps and local windows (gemma2)."""
    cfg, jp, tp, tok, lab = _setup(arch)
    lj, gj = jax.jit(jax.value_and_grad(JLM.lm_loss), static_argnums=3)(
        jp, jnp.asarray(tok), jnp.asarray(lab), cfg)
    lt, gt = _port_loss_and_grads(tp, tok, lab, cfg)
    assert lt.dtype == torch.float32 and lt.dim() == 0
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    paths = [p for p, _ in LM.tree_leaves(tp)]
    assert len(paths) == len(jax.tree.leaves(gj))
    for path, g in zip(paths, gt):
        want = _leaf(gj, path)
        assert tuple(g.shape) == want.shape, path
        err = float(np.abs(g.numpy() - want).max())
        top = float(np.abs(want).max())
        assert top > 0 and err <= LEAF_TOL * top, (path, err, top)


def _no_remat(monkeypatch):
    monkeypatch.setattr(LM, "checkpoint",
                        lambda fn, *args, use_reentrant: fn(*args))


@pytest.mark.parametrize("arch", ("granite-3-2b", "gemma2-27b"))
def test_remat_gives_the_gradients_of_no_remat(arch, monkeypatch):
    """Each layer recomputed in the backward (``torch.utils.checkpoint``)
    gives the loss and the gradients of the plain backward, bit for bit."""
    cfg, _, tp, tok, lab = _setup(arch)
    la, ga = _port_loss_and_grads(tp, tok, lab, cfg)
    _no_remat(monkeypatch)
    lb, gb = _port_loss_and_grads(tp, tok, lab, cfg)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


def test_remat_recomputes_each_layer_once_and_only_under_a_gradient(
        monkeypatch):
    """With remat a gradient runs each sub-layer twice (forward and
    recompute); serving, without grad, runs it once."""
    cfg, _, tp, tok, lab = _setup("gemma2-27b")
    calls = []
    real = LM._sub_layer

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(LM, "_sub_layer", counted)
    _port_loss_and_grads(tp, tok, lab, cfg)
    assert len(calls) == 2 * cfg.n_layers
    calls.clear()
    LM.forward(tp, torch.from_numpy(tok), cfg)
    assert len(calls) == cfg.n_layers
    calls.clear()
    _no_remat(monkeypatch)
    _port_loss_and_grads(tp, tok, lab, cfg)
    assert len(calls) == cfg.n_layers


def _moe_cfg(n_shared, capacity_factor):
    moe = MoEConfig(n_experts=4, top_k=2, d_ff=16, n_shared=n_shared,
                    d_ff_shared=12 if n_shared else 0,
                    capacity_factor=capacity_factor)
    lc = LayerConfig(AttnConfig(n_heads=2, n_kv_heads=2, d_head=4), moe=moe)
    return LMConfig(name="moe", d_model=8, vocab=64,
                    segments=(Segment(1, (lc,)),)), lc


@pytest.mark.parametrize("case,capacity_factor,n_shared", [
    ("no drops", 16.0, 1), ("heavy drops", 0.1, 0)])
def test_moe_backward_matches_jax(case, capacity_factor, n_shared):
    """The gradient of ``moe_ffn`` through the dispatch's ``index_copy_``
    into a fresh buffer, the gather back and the combine, against
    ``jax.vjp`` of the reference's ``segment_sum`` dispatch, for the input
    and every parameter (the router's through the gate weights and the aux
    loss). A dropped assignment gets a zero gradient: with the aux loss's
    cotangent 0 and no shared experts, a token whose assignments were all
    dropped gets none at all."""
    cfg, lc = _moe_cfg(n_shared, capacity_factor)
    jp = JLM.ffn_params(jax.random.PRNGKey(7), cfg, lc, jnp.float32)
    x = np.random.default_rng(8).normal(0, 1, (40, 8)).astype(np.float32)
    rng = np.random.default_rng(9)
    dy = rng.normal(0, 1, (40, 8)).astype(np.float32)
    @jax.jit
    def jax_grads(p, a, ct):
        return jax.vjp(lambda p_, a_: JLM.moe_ffn(p_, a_, lc.moe), p, a)[1](ct)
    for daux in (0.0, 0.7):
        gp_j, gx_j = jax_grads(jp, jnp.asarray(x),
                               (jnp.asarray(dy), jnp.float32(daux)))
        tp = LM.tree_map(lambda a: torch.from_numpy(np.array(a))
                         .requires_grad_(), jp)
        xt = torch.from_numpy(x).requires_grad_()
        y, aux = LM.moe_ffn(tp, xt, lc.moe)
        leaves = [t for _, t in LM.tree_leaves(tp)]
        grads = torch.autograd.grad(
            (y, aux), [xt] + leaves,
            (torch.from_numpy(dy), torch.tensor(daux)))
        np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_j),
                                   rtol=1e-4, atol=1e-5)
        for (path, _), g in zip(LM.tree_leaves(tp), grads[1:]):
            np.testing.assert_allclose(g.numpy(), _leaf(gp_j, path),
                                       rtol=1e-4, atol=1e-5, err_msg=path)
        assert float(grads[1 + [p for p, _ in LM.tree_leaves(tp)].index(
            ("router",))].abs().max()) > 0
        if case == "heavy drops" and daux == 0.0:
            gate_i = LM.moe_route(tp, xt.detach(), lc.moe)[2]
            keep = LM.moe_dispatch(gate_i, lc.moe)[0].reshape(40, 2)
            gone = ~keep.any(1)
            assert gone.sum() > 5 and keep.any()
            assert torch.all(grads[0][gone] == 0)
            assert torch.all(grads[0][keep.any(1)].abs().sum(1) > 0)
