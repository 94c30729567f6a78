"""The port's LM training loop against the JAX reference, on the CPU: three
steps of ``make_train_step`` with SGD and with Adam, the token stream, the
``Prefetcher`` and the launcher's ``train_lm``.

Parameters come from the JAX ``init_params(..., dtype=float32)`` through
``lm_params_from_numpy``; the batches are ``token_stream``'s (array-equal
in both packages). JAX's step runs under ``jax.jit``.

Tolerances, and why:

* three steps' losses, SGD or Adam: rtol 1e-5 (``STEP_RTOL``; measured:
  below 3.1e-7) — the gradients agree to ~1e-6 of their largest magnitude
  (``tests/test_torch_lm_train.py``). Adam's parameters are not compared:
  its first step moves every element by about ``lr * sign(g)`` whatever
  the gradient's size, so an element whose gradient is a rounding away
  from 0 can move by ``lr`` in one package and the other way in the other
  (``PERF.md`` §6: Adam's first step drifts); the loss stays close.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import token_stream as jax_token_stream
from repro.models.lm import model as JLM
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.data.pipeline import Prefetcher, token_stream
from repro_torch.launch import train as launch
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.models.lm import model as LM
from repro_torch.train import optimizer as topt

STEP_RTOL = 1e-5


def _losses(arch, jax_opt, port_opt, steps=3, batch=2, seq=16):
    cfg = configs.get(arch).reduced()
    jp = JLM.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    jstate = (jp, jax_opt.init(jp), jnp.zeros((), jnp.int32))
    tstate = (tp, port_opt.init(tp), torch.zeros((), dtype=torch.int32))
    jstep = jax.jit(JLM.make_train_step(cfg, jax_opt))
    tstep = LM.make_train_step(cfg, port_opt)
    lj, lt = [], []
    for tok, lab in jax_token_stream(cfg.vocab, batch, seq, 0, steps):
        jstate, loss = jstep(jstate, jnp.asarray(tok), jnp.asarray(lab))
        lj.append(float(loss))
        tstate, loss = tstep(tstate, torch.from_numpy(tok),
                             torch.from_numpy(lab))
        assert loss.dtype == torch.float32 and not loss.requires_grad
        lt.append(float(loss))
    assert int(tstate[2]) == steps
    return np.array(lt), np.array(lj), tstate


def test_three_sgd_steps_match_jax():
    """olmoe: the MoE's routing and drops move with the parameters."""
    lt, lj, _ = _losses("olmoe-1b-7b", jopt.sgd(0.1), topt.sgd(0.1))
    np.testing.assert_allclose(lt, lj, rtol=STEP_RTOL)


def test_three_adam_steps_match_jax():
    lt, lj, (params, opt_state, _) = _losses("granite-3-2b", jopt.adam(1e-3),
                                             topt.adam(1e-3))
    np.testing.assert_allclose(lt, lj, rtol=STEP_RTOL)
    assert int(opt_state["t"]) == 3
    for _, t in LM.tree_leaves(params):
        assert not t.requires_grad


def test_train_step_updates_in_place_as_the_tree_update():
    """``make_train_step`` updates the parameters and Adam's state it is
    given, in place, to the bits of ``optimizer.update`` + ``apply_updates``
    over the whole tree."""
    cfg = configs.get("gemma2-27b").reduced()
    params = LM.init_params(cfg, torch.Generator().manual_seed(0),
                            dtype=torch.float32)
    opt = topt.adam(1e-2)
    tok, lab = (torch.from_numpy(a) for a in next(token_stream(cfg.vocab, 2,
                                                               12, 3, 1)))
    ref = LM.tree_map(torch.clone, params)
    _, gtree = LM.loss_and_grads(ref, tok, lab, cfg)
    upd, ref_state = opt.update(gtree, opt.init(ref), ref)
    ref = topt.apply_updates(ref, upd)
    state = (params, opt.init(params), torch.zeros((), dtype=torch.int32))
    ids = [id(t) for _, t in LM.tree_leaves(params)]
    (new, opt_state, step), _ = LM.make_train_step(cfg, opt)(state, tok, lab)
    assert new is params and [id(t) for _, t in LM.tree_leaves(new)] == ids
    for path, a in LM.tree_leaves(new):
        b = ref
        for k in path:
            b = b[k]
        assert torch.equal(a, b), path
    for a, b in zip(topt.tree_leaves(opt_state), topt.tree_leaves(ref_state)):
        assert torch.equal(a, b)


def test_update_in_place_equals_the_tree_update_for_every_optimizer(
        monkeypatch):
    monkeypatch.setattr(topt, "UPDATE_CHUNK", 4)     # leaves in slices
    def tree(seed):
        g = torch.Generator().manual_seed(seed)
        return {"a": torch.randn(7, 5, generator=g),
                "s": {"b": torch.randn(3, generator=g),
                      "c": torch.randn(2, 4, 3, generator=g)}}
    for opt in (topt.adam(1e-3), topt.adamw(1e-2), topt.sgd(0.1),
                topt.sgd(0.1, momentum=0.9)):
        p, p2 = tree(0), tree(0)
        st, st2 = opt.init(p), opt.init(p2)
        for i in range(3):
            upd, st = opt.update(tree(10 + i), st, p)
            p = topt.apply_updates(p, upd)
            grads = tree(10 + i)
            topt.update_in_place(opt, grads, st2, p2)
            assert not grads["s"] and list(grads) == ["s"]   # each one used
        for a, b in zip(topt.tree_leaves((p, st)), topt.tree_leaves((p2,
                                                                     st2))):
            assert torch.equal(a, b)


def test_token_stream_equals_the_references():
    for args in ((100, 4, 8, 3, 3), (49155, 2, 33, 0, 2)):
        got = list(token_stream(*args))
        want = list(jax_token_stream(*args))
        assert len(got) == len(want) == args[-1]
        for (t1, l1), (t2, l2) in zip(got, want):
            assert t1.dtype == np.int32 and t1.shape == args[1:3]
            np.testing.assert_array_equal(t1, t2)
            np.testing.assert_array_equal(l1, l2)
            np.testing.assert_array_equal(t1[:, 2::2], t1[:, 1:-1:2])


def test_prefetcher_preserves_order_and_values():
    batches = [(np.full((2, 2), i), np.full((2,), i)) for i in range(10)]
    out = list(Prefetcher(iter(batches), device="cpu"))
    assert len(out) == 10
    for i, (a, b) in enumerate(out):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert torch.all(a == i) and torch.all(b == i)


def test_prefetcher_overlaps_host_work():
    def slow_gen():
        for _ in range(5):
            time.sleep(0.05)
            yield np.zeros(4)
    pf = Prefetcher(slow_gen(), depth=4, device="cpu")
    time.sleep(0.3)                       # the producer fills the queue
    t0 = time.time()
    for _ in pf:
        pass
    assert time.time() - t0 < 0.2         # consumption hits the buffer


def test_prefetcher_propagates_errors():
    def bad():
        yield np.zeros(2)
        raise RuntimeError("boom")
    it = Prefetcher(bad(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        for _ in it:
            pass


def test_prefetcher_surfaces_midstream_error_after_buffered_batches():
    """A producer that dies mid-stream (after the queue is full) first
    delivers every batch it produced, then raises once, then stops."""
    def bad():
        for i in range(4):
            yield np.full((2,), i)
        raise ValueError("died at batch 4")
    it = Prefetcher(bad(), depth=2, device="cpu")
    time.sleep(0.2)                       # the producer blocks on the queue
    got = []
    with pytest.raises(ValueError, match="died at batch 4"):
        for batch in it:
            got.append(int(batch[0]))
    assert got == [0, 1, 2, 3]
    with pytest.raises(StopIteration):
        next(it)


def test_prefetcher_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Prefetcher(iter([]))


def test_entry_point_trains_every_lm_on_the_cpu(capsys, monkeypatch):
    """``--arch <lm>`` without ``--serve`` trains (``train_lm``): the
    reference's step and final lines; without ``--device cpu`` and without
    a card it raises."""
    for arch in ("granite-3-2b", "olmoe-1b-7b", "deepseek-v2-236b",
                 "gemma2-27b", "yi-34b"):
        launch.main(["--arch", arch, "--reduced", "--steps", "3", "--batch",
                     "1", "--seq", "8", "--log-every", "1", "--device",
                     "cpu"])
        out = capsys.readouterr().out.splitlines()
        assert [ln.split()[:2] for ln in out[:3]] == [
            ["step", "1"], ["step", "2"], ["step", "3"]]
        assert all("tok/s" in ln for ln in out[:3])
        assert out[3].startswith("final loss ")
        assert "not ported" not in "".join(out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--arch", "granite-3-2b", "--reduced", "--steps", "3"])
    args = launch.argparse.Namespace(
        arch="granite-3-2b", reduced=True, steps=2, lr=1e-3, batch=1,
        seq=8, seed=0, log_every=10, device="cpu")
    losses = launch.train_lm(args)
    assert len(losses) == 2 and np.all(np.isfinite(losses))
