"""DLRM under the port's multi-process runtime: four ``gloo`` ranks on the
CPU (``dist.spawn``), each holding a quarter of the table's rows.

The program is the reference's ``DLRM_EQUIV`` (``tests/test_distributed.py``):
tables (50, 30, 20, 40) of width 16, hot (2, 1, 1, 3), SGD 0.5, 8 steps,
batch 32 (8 a rank). The ranks run it at 32, 16 and 1 bits of the embedding
exchange; at 32 bits they are held to the port's single process (losses
rtol 1e-5, table 1e-5 / 1e-7) and to the reference's single device (its own
tolerances: loss 1e-4, table 1e-3 / 1e-5); at 16 and 1 bits to the
reference's ``shard_map`` over four forced host devices, run once in a
subprocess, with its noise (``jax.random.uniform(fold_in(key, i), (n_local,
16))``) handed to the ranks (losses rtol 1e-5, table 1e-4). The plain
versions' calls per step on every rank are the launches ``chip_smoke.py``
gates on the card (``DLRM_LAUNCHES``), and retrieval sharded four ways
returns the single process's top 8.
"""
from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.dist.spawn import spawn

SRC = str(Path(__file__).resolve().parents[1] / "src")
P = 4
TIMEOUT = 240
STEPS = 8
BATCH = 32
LR = 0.5
BITS = (32, 16, 1)
CFG = dict(n_dense=13, embed_dim=16, table_sizes=(50, 30, 20, 40),
           bot_mlp=(32, 16), top_mlp=(64, 32, 1), hot=(2, 1, 1, 3))

# the reference's program, in one subprocess with four forced host devices
# (jax fixes its device count when it first initializes; this process must
# keep its one); writes its inputs, weights, noise and results to an .npz
JAX_PROGRAM = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys; sys.path.insert(0, {src!r})
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.dist import compat
from repro.models.recsys import dlrm as D
from repro.train import optimizer as opt

cfg = D.DLRMConfig(**{cfg!r})
key = jax.random.PRNGKey(0)
dp = D.init_dense_params(key, cfg)
B = {batch}
offs = cfg.row_offsets
rng = np.random.default_rng(0)
ids = np.concatenate([rng.integers(offs[f], offs[f+1], (B, h))
                      for f, h in enumerate(cfg.hots)],
                     axis=1).reshape(-1).astype(np.int32)
dx = rng.normal(0, 1, (B, 13)).astype(np.float32)
labels = rng.integers(0, 2, B).astype(np.float32)
tb = D.init_table(jax.random.fold_in(key, 1), cfg, n_dev=4)
o = opt.sgd({lr})
out = dict(ids=ids, dx=dx, labels=labels, table=np.asarray(tb))
for path, leaf in jax.tree_util.tree_leaves_with_path(dp):
    out["dp/" + "/".join(k.key for k in path)] = np.asarray(leaf)

step1 = jax.jit(D.make_train_step(cfg, o, None))
st = (dp, tb, o.init(dp), o.init(tb), jnp.zeros((), jnp.int32))
losses = []
for i in range({steps}):
    st, loss = step1(st, jnp.asarray(dx), jnp.asarray(ids),
                     jnp.asarray(labels), key)
    losses.append(float(loss))
out["single_losses"] = np.asarray(losses)
out["single_table"] = np.asarray(st[1])

mesh = compat.make_mesh((4,), ("data",))
shard, rep = P("data"), P()
n_local = B // 4 * cfg.total_ids_per_sample
for bits in (16, 1):
    cq = dataclasses.replace(cfg, quantize_collective_bits=bits)
    sm = jax.jit(compat.shard_map(D.make_train_step(cq, o, "data"), mesh,
        in_specs=((rep, shard, rep, (), rep), shard, shard, shard, rep),
        out_specs=((rep, shard, rep, (), rep), rep)))
    st = (dp, tb, o.init(dp), o.init(tb), jnp.zeros((), jnp.int32))
    losses, us = [], []
    for i in range({steps}):
        k = jax.random.fold_in(key, i)
        us.append(np.asarray(jax.random.uniform(k, (n_local, cfg.embed_dim),
                                                jnp.float32)))
        st, loss = sm(st, jnp.asarray(dx), jnp.asarray(ids),
                      jnp.asarray(labels), k)
        losses.append(float(loss))
    out[f"u{{bits}}"] = np.stack(us)
    out[f"losses{{bits}}"] = np.asarray(losses)
    out[f"table{{bits}}"] = np.asarray(jax.device_get(st[1]))
np.savez({path!r}, **out)
print("OK")
"""


def _cfg(bits=None):
    from repro_torch.models.recsys import dlrm as D
    return D.DLRMConfig(**CFG, quantize_collective_bits=bits)


def _dense(ref) -> dict:
    tree: dict = {}
    for k in ref.files:
        if k.startswith("dp/"):
            node = tree
            *path, leaf = k.split("/")[1:]
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = ref[k]
    return tree


def _state(dense_tree, table, opt):
    from repro_torch.models.convert import dlrm_params_from_numpy
    dp, tb = dlrm_params_from_numpy(dense_tree, table)
    return (dp, tb, opt.init(dp), opt.init(tb),
            torch.zeros((), dtype=torch.int32))


def _counting():
    """Count the calls of the plain versions of ``chip_smoke.DLRM_KERNELS``
    (quantize, dequantize, SpMM) into a list of three."""
    from repro_torch.kernels.quant import ref as qref
    from repro_torch.kernels.spmm import ref as sref
    counts = [0, 0, 0]
    for i, (mod, fn) in enumerate(((qref, "quantize_pack_ref"),
                                   (qref, "unpack_dequantize_ref"),
                                   (sref, "spmm_ref"))):
        real = getattr(mod, fn)

        def counted(*a, _real=real, _i=i, **k):
            counts[_i] += 1
            return _real(*a, **k)
        setattr(mod, fn, counted)
    return counts


def _rank(inputs: dict) -> dict:
    """One rank: the program at each of ``BITS`` from the same weights,
    then retrieval; the tables gathered in rank order."""
    import torch.distributed as dist

    from repro_torch.dist.runtime import Runtime
    from repro_torch.models.recsys import dlrm as D
    from repro_torch.train import optimizer as optlib

    rt = Runtime.sharded(P, device="cpu")
    r, be = rt.rank, rt.backend
    counts = _counting()
    ids = torch.from_numpy(inputs["ids"]).view(BATCH, -1)
    b_local = BATCH // P
    sl = slice(r * b_local, (r + 1) * b_local)
    ids_l = ids[sl].reshape(-1).contiguous()
    dx = torch.from_numpy(inputs["dx"])[sl]
    labels = torch.from_numpy(inputs["labels"])[sl]
    rpd = inputs["table"].shape[0] // P
    table = inputs["table"][r * rpd:(r + 1) * rpd]
    out = {"rank": r}
    for bits in BITS:
        cfg = _cfg(None if bits == 32 else bits)
        opt = optlib.sgd(LR)
        state = _state(inputs["dense"], table, opt)
        step = D.make_train_step(cfg, opt, be)
        losses, launches = [], []
        for i in range(STEPS):
            noise = torch.from_numpy(inputs[f"u{bits}"][i]) \
                if bits < 16 else None
            counts[:] = [0, 0, 0]
            state, loss = step(state, dx, ids_l, labels, noise)
            launches.append(tuple(counts))
            losses.append(float(loss))
        out[bits] = dict(losses=losses, launches=launches,
                         table=D.all_gather(state[1], be.group).numpy())
        if bits == 32:
            trained = state
    # retrieval: the query's ids on every rank, the candidates sharded
    cfg = _cfg()
    cand = torch.from_numpy(inputs["cand"]).view(P, -1)[r].contiguous()
    ret = D.make_retrieval_step(cfg, be, top_k=8)
    query = ids[0].contiguous()
    v, got = ret(trained[0], trained[1], torch.from_numpy(inputs["dx"])[:1],
                 query, cand)
    out["retrieval"] = (v.numpy(), got.numpy())
    dist.barrier()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's program (one subprocess) and the ranks' (one
    spawn)."""
    path = str(tmp_path_factory.mktemp("dlrm") / "ref.npz")
    prog = textwrap.dedent(JAX_PROGRAM).format(
        src=SRC, cfg=CFG, batch=BATCH, lr=LR, steps=STEPS, path=path)
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    ref = np.load(path)
    cand = np.random.default_rng(1).permutation(
        CFG["table_sizes"][0])[:32].astype(np.int32)
    inputs = {k: ref[k] for k in ("ids", "dx", "labels", "table", "u16",
                                  "u1")}
    inputs.update(dense=_dense(ref), cand=cand)
    ranks = spawn(_rank, P, device="cpu", dist_backend="gloo",
                  args=(inputs,), timeout=TIMEOUT)
    return ref, inputs, ranks


def _single(inputs):
    """The port's single process on the same program (32 bits)."""
    from repro_torch.models.recsys import dlrm as D
    from repro_torch.train import optimizer as optlib
    cfg, opt = _cfg(), optlib.sgd(LR)
    state = _state(inputs["dense"], inputs["table"], opt)
    step = D.make_train_step(cfg, opt)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, torch.from_numpy(inputs["dx"]),
                           torch.from_numpy(inputs["ids"]),
                           torch.from_numpy(inputs["labels"]))
        losses.append(float(loss))
    return state, losses


def test_sharded_32_bits_equals_the_single_process(runs):
    ref, inputs, ranks = runs
    state, losses = _single(inputs)
    got = ranks[32]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    n = _cfg().total_rows
    np.testing.assert_allclose(got["table"][:n], state[1].numpy()[:n],
                               rtol=1e-5, atol=1e-7)


def test_sharded_32_bits_matches_the_reference_single_device(runs):
    ref, _, ranks = runs
    got = ranks[32]
    np.testing.assert_allclose(got["losses"][-1], ref["single_losses"][-1],
                               rtol=1e-4)
    np.testing.assert_allclose(got["losses"], ref["single_losses"],
                               rtol=1e-4)
    n = _cfg().total_rows
    np.testing.assert_allclose(got["table"][:n], ref["single_table"][:n],
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("bits", (16, 1))
def test_sharded_quantized_exchange_matches_the_reference_shard_map(runs,
                                                                    bits):
    ref, _, ranks = runs
    got = ranks[bits]
    np.testing.assert_allclose(got["losses"], ref[f"losses{bits}"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["table"], ref[f"table{bits}"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("bits", BITS)
def test_sharded_step_runs_each_kernel_as_documented(runs, bits):
    import chip_smoke
    _, _, ranks = runs
    want = chip_smoke.DLRM_LAUNCHES[("train_sharded", bits)]
    assert ranks[bits]["launches"] == [want] * STEPS


def test_sharded_retrieval_returns_the_single_process_top_8(runs):
    from repro_torch.models.recsys import dlrm as D
    _, inputs, ranks = runs
    state, _ = _single(inputs)
    ret = D.make_retrieval_step(_cfg(), None, top_k=8)
    query = torch.from_numpy(inputs["ids"]).view(BATCH, -1)[0].contiguous()
    v, ids = ret(state[0], state[1], torch.from_numpy(inputs["dx"])[:1],
                 query, torch.from_numpy(inputs["cand"]))
    gv, gids = ranks["retrieval"]
    np.testing.assert_array_equal(gids, ids.numpy())
    np.testing.assert_allclose(gv, v.numpy(), rtol=1e-5, atol=1e-6)
    assert (np.diff(gv) <= 0).all()
