"""The port's cell inventory (``repro_torch.launch.cells``) against the JAX
reference's ``repro.launch.cells``, on the CPU.

* ``all_cells()`` is the reference's 40 (arch, shape) pairs, in order;
* every cell's ``model_flops`` equals the reference's: LM cells through
  ``repro.launch.cells._lm_model_flops`` on the reference's config, GNN
  cells through its ``gnn_cell_sizes`` and ``_gnn_model_flops``, DLRM cells
  through its ``_dlrm_model_flops``; the LM and DLRM meta equal the
  reference's configs' counts;
* every GNN cell's meta at 4 devices (and at 8, 1 bit and 32, sync and
  async) equals the reference's ``_gnn_cell(...).meta``, built in one JAX
  subprocess with four (eight) forced host devices — built, not lowered;
* ``_reduce_depth`` and ``lm_scaled_count`` equal the reference's for the
  five LMs, and ``depth=`` cuts a cell's FLOPs as the reference's does;
* ``build_cell`` allocates nothing: deepseek-v2-236b's cells build in well
  under a second, and no tensor a cell holds or builds is off ``meta``
  (the GNN cell's model and plan are built on it);
* the sampler-sized ``minibatch_lg`` cell and the analytic partition
  spec, ``PlanArrays.from_spec``'s rows and bytes, equal the reference's.
"""
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from repro import configs as jconfigs
from repro.graph import partition as jpartition
from repro.launch import cells as jcells
from repro_torch import configs
from repro_torch.core import exchange as X
from repro_torch.graph import partition
from repro_torch.launch import cells

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
LMS = ("granite-3-2b", "gemma2-27b", "yi-34b", "olmoe-1b-7b",
       "deepseek-v2-236b")
GNN_KW = (dict(n_devices=4), dict(n_devices=4, sylvie_mode="async"),
          dict(n_devices=4, bits=32), dict(n_devices=8, bits=2))

META_PROG = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys; sys.path.insert(0, {src!r})
from repro import configs
from repro.launch import cells as C
from repro.launch.mesh import make_test_mesh

out = []
for kw in {kws!r}:
    kw = dict(kw)
    n = kw.pop("n_devices")
    mesh = make_test_mesh((n,), ("data",))
    for arch, shape in C.all_cells():
        if configs.get(arch).kind != "gnn":
            continue
        cell = C.build_cell(arch, shape, mesh, **kw)
        out.append([arch, shape, dict(kw, n_devices=n), cell.meta,
                    cell.model_flops, cell.n_devices])
print("META", json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_gnn_meta():
    prog = textwrap.dedent(META_PROG.format(src=SRC, kws=GNN_KW))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("META ")][-1]
    return json.loads(line[5:])


def test_all_cells_are_the_references_forty_in_order():
    got = cells.all_cells()
    assert got == jcells.all_cells()
    assert len(got) == 40 and len({a for a, _ in got}) == 10


@pytest.mark.parametrize("pair", jcells.all_cells(),
                         ids=lambda p: f"{p[0]}-{p[1]}")
def test_model_flops_equal_the_references(pair):
    arch, shape = pair
    cell = cells.build_cell(arch, shape, 4)
    spec = jconfigs.get(arch)
    jcell = spec.shape(shape)
    assert (cell.arch_id, cell.shape_name, cell.step, cell.n_devices) == \
        (arch, shape, jcell.step, 4)
    if spec.kind == "lm":
        cfg = spec.config()
        want = jcells._lm_model_flops(cfg, jcell)
        assert cell.meta == dict(params=cfg.param_count(),
                                 active_params=cfg.param_count(
                                     active_only=True))
    elif spec.kind == "gnn":
        n, e, d = jcells.gnn_cell_sizes(jcell)
        assert cells.gnn_cell_sizes(configs.get(arch).shape(shape)) == \
            (n, e, d)
        model = spec.config().make(d, 16)
        want = jcells._gnn_model_flops(spec.config().name, model, n, e, d,
                                       True)
    else:
        from repro.models.recsys import dlrm as JD
        cfg = spec.config()
        want = jcells._dlrm_model_flops(cfg, jcell)
        assert cell.meta == dict(table_rows=cfg.total_rows,
                                 rows_per_device=JD.rows_per_device(cfg, 4),
                                 params=cfg.param_count())
    assert cell.model_flops == want and want > 0


def test_gnn_meta_equals_the_references_cells(reference_gnn_meta):
    assert len(reference_gnn_meta) == 16 * len(GNN_KW)
    for arch, shape, kw, meta, flops, n_dev in reference_gnn_meta:
        kw = dict(kw)
        cell = cells.build_cell(arch, shape, kw.pop("n_devices"), **kw)
        assert cell.meta == meta, (arch, shape, kw)
        assert cell.model_flops == flops and cell.n_devices == n_dev


def test_minibatch_lg_is_sized_by_the_sampler():
    spec = configs.get("pna").shape("minibatch_lg")
    assert cells.gnn_cell_sizes(spec) == (169_984, 168_960, 602)
    cell = cells.build_cell("nequip", "minibatch_lg", 4)
    assert cell.meta["n_local"] == 42_496
    jspec = jpartition.analytic_partition_spec(169_984, 168_960, 4)
    assert partition.analytic_partition_spec(169_984, 168_960, 4) == \
        partition.PartitionShapeSpec(jspec.n_parts, jspec.n_local,
                                     jspec.e_pad, jspec.h_pad)


@pytest.mark.parametrize("n_parts", [1, 2, 4, 8])
def test_plan_from_spec_allocates_nothing_and_counts_the_references_rows(
        n_parts):
    from repro.core import exchange as JX
    spec = partition.analytic_partition_spec(2708, 10556, n_parts)
    plan = X.PlanArrays.from_spec(spec)
    jplan = JX.PlanArrays.from_spec(jpartition.analytic_partition_spec(
        2708, 10556, n_parts))
    for t in (plan.send_idx, plan.send_mask, plan.recv_mask):
        assert t.device.type == "meta"
    assert (plan.wire_rows, plan.real_rows, plan.halo_rows, plan.h_pad,
            plan.n_local, plan.bucket_sizes) == \
        (jplan.wire_rows, jplan.real_rows, jplan.halo_rows, jplan.h_pad,
         jplan.n_local, jplan.bucket_sizes)
    assert plan.wire_rows == n_parts * (n_parts - 1) * spec.h_pad
    for bits in (1, 2, 8, 16, 32):
        assert X.exchange_bytes(plan, 75, bits) == \
            JX.exchange_bytes(jplan, 75, bits)


@pytest.mark.parametrize("arch", LMS)
def test_reduce_depth_and_scaled_count_equal_the_references(arch):
    cfg, jcfg = configs.get(arch).config(), jconfigs.get(arch).config()
    assert cells.lm_scaled_count(cfg) == jcells.lm_scaled_count(jcfg)
    for depth in (1, 2):
        got = cells._reduce_depth(cfg, depth)
        want = jcells._reduce_depth(jcfg, depth)
        assert [(s.count, len(s.layers)) for s in got.segments] == \
            [(s.count, len(s.layers)) for s in want.segments]
        assert got.param_count() == want.param_count()
        for shape in ("train_4k", "decode_32k"):
            cell = cells.build_cell(arch, shape, 4, depth=depth)
            assert cell.model_flops == jcells._lm_model_flops(
                want, jconfigs.get(arch).shape(shape))


def test_build_cell_allocates_nothing():
    """deepseek-v2-236b's four cells build in well under a second; no cell
    builds a tensor off the ``meta`` device (every factory call is
    watched)."""
    t0 = time.perf_counter()
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        cell = cells.build_cell("deepseek-v2-236b", shape, 4)
        assert cell.meta["params"] > 200e9
    assert time.perf_counter() - t0 < 1.0

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Devices(TorchDispatchMode):
        """The device of every tensor any operation makes."""

        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.seen += [(str(func), t.device.type)
                          for t in tree_flatten(out)[0]
                          if isinstance(t, torch.Tensor)]
            return out

    with Devices() as mode:
        for arch, shape in cells.all_cells():
            cell = cells.build_cell(arch, shape, 4)
            leaves = [v for v in vars(cell).values() if torch.is_tensor(v)]
            assert not leaves, (arch, shape)
    assert len(mode.seen) > 100
    off = [op for op, dev in mode.seen if dev != "meta"]
    assert not off, off[:10]
    with torch.device("meta"):
        model = configs.get("nequip").config().make(602, 16)
    assert all(p.device.type == "meta" for p in model.parameters())
