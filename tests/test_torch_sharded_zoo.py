"""PNA, MeshGraphNet, SchNet and NequIP under the port's multi-process runtime
(``Runtime.sharded``: one partition per process over ``torch.distributed``)
on the CPU, four ``gloo`` processes from ``repro_torch.dist.spawn``, against
the port's simulated runtime (which ``tests/test_torch_zoo.py`` holds to the
JAX reference).

One spawn runs, on every rank, each zoo model at its reduced config on its
``chip_smoke.ZOO_SMOKE`` graph, 2 epochs each of vanilla and Sylvie-A (1 bit,
deterministic rounding, ``BoundedStaleness(eps_s=4)``), SGD at
``ZOO_ARCHS``' rate (MeshGraphNet with Adam, ``ZOO_SHARDED_ADAM``: under SGD
its full config's first step overshoots to NaN on the card), through
``chip_smoke.sharded_zoo_rank``, the function the card's ``[sharded]`` (g)
runs. Rank 0 trains the simulated runtime first. Each rank counts the
kernels' plain versions (``chip_smoke.plain_counter``): each epoch's calls
must equal the card's launches (``zoo_step_launches`` at the reduced
config's layers), and each arch's first Sylvie-A step is recorded and its
calls held to their plain versions at the rank's own shapes.
``chip_smoke.sharded_zoo_check`` gates the figures as on the card: losses
the same on every rank, within rtol 1e-5 of the simulated run's at 32 bits
and ``SHARDED_ONE_BIT_RTOL`` (1e-4) at 1 bit, parameters within 1e-5 at 32
bits, halo rows apart within ``SHARDED_ROWS_APART`` at 1 bit, bytes equal.

Each rank holds its own block (``part=rank``: edge CSRs, edge attributes,
PNA's max/min over its own rows) and all-reduces the edge and radial MLPs'
weight gradients with the rest.
"""
import numpy as np
import pytest

from repro_torch.dist.spawn import spawn

P = 4
EPOCHS = 2
TIMEOUT = 240


def _rank() -> list:
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.dist.runtime import Runtime

    rt = Runtime.sharded(P, device="cpu")
    smoke = {a: (g, None) for a, g in cs.ZOO_SMOKE.items()}
    out = dict(rank=rt.rank, zoo=cs.sharded_zoo_rank(
        rt, smoke, "reduced", EPOCHS, counts=cs.plain_counter()))
    every = [None] * P
    dist.all_gather_object(every, out)
    return every


@pytest.fixture(scope="module")
def trained():
    """Every rank's results."""
    return spawn(_rank, P, device="cpu", dist_backend="gloo",
                 timeout=TIMEOUT)


KEYS = [(a, r) for a in ("pna", "meshgraphnet", "schnet", "nequip")
        for r in ("vanilla", "sylvie_a")]


def test_the_cards_gates_pass_on_the_cpu(trained):
    import chip_smoke as cs
    ranks = trained
    assert [x["rank"] for x in ranks] == list(range(P))
    out = cs.sharded_zoo_check(ranks, "gloo on the CPU")
    assert {k for k in out if k not in ("launches", "kernels")} == \
        {f"{a}_{r}" for a, r in KEYS}
    # on the CPU the plain versions run, as often as the card's kernels
    for (arch, run) in KEYS:
        layers = ranks[0]["zoo"][f"{arch}_{run}"]["layers"]
        want = dict(zip(cs.ZOO_KERNELS,
                        cs.zoo_step_launches(arch, run, layers)))
        got = {p: c for p, c in out["launches"].items()
               if p.startswith(f"{arch}_train_sharded_{run}_")}
        assert got and all(c == want for c in got.values())
    assert all(out["kernels"][k] == 0.0 for k in cs.ZOO_KERNELS)
    assert set(out["kernels"]["calls"]) == {a for a, _ in KEYS}


@pytest.mark.parametrize("arch,run", KEYS)
def test_sharded_zoo_matches_the_simulated_runtime(trained, arch, run):
    import chip_smoke as cs
    ranks = trained
    z = ranks[0]["zoo"][f"{arch}_{run}"]
    want = z["simulated"]
    rtol = 1e-5 if run == "vanilla" else cs.SHARDED_ONE_BIT_RTOL
    for x in ranks:
        got = x["zoo"][f"{arch}_{run}"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol)
        assert got["mb"] == want["mb"]
        assert got["losses"] == z["losses"]
    assert z["loss_max_rel"] <= rtol
    if run == "vanilla":
        assert z["param_max_abs"] <= 1e-5
        assert max(z["rows_apart"]["feats"] + z["rows_apart"]["grads"]) \
            <= cs.SHARDED_ROWS_APART * z["rows"]
    assert all(np.isfinite(z["losses"]))


@pytest.mark.parametrize("arch,run", KEYS)
def test_each_rank_runs_the_plain_versions_as_the_card_launches(
        trained, arch, run):
    import chip_smoke as cs
    ranks = trained
    for x in ranks:
        got = x["zoo"][f"{arch}_{run}"]
        want = cs.zoo_step_launches(arch, run, got["layers"])
        assert got["launches"] == [(m, want) for m, _ in got["launches"]]
        assert [m for m, _ in got["launches"]] == ["sync", "async"] \
            if run == "sylvie_a" else ["sync", "sync"]
    if arch == "pna":
        assert want[3] == want[4] == got["layers"] > 0
    else:
        assert want[3] == want[4] == 0


@pytest.mark.parametrize("arch", ("pna", "meshgraphnet", "schnet", "nequip"))
def test_each_ranks_recorded_step_checks_every_call_of_its_kernels(
        trained, arch):
    """The first Sylvie-A step of each rank is recorded: as many calls of
    each kernel as a sync step launches, each held to its plain version."""
    import chip_smoke as cs
    for x in trained:
        got = x["zoo"][f"{arch}_sylvie_a"]
        k = got["kernels"]
        assert k["calls"] == cs.zoo_step_launches(arch, "sylvie_a",
                                                  got["layers"])
        assert all(k[name] == 0.0 for name in cs.ZOO_KERNELS)
