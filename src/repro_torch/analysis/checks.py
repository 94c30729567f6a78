"""Checks on a :class:`~repro_torch.analysis.census.Census`: collective
census, wire dtypes, ring inversion, the overlap schedule's fence and
census, and census equality — the counterpart of
``repro.analysis.jaxpr_checks``.

Why shifts and rows (the reference's argument, unchanged): the compact halo
layout ships ring bucket ``k`` (``b_k`` rows) from partition ``p`` to
``(p+k) % P``, and the backward communication must run the *inverted*
rings (shift ``P-k``). Bucket sizes are ragged on a skewed partition, so
the multiset of ``(shift, rows)`` pairs fingerprints the whole schedule: a
missing bucket, an extra exchange or a backward pass that is not inverted
each perturbs it differently. The expectation comes from the plan's static
metadata; nothing is learned from the census being checked.

A census is checked at two seams. The backend's events say how many
logical exchanges a call made, in which direction, over which buckets and
with which dtypes; under a sharded runtime the ``torch.distributed``
collectives say what reached the wire, one ``all_to_all_single`` per array
with each bucket as a split (:func:`~repro_torch.analysis.census
.shift_census`). Under the simulated runtime nothing may reach
``torch.distributed`` at all (:func:`check_no_collectives`).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

from .census import QUANTIZED_METHODS, RAW_METHODS, Census, shift_census
from .report import Finding

EXCHANGES = ("all_to_all_single",)
REDUCES = ("all_reduce",)
GATHERS = ("all_gather",)
BROADCASTS = ("broadcast", "broadcast_object_list")


# ---------------------------------------------------------------------------
# expectations (as the reference's)
# ---------------------------------------------------------------------------
def quant_components(bits: int) -> int:
    """Arrays per quantized exchange: packed payload + scale + zero for real
    quantization; passthrough widths (16/32) ship the payload alone."""
    return 1 if bits >= 16 else 3


@dataclasses.dataclass(frozen=True)
class ExchangeExpectation:
    """Declared communication structure of one entry point.

    ``fwd_ops``/``bwd_ops`` count *logical halo exchanges* (one per live
    exchange site per direction); each op moves :func:`quant_components`
    arrays. ``mask_ops`` are the serving path's unquantized affected-mask
    rides (1 array each, forward direction). ``buckets`` is the compact
    layout's static ragged bucket-size tuple, ``None`` for the dense layout.
    ``psums`` is the exact all-reduce count (``None`` = don't check).
    """

    fwd_ops: int
    bwd_ops: int
    bits: int
    buckets: Optional[tuple[int, ...]]
    mask_ops: int = 0
    psums: Optional[int] = None
    wire_dtypes: frozenset = frozenset({"uint8", "bfloat16"})

    @property
    def comps(self) -> int:
        return quant_components(self.bits)


def expected_shift_census(exp: ExchangeExpectation
                          ) -> collections.Counter:
    """Multiset of (shift, rows) a compact-layout entry point must produce.

    Forward ops ship bucket ``k`` (``b_k`` rows) at shift ``k``; backward ops
    run the inverted rings — bucket ``k``'s rows at shift ``P - k``. The
    diagonal bucket (k=0) and empty buckets never hit the wire.
    """
    assert exp.buckets is not None
    p = len(exp.buckets)
    census: collections.Counter = collections.Counter()
    fwd_arrays = exp.fwd_ops * exp.comps + exp.mask_ops
    bwd_arrays = exp.bwd_ops * exp.comps
    for k, b in enumerate(exp.buckets):
        if k == 0 or not b:
            continue
        census[(k, b)] += fwd_arrays
        census[((p - k) % p, b)] += bwd_arrays
    return census


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------
def _check_backend(c: Census, exp: ExchangeExpectation, bad) -> None:
    """The backend seam: logical exchanges by direction, their buckets and
    arrays, the mask rides and the psums."""
    quant = c.methods(*QUANTIZED_METHODS)
    raw = c.methods(*RAW_METHODS)
    compact = exp.buckets is not None
    layouts = {e.bucket_sizes for e in quant + raw}
    if layouts - {exp.buckets}:
        bad("RC201", f"exchanges over buckets {sorted(map(str, layouts))}, "
            f"expected {exp.buckets} "
            f"({'compact' if compact else 'dense'} layout)")
    n_bwd = sum(e.reverse is True for e in quant)
    n_fwd = len(quant) - n_bwd
    want = exp.fwd_ops + exp.bwd_ops
    if len(quant) != want or (not compact and n_bwd):
        bad("RC201", f"quantized exchange census mismatch: expected "
            f"{exp.fwd_ops} fwd + {exp.bwd_ops} bwd ops, found {n_fwd} fwd "
            f"+ {n_bwd} bwd")
    elif compact and n_bwd != exp.bwd_ops:
        bad("RC203", f"{exp.bwd_ops} backward exchanges must run the "
            f"inverted rings (reverse=True), found {n_bwd} reversed of "
            f"{len(quant)}")
    arity = collections.Counter(len(e.arrays) for e in quant)
    if set(arity) - {exp.comps}:
        bad("RC201", f"each quantized exchange must move {exp.comps} "
            f"array(s), found {dict(arity)}")
    if len(raw) != exp.mask_ops:
        bad("RC201", f"expected {exp.mask_ops} unquantized mask ride(s), "
            f"found {len(raw)}")
    if any(e.reverse for e in raw):
        bad("RC203", "an affected-mask ride ran the inverted rings — masks "
            "travel with the forward exchange")
    n_psum = len(c.methods("psum"))
    if exp.psums is not None and n_psum != exp.psums:
        bad("RC201", f"backend psum census mismatch: expected exactly "
            f"{exp.psums}, found {n_psum}")


def check_exchange_census(c: Census, exp: ExchangeExpectation, where: str,
                          rank: Optional[int] = None,
                          n_parts: Optional[int] = None) -> list[Finding]:
    """Collective census and ring inversion for one entry point: the
    backend seam always, the collectives under a sharded runtime
    (``rank`` and ``n_parts`` given)."""
    out = []

    def bad(code, msg):
        out.append(Finding(code=code, where=where, message=msg))

    _check_backend(c, exp, bad)
    if rank is None:
        return out
    n_gather = len(c.calls(*GATHERS))
    if n_gather:
        bad("RC201", f"{n_gather} all_gather collective(s) — the halo "
            "exchange must never gather globally (wire cost P x payload)")
    n_bcast = len(c.calls(*BROADCASTS))
    if n_bcast:
        bad("RC201", f"{n_bcast} broadcast(s) inside a halo path")
    a2a = c.calls(*EXCHANGES)
    if exp.buckets is not None:
        even = sum(e.in_splits is None for e in a2a)
        if even:
            bad("RC201", f"{even} all_to_all_single with equal splits in a "
                "compact-layout entry point — ring buckets must travel as "
                "uneven splits")
        want = expected_shift_census(exp)
        got = shift_census(c, rank, n_parts)
        if got != want:
            detail = []
            missing = dict(want - got)
            extra = dict(got - want)
            if missing:
                detail.append(f"missing (shift, rows) splits {missing}")
            if extra:
                detail.append(f"unexpected {extra}")
            # a pure fwd<->bwd swap is specifically a ring-inversion bug
            code = "RC203" if _is_inversion_miss(want, got) else "RC201"
            bad(code, f"all_to_all_single split census mismatch on rank "
                f"{rank} — expected {exp.fwd_ops} fwd + {exp.bwd_ops} bwd "
                f"ops x {exp.comps} arrays (+{exp.mask_ops} mask) over "
                f"buckets {exp.buckets}: " + "; ".join(detail))
    else:
        split = sum(e.in_splits is not None for e in a2a)
        if split:
            bad("RC201", f"{split} all_to_all_single with uneven splits in "
                "a dense-layout entry point — pairwise blocks move as one "
                "tiled exchange")
        want_a2a = (exp.fwd_ops + exp.bwd_ops) * exp.comps + exp.mask_ops
        if len(a2a) != want_a2a:
            bad("RC201", f"all_to_all_single census mismatch: expected "
                f"{want_a2a} ({exp.fwd_ops} fwd + {exp.bwd_ops} bwd ops x "
                f"{exp.comps} arrays + {exp.mask_ops} mask), found "
                f"{len(a2a)}")
    n_red = len(c.calls(*REDUCES))
    if exp.psums is not None and n_red != exp.psums:
        bad("RC201", f"all_reduce census mismatch: expected exactly "
            f"{exp.psums} (weight-grad leaves + loss + telemetry), found "
            f"{n_red} — a stray all-reduce silently multiplies gradient "
            "sync cost")
    return out


def _is_inversion_miss(want: collections.Counter,
                       got: collections.Counter) -> bool:
    """True when ``got`` is ``want`` with some shifts un-inverted (k vs P-k
    confusion) — same totals per rows-class, wrong directions."""
    if sum(want.values()) != sum(got.values()):
        return False

    def by_rows(c):
        out = collections.Counter()
        for (_, rows), n in c.items():
            out[rows] += n
        return out

    return by_rows(want) == by_rows(got) and want != got


def check_wire_dtypes(c: Census, exp: ExchangeExpectation,
                      where: str) -> list[Finding]:
    """Every exchanged array, at the backend seam and on the wire, must be a
    wire-cheap dtype: for quantized entry points uint8 payload plus bf16
    error compensation, **never** float32 (dequantized data crossing the
    wire voids the one-bit claim). All-reduces and psums are exempt —
    gradient sync is full precision by design."""
    leaks = [(e.method, dtype, shape)
             for e in c.methods(*QUANTIZED_METHODS, *RAW_METHODS)
             for dtype, shape in e.arrays if dtype not in exp.wire_dtypes]
    leaks += [(e.name, e.dtype, e.shape) for e in c.calls(*EXCHANGES)
              if e.dtype not in exp.wire_dtypes]
    return [Finding(
        code="RC202", where=where,
        message=f"{what} ships {dtype}{list(shape)} but this entry point is "
        f"contracted to {sorted(exp.wire_dtypes)} — a full-precision "
        "array on a quantized exchange leaks dequantized data onto the "
        "wire") for what, dtype, shape in leaks]


def check_no_collectives(c: Census, where: str) -> list[Finding]:
    """Simulated-runtime entry points run the whole stack in one process:
    any ``torch.distributed`` collective means backend dispatch leaked."""
    found = collections.Counter(e.name for e in c.collectives)
    if not found:
        return []
    return [Finding(
        code="RC201", where=where,
        message=f"collectives {dict(found)} in a simulated-runtime entry "
        "point — the stacked reference semantics must run as plain tensor "
        "ops")]


def check_overlap(blocking: Census, overlap: Census,
                  where: str) -> list[Finding]:
    """RC209(a): the overlap schedule is census-identical to blocking — the
    same exchanges (arrays, buckets, directions) and the same collectives
    (``async_op=True`` for its exchanges) — plus one ``fence`` per issue:
    without the fence the issued exchange is never landed."""
    out = []

    def bad(msg):
        out.append(Finding(code="RC209", where=where, message=msg))

    def moves(c):
        return [(e.reverse, e.bucket_sizes, e.arrays)
                for e in c.methods(*QUANTIZED_METHODS)]

    issues = len(overlap.methods("issue_quantized"))
    fences = len(overlap.methods("fence"))
    if not issues:
        bad("the overlap-schedule step issued no exchange — it ran the "
            "blocking primitives")
    elif fences != issues:
        bad(f"{issues} issued exchange(s) but {fences} fence(s) — without "
            "the fence the land is never ordered after the issue and the "
            "received rows are read before they arrive")
    if moves(overlap) != moves(blocking):
        bad("the overlap schedule moves other arrays, buckets or directions "
            "than blocking")
    sync_a2a = [e for e in overlap.calls(*EXCHANGES) if not e.async_op]
    if sync_a2a:
        bad(f"{len(sync_a2a)} blocking all_to_all_single in an overlap "
            "step — an issue must start its collective asynchronously")
    plain = [dataclasses.replace(e, async_op=False)
             for e in overlap.collectives]
    if plain != [dataclasses.replace(e, async_op=False)
                 for e in blocking.collectives]:
        bad("the overlap schedule's collectives differ from blocking's "
            "(other splits, dtypes or count)")
    return out


def census_diff(a: Census, b: Census) -> str:
    """The first difference between two censuses, for a message."""
    for field in ("backend", "collectives", "launches"):
        x, y = getattr(a, field), getattr(b, field)
        if x == y:
            continue
        i = next((i for i, (p, q) in enumerate(zip(x, y)) if p != q),
                 min(len(x), len(y)))
        p = x[i] if i < len(x) else "nothing"
        q = y[i] if i < len(y) else "nothing"
        return f"{field}: {len(x)} vs {len(y)} entries, first at {i}: " \
               f"{p} vs {q}"
    return "equal"


def check_same_census(a: Census, b: Census, code: str, where: str,
                      what: str) -> list[Finding]:
    """``a == b``, or one ``code`` finding saying ``what`` and where the
    two first differ."""
    if a == b:
        return []
    return [Finding(code=code, where=where,
                    message=f"{what} ({census_diff(a, b)})")]
