"""The plain reference of Sylvie's full-graph training step, in PyTorch.

It re-derives from the benchmark's graph and weights what the program's
set-up derives (the block partition, the ring-bucket halo plan), and follows
the program's first training steps on the whole graph at once: every node's
own row is exact, and what partition ``p`` reads of a node owned by another
partition is that row sent through the exchange at the configured bits.

What the exchange does (Sylvie, arXiv:2303.01277, §3 and Alg. 2):

* Each halo entry (receiver ``p``, sender ``q``, node ``u``) is one row of
  ``q``'s send buffer: the compact ring layout puts it in bucket ``k = (p -
  q) % P`` at the rank of ``u`` among the nodes ``p`` needs from ``q``;
  each bucket holds the largest such count over the ring, rounded up to 8
  rows.
* Below 32 bits a row is quantized to ``bits`` per value with one (scale,
  zero) pair in bfloat16 and stochastic rounding (Equ. 3-5); its noise is
  the uniform draw over the whole send buffer of the site's stream, seeded
  by ``SeedSequence([seed, epoch, stream])`` (``2i`` forward, ``2i + 1``
  backward), as the program states its noise streams.
* A synchronous step exchanges every site in both passes; the backward
  quantizes each halo row's gradient on the receiver and sums it onto the
  owner. An asynchronous step (Sylvie-A) reads the previous step's halo,
  sends this step's as the next one's, adds the previous step's boundary
  gradient onto the owners and sends this step's as the next one's. A
  synchronous step drains the boundary gradients to zero.

Nothing here imports the program: torch and numpy only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

ALIGNMENT = 8


def stream_noise(seed: int, epoch: int, stream: int, shape, device
                 ) -> torch.Tensor:
    """Uniform [0, 1) float32 noise of one stream over a whole buffer."""
    s = np.random.SeedSequence([int(seed), int(epoch), int(stream)]
                               ).generate_state(1)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(s))
    return torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                      device=device)


def quant_dequant(h: torch.Tensor, u: Optional[torch.Tensor],
                  bits: int) -> torch.Tensor:
    """Rows of ``h`` quantized to ``bits`` and back (Equ. 3-5): per row
    ``hbar = (h - min) / (max - min) * B``, rounded up where ``u`` lies
    below its fraction; scale ``(max - min) * f32(1 / B)`` and zero ``min``
    carried in bfloat16. 32 bits is the identity."""
    if bits >= 32:
        return h
    big = float(2 ** bits - 1)
    lo = h.amin(dim=-1, keepdim=True)
    hi = h.amax(dim=-1, keepdim=True)
    rng = hi - lo
    safe = torch.where(rng > 0, rng, torch.ones_like(rng))
    hbar = (h - lo) / safe * big
    if u is None:
        q = torch.round(hbar)
    else:
        fl = torch.floor(hbar)
        q = fl + (u < (hbar - fl)).to(torch.float32)
    q = q.clamp(0.0, big)
    recip = float(np.float32(1.0) / np.float32(big))
    scale = (rng * torch.full_like(rng, recip)).to(torch.bfloat16).float()
    zero = lo.to(torch.bfloat16).float()
    return q * scale + zero


@dataclasses.dataclass
class Plan:
    """The partition and its halo entries, over global node ids."""

    n: int
    n_parts: int
    rows: int                 # R: rows of one partition's send buffer
    recv: torch.Tensor        # (H,) receiving partition of each entry
    send: torch.Tensor        # (H,) sending partition (the node's owner)
    node: torch.Tensor        # (H,) global id of the entry's node
    pos: torch.Tensor         # (H,) row of the entry in the send buffer
    col: torch.Tensor         # (E,) each edge's row of [h ; halo entries]

    @staticmethod
    def build(src: torch.Tensor, dst: torch.Tensor, n: int,
              n_parts: int) -> "Plan":
        dev = src.device
        P = int(n_parts)
        part = torch.arange(n, device=dev) * P // n
        ps, pd = part[src], part[dst]
        halo = ps != pd
        key = (pd[halo] * P + ps[halo]) * n + src[halo]
        uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
        pair = uniq // n
        counts = torch.bincount(pair, minlength=P * P)
        first = torch.cumsum(counts, 0) - counts
        slot = torch.arange(uniq.numel(), device=dev) - first[pair]
        recv, send = pair // P, pair % P
        pc = counts.reshape(P, P).cpu().numpy()          # [recv, send]
        ring = np.zeros(P, np.int64)
        for k in range(1, P):
            ring[k] = max(pc[(p + k) % P, p] for p in range(P))
        bucket = np.where(ring > 0, -(-ring // ALIGNMENT) * ALIGNMENT, 0)
        bucket[0] = 0
        bstart = torch.as_tensor(np.concatenate([[0], np.cumsum(bucket)]),
                                 device=dev)
        pos = bstart[(recv - send) % P] + slot
        col = src.clone()
        col[halo] = n + inv
        return Plan(n, P, int(bucket.sum()), recv, send, uniq % n, pos, col)


def sparse_rows(rows: torch.Tensor, cols: torch.Tensor, n_rows: int,
                n_cols: int, dtype=torch.float32) -> torch.Tensor:
    """The 0/1 (with repeats summed) matrix of the pairs, in CSR form."""
    ones = torch.ones(rows.numel(), dtype=dtype, device=rows.device)
    m = torch.sparse_coo_tensor(torch.stack([rows, cols]), ones,
                                (n_rows, n_cols)).coalesce()
    return m.to_sparse_csr()


class _SpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, at, t):
        ctx.at = at
        return a @ t

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.at @ g.contiguous()


def spmm(a: torch.Tensor, at: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``a @ t`` with the gradient ``a^T @ g`` (``at`` given)."""
    return _SpMM.apply(a, at, t)


class _SyncHalo(torch.autograd.Function):
    """Forward: the halo entries' rows through the exchange. Backward: each
    entry's gradient quantized on the receiver and summed onto its node."""

    @staticmethod
    def forward(ctx, h, comm, site):
        ctx.comm, ctx.site = comm, site
        return comm.send_rows(h, site)

    @staticmethod
    def backward(ctx, g):
        comm, site = ctx.comm, ctx.site
        return comm.return_grads(g, site), None, None


class RefComm:
    """The exchange of one step for the reference's model: ``table(i, h)``
    is ``[h ; halo entries]`` at site ``i``."""

    def __init__(self, plan: Plan, bits: int, seed: int, epoch: int,
                 sync: bool, caches: list, grad_ins: list):
        self.plan, self.bits = plan, bits
        self.seed, self.epoch, self.sync = seed, epoch, sync
        self.caches, self.grad_ins = caches, grad_ins
        self.new_caches: list = []
        self.stale: list = []          # async: (site, leaf) read this step
        self.aux = []                  # async: (h, summed stale gradients)

    def _noise(self, stream: int, d: int, dev) -> torch.Tensor:
        return stream_noise(self.seed, self.epoch, stream,
                            (self.plan.n_parts, self.plan.rows, d), dev)

    def send_rows(self, h: torch.Tensor, site: int) -> torch.Tensor:
        pl = self.plan
        rows = h.index_select(0, pl.node)
        if self.bits >= 32:
            return rows
        u = self._noise(2 * site, h.shape[1], h.device)[pl.send, pl.pos]
        return quant_dequant(rows, u, self.bits)

    def quant_grads(self, g: torch.Tensor, site: int) -> torch.Tensor:
        pl = self.plan
        if self.bits >= 32:
            return g
        u = self._noise(2 * site + 1, g.shape[1], g.device)[pl.recv, pl.pos]
        return quant_dequant(g, u, self.bits)

    def scatter(self, g: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((self.plan.n, g.shape[1]), dtype=g.dtype,
                          device=g.device)
        return out.index_add_(0, self.plan.node, g)

    def return_grads(self, g: torch.Tensor, site: int) -> torch.Tensor:
        return self.scatter(self.quant_grads(g, site))

    def table(self, site: int, h: torch.Tensor) -> torch.Tensor:
        if self.sync:
            if self.bits >= 32:
                halo = h.index_select(0, self.plan.node)
            else:
                halo = _SyncHalo.apply(h, self, site)
            self.new_caches.append(halo.detach())
        else:
            halo = self.caches[site].detach().requires_grad_(h.requires_grad)
            if h.requires_grad:
                self.stale.append((site, halo))
                self.aux.append((h, self.scatter(self.grad_ins[site])))
            with torch.no_grad():
                self.new_caches.append(self.send_rows(h.detach(), site))
        return torch.cat([h, halo], 0)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Adam with bias correction (Kingma and Ba), every quantity in float32,
    the corrections ``1 - b^t`` included."""
    def step(params, grads, state, t):
        state.setdefault("first", dict(grads))     # as the optimizer got it
        new = {}
        for k, p in params.items():
            g = grads[k]
            m = b1 * state["m"][k] + (1 - b1) * g
            v = b2 * state["v"][k] + (1 - b2) * g * g
            state["m"][k], state["v"][k] = m, v
            tf = torch.full((), float(t), device=p.device)
            bc1 = 1 - torch.pow(torch.full_like(tf, b1), tf)
            bc2 = 1 - torch.pow(torch.full_like(tf, b2), tf)
            new[k] = p + (-lr * (m / bc1 / (torch.sqrt(v / bc2) + eps)))
        return new
    return step


def glorot_params(shapes: dict, seed: int, device) -> dict:
    """Weights from the seed: each matrix Glorot-uniform, each bias zero,
    the uniforms of all matrices drawn in one call on ``device``."""
    mats = [k for k, s in shapes.items() if len(s) == 2]
    total = sum(math.prod(shapes[k]) for k in mats)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5EED)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if len(s) == 2:
            lim = math.sqrt(6.0 / (s[0] + s[1]))
            n = math.prod(s)
            out[k] = ((u[at:at + n] * 2.0 - 1.0) * lim).reshape(s)
            at += n
        else:
            out[k] = torch.zeros(s, dtype=torch.float32, device=device)
    return out


@dataclasses.dataclass
class Graph:
    """The graph as the reference reads it (self-loops added)."""

    n: int
    src: torch.Tensor
    dst: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    train_mask: torch.Tensor
    deg: torch.Tensor          # (n,) in-degree, float32

    @staticmethod
    def from_data(data: dict, device, dtype=torch.float32) -> "Graph":
        """Self-loops appended to the generator's edges, as the program's
        normal path (``gcn_normalize``) adds them; the features in
        ``dtype``."""
        n = int(data["x"].shape[0])
        loop = torch.arange(n, device=device)
        src = torch.cat([torch.as_tensor(data["src"], device=device), loop])
        dst = torch.cat([torch.as_tensor(data["dst"], device=device), loop])
        deg = torch.bincount(dst, minlength=n).to(torch.float32)
        return Graph(n, src, dst,
                     torch.as_tensor(data["x"], device=device).to(dtype),
                     torch.as_tensor(data["y"], device=device).long(),
                     torch.as_tensor(data["train_mask"], device=device), deg)


def masked_ce(logits: torch.Tensor, y: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, y[:, None])[:, 0]
    m = mask.to(torch.float32)
    return ((logz - ll) * m).sum() / torch.clamp(m.sum(), min=1.0)


def is_sync(t: int, mode: str, eps_s: Optional[int]) -> bool:
    """Epoch ``t``'s step under the Bounded Staleness Adaptor (§3.3)."""
    if mode != "async" or t == 0:
        return True
    return eps_s is not None and t % eps_s == 0


def train_steps(model, graph: Graph, plan: Plan, params: dict, *, mode: str,
                bits: int, eps_s: Optional[int], lr: float, seed: int,
                steps: int = 3, loss_fn: Callable = masked_ce) -> dict:
    """``steps`` epochs from ``params``: each step's loss, the first step's
    gradient as the optimizer got it, and the parameters after the last."""
    dims = model.comm_dims()
    dev = graph.x.device
    caches = [torch.zeros((plan.recv.numel(), d), dtype=graph.x.dtype,
                          device=dev) for d in dims]
    grad_ins = [torch.zeros_like(c) for c in caches]
    opt = adam(lr)
    state = {"m": {k: torch.zeros_like(p) for k, p in params.items()},
             "v": {k: torch.zeros_like(p) for k, p in params.items()}}
    losses = []
    for t in range(steps):
        sync = is_sync(t, mode, eps_s)
        comm = RefComm(plan, bits, seed, t, sync, caches, grad_ins)
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = loss_fn(model.forward(leaves, graph, plan, comm), graph.y,
                       graph.train_mask)
        total = loss + sum((h * s).sum() for h, s in comm.aux)
        names = list(leaves)
        stale = [leaf for _, leaf in comm.stale]
        got = torch.autograd.grad(total, [leaves[k] for k in names] + stale)
        grads = dict(zip(names, got[:len(names)]))
        new_grad_ins = [torch.zeros_like(c) for c in caches]
        with torch.no_grad():
            for (site, _), g in zip(comm.stale, got[len(names):]):
                new_grad_ins[site] = comm.quant_grads(g, site)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            params = opt(params, grads, state, t + 1)
        caches = [c.detach() for c in comm.new_caches]
        grad_ins = new_grad_ins
    return dict(losses=losses, grad0=state["first"], params=params)
