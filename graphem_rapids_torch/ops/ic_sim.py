"""Batched Independent-Cascade simulation in PyTorch.

Counterpart of ``graphem_rapids_tpu/ops/ic_sim.py``. All Monte-Carlo runs
advance together: when a node first activates it gets exactly one chance
to activate each inactive neighbour with probability p, and a run ends when
its frontier is empty. The spread counts every activated node.

Two frontier updates, as in the JAX package:

- gather (``_ic_run_table``, the default): a self-padded in-neighbour table
  turns the activation test into ``frontier[table]``, an (n, cap, B)
  gather, a coin mask and ``.any(dim=1)``; the few above-cap hub edges are
  folded with a sorted segment max (``scatter_reduce`` with ``amax``). The
  state is (n, B) bool, the batch B on the minor axis;
- scatter (``_ic_run``, the fallback for graphs whose table would exceed
  TABLE_BUDGET_SLOTS): per-edge attempts folded with a segment max.

Coins come from an explicit ``torch.Generator`` on the state's device; its
numbers differ from jax.random's, so the two packages agree in
distribution, not run by run. The JAX ``while_loop`` is a Python loop
here, and its ``frontier.any()`` test synchronizes with the device once per
cascade step; fusing the steps (a CUDA graph, or a device-side loop) is
later work.
"""

import numpy as np
import torch

from .forces import _optimal_table_cap

# Beyond this many table slots the gather formulation's memory stops paying
# for itself; the scatter path takes over (the JAX package's bound).
TABLE_BUDGET_SLOTS = 1 << 27


def _generator(key, device):
    """A torch.Generator on ``device``: ``key`` is one already, or an int
    seed (None means 0, as the JAX package's PRNGKey(0) default)."""
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(0 if key is None else int(key))
    return gen


def _ic_run(src, dst, seed_mask, p, generator, n, num_sims, max_iters):
    """Scatter-formulation batched IC cascade; state (num_sims, n) bool.

    src, dst : (2E,) int64 directed edge endpoints (both directions).
    seed_mask : (n,) bool, or (num_sims, n) bool with one seed set per row.
    Returns (num_sims,) int64 final activated counts.
    """
    if seed_mask.ndim == 1:
        active = seed_mask.expand(num_sims, n).clone()
    else:
        active = seed_mask.clone()
    frontier = active.clone()
    dst_rows = dst.expand(num_sims, -1)
    it = 0
    while it < max_iters and bool(frontier.any()):  # one sync per step
        coin = torch.rand((num_sims, src.shape[0]), generator=generator,
                          device=active.device) < p
        attempt = (frontier[:, src] & coin).to(torch.int32)
        hit = torch.zeros((num_sims, n), dtype=torch.int32,
                          device=active.device)
        hit = hit.scatter_reduce(1, dst_rows, attempt, reduce="amax")
        newly = (hit > 0) & ~active
        active |= newly
        frontier = newly
        it += 1
    return active.sum(dim=1)


def build_cascade_plan(edges, n, device):
    """Self-padded in-neighbour table + hub overflow for the gather IC.

    Returns None when the table would exceed TABLE_BUDGET_SLOTS, else a
    dict on ``device`` with 'table' (n, cap) int64 (row v = in-neighbours
    of v, padded with v: a self slot never creates an activation, because
    v in the frontier implies v active), and 'ov_dst'/'ov_src' (O,) int64
    sorted by dst (the above-cap hub edges).
    """
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    src2 = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int32)
    dst2 = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int32)
    deg_in = np.bincount(dst2, minlength=n)
    cap = max(1, _optimal_table_cap(deg_in, n)) if len(edges) else 1
    if n * cap > TABLE_BUDGET_SLOTS:
        return None
    order = np.argsort(dst2, kind="stable")
    d_s, s_s = dst2[order], src2[order]
    starts = np.concatenate([[0], np.cumsum(deg_in)[:-1]]).astype(np.int64)
    rank = np.arange(len(d_s), dtype=np.int64) - starts[d_s]
    in_t = rank < cap
    table = np.repeat(np.arange(n, dtype=np.int32)[:, None], cap, axis=1)
    table[d_s[in_t], rank[in_t]] = s_s[in_t]

    def put(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return {"table": put(table), "ov_dst": put(d_s[~in_t]),
            "ov_src": put(s_s[~in_t])}


def _ic_run_table(table, ov_dst, ov_src, seed_mask, p, generator, num_sims,
                  max_iters):
    """Gather-formulation batched IC cascade; state (n, B) bool.

    seed_mask : (n,) bool, or (n, B) bool with one seed set per column (a
    greedy candidate sweep folds C candidates x s runs into one batch).
    Returns (B,) int64 final activated counts.
    """
    n, _ = table.shape
    O = ov_dst.shape[0]
    dev = table.device
    if seed_mask.ndim == 1:
        active = seed_mask[:, None].expand(n, num_sims).clone()
    else:
        active = seed_mask.clone()
    B = active.shape[1]
    frontier = active.clone()
    ov_rows = ov_dst[:, None].expand(O, B) if O else None
    it = 0
    while it < max_iters and bool(frontier.any()):  # one sync per step
        fr_nb = frontier[table]  # (n, cap, B)
        coins = torch.rand(fr_nb.shape, generator=generator, device=dev) < p
        hit = (fr_nb & coins).any(dim=1)  # (n, B)
        if O:
            att = frontier[ov_src] & (
                torch.rand((O, B), generator=generator, device=dev) < p
            )
            hit_ov = torch.zeros((n, B), dtype=torch.int32, device=dev)
            hit_ov = hit_ov.scatter_reduce(0, ov_rows, att.to(torch.int32),
                                           reduce="amax")
            hit |= hit_ov > 0
        newly = hit & ~active
        active |= newly
        frontier = newly
        it += 1
    return active.sum(dim=0)


def independent_cascade(edges, n, seeds, p=0.1, num_sims=64, max_iters=200,
                        key=None, plan=None, device=None):
    """Monte-Carlo IC spread for a seed set.

    edges : (E, 2) int array, the undirected edge list (i < j).
    n : number of vertices. seeds : sequence of int, initially active.
    p : per-edge propagation probability. num_sims : Monte-Carlo batch.
    max_iters : cascade-depth cap. key : int seed or torch.Generator.
    plan : a build_cascade_plan result to reuse. device : None is CUDA,
    which must exist; pass 'cpu' to run on the CPU.

    Returns (counts (num_sims,) np.ndarray of activated counts, max_iters).
    """
    from ..models.embedder import resolve_device

    dev = resolve_device(device)
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    seed_mask = torch.zeros(n, dtype=torch.bool, device=dev)
    seed_idx = np.asarray(list(seeds), np.int64)
    seed_mask[torch.as_tensor(seed_idx, device=dev)] = True
    gen = _generator(key, dev)
    if plan is None:
        plan = build_cascade_plan(edges, n, dev)
    if plan is not None:
        counts = _ic_run_table(plan["table"], plan["ov_dst"], plan["ov_src"],
                               seed_mask, float(p), gen, int(num_sims),
                               int(max_iters))
        return counts.cpu().numpy(), max_iters
    src = torch.as_tensor(np.concatenate([edges[:, 0], edges[:, 1]]),
                          device=dev)
    dst = torch.as_tensor(np.concatenate([edges[:, 1], edges[:, 0]]),
                          device=dev)
    counts = _ic_run(src, dst, seed_mask, float(p), gen, int(n),
                     int(num_sims), int(max_iters))
    return counts.cpu().numpy(), max_iters


def estimated_influence(edges, n, seeds, p=0.1, num_sims=64, max_iters=200,
                        key=None, device=None):
    """Mean IC spread (float) over a Monte-Carlo batch."""
    counts, _ = independent_cascade(
        edges, n, seeds, p=p, num_sims=num_sims, max_iters=max_iters,
        key=key, device=device,
    )
    return float(np.mean(counts))
