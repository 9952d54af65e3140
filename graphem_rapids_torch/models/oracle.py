"""Numpy oracle: a direct transcription of one reference layout step.

Counterpart of ``graphem_rapids_tpu/models/oracle.py`` (the same functions,
the same arithmetic), so that the port's tests have their own ground truth
for layer-by-layer parity. It mirrors the reference's ``update_positions``:

- spring law  F = -k_attr * (||p2-p1|| - L_min) * unit(p2-p1)
- exact (k+1)-NN of sampled edge midpoints vs all midpoints, drop the
  self column
- candidate filtering i<j, shared-vertex, strict 2D orientation
  intersection test on the first two coordinates
- repulsion k_inter * (v - mid) / ||v - mid||^2 scattered to the 4
  endpoints
- position update + per-dimension standardization with the unbiased std
  (ddof=1)
"""

import numpy as np

EPS = 1e-6


def spring_forces_np(positions, edges, k_attr, L_min):
    p1 = positions[edges[:, 0]]
    p2 = positions[edges[:, 1]]
    diff = p2 - p1
    dist = np.linalg.norm(diff, axis=1, keepdims=True) + EPS
    f = -k_attr * (dist - L_min) * (diff / dist)
    forces = np.zeros_like(positions)
    np.add.at(forces, edges[:, 0], f)
    np.add.at(forces, edges[:, 1], -f)
    return forces


def knn_np(queries, refs, k):
    """Exact kNN by full argsort (stable; ties broken by smallest index)."""
    d2 = ((queries[:, None, :] - refs[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1, kind="stable")
    return order[:, :k]


def _orientation(a, b, c):
    return (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (
        b[:, 1] - a[:, 1]
    ) * (c[:, 0] - a[:, 0])


def intersection_forces_np(positions, edges, knn_indices, sampled_indices,
                           k_inter):
    S, k = knn_indices.shape
    ci = np.repeat(sampled_indices, k)
    cj = knn_indices.reshape(-1)

    valid = ci < cj
    ci, cj = ci[valid], cj[valid]
    ei, ej = edges[ci], edges[cj]

    share = (
        (ei[:, 0] == ej[:, 0]) | (ei[:, 0] == ej[:, 1])
        | (ei[:, 1] == ej[:, 0]) | (ei[:, 1] == ej[:, 1])
    )
    ei, ej = ei[~share], ej[~share]

    p1, p2 = positions[ei[:, 0]], positions[ei[:, 1]]
    q1, q2 = positions[ej[:, 0]], positions[ej[:, 1]]
    o1 = _orientation(p1, p2, q1)
    o2 = _orientation(p1, p2, q2)
    o3 = _orientation(q1, q2, p1)
    o4 = _orientation(q1, q2, p2)
    hit = (o1 * o2 < 0) & (o3 * o4 < 0)

    ei, ej = ei[hit], ej[hit]
    p1, p2, q1, q2 = p1[hit], p2[hit], q1[hit], q2[hit]
    mid = (p1 + p2 + q1 + q2) / 4.0

    forces = np.zeros_like(positions)
    for v, idx in ((p1, ei[:, 0]), (p2, ei[:, 1]), (q1, ej[:, 0]),
                   (q2, ej[:, 1])):
        d = v - mid
        dist = np.linalg.norm(d, axis=1, keepdims=True) + EPS
        np.add.at(forces, idx, k_inter * d / dist**2)
    return forces


def update_step_np(positions, edges, sampled_indices, *, k_attr, L_min,
                   k_inter, n_neighbors):
    """One full reference layout step with injected sample indices.

    ``sampled_indices`` are injected (not drawn here) so the oracle and an
    engine can be driven with identical samples for parity testing (torch
    and jax.random streams cannot match bit for bit).
    """
    spring = spring_forces_np(positions, edges, k_attr, L_min)
    midpoints = (positions[edges[:, 0]] + positions[edges[:, 1]]) / 2.0
    knn_idx = knn_np(midpoints[sampled_indices], midpoints, n_neighbors + 1)
    knn_idx = knn_idx[:, 1:]
    inter = intersection_forces_np(
        positions, edges, knn_idx, sampled_indices, k_inter
    )
    new_positions = positions + spring + inter
    new_positions = new_positions - new_positions.mean(axis=0, keepdims=True)
    std = new_positions.std(axis=0, keepdims=True, ddof=1) + EPS
    return new_positions / std
