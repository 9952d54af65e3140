"""2D segment-intersection orientation test.

The test always uses the first two coordinates, even for d >= 3
embeddings: that is the reference semantics the JAX package
(graphem_rapids_tpu/ops/intersect.py) reproduces, and so does this port.
"""


def _orientation(a, b, c):
    """Signed area orientation of ordered triplet (a, b, c) in the xy-plane."""
    return (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (
        b[..., 1] - a[..., 1]
    ) * (c[..., 0] - a[..., 0])


def segments_intersect_2d(p1, p2, q1, q2):
    """Boolean mask: does segment (p1,p2) properly intersect segment (q1,q2)?

    Strict orientation test on the first two coordinates only. All inputs
    are (..., d) tensors with d >= 2; the output is (...,) bool.
    """
    o1 = _orientation(p1, p2, q1)
    o2 = _orientation(p1, p2, q2)
    o3 = _orientation(q1, q2, p1)
    o4 = _orientation(q1, q2, p2)
    return (o1 * o2 < 0) & (o3 * o4 < 0)
