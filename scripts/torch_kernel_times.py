#!/usr/bin/env python3
"""Time the port's kNN kernels K1 (bin fold), K2 (exact tiled kNN) and K3
(ring bin-fold hop) of several checkouts in turns on one CUDA card.

    python3 scripts/torch_kernel_times.py --repo OLD --repo NEW \\
        --repo NEW --repo OLD

Each ``--repo`` is a checkout holding ``graphem_rapids_torch``. Its
kernels are built from its own sources into its own build directory and
timed in the order given, so two versions of a kernel are compared inside
one run on one card (parent, change, change, parent). Without ``--repo``
the checkout this script lives in is timed. Each line is one JSON object
with ``chip_smoke.py``'s two times: ``kernel_ms``, the median of 20 calls
each timed alone (the card also waits for the host to enqueue each call),
and ``back_to_back_ms``, CUDA events around 20 calls launched back to back
(the card's time).

K1 is timed at S=512 and S=416 queries (d=3, T=2048, G=24) against
800,000 and 5,699,741 refs (the 100K and 1M graphs' fused refs; 1 in 40
rows at the 1e30 pad). K2 is timed at S=512, d=3, k=16 against 399,984
and 3,999,991 refs (the graphs' edge midpoints). K3 (``ring_fold_cuda``,
one hop, which makes its own scratch) is timed at the one-rank 1M shape
(S_loc=512 against the same 5,699,741 refs, no carry), on 64 of those
queries, and on the last of four tiles of those refs (the four-card tile,
S_loc=128, E_loc=1,424,936, offset 3 * R_pad) merged in place into a
carry folded from the third tile, as the ring's later hops do. Where the
checkout has K3's whole-ring entry (``ring_run_cuda``, one launch per
ring), it is timed too as a ring of one rank at the one-rank 1M shape and
on the four-card tile (no carry), beside the per-hop entry at the same
shapes (``ring_binfold_hop``).
"""

import argparse
import importlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import back_to_back_ms, cuda_ms, nvidia_smi  # noqa: E402


def _import_port(repo):
    """graphem_rapids_torch's bin-fold, tiled-kNN and ring modules and its
    builder, from ``repo``."""
    for name in list(sys.modules):
        if name == "graphem_rapids_torch" or name.startswith(
                "graphem_rapids_torch."):
            del sys.modules[name]
    sys.path.insert(0, os.path.abspath(repo))
    try:
        bf = importlib.import_module("graphem_rapids_torch.ops.knn_binfold")
        kp = importlib.import_module("graphem_rapids_torch.ops.knn_pallas")
        rb = importlib.import_module(
            "graphem_rapids_torch.parallel.ring_binfold")
        build = importlib.import_module("graphem_rapids_torch._build")
    finally:
        sys.path.pop(0)
    return bf, kp, rb, build



def _timed(fn, **fields):
    fields["kernel_ms"] = cuda_ms(fn)
    fields["back_to_back_ms"] = back_to_back_ms(fn)
    print(json.dumps(fields), flush=True)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", action="append")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device available", file=sys.stderr)
        return 2
    print(nvidia_smi("name,power.limit"), flush=True)
    gen = torch.Generator(device="cpu").manual_seed(0)
    q512 = torch.randn(512, 3, generator=gen).cuda()
    k1_refs = {}
    for label, E in (("100k", 800_000), ("1m", 5_699_741)):
        r = torch.randn(E, 3, generator=gen)
        r[torch.randperm(E, generator=gen)[:E // 40]] = 1e30
        k1_refs[label] = r.cuda()
    k2_refs = {label: torch.randn(E, 3, generator=gen).cuda()
               for label, E in (("100k", 399_984), ("1m", 3_999_991))}
    r1m = k1_refs["1m"]
    t4 = list(torch.cat([r1m, torch.full((3, 3), 1e30, device="cuda")])
              .chunk(4))  # 1,424,936 refs each
    carry4 = None
    for repo in args.repo or [ROOT]:
        bf, kp, rb, build = _import_port(repo)
        build.build(force=True)
        for label, r in k1_refs.items():
            G, n_super = bf._geometry(r.shape[0], 2048, 24)
            for S in (512, 416):
                q = q512[:S]
                _timed(lambda: bf.binfold_bins_cuda(q, r, 2048, G, n_super),
                       repo=repo, kernel="knn_binfold", shape=label, S=S,
                       E=r.shape[0], G=G, n_super=n_super)
        for label, r in k2_refs.items():
            _timed(lambda: kp.knn_tiled_cuda(q512, r, 16), repo=repo,
                   kernel="knn_pallas", shape=label, S=512, E=r.shape[0],
                   k=16)
        T, G, n_super, R_pad, _, _, _ = rb._geometry(r1m.shape[0], 512, 1,
                                                     16, 0.95)
        T4, G4, n_super4, R_pad4, _, _, _ = rb._geometry(t4[3].shape[0],
                                                         512, 4, 16, 0.95)
        if carry4 is None:  # the plain fold, 64 rows at a time
            parts = [rb.ring_fold_reference(q512[i:i + 64], t4[2], None,
                                            2 * R_pad4, T4, G4, n_super4)
                     for i in range(0, 128, 64)]
            carry4 = tuple(torch.cat(c) for c in zip(*parts))
        for label, q, r, c, offset, T_, G_, ns_ in (
                ("1m_1rank_512q", q512, r1m, None, 0, T, G, n_super),
                ("1m_1rank_64q", q512[:64], r1m, None, 0, T, G, n_super),
                ("4card_tile_carry", q512[:128], t4[3],
                 (carry4[0].clone(), carry4[1].clone()), 3 * R_pad4, T4, G4,
                 n_super4)):
            _timed(lambda: rb.ring_fold_cuda(q, r, c, offset, T_, G_, ns_,
                                             out=c),
                   repo=repo, kernel="ring_binfold", shape=label,
                   S_loc=q.shape[0], E_loc=r.shape[0], R_pad=ns_ * G_ * T_,
                   offset=offset, carry=c is not None)
        if hasattr(rb, "ring_run_cuda"):
            _time_whole_ring(rb, q512, r1m, t4[3])
    return 0


def _time_whole_ring(rb, q512, r1m, tile4):
    """K3's whole-ring entry as a ring of one rank, and the per-hop entry
    on the same inputs, at the one-rank 1M shape and on the four-card
    tile."""
    from graphem_rapids_torch.parallel.mesh import Mesh

    mesh = Mesh(1, 0, q512.device)
    for label, q, r in (("1m_1rank_512q", q512, r1m),
                        ("4card_tile_1rank", q512[:128], tile4)):
        S = q.shape[0]
        T, G, n_super, R_pad, _, _, _ = rb._geometry(r.shape[0], S, 1, 16,
                                                     0.95)
        region = rb.ring_region(mesh, S, 3, G, n_super)
        out = (torch.empty((S, G * 128), device=q.device),
               torch.empty((S, G * 128), dtype=torch.int32, device=q.device))
        scratch = rb.ring_fold_scratch(S, 3, G, n_super, q.device)
        _timed(lambda: rb.ring_run_cuda(q, r, region, out, 0, 1, (0, 1), T, G,
                                        n_super, R_pad),
               kernel="ring_binfold_whole_ring", shape=label, S_loc=S,
               E_loc=r.shape[0], blocks=region.made_for[5])
        _timed(lambda: rb.ring_fold_cuda(q, r, None, 0, T, G, n_super,
                                         scratch=scratch),
               kernel="ring_binfold_hop", shape=label, S_loc=S,
               E_loc=r.shape[0])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
