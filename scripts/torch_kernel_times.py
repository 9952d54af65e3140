#!/usr/bin/env python3
"""Time the port's kNN kernels K1 (bin fold) and K2 (exact tiled kNN) of
several checkouts in turns on one CUDA card.

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
and 3,999,991 refs (the graphs' edge midpoints).
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
    """graphem_rapids_torch's bin-fold and tiled-kNN modules from ``repo``."""
    for name in list(sys.modules):
        if name == "graphem_rapids_torch" or name.startswith(
                "graphem_rapids_torch."):
            del sys.modules[name]
    sys.path.insert(0, os.path.abspath(repo))
    try:
        bf = importlib.import_module("graphem_rapids_torch.ops.knn_binfold")
        kp = importlib.import_module("graphem_rapids_torch.ops.knn_pallas")
        build = importlib.import_module("graphem_rapids_torch._build")
    finally:
        sys.path.pop(0)
    return bf, kp, build


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
    for repo in args.repo or [ROOT]:
        bf, kp, build = _import_port(repo)
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
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
