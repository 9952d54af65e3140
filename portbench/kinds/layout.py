"""Layout calls: one engine built in set-up, ``run_layout`` back to back.

The program's side: ``create_graphem(adj, **engine)``, its start read
back, one warm-up call (the eager first iteration, the CUDA graph's
capture and the replays), then whole ``run_layout(num_iterations)`` calls,
each returning the positions to the host in user order.

The check, once the window has closed: ``check_steps`` more calls of one
iteration each through the same replayed step, each taken from the
positions the call before returned. The sample each step drew (recorded by
a wrapper around the engine's ``_sample``) must be the one the engine's
seed gives for that draw: the reference draws it again by the sample rule
from a generator of its own, seeded alike and advanced by one draw an
iteration that ran (``sample_mismatch``). The reference
(``portbench/reference/layout.py``) then recomputes each step from the same
positions and sample (every term in float32, every sum in float64); the
numbers compared are the largest gap over the vertices, each as a share of
the mass of what was added there (``step_gap``), and over the hubs
(``reference/layout.py`` ``HUB_DEGREE``), as a share of that mass without
the mean's share (``hub_gap``), the vertices an exact kNN tie leaves open
left out. The start (the Chebyshev columns, or the
random start) is checked against the reference's start (``start_gap``).
"""

import gc

import numpy as np
import torch

from portbench.reference import layout as ref_layout
from portbench.reference import tables as ref_tables

def _most(values):
    return float(values.max()) if values.numel() else 0.0


def _start_method(init, n):
    if init == "auto":
        return "chebyshev" if n >= 500_000 else "scipy"
    return init


class Calls:
    """The ``layout`` traffic kind."""

    # no span waits for the device: a layout call queues its replays
    # without a host sync, and a wait per block would idle the card
    sync_spans = False


    def __init__(self, mix, config, seed, device, spans):
        import graphem_rapids_torch as grt
        from graphem_rapids_torch.models import embedder as em

        self.grt, self.em = grt, em
        self.mix, self.config, self.seed = mix, config, int(seed)
        self.device, self.spans = device, spans
        self.iters = int(mix["num_iterations"])
        self.emb = None
        self.last = None
        self.sample = {}
        self.draws = 0  # the engine's sample draws so far: one an iteration
        self.notes = {}

    # -- set-up ---------------------------------------------------------- #

    def setup_targets(self):
        em = self.em
        return [(em, "build_neighbor_table_binned", "tables"),
                (em, "build_neighbor_table", "tables"),
                (em, "spectral_init", "spectral")]

    def set_up(self, adj):
        self.adj = adj
        kw = dict(self.config["engine"])
        backend = kw.pop("backend", None)
        device = None if self.device == "cuda" else self.device
        self.emb = self.grt.create_graphem(
            adj, backend=backend, device=device, seed=self.seed,
            verbose=False, **kw)
        self.start = self.emb.positions
        original = self.emb._sample

        def recorded():
            s = original()
            self.sample["last"] = s
            return s

        self.emb._sample = recorded

    def _layout(self, iterations):
        self.last = self.emb.run_layout(num_iterations=iterations)
        self.draws += iterations
        return self.last

    def warm_up(self):
        self._layout(self.iters)

    # -- the window ------------------------------------------------------ #

    def call(self):
        self._layout(self.iters)
        return self.emb.n_edges * self.iters

    def window_targets(self):
        G = self.em.GraphEmbedderTorch
        return [(G, "run_layout", "layout.call"),
                (G, "_iterate", "layout.step"),
                (G, "positions", "layout.read")]

    def facts(self):
        """What the per-layer readers need to know of this engine."""
        from graphem_rapids_torch.ops import knn_binfold as bf

        emb = self.emb
        R = int(len(emb._nb["ref_edge"]))
        plan = emb._nb.get("overflow_plan")
        facts = {"n": emb.n, "E": emb.n_edges, "d": emb.n_components,
                 "S": emb.sample_size, "k": emb._k_eff, "refs": R,
                 "strategy": emb._strategy, "table": emb.table_kind,
                 "fused_refs": bool(emb._fused_refs_active),
                 "n_seg": bf.segments(R, 2048)[1],
                 "iterations_per_call": self.iters}
        if plan is not None:
            hubs = np.asarray(plan["block_hub"])
            facts["hub_blocks"] = int(len(hubs))
            facts["hub_block_size"] = int(plan["block"])
            facts["hub_longest_run"] = int(np.bincount(hubs).max())
        return facts

    @staticmethod
    def counters():
        from graphem_rapids_torch.ops import knn_binfold as bf
        from graphem_rapids_torch.ops import segment

        return {"knn_binfold": bf.knn_binfold.launches,
                "segment_sum": segment.segment_sum.launches,
                "segment_sum_cluster": segment.segment_sum_cluster.launches,
                "sort_tiles": segment.sort_tiles.launches}

    # -- the check ------------------------------------------------------- #

    def program_check_steps(self):
        """The check's program calls: (positions before, the draw's index,
        its sample, positions after)."""
        steps = []
        before = self.last
        for _ in range(int(self.mix["check_steps"])):
            draw = self.draws
            after = self._layout(1)
            sample = self.sample["last"].detach().to("cpu").clone()
            steps.append((before, draw, sample, after))
            before = after
        return steps

    def release(self):
        self.emb = None
        self.sample.clear()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, steps, control=False):
        """{name: value} of the compared numbers (and of the control's,
        under ``control.<name>``), worked out on the run's device."""
        dev = self.device
        adj = self.adj
        n = adj.shape[0]
        engine = self.config["engine"]
        budget = (ref_tables.MAX_REFS_SEGMENTED - 1 if dev == "cuda"
                  else None)
        space = ref_tables.ref_space(adj.indptr, adj.indices, dev, budget)
        e0, e1 = ref_tables.upper_edges(adj.indptr, adj.indices, dev)
        ref = ref_layout.LayoutReference(space, e0, e1, engine)
        draws = ref_layout.SampleDraws(self.seed, len(e0),
                                       int(engine["sample_size"]), dev)
        deg = torch.as_tensor(np.diff(adj.indptr), device=dev)
        hubs = torch.nonzero(deg >= ref_layout.HUB_DEGREE).flatten()
        out = {"sample_mismatch": 0, "step_gap": 0.0, "hub_gap": 0.0}
        ctl = {}
        self.notes = {"hubs": int(hubs.numel())}
        for before, draw, sample, after in steps:
            if not draws.matches(draw, sample):
                out["sample_mismatch"] += 1
                continue
            P = torch.as_tensor(before, device=dev)
            R, scale = ref.step(P, sample)
            left_out = ref.open_vertices
            self.notes["left_out"] = (self.notes.get("left_out", 0)
                                      + int(left_out.numel()))
            got = torch.as_tensor(after, device=dev)
            err = ref_layout.step_gaps(got, R, scale, left_out)
            worst = int(err.argmax())
            if float(err[worst]) >= out["step_gap"]:
                self.notes["worst_vertex"] = {
                    "degree": int(deg[worst]),
                    "radius": float(R[worst].norm()),
                    "scale": float(scale[worst].max()),
                    "abs_gap": float((got[worst].double()
                                      - R[worst]).abs().max())}
            out["step_gap"] = max(out["step_gap"], float(err[worst]))
            terms = ref.term_scale
            out["hub_gap"] = max(out["hub_gap"], _most(
                ref_layout.step_gaps(got, R, terms, left_out)[hubs]))
            if control:
                C, _ = ref.step(P, sample, dtype=torch.bfloat16)
                ctl["step_gap"] = max(ctl.get("step_gap", 0.0), float(
                    ref_layout.step_gaps(C, R, scale, left_out).max()))
                ctl["hub_gap"] = max(ctl.get("hub_gap", 0.0), _most(
                    ref_layout.step_gaps(C, R, terms, left_out)[hubs]))
                del C
            del P, R, scale, got, terms
        del space, ref
        method = _start_method(engine.get("init", "auto"), n)
        d = int(engine["n_components"])
        if method == "random":
            want = ref_layout.random_start(n, d, self.seed)
            out["start_gap"] = float(np.abs(self.start - want).max())
            if control:
                ctl["start_gap"] = float(np.abs(
                    want.astype(np.float64)
                    - torch.as_tensor(want).bfloat16().double().numpy()
                ).max())
        elif method == "chebyshev":
            X, ritz = ref_layout.chebyshev_start(adj.indptr, adj.indices, d,
                                                 self.seed, dev)
            span = X[:, :d + 1]
            out["start_gap"] = ref_layout.subspace_gap(
                torch.as_tensor(self.start, device=dev), span)
            self.notes["ritz"] = ritz.tolist()
            self.notes["start_gap_own_span"] = ref_layout.subspace_gap(
                torch.as_tensor(self.start, device=dev), X[:, :d])
            if control:
                Xc, _ = ref_layout.chebyshev_start(
                    adj.indptr, adj.indices, d, self.seed, dev,
                    dtype=torch.bfloat16)
                ctl["start_gap"] = ref_layout.subspace_gap(Xc[:, :d], span)
        else:
            raise ValueError(f"the reference has no {method!r} start")
        out.update({f"control.{k}": v for k, v in ctl.items()})
        return out
