"""Spread estimates: ``estimated_influence`` calls back to back.

Each call scores a new seed set of ``seeds_per_call`` vertices, drawn
uniformly without replacement from the run's seed, under a new key drawn
the same way: ``estimated_influence(adj, seeds, p, iterations_count,
num_sims, key)``. Every call returns one number, the mean spread.

The check, once the window has closed: ``check_calls`` of the window's
calls, drawn from the seed, are worked out again by the reference
(``portbench/reference/influence.py``), which follows the same coins and
must give the same mean exactly (``spread_gap``, the largest absolute
difference).
"""

import gc

import numpy as np
import torch

from portbench.reference import influence as ref_influence


class Calls:
    """The ``spread`` traffic kind."""

    # in a traced run each stage's span waits for its device work, so that
    # the work falls inside it (the stages sync on their results anyway)
    sync_spans = True


    def __init__(self, mix, config, seed, device, spans):
        from graphem_rapids_torch import influence as inf
        from graphem_rapids_torch.ops import ic_sim as tic

        self.inf, self.tic = inf, tic
        self.mix, self.config, self.seed = mix, config, int(seed)
        self.device, self.spans = device, spans
        self.rng = np.random.default_rng([self.seed, 1])
        self.calls = []
        self.notes = {}

    def setup_targets(self):
        return []

    def set_up(self, adj):
        self.adj = adj

    def _one(self):
        n = self.adj.shape[0]
        seeds = self.rng.choice(n, int(self.mix["seeds_per_call"]),
                                replace=False)
        key = int(self.rng.integers(0, 2**62))
        device = None if self.device == "cuda" else self.device
        value = self.inf.estimated_influence(
            self.adj, seeds, p=float(self.mix["p"]),
            iterations_count=int(self.mix["iterations_count"]),
            num_sims=int(self.mix["num_sims"]), key=key, device=device)
        return seeds, key, value

    def warm_up(self):
        self._one()

    def call(self):
        self.calls.append(self._one())
        return 1

    def window_targets(self):
        inf, tic = self.inf, self.tic
        return [(inf, "estimated_influence", "ic.estimate"),
                (inf, "_as_edges_and_n", "ic.extract"),
                (tic, "cascade_plan_arrays", "ic.plan"),
                (tic, "upload_plan", "ic.upload"),
                (tic, "directed_edges", "ic.upload"),
                (tic, "table_push_lists", "ic.push"),
                (tic, "edge_push_lists", "ic.push"),
                (tic, "_ic_run_table", "ic.cascade"),
                (tic, "_ic_run", "ic.cascade")]

    def facts(self):
        return {"n": self.adj.shape[0], "E": self.adj.nnz // 2,
                "num_sims": int(self.mix["num_sims"])}

    @staticmethod
    def counters():
        from graphem_rapids_torch.ops import ic_cascade, ic_scatter

        return {"ic_cascade": ic_cascade.ic_cascade.launches,
                "ic_scatter": ic_scatter.ic_scatter.launches,
                "push_lists": ic_cascade.push_lists.builds}

    def program_check_steps(self):
        """The window's calls whose answers the check recomputes."""
        rng = np.random.default_rng([self.seed, 2])
        m = min(int(self.mix["check_calls"]), len(self.calls))
        pick = sorted(rng.choice(len(self.calls), m, replace=False))
        return [self.calls[i] for i in pick]

    def release(self):
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, steps, control=False):
        cg = ref_influence.CascadeGraph(self.adj.indptr, self.adj.indices,
                                        self.device)
        p = float(self.mix["p"])
        kw = dict(num_sims=int(self.mix["num_sims"]),
                  max_iters=int(self.mix["iterations_count"]))
        out = {"spread_gap": 0.0}
        ctl = {}
        steps_seen = []
        for seeds, key, value in steps:
            want, _, n_steps = cg.estimate(seeds, p, key=key, **kw)
            steps_seen.append(n_steps)
            out["spread_gap"] = max(out["spread_gap"], abs(value - want))
            if control:
                thr = ref_influence.threshold(
                    float(torch.tensor(p, dtype=torch.bfloat16)))
                got, _, _ = cg.estimate(seeds, p, key=key, thr=thr, **kw)
                ctl["spread_gap"] = max(ctl.get("spread_gap", 0.0),
                                        abs(got - want))
        self.notes = {"ic_form": cg.form, "ic_table_cap": cg.cap,
                      "cascade_steps": steps_seen}
        out.update({f"control.{k}": v for k, v in ctl.items()})
        return out
