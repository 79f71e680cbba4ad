"""The ``fleet`` loop: one client, one batch in flight.

Each batch is ``systems_per_batch`` copies of the sketch, split into the
program's topology buckets (``models.blocks.build_buckets``) and solved
bucket by bucket by ``BatchSolver.solve``, made with the traffic file's
``solver`` settings; then the host reads how many whole systems came back
solved (every lane converged and satisfied). The inputs cycle through a
pool of ``pool`` input sets made on the device at set-up, each lane's from
``sketches/<sketch>.lanes`` and drawn from ``--seed``.

A loop file (``loops/<loop>.py``, named by the traffic file's ``loop``)
defines ``Loop``, which keeps the answers the check reads (``answers``) and
the work the per-layer readers count (``work``), and ``plant(patch,
change)``, which breaks the call the loop times for the tests of the
check: here ``BatchSolver.solve``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from portbench import roofline
from portbench.reference.lm import Answer


def _annotate(name):
    return torch.profiler.record_function(f"portbench.{name}")


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


@dataclass
class Inputs:
    params: torch.Tensor  # (lanes, m) float64, the sketch's constraint order
    guesses: torch.Tensor  # (lanes, n) float64, the sketch's variable ids
    solver_args: list  # what the program is called with


class Loop:
    """Batches of whole sketches through ``BatchSolver``, bucket by bucket."""

    def __init__(self, cfg, traffic, sketch_mod, sketch, device):
        from ezpz_tpu_torch.batch import BatchSolver
        from ezpz_tpu_torch.config import Config
        from ezpz_tpu_torch.models.blocks import build_buckets

        self.cfg, self.traffic, self.sketch_mod, self.sketch = cfg, traffic, sketch_mod, sketch
        self.device = torch.device(device)
        self.copies = traffic["systems_per_batch"]
        cons = [r.constraint for r in sketch_mod.port_requests(cfg)]
        self.buckets = build_buckets(cons, sketch.n_vars)
        self.solvers = [BatchSolver(b.system, Config(), batch_params=True, device=self.device,
                                    **traffic["solver"])
                        for b in self.buckets]
        dev = self.device
        # Per bucket: its lanes' variables and, per block, the sketch's
        # constraint of each instance (every kind here lowers to one).
        self.var_index = [torch.as_tensor(b.var_index, dtype=torch.long, device=dev)
                          for b in self.buckets]
        self.sources = [[(torch.as_tensor(b.cid_index[:, blk.cid], dtype=torch.long,
                                          device=dev), blk.spec.nparams)
                         for blk in b.system.blocks] for b in self.buckets]
        self.pool, self.steps, self.kept = [], [], {}

    def prepare(self, seed: int):
        """The pool of input sets from ``seed``, then every set solved once
        (warm-up), recording each bucket's LM steps."""
        gen = _generator(seed, self.device)
        self.pool = [self._inputs(*self.sketch_mod.lanes(
            self.cfg, self.sketch, self.copies, self.traffic["vary"], gen, self.device))
            for _ in range(self.traffic["pool"])]
        self.steps = []
        for inp in self.pool:
            outs = self._solve(inp)
            self.steps.append([int(o.iterations.sum()) for o in outs])

    def _inputs(self, params, guesses) -> Inputs:
        args = []
        for b, vi, srcs in zip(self.buckets, self.var_index, self.sources):
            lanes = self.copies * len(b.components)
            x0 = guesses[:, vi].reshape(lanes, -1)
            pars = tuple(params[:, src].unsqueeze(-1)[..., :npar]
                         .reshape(lanes, src.shape[1], npar).contiguous()
                         for src, npar in srcs)
            args.append((x0, pars))
        return Inputs(params, guesses, args)

    def _solve(self, inp: Inputs):
        with _annotate("solve"):
            return [s.solve(x0, pars) for s, (x0, pars) in zip(self.solvers, inp.solver_args)]

    def _solved(self, outs) -> torch.Tensor:
        """(copies,) bool: every lane of the system converged and satisfied."""
        with _annotate("count"):
            ok = None
            for b, o in zip(self.buckets, outs):
                lane = (o.converged & o.satisfied.all(-1)).view(self.copies, len(b.components))
                ok = lane.all(1) if ok is None else ok & lane.all(1)
            return ok

    def run(self, seconds=None, count=None, keep=()):
        """Batches until ``seconds`` have passed (or ``count`` batches),
        each synchronised by reading its solved count. Keeps the answers of
        the batches in ``keep`` and of the last. Returns (wall seconds,
        batches, systems attempted, systems solved)."""
        self.kept = {}
        solved = k = 0
        t0 = time.perf_counter()
        while True:
            i = k % len(self.pool)
            outs = self._solve(self.pool[i])
            solved += int(self._solved(outs).sum())
            if k in keep:
                self.kept[k] = (i, outs)
            k += 1
            if (count is not None and k >= count) or (
                    seconds is not None and time.perf_counter() - t0 >= seconds):
                break
        wall = time.perf_counter() - t0
        self.kept[k - 1] = (i, outs)
        return wall, k, k * self.copies, solved

    def end_to_end(self, wall: float, solved: int) -> dict:
        """Systems solved a second over the window's wall time."""
        return {"systems_per_s": solved / wall}

    def trips(self) -> dict:
        """LM steps a lane of each bucket in each pool set (warm-up)."""
        return {f"bucket {bi}": [round(st[bi] / (self.copies * len(b.components)), 4)
                                 for st in self.steps] for bi, b in enumerate(self.buckets)}

    def keep_for(self, rng, limit=None):
        """Batch indices whose answers the check reads, drawn from ``rng``
        among the first ``from_first`` batches (or ``limit``)."""
        spec = self.traffic["check_batches"]
        first = spec["from_first"] if limit is None else min(spec["from_first"], limit)
        return set(rng.choice(first, size=min(spec["drawn"], first), replace=False).tolist())

    def answers(self, rng):
        """(params, guess, the program's ``Answer``) of systems drawn from
        ``rng`` in every kept batch, in the sketch's ids."""
        out = []
        per = self.traffic["check_systems_per_batch"]
        n, m = self.sketch.n_vars, self.sketch.n_constraints
        for _k, (i, outs) in sorted(self.kept.items()):
            systems = np.sort(rng.choice(self.copies, size=min(per, self.copies), replace=False))
            sel = torch.as_tensor(systems, device=self.device)
            inp = self.pool[i]
            params = inp.params[sel].cpu().numpy()
            guesses = inp.guesses[sel].cpu().numpy()
            x = np.zeros((len(systems), n))
            sat = np.zeros((len(systems), m), dtype=bool)
            conv = np.ones(len(systems), dtype=bool)
            for b, o in zip(self.buckets, outs):
                comps = len(b.components)
                x[:, b.var_index] = o.x.view(self.copies, comps, -1)[sel].cpu().numpy()
                sat[:, b.cid_index] = o.satisfied.view(self.copies, comps, -1)[sel].cpu().numpy()
                conv &= o.converged.view(self.copies, comps)[sel].all(1).cpu().numpy()
            out += [(params[j], guesses[j], Answer(x[j], bool(conv[j]), sat[j]))
                    for j in range(len(systems))]
        return out

    def work(self, batches: int) -> dict:
        """What the roofline readers count for ``batches`` batches from the
        pool's start, from the sketch's own shapes (``roofline``)."""
        buckets = []
        for bi, b in enumerate(self.buckets):
            comp = b.cid_index[0]
            shape = roofline.component_shape(self.sketch, comp, b.var_index[0])
            buckets.append(dict(shape, lanes=self.copies * len(b.components),
                                steps=sum(self.steps[k % len(self.pool)][bi]
                                          for k in range(batches))))
        return {"batches": batches, "buckets": buckets}


def plant(patch, change):
    """Break the timed call underneath, through ``patch`` (a ``setattr``,
    such as pytest's ``monkeypatch.setattr``): ``BatchSolver.solve`` returns
    ``change(x, x0)`` as its coordinates, its iterations and its converged,
    satisfied and degenerate flags as solved."""
    from ezpz_tpu_torch import batch

    real = batch.BatchSolver.solve

    def broken(self, x0, pars=None, *a, **k):
        out = real(self, x0, pars, *a, **k)
        return batch.BatchResult(change(out.x, x0), out.iterations, out.converged,
                                 out.satisfied, out.degenerate)

    patch(batch.BatchSolver, "solve", broken)
