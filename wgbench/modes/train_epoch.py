"""Mode ``train_epoch``: ``train.train_epoch`` over whole passes of the
split, one CUDA graph of the step replayed once a batch.

Set-up drives the one training state from the seed through its first
steps, all through ``train_epoch`` on pass 0's batches, each batch once:

- step 1, a call of one step (eager): the first gradient, as the
  optimizers' first moments hold it;
- steps 2-4, a call of three (two eager, the last replayed from a graph of
  its own): the parameters' change after them;
- steps 5 on, the call at the window's S that captures the graph the
  window replays (its first two steps eager, then replays of that graph),
  over pass 0's batches from the fifth on and then its first four: the
  losses of its first :data:`CAPTURED_COMPARED` steps, four of them replays.

The reference follows the first ``CHECKED + CAPTURED_COMPARED`` steps.
Numbers compared (those that ``limits/<cell>.json`` gives a limit):

- ``loss``: the widest relative gap of those steps' losses;
- ``grad``: the worst leaf's gap between the norms of the first step's
  gradient as the optimizer got it (the port's from Adam's and LazyAdam's
  first moments, ``m / (1 - beta1)``);
- ``grad_last``: ``grad`` over the last layer's leaves alone, where no
  ReLU gate lies between leaf and loss, so that rounding cannot flip a
  gate and the gap is steady from seed to seed;
- ``change``: the worst leaf's gap between the norms of its change over
  steps 1-4.

A leaf's gap is over the larger of the reference's norm of that leaf and
of the median leaf; leaves whose reference gradient is under a thousandth
of the median leaf's are left out (``counted_leaves``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from wgbench.program import Mode, _sync
from wgbench.reference import steps as R
from wgbench.traffic import Traffic

CHECKED = 4  # steps 1-4: one eager step, then a call of three
CAPTURED_COMPARED = 6  # the capture call's first steps whose losses are compared
FAULTS = {"half_batch": {"batch_fraction": 0.5}}


class Runner(Mode):
    UNIT = "step"

    def setup(self) -> None:
        from wholegraph_tpu_torch.train import train_epoch

        st, tr = self.built.state, self.traffic
        C, Y = tr.epoch(0)
        seeds = tr.sampler_seeds(0, tr.per_pass + CHECKED, self.dev)
        beta1 = self.built.dense_opt.param_groups[0]["betas"][0]
        l1 = train_epoch(st, C[:1], Y[:1], seeds[:1])
        # a parameter the optimizer never stepped has no first moment: its gradient reads 0
        grads = {name: float(self.built.dense_opt.state.get(p, {}).get(
                     "exp_avg", torch.zeros(())).norm()) / (1.0 - beta1)
                 for name, p in self.built.leaves().items()}
        if self.run.cfg["train_embedding"]:
            b1 = self.built.emb.optimizer.beta1
            grads["table"] = float(self.built.emb.slots["m"].norm()) / (1.0 - b1)
        l2 = train_epoch(st, C[1:CHECKED], Y[1:CHECKED], seeds[1:CHECKED])
        change = {name: float((p.detach() - self._initial(name)).norm())
                  for name, p in self.built.leaves().items()}
        if self.run.cfg["train_embedding"]:
            from wgbench.inputs import make_features
            f0 = make_features(self.run.cfg, self.run.seed, self.dev)
            change["table"] = float((self.built.emb.table - f0).norm())
            del f0
        _sync(self.dev)
        self.reset_peak()
        # the capture, at the window's S: pass 0's batches from the fifth on, then its first four
        l3 = train_epoch(st, C.roll(-CHECKED, 0), Y.roll(-CHECKED, 0), seeds[CHECKED:])
        self.check = {"losses": l1.tolist() + l2.tolist() + l3[:CAPTURED_COMPARED].tolist(),
                      "grad_norms": grads, "change_norms": change}
        self.step = CHECKED + tr.per_pass
        self.passes = 1
        _sync(self.dev)

    def _initial(self, leaf: str) -> torch.Tensor:
        """A leaf's initial value, in the port's layout (``w`` transposed)."""
        i, key = leaf.split(".", 1)
        w = self.run.inputs["weights"][int(i)][key]
        return w.t() if key == "w" else w

    def one_pass(self) -> None:
        from wholegraph_tpu_torch.train import train_epoch

        tr = self.traffic
        C, Y = tr.epoch(self.passes)
        train_epoch(self.built.state, C, Y, tr.sampler_seeds(self.step, tr.per_pass, self.dev))
        self.step += tr.per_pass
        self.passes += 1

    def window(self, seconds: float) -> Dict:
        tr = self.traffic
        n, dt = self.whole_passes(seconds)
        steps = n * tr.per_pass
        return {"seconds": dt, "steps": steps, "attempted": steps, "units": steps * tr.batch,
                "train_seeds_per_s": steps * tr.batch / dt}

    def traced_block(self):
        return self.one_pass, self.traffic.per_pass

    def one_call(self):
        """One step as the graph captures it, for counting its kernels."""
        from wholegraph_tpu_torch.train import train_step

        tr = self.traffic
        c, y = tr.batch_at(0)
        seed = tr.sampler_seeds(0, 1, self.dev)[0]
        emb = self.built.emb
        corr = emb.optimizer.step_table([emb.step + 1], self.dev)[0]
        return lambda: train_step(self.built.state, c, y, seed, corrections=corr)

    def representative(self) -> Dict:
        """Batch 0 of pass 0 and its sampler seed: the inputs of the calls a reader times."""
        tr = self.traffic
        c, y = tr.batch_at(0)
        return {"centers": c, "labels": y, "seed": tr.sampler_seed(0)}


def train_reference(cfg: Dict, mix: Dict, seed: int, ref: Dict, n_steps: int,
                    precision: str = "float32", batch_fraction: float = 1.0
                    ) -> Tuple[R.Trainer, Dict[str, float]]:
    """The reference following the first ``n_steps`` steps, step ``s`` on
    pass 0's batch ``s`` with the sampler seed of step ``s``, and its
    change norms after :data:`CHECKED` steps. ``batch_fraction`` < 1 keeps
    only the first part of each batch (a fault, for the control's readings
    and the test of the comparison)."""
    tr = Traffic(mix, seed, ref["splits"][mix["split"]], ref["labels"])
    C, Y = tr.epoch(0)
    t = R.Trainer(cfg, ref["weights"], ref["row_ptr"], ref["col"], ref["features"], precision)
    keep = max(1, int(C.shape[1] * batch_fraction))
    change = {}
    for s in range(n_steps):
        t.step(C[s, :keep], Y[s, :keep], tr.sampler_seed(s))
        if s + 1 == min(CHECKED, n_steps):
            change = t.change_norms()
    return t, change


def reference_record(cfg: Dict, mix: Dict, seed: int, ref: Dict, check: Dict,
                     precision: str = "float32", batch_fraction: float = 1.0) -> Dict:
    t, change = train_reference(cfg, mix, seed, ref, len(check["losses"]), precision,
                                batch_fraction)
    return {"losses": list(t.losses), "grad_norms": dict(t.first_grad_norms),
            "change_norms": change}


def last_layer(leaves: List[str]) -> List[str]:
    """The counted leaves of the last layer (named ``<layer>.<key>``): no
    ReLU gate lies between them and the loss."""
    layered = [k for k in leaves if k.split(".")[0].isdigit()]
    top = max(int(k.split(".")[0]) for k in layered)
    return [k for k in layered if int(k.split(".")[0]) == top]


def compare(program: Dict, reference: Dict) -> Dict:
    """The numbers, the leaves left out by the rule, and every leaf's gaps
    and each step's loss gap (what a look at a cell's readings needs)."""
    pg, rg = program["grad_norms"], reference["grad_norms"]
    pc, rc = program["change_norms"], reference["change_norms"]
    leaves = R.counted_leaves(rg)
    lp, lr = program["losses"], reference["losses"]
    loss_gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr)]
    numbers = {"loss": max(loss_gaps) if len(lp) == len(lr) else math.inf,
               "grad": max(R.norm_gaps(pg, rg, leaves).values()),
               "grad_last": max(R.norm_gaps(pg, rg, last_layer(leaves)).values()),
               "change": max(R.norm_gaps(pc, rc, leaves).values())}
    return {"numbers": numbers, "left_out": sorted(set(rg) - set(leaves)),
            "detail": {"grad": R.norm_gaps(pg, rg, list(rg)),
                       "change": R.norm_gaps(pc, rc, list(rc)), "loss": loss_gaps,
                       "ref_grad_norms": rg, "ref_change_norms": rc}}
