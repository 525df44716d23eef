"""Driver of the training cells: SoftSDFModel stepped by
make_train_step(model, create_train_state(model)), as the configuration
states it.

Set-up builds the one model, optimizer and step, and drives the first three
steps through the window's own call on the first three batches of the pool
(all different); the window goes on from the fourth, on the same objects.
From those three steps it keeps each step's loss, the first gradient as
Adam got it (its first moment after one step over 1 - beta1) and the
parameters' change over the three, for the reference to follow: each taken
as a norm per leaf (threshold_bias, log_tau, channel_mix)."""

from __future__ import annotations

import math
import time

import torch

from benchmark.harness import traffic
from benchmark.harness.runner import Check

FOLLOWED = 3  # steps the reference follows
LEAVES = ("threshold_bias", "log_tau", "channel_mix")


def _norm(t: torch.Tensor) -> float:
    return float(t.detach().double().norm())


def gaps(got: dict, want: dict) -> dict:
    """The numbers compared, each relative to the reference:
      loss_gap    the worst step's |loss - reference's| / reference's
      grad_gap    the worst leaf's gap of first-gradient norms
      change_gap  the worst leaf's gap of change norms, over the leaves
                  whose reference gradient is above a thousandth of the
                  median leaf's (the others move by rounding alone)
    a leaf's gap over the larger of its reference norm and the median
    leaf's."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))

    def worst(key, leaves):
        ref = sorted(want[key].values())
        median = ref[len(ref) // 2]
        return max(abs(got[key][k] - want[key][k]) / max(want[key][k], median) for k in leaves)

    g_ref = sorted(want["grad"].values())
    moving = [k for k in LEAVES if want["grad"][k] > 1e-3 * g_ref[len(g_ref) // 2]]
    return {"loss_gap": loss, "grad_gap": worst("grad", LEAVES), "change_gap": worst("change", moving)}


class SoftTrain:
    def __init__(self, run):
        self.run = run
        cfg = run.config
        self.size = [int(v) for v in cfg["size"]]
        self.batch = int(cfg["batch"])
        self.pixels_per_unit = self.batch * self.size[0] * self.size[1]
        self.spans = {}

    def _batch(self, index: int):
        run = self.run
        return (traffic.make_input(run.traffic, self.size, self.batch, run.seed, index, run.device),
                traffic.make_target(run.traffic, self.size, self.batch, run.seed, index, run.device))

    def setup(self) -> None:
        from chaq_sdfgen_tpu_torch import SoftConfig, SoftSDFModel, create_train_state, make_train_step

        run = self.run
        t0 = time.perf_counter()
        m, o = run.config["model"], run.config["optimizer"]
        pool = int(run.traffic["pool"])
        if pool < FOLLOWED:
            raise ValueError(f"a pool of {pool} batches: the first {FOLLOWED} steps need batches that differ")
        self.pool = [self._batch(i) for i in range(pool)]
        t1 = time.perf_counter()
        soft = SoftConfig(tau=float(m["tau"]), temperature=float(m["temperature"]), eps=float(m["eps"]))
        self.model = SoftSDFModel(int(m["spread"]), soft, device=run.device)
        self.opt = create_train_state(self.model, lr=float(o["lr"]))
        group = self.opt.param_groups[0]
        stated = (float(o["lr"]), (float(o["b1"]), float(o["b2"])), float(o["eps"]))
        if (group["lr"], tuple(group["betas"]), group["eps"]) != stated:
            raise ValueError(f"the optimizer runs lr {group['lr']}, betas {group['betas']}, eps {group['eps']}; "
                             f"the configuration states {stated}")
        self.train = make_train_step(self.model, self.opt)
        t2 = time.perf_counter()
        params = dict(self.model.named_parameters())
        start = {k: params[k].detach().clone() for k in LEAVES}
        self.begin_window()
        losses, first, times = [], None, [t1 - t0, t2 - t1]
        for _ in range(FOLLOWED):
            t1 = time.perf_counter()
            losses.append(self.step())
            times.append(time.perf_counter() - t1)
            if first is None:
                b1 = self.opt.param_groups[0]["betas"][0]
                moments = {k: self.opt.state.get(params[k], {}).get("exp_avg") for k in LEAVES}
                first = {k: 0.0 if m is None else _norm(m / (1 - b1)) for k, m in moments.items()}
        self.got = {"loss": [float(l) for l in losses], "grad": first,
                    "change": {k: _norm(params[k] - start[k]) for k in LEAVES}}
        self.run.log(f"program's first steps: {self.got}")
        self.run.log("set-up seconds: inputs {:.3f}, model and optimizer {:.3f}, steps {:.3f} {:.3f} {:.3f}"
                     .format(*times))

    def begin_window(self) -> None:
        self.units = 0
        self.next = getattr(self, "next", 0)

    def step(self):
        x, target = self.pool[self.next % len(self.pool)]
        self.next += 1
        self.units += 1
        return self.train(x, target)

    def drain(self) -> None:
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def end_to_end(self, window_s: float) -> dict:
        self.run.log(f"steps in the window: {self.units}")
        return {"soft_step_ms": window_s * 1e3 / self.units}

    def release(self) -> None:
        del self.pool, self.model, self.opt, self.train
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, dtype=torch.float64, half: bool = False) -> dict:
        batches = [self._batch(i) for i in range(FOLLOWED)]
        keep = self.batch // 2 if half else self.batch
        return self.run.reference.train([x[:keep] for x, _ in batches], [t[:keep] for _, t in batches],
                                        self.run.config, dtype=dtype)

    def _checks(self, got: dict) -> list:
        want = self._reference()
        self.run.log(f"reference's first steps: {want}")
        return [Check(k, v, self.run.limit(k)) for k, v in gaps(got, want).items()]

    def check(self) -> list:
        return self._checks(self.got)

    def readings(self, kind: str) -> list:
        """The numbers compared with ``kind`` in the program's place:
        "control", the reference in bfloat16; "half_batch", the reference
        on the first half of each batch, the mean over it alone; "unchanged",
        steps that leave the parameters as they were."""
        if kind == "control":
            got = self._reference(torch.bfloat16)
        elif kind == "half_batch":
            got = self._reference(half=True)
        elif kind == "unchanged":
            got = dict(self._reference(), change={k: 0.0 for k in LEAVES})
        else:
            raise ValueError(f"unknown reading {kind!r}")
        if any(not math.isfinite(v) for v in got["loss"]):
            self.run.log(f"{kind}: a loss is not finite")
        return self._checks(got)


def make(run):
    return SoftTrain(run)
