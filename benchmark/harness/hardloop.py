"""The closed loop of the hard cells: one client calls the entry on the next
input of the pool and synchronises before the next call. Each call's
latency is read from the card's clock: a CUDA event recorded as the call
enters and one recorded as it returns, whose difference runs until the
call's last kernel has ended. The host time the call spends inside the
entry is kept beside it (``hard.entry_host_us``).

After the window a sample of the answers, drawn from the seed (a reservoir,
so every call of the window is as likely to be in it), is held byte for
byte against the configuration's plain reference on the same inputs, made
again from the seed."""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from benchmark.harness import traffic
from benchmark.harness.runner import Check


class HardLoop:
    """A driver of the hard cells; ``make_entry()`` builds the program's
    entry (it runs in set-up), ``single`` drops the batch axis of a
    one-image call."""

    def __init__(self, run, make_entry, single: bool = False):
        self.run = run
        self.make_entry = make_entry
        self.single = single
        mix = run.traffic
        self.batch = int(mix["images_per_call"])
        self.size = [int(v) for v in run.config["size"]]
        self.pixels_per_unit = self.batch * self.size[0] * self.size[1]
        self.keep = int(run.spec["sample"])

    def _input(self, index: int) -> torch.Tensor:
        x = traffic.make_input(self.run.traffic, self.size, self.batch, self.run.seed, index, self.run.device)
        return x[0] if self.single else x

    def setup(self) -> None:
        self.pool = [self._input(i) for i in range(int(self.run.traffic["pool"]))]
        self.entry = self.make_entry()
        self.on_card = self.run.device.type == "cuda"
        for x in self.pool[:2]:  # the first call builds the kernels' library
            self.entry(x)
            self.sync()
        if self.on_card:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self.rng = random.Random(traffic.sub_seed(self.run.seed, 2))
        self.begin_window()

    def sync(self) -> None:
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def begin_window(self) -> None:
        self.units = 0
        self.latency_ms = []
        self.spans = {"entry_host_s": []}
        self.samples = []

    def step(self) -> None:
        index = self.units % len(self.pool)
        x = self.pool[index]
        if self.on_card:
            start, end = self.events
            start.record()
            t0 = time.perf_counter()
            out = self.entry(x)
            t1 = time.perf_counter()
            end.record()
            torch.cuda.synchronize(self.run.device)
            self.latency_ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = self.entry(x)
            t1 = time.perf_counter()
            self.latency_ms.append((t1 - t0) * 1e3)
        self.spans["entry_host_s"].append(t1 - t0)
        self.units += 1
        if len(self.samples) < self.keep:
            self.samples.append((index, out))
        else:
            slot = self.rng.randrange(self.units)
            if slot < self.keep:
                self.samples[slot] = (index, out)

    def drain(self) -> None:
        self.sync()

    def end_to_end(self, window_s: float) -> dict:
        self.run.log(f"calls in the window: {self.units}, {self.pixels_per_unit} output pixels each")
        return {
            "hard_gpix_per_s": self.units * self.pixels_per_unit / window_s / 1e9,
            "hard_p95_ms": float(np.percentile(self.latency_ms, 95)),
        }

    def release(self) -> None:
        """Free the program's state; the sampled answers stay."""
        del self.pool, self.entry
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def _wrong(self, answers) -> Check:
        """wrong_bytes: the answers' bytes that differ from the reference's
        on their inputs (every byte of an answer of another shape or type)."""
        cfg = self.run.config["sdf_config"]
        wrong = 0
        for index in sorted({i for i, _ in answers}):
            want = self.run.reference.sdf_bytes(self._input(index), cfg)
            for i, got in answers:
                if i != index:
                    continue
                if got.shape != want.shape or got.dtype != want.dtype:
                    wrong += want.numel()
                else:
                    wrong += int((got.to(want.device) != want).sum())
        self.run.log(f"answers checked: {len(answers)} (pool inputs {sorted({i for i, _ in answers})})")
        return Check("wrong_bytes", wrong, self.run.limit("wrong_bytes"))

    def check(self) -> list:
        if not self.samples:  # no answer came: a call's bytes, all wrong
            return [Check("wrong_bytes", self.pixels_per_unit, self.run.limit("wrong_bytes"))]
        return [self._wrong(self.samples)]

    def readings(self, kind: str) -> list:
        """The numbers compared, with ``kind`` in the program's place, on
        every input of the pool: "control", the reference in bfloat16;
        "short_band", the reference with its column search cut to |dy| <= 1
        (a band too short for the exact transform)."""
        kw = {"control": dict(precision="bfloat16"), "short_band": dict(reach=1)}[kind]
        cfg = self.run.config["sdf_config"]
        answers = [(i, self.run.reference.sdf_bytes(self._input(i), cfg, **kw))
                   for i in range(int(self.run.traffic["pool"]))]
        return [self._wrong(answers)]
