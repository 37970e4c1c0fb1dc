"""The request drivers, one per kind of traffic file ("driver" key), each a
general reader of its file's parameters:

  closed_loop  one client, `batch`-window requests drawn from the seed over
               the `cases` storms' windows, each issued when the last is
               ready: DevicePipeline.batch then ServingModel; latency per
               request by CUDA events, issue to forecast ready on the card
  sweep        a storm's windows in order, in batches of `batch`, cyclic,
               each enqueued without waiting for the one before (at most
               `in_flight` unfinished); tiles of all batches / window time
  train        the program's train step at `batch` on windows of the
               storms other than `test_case`, shuffled per epoch from the
               seed, the cosine schedule per epoch; tiles / window time
               (the mix's "model" group, such as a scheduled-sampling
               rate, reaches the program and the reference alike)

Every driver: setup() makes the inputs from the seed, builds the program
and warms the cell's own shapes; measure(seconds) runs the window;
segment(seconds) runs on under the profiler; check() frees the program
and holds what the window produced to the reference.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from outage_bench import check, inputs
from outage_bench.reference import model as ref

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cuda = self.device.type == "cuda"
        cfg, tr = cell.config, cell.traffic
        self.model, self.data, self.tr = cfg["model"], cfg["data"], tr
        self.n, self.size, self.horizon = (self.data["n_counties"], self.data["image_size"],
                                           self.data["horizon"])
        self.b = tr["batch"]
        self.window: Dict = {}
        self.marks: List[Tuple[str, float]] = [("start", time.perf_counter())]

    def mark(self, name: str) -> None:
        """The end of a stage of set-up (reported on standard error)."""
        _sync(self.device)
        self.marks.append((name, time.perf_counter()))

    # the inputs, shared by every driver
    def make_inputs(self) -> None:
        from outage_bench import program

        self.program = program
        ref.family(self.model)  # an unknown st-GNN fails here, naming the file it lacks
        self.dates = inputs.store_dates(self.tr["store"])
        frames = inputs.make_frames(self.tr["store"], self.n, self.size, self.seed, self.device)
        self.frames = frames.cpu().numpy()  # the store as the program loads it: a host array
        del frames
        self.store = program.store(self.frames, self.dates, self.n)
        self.pipe = program.pipeline(self.store, self.data, self.model, self.device)
        self.supports = inputs.static_supports(inputs.support_kind(self.model), self.n)
        self.variables = inputs.make_variables(self.model, self.n, self.size,
                                               self.supports.shape[0], self.seed, self.device)
        self.mark("inputs")

    def cases(self, names) -> Dict:
        storms = inputs.storm_dates(self.tr["store"])
        return {k: storms[k] for k in names}

    def ref_batch(self, positions: np.ndarray, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        pos = inputs.window_positions(positions, idx, self.horizon)
        rb = inputs.reference_batch(torch.from_numpy(self.frames), self.dates, pos, self.horizon,
                                    self.data["mean"], self.data["std"],
                                    getattr(torch, self.model["compute_dtype"]))
        return {k: v.to(self.device) for k, v in rb.items()}

    def segment(self, seconds: float):
        """The cell's own loop for `seconds` more, under the profiler."""
        from outage_bench import trace

        return trace.record(lambda: self.run(seconds), self.device)

    def free_program(self) -> None:
        for name in ("engine", "pipe", "store", "module", "state", "step"):
            if hasattr(self, name):
                delattr(self, name)
        if self.cuda:
            torch.cuda.empty_cache()


class Forecasts(Driver):
    """What closed_loop and sweep share: the engine, the sample of served
    forecasts kept for the check (a reservoir drawn from the seed), and the
    check itself."""

    def setup(self) -> None:
        self.make_inputs()
        cases = self.cases(self.tr["cases"])
        self.ds = self.program.dataset(self.store, cases, self.data["dataset_range"], self.horizon)
        self.positions = inputs.case_positions(self.dates, cases, self.data["dataset_range"])
        self.n_windows = len(self.positions) - 2 * self.horizon
        if len(self.ds) != self.n_windows:
            raise RuntimeError(f"the program has {len(self.ds)} windows, the benchmark "
                               f"{self.n_windows}")
        self.engine = self.program.engine(self.model, self.variables, self.supports,
                                          self.horizon, self.device)
        self.mark("engine")
        self.rng = np.random.default_rng(inputs.sub_seed(self.seed, 4))
        self.pick = np.random.default_rng(inputs.sub_seed(self.seed, 5))
        self.sample: List[Tuple[np.ndarray, torch.Tensor]] = []
        self.served = 0
        self.host_s: List[float] = []
        for _ in range(self.tr["warmup"]):
            self.serve(self.next_idx(), keep=False)
        self.mark("warm-up")

    def serve(self, idx: np.ndarray, keep: bool = True) -> torch.Tensor:
        """One request: the program's window gather, then its engine (the
        host's time inside the engine call kept as a span)."""
        batch = self.pipe.batch(self.ds, idx)
        t0 = time.perf_counter()
        y = self.engine(batch["x"], batch["date_feats"])
        self.host_s.append(time.perf_counter() - t0)
        if keep:
            self.keep(idx, y)
        return y

    def keep(self, idx: np.ndarray, y: torch.Tensor) -> None:
        k = self.tr["check_sample"]
        if len(self.sample) < k:
            self.sample.append((idx, y))
        else:
            j = int(self.pick.integers(0, self.served + 1))
            if j < k:
                self.sample[j] = (idx, y)
        self.served += 1

    def check(self) -> Dict[str, float]:
        yr = self.reference()
        return check.forecast_gaps([y for _, y in self.sample], yr, self.reference(ref.bf16))

    def reference(self, quant=ref.ident) -> List[torch.Tensor]:
        """The reference's forecasts of the sampled requests (the program
        freed first)."""
        _sync(self.device)
        self.free_program()
        sup = torch.from_numpy(self.supports).to(self.device)
        with ref.tf32_off():
            return [check.reference_forecast(self.variables, self.model,
                                             self.ref_batch(self.positions, idx), sup, quant)
                    for idx, _ in self.sample]


class ClosedLoop(Forecasts):
    def next_idx(self) -> np.ndarray:
        return self.rng.integers(0, self.n_windows, size=self.b)

    def run(self, seconds: float, lat: Optional[List[float]] = None) -> int:
        done = 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if self.cuda else None
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            idx = self.next_idx()
            if self.cuda:
                ev[0].record()
                self.serve(idx)
                ev[1].record()
                ev[1].synchronize()
                ms = ev[0].elapsed_time(ev[1])
            else:
                t = time.perf_counter()
                self.serve(idx)
                ms = 1e3 * (time.perf_counter() - t)
            if lat is not None:
                lat.append(ms)
            done += 1
        return done

    def measure(self, seconds: float) -> Dict[str, float]:
        lat: List[float] = []
        self.host_s.clear()
        t0 = time.perf_counter()
        done = self.run(seconds, lat)
        self.window = {"units": done, "seconds": time.perf_counter() - t0, "latency_ms": lat,
                       "host_ms": [1e3 * s for s in self.host_s]}
        return {name: float(np.percentile(lat, q)) for name, q in self.tr["latency_metrics"].items()}


class Sweep(Forecasts):
    def setup(self) -> None:
        self.k = 0
        super().setup()
        self.k = int(self.rng.integers(0, self.n_windows))

    def next_idx(self) -> np.ndarray:
        idx = (self.k + np.arange(self.b)) % self.n_windows
        self.k += self.b
        return idx

    def run(self, seconds: float) -> int:
        pending: deque = deque()
        done = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.serve(self.next_idx())
            done += 1
            if self.cuda:
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
                if len(pending) >= self.tr["in_flight"]:
                    pending.popleft().synchronize()
        _sync(self.device)
        return done

    def measure(self, seconds: float) -> Dict[str, float]:
        self.host_s.clear()
        t0 = time.perf_counter()
        done = self.run(seconds)
        sec = time.perf_counter() - t0
        self.window = {"units": done, "seconds": sec, "host_ms": [1e3 * s for s in self.host_s]}
        return {self.tr["rate_metric"]: done * self.b * self.n * self.horizon / sec}


class Train(Driver):
    """The train step as the program's fit drives it, one object from
    set-up to window: its first `check_steps` steps run in set-up (they
    also warm the cell's shapes) and are what the reference follows."""

    def setup(self) -> None:
        self.make_inputs()
        storms = inputs.storm_dates(self.tr["store"])
        cases = {k: v for k, v in storms.items() if k != self.tr["test_case"]}
        self.ds = self.program.dataset(self.store, cases, self.data["dataset_range"], self.horizon)
        self.positions = inputs.case_positions(self.dates, cases, self.data["dataset_range"])
        n_all = len(self.positions) - 2 * self.horizon
        if len(self.ds) != n_all:
            raise RuntimeError(f"the program has {len(self.ds)} windows, the benchmark {n_all}")
        n_val = int(n_all * self.data["val_fraction"])
        perm = np.random.default_rng(inputs.sub_seed(self.seed, 6)).permutation(n_all)
        self.train_idx = np.sort(perm[n_val:])
        self.drop_seed = inputs.sub_seed(self.seed, 7) % 2**31
        self.epoch, self.batches = -1, iter(())
        self.module, self.state, self.step = self.program.trainer(
            self.model, self.variables, self.horizon, self.n, self.size, self.device)
        self.sup = torch.from_numpy(self.supports).to(self.device)
        self.mark("model")
        params = self.program.named_parameters(self.state)
        p0 = {k: v.detach().clone() for k, v in params.items()}
        self.first: List[np.ndarray] = []
        losses, grads = [], []
        mu_prev: Dict[str, torch.Tensor] = {}
        self.input_ev: List[Tuple] = []
        for s in range(self.tr["check_steps"]):
            idx = self.next_idx()
            self.first.append(idx)
            losses.append(self.train_step(idx)["loss"])
            mu = self.program.adam_moments(self.state)
            if s == 0:
                grad1 = {k: mu[k].detach() / (1 - check.B1) for k in mu}
            # each step's gradient from the first moment, mu_s = b1 mu_(s-1) + (1 - b1) g_s,
            # kept on the host
            grads.append({k: ((mu[k].detach() - check.B1 * mu_prev[k]) / (1 - check.B1)
                              if k in mu_prev else mu[k].detach() / (1 - check.B1)).cpu()
                          for k in mu})
            mu_prev = {k: v.detach().clone() for k, v in mu.items()}
        del mu_prev
        self.mark("first steps")
        self.prog = {"loss": [float(v) for v in losses],
                     "grad1": {k: v.clone() for k, v in grad1.items()}, "grads": grads,
                     "change": {k: params[k].detach() - p0[k] for k in params}}
        self.input_ev.clear()

    def next_idx(self) -> np.ndarray:
        idx = next(self.batches, None)
        if idx is None:
            self.epoch += 1
            order = np.random.default_rng(inputs.sub_seed(self.seed, 100 + self.epoch)).permutation(
                len(self.train_idx))
            full = len(order) // self.b * self.b  # whole batches: one shape
            self.batches = iter(self.train_idx[order[:full]].reshape(-1, self.b))
            idx = next(self.batches)
        return idx

    def lr(self) -> float:
        t = self.cell.config["train"]
        return t["lr"] * (1.0 + np.cos(np.pi * self.epoch / t["cosine_t_max"])) / 2.0

    def train_step(self, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        if self.cuda:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        batch = self.pipe.batch(self.ds, idx)
        if self.cuda:
            ev[1].record()
            self.input_ev.append(ev)
        return self.step(self.state, batch, self.sup, self.lr(), self.drop_seed)

    def run(self, seconds: float) -> int:
        done = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.train_step(self.next_idx())
            done += 1
        _sync(self.device)
        return done

    def measure(self, seconds: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        done = self.run(seconds)
        sec = time.perf_counter() - t0
        self.window = {"units": done, "seconds": sec,
                       "input_ms": [a.elapsed_time(b) for a, b in self.input_ev]}
        return {self.tr["rate_metric"]: done * self.b * self.n * self.horizon / sec}

    def check(self) -> Dict[str, float]:
        """The gaps the cell's limits name; the bf16 yardstick's steps, and
        the untaught reference's (every coin tails), are run only where a
        limit reads against them."""
        names = self.cell.limits
        taught = "teacher_gap_ratio" in names
        refd = self.reference()
        yard = (self.reference(ref.bf16) if taught or any(k.endswith("_vs_bf16") for k in names)
                else None)
        untaught = self.reference(heads=lambda c: [False] * len(c)) if taught else None
        return check.train_gaps(self.prog, refd, yard, untaught)

    def reference(self, quant=ref.ident, use_rows: Optional[int] = None, heads=None,
                  lr: Optional[float] = None) -> Dict:
        """The reference's first steps (the program freed first); lr 0 is
        the fault of a step that leaves its parameters unchanged."""
        _sync(self.device)
        self.free_program()
        lr = self.cell.config["train"]["lr"] if lr is None else lr
        batches = [self.ref_batch(self.positions, idx) for idx in self.first]
        with ref.tf32_off():
            return check.reference_train(self.variables, self.model, batches, self.sup,
                                         self.drop_seed, [lr] * len(batches),
                                         self.tr["ref_rows"], quant, use_rows, heads)


DRIVERS = {"closed_loop": ClosedLoop, "sweep": Sweep, "train": Train}
