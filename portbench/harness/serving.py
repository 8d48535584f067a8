"""Serving an LM through the port's paged engine: set-up, traffic from the
mix, the window in an open or a closed loop, and the check of the served
tokens against the plain reference.

The configuration's ``model_type`` names its architecture module
(``portbench/archs/<model_type>.py``), which gives the program's
``ArchConfig``, the weights' leaves, their program names, the plain
reference and the FLOP counts.  Set-up makes the weights on the card from
the seed (``portbench.harness.weights``), builds ``repro_torch``'s
``ServingEngine`` in paged mode over them, and warms the shapes the
traffic uses: one prompt of each length from 1 to the prefill chunk, so
every chunk graph and the step graph are captured before the window.

Sizes and arrival gaps come from the mix's ``size_seed`` in a fixed
order, the same trace for every run seed; ``--seed`` draws the token ids
and the weights.  Each token's clock stamp comes back
with its request, so ``tokens_per_s`` counts exactly the tokens emitted
inside the window; after the window no request is submitted and every one
in flight is waited for (at most ``drain_s``), so the tails are over every
request and the judged sample can hold the longest.

At the window's edges the balancer's slot occupancy and every amount the
program tallies (``repro_torch.kernels.build.TALLIES``) are read, and
their differences go into ``facts`` (``slot_share``, ``tallies``), where a
reader under ``portbench/metrics`` finds them.
"""
from __future__ import annotations

import math
import statistics
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from portbench.counts.peaks import BF16_FLOPS
from portbench.harness.bench import BenchBase
from portbench.harness.cells import load_arch
from portbench.harness.report import Check
from portbench.harness.weights import make_weights


def arch_config(c: Dict[str, Any]):
    """The program's ``ArchConfig`` for the configuration file."""
    return load_arch(c["model_type"]).arch_config(c)


def tallies() -> Dict[str, int]:
    """Every amount the program tallies, as it reads now."""
    from repro_torch.kernels import build

    counters = [build.COUNTERS.get(n) for n in list(build.TALLIES)]
    return {c.name: c.value for c in counters if c is not None}


def tally_deltas(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    """What each tally added between two readings; one that did not exist
    at the first counts from 0."""
    return {n: v - before.get(n, 0) for n, v in after.items()}


def lengths(spec: Dict[str, Any], n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` integer lengths: ``lognormal`` (median, sigma) or ``uniform``
    (low, high inclusive), clipped to [min, max]."""
    if spec["dist"] == "lognormal":
        x = rng.lognormal(math.log(spec["median"]), spec["sigma"], n)
    elif spec["dist"] == "uniform":
        x = rng.uniform(spec["min"], spec["max"] + 1, n)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.floor(x), spec["min"], spec["max"]).astype(np.int64)


class Record:
    __slots__ = ("idx", "due", "submitted", "gen", "result", "error")

    def __init__(self, idx: int, due: float, submitted: float, gen) -> None:
        self.idx, self.due, self.submitted, self.gen = idx, due, submitted, gen
        self.result = None
        self.error: Optional[BaseException] = None


class ServeBench(BenchBase):
    loop = "open"

    def __init__(self, ctx) -> None:
        super().__init__()
        import torch

        from repro_torch.runtime.serve_loop import ServingEngine

        self.ctx = ctx
        self.cfg = ctx.config
        self.mix = ctx.mix
        self.name = self.cfg["name"]
        self.model = load_arch(self.cfg["model_type"], ctx.root)
        self.arch = self.model.arch_config(self.cfg)
        eng = self.mix["engine"]
        self.chunk = int(eng["prefill_chunk"])
        self.weights = make_weights(self.cfg, ctx.seed, ctx.device, self.model)
        self.engine = ServingEngine(
            {self.name: self.arch}, mode="paged", n_slots=int(eng["slots"]),
            cache_len=int(eng["cache_len"]), block_size=int(eng["block_size"]),
            prefill_chunk=self.chunk, seed=int(ctx.seed) & 0x7FFFFFFF, device=ctx.device,
            params={self.name: self.model.program_tree(self.weights)},
        )
        self.pool = next(s for s in self.engine.lb.servers if s.name.startswith("paged:"))
        self.calls: Optional[list] = None
        self.timed = bool(ctx.trace and ctx.device == "cuda")
        if self.timed:
            self._time_calls()
        self._make_traffic()
        warm = np.random.default_rng(0)
        gens = [self.engine.submit(self.name, warm.integers(0, self.arch.vocab, size=(1, r)), 2)
                for r in range(1, self.chunk + 1)]
        for g in gens:
            g.result(timeout=600)
        if ctx.device == "cuda":
            torch.cuda.synchronize()

    def _time_calls(self) -> None:
        """Stamp every call of the pool into the model on the card (traced
        runs): a CUDA event before and after each decode step, prefill chunk
        and slot reset that starts inside the window, on the pool's own
        stream.  The pool's thread issues
        all of the engine's device work on that one stream, so these spans
        are the device's busy time (see :class:`EventTrace`)."""
        import torch

        def timed(fn, kind):
            def call(*a):
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a)
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                if self.calls is not None and time.monotonic() < self.t1:
                    self.calls.append((kind, start, end))
                return out
            return call

        self.pool.step_fn = timed(self.pool.step_fn, "decode step")
        self.pool.chunk_fn = timed(self.pool.chunk_fn, "prefill chunk")
        self.pool.reset_fn = timed(self.pool.reset_fn, "slot reset")

    # -- traffic -----------------------------------------------------------------
    def _make_traffic(self) -> None:
        """The request trace: sizes (and, in the open loop, the gaps between
        arrivals) from the mix's ``size_seed`` in a fixed order, the same for
        every run seed; the seed draws the prompts' token ids.  A permutation
        a seed moved which requests fall inside the window, and with it every
        end-to-end metric, by 10-20% from seed to seed (measured on an H100)."""
        mix, seconds = self.mix, float(self.ctx.seconds)
        sizes = np.random.default_rng(int(mix["size_seed"]))
        n = int(mix["n_requests"]) if "n_requests" in mix else max(
            1, int(round(float(mix["rate_rps"]) * seconds)))
        self.prompt_lens = lengths(mix["prompt"], n, sizes)
        self.output_lens = lengths(mix["output"], n, sizes)
        if self.loop == "open":
            gaps = sizes.exponential(1.0 / float(mix["rate_rps"]), n)
            gaps *= seconds * (n - 0.5) / n / gaps.sum()
            self.arrivals = np.cumsum(gaps)
        rng = np.random.default_rng(self.ctx.seed)
        self.tokens = [rng.integers(0, self.arch.vocab, size=int(p)) for p in self.prompt_lens]
        self.n_traffic = n

    def _submit(self, i: int) -> Any:
        return self.engine.submit(self.name, self.tokens[i].reshape(1, -1), int(self.output_lens[i]))

    # -- window -------------------------------------------------------------------
    def window(self) -> None:
        before = self._occupancy()
        tallies_before = tallies()
        if self.timed:
            self.calls = []
        self.t0 = time.monotonic()
        self.t1 = self.t0 + float(self.ctx.seconds)
        self.records: List[Record] = []
        if self.loop == "open":
            self._open_loop()
        else:
            self._closed_loop()
        self.window_s = self.t1 - self.t0
        self.occupancy = (before, self._occupancy())
        self.tallies = tally_deltas(tallies_before, tallies())
        self._drain()
        self._facts()

    def _open_loop(self) -> None:
        for i in range(self.n_traffic):
            due = self.t0 + float(self.arrivals[i])
            wait = due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            sub = time.monotonic()
            self.records.append(Record(i, due, sub, self._submit(i)))
        wait = self.t1 - time.monotonic()
        if wait > 0:
            time.sleep(wait)

    def _closed_loop(self) -> None:
        lock = threading.Lock()
        nxt = [0]

        def client() -> None:
            while True:
                with lock:
                    now = time.monotonic()
                    if now >= self.t1:
                        return
                    i = nxt[0] % self.n_traffic
                    nxt[0] += 1
                    rec = Record(i, now, now, self._submit(i))
                    self.records.append(rec)
                self._wait(rec, self.t1 + float(self.mix.get("drain_s", 60.0)))

        threads = [threading.Thread(target=client, name=f"portbench-client-{k}")
                   for k in range(int(self.mix["clients"]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    @staticmethod
    def _wait(rec: Record, until: float) -> None:
        try:
            rec.result = rec.gen.result(timeout=max(until - time.monotonic(), 0.0))
        except BaseException as e:  # noqa: BLE001 - a failed or late request
            rec.error = e

    def _drain(self) -> None:
        until = self.t1 + float(self.mix.get("drain_s", 60.0))
        for rec in self.records:
            if rec.result is None and rec.error is None:
                self._wait(rec, until)

    def _occupancy(self) -> Dict[str, float]:
        occ = self.engine.summary()["slot_occupancy"].get(self.pool.name)
        if not occ:
            return {"slot_steps": 0.0, "steps": 0.0, "capacity": 0.0}
        return {"slot_steps": occ["mean"] * occ["steps"] * occ["capacity"],
                "steps": float(occ["steps"]), "capacity": float(occ["capacity"])}

    # -- what the window gives -------------------------------------------------------
    def _facts(self) -> None:
        done = [r for r in self.records if r.result is not None]
        self.attempted = len(self.records)
        self.failed = len(self.records) - len(done)
        t0, t1 = self.t0, self.t1
        n_tok = 0
        flops = 0
        for r in done:
            times = r.result.token_times
            p = int(self.prompt_lens[r.idx])
            n_tok += sum(1 for t in times if t0 <= t < t1)
            if times and t0 <= times[0] < t1:
                flops += self.model.prompt_flops(self.cfg, p)
            for j, t in enumerate(times[1:], start=1):
                if t0 <= t < t1:
                    flops += self.model.decode_token_flops(self.cfg, p + j - 1)
        ttft = [r.result.token_times[0] - r.due for r in done]
        tpot = [(r.result.token_times[-1] - r.result.token_times[0]) / (len(r.result.tokens) - 1)
                for r in done if len(r.result.tokens) > 1]
        late = [r.submitted - r.due for r in self.records]
        b, a = self.occupancy
        steps = a["steps"] - b["steps"]
        self.facts = {
            "window_s": self.window_s,
            "tokens_in_window": n_tok,
            "flops_in_window": flops,
            "peak_flops": BF16_FLOPS,
            "slot_share": (a["slot_steps"] - b["slot_steps"]) / (steps * a["capacity"])
            if steps > 0 and a["capacity"] else None,
            "tallies": self.tallies,
        }
        self.trace = None
        if self.timed:
            import torch

            torch.cuda.synchronize()
            self.trace = EventTrace(self.calls, self.window_s)
            self.facts["decode_step_ms"] = self.trace.median_ms("decode step")
        self.values = {
            "tokens_per_s": n_tok / self.window_s,
            "ttft_p95_ms": _p95(ttft) * 1e3 if ttft else None,
            "tpot_p95_ms": _p95(tpot) * 1e3 if tpot else None,
        }
        self.summary = {
            "requests": len(self.records), "finished": len(done),
            "finished_in_window": sum(1 for r in done if r.result.token_times[-1] < t1),
            "generator_late_ms": {"p50": _q(late, 0.5) * 1e3, "p99": _q(late, 0.99) * 1e3,
                                  "max": max(late) * 1e3} if late else None,
            "ttft_p50_ms": _q(ttft, 0.5) * 1e3 if ttft else None,
            "tpot_p50_ms": _q(tpot, 0.5) * 1e3 if tpot else None,
        }
        self.ctx.log(f"window: {self.summary}")

    def end_to_end(self) -> Dict[str, float]:
        return self.values

    def extra(self) -> Dict[str, Any]:
        return {"serving": self.summary}

    def release(self) -> None:
        import torch

        self.engine.shutdown()
        self.engine = self.pool = None
        if self.ctx.device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- correctness ------------------------------------------------------------------
    def _sample(self) -> List[Record]:
        """The judged requests: the one with the longest sequence, then
        others drawn from the seed until ``check_tokens`` served tokens."""
        done = [r for r in self.records if r.result is not None]
        if not done:
            return []
        longest = max(done, key=lambda r: int(self.prompt_lens[r.idx]) + len(r.result.tokens))
        rng = np.random.default_rng(self.ctx.seed)
        picked, total = [longest], len(longest.result.tokens)
        for k in rng.permutation(len(done)):
            if total >= int(self.mix["check_tokens"]):
                break
            r = done[int(k)]
            if r is longest:
                continue
            picked.append(r)
            total += len(r.result.tokens)
        return picked

    def readings(self, control: bool = False) -> Dict[str, float]:
        """The mean gap of a served token's reference logit below the
        reference's best over every judged token (or, with ``control``, of
        the token that the fp8 reference puts first at the same positions).
        The widest gap does not separate the two: the bf16 program's
        widest read up to 0.23, the fp8 control's least 0.27-0.40."""
        import torch

        from portbench.reference.lm import control_gaps, served_gaps

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = self.model.Reference(self.weights, self.cfg, dtype=torch.float32)
        ctl = self.model.Reference(self.weights, self.cfg, dtype=torch.float32,
                                   quant="fp8") if control else None
        gaps = []
        n_tokens = 0
        for r in self._sample():
            p = int(self.prompt_lens[r.idx])
            served = torch.as_tensor(np.asarray(r.result.tokens, dtype=np.int64),
                                     device=self.ctx.device)
            seq = torch.cat([torch.as_tensor(self.tokens[r.idx], device=self.ctx.device),
                             served[:-1]])
            logits = ref.logits(seq)
            if ctl is None:
                gaps.append(served_gaps(logits, p, served))
            else:
                gaps.append(control_gaps(logits, ctl.logits(seq), p, len(served)))
            n_tokens += len(served)
            del logits
        self.ctx.log(f"judged {n_tokens} served tokens")
        if not gaps:
            return {"mean_token_gap": float("nan")}
        mean = torch.cat(gaps).mean()
        return {"mean_token_gap": float(mean) if torch.isfinite(mean) else float("inf")}

    def verify(self) -> List[Check]:
        limits = self.mix["limits"]
        return [Check(k, v, float(limits[k])) for k, v in self.readings().items()]


def _q(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _p95(xs) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive method)."""
    if len(xs) < 2:
        return float(xs[0])
    return statistics.quantiles(xs, n=20)[-1]


class EventTrace:
    """The serving pool's device activity over the window from CUDA events:
    the same reading a profiler trace gives the harness (busy seconds, the
    largest operations, the longest idle gaps), without the profiler, which
    hung 4 of 13 traced serving runs on the card (in its start or stop while
    the pool replayed graphs; 0 of 9 MLDA runs).  Each call's span runs from
    its first enqueued operation to the end of its last (a replay and its
    copies); calls come one after another on one stream."""

    def __init__(self, calls, window_s: float) -> None:
        self.window_s = float(window_s)
        self.device = []
        if not calls:
            return
        first = calls[0][1]
        self.device = [(kind, first.elapsed_time(a) * 1e-3, first.elapsed_time(b) * 1e-3)
                       for kind, a, b in calls]

    def busy_s(self) -> float:
        return sum(b - a for _, a, b in self.device)

    def median_ms(self, kind: str) -> Optional[float]:
        spans = [(b - a) * 1e3 for k, a, b in self.device if k == kind]
        return statistics.median(spans) if spans else None

    def top_ops(self, n: int = 10) -> List[List]:
        tot: Dict[str, float] = {}
        for kind, a, b in self.device:
            tot[kind] = tot.get(kind, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        gaps = [(self.device[i + 1][1] - self.device[i][2],
                 f"host between {self.device[i][0]} and {self.device[i + 1][0]}")
                for i in range(len(self.device) - 1)]
        return [[label, g] for g, label in sorted(gaps, reverse=True)[:n]]
