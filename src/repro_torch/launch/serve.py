"""Batched serving: a continuous-batching decode loop.

The counterpart of ``repro.launch.serve``.  A fixed pool of sequence
slots; finished sequences release their slot and queued requests claim
it (their prompt is fed into the slot's cache region token by token).
Per-slot lengths drive the masked decode attention, so heterogeneous
sequence lengths coexist in one batch.  For the ``ssm`` and ``hybrid``
families the cache also holds each slot's conv and SSM states; as in the
JAX package, a reused slot keeps the previous request's states (only its
length is reset) and idle slots advance on token 0.  Each decode step
is an eager call of ``Model.decode_step``.  On one rank the launcher
serves with no sharding policy.  Under ``torchrun`` with more than one
rank it starts the process world (NCCL on CUDA, gloo on the CPU) and
serves under a host mesh over those ranks (heads on ``"model"``) and a
``ShardingPolicy`` with unsharded decode caches, as the JAX package's
launcher does; every rank runs the same scheduler on the same requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --preset smoke --slots 4 --requests 8 --max-new 16 [--device cpu]

``--arch`` takes any config that reads tokens: dense, ``moe``
(granite-moe-1b-a400m, llama4-scout-17b-a16e), ``ssm`` (mamba2-2.7b) and
``hybrid`` (zamba2-2.7b).  A MoE model routes each decode row as a group
of one token, as the JAX package's server does.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import telemetry as tele
from repro_torch.models.model import LMParams, Model


class Request:
    def __init__(self, rid: int, prompt: np.ndarray, max_new: int,
                 deadline_s: Optional[float] = None):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.deadline_s = deadline_s
        self.submitted_at: Optional[float] = None
        self.span_ts_us: Optional[float] = None   # tracer-epoch submit time
        self.output: List[int] = []
        self.pending_token: Optional[int] = None  # the prompt's last token
        self.done = False
        self.rejected = False          # shed at admission (queue full)
        self.expired = False           # deadline passed before completion

    def past_deadline(self, now: float) -> bool:
        return (self.deadline_s is not None
                and self.submitted_at is not None
                and now - self.submitted_at > self.deadline_s)


class Server:
    """Slot-based continuous batching engine.

    Admission is bounded: at most ``max_queue`` requests wait for a
    slot; past that, ``submit`` sheds the request (returns ``False``,
    marks it ``rejected``).  A request carrying ``deadline_s`` is
    dropped, queued or mid-decode, once its deadline passes
    (``expired``), freeing its slot.

    A deployment running guarded executors next to the engine reports
    each inference's outcome through :meth:`record_guard_report`; the
    per-outcome counters surface in :meth:`stats` next to the admission
    counters."""

    #: every guarded-execution outcome the stats payload reports.
    GUARD_OUTCOMES = ("clean", "checkpoint_replayed", "reexecuted",
                      "fell_back", "unrecovered", "masked")

    def __init__(self, model: Model, params: LMParams, slots: int,
                 cache_len: int, max_queue: int = 64,
                 registry: Optional[tele.MetricsRegistry] = None,
                 tracer: Optional[tele.Tracer] = None):
        self.model = model
        self.params = params
        self.slots = slots
        self.cache_len = cache_len
        self.max_queue = max_queue
        self.cache = model.init_cache(slots, cache_len)
        self.lengths = np.zeros((slots,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self.rejected = 0
        self.expired = 0
        self.guard_outcomes: Dict[str, int] = {
            k: 0 for k in self.GUARD_OUTCOMES}
        # telemetry: per-request spans, a queue-depth gauge and an
        # end-to-end latency histogram; p50/p95/p99 and tokens/s in
        # stats() derive from these
        self._registry = registry if registry is not None \
            else tele.get_registry()
        self._tracer = tracer if tracer is not None else tele.get_tracer()
        self._latency = self._registry.histogram("serve.request_latency_s")
        self._tokens = self._registry.counter("serve.tokens")
        self._queue_depth = self._registry.gauge("serve.queue_depth")
        self._active_slots = self._registry.gauge("serve.active_slots")
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    def _finish(self, req: Request, outcome: str) -> None:
        """Single completion point: every admitted request leaves through
        here exactly once (completed or expired)."""
        req.done = True
        now = time.monotonic()
        self._t_last = now
        if req.submitted_at is not None:
            latency = now - req.submitted_at
            self._latency.record(latency)
            if req.span_ts_us is not None:
                self._tracer.add_span(
                    f"serve.request:{req.rid}", req.span_ts_us,
                    latency * 1e6, cat="serve",
                    args={"rid": req.rid, "outcome": outcome,
                          "tokens": len(req.output)})

    def record_guard_report(self, report) -> str:
        """Count one guarded inference's outcome (a report with an
        ``outcome`` or a bare outcome string); returns the outcome key."""
        outcome = getattr(report, "outcome", report)
        if outcome not in self.guard_outcomes:
            raise ValueError(f"unknown guard outcome {outcome!r} "
                             f"(expected one of {self.GUARD_OUTCOMES})")
        self.guard_outcomes[outcome] += 1
        return outcome

    def stats(self) -> Dict[str, Any]:
        """Admission counters, occupancy, the guarded-execution outcome
        counters, and the latency percentiles and throughput."""
        h = self._latency
        span = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        return {
            "rejected": self.rejected,
            "expired": self.expired,
            "queued": len(self.queue),
            "active": sum(r is not None for r in self.slot_req),
            "guard": dict(self.guard_outcomes),
            "latency_s": {"count": h.count, "mean": h.mean,
                          "p50": h.percentile(50),
                          "p95": h.percentile(95),
                          "p99": h.percentile(99)},
            "tokens": self._tokens.value,
            "tokens_per_s": (self._tokens.value / span if span > 0
                             else None),
        }

    def submit(self, req: Request) -> bool:
        if len(self.queue) >= self.max_queue:
            req.rejected = True
            req.done = True
            self.rejected += 1
            self._registry.counter("serve.rejected").inc()
            return False
        req.submitted_at = time.monotonic()
        if self._t_first is None:
            self._t_first = req.submitted_at
        req.span_ts_us = self._tracer.now_us()
        self.queue.append(req)
        self._queue_depth.set(len(self.queue))
        return True

    def _admit(self) -> None:
        now = time.monotonic()
        live = []
        for req in self.queue:
            if req.past_deadline(now):
                req.expired = True
                self.expired += 1
                self._registry.counter("serve.expired").inc()
                self._finish(req, "expired")
            else:
                live.append(req)
        self.queue = live
        self._queue_depth.set(len(self.queue))
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[s] = req
                # feed the prompt into this slot token by token through
                # decode steps (Model.prefill is the bulk path)
                self.lengths[s] = 0
                for tok in req.prompt[:-1]:
                    self._step_slot(s, int(tok))
                req.pending_token = int(req.prompt[-1])

    def _decode(self, tokens: np.ndarray) -> torch.Tensor:
        """One decode step of every slot; returns the logits (slots, 1, V)."""
        dev = self.model.device
        logits, self.cache = self.model.decode_step(
            self.params, {"tokens": torch.as_tensor(tokens, device=dev),
                          "lengths": torch.as_tensor(self.lengths,
                                                     device=dev)},
            self.cache)
        if self.model.policy is not None:
            logits = logits.full_tensor()
        return logits

    def _step_slot(self, s: int, token: int) -> int:
        """Advance a single slot by one token (batched with idle slots)."""
        tokens = np.zeros((self.slots, 1), np.int32)
        tokens[s, 0] = token
        logits = self._decode(tokens)
        self.lengths[s] += 1
        return int(logits[s, -1].argmax())

    def step(self) -> None:
        """One decode step across all active slots (true batching)."""
        self._admit()
        now = time.monotonic()
        for s, req in enumerate(self.slot_req):
            if req is not None and req.past_deadline(now):
                req.expired = True
                self.slot_req[s] = None
                self.lengths[s] = 0
                self.expired += 1
                self._registry.counter("serve.expired").inc()
                self._finish(req, "expired")
        self._active_slots.set(sum(r is not None for r in self.slot_req))
        tokens = np.zeros((self.slots, 1), np.int32)
        active = []
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            tokens[s, 0] = (req.pending_token if req.output == []
                            else req.output[-1])
            active.append(s)
        if not active:
            return
        nxt = self._decode(tokens)[:, -1].argmax(-1).cpu().numpy()
        for s in active:
            req = self.slot_req[s]
            self.lengths[s] += 1
            req.output.append(int(nxt[s]))
            self._tokens.inc()
            if (len(req.output) >= req.max_new
                    or self.lengths[s] >= self.cache_len - 1):
                self.slot_req[s] = None
                self.lengths[s] = 0
                self._registry.counter("serve.completed").inc()
                self._finish(req, "completed")

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission bound: submissions past this many "
                         "queued requests are shed")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline; late requests are "
                         "dropped instead of completing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke(args.arch) if args.preset == "smoke"
           else configs.get(args.arch))
    from repro_torch import device as tdevice
    tdevice.resolve(args.device)
    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    if ranks == 1:
        # the JAX launcher's host mesh on one device is 1 x 1, where its
        # policy shards nothing: no policy gives the same outputs without
        # DTensor's dispatch on every op
        return _serve(args, cfg, Model(cfg, device=args.device))
    if args.deadline_s is not None:
        raise ValueError("--deadline-s runs on one rank: each rank's "
                         "clock would expire other requests")
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.sharding import PolicyOptions, ShardingPolicy
    dev = tdevice.resolve(args.device)
    with mesh_mod.world("nccl" if dev.type == "cuda" else "gloo"):
        mesh = mesh_mod.make_host_mesh(1, ranks)
        policy = ShardingPolicy(mesh, cfg,
                                PolicyOptions(seq_shard_decode=False))
        model = Model(cfg, device=args.device, policy=policy)
        with mesh_mod.set_mesh(mesh):
            return _serve(args, cfg, model,
                          verbose=torch.distributed.get_rank() == 0)


def _serve(args, cfg, model: Model, verbose: bool = True) -> int:
    say = print if verbose else (lambda *a: None)
    rng = np.random.default_rng(args.seed)
    params = model.init(torch.Generator(model.device).manual_seed(args.seed))
    server = Server(model, params, args.slots, args.cache_len,
                    max_queue=args.max_queue)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, args.prompt_len),
                    args.max_new, deadline_s=args.deadline_s)
            for i in range(args.requests)]
    for r in reqs:
        server.submit(r)
    t0 = time.perf_counter()
    steps = 0
    while server.busy:
        server.step()
        steps += 1
        if steps > args.requests * (args.prompt_len + args.max_new) + 64:
            raise RuntimeError("serving loop did not converge")
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in reqs)
    say(f"served {len(reqs)} requests on {model.device}, {toks} tokens in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s, {steps} engine steps)")
    stats = server.stats()
    lat = stats["latency_s"]

    def _ms(v):
        return f"{v * 1e3:.1f}ms" if v is not None else "n/a"

    tps = stats["tokens_per_s"]
    say(f"latency: p50={_ms(lat['p50'])} p95={_ms(lat['p95'])} "
          f"p99={_ms(lat['p99'])} over {lat['count']} requests; "
          "telemetry tokens/s="
          f"{f'{tps:.1f}' if tps is not None else 'n/a'}")
    if server.rejected or server.expired:
        say(f"admission: rejected={stats['rejected']} "
              f"expired={stats['expired']}")
    if any(stats["guard"].values()):
        say("guard: " + " ".join(f"{k}={v}" for k, v
                                   in stats["guard"].items() if v))
    if not all(r.done for r in reqs):
        raise RuntimeError("a request was left unfinished")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
