"""Hardware-aware design-space exploration (§4.3/§4.4 of the paper).

Two fitters over a generic ``DesignSpace``:

  * ``brute_force`` (BF-DSE, §4.3.1) — exhaustively evaluates every
    feasible option, keeps the one maximizing resource utilization
    below the user thresholds (utilization ∝ throughput for the
    pipelined architecture).
  * ``rl_dse`` (RL-DSE, §4.4) — a time-limited tabular Q-learning agent.
    Actions (the paper's): 1) increase N_l, 2) increase N_i,
    3) increase both; a variable that passes its maximum wraps back to
    its minimum.  Reward shaping is Algorithm 1 verbatim: -1 when any
    quota exceeds its threshold, β·F_avg when a new best utilization is
    observed (β = 0.01 scales percent → [0, 1]), else 0.  Discount
    γ = 0.1, episodes are step-limited (time-limited RL [34]).

Both fitters share a memoised ``evaluate`` — in the real system each
evaluation is a multi-second vendor-compiler call, so the number of
*unique* evaluations is the cost that RL-DSE reduces (Table 2: 2.5 min
vs 3.5 min ≈ 25 % faster).  We report wall time and unique-eval counts.

The port's own copy of ``repro.core.dse``, line for line: the same seed
walks the same trajectory (``np.random.default_rng``), so the port's
results equal the JAX package's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import telemetry as tele
from .resources import ResourceReport
from .verify import VerificationError

BETA = 0.01     # reward scale (percent -> [0, 1]), §4.4
GAMMA = 0.1     # discount factor, §4.4

#: Quota charged to a quarantined/failed candidate: far over every
#: threshold, so both fitters treat it exactly like an over-quota
#: compile (BF skips it, RL rewards -1) instead of dying on it.
FAILED_PCT = 1e9

Thresholds = Dict[str, float]
DEFAULT_THRESHOLDS: Thresholds = {"lut": 100.0, "dsp": 100.0,
                                  "mem": 100.0, "reg": 100.0}


class DesignSpace:
    """An enumerable option space + a compiler-feedback oracle.

    Concrete space: ``repro_torch.core.spaces.CNNDesignSpace`` ((N_i,
    N_l) pairs under the divisibility constraints of §4.2, optionally
    with the row-band and checkpoint axes).
    """

    def options(self) -> List[Tuple]:
        raise NotImplementedError

    def evaluate(self, option: Tuple) -> ResourceReport:
        raise NotImplementedError

    # Axes for the RL agent's increase/wrap actions: list of sorted
    # per-dimension value lists; an option is a tuple indexed alike.
    def axes(self) -> List[List]:
        raise NotImplementedError

    def axis_names(self) -> List[str]:
        """Human-readable names for the option tuple's positions
        (reports, CLI output)."""
        return [f"axis{i}" for i in range(len(self.axes()))]

    def tiebreak(self, option: Tuple) -> float:
        """Secondary score among options with equal F_avg.  The CNN space
        prefers *balanced* (N_i, N_l): the memory-read kernel's delivery
        rate scales with N_i while lane consumption scales with N_l, so
        among equal-resource options the balanced pair minimises pipe
        stalls (this is why the paper's 5CSEMA5 result is (8, 8) rather
        than an equal-product skewed pair)."""
        return 0.0


@dataclasses.dataclass
class DSEResult:
    best: Optional[Tuple]
    best_report: Optional[ResourceReport]
    f_max: float
    evaluations: int           # unique compiler calls
    steps: int                 # agent steps (RL) or options scanned (BF)
    wall_time_s: float
    history: List[Tuple]       # (option, f_avg, fits) per unique eval

    @property
    def found(self) -> bool:
        return self.best is not None


class _Memo:
    """Memoised oracle — models 'one vendor-compiler call per option'."""

    def __init__(self, space: DesignSpace, eval_cost_s: float = 0.0):
        self.space = space
        self.cache: Dict[Tuple, ResourceReport] = {}
        self.eval_cost_s = eval_cost_s
        self.simulated_time = 0.0

    def __call__(self, option: Tuple) -> ResourceReport:
        if option not in self.cache:
            self.cache[option] = self.space.evaluate(option)
            self.simulated_time += self.eval_cost_s
        return self.cache[option]


class EvalTimeout(RuntimeError):
    """A candidate evaluation exceeded its wall-clock budget."""


class RobustEvaluator(DesignSpace):
    """Fault-tolerant wrapper around a ``DesignSpace`` oracle.

    Real vendor-compiler calls hang, crash, and flake; a multi-hour
    sweep must survive all three and be resumable.  This wrapper adds:

      * **per-candidate timeout** — the underlying ``evaluate`` runs on
        a daemon thread and is abandoned after ``timeout_s`` (a hung
        compiler call cannot stall the sweep; the orphaned thread dies
        with the process).  Timeouts are not retried: a hang is almost
        never transient and each retry would cost another full budget.
      * **retry with exponential backoff + jitter** — a raising
        evaluation is retried up to ``retries`` times, sleeping
        ``backoff_s * 2^k * (1 + jitter)`` between attempts
        (deterministic jitter from ``seed``).
      * **quarantine** — a candidate that exhausts its retries (or
        times out) is recorded with its failure reason and charged a
        :data:`FAILED_PCT` report (``fits=False``, every quota far over
        threshold), so BF-DSE skips it and RL-DSE rewards it -1; the
        search itself never sees the exception.
      * **resumable journal** — every completed report and quarantine
        decision is appended to ``journal_path`` as one JSON line
        (schema v2: a ``{"journal": ..., "version": 2}`` header line,
        then one record per line).  A fresh evaluator pointed at the
        same journal replays those results without touching the
        underlying space — kill the sweep, rerun the command, and only
        the remaining candidates compile.  Append-per-record means a
        crash mid-write can only tear the LAST line: on load, a
        corrupt/truncated journal is detected, backed up aside
        (``<path>.corrupt``), and the sweep resumes from the valid
        prefix instead of crashing — ``stats["journal_dropped"]``
        counts the discarded lines.  Legacy v1 journals (one monolithic
        JSON object) are migrated in place on first load.

    ``stats`` counts evaluated / journal_hits / retries / errors /
    timeouts / quarantined / journal_dropped for reporting.  Every
    count is mirrored into the telemetry registry (``dse.evaluated``,
    ``dse.quarantined``, ... — DESIGN.md §12) and each underlying
    ``evaluate`` runs inside a ``dse.evaluate`` span carrying the
    option, so a ``--robust`` sweep's retry/timeout/quarantine totals
    show up in any profile snapshot without parsing the autotune
    payload.
    """

    QUOTAS = ("lut", "dsp", "mem", "reg")
    JOURNAL_VERSION = 2

    def __init__(self, space: DesignSpace,
                 timeout_s: Optional[float] = None,
                 retries: int = 2,
                 backoff_s: float = 0.05,
                 journal_path: Optional[str] = None,
                 seed: int = 0,
                 registry: Optional[tele.MetricsRegistry] = None,
                 tracer: Optional[tele.Tracer] = None):
        self.space = space
        self.timeout_s = timeout_s
        self.retries = max(0, retries)
        self.backoff_s = backoff_s
        self.journal_path = journal_path
        self._rng = np.random.default_rng(seed)
        self._registry = registry if registry is not None \
            else tele.get_registry()
        self._tracer = tracer if tracer is not None else tele.get_tracer()
        self.completed: Dict[str, dict] = {}
        self.quarantined: Dict[str, str] = {}
        self.stats = {"evaluated": 0, "journal_hits": 0, "retries": 0,
                      "errors": 0, "timeouts": 0, "quarantined": 0,
                      "verifier_rejects": 0, "journal_dropped": 0}
        if journal_path and os.path.exists(journal_path):
            self._load_journal()

    def _count(self, key: str, n: int = 1) -> None:
        """One robustness event: the local stats dict AND the registry
        counter move together, so the autotune payload and any profile
        snapshot agree."""
        self.stats[key] += n
        self._registry.counter(f"dse.{key}").inc(n)

    # ------------------------------------------------ space delegation
    def options(self) -> List[Tuple]:
        return self.space.options()

    def axes(self) -> List[List]:
        return self.space.axes()

    def axis_names(self) -> List[str]:
        return self.space.axis_names()

    def tiebreak(self, option: Tuple) -> float:
        return self.space.tiebreak(option)

    # ---------------------------------------------------------- oracle
    @staticmethod
    def _key(option: Tuple) -> str:
        return json.dumps(list(option), default=str)

    def _failed(self) -> ResourceReport:
        return ResourceReport(percents={k: FAILED_PCT for k in self.QUOTAS},
                              raw={}, fits=False)

    def _attempt(self, option: Tuple) -> ResourceReport:
        if self.timeout_s is None:
            return self.space.evaluate(option)
        box: dict = {}

        def run():
            try:
                box["report"] = self.space.evaluate(option)
            except BaseException as e:  # surfaced on the caller thread
                box["error"] = e

        t = threading.Thread(target=run, daemon=True,
                             name=f"dse-eval-{self._key(option)}")
        t.start()
        t.join(self.timeout_s)
        if t.is_alive():
            raise EvalTimeout(f"evaluation of {option} exceeded "
                              f"{self.timeout_s}s")
        if "error" in box:
            raise box["error"]
        return box["report"]

    def evaluate(self, option: Tuple) -> ResourceReport:
        key = self._key(option)
        if key in self.completed:
            self._count("journal_hits")
            rec = self.completed[key]
            return ResourceReport(percents=dict(rec["percents"]),
                                  raw=dict(rec["raw"]),
                                  fits=bool(rec["fits"]))
        if key in self.quarantined:
            self._count("journal_hits")
            return self._failed()
        last: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            if attempt:
                self._count("retries")
                jitter = 1.0 + float(self._rng.random())
                time.sleep(self.backoff_s * (2 ** (attempt - 1)) * jitter)
            try:
                with self._tracer.span("dse.evaluate", cat="dse",
                                       args={"option": key,
                                             "attempt": attempt}):
                    rep = self._attempt(option)
            except EvalTimeout as e:
                self._count("timeouts")
                last = e
                break  # hangs are not retried — see class docstring
            except VerificationError as e:
                # static DRC failure: deterministic, retrying re-proves
                # the same theorem — quarantine immediately
                self._count("verifier_rejects")
                last = e
                break
            except Exception as e:
                self._count("errors")
                last = e
                continue
            self._count("evaluated")
            rec = {"percents": rep.percents, "raw": rep.raw,
                   "fits": rep.fits}
            self.completed[key] = rec
            self._append({"kind": "completed", "key": key, "record": rec})
            return rep
        why = f"{type(last).__name__}: {last}"
        self.quarantined[key] = why
        self._count("quarantined")
        self._append({"kind": "quarantined", "key": key, "why": why})
        return self._failed()

    def quarantined_options(self) -> List[Tuple[List, str]]:
        """Quarantine list with the option decoded back from its key."""
        return [(json.loads(k), why) for k, why in self.quarantined.items()]

    # ---------------------------------------------------- journal (v2)
    def _load_journal(self) -> None:
        """Load ``journal_path``: v2 JSONL, legacy v1 monolithic JSON
        (migrated in place), or a corrupt/truncated file of either —
        detected, backed up to ``<path>.corrupt`` and resumed from the
        longest valid prefix."""
        with open(self.journal_path) as f:
            text = f.read()
        lines = text.splitlines()
        dropped = 0
        if len(lines) == 1 or (lines and not lines[0].lstrip()
                               .startswith('{"journal"')):
            # legacy v1: the whole file is one JSON object (possibly
            # pretty-printed across lines).  A truncated v1 journal
            # fails to parse and is discarded wholesale — v1 had no
            # record boundaries to salvage a prefix from.
            try:
                state = json.loads(text)
                self.completed = dict(state.get("completed", {}))
                self.quarantined = dict(state.get("quarantined", {}))
            except (json.JSONDecodeError, AttributeError):
                dropped = max(1, len(lines))
        else:
            for n, line in enumerate(lines):
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                    if rec.get("journal"):  # header line
                        continue
                    if rec["kind"] == "completed":
                        self.completed[rec["key"]] = rec["record"]
                    elif rec["kind"] == "quarantined":
                        self.quarantined[rec["key"]] = rec["why"]
                    else:
                        raise KeyError(rec["kind"])
                except (json.JSONDecodeError, KeyError, TypeError):
                    # torn tail (or mid-file corruption): keep the
                    # valid prefix, drop this line and everything after
                    # it — later lines may depend on sync we can no
                    # longer trust
                    dropped = len(lines) - n
                    break
        if dropped:
            os.replace(self.journal_path, self.journal_path + ".corrupt")
            self._count("journal_dropped", dropped)
        # persist migration/recovery so the next crash tears v2 lines,
        # not a half-migrated hybrid
        self._rewrite_journal()

    def _journal_header(self) -> str:
        return json.dumps({"journal": "dse-robust-evaluator",
                           "version": self.JOURNAL_VERSION})

    def _rewrite_journal(self) -> None:
        if not self.journal_path:
            return
        d = os.path.dirname(self.journal_path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.journal_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self._journal_header() + "\n")
            for key, rec in self.completed.items():
                f.write(json.dumps({"kind": "completed", "key": key,
                                    "record": rec}, default=str) + "\n")
            for key, why in self.quarantined.items():
                f.write(json.dumps({"kind": "quarantined", "key": key,
                                    "why": why}, default=str) + "\n")
        os.replace(tmp, self.journal_path)

    def _append(self, entry: dict) -> None:
        """One record, one line, one append: a crash can only tear the
        final line, which ``_load_journal`` recovers from."""
        if not self.journal_path:
            return
        d = os.path.dirname(self.journal_path)
        if d:
            os.makedirs(d, exist_ok=True)
        fresh = not os.path.exists(self.journal_path)
        with open(self.journal_path, "a") as f:
            if fresh:
                f.write(self._journal_header() + "\n")
            f.write(json.dumps(entry, default=str) + "\n")


def _within(report: ResourceReport, th: Thresholds) -> bool:
    return all(report.percents[k] <= th.get(k, 100.0) for k in report.percents)


def brute_force(space: DesignSpace,
                thresholds: Optional[Thresholds] = None,
                eval_cost_s: float = 0.0) -> DSEResult:
    """BF-DSE: scan every option; keep the first strict-max F_avg."""
    th = thresholds or DEFAULT_THRESHOLDS
    memo = _Memo(space, eval_cost_s)
    t0 = time.perf_counter()
    best, best_rep = None, None
    best_key = (-1.0, float("-inf"))
    history: List[Tuple] = []
    opts = space.options()
    for opt in opts:
        rep = memo(opt)
        ok = _within(rep, th)
        history.append((opt, rep.f_avg, ok))
        key = (rep.f_avg, space.tiebreak(opt))
        if ok and key > best_key:
            best_key, best, best_rep = key, opt, rep
    wall = time.perf_counter() - t0 + memo.simulated_time
    return DSEResult(best, best_rep, best_key[0], len(memo.cache), len(opts),
                     wall, history)


def rl_dse(space: DesignSpace,
           thresholds: Optional[Thresholds] = None,
           episodes: int = 12,
           steps_per_episode: int = 24,
           epsilon: float = 0.25,
           alpha: float = 0.5,
           seed: int = 0,
           patience: int = 3,
           eval_cost_s: float = 0.0) -> DSEResult:
    """RL-DSE: Q-learning over (axis-index) states with the paper's
    increase/wrap action set and Algorithm-1 reward shaping.  Episodes
    stop early once ``patience`` consecutive episodes bring no new
    H_best — this is where the paper's ~25 % wall-time saving over
    BF-DSE comes from (fewer unique vendor-compiler calls)."""
    th = thresholds or DEFAULT_THRESHOLDS
    axes = space.axes()
    dims = [len(a) for a in axes]
    n_actions = 3  # ++axis0 | ++axis1 | ++both   (paper's action set)
    if len(axes) != 2:
        # generalised: ++axis_i for each axis, plus ++all (e.g. the CNN
        # space's third block_h row-band axis, DESIGN.md §4)
        n_actions = len(axes) + 1
    q = np.zeros(dims + [n_actions], np.float64)
    rng = np.random.default_rng(seed)
    memo = _Memo(space, eval_cost_s)
    valid = set(space.options())

    t0 = time.perf_counter()
    best_key = (-1.0, float("-inf"))
    best: Optional[Tuple] = None
    best_rep: Optional[ResourceReport] = None
    history: List[Tuple] = []
    steps = 0
    stale_episodes = 0

    def step_state(state: Tuple[int, ...], action: int) -> Tuple[int, ...]:
        s = list(state)
        if action < len(axes):
            targets = [action]
        else:
            targets = list(range(len(axes)))
        for t in targets:
            s[t] += 1
            if s[t] >= dims[t]:
                s[t] = 0  # paper: reset to initial value on overflow
        return tuple(s)

    for _ep in range(episodes):
        state = tuple(0 for _ in axes)  # start from minimum values (§4.4)
        improved = False
        for _t in range(steps_per_episode):  # time-limited episode [34]
            steps += 1
            if rng.random() < epsilon:
                action = int(rng.integers(n_actions))
            else:
                action = int(np.argmax(q[state]))
            nxt = step_state(state, action)
            option = tuple(axes[i][nxt[i]] for i in range(len(axes)))
            if option in valid:
                rep = memo(option)
                ok = _within(rep, th)
                key = (rep.f_avg, space.tiebreak(option))
                # ---- Algorithm 1: reward shaping -------------------
                if ok:
                    if key > best_key:
                        best_key = key
                        reward = BETA * rep.f_avg
                        best, best_rep = option, rep
                        improved = True
                    else:
                        reward = 0.0
                else:
                    reward = -1.0
                history.append((option, rep.f_avg, ok))
            else:
                reward = -1.0  # infeasible (divisibility) — treated as over-threshold
            q[state][action] += alpha * (
                reward + GAMMA * float(np.max(q[nxt])) - q[state][action])
            state = nxt
        stale_episodes = 0 if improved else stale_episodes + 1
        if stale_episodes >= patience:
            break  # converged: no new H_best for `patience` episodes
    wall = time.perf_counter() - t0 + memo.simulated_time
    return DSEResult(best, best_rep, best_key[0], len(memo.cache), steps,
                     wall, history)
