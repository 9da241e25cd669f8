"""The design spaces of the DSE fitters: ``CNNDesignSpace`` and
``ShardingSpace``.

``CNNDesignSpace`` is the paper's own (N_i, N_l) space, with the
row-band (``block_h``) and checkpoint (``ckpt_k``) axes, scored by the
calibrated FPGA estimator of :mod:`.resources`: the port's own copy of
the JAX package's, line for line.  ``ShardingSpace`` is the fitter
lifted to a pod of cards: the JAX package's options in the same order
(``DEFAULT_POD_AXES``), each scored by the port's dry run
(``launch/dryrun.py``, a trace on a fake world with the H100's
constants) where the JAX package compiles with XLA.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

from .dse import DesignSpace
from .parser import ParsedModel
from .resources import (H100, FPGAProfile, GPUProfile, ResourceReport,
                        NI_CAP, NL_CAP, checkpoint_bytes,
                        conv_band_working_set, estimate_fpga,
                        plan_checkpoints)

#: Default row-band heights offered to the DSE when the caller enables
#: the third axis but does not name candidates.
DEFAULT_BLOCK_H_OPTIONS: List[int] = [4, 8, 16, 32]


class CNNDesignSpace(DesignSpace):
    """The paper's (N_i, N_l) space for a parsed CNN on a given board,
    optionally extended with the conv kernel's ``block_h`` row-band
    height as a third axis (DESIGN.md §4).

    Options obey the §4.2 divisibility constraints (from the parsed
    model) and the framework caps (N_i <= 16 from the 128-bit DDR burst,
    N_l <= 32 from the pipe width — the paper's 'limited options'
    discussion in §5).  ``evaluate`` calls the calibrated analytical
    stand-in for the vendor compiler; in the 3-axis space it adds the
    row-band working set (``conv_band_working_set``) against the
    board's on-chip memory, so options whose band does not fit are
    rejected exactly like any over-quota option in Algorithm 1.  The
    working-set rule covers the whole DAG stage program — dense convs
    (Cin-sliced by the ``8*N_i`` contraction tile, plus the skip band
    when a residual add is fused into the epilogue), depthwise convs at
    any channel multiplier, ragged grouped convs (banded per group, so
    the group count never inflates the per-step set), residual merge
    buffers, and concats (charged once per merge tensor when standalone,
    zero when epilogue-fused: the producers' own bands already hold the
    in-place slices — resources.py) — so branchy models prune the same
    way linear ones do, and both parallelism degrees shape the scored
    band exactly as they shape the executor's kernel tiles.

    ``checkpoint_options`` adds a fourth axis ``ckpt_k``: the number of
    stage-boundary recovery snapshots the deployment retains (DESIGN.md
    §11).  Each candidate K is expanded by ``plan_checkpoints`` (the
    equal-cumulative-MAC placement rule) and the retained snapshots'
    int8 bytes are charged against the same on-chip memory quota as the
    row band — they coexist with it, so the charges *add*, and a K whose
    snapshots push the memory over quota is rejected exactly like an
    oversized band.  K=0 (no checkpoints, no charge) should normally be
    in the candidate list so resilience is paid for only when it fits.

    ``specs`` (optional) arms the static verifier as a DRC gate: the
    (program, specs) pair is checked once at construction, and a space
    whose program fails verification scores every option as infeasible
    (all quotas at ``FAILED_PCT``, ``raw["verifier"]`` naming the
    tripped rules) — the Algorithm-1 move of rejecting a design before
    paying the vendor compiler for it.
    """

    def __init__(self, model: ParsedModel, board: FPGAProfile,
                 ni_cap: int = NI_CAP, nl_cap: int = NL_CAP,
                 block_h_options: Optional[List[int]] = None,
                 per_channel: bool = False,
                 checkpoint_options: Optional[List[int]] = None,
                 specs: Optional[Dict] = None):
        self.model = model
        self.board = board
        #: error rule ids from the one-time static verification of the
        #: (program, specs) pair; empty when clean or unarmed
        self.verifier_errors: Tuple[str, ...] = ()
        if specs is not None:
            from . import verify as verify_mod
            rep = verify_mod.verify_program(model, specs,
                                            check_identity=False)
            self.verifier_errors = tuple(sorted(
                {d.rule_id for d in rep.errors}))
        self._ni = [n for n in model.feasible_ni(ni_cap) if n <= ni_cap]
        self._nl = [n for n in model.feasible_nl(nl_cap) if n <= nl_cap]
        self._bh = sorted(block_h_options) if block_h_options else None
        self._ck = (sorted(set(checkpoint_options))
                    if checkpoint_options else None)
        #: K -> (plan, retained int8 bytes); the plan is a pure function
        #: of the parsed model, so one expansion serves every option
        self._ck_cache: Dict[int, Tuple[Tuple[int, ...], int]] = {}
        #: per-channel quantized program: the working-set rule charges
        #: the per-lane shift row (int32/lane) alongside the bias, and
        #: the weight store grows by one int32 exponent per Cout lane
        self.per_channel = per_channel
        self.weight_bytes = model.total_weights  # int8: 1 byte/weight
        if per_channel:
            self.weight_bytes += 4 * sum(
                li.c_out for li in model.layers
                if li.kind in ("conv", "fc"))

    def options(self) -> List[Tuple]:
        import itertools
        return list(itertools.product(*self.axes()))

    def axes(self) -> List[List[int]]:
        axes = [list(self._ni), list(self._nl)]
        if self._bh is not None:
            axes.append(list(self._bh))
        if self._ck is not None:
            axes.append(list(self._ck))
        return axes

    def axis_names(self) -> List[str]:
        names = ["n_i", "n_l"]
        if self._bh is not None:
            names.append("block_h")
        if self._ck is not None:
            names.append("ckpt_k")
        return names

    def checkpoint_plan(self, k: int) -> Tuple[Tuple[int, ...], int]:
        """(boundary plan, retained int8 bytes) for K snapshots."""
        if k not in self._ck_cache:
            plan = plan_checkpoints(self.model, k)
            self._ck_cache[k] = (plan, checkpoint_bytes(self.model, plan))
        return self._ck_cache[k]

    def evaluate(self, option: Tuple) -> ResourceReport:
        if self.verifier_errors:
            # a program that fails DRC can never fit, at any option:
            # charge it like any over-quota design (Algorithm 1)
            from .dse import FAILED_PCT
            return ResourceReport(
                percents={k: FAILED_PCT
                          for k in ("lut", "dsp", "mem", "reg")},
                raw={"verifier": list(self.verifier_errors)}, fits=False)
        ni, nl = option[0], option[1]
        rep = estimate_fpga(self.board, ni, nl, self.weight_bytes)
        if self._bh is None and self._ck is None:
            return rep
        i = 2
        band_bytes = 0
        if self._bh is not None:
            # the Cin tile (8*N_i) and the Cout tile (8*N_l) both bound
            # the band the same way the executor's kernel tiles do
            band_bytes = conv_band_working_set(
                self.model.layers, nl, option[i], n_i=ni,
                per_channel=self.per_channel)
            i += 1
        ckpt_b = 0
        plan: Tuple[int, ...] = ()
        if self._ck is not None:
            plan, ckpt_b = self.checkpoint_plan(option[i])
        # band and retained snapshots coexist on chip: charges add
        onchip_pct = 100.0 * (8 * (band_bytes + ckpt_b)) / self.board.mem_bits
        percents = dict(rep.percents)
        percents["mem"] = max(percents["mem"], onchip_pct)
        raw = dict(rep.raw, band_ws_bytes=band_bytes,
                   band_ws_pct=100.0 * 8 * band_bytes / self.board.mem_bits,
                   ckpt_bytes=ckpt_b, ckpt_plan=plan,
                   onchip_pct=onchip_pct)
        fits = all(v <= 100.0 for v in percents.values())
        return ResourceReport(percents=percents, raw=raw, fits=fits)

    def tiebreak(self, option: Tuple) -> float:
        # prefer balanced (N_i, N_l) — see DesignSpace.tiebreak
        # docstring; among those, deeper row bands (larger block_h =
        # fewer halo re-reads) break remaining ties, then more
        # checkpoints (cheaper expected recovery) break the rest
        t = float(min(option[0], option[1]))
        i = 2
        if self._bh is not None:
            t += option[i] * 1e-3
            i += 1
        if self._ck is not None:
            t += option[i] * 1e-5
        return t


DEFAULT_POD_AXES: List[Tuple[str, List]] = [
    ("remat", ["none", "dots", "full"]),
    ("n_micro", [1, 4, 8, 16]),
    ("sequence_parallel", [False, True]),
]


class ShardingSpace(DesignSpace):
    """Pod-scale parallelism options scored by the dry run.

    ``evaluate`` traces a depth-reduced variant of the cell on the
    production mesh (estimation stage, like the paper's first synthesis
    stage) and scales residency/terms back to full depth.  The reward
    quotas (Algorithm 1 unchanged):

        lut  -> projected HBM residency %      (hard fit criterion)
        dsp  -> compute fraction of the step % (utilization == throughput)
        mem  -> projected temp pressure %
        reg  -> collective/compute pressure %
    """

    def __init__(self, arch: str, shape_name: str,
                 axes: Optional[List[Tuple[str, List]]] = None,
                 eval_depth: int = 4, flash_accounting: bool = True,
                 profile: GPUProfile = H100):
        self.arch = arch
        self.shape_name = shape_name
        self._axes = axes or DEFAULT_POD_AXES
        self.eval_depth = eval_depth
        self.flash = flash_accounting
        self.profile = profile
        from repro_torch import configs
        self._cfg = configs.get(arch)
        self._scale = max(1, self._cfg.n_layers // max(eval_depth, 1))

    def axes(self) -> List[List]:
        return [vals for _n, vals in self._axes]

    def axis_names(self) -> List[str]:
        return [name for name, _vals in self._axes]

    def options(self) -> List[Tuple]:
        return list(itertools.product(*self.axes()))

    def _policy_kwargs(self, option: Tuple) -> Dict[str, Any]:
        return {name: val for (name, _), val in zip(self._axes, option)}

    def evaluate(self, option: Tuple) -> ResourceReport:
        from repro_torch.launch.dryrun import _depth_cfg, lower_cell
        from repro_torch.sharding import PolicyOptions
        opts = PolicyOptions(**self._policy_kwargs(option))
        cfg1, _ = _depth_cfg(self._cfg, 1)  # family-consistent reduction
        depth_over = {"n_layers": cfg1.n_layers * self.eval_depth}
        if self._cfg.family == "encdec":
            depth_over["encoder_layers"] = depth_over["n_layers"]
        _c, meta = lower_cell(
            self.arch, self.shape_name, options=opts,
            cfg_override=depth_over, extrapolate=False,
            flash_accounting=self.flash)
        # project depth-linear quantities back to full depth
        hbm = self.profile.hbm_bytes
        peak = meta["arg_bytes"] + meta["out_bytes"] \
            + meta["temp_bytes"] * self._scale
        t_c = meta["t_compute"] * self._scale
        t_m = meta["t_memory_fused"] * self._scale
        t_col = meta["t_collective"] * self._scale
        t_step = max(t_c, t_m, t_col)
        percents = {
            "lut": 100.0 * peak / hbm,
            "dsp": 100.0 * t_c / max(t_step, 1e-12),
            "mem": 100.0 * meta["temp_bytes"] * self._scale / hbm,
            "reg": 100.0 * min(t_col / max(t_c, 1e-12), 2.0) / 2.0,
        }
        raw = {"peak": peak, "t_compute": t_c, "t_memory": t_m,
               "t_collective": t_col, "t_step": t_step,
               "option": self._policy_kwargs(option)}
        fits = percents["lut"] <= 100.0
        return ResourceReport(percents=percents, raw=raw, fits=fits)

    def tiebreak(self, option: Tuple) -> float:
        return 0.0
